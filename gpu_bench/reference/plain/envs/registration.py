"""Environment registry, with gymnasium registration where it is installed.

Counterpart of the JAX package's envs/registration.py: a local spec table
that ``make`` resolves (so ``cfg.env_name`` reaches the port's classes
even when the JAX package registered the same id with gymnasium in the
same process), and ``make`` wraps the env in a step limit. With gymnasium
installed, ``register_env`` also registers the class under the namespaced
id ``real2sim_eval_tpu_torch/<uid>``, so ``gym.make`` of that id builds
the port's env and never the JAX package's.
"""

from __future__ import annotations

from typing import Callable, Type

from ..utils.logging import get_logger

try:
    import gymnasium as gym
except ImportError:   # the port runs without gymnasium
    gym = None

logger = get_logger(__name__)

GYM_NAMESPACE = "real2sim_eval_tpu_torch"
REGISTERED_ENVS: dict[str, "EnvSpec"] = {}


class EnvSpec:
    def __init__(self, uid: str, cls: Type, max_episode_steps: int | None = None,
                 default_kwargs: dict | None = None):
        self.uid = uid
        self.cls = cls
        self.max_episode_steps = max_episode_steps
        self.default_kwargs = default_kwargs or {}

    def make(self, **kwargs):
        return self.cls(**{**self.default_kwargs, **kwargs})


class TimeLimit:
    """Truncate an episode after ``max_episode_steps`` steps (gymnasium's
    ``TimeLimit`` semantics: the step's truncation flag turns true);
    attributes of the env are reached through the wrapper."""

    def __init__(self, env, max_episode_steps: int):
        self.env = env
        self.max_episode_steps = int(max_episode_steps)
        self._elapsed_steps = 0

    @property
    def unwrapped(self):
        return self.env

    def reset(self, **kwargs):
        self._elapsed_steps = 0
        return self.env.reset(**kwargs)

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._elapsed_steps += 1
        if self._elapsed_steps >= self.max_episode_steps:
            truncated = True
        return obs, reward, terminated, truncated, info

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.env, name)


def register(uid: str, cls: Type, max_episode_steps=None, default_kwargs=None,
             override: bool = False) -> EnvSpec:
    if uid in REGISTERED_ENVS and not override:
        logger.warning("env %s already registered; skipping", uid)
        return REGISTERED_ENVS[uid]
    spec = EnvSpec(uid, cls, max_episode_steps, default_kwargs)
    REGISTERED_ENVS[uid] = spec
    return spec


def make(env_id: str, max_episode_steps: int | None = None, **kwargs):
    """Instantiate a registered env inside a ``TimeLimit``."""
    if env_id not in REGISTERED_ENVS:
        raise KeyError(f"env {env_id!r} not registered")
    spec = REGISTERED_ENVS[env_id]
    env = spec.make(**kwargs)
    limit = (max_episode_steps if max_episode_steps is not None
             else spec.max_episode_steps)
    if limit is not None:
        env = TimeLimit(env, max_episode_steps=int(limit))
    return env


def register_env(uid: str, max_episode_steps: int | None = None,
                 override: bool = False, **default_kwargs) -> Callable:
    """Class decorator: register locally and, with gymnasium installed,
    under ``real2sim_eval_tpu_torch/<uid>`` with gymnasium."""

    def decorator(cls):
        register(uid, cls, max_episode_steps, default_kwargs,
                 override=override)
        if gym is None:
            return cls
        gym_id = f"{GYM_NAMESPACE}/{uid}"
        if gym_id in gym.registry:
            if not override:
                return cls
            del gym.registry[gym_id]
        gym.register(id=gym_id,
                     entry_point=lambda **kw: cls(**{**default_kwargs, **kw}),
                     max_episode_steps=max_episode_steps,
                     disable_env_checker=True)
        return cls

    return decorator
