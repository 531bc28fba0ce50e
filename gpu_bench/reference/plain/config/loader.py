"""YAML config composition with hydra-compatible semantics.

The reference drives everything through hydra-composed YAML groups
(reference: cfg/eval_policy.yaml:1-9 ``defaults: [env: xarm_gripper, gs: rope,
physics: default, ...]`` plus CLI dotted overrides, README.md:120-127, and an
``eval`` resolver registered in experiments/eval_policy.py:17). This module
reimplements exactly that surface on plain PyYAML so the reference's ``cfg/``
trees load verbatim:

  - ``defaults`` list composition from sibling group directories
  - ``_self_`` ordering
  - ``${a.b}`` interpolation and ``${eval:...}`` resolver
  - ``key=value`` / ``+key=value`` / ``group=option`` CLI overrides
  - hydra-specific keys (``hydra:``, ``override hydra/...``) are ignored
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Any, Sequence

import yaml

from .node import ConfigNode

_INTERP_RE = re.compile(r"\$\{([^{}]+)\}")


class _Loader(yaml.SafeLoader):
    """SafeLoader with a YAML-1.2 float resolver so scalars like ``5e-5``
    parse as floats (PyYAML's 1.1 grammar requires a dot; hydra/omegaconf,
    which the reference's cfg files are written for, accept them)."""


_Loader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        r"""^(?:
            [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
            |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
            |\.[0-9][0-9_]*(?:[eE][-+]?[0-9]+)?
            |[-+]?\.(?:inf|Inf|INF)
            |\.(?:nan|NaN|NAN)
        )$""",
        re.X,
    ),
    list("-+0123456789."),
)


def _read_yaml(path: Path) -> dict:
    with open(path, "r") as f:
        data = yaml.load(f, Loader=_Loader)
    return data or {}


def load_config(
    config_path: str | Path,
    config_name: str,
    overrides: Sequence[str] | None = None,
    resolve: bool = True,
) -> ConfigNode:
    """Compose ``<config_path>/<config_name>.yaml`` like ``hydra.main`` would."""
    config_path = Path(config_path)
    cfg, group_choices = _compose_file(config_path, config_name)

    for ov in overrides or []:
        _apply_override(config_path, cfg, group_choices, ov)

    if resolve:
        resolve_interpolations(cfg)
    return cfg


def compose(config_path: str | Path, config_name: str, overrides=None) -> ConfigNode:
    return load_config(config_path, config_name, overrides)


def _compose_file(config_path: Path, config_name: str) -> tuple[ConfigNode, dict]:
    raw = _read_yaml(config_path / f"{config_name}.yaml")
    defaults = raw.pop("defaults", None)
    raw.pop("hydra", None)

    cfg = ConfigNode()
    group_choices: dict[str, str] = {}
    self_merged = False

    for entry in defaults or []:
        if entry == "_self_":
            cfg.merge(raw)
            self_merged = True
            continue
        if isinstance(entry, str):
            # bare defaults entry: a sibling config file
            sub, _ = _compose_file(config_path, entry)
            cfg.merge(sub)
            continue
        (group, option), = entry.items()
        if group.startswith("override ") or "/" in group:
            continue  # hydra-internal (e.g. "override hydra/job_logging")
        if option is None:
            continue
        group_choices[group] = option
        group_cfg, _ = _compose_file(config_path / group, option)
        cfg.setdefault(group, ConfigNode())
        cfg[group].merge(group_cfg)

    if not self_merged:
        cfg.merge(raw)
    return cfg, group_choices


def _apply_override(config_path: Path, cfg: ConfigNode, group_choices: dict, ov: str):
    if "=" not in ov:
        raise ValueError(f"override {ov!r} must look like key=value")
    key, _, value = ov.partition("=")
    key = key.lstrip("+")
    # group override: "gs=sloth" re-composes that group
    if "." not in key and (config_path / key).is_dir() and (
        config_path / key / f"{value}.yaml"
    ).exists():
        group_cfg, _ = _compose_file(config_path / key, value)
        cfg[key] = ConfigNode()
        cfg[key].merge(group_cfg)
        group_choices[key] = value
        return
    cfg.update_dotted(key, _parse_value(value))


def parse_overrides(argv: Sequence[str]) -> list[str]:
    return [a for a in argv if "=" in a and not a.startswith("-")]


def _parse_value(text: str) -> Any:
    text = text.strip()
    if text.lower() in ("null", "none"):
        return None
    if text.lower() == "true":
        return True
    if text.lower() == "false":
        return False
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def resolve_interpolations(cfg: ConfigNode) -> ConfigNode:
    """Resolve ``${a.b}`` and ``${eval:expr}`` in-place against the root."""

    def resolve_str(s: str) -> Any:
        m = _INTERP_RE.fullmatch(s.strip())
        if m:
            return resolve_expr(m.group(1))
        # partial interpolation inside a longer string
        def sub(mm):
            return str(resolve_expr(mm.group(1)))
        return _INTERP_RE.sub(sub, s)

    def resolve_expr(expr: str) -> Any:
        if expr.startswith("eval:"):
            body = expr[len("eval:"):].strip()
            body = _INTERP_RE.sub(lambda mm: str(resolve_expr(mm.group(1))), body)
            # omegaconf resolver args arrive unquoted: strip matching quotes
            if len(body) >= 2 and body[0] == body[-1] and body[0] in "'\"":
                body = body[1:-1]
            return eval(body)  # noqa: S307 - mirrors the reference's eval resolver
        return cfg.select(expr)

    def walk(node: Any) -> Any:
        if isinstance(node, ConfigNode):
            for k, v in list(node.items()):
                node[k] = walk(v)
            return node
        if isinstance(node, list):
            return [walk(v) for v in node]
        for _ in range(8):  # nested interpolations resolve iteratively
            if isinstance(node, str) and "${" in node:
                node = resolve_str(node)
            else:
                break
        return node

    walk(cfg)
    return cfg


def to_yaml(cfg: ConfigNode) -> str:
    return yaml.safe_dump(cfg.to_dict(), sort_keys=False)


def save_config(cfg: ConfigNode, path: str | Path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write(to_yaml(cfg))
