"""Attribute-style config tree.

A self-contained replacement for the omegaconf ``DictConfig`` surface the
reference relies on (reference: cfg/*.yaml consumed via ``cfg.physics.dt``,
``cfg.env['robot']['type']`` and ``'c2w' in camera_cfg`` style access, e.g.
sim/renderer/gs_renderer.py:107-133). Supports both attribute and item
access, ``in`` tests, and recursive conversion to/from plain containers.
"""

from __future__ import annotations

from typing import Any, Iterator


class ConfigNode:
    """A dict-like node with attribute access, wrapping nested dicts/lists."""

    __slots__ = ("_data",)

    def __init__(self, data: dict | None = None):
        object.__setattr__(self, "_data", {})
        if data:
            for k, v in data.items():
                self._data[k] = _wrap(v)

    # -- access ------------------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        # guard against copy/pickle protocols probing dunders on a
        # not-yet-initialized instance (would recurse through _data)
        if key.startswith("__") or key == "_data":
            raise AttributeError(key)
        try:
            data = object.__getattribute__(self, "_data")
        except AttributeError:
            raise AttributeError(key)
        try:
            return data[key]
        except KeyError:
            raise AttributeError(f"config has no key {key!r}")

    def __reduce__(self):
        return (ConfigNode, (self.to_dict(),))

    def __deepcopy__(self, memo):
        return ConfigNode(self.to_dict())

    def __copy__(self):
        return ConfigNode(self.to_dict())

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = _wrap(value)

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = _wrap(value)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, ConfigNode):
            return self._data == other._data
        if isinstance(other, dict):
            return self.to_dict() == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"ConfigNode({self.to_dict()!r})"

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def keys(self):
        return self._data.keys()

    def values(self):
        return self._data.values()

    def items(self):
        return self._data.items()

    def pop(self, key: str, *default: Any) -> Any:
        return self._data.pop(key, *default)

    def setdefault(self, key: str, default: Any = None) -> Any:
        if key not in self._data:
            self._data[key] = _wrap(default)
        return self._data[key]

    # -- tree ops ----------------------------------------------------------
    def merge(self, other: "ConfigNode | dict") -> "ConfigNode":
        """Recursively merge ``other`` into self (other wins). Returns self."""
        items = other.items() if isinstance(other, (ConfigNode, dict)) else []
        for k, v in items:
            cur = self._data.get(k)
            if isinstance(cur, ConfigNode) and isinstance(v, (ConfigNode, dict)):
                cur.merge(v)
            else:
                self._data[k] = _wrap(v)
        return self

    def select(self, dotted: str, default: Any = ...) -> Any:
        """Fetch ``a.b.c`` style path; raise KeyError unless default given."""
        node: Any = self
        for part in dotted.split("."):
            try:
                if isinstance(node, list):
                    node = node[int(part)]
                else:
                    node = node[part]
            except (KeyError, IndexError, ValueError, TypeError):
                if default is ...:
                    raise KeyError(dotted)
                return default
        return node

    def update_dotted(self, dotted: str, value: Any, create: bool = True) -> None:
        parts = dotted.split(".")
        node: Any = self
        for part in parts[:-1]:
            if isinstance(node, list):
                node = node[int(part)]
                continue
            if part not in node:
                if not create:
                    raise KeyError(dotted)
                node[part] = ConfigNode()
            node = node[part]
        last = parts[-1]
        if isinstance(node, list):
            node[int(last)] = _wrap(value)
        else:
            node[last] = _wrap(value)

    def to_dict(self) -> dict:
        return _unwrap(self)

    def copy(self) -> "ConfigNode":
        return ConfigNode(self.to_dict())


def _wrap(value: Any) -> Any:
    if isinstance(value, ConfigNode):
        return value
    if isinstance(value, dict):
        return ConfigNode(value)
    if isinstance(value, (list, tuple)):
        return [_wrap(v) for v in value]
    return value


def _unwrap(value: Any) -> Any:
    if isinstance(value, ConfigNode):
        return {k: _unwrap(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_unwrap(v) for v in value]
    return value
