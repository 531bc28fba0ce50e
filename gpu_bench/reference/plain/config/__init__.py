from .node import ConfigNode
from .loader import load_config, compose, parse_overrides, to_yaml, save_config

__all__ = [
    "ConfigNode",
    "load_config",
    "compose",
    "parse_overrides",
    "to_yaml",
    "save_config",
]
