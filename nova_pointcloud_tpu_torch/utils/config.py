"""Config system: nested dict configs with YAML files and dotted overrides
(the port's own copy of what it needs from
``nova_pointcloud_tpu/utils/config.py``).

Plain dicts with attribute access, recursive merge, dotted get / set, and
flattening for experiment trackers. ``yaml`` is imported inside
:func:`load_config` only: a config given as a dict needs no YAML package.
"""

from typing import Any, Dict


class Config(dict):
    """A dict with attribute access and recursive wrapping."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any):
        self[name] = value

    @classmethod
    def wrap(cls, obj: Any) -> Any:
        if isinstance(obj, dict):
            return cls({k: cls.wrap(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return type(obj)(cls.wrap(v) for v in obj)
        return obj

    def to_dict(self) -> Dict:
        def unwrap(obj):
            if isinstance(obj, dict):
                return {k: unwrap(v) for k, v in obj.items()}
            if isinstance(obj, (list, tuple)):
                return [unwrap(v) for v in obj]
            return obj

        return unwrap(self)


def set_by_path(cfg: Dict, dotted: str, value: Any):
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, Config())
    node[keys[-1]] = Config.wrap(value)


def get_by_path(cfg: Dict, dotted: str, default: Any = None) -> Any:
    node = cfg
    for k in dotted.split("."):
        if not isinstance(node, dict) or k not in node:
            return default
        node = node[k]
    return node


def merge(base: Dict, override: Dict) -> Dict:
    """Recursively merge ``override`` into ``base`` (returns base)."""
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            merge(base[k], v)
        else:
            base[k] = Config.wrap(v)
    return base


def load_config(path: str) -> Config:
    import yaml

    with open(path) as f:
        return Config.wrap(yaml.safe_load(f) or {})


def flatten_config(cfg: Dict, prefix: str = "") -> Dict[str, Any]:
    """Flatten nested config to dotted keys (for wandb-style trackers)."""
    flat = {}
    for k, v in cfg.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(flatten_config(v, key))
        else:
            flat[key] = v
    return flat
