"""Python-file config loader with ``_base_`` inheritance.

The port's copy of ``occformer_tpu/config.py``, with its ``a.b.c=value``
overrides for the CLIs' ``--cfg-options``.

Replaces ``mmcv.Config.fromfile`` used throughout the reference (reference:
tools/train.py:104-136, projects/configs/_base_/*).  Configs are plain python
files whose module-level names become config keys; ``_base_`` is a list of
relative paths merged depth-first (later files and the child override).
"""
from __future__ import annotations

import ast
import copy
import os
import types
from typing import Any, Dict, Optional


class ConfigDict(dict):
    """dict with attribute access, recursively wrapping nested dicts."""

    def __getattr__(self, name):
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return v

    def __setattr__(self, name, value):
        self[name] = value

    @staticmethod
    def wrap(obj):
        if isinstance(obj, dict) and not isinstance(obj, ConfigDict):
            return ConfigDict({k: ConfigDict.wrap(v) for k, v in obj.items()})
        if isinstance(obj, ConfigDict):
            return ConfigDict({k: ConfigDict.wrap(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return type(obj)(ConfigDict.wrap(v) for v in obj)
        return obj


def _exec_pyfile(path: str) -> Dict[str, Any]:
    with open(path) as f:
        src = f.read()
    # validate it parses before exec'ing
    ast.parse(src, filename=path)
    mod = types.ModuleType("_occ_cfg")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return {
        k: v
        for k, v in mod.__dict__.items()
        if not k.startswith("__") and not isinstance(v, types.ModuleType)
    }


def merge_dict(base: Dict, child: Dict) -> Dict:
    """Recursively merge ``child`` into ``base`` (child wins).

    A child dict with ``_delete_=True`` replaces the base value wholesale,
    mirroring mmcv semantics.
    """
    out = copy.deepcopy(base)
    for k, v in child.items():
        if (
            isinstance(v, dict)
            and isinstance(out.get(k), dict)
            and not v.pop("_delete_", False)
        ):
            out[k] = merge_dict(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_config(path: str, overrides: Optional[Dict[str, Any]] = None) -> ConfigDict:
    """Load a python config file, resolving ``_base_`` inheritance, then
    apply dot-path ``overrides``."""
    path = os.path.abspath(path)
    cfg = _exec_pyfile(path)
    bases = cfg.pop("_base_", [])
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    for rel in bases:
        base_cfg = load_config(os.path.join(os.path.dirname(path), rel))
        merged = merge_dict(merged, base_cfg)
    merged = merge_dict(merged, cfg)
    if overrides:
        merged = apply_overrides(merged, overrides)
    return ConfigDict.wrap(merged)


def apply_overrides(cfg: Dict[str, Any], overrides: Dict[str, Any]) -> Dict[str, Any]:
    """Apply ``a.b.c=value`` dot-path overrides (reference: tools/train.py:66-75)."""
    cfg = copy.deepcopy(cfg)
    for dotted, value in overrides.items():
        keys = dotted.split(".")
        node = cfg
        for k in keys[:-1]:
            if isinstance(node, (list, tuple)):
                node = node[int(k)]
            else:
                node = node.setdefault(k, {})
        last = keys[-1]
        if isinstance(node, (list, tuple)):
            node[int(last)] = value
        else:
            node[last] = value
    return cfg


def parse_override_value(s: str) -> Any:
    """Parse a CLI override string into a python value."""
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def parse_cfg_options(options) -> Dict[str, Any]:
    """``["a.b=1", "c=x"]`` (the CLIs' ``--cfg-options``) -> overrides."""
    overrides = {}
    for kv in options:
        k, v = kv.split("=", 1)
        overrides[k] = parse_override_value(v)
    return overrides
