"""Component registry: string-keyed factories built from config dicts.

The port's copy of ``occformer_tpu/registry.py`` (reference
mmdetection3d/mmdet3d/models/builder.py): the ``dict(type='Name', **kwargs)``
config convention, so that the reference's config files map 1:1 onto the
port.  The port builds its models with ``models/detector.py:translate_cfg``;
datasets (``DATASETS``, used by the CLIs), the steps of their data pipelines
(``PIPELINES``) and the view transformers no config builds
(``NECKS``: BEVStereo's, registered where the JAX package registers it) go
through a registry.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional


class Registry:
    """A simple name -> class registry.

    Unlike mmcv there is no parent/child scoping: this framework has a
    single flat namespace per registry.
    """

    def __init__(self, name: str):
        self._name = name
        self._module_dict: Dict[str, Callable] = {}

    @property
    def name(self) -> str:
        return self._name

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict

    def __repr__(self) -> str:
        return f"Registry(name={self._name}, items={list(self._module_dict)})"

    def get(self, key: str) -> Optional[Callable]:
        return self._module_dict.get(key)

    def register_module(self, name: Optional[str] = None, module: Optional[Callable] = None):
        """Register a class, usable as decorator: ``@REG.register_module()``."""
        if module is not None:
            self._register(module, name)
            return module

        def _decorator(cls):
            self._register(cls, name)
            return cls

        return _decorator

    def _register(self, cls: Callable, name: Optional[str]):
        key = name or cls.__name__
        if key in self._module_dict and self._module_dict[key] is not cls:
            raise KeyError(f"{key} already registered in {self._name}")
        self._module_dict[key] = cls

    def build(self, cfg: Dict[str, Any], **default_args) -> Any:
        return build_from_cfg(cfg, self, **default_args)


def build_from_cfg(cfg: Dict[str, Any], registry: Registry, **default_args) -> Any:
    """Instantiate ``registry[cfg['type']](**cfg_without_type)``."""
    if not isinstance(cfg, dict) or "type" not in cfg:
        raise TypeError(f"cfg must be a dict with a 'type' key, got {cfg!r}")
    cfg = copy.deepcopy(cfg)
    obj_type = cfg.pop("type")
    if isinstance(obj_type, str):
        cls = registry.get(obj_type)
        if cls is None:
            raise KeyError(f"{obj_type} is not registered in {registry.name}")
    else:
        cls = obj_type
    for k, v in default_args.items():
        cfg.setdefault(k, v)
    return cls(**cfg)


# the datasets the CLIs build from ``data.train`` / ``data.val`` / ``data.test``
DATASETS = Registry("datasets")
# the steps of a dataset's ``pipeline`` (``data/transforms.py``, ``data/voxelize.py``)
PIPELINES = Registry("pipelines")
# ``models/bevstereo.py:ViewTransformerLSSBEVStereo``
NECKS = Registry("necks")
