"""Minimal hydra-style component instantiation from YAML configs.

The port's own copy of ``tpdm_tpu/utils/instantiate.py``: the training
entry point (``tpdm_tpu_torch.train.main``) names its components (agent,
reward, dataset, collator) by ``_target_`` YAMLs. It covers the subset the
config tree uses: a dotted ``_target_`` import, nested dict instantiation,
``_partial_: true`` for functions called later (collators, agent builders)
and call-time overrides.
"""

from __future__ import annotations

import functools
import importlib
from typing import Any

import yaml


def load_yaml(path: str) -> Any:
    with open(path) as f:
        return yaml.safe_load(f)


def _resolve(target: str):
    module, _, attr = target.rpartition(".")
    return getattr(importlib.import_module(module), attr)


def instantiate(cfg: Any, **overrides) -> Any:
    """Recursively instantiate `_target_` nodes; other values pass through."""
    if isinstance(cfg, list):
        return [instantiate(v) for v in cfg]
    if not isinstance(cfg, dict):
        return cfg
    cfg = dict(cfg)
    target = cfg.pop("_target_", None)
    partial = cfg.pop("_partial_", False)
    kwargs = {k: instantiate(v) for k, v in cfg.items()}
    kwargs.update(overrides)
    if target is None:
        return kwargs
    fn = _resolve(target)
    if partial:
        return functools.partial(fn, **kwargs)
    return fn(**kwargs)


def instantiate_file(path: str, **overrides) -> Any:
    return instantiate(load_yaml(path), **overrides)
