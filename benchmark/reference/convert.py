"""Hand the program's state to the plain reference, and keep a copy of it.

Where the reference follows the program step by step (a float32 run and a
float64 run part by rounding within a frame, so a whole-run comparison has
no tight limit), it starts a step from the program's own state before that
step. ``clone`` keeps that state as it was, since the program's CUDA graphs
overwrite their output tensors at the next replay; ``to_reference`` rebuilds
it from the reference's own classes, found by the same module path under
``benchmark.reference.plain``, with every floating tensor cast. Neither
imports the program: classes are matched by their module's name.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

PROGRAM = "rivslam_tpu_torch"
REFERENCE = "benchmark.reference.plain"


def _map(obj, tensor_fn, class_fn):
    if isinstance(obj, torch.Tensor):
        return tensor_fn(obj)
    if isinstance(obj, list):
        return [_map(o, tensor_fn, class_fn) for o in obj]
    if isinstance(obj, tuple):
        return tuple(_map(o, tensor_fn, class_fn) for o in obj)
    if isinstance(obj, dict):
        return {k: _map(v, tensor_fn, class_fn) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = class_fn(type(obj))
        return cls(**{f.name: _map(getattr(obj, f.name), tensor_fn, class_fn)
                      for f in dataclasses.fields(obj) if f.init})
    return obj


def clone(obj):
    """A copy of a nest of tensors, dataclasses and containers whose tensors
    are new copies on their own devices."""
    return _map(obj, lambda t: t.clone(), lambda c: c)


def reference_class(cls: type) -> type:
    """The reference's class of the program's ``cls`` (the same module path
    under ``benchmark.reference.plain`` and the same name)."""
    mod = cls.__module__
    if mod == PROGRAM or mod.startswith(PROGRAM + "."):
        mod = REFERENCE + mod[len(PROGRAM):]
    elif not mod.startswith(REFERENCE):
        return cls
    return getattr(importlib.import_module(mod), cls.__qualname__)


def to_reference(obj, dtype: torch.dtype, device):
    """The program's state ``obj`` in the reference's classes, floating
    tensors cast to ``dtype``, every tensor on ``device``."""

    def tensor(t: torch.Tensor) -> torch.Tensor:
        return t.to(device=device, dtype=dtype if t.is_floating_point() else t.dtype)

    return _map(obj, tensor, reference_class)
