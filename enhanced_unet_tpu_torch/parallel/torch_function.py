"""Reading the arguments of the calls a `TorchFunctionMode` sees: the
tensors nested in them, the same structure with each tensor replaced, the
arguments by name and a function's name.  `parallel.spatial.SpatialMode`
and `parallel.tensor_parallel.TensorParallelMode` both parse their calls
with these."""

from __future__ import annotations

from typing import List

import torch


def tensors_of(obj) -> List[torch.Tensor]:
    """The tensors in `obj`, nested in lists, tuples and dicts."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in tensors_of(o)]
    if isinstance(obj, dict):
        return [t for o in obj.values() for t in tensors_of(o)]
    return []


def replace_tensors(obj, fn):
    """`obj` with each tensor t nested in it replaced by `fn(t)`."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(replace_tensors(o, fn) for o in obj)
    if isinstance(obj, dict):
        return {k: replace_tensors(v, fn) for k, v in obj.items()}
    return obj


def call_args(args, kwargs, names, defaults) -> dict:
    """Positional and keyword arguments by name."""
    out = dict(zip(names, defaults))
    out.update(zip(names, args))
    out.update(kwargs)
    return out


def func_name(func) -> str:
    """A called function's or method's `__name__`, or ""."""
    return getattr(func, "__name__", "") or ""
