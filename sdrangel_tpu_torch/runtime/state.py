"""The pipelines' and the gears' states as trees (NamedTuples, dicts, lists
and tuples of tensors): a map over them, and their crossing to and from the
JAX package's states fetched as numpy."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def tree_map(fn, *trees: Any) -> Any:
    """fn over the tensors of states of one structure (NamedTuples, dicts,
    lists and tuples of tensors)."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if isinstance(first, dict):
        return {k: tree_map(fn, *(tr[k] for tr in trees)) for k in first}
    if hasattr(first, "_fields"):
        return type(first)(*(tree_map(fn, *leaves) for leaves in zip(*trees)))
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *leaves) for leaves in zip(*trees))
    raise TypeError(f"unexpected state node {type(first)}")


def tree_from_numpy(template: Any, value: Any) -> Any:
    """`value` (a numpy tree) in the structure and dtypes of `template`."""
    if isinstance(template, torch.Tensor):
        a = np.asarray(value)
        if template.dtype == torch.int16 and np.iscomplexobj(a):  # fused-ingest tail
            a = np.round(np.stack([a.real, a.imag], axis=-1) * 32768.0)
        np_dtype = torch.empty(0, dtype=template.dtype).numpy().dtype
        t = torch.from_numpy(np.array(a, dtype=np_dtype, order="C")).to(template.device)
        if t.shape != template.shape:
            raise ValueError(f"state field shape {tuple(t.shape)}, expected {tuple(template.shape)}")
        return t
    if isinstance(template, dict):
        return {k: tree_from_numpy(v, value[k]) for k, v in template.items()}
    if hasattr(template, "_fields"):  # NamedTuple state: match fields by name
        return type(template)(*(
            tree_from_numpy(getattr(template, f), getattr(value, f)) for f in template._fields))
    if isinstance(template, (list, tuple)):
        if len(template) != len(value):
            raise ValueError(f"state has {len(value)} entries, expected {len(template)}")
        return type(template)(tree_from_numpy(t, v) for t, v in zip(template, value))
    raise TypeError(f"unexpected state node {type(template)}")


def tree_to_numpy(state: Any) -> Any:
    """A state tree as numpy in the JAX package's field types: NCO phases
    as uint32, the int16 raw tail as the complex64 tail."""
    if isinstance(state, torch.Tensor):
        a = state.cpu().numpy()
        if a.dtype == np.int16:  # the fused-ingest raw tail
            return (a[..., 0].astype(np.float32) / 32768.0
                    + 1j * (a[..., 1].astype(np.float32) / 32768.0)).astype(np.complex64)
        if a.dtype == np.int64:  # NCO phase wheel
            return a.astype(np.uint32)
        return a
    if isinstance(state, dict):
        return {k: tree_to_numpy(v) for k, v in state.items()}
    if hasattr(state, "_fields"):
        return type(state)(*(tree_to_numpy(v) for v in state))
    if isinstance(state, (list, tuple)):
        return type(state)(tree_to_numpy(v) for v in state)
    raise TypeError(f"unexpected state node {type(state)}")
