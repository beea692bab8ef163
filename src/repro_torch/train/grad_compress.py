"""Gradient compression for the cross-group all-reduce: int8 codes and
error feedback (port of ``repro/train/grad_compress.py``).

int8 cuts the bytes of a gradient all-reduce 4x against f32 (2x against
bf16); error feedback carries each step's residual into the next, which
keeps the compression unbiased over time (EF-SGD, 1-bit Adam). The
reference reduces over a mesh axis name inside ``shard_map``; here the
members are the ranks of a ``torch.distributed`` process group.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import tree

__all__ = ["quantize_int8", "dequantize_int8", "compressed_psum_mean",
           "apply_error_feedback"]


def _codes(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(xf / scale), -127, 127)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (codes int8, scale f32)."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    return _codes(x, scale).to(torch.int8), scale


def dequantize_int8(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.to(torch.float32) * scale


def compressed_psum_mean(tree_, group=None):
    """The mean of a gradient tree over the ranks of ``group`` (the default
    group if None), through int8. The largest |value| is all-reduced first
    (MAX), so every rank quantizes onto the same grid; the codes are summed
    as int32 (exact), then scaled back and divided by the group's size.
    Each leaf comes back in its own type. Bytes a tensor on the wire: its
    codes (as int32 in this collective) and one scale."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    leaves, treedef = tree.flatten(tree_)
    out = []
    for x in leaves:
        xf = x.to(torch.float32)
        amax = torch.max(torch.abs(xf))
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = torch.clamp(amax, min=1e-12) / 127.0
        total = _codes(xf, scale).to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        out.append((total.to(torch.float32) * scale / n).to(x.dtype))
    return treedef.unflatten(out)


def apply_error_feedback(grads, residuals):
    """g' = g + residual (f32); returns (g', fn(applied) -> new residual).
    The caller compresses g' however it likes, then calls the closure with
    the values actually applied to get the next residual tree. ``None``
    residuals start at zero."""
    leaves, treedef = tree.flatten(grads)
    res = ([torch.zeros_like(g, dtype=torch.float32) for g in leaves]
           if residuals is None else tree.leaves(residuals))
    corrected = [g.to(torch.float32) + r for g, r in zip(leaves, res)]

    def new_residuals(applied):
        return treedef.unflatten([c - a.to(torch.float32) for c, a in
                                  zip(corrected, tree.leaves(applied))])

    return treedef.unflatten(corrected), new_residuals
