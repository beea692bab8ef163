"""Per-dimension affine scalar quantization of reduced vectors (port of
``repro/core/quantization.py``).

    <q, u * delta + lo> = <q * delta, u> + <q, lo>

so the scan over the codes is a pure u8 product with a query-side scale.
``torch.round`` rounds half to even, like ``jnp.round``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["SQDatabase", "ClusteredSQDatabase", "quantize",
           "quantize_per_cluster", "dequantize", "quantized_inner_products"]


class SQDatabase(NamedTuple):
    codes: torch.Tensor   # (n, d) uint8
    lo: torch.Tensor      # (d,)
    delta: torch.Tensor   # (d,)


class ClusteredSQDatabase(NamedTuple):
    codes: torch.Tensor   # (n, d) uint8
    lo: torch.Tensor      # (C, d) per-cluster lower bound
    delta: torch.Tensor   # (C, d) per-cluster step


def _codes(x, lo, delta, levels):
    return torch.clamp(torch.round((x - lo) / delta), 0,
                       levels).to(torch.uint8)


def quantize(x: torch.Tensor, bits: int = 8,
             valid: torch.Tensor = None) -> SQDatabase:
    """Per-dimension affine quantization of ``x (n, d)`` to ``bits`` levels.

    ``valid`` ((n,) bool, optional) restricts the range fit to the marked
    rows: the dead and padding rows of a streaming store must not widen
    the scales. Every row is still coded (out-of-range rows clip)."""
    levels = (1 << bits) - 1
    x = x.to(torch.float32)
    if valid is None:
        lo = torch.amin(x, dim=0)
        hi = torch.amax(x, dim=0)
    else:
        v = valid[:, None]
        lo = torch.amin(torch.where(v, x, float("inf")), dim=0)
        hi = torch.amax(torch.where(v, x, float("-inf")), dim=0)
        lo = torch.where(torch.isfinite(lo), lo, torch.zeros_like(lo))
        hi = torch.where(torch.isfinite(hi), hi, torch.zeros_like(hi))
    delta = torch.clamp(hi - lo, min=1e-12) / levels
    return SQDatabase(codes=_codes(x, lo[None, :], delta[None, :], levels),
                      lo=lo, delta=delta)


def quantize_per_cluster(x: torch.Tensor, tags: torch.Tensor,
                         n_clusters: int, bits: int = 8,
                         valid: torch.Tensor = None) -> ClusteredSQDatabase:
    """Per-cluster per-dimension affine quantization: each cluster's rows
    get their own (lo, delta) per dimension. ``valid`` ((n,) bool,
    optional) leaves dead and padding rows out of the range fit (they are
    still coded). A cluster with no (valid) rows gets lo = 0 and the
    minimal step, as in the reference."""
    levels = (1 << bits) - 1
    x = x.to(torch.float32)
    d = x.shape[1]
    idx = tags.to(torch.int64)[:, None].expand(-1, d)
    x_lo, x_hi = x, x
    if valid is not None:
        x_lo = torch.where(valid[:, None], x, float("inf"))
        x_hi = torch.where(valid[:, None], x, float("-inf"))
    lo = torch.full((n_clusters, d), float("inf"), device=x.device)
    hi = torch.full((n_clusters, d), float("-inf"), device=x.device)
    lo = lo.scatter_reduce(0, idx, x_lo, reduce="amin", include_self=True)
    hi = hi.scatter_reduce(0, idx, x_hi, reduce="amax", include_self=True)
    lo = torch.where(torch.isfinite(lo), lo, torch.zeros_like(lo))
    hi = torch.where(torch.isfinite(hi), hi, torch.zeros_like(hi))
    delta = torch.clamp(hi - lo, min=1e-12) / levels
    t = tags.to(torch.int64)
    return ClusteredSQDatabase(codes=_codes(x, lo[t], delta[t], levels),
                               lo=lo, delta=delta)


def dequantize(db: SQDatabase) -> torch.Tensor:
    """(n, d) f32 reconstruction ``codes * delta + lo``."""
    return db.codes.to(torch.float32) * db.delta[None, :] + db.lo[None, :]


def quantized_inner_products(query: torch.Tensor,
                             db: SQDatabase) -> torch.Tensor:
    """<q, dequant(x)> for every row, without the dequantized matrix:
    ``query (d,)`` -> scores ``(n,)``."""
    q = query.to(torch.float32)
    return db.codes.to(torch.float32) @ (q * db.delta) + q @ db.lo
