"""Top-k utilities: blocked scans and (value, id) merges (port of
``repro/index/topk.py``).

These are the plain, blocked-over-N machinery behind every kernel's plain
version: peak memory is one (batch, block) score tile. Results are ordered
by value descending, then row index ascending: each merge is a stable
sort of the running list (earlier rows, already in that order) followed
by the block's rows, so equal values keep the smaller row first, as the
CUDA kernels do.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["NEG_INF", "merge_topk", "blocked_topk"]

NEG_INF = -3.4e38


def merge_topk(val_a, id_a, val_b, id_b, k: int):
    """Joint top-k of two (batch, *) candidate sets; among equal values
    the entry that comes first in ``a ++ b`` wins."""
    vals = torch.cat([val_a, val_b], dim=-1)
    ids = torch.cat([id_a, id_b], dim=-1)
    order = torch.sort(vals, dim=-1, descending=True, stable=True).indices
    order = order[..., :k]
    return torch.gather(vals, -1, order), torch.gather(ids, -1, order)


def blocked_topk(score_block_fn: Callable, n: int, k: int, block: int,
                 batch: int, device):
    """Running top-k over ``n`` items scored block by block.

    ``score_block_fn(start, size) -> (batch, size)`` scores rows
    [start, start + size). Returns (values f32, row indices i32), (batch, k)
    each; slots never filled hold (NEG_INF, -1)."""
    best_v = torch.full((batch, k), NEG_INF, dtype=torch.float32,
                        device=device)
    best_i = torch.full((batch, k), -1, dtype=torch.int64, device=device)
    for start in range(0, n, block):
        size = min(block, n - start)
        scores = score_block_fn(start, size).to(torch.float32)
        ids = torch.arange(start, start + size, device=device)
        best_v, best_i = merge_topk(best_v, best_i, scores,
                                    ids.expand(batch, -1), k)
    return best_v, best_i.to(torch.int32)
