"""Embedding tables and EmbeddingBag (port of ``repro/models/embedding.py``).

Several tables with different vocab sizes are packed into one (sum V_i, D)
array with per-feature row offsets (``pack_table_offsets``); a lookup is a
``take`` and a bag is a ``take`` plus a segment sum (``index_add_``).

The reference's ``make_sharded_lookup`` (the DLRM model-parallel lookup
over a mesh: table rows over "model", embed dim over "data", an
all-to-all) waits with ``models/sharding.py``: on one device it is this
module's plain lookup.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["pack_table_offsets", "embedding_lookup", "embedding_bag"]


def pack_table_offsets(vocab_sizes: Sequence[int]) -> np.ndarray:
    """Row offsets (int32) for packing ``len(vocab_sizes)`` tables into
    one array."""
    return np.concatenate([[0], np.cumsum(np.asarray(vocab_sizes))[:-1]]
                          ).astype(np.int32)


def embedding_lookup(table: torch.Tensor, idx: torch.Tensor,
                     offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``idx (B, F)`` (+ per-feature ``offsets (F,)``) -> (B, F, D)."""
    if offsets is not None:
        idx = idx + offsets[None, :]
    return table[idx.long()]


def embedding_bag(table: torch.Tensor, idx: torch.Tensor,
                  segment_ids: torch.Tensor, n_bags: int,
                  combiner: str = "mean",
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ragged multi-hot lookup reduced per bag: ``idx (L,)`` flat ids,
    ``segment_ids (L,)`` bag of each id (sorted or not), optional per-id
    ``weights (L,)`` -> (n_bags, D). ``combiner`` is ``"sum"`` or
    ``"mean"`` (the weighted sum over the bag's id count); an empty bag is
    zeros."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"unknown combiner {combiner!r}")
    emb = table[idx.long()]                               # (L, D)
    if weights is not None:
        emb = emb * weights[:, None]
    seg = segment_ids.long()
    summed = torch.zeros((n_bags, table.shape[1]), dtype=emb.dtype,
                         device=table.device).index_add_(0, seg, emb)
    if combiner == "sum":
        return summed
    counts = torch.zeros(n_bags, dtype=torch.float32,
                         device=table.device).index_add_(
        0, seg, torch.ones(seg.shape[0], dtype=torch.float32,
                           device=table.device))
    return summed / torch.clamp(counts, min=1.0)[:, None]
