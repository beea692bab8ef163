"""Embedding tables and EmbeddingBag (port of ``repro/models/embedding.py``).

Several tables with different vocab sizes are packed into one (sum V_i, D)
array with per-feature row offsets (``pack_table_offsets``); a lookup is a
``take`` and a bag is a ``take`` plus a segment sum (``index_add_``).

``make_sharded_lookup`` is the DLRM model-parallel lookup over a
``DeviceMesh`` (table rows over "model", the embedding dim over the data
axes, the batch over the data axes):

  1. all-gather the local batch's ids over the data axes -> global batch;
  2. masked local take of this rank's rows + all-reduce over "model"
     -> (B_global, F, D / dp);
  3. all-to-all over the data axes swapping batch and dim -> (B_local, F,
     D).

Differentiable (the all-to-all's backward is the reverse exchange; the
all-reduce passes the gradient through, as the reference's ``psum`` in
``shard_map``), so the same path serves training.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.models.sharding import sum_over_group

__all__ = ["pack_table_offsets", "embedding_lookup", "embedding_bag",
           "make_sharded_lookup"]


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


def make_sharded_lookup(device_mesh, total_vocab: int, dim: int):
    """The 2D-sharded DLRM lookup on a live ``DeviceMesh`` whose axes are
    ("data", "model") or ("pod", "data", "model"). Returns ``lookup(table,
    idx) -> (B_local, F, D)`` to call on every rank with ``table`` its
    (ceil(total_vocab / tp), dim / dp) block (rows by its "model" index,
    the dim by its data index: spec ("model", dp axes)) and ``idx (B_local,
    F)`` its batch (spec (dp axes, None)), ids into the packed table."""
    import torch.distributed as dist
    import torch.distributed.nn.functional as dist_fn

    from repro_torch.launch.mesh import axis_group
    names = tuple(device_mesh.mesh_dim_names)
    dp_axes = tuple(a for a in ("pod", "data") if a in names)
    dp_group = axis_group(device_mesh, dp_axes)
    tp_group = device_mesh.get_group("model")
    n_dp = dist.get_world_size(dp_group) if dp_group is not None else 1
    rows = -(-total_vocab // device_mesh.size(names.index("model")))
    if dim % n_dp:
        raise ValueError(f"embed dim {dim} does not cut into {n_dp} slices")

    def lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        if table.shape != (rows, dim // n_dp):
            raise ValueError(f"table block {tuple(table.shape)}, expected "
                             f"{(rows, dim // n_dp)}")
        b_local, f = idx.shape
        idx = idx.contiguous()
        if dp_group is not None:
            gathered = torch.empty((n_dp * b_local, f), dtype=idx.dtype,
                                   device=idx.device)
            dist.all_gather_into_tensor(gathered, idx, group=dp_group)
            idx = gathered
        loc = idx.long() - dist.get_rank(tp_group) * rows
        hit = (loc >= 0) & (loc < rows)
        emb = table[loc.clamp(0, rows - 1)]            # (B, F, D / dp)
        emb = torch.where(hit[..., None], emb, torch.zeros_like(emb))
        emb = sum_over_group(emb, tp_group)
        if dp_group is None:
            return emb
        # batch <-> dim: chunk j of the global batch goes to data rank j,
        # which places rank r's dim slice at columns r * D / dp
        out = dist_fn.all_to_all_single(
            torch.empty_like(emb), emb.contiguous(), group=dp_group)
        return out.view(n_dp, b_local, f, -1).permute(1, 2, 0, 3) \
            .reshape(b_local, f, dim)

    return lookup
