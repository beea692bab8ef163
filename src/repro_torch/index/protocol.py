"""The Index protocol (port of ``repro/index/protocol.py``): every index
answers

    qstate = index.prepare_queries(scorer, queries)
    vals, ids = index.candidates(qstate, scorer, k)   # ids: original space
    vals, ids = index.search(queries, scorer, k)

Members: ``FlatIndex`` here, ``IVFIndex`` in :mod:`repro_torch.index.ivf`
(gathered fine step for every scorer, the gather-free ``ivf_scan_topk``
fine step for aligned sorted layouts), ``GraphIndex`` in
:mod:`repro_torch.index.graph` (gathered hops for every scorer, the
gather-free traversal, one ``graph_beam_search`` launch a batch, for a
graph bound to a sorted layout) and ``ShardedIndex`` in
:mod:`repro_torch.index.distributed` (any of them, shard by shard). All
have the streaming hook ``refreshed(scorer, model)``, which
``streaming.refresh_state`` calls.

Two id contracts meet in a sharded placement
(:mod:`repro_torch.index.distributed`): a sub-index built over one shard's
rows emits LOCAL ids, and the INDEX-level ``globalize_ids(scorer, ids,
row_start)`` lifts them to global ids by the shard's row offset
(:func:`_offset_ids`); a scorer row-sharded from a global build lifts its
own ids with the SCORER-level ``scorer.globalize_ids(ids, shard_idx)``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["FlatIndex"]


def _offset_ids(ids: torch.Tensor, row_start) -> torch.Tensor:
    """Local -> global id lift: ``ids + row_start`` where ``ids >= 0``; -1
    (padding, unfilled slots) stays -1. ``row_start`` may be a device
    scalar, so the lift needs no host sync."""
    return torch.where(ids >= 0, ids + row_start, torch.full_like(ids, -1))


@dataclass(frozen=True)
class FlatIndex:
    """Exhaustive scan: ``candidates`` is the fused scan + top-k kernel of
    the scorer (``kernels.scorer_topk_prepared``); on CPU tensors that is
    the kernel's plain version. The kernels tile the rows themselves, so
    the reference's ``block`` setting has no counterpart. Ids come out in
    the original space with dead slots of a streaming store as -1 (the
    lowering translates them, as the reference's ``translate_ids``), so
    they never reach the rerank."""

    def prepare_queries(self, scorer, queries):
        return scorer.prepare_queries(queries)

    def candidates(self, qstate, scorer, k: int):
        from repro_torch.kernels import scorer_topk_prepared
        return scorer_topk_prepared(scorer, qstate, k)

    def search(self, queries, scorer, k: int):
        return self.candidates(self.prepare_queries(scorer, queries),
                               scorer, k)

    def globalize_ids(self, scorer, ids, row_start):
        return _offset_ids(ids, row_start)

    def refreshed(self, scorer, model):
        """Streaming-refresh hook: nothing here derives from the
        representation."""
        return self
