"""The Index protocol (port of ``repro/index/protocol.py``): every index
answers

    qstate = index.prepare_queries(scorer, queries)
    vals, ids = index.candidates(qstate, scorer, k)   # ids: original space
    vals, ids = index.search(queries, scorer, k)

Members so far: ``FlatIndex`` here, ``IVFIndex`` in
:mod:`repro_torch.index.ivf` (gathered fine step for every scorer, the
gather-free ``ivf_scan_topk`` fine step for aligned sorted layouts), and
``GraphIndex`` in :mod:`repro_torch.index.graph` (gathered hops for every
scorer, the gather-free traversal, one ``graph_beam_search`` launch a
batch, for a graph bound to a sorted layout). All have the streaming hook ``refreshed(scorer, model)``,
which ``streaming.refresh_state`` calls. Sharded indexes come with a later
part of the port.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["FlatIndex"]


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

    def refreshed(self, scorer, model):
        """Streaming-refresh hook: nothing here derives from the
        representation."""
        return self
