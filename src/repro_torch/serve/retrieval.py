"""Candidate-retrieval serving: where the paper meets the recommenders (port
of ``repro/serve/retrieval.py``).

``retrieve`` scores a batch of users against ~10^6 candidate items -- the
MIPS workload GleanVec accelerates. The scoring mode is one of
``scorer.MODES`` (full, sphering, gleanvec, sphering-int8, gleanvec-int8,
gleanvec-sorted, gleanvec-int8-sorted) and the traversal any Index of the
port (flat scan by default, IVF, graph, or a ``ShardedIndex``); the two
axes are orthogonal, so there is no per-mode code here. Every mode but
``full`` runs Algorithm 1 (reduced search of kappa candidates, then the
full-precision rerank) through :func:`repro_torch.core.search.state_search`,
with the rerank store on the device or in host memory
(``search.demote_rerank_tier``); ``full`` is exact already and skips the
rerank. The scans lower through ``repro_torch.kernels``: ``ip_topk`` for
the linear modes, ``gleanvec_sq_topk`` for the GleanVec ones.

The reference caches a compiled search function per ``(k, kappa, state
treedef)`` and mounts the state anew on every call; the port has nothing
to compile, so ``fn_cache`` holds one mounted
:class:`~repro_torch.core.search.ServingState` per ``(k, kappa)``, beside
the artifacts and index it was built from. A second call with the same
``(k, kappa)``, artifacts and index builds no state; a call with other
artifacts or another index (``_replace`` shares the dict) replaces it, so
refreshed artifacts are served as the reference serves them.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.core import search as msearch
from repro_torch.core.scorer import build_scorer
from repro_torch.device import resolve_device
from repro_torch.index.protocol import FlatIndex

__all__ = ["RetrievalIndex", "build_retrieval_index", "retrieve"]


class RetrievalIndex(NamedTuple):
    """``mode`` picks the scorer (representation), ``index`` the traversal
    (None = the flat scan); ``fn_cache`` holds the serving states built by
    :func:`retrieve`: ``(k, kappa) -> (artifacts, index, state)``."""

    mode: str
    artifacts: msearch.SearchArtifacts
    index: Any = None
    fn_cache: Optional[Dict] = None

    @property
    def x_full(self):
        return self.artifacts.x_full

    @property
    def scorer(self) -> Any:
        return self.artifacts.scorer


def build_retrieval_index(candidates, mode: str = "full", model=None,
                          index=None, scorer=None,
                          device=None) -> RetrievalIndex:
    """Encode ``candidates (n, D)`` for ``mode`` on ``device`` (default:
    the GPU); ``index`` mounts the scorer behind an Index traversal (IVF,
    graph, sharded) instead of the flat scan. ``scorer`` overrides the
    mode-built one where the traversal needs its own (a ``ShardedIndex``
    takes the stacked per-shard scorer of
    ``distributed.build_sharded_index``)."""
    candidates = torch.as_tensor(candidates, dtype=torch.float32,
                                 device=resolve_device(device))
    if scorer is None:
        scorer = build_scorer(mode, candidates, model,
                              device=candidates.device)
    artifacts = msearch.SearchArtifacts(scorer=scorer, x_full=candidates,
                                        model=model)
    return RetrievalIndex(mode=mode, artifacts=artifacts, index=index,
                          fn_cache={})


def retrieve(index: RetrievalIndex, user_vecs, k: int,
             kappa: Optional[int] = None) -> torch.Tensor:
    """``user_vecs (B, D)`` -> the top-k candidate ids (B, k), int32 on
    the serving device. ``kappa`` (default 2 k) candidates go to the
    rerank; a host-tier store reranks from host memory."""
    q = torch.as_tensor(user_vecs, dtype=torch.float32,
                        device=msearch.artifacts_device(index.artifacts))
    if index.mode == "full":    # the exact search is the answer
        traversal = index.index if index.index is not None else FlatIndex()
        return traversal.search(q, index.scorer, k)[1]
    kappa = kappa or 2 * k
    cache = index.fn_cache if index.fn_cache is not None else {}
    built = cache.get((k, kappa))
    if (built is None or built[0] is not index.artifacts
            or built[1] is not index.index):
        built = (index.artifacts, index.index,
                 msearch.make_state(index.artifacts, index=index.index))
        cache[(k, kappa)] = built
    return msearch.state_search(q, built[2], k, kappa)
