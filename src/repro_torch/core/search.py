"""Multi-step vector search (paper Algorithm 1; port of the device-resident
part of ``repro/core/search.py``).

The main search runs in the compressed representation through an index
(``FlatIndex``: the fused scan + top-kappa kernel of the scorer); the kappa
candidates are then reranked with full-precision inner products. The
rerank is a gather, a small batched product and a top-k in plain PyTorch;
the reference has no kernel for it either. The host-resident rerank tier
belongs to a later part of the port.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core import scorer as sc
from repro_torch.device import resolve_device
from repro_torch.index.topk import NEG_INF

__all__ = ["SearchArtifacts", "ServingState", "build_artifacts",
           "build_artifacts_sphering", "build_artifacts_gleanvec",
           "make_state", "state_search", "state_candidates",
           "multi_step_search", "rerank"]


class SearchArtifacts(NamedTuple):
    """``scorer``: the main-search representation; ``x_full``: (n, D)
    full-precision rerank store (or the rotated x' of Section 3.1);
    ``rerank_a``: optional (D, D) query rotation for the rerank (Eq. 10);
    ``model``: the DR model, kept for bookkeeping only."""

    scorer: Any
    x_full: torch.Tensor
    rerank_a: Optional[torch.Tensor] = None
    model: Any = None


def build_artifacts_sphering(model, database, use_rotated_full: bool = True,
                             device=None) -> SearchArtifacts:
    """Linear path. With a d == D model and ``use_rotated_full`` the store
    holds x' = B'x and the rerank rotates queries by A' (Section 3.1)."""
    database = torch.as_tensor(database, dtype=torch.float32,
                               device=resolve_device(device))
    scorer = sc.linear_scorer(model, database)
    if use_rotated_full and model.dim == database.shape[1]:
        return SearchArtifacts(scorer=scorer, x_full=scorer.x_low,
                               rerank_a=model.a, model=model)
    return SearchArtifacts(scorer=scorer, x_full=database, model=model)


def build_artifacts_gleanvec(model, database, device=None) -> SearchArtifacts:
    database = torch.as_tensor(database, dtype=torch.float32,
                               device=resolve_device(device))
    return SearchArtifacts(scorer=sc.gleanvec_scorer(model, database),
                           x_full=database, model=model)


def build_artifacts(mode: str, database, model=None, block: int = 4096,
                    device=None) -> SearchArtifacts:
    """Any of ``scorer.MODES`` over ``database`` on ``device`` (default:
    the GPU). The rerank store is the f32 database itself."""
    database = torch.as_tensor(database, dtype=torch.float32,
                               device=resolve_device(device))
    return SearchArtifacts(
        scorer=sc.build_scorer(mode, database, model, block=block,
                               device=database.device),
        x_full=database, model=model)


class ServingState(NamedTuple):
    """Everything a serving search needs: artifacts, the index over them,
    and a generation counter bumped on every engine swap."""

    artifacts: SearchArtifacts
    index: Any
    version: int = 0


def make_state(artifacts: SearchArtifacts, index=None,
               version: int = 0) -> ServingState:
    """Mount ``artifacts`` behind ``index`` (None = the flat scan)."""
    from repro_torch.index.protocol import FlatIndex
    return ServingState(artifacts=artifacts,
                        index=FlatIndex() if index is None else index,
                        version=version)


def state_candidates(queries, state: ServingState, kappa: int):
    """The main (reduced-space) search only: (m, kappa) original ids."""
    scorer = state.artifacts.scorer
    qstate = state.index.prepare_queries(scorer, queries)
    return state.index.candidates(qstate, scorer, kappa)[1]


def state_search(queries, state: ServingState, k: int, kappa: int):
    """Algorithm 1 over a :class:`ServingState`: (m, k) original ids."""
    return multi_step_search(queries, state.artifacts, state.index, k, kappa)


def _rerank_math(q_full, cand_vecs, candidates, k: int):
    """Exact top-k among the gathered candidate rows. -1 slots score
    NEG_INF and are ordered after every real candidate of equal score
    (``torch.topk`` promises no tie order, so two stable sorts fix it): a
    row with fewer than k real candidates pads its tail with -1."""
    scores = torch.einsum("mkd,md->mk", cand_vecs, q_full)
    real = candidates >= 0
    scores = torch.where(real, scores, torch.full_like(scores, NEG_INF))
    o1 = torch.sort((~real).to(torch.int8), dim=1, stable=True).indices
    scores, cand = torch.gather(scores, 1, o1), torch.gather(candidates, 1, o1)
    o2 = torch.sort(scores, dim=1, descending=True, stable=True).indices
    return torch.gather(cand, 1, o2[:, :k])


def _rotate_queries(queries, artifacts: SearchArtifacts):
    return queries if artifacts.rerank_a is None \
        else queries @ artifacts.rerank_a.T


def rerank(queries, artifacts: SearchArtifacts, candidates, k: int):
    """Postprocessing (Alg. 1 line 3): exact top-k among ``candidates``
    (m, kappa); -1 entries never win."""
    safe = torch.where(candidates >= 0, candidates,
                       torch.zeros_like(candidates)).long()
    cand_vecs = artifacts.x_full[safe]                  # (m, kappa, D)
    return _rerank_math(_rotate_queries(queries, artifacts), cand_vecs,
                        candidates, k)


def multi_step_search(queries, artifacts: SearchArtifacts, index, k: int,
                      kappa: int):
    """Algorithm 1: main search through ``index`` (kappa candidates in the
    original id space), then the full-precision rerank."""
    scorer = artifacts.scorer
    qstate = index.prepare_queries(scorer, queries)
    _, candidates = index.candidates(qstate, scorer, kappa)
    return rerank(queries, artifacts, candidates, k)
