"""Multi-step vector search (paper Algorithm 1; port of
``repro/core/search.py``).

The main search runs in the compressed representation through an index
(``FlatIndex``: the fused scan + top-kappa kernel of the scorer); the kappa
candidates are then reranked with full-precision inner products. The
rerank is a gather, a small batched product and a top-k in plain PyTorch;
the reference has no kernel for it either.

The full-precision store ``x_full`` lives on the device, or in host memory
after :func:`demote_rerank_tier` (:mod:`repro_torch.core.rerank_tier`):
then only the kappa candidate rows of each query cross to the device, and
:func:`rerank_candidates` reranks them there. The serving engine overlaps
that gather and copy with the next batch's scan.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core import rerank_tier
from repro_torch.core import scorer as sc
from repro_torch.device import resolve_device
from repro_torch.index.topk import NEG_INF

__all__ = ["SearchArtifacts", "ServingState", "build_artifacts",
           "build_artifacts_sphering", "build_artifacts_gleanvec",
           "make_state", "state_search", "state_candidates",
           "multi_step_search", "rerank", "rerank_candidates", "host_tier",
           "demote_rerank_tier", "promote_rerank_tier", "artifacts_device"]


class SearchArtifacts(NamedTuple):
    """``scorer``: the main-search representation; ``x_full``: (n, D)
    full-precision rerank store (or the rotated x' of Section 3.1);
    ``rerank_a``: optional (D, D) query rotation for the rerank (Eq. 10);
    ``model``: the DR model, kept for bookkeeping only. ``x_full`` is a
    device tensor or a host store (:func:`demote_rerank_tier`)."""

    scorer: Any
    x_full: Any
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


def host_tier(artifacts: SearchArtifacts):
    """The artifacts' host rerank store, or None when ``x_full`` is a
    device tensor."""
    return rerank_tier.host_store(artifacts.x_full)


def artifacts_device(artifacts: SearchArtifacts) -> torch.device:
    """The device the artifacts serve on: ``x_full``'s, or with a host
    tier the scorer's."""
    if host_tier(artifacts) is None:
        return artifacts.x_full.device
    from repro_torch import tree
    for leaf in tree.leaves(artifacts.scorer):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    raise ValueError("a scorer without tensors has no device")


def demote_rerank_tier(artifacts: SearchArtifacts,
                       shards: int = 0) -> SearchArtifacts:
    """Move the (n, D) full-precision store to host memory (pinned when
    it was on the card; in ``shards`` row shards when > 0); the reduced
    codes stay on the device."""
    return artifacts._replace(
        x_full=rerank_tier.demote(artifacts.x_full, shards=shards))


def promote_rerank_tier(artifacts: SearchArtifacts) -> SearchArtifacts:
    """Undo :func:`demote_rerank_tier`: all n rows back on the device."""
    if host_tier(artifacts) is None:
        return artifacts
    return artifacts._replace(x_full=rerank_tier.promote(
        artifacts.x_full, artifacts_device(artifacts)))


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


# The second stage of the two-level pipeline: the top-k over the kappa
# rows that came across from the host tier.
rerank_candidates = _rerank_math


def _rotate_queries(queries, artifacts: SearchArtifacts):
    return queries if artifacts.rerank_a is None \
        else queries @ artifacts.rerank_a.T


def rerank(queries, artifacts: SearchArtifacts, candidates, k: int):
    """Postprocessing (Alg. 1 line 3): exact top-k among ``candidates``
    (m, kappa); -1 entries never win. Over a host tier the candidate ids
    come to the host and :func:`rerank_tier.fetch` gathers their rows into
    pinned memory and copies them to the queries' device in chunks (one
    batch at a time; the engine's pipelined submit overlaps these steps
    with the next batch's scan)."""
    q_full = _rotate_queries(queries, artifacts)
    store = host_tier(artifacts)
    if store is None:
        safe = torch.where(candidates >= 0, candidates,
                           torch.zeros_like(candidates)).long()
        cand_vecs = artifacts.x_full[safe]              # (m, kappa, D)
    else:
        rows = rerank_tier.fetch(store, candidates, queries.device,
                                 chunks=rerank_tier.COPY_CHUNKS)[0]
        cand_vecs = rows.view(*candidates.shape, -1)
    return rerank_candidates(q_full, cand_vecs, candidates, k)


def multi_step_search(queries, artifacts: SearchArtifacts, index, k: int,
                      kappa: int):
    """Algorithm 1: main search through ``index`` (kappa candidates in the
    original id space), then the full-precision rerank."""
    scorer = artifacts.scorer
    qstate = index.prepare_queries(scorer, queries)
    _, candidates = index.candidates(qstate, scorer, kappa)
    return rerank(queries, artifacts, candidates, k)
