"""Streaming vector search (paper Section 3.2; port of
``repro/core/streaming.py``).

Moment tracking
---------------
The D x D summary statistics

    K_Q(t) = sum_{q in Q_t} q q^T,   K_X(t) = sum_{x in X_t} x x^T

follow insertions and removals as rank-1 updates (Eq. 11); every ``s``
updates the projections are refit from them by eigendecomposition, and
stored reduced vectors are re-projected with the transition matrix
T = P_{t+1} W_{t+1} (P_t W_t)^+ (Eq. 12), eagerly or for a ``pending``
subset. For GleanVec the same runs per cluster: ``k_x`` is the (C, D, D)
stack of per-cluster moments (the k-means landmarks stay fixed, so inserts
are tagged by the existing centers), ``refresh`` refits every cluster
through :func:`repro_torch.core.gleanvec.fit_from_moments`, and the
transition is a (C, d, d) stack applied per tag -- cluster by cluster
(``gleanvec.project_per_cluster``), never as a per-row gather.

Serving bridge
--------------
:func:`build_streaming_artifacts` builds a fixed-capacity
:class:`~repro_torch.core.search.SearchArtifacts`: the row-aligned scorers
pre-allocate ``capacity`` rows under a ``live`` mask, the sorted scorers
keep free slots inside each cluster's blocks. :func:`insert_rows`,
:func:`remove_rows` and :func:`refresh_artifacts` keep every tensor's
shape and dtype and the classes, which is what
:meth:`repro_torch.serve.engine.ServingEngine.swap` checks. The cycle:

    observe_queries -> insert / insert_rows -> refresh -> refresh_state
        -> engine.swap

Every operation returns a new state (new tensors; the state it was given
is left as it was), so the engine serves the installed state until the
swap. A host rerank tier (``host_rerank=True``) is read through the
store's gather and written through its ``set_rows``, which leaves the
store it was called on reading its own rows.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from repro_torch.core import gleanvec as gv
from repro_torch.core import linalg, rerank_tier
from repro_torch.core import scorer as sc
from repro_torch.core.gleanvec import GleanVecModel
from repro_torch.core.leanvec_sphering import SpheringModel, fit_from_moments
from repro_torch.core.search import (SearchArtifacts, ServingState,
                                     artifacts_device)
from repro_torch.device import resolve_device

__all__ = ["StreamingState", "init", "init_gleanvec", "init_from_artifacts",
           "insert", "remove", "observe_queries", "needs_refresh",
           "refresh", "transition_matrix", "transition_condition",
           "reproject", "build_streaming_artifacts", "live_mask",
           "free_ids", "insert_rows", "remove_rows", "refresh_artifacts",
           "refresh_state"]


class StreamingState(NamedTuple):
    """Running moments and the current model. ``k_x`` is (D, D) for the
    linear family and (C, D, D) for GleanVec; ``prev_bw`` is the (d, D) or
    (C, d, D) database projection at the last refresh (the denominator of
    Eq. 12)."""

    k_q: torch.Tensor
    k_x: torch.Tensor
    model: Union[SpheringModel, GleanVecModel]
    prev_bw: torch.Tensor
    updates_since: int
    refresh_every: int


def _per_cluster(state: StreamingState) -> bool:
    return state.k_x.ndim == 3


def _rows2d(x, device) -> torch.Tensor:
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    return x.reshape(1, -1) if x.ndim == 1 else x


def init(k_q: torch.Tensor, k_x: torch.Tensor, d: int,
         refresh_every: int = 1024) -> StreamingState:
    """Linear (LeanVec-Sphering) streaming state, model fit from moments."""
    model = fit_from_moments(k_q, k_x, d)
    return StreamingState(k_q=k_q, k_x=k_x, model=model, prev_bw=model.b,
                          updates_since=0, refresh_every=refresh_every)


def init_gleanvec(model: GleanVecModel, k_q: torch.Tensor,
                  k_x_per_cluster: torch.Tensor,
                  refresh_every: int = 1024) -> StreamingState:
    """GleanVec streaming state around an already-fit model (the one
    serving now): the first transition is measured against its B_c."""
    return StreamingState(k_q=k_q, k_x=k_x_per_cluster, model=model,
                          prev_bw=model.b, updates_since=0,
                          refresh_every=refresh_every)


def init_from_artifacts(artifacts: SearchArtifacts, queries,
                        refresh_every: int = 1024) -> StreamingState:
    """Moments from a serving store: K_Q from ``queries``, K_X from the
    store's LIVE full-precision rows (per cluster for GleanVec); the model
    is taken as it is, so the first Eq. 12 transition is relative to what
    is serving."""
    model = artifacts.model
    if model is None:
        raise ValueError("mode 'full' stores raw vectors; there is no DR "
                         "model to stream (refresh is the identity)")
    dev = artifacts_device(artifacts)
    k_q = linalg.second_moment(_rows2d(queries, dev))
    rows = rerank_tier.rows(artifacts.x_full,
                            torch.nonzero(live_mask(artifacts)).squeeze(1),
                            dev)
    if isinstance(model, GleanVecModel):
        tags = gv.assign_tags(model, rows)
        k_x = gv.per_cluster_moments(rows, tags, model.n_clusters)
        return init_gleanvec(model, k_q, k_x, refresh_every)
    return StreamingState(k_q=k_q, k_x=linalg.second_moment(rows),
                          model=model, prev_bw=model.b, updates_since=0,
                          refresh_every=refresh_every)


def _moment_delta(state: StreamingState, x2d: torch.Tensor) -> torch.Tensor:
    if _per_cluster(state):
        tags = gv.assign_tags(state.model, x2d)
        return gv.per_cluster_moments(x2d, tags, state.k_x.shape[0])
    return linalg.second_moment(x2d)


def insert(state: StreamingState, x) -> StreamingState:
    """X_t = X_{t-1} u {x}: rank-1 update of K_X (Eq. 11). ``x`` is (D,)
    or (b, D); GleanVec states route each row to its cluster's moment."""
    x2d = _rows2d(x, state.k_x.device)
    return state._replace(k_x=state.k_x + _moment_delta(state, x2d),
                          updates_since=state.updates_since + x2d.shape[0])


def remove(state: StreamingState, x) -> StreamingState:
    """X_t = X_{t-1} \\ {x}: rank-1 downdate of K_X (Eq. 11)."""
    x2d = _rows2d(x, state.k_x.device)
    return state._replace(k_x=state.k_x - _moment_delta(state, x2d),
                          updates_since=state.updates_since + x2d.shape[0])


def observe_queries(state: StreamingState, q) -> StreamingState:
    """Fold a batch of observed queries into K_Q."""
    return state._replace(k_q=state.k_q + linalg.second_moment(
        _rows2d(q, state.k_q.device)))


def needs_refresh(state: StreamingState) -> bool:
    return state.updates_since >= state.refresh_every


def refresh(state: StreamingState) -> StreamingState:
    """Refit W and P (per cluster for GleanVec) from the current moments;
    the outgoing model's B becomes ``prev_bw``."""
    d = state.model.dim
    if _per_cluster(state):
        new_model = gv.fit_from_moments(state.model.centers, state.k_q,
                                        state.k_x, d)
    else:
        new_model = fit_from_moments(state.k_q, state.k_x, d)
    return state._replace(model=new_model, prev_bw=state.model.b,
                          updates_since=0)


def transition_matrix(state: StreamingState) -> torch.Tensor:
    """T = P_{t'} W_{t'} (P_{t-1} W_{t-1})^+ (Eq. 12): (d, d), or the
    (C, d, d) stack for GleanVec. Exact when d == D; for d < D the
    least-squares re-projection onto the new basis."""
    return state.model.b @ torch.linalg.pinv(state.prev_bw)


def transition_condition(state: StreamingState) -> float:
    """Condition number of the Eq. 12 denominator B_prev (the largest over
    clusters): how far its pseudo-inverse amplifies stored-vector noise.
    ``inf`` for a singular solve, ``nan`` for non-finite inputs."""
    prev = state.prev_bw.to(torch.float32)
    if not bool(torch.isfinite(prev).all()):
        return float("nan")
    s = torch.linalg.svdvals(prev)
    smax = s.max(dim=-1).values
    smin = s.min(dim=-1).values
    cond = torch.where(smin > 0, smax / smin,
                       torch.full_like(smax, float("inf")))
    return float(cond.max())


def reproject(state: StreamingState, x_low: torch.Tensor,
              tags: Optional[torch.Tensor] = None,
              pending: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. 12 over stored reduced vectors. GleanVec states need the rows'
    ``tags`` (row i maps through T_{tags_i}, one product per cluster);
    ``pending`` selects a lazy subset, the other rows keep their values."""
    t = transition_matrix(state)
    if t.ndim == 3:
        if tags is None:
            raise ValueError("per-cluster reprojection needs the rows' "
                             "cluster tags")
        new = gv.project_per_cluster(x_low, tags, t)
    else:
        new = x_low.to(torch.float32) @ t.T
    if pending is None:
        return new
    return torch.where(pending[:, None], new, x_low)


# ---------------------------------------------------------------------------
# Serving bridge: fixed-capacity stores, row-level updates, state refresh.
# ---------------------------------------------------------------------------


_SORTED_MODES = ("gleanvec-sorted", "gleanvec-int8-sorted")


def build_streaming_artifacts(mode: str, database, model=None,
                              capacity: Optional[int] = None,
                              sort_block: int = 4096,
                              slack_blocks: int = 1,
                              host_rerank: bool = False,
                              device=None) -> SearchArtifacts:
    """Fixed-capacity artifacts for any of ``scorer.MODES``.

    Row-aligned modes pre-allocate ``capacity`` rows (the spare slots hold
    copies of row 0, so scale fits and tags stay sane) masked dead by the
    scorer's ``live``; sorted modes build the layout over the given rows
    with ``slack_blocks`` free blocks per cluster and a capacity-sized
    ``inv_perm``. The rerank store ``x_full`` is capacity-sized either way;
    ``host_rerank`` demotes it to host memory
    (:func:`repro_torch.core.search.demote_rerank_tier`)."""
    dev = resolve_device(device)
    x = torch.as_tensor(database, dtype=torch.float32, device=dev)
    n0 = x.shape[0]
    capacity = n0 if capacity is None else capacity
    if capacity < n0:
        raise ValueError(f"capacity {capacity} < initial rows {n0}")
    x_cap = torch.cat([x, x[:1].expand(capacity - n0, -1)], dim=0)
    if mode in _SORTED_MODES:
        if mode == "gleanvec-sorted":
            scorer = sc.sorted_gleanvec_scorer(model, x, block=sort_block,
                                               slack_blocks=slack_blocks)
        else:
            scorer = sc.sorted_gleanvec_quantized_scorer(
                model, x, block=sort_block, slack_blocks=slack_blocks)
        pad = torch.full((capacity - n0,), -1, dtype=scorer.inv_perm.dtype,
                         device=dev)
        scorer = scorer._replace(inv_perm=torch.cat([scorer.inv_perm, pad]))
    else:
        scorer = sc.build_scorer(mode, x_cap, model, block=sort_block,
                                 device=dev)
        scorer = scorer._replace(live=torch.arange(capacity, device=dev) < n0)
    x_full = rerank_tier.demote(x_cap) if host_rerank else x_cap
    return SearchArtifacts(scorer=scorer, x_full=x_full, model=model)


def live_mask(artifacts: SearchArtifacts) -> torch.Tensor:
    """(capacity,) bool over EXTERNAL ids: the slots holding a vector."""
    s = artifacts.scorer
    if hasattr(s, "inv_perm"):
        return s.inv_perm >= 0
    if getattr(s, "live", None) is not None:
        return s.live
    return torch.ones(s.n_rows, dtype=torch.bool,
                      device=artifacts_device(artifacts))


def free_ids(artifacts: SearchArtifacts, count: int) -> torch.Tensor:
    """The first ``count`` free external ids of a fixed-capacity store,
    (count,) int32."""
    free = torch.nonzero(~live_mask(artifacts)).squeeze(1)
    if free.numel() < count:
        raise ValueError(f"store full: {free.numel()} free slots < {count}")
    return free[:count].to(torch.int32)


def insert_rows(artifacts: SearchArtifacts, rows, ids=None):
    """Insert full-D ``rows`` into free slots (the scorer and the rerank
    store together). Returns ``(artifacts', ids)``."""
    dev = artifacts_device(artifacts)
    rows = _rows2d(rows, dev)
    if ids is None:
        ids = free_ids(artifacts, rows.shape[0])
    ids = torch.as_tensor(ids, dtype=torch.int32, device=dev)
    scorer = artifacts.scorer.insert_rows(ids, rows, artifacts.model)
    store = rerank_tier.host_store(artifacts.x_full)
    if store is None:
        x_full = artifacts.x_full.index_put((ids.long(),), rows)
    else:
        x_full = store.set_rows(ids.cpu(), rows.cpu())
    return artifacts._replace(scorer=scorer, x_full=x_full), ids


def remove_rows(artifacts: SearchArtifacts, ids) -> SearchArtifacts:
    """Tombstone external ``ids``: they stop serving, their slots become
    free again."""
    ids = torch.as_tensor(ids, dtype=torch.int32,
                          device=artifacts_device(artifacts))
    return artifacts._replace(scorer=artifacts.scorer.remove_rows(ids))


def refresh_artifacts(artifacts: SearchArtifacts,
                      state: Optional[StreamingState],
                      source: str = "stored",
                      pending: Optional[torch.Tensor] = None
                      ) -> SearchArtifacts:
    """Re-encode the serving representation under ``state``'s refreshed
    model. ``source="stored"`` maps the stored reduced vectors
    (dequantized first for int8) through the Eq. 12 transition and re-codes
    with scales fitted over the live rows; ``source="full"`` re-encodes
    exactly from ``x_full`` (a host tier is copied to the device for the
    re-encode and freed after it). ``pending`` restricts the reprojection to the
    marked external ids. ``state=None`` or a model-free store returns the
    artifacts unchanged."""
    if state is None or artifacts.model is None:
        return artifacts
    if source not in ("stored", "full"):
        raise ValueError(f"unknown refresh source {source!r}")
    transition = transition_matrix(state) if source == "stored" else None
    x_full = rerank_tier.promote(artifacts.x_full,
                                 artifacts_device(artifacts)) \
        if source == "full" else None
    scorer = artifacts.scorer.refresh(state.model, transition=transition,
                                      x_full=x_full, pending=pending)
    return artifacts._replace(scorer=scorer, model=state.model)


def refresh_state(serving: ServingState, state: Optional[StreamingState],
                  source: str = "stored",
                  pending: Optional[torch.Tensor] = None) -> ServingState:
    """Whole-state refresh: the artifacts re-encoded and the index's
    derived representations (IVF reduced-space centers) re-projected
    through its ``refreshed`` hook. Same structure, shapes and dtypes as
    ``serving``: hand it to ``engine.swap``."""
    artifacts = refresh_artifacts(serving.artifacts, state, source=source,
                                  pending=pending)
    index = serving.index
    if hasattr(index, "refreshed"):
        index = index.refreshed(artifacts.scorer, artifacts.model)
    return serving._replace(artifacts=artifacts, index=index)
