"""Fault-tolerant serving lifecycle over the engine (port of
``repro/serve/lifecycle.py``).

``ServingEngine.swap`` checks structure only: it would install a state
full of NaNs from a poisoned moment update or a singular Eq. 12 solve.
This module adds the three layers a streamed index needs to stay up:

* :class:`GuardedEngine` -- guarded swaps. A candidate state is checked
  for structure (the engine's own check, first), version (monotonic: a
  candidate older than the installed state is refused), non-finite leaves,
  and a canary: a pinned query battery runs through the candidate
  (``engine.search_with``) and the swap is refused if its top-k overlap
  with the installed state collapses. Every refusal raises
  :class:`SwapRejected` before any engine field changes; the displaced
  state of the last accepted swap is kept, so ``rollback()`` restores it
  bit for bit. The reference demands a non-donating engine here; the
  port's engine donates nothing, so there is nothing to check.
* ``snapshot`` / ``restore`` -- the ``ServingState`` + ``StreamingState``
  pair through :mod:`repro_torch.train.checkpoint` (one file a leaf,
  ``.tmp`` + rename). A restarted process rebuilds the structure from its
  launch flags (``template_model``: no refit) and restores the leaves into
  it; a truncated or corrupted step falls back to the previous one. A host
  rerank tier is written from host memory and read back into host memory,
  never through the card.
* :class:`RefreshSupervisor` -- the stream's refresh as a supervised
  operation: retry with exponential backoff, ``stored`` -> ``full``
  escalation when the Eq. 12 transition is ill-conditioned or an attempt
  failed, and degradation: on persistent failure the engine keeps serving
  the last good state; ``recover`` rebuilds the moments from it.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import rerank_tier
from repro_torch.core import search as msearch
from repro_torch.core import streaming
from repro_torch.core.gleanvec import GleanVecModel
from repro_torch.core.leanvec_sphering import SpheringModel
from repro_torch.device import resolve_device
from repro_torch.serve.engine import ServingEngine
from repro_torch.train import checkpoint

__all__ = ["SwapRejected", "GuardStats", "GuardedEngine", "RefreshReport",
           "RefreshSupervisor", "snapshot", "restore", "restore_into",
           "nonfinite_leaves", "template_model", "template_stream"]


class SwapRejected(RuntimeError):
    """A guarded swap refused the candidate. ``reason`` is one of
    ``treedef`` / ``aval`` / ``stale-version`` / ``non-finite`` /
    ``canary-overlap``; the installed state is untouched."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        super().__init__(f"swap rejected ({reason}): {detail}" if detail
                         else f"swap rejected ({reason})")


def nonfinite_leaves(tree_) -> List[str]:
    """Paths of float leaves holding any non-finite value (one
    ``isfinite`` reduction a float tensor). A host rerank store has no
    leaves and is skipped: an O(n D) host scan a swap would defeat the
    tier, and the canary reads its rows."""
    bad = []
    paths, leaves, _ = tree.flatten_with_paths(tree_)
    for p, leaf in zip(paths, leaves):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point() and \
                    not bool(torch.isfinite(leaf).all()):
                bad.append(p)
        elif isinstance(leaf, float) and not np.isfinite(leaf):
            bad.append(p)
    return bad


@dataclass
class GuardStats:
    """Observable health of a :class:`GuardedEngine`."""

    accepted: int = 0
    rejected: int = 0
    rollbacks: int = 0
    last_overlap: float = 1.0
    rejections: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=256))

    def reject(self, reason: str):
        self.rejected += 1
        self.rejections.append(reason)


class GuardedEngine:
    """Validating wrapper around a :class:`ServingEngine`.

    ``canary_queries`` ((m, D) host array) pins the query battery (at most
    one batch); ``min_overlap`` is the mean top-k overlap with the
    installed state below which a candidate is refused (0 turns the canary
    off). A refusal leaves ``engine.state`` and ``n_swaps`` as they were."""

    def __init__(self, engine: ServingEngine,
                 canary_queries: Optional[np.ndarray] = None,
                 min_overlap: float = 0.3, check_finite: bool = True,
                 monotonic: bool = True):
        self.engine = engine
        self.min_overlap = float(min_overlap)
        self.check_finite = check_finite
        self.monotonic = monotonic
        self.health = GuardStats()
        self._prev: Optional[msearch.ServingState] = None
        self._canary = None
        self._canary_rows = 0
        if canary_queries is not None and min_overlap > 0:
            q = np.asarray(canary_queries, np.float32)
            self._canary_rows = min(q.shape[0], engine.batch_size)
            batch = np.zeros((engine.batch_size, engine.dim), np.float32)
            batch[:self._canary_rows] = q[:self._canary_rows]
            self._canary = batch
            self._canary_ref = self._run_canary(engine.state)

    # -- delegation -------------------------------------------------------
    @property
    def state(self) -> msearch.ServingState:
        return self.engine.state

    @property
    def version(self) -> int:
        return self.engine.version

    @property
    def n_swaps(self) -> int:
        return self.engine.n_swaps

    @property
    def n_compiles(self) -> int:
        return self.engine.n_compiles

    def submit(self, queries: np.ndarray) -> np.ndarray:
        return self.engine.submit(queries)

    # -- validation -------------------------------------------------------
    def _run_canary(self, state: msearch.ServingState) -> np.ndarray:
        """The battery's top-k under ``state`` (over a host tier, through
        the candidate's own store: the one guard that reads its rows)."""
        return self.engine.search_with(self._canary,
                                       state)[:self._canary_rows]

    @staticmethod
    def _overlap(a: np.ndarray, b: np.ndarray) -> float:
        """Mean per-query fraction of shared ids between two (m, k) result
        sets (-1 slots never count)."""
        hits = sum(np.intersect1d(ra[ra >= 0], rb[rb >= 0]).size
                   for ra, rb in zip(a, b))
        return hits / float(max(a.shape[0] * a.shape[1], 1))

    def validate(self, state: msearch.ServingState,
                 monotonic: Optional[bool] = None) -> Optional[np.ndarray]:
        """Run every guard against ``state``: raises :class:`SwapRejected`
        (engine untouched) or returns the candidate's canary result."""
        try:
            self.engine._check_swap_compatible(state)
        except ValueError as e:
            reason = "treedef" if "treedef" in str(e) else "aval"
            self.health.reject(reason)
            raise SwapRejected(reason, str(e)) from e
        if self.monotonic if monotonic is None else monotonic:
            v_new, v_old = int(state.version), int(self.engine.state.version)
            if v_new < v_old:
                self.health.reject("stale-version")
                raise SwapRejected(
                    "stale-version",
                    f"candidate version {v_new} < installed {v_old}")
        if self.check_finite:
            bad = nonfinite_leaves(state)
            if bad:
                self.health.reject("non-finite")
                raise SwapRejected("non-finite",
                                   f"non-finite leaves: {bad[:4]}")
        if self._canary is None:
            return None
        ids = self._run_canary(state)
        overlap = self._overlap(ids, self._canary_ref)
        self.health.last_overlap = overlap
        if overlap < self.min_overlap:
            self.health.reject("canary-overlap")
            raise SwapRejected(
                "canary-overlap",
                f"canary top-k overlap {overlap:.3f} < {self.min_overlap}")
        return ids

    def _install(self, state: msearch.ServingState,
                 canary_ids: Optional[np.ndarray]) -> None:
        prev = self.engine.state
        self.engine.swap(state)
        self._prev = prev
        if self._canary is not None:
            self._canary_ref = canary_ids
        self.health.accepted += 1

    def swap(self, state: msearch.ServingState) -> None:
        """Guarded swap: validate (raising before any change), then
        install; the displaced state becomes the rollback target."""
        self._install(state, self.validate(state))

    def rollback(self) -> msearch.ServingState:
        """Reinstall the state the last accepted swap displaced: the same
        results bit for bit, the version moving on."""
        if self._prev is None:
            raise RuntimeError("no retained last-known-good state to "
                               "roll back to")
        good, self._prev = self._prev, None
        self.engine.swap(good)
        if self._canary is not None:
            self._canary_ref = self._run_canary(self.engine.state)
        self.health.rollbacks += 1
        return self.engine.state


# ---------------------------------------------------------------------------
# Snapshot / restore: ServingState + StreamingState through the checkpoint.
# ---------------------------------------------------------------------------


def snapshot(snap_dir: str, serving: msearch.ServingState,
             stream: Optional[streaming.StreamingState] = None,
             step: Optional[int] = None, meta: Optional[dict] = None) -> str:
    """Persist the serving + streaming pair atomically under ``snap_dir``;
    ``step`` defaults to the latest durable step + 1, so snapshots form the
    chain ``restore`` walks back on corruption. A host tier's rows go as
    an explicit ``host_full`` dict, written from host memory."""
    if step is None:
        last = checkpoint.latest_step(snap_dir)
        step = 0 if last is None else last + 1
    meta = dict(meta or {})
    meta["has_stream"] = stream is not None
    host_full = rerank_tier.host_arrays(serving.artifacts.x_full)
    return checkpoint.save(
        snap_dir, step,
        {"serving": serving, "stream": stream, "host_full": host_full},
        meta=meta)


def _place(restored, template):
    """Numpy leaves of a restored tree as tensors on the devices of the
    template's leaves (python scalars stay as they are)."""
    got, treedef = tree.flatten(restored)
    like = tree.leaves(template)
    out = [torch.from_numpy(np.ascontiguousarray(g)).to(t.device)
           if isinstance(t, torch.Tensor) else g for g, t in zip(got, like)]
    return treedef.unflatten(out)


def restore(snap_dir: str, serving_template: msearch.ServingState,
            stream_template: Optional[streaming.StreamingState] = None,
            step: Optional[int] = None
            ) -> Tuple[msearch.ServingState,
                       Optional[streaming.StreamingState], int, dict]:
    """Load the newest restorable snapshot into the templates' structure.

    The templates give structure only (classes and static configuration
    from the launch flags; ``template_model`` builds one without a refit);
    leaf shapes come from the snapshot, so layout-dependent shapes restore
    exactly. A truncated manifest, a short or missing leaf file, or any
    other corruption of a step falls back to the previous step; raises
    ``FileNotFoundError`` when none restores. Leaves land on the devices
    of the template's leaves; a host tier's rows stay in host memory
    (pinned like the template's store)."""
    steps = checkpoint.available_steps(snap_dir)
    if step is not None:
        steps = [s for s in steps if s <= step]
    if not steps:
        raise FileNotFoundError(f"no snapshot steps under {snap_dir}")
    store = rerank_tier.host_store(serving_template.artifacts.x_full)
    template = {"serving": serving_template, "stream": stream_template,
                "host_full": rerank_tier.host_arrays(
                    serving_template.artifacts.x_full)}
    errors = []
    for s in reversed(steps):
        try:
            got, step_got, meta = checkpoint.restore(
                snap_dir, template, step=s, strict_shapes=False)
        except Exception as e:                  # noqa: BLE001 -- fall back
            errors.append(f"step {s}: {type(e).__name__}: {e}")
            continue
        serving = _place(got["serving"], serving_template)
        stream = None if stream_template is None \
            else _place(got["stream"], stream_template)
        if got["host_full"] is not None:
            serving = serving._replace(artifacts=serving.artifacts._replace(
                x_full=rerank_tier.from_host_arrays(got["host_full"],
                                                    pin=store.pinned)))
        return serving, stream, step_got, meta
    raise FileNotFoundError(
        f"no restorable snapshot under {snap_dir}; tried {errors}")


def restore_into(guarded: GuardedEngine,
                 serving: msearch.ServingState) -> None:
    """Install a restored state into a warm engine: validated like any
    swap (monotonicity waived: a restore may rewind the clock), and the
    engine's version clock continues from the snapshot's version."""
    canary_ids = guarded.validate(serving, monotonic=False)
    eng = guarded.engine
    # after _install bumps n_swaps, version == the snapshot's version
    eng._version0 = int(serving.version) - (eng.n_swaps + 1)
    guarded._install(serving, canary_ids)


# ---------------------------------------------------------------------------
# Refresh supervision: retry + backoff, escalation, graceful degradation.
# ---------------------------------------------------------------------------


@dataclass
class RefreshReport:
    """What one supervised refresh chain did."""

    outcome: str                 # "ok" | "degraded"
    source: str                  # refresh source actually used
    attempts: int = 1
    escalated: bool = False
    condition: float = 0.0       # Eq. 12 denominator condition number
    errors: List[str] = field(default_factory=list)
    elapsed_s: float = 0.0


class RefreshSupervisor:
    """Supervises ``refresh -> refresh_state -> guarded swap``.

    The ladder: (1) the requested source, with ``stored`` promoted to
    ``full`` up front when ``transition_condition`` exceeds
    ``cond_threshold``; (2) on any failure, retry with exponential
    backoff, escalating ``stored`` -> ``full``; (3) after ``max_retries``
    retries, degrade: the engine keeps serving its state, ``degraded`` is
    set, and the stream state is handed back unrefreshed for
    :meth:`recover`."""

    def __init__(self, guarded: GuardedEngine, max_retries: int = 2,
                 backoff_s: float = 0.05, backoff_mult: float = 2.0,
                 cond_threshold: float = 1e6, query_window: int = 4096,
                 sleep=time.sleep):
        self.guarded = guarded
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.backoff_mult = backoff_mult
        self.cond_threshold = cond_threshold
        self._sleep = sleep
        self.degraded = False
        self.n_refreshes = 0
        self.n_degraded = 0
        self.n_escalations = 0
        self.n_retries = 0
        self.n_recoveries = 0
        self.reports: List[RefreshReport] = []
        self._recent_q: collections.deque = collections.deque()
        self._recent_rows = 0
        self._query_window = query_window

    def note_queries(self, queries: np.ndarray) -> None:
        """Keep a bounded window of served (finite) queries for
        ``recover``."""
        q = np.asarray(queries, np.float32)
        q = q[np.isfinite(q).all(axis=1)]
        if not q.size:
            return
        self._recent_q.append(q)
        self._recent_rows += q.shape[0]
        while self._recent_q and \
                self._recent_rows - self._recent_q[0].shape[0] \
                >= self._query_window:
            self._recent_rows -= self._recent_q.popleft().shape[0]

    def refresh_and_swap(self, stream: streaming.StreamingState,
                         source: str = "stored", pending=None,
                         refresh_fn=streaming.refresh
                         ) -> Tuple[streaming.StreamingState, RefreshReport]:
        """One supervised refresh: ``(stream', report)``, ``stream'`` the
        refreshed state on success and the one given on degradation. A
        failed attempt changes nothing in the engine."""
        self.n_refreshes += 1
        t0 = time.perf_counter()
        report = RefreshReport(outcome="degraded", source=source)
        src, delay = source, self.backoff_s
        for attempt in range(self.max_retries + 1):
            report.attempts = attempt + 1
            try:
                new_stream = refresh_fn(stream)
                use = src
                if use == "stored":
                    cond = streaming.transition_condition(new_stream)
                    report.condition = cond
                    if not cond < self.cond_threshold:   # inf/nan escalate
                        use = "full"
                        report.escalated = True
                        self.n_escalations += 1
                candidate = streaming.refresh_state(
                    self.guarded.engine.state, new_stream, source=use,
                    pending=pending)
                self.guarded.swap(candidate)
                report.outcome, report.source = "ok", use
                report.elapsed_s = time.perf_counter() - t0
                self.degraded = False
                self.reports.append(report)
                return new_stream, report
            except Exception as e:       # noqa: BLE001 -- supervision point
                report.errors.append(f"{type(e).__name__}: {e}")
                if src == "stored":
                    src = "full"
                    report.escalated = True
                    self.n_escalations += 1
                if attempt < self.max_retries:
                    self.n_retries += 1
                    if delay > 0:
                        self._sleep(delay)
                    delay *= self.backoff_mult
        self.degraded = True
        self.n_degraded += 1
        report.elapsed_s = time.perf_counter() - t0
        self.reports.append(report)
        return stream, report

    def recover(self, stream: streaming.StreamingState,
                queries: Optional[np.ndarray] = None
                ) -> streaming.StreamingState:
        """Rebuild the moments from the served store (its live rows under
        the served model) and the retained query window: the way back when
        the moments themselves were poisoned."""
        if queries is None:
            if not self._recent_q:
                raise ValueError("no retained queries to recover K_Q from; "
                                 "pass queries= explicitly")
            queries = np.concatenate(list(self._recent_q), axis=0)
        fresh = streaming.init_from_artifacts(
            self.guarded.engine.state.artifacts, queries,
            refresh_every=int(stream.refresh_every))
        self.n_recoveries += 1
        return fresh


# ---------------------------------------------------------------------------
# Restart templates: the structure of a fit pipeline, without the fit.
# ---------------------------------------------------------------------------


def template_model(mode: str, dim: int, d: int, clusters: int = 8,
                   seed: int = 0, device=None):
    """A DR model with placeholder weights and the structure of a fit one
    (no training): what a restarted engine is built around before the
    snapshot's leaves replace it."""
    if mode == "full":
        return None
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    eye = torch.eye(dim, dtype=torch.float32, device=dev)
    if mode.startswith("sphering"):
        a = torch.as_tensor(rng.standard_normal((d, dim)), dtype=torch.float32,
                            device=dev) * 0.1
        return SpheringModel(a=a, b=a, p=a, w=eye, w_pinv=eye)
    centers = rng.standard_normal((clusters, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    ab = torch.as_tensor(rng.standard_normal((clusters, d, dim)),
                         dtype=torch.float32, device=dev) * 0.1
    return GleanVecModel(centers=torch.as_tensor(centers, device=dev), a=ab,
                         b=ab, w=eye, w_pinv=eye)


def template_stream(model, refresh_every: int = 1024
                    ) -> streaming.StreamingState:
    """Zero-moment :class:`StreamingState` around ``model``, with the
    structure of a live one (its leaves are restored over it)."""
    dim = model.w.shape[0]
    dev = model.w.device
    if isinstance(model, GleanVecModel):
        k_x = torch.zeros((model.n_clusters, dim, dim), device=dev)
    else:
        k_x = torch.zeros((dim, dim), device=dev)
    return streaming.StreamingState(
        k_q=torch.zeros((dim, dim), device=dev), k_x=k_x, model=model,
        prev_bw=model.b, updates_since=0, refresh_every=refresh_every)
