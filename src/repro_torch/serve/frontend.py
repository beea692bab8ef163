"""Overload-safe serving frontend: a bounded-queue request coalescer with
deadline admission, and a supervised background refresh worker (port of
``repro/serve/frontend.py``).

* :class:`ServingFrontend` -- concurrent clients ``enqueue(query,
  deadline_ms)`` into a fixed-capacity queue; one dispatcher thread drains
  it into padded batches of a small static set of shapes
  (:func:`bucket_shapes`) and serves them through
  ``engine.search_with(batch, engine.state)``. A request coalesced into a
  bucket gets the ids the same query gets through ``submit`` alone.
  Malformed requests raise at ``enqueue``; poisoned rows are zeroed and
  answered with -1 ids.
* Admission and shedding, loud: a full queue, or a deadline the wait
  estimate (EWMA batch latency x queue depth in buckets) cannot meet,
  raises :class:`Rejected` at enqueue (``ServeStats.n_rejected``); a
  request whose deadline passes in the queue is shed at dispatch, its
  future failing with ``Rejected("shed")`` (``n_shed``).
* :class:`RefreshWorker` -- the Section 3.2 refresh on its own thread
  under :class:`~repro_torch.serve.lifecycle.RefreshSupervisor`, handing
  finished states to ``GuardedEngine.swap``. Serving never waits on a
  refresh: the dispatcher reads ``engine.state`` once a batch (one
  reference read; states are never mutated), so a slow, stuck or crashed
  worker leaves the last good state serving and only ``staleness_s``
  grows. On the card the worker runs its refresh and canary on a CUDA
  stream of its own, so the dispatcher's kernels on the default stream do
  not queue behind them. That stream waits for the default stream's work
  at the start of a cycle and is finished at its end;
  ``ServingEngine.swap`` ties the new state's tensors to the default
  stream (see there).

The deterministic core is :meth:`ServingFrontend.drain_once` with an
injectable ``clock``; the dispatcher thread is a loop over it.
"""
from __future__ import annotations

import collections
import math
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import streaming
from repro_torch.serve.engine import ServingEngine, sanitize_queries
from repro_torch.serve.lifecycle import GuardedEngine, RefreshSupervisor

__all__ = ["MAX_BUCKETS", "Rejected", "bucket_shapes", "ServingFrontend",
           "RefreshWorker"]

# Ceiling on the static bucket set: every dispatched batch has one of at
# most MAX_BUCKETS shapes.
MAX_BUCKETS = 12


class Rejected(RuntimeError):
    """Backpressure: the frontend refused or shed a request. ``reason`` is
    ``queue-full``, ``deadline`` (the wait estimate exceeds the budget),
    ``shed`` (the deadline passed while queued) or ``shutdown``."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        super().__init__(f"request rejected ({reason}): {detail}" if detail
                         else f"request rejected ({reason})")


def bucket_shapes(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to, and always including, ``max_batch``: padding
    waste at most 2x, O(log max_batch) shapes, all warmed up front."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    shapes = set()
    b = 1
    while b < max_batch:
        shapes.add(b)
        b *= 2
    shapes.add(max_batch)
    out = tuple(sorted(shapes))
    if len(out) > MAX_BUCKETS:
        raise ValueError(
            f"{len(out)} bucket shapes exceed MAX_BUCKETS={MAX_BUCKETS}")
    return out


@dataclass
class _Request:
    """One admitted request (a single query vector)."""

    query: np.ndarray            # (1, dim) float32, sanitized
    poisoned: bool               # non-finite row: answered with -1 ids
    deadline: float              # absolute clock time (math.inf: none)
    t_enqueue: float
    future: Future


class ServingFrontend:
    """Bounded-queue request coalescer over a :class:`ServingEngine` (or a
    :class:`~repro_torch.serve.lifecycle.GuardedEngine`, through its
    ``.engine``).

    ``capacity`` bounds the queue; ``default_deadline_ms`` applies to an
    ``enqueue`` without a deadline (None: no deadline);
    ``est_batch_ms`` / ``ewma_alpha`` seed and smooth the wait estimate;
    ``clock`` is injectable. ``start=False`` runs no dispatcher thread:
    drive :meth:`drain_once` directly. ``batch_spans`` keeps the last
    batches' (start, end) on ``clock``, for reading overlap with a
    refresh."""

    def __init__(self, engine, capacity: int = 256,
                 buckets: Optional[Sequence[int]] = None,
                 default_deadline_ms: Optional[float] = None,
                 est_batch_ms: float = 5.0, ewma_alpha: float = 0.2,
                 clock: Callable[[], float] = time.monotonic,
                 start: bool = True, warmup: bool = True):
        self.engine: ServingEngine = getattr(engine, "engine", engine)
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.buckets = tuple(sorted(buckets)) if buckets is not None \
            else bucket_shapes(self.engine.batch_size)
        if len(self.buckets) > MAX_BUCKETS:
            raise ValueError(f"{len(self.buckets)} buckets exceed "
                             f"MAX_BUCKETS={MAX_BUCKETS}")
        self.max_bucket = self.buckets[-1]
        self.default_deadline_ms = default_deadline_ms
        self.stats = self.engine.stats
        self._ewma_s = est_batch_ms / 1e3
        self._ewma_alpha = float(ewma_alpha)
        self._clock = clock
        self._cv = threading.Condition(threading.Lock())
        self._queue: collections.deque = collections.deque()
        self._closed = False
        self.dispatched_shapes: set = set()
        self.batch_spans: collections.deque = collections.deque(maxlen=8192)
        self._thread: Optional[threading.Thread] = None
        if warmup:
            self.warmup()
        if start:
            self._thread = threading.Thread(target=self._dispatch_loop,
                                            name="frontend-dispatch",
                                            daemon=True)
            self._thread.start()

    # -- warm-up / observability -------------------------------------------
    def warmup(self) -> None:
        """Run every bucket shape once (``engine.n_compiles`` then counts
        them all, and serving adds none)."""
        for b in self.buckets:
            self.engine.search_with(np.zeros((b, self.engine.dim),
                                             np.float32), self.engine.state)

    @property
    def queue_depth(self) -> int:
        with self._cv:
            return len(self._queue)

    def estimated_wait_s(self, depth: Optional[int] = None) -> float:
        """Batches ahead of (and including) a new request, times the EWMA
        batch latency."""
        if depth is None:
            depth = self.queue_depth
        return (depth // self.max_bucket + 1) * self._ewma_s

    # -- admission ----------------------------------------------------------
    def enqueue(self, query: np.ndarray,
                deadline_ms: Optional[float] = None) -> Future:
        """Admit one query vector; the future resolves to its (k,) int32
        ids. Malformed input raises ``ValueError``; a full queue or an
        unmeetable deadline raises :class:`Rejected`."""
        q = np.asarray(query)
        if q.ndim == 1:
            q = q[None, :]
        if q.ndim != 2 or q.shape[0] != 1:
            raise ValueError(
                f"enqueue takes ONE query vector per request; got shape "
                f"{np.shape(query)} (use ServingEngine.submit for batches)")
        q, bad = sanitize_queries(q, self.engine.dim)
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        now = self._clock()
        deadline = math.inf if deadline_ms is None \
            else now + deadline_ms / 1e3
        with self._cv:
            if self._closed:
                raise Rejected("shutdown", "frontend is closed")
            if len(self._queue) >= self.capacity:
                self.stats.n_rejected += 1
                raise Rejected(
                    "queue-full",
                    f"admission queue at capacity {self.capacity}")
            est = self.estimated_wait_s(len(self._queue))
            if now + est > deadline:
                self.stats.n_rejected += 1
                raise Rejected(
                    "deadline",
                    f"predicted wait {est * 1e3:.1f}ms exceeds budget "
                    f"{deadline_ms:.1f}ms at depth {len(self._queue)}")
            if bad[0]:
                self.stats.n_sanitized += 1
            req = _Request(query=q, poisoned=bool(bad[0]),
                           deadline=deadline, t_enqueue=now,
                           future=Future())
            self._queue.append(req)
            self._cv.notify()
        return req.future

    # -- dispatch -----------------------------------------------------------
    def _pick_bucket(self, n: int) -> int:
        """Smallest bucket holding ``n`` requests."""
        for b in self.buckets:
            if b >= n:
                return b
        return self.max_bucket

    def _take(self, timeout: Optional[float]
              ) -> Tuple[List[_Request], List[_Request]]:
        """Pop up to ``max_bucket`` requests, splitting off those whose
        deadline cannot survive one more batch (shed)."""
        with self._cv:
            if not self._queue and timeout:
                self._cv.wait(timeout)
            batch: List[_Request] = []
            shed: List[_Request] = []
            horizon = self._clock() + self._ewma_s
            while self._queue and len(batch) < self.max_bucket:
                req = self._queue.popleft()
                (shed if req.deadline < horizon else batch).append(req)
        return batch, shed

    def drain_once(self, timeout: Optional[float] = None) -> int:
        """One dispatcher round: shed expired requests, serve the rest as
        one padded bucket, slice the results back. Returns the number of
        requests retired (served + shed)."""
        batch, shed = self._take(timeout)
        for req in shed:
            self.stats.n_shed += 1
            req.future.set_exception(
                Rejected("shed", "deadline expired while queued"))
        if not batch:
            return len(shed)
        b = self._pick_bucket(len(batch))
        chunk = np.zeros((b, self.engine.dim), np.float32)
        for i, req in enumerate(batch):
            chunk[i] = req.query[0]
        t0 = self._clock()
        try:
            # one reference read: a concurrent swap lands before or after
            # this batch, never inside it
            state = self.engine.state
            ids = self.engine.search_with(chunk, state)
        except Exception as e:      # noqa: BLE001 -- fail THIS batch only
            for req in batch:
                req.future.set_exception(e)
            return len(batch) + len(shed)
        dt = self._clock() - t0
        a = self._ewma_alpha
        self._ewma_s = a * dt + (1 - a) * self._ewma_s
        self.dispatched_shapes.add(b)
        self.stats.n_batches += 1
        self.stats.n_queries += len(batch)
        self.stats.total_s += dt
        self.stats.latencies_ms.append(dt * 1e3)
        now = self._clock()
        self.batch_spans.append((t0, now))
        for i, req in enumerate(batch):
            self.stats.request_ms.append((now - req.t_enqueue) * 1e3)
            if now > req.deadline:
                self.stats.n_deadline_miss += 1
            out = np.full((self.engine.k,), -1, np.int32) if req.poisoned \
                else ids[i].astype(np.int32, copy=True)
            req.future.set_result(out)
        return len(batch) + len(shed)

    def _dispatch_loop(self) -> None:
        while True:
            with self._cv:
                if self._closed and not self._queue:
                    return
            self.drain_once(timeout=0.02)

    # -- shutdown -----------------------------------------------------------
    def close(self, drain: bool = True, timeout: float = 10.0) -> None:
        """Stop admitting; serve the backlog (``drain=True``) or fail it
        with ``Rejected("shutdown")``. Idempotent."""
        with self._cv:
            self._closed = True
            if not drain:
                while self._queue:
                    req = self._queue.popleft()
                    req.future.set_exception(
                        Rejected("shutdown", "frontend closed"))
            self._cv.notify_all()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout)
        if drain:
            while self.queue_depth:
                self.drain_once()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class RefreshWorker:
    """Supervised background refresh: ``observe -> refresh ->
    refresh_state -> GuardedEngine.swap`` on its own thread.

    The worker owns the :class:`~repro_torch.core.streaming.StreamingState`;
    traffic threads feed it through :meth:`observe` (bounded) and kick
    cycles through :meth:`request_refresh` (or every ``interval_s``). Each
    cycle runs the supervisor's ladder; a degraded cycle recovers the
    moments from the served store so the next one swaps clean. A refresh
    that hangs strands only this daemon thread (``stuck`` turns true,
    ``staleness_s`` grows); a crash outside the supervisor is kept in
    ``crashed`` and ends the loop, serving untouched.

    On a CUDA engine the worker takes a stream of its own (raising if it
    cannot); see the module docstring. ``cycle_spans`` keeps each cycle's
    (start, end) on ``clock``."""

    def __init__(self, supervisor: RefreshSupervisor,
                 stream: streaming.StreamingState, source: str = "stored",
                 refresh_fn=streaming.refresh, interval_s: float = 0.0,
                 pending_window: int = 64,
                 clock: Callable[[], float] = time.monotonic):
        self.supervisor = supervisor
        self.guarded: GuardedEngine = supervisor.guarded
        self.stream = stream
        self.source = source
        self.refresh_fn = refresh_fn
        self.interval_s = interval_s
        self._clock = clock
        self._pending: collections.deque = collections.deque(
            maxlen=pending_window)
        self._pending_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self.n_cycles = 0
        self.crashed: Optional[BaseException] = None
        self.last_swap_t = clock()
        self._cycle_t0: Optional[float] = None
        self.cycle_spans: collections.deque = collections.deque(maxlen=1024)
        dev = self.guarded.engine.device
        self._cuda_stream = torch.cuda.Stream(dev) \
            if dev.type == "cuda" else None
        self._thread = threading.Thread(target=self._loop,
                                        name="refresh-worker", daemon=True)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "RefreshWorker":
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> bool:
        """Ask the worker to exit; False when the thread is still alive
        (stuck inside a hung refresh: a daemon, it never pins the
        process)."""
        self._stop.set()
        self._wake.set()
        if self._thread.is_alive():
            self._thread.join(timeout)
        return not self._thread.is_alive()

    # -- traffic-side API ---------------------------------------------------
    def observe(self, queries: np.ndarray) -> None:
        """Queue served queries for the next cycle's K_Q update and the
        supervisor's recovery window (old observations drop first)."""
        q = np.asarray(queries, np.float32)
        with self._pending_lock:
            self._pending.append(q)
        self.supervisor.note_queries(q)

    def request_refresh(self) -> None:
        """Kick one supervised refresh cycle."""
        self._wake.set()

    # -- health observables -------------------------------------------------
    @property
    def degraded(self) -> bool:
        return self.supervisor.degraded

    @property
    def in_cycle_s(self) -> float:
        """Seconds the current cycle has run (0 when idle)."""
        t0 = self._cycle_t0
        return self._clock() - t0 if t0 is not None else 0.0

    def stuck(self, timeout_s: float) -> bool:
        """True when the cycle in flight has run past ``timeout_s``."""
        return self.in_cycle_s > timeout_s

    @property
    def staleness_s(self) -> float:
        """Seconds since the last refresh that swapped in."""
        return self._clock() - self.last_swap_t

    @property
    def healthy(self) -> bool:
        return self.crashed is None and self._thread.is_alive()

    # -- the supervised cycle -----------------------------------------------
    def _refresh(self, pending):
        """Fold ``pending`` into K_Q, then refresh, canary and swap, all on
        the worker's stream (None on the CPU: a no-op). That stream first
        waits for the work queued on the default stream so far (the state
        it reads may have been written there: the initial stream, inserts,
        the served state), and is finished before this returns, so no
        tensor it reads is released while a kernel of it is pending. The
        engine's swap finishes it too before it installs the state."""
        side = self._cuda_stream
        with torch.cuda.stream(side):
            if side is not None:
                side.wait_stream(torch.cuda.default_stream(side.device))
            try:
                stream = self.stream
                for q in pending:
                    stream = streaming.observe_queries(stream, q)
                self.stream = stream    # observations survive a failure
                return self.supervisor.refresh_and_swap(
                    stream, source=self.source, refresh_fn=self.refresh_fn)
            finally:
                if side is not None:
                    side.synchronize()

    def run_cycle(self) -> Optional[object]:
        """One supervised refresh cycle, synchronously (the thread's loop
        calls this; tests may too). Returns the ``RefreshReport``."""
        t0 = self._cycle_t0 = self._clock()
        try:
            with self._pending_lock:
                pending = list(self._pending)
                self._pending.clear()
            stream, report = self._refresh(pending)
            self.stream = stream
            self.n_cycles += 1
            if report.outcome == "ok":
                self.last_swap_t = self._clock()
            else:
                try:
                    self.stream = self.supervisor.recover(stream)
                except ValueError:
                    pass            # no retained queries yet: stay degraded
            return report
        finally:
            self.cycle_spans.append((t0, self._clock()))
            self._cycle_t0 = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            fired = self._wake.wait(
                self.interval_s if self.interval_s > 0 else None)
            if self._stop.is_set():
                return
            if fired:
                self._wake.clear()
            try:
                self.run_cycle()
            except BaseException as e:   # noqa: BLE001 -- watchdog record
                # outside the supervisor's net: record and stand down; the
                # engine keeps serving its state
                self.crashed = e
                return
