"""Batched vector-search serving engine (Algorithm 1 as a service; port of
``repro/serve/engine.py``).

The engine serves ``state_search(queries (B, D), state) -> ids (B, k)`` at
a fixed batch size, pads the tail batch, and records per-batch latency.
``swap`` installs a new state only if it keeps the installed state's
structure (:mod:`repro_torch.tree`: classes, an index's static
configuration -- an IVF index's ``nprobe`` and fine-step mode, a graph's
``beam``, ``max_hops``, ``expand``, ``fused`` and ``scan_tn``, whether it
carries ``nbr_rows`` -- and a host store's type, shape and dtype) and every
tensor's shape, dtype and device, so a swapped-in refresh serves through
the same kernels at the same shapes and allocates nothing on the device.

Two serving shapes, picked by where the rerank store lives:

* device ``x_full``: one step, scan + rerank, per batch;
* host ``x_full`` (:func:`repro_torch.core.search.demote_rerank_tier`):
  ``submit`` pipelines the batches. Batch i+1's scan is launched before
  batch i is drained; batch i's candidate ids come to pinned host memory
  through a non-blocking copy and an event, and
  :func:`repro_torch.core.rerank_tier.fetch` gathers their kappa rows into
  the slot's pinned staging buffer in chunks, copying each chunk to the
  device on a side stream while the next is gathered; the rerank runs on
  that stream after the copies, so it does not queue behind batch i+1's
  scan on the default stream. Only the candidate rows cross PCIe:
  ``stats.host_bytes`` adds up the bytes of the copies against the
  batch * kappa * D * 4 lower bound. ``search_with`` (one batch: the
  frontend, the canary) reaches the same ``fetch`` through
  :func:`repro_torch.core.search.rerank`, with staging from torch's
  caching pinned allocator.

PyTorch runs eagerly, so nothing is compiled; ``n_compiles`` counts the
distinct query-batch shapes the serving step has run (the reference's jit
cache, keyed by shape): the warm-up batch adds ``batch_size``, a frontend
adds its buckets, and a swap adds none. The warm-up is also where the CUDA
kernels are built and loaded.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass
from typing import Deque, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import rerank_tier
from repro_torch.core import search as msearch

__all__ = ["ServeStats", "ServingEngine", "make_search_fn",
           "sanitize_queries"]


def sanitize_queries(queries: np.ndarray, dim: int):
    """Validate a query batch and zero rows holding non-finite values.

    Raises ``ValueError`` for a wrong shape or a non-numeric dtype. Returns
    ``(clean (n, dim) float32, bad_rows (n,) bool)``; callers answer the
    flagged rows with all ``-1`` ids."""
    queries = np.asarray(queries)
    if queries.ndim != 2 or queries.shape[1] != dim:
        raise ValueError(f"queries must be a (n, {dim}) array; got shape "
                         f"{queries.shape}")
    if not (np.issubdtype(queries.dtype, np.floating)
            or np.issubdtype(queries.dtype, np.integer)):
        raise ValueError(f"queries must be real-valued (float or int), got "
                         f"dtype {queries.dtype}")
    queries = queries.astype(np.float32, copy=False)
    bad_rows = ~np.isfinite(queries).all(axis=1)
    if bad_rows.any():
        queries = np.where(bad_rows[:, None], np.float32(0), queries)
    return queries, bad_rows


def make_search_fn(artifacts, k: int, kappa: int, index=None):
    """One-shot convenience: ``queries (B, D) -> ids (B, k)`` over
    ``artifacts`` behind ``index`` (None = the flat scan). For anything
    long-lived or refreshable use :class:`ServingEngine`."""
    state = msearch.make_state(artifacts, index=index)

    def search_fn(queries):
        return msearch.state_search(queries, state, k, kappa)

    return search_fn


@dataclass
class ServeStats:
    """Serving counters. The ``*_ms`` deques are ring buffers over the last
    ``window`` entries; the scalars are lifetime totals.

    Overload (:mod:`repro_torch.serve.frontend`): ``n_rejected`` requests
    refused at enqueue (queue full, or a deadline the wait estimate cannot
    meet), ``n_shed`` dropped from the queue when their deadline passed,
    ``n_deadline_miss`` served after their deadline. Host tier:
    ``host_bytes`` the bytes of the rerank's host-to-device copies (on
    the CPU: of the gathered rows), added up copy by copy, against
    ``host_bytes_lb``, the batch * kappa * D * 4 bound; ``prefetch_ms``
    from the candidate ids on the host to the reranked ids on the host,
    with the host gather (``gather_ms``) and the H2D copies on the card
    (``copy_ms``, CUDA events) inside it, each summed over the batch's
    chunks (a chunk's copy overlaps the next chunk's gather)."""

    n_queries: int = 0
    n_batches: int = 0
    n_sanitized: int = 0
    total_s: float = 0.0
    n_rejected: int = 0
    n_shed: int = 0
    n_deadline_miss: int = 0
    host_bytes: int = 0
    host_bytes_lb: int = 0
    window: int = 8192
    latencies_ms: Optional[Deque[float]] = None
    swap_ms: Optional[Deque[float]] = None
    prefetch_ms: Optional[Deque[float]] = None
    gather_ms: Optional[Deque[float]] = None
    copy_ms: Optional[Deque[float]] = None
    request_ms: Optional[Deque[float]] = None     # frontend enqueue->resolve

    def __post_init__(self):
        for name in ("latencies_ms", "swap_ms", "prefetch_ms", "gather_ms",
                     "copy_ms", "request_ms"):
            if getattr(self, name) is None:
                setattr(self, name, collections.deque(maxlen=self.window))

    @property
    def qps(self) -> float:
        return self.n_queries / self.total_s if self.total_s else 0.0

    @property
    def host_bytes_ratio(self) -> float:
        """Measured host-to-device rerank traffic over the kappa-row bound
        (1.0: every byte moved is a candidate row)."""
        return self.host_bytes / self.host_bytes_lb \
            if self.host_bytes_lb else 0.0

    @staticmethod
    def _percentile(values, p: float) -> float:
        return float(np.percentile(np.asarray(values, np.float64), p)) \
            if values else 0.0

    def percentile_ms(self, p: float) -> float:
        return self._percentile(self.latencies_ms, p)

    def request_percentile_ms(self, p: float) -> float:
        """Percentile of per-request latency (enqueue -> resolved, queue
        wait included): the number an SLO is stated against."""
        return self._percentile(self.request_ms, p)

    @property
    def shed_rate(self) -> float:
        """Fraction of offered requests rejected or shed."""
        offered = self.n_queries + self.n_rejected + self.n_shed
        return (self.n_rejected + self.n_shed) / offered if offered else 0.0


def _aval(leaf):
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape), leaf.dtype, leaf.device)
    return (type(leaf).__name__,)


class _Slot:
    """Buffers of one in-flight batch of the pipelined submit: its
    candidate ids on the host, the staging rows of the host gather (both
    pinned on CUDA), the rows on the device, the event after its
    candidates and a pair of timing events a chunk's copy."""

    def __init__(self, batch: int, kappa: int, dim: int, dtype,
                 device: torch.device):
        cuda = device.type == "cuda"
        self.cand: Optional[torch.Tensor] = None    # sized at first use
        self.staging = torch.empty((batch * kappa, dim), dtype=dtype,
                                   pin_memory=cuda)
        self.rows = torch.empty((batch * kappa, dim), dtype=dtype,
                                device=device) if cuda else None
        self.ev_cand = torch.cuda.Event() if cuda else None
        self.ev_copy = [(torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
                        for _ in range(rerank_tier.COPY_CHUNKS)] \
            if cuda else None


class ServingEngine:
    """Serves ``state_search`` at a fixed batch size with a swappable state.

    ``state`` is a :class:`~repro_torch.core.search.ServingState`; its
    tensors live on the device the queries are sent to, and the engine
    serves on that device's default stream. The engine never donates or
    mutates a state, so a displaced one stays valid (the lifecycle layer's
    rollback target)."""

    def __init__(self, state: msearch.ServingState, k: int, kappa: int,
                 batch_size: int, dim: int, stats_window: int = 8192):
        self.k = k
        self.kappa = kappa
        self.batch_size = batch_size
        self.dim = dim
        self.stats = ServeStats(window=stats_window)
        self.state = state
        self.n_swaps = 0
        self._version0 = int(state.version)
        self._shapes: set = set()
        self.device = msearch.artifacts_device(state.artifacts)
        self._host = msearch.host_tier(state.artifacts)
        self._slots = self._copy_stream = None
        if self._host is not None:
            self._slots = [_Slot(batch_size, kappa, self._host.shape[1],
                                 self._host.dtype, self.device)
                           for _ in range(2)]
            if self.device.type == "cuda":
                self._copy_stream = torch.cuda.Stream(self.device)
        # warm-up: builds and loads the kernels this state lowers to; over
        # a host store also both slots of the pipeline and the side
        # stream's first rerank (its handles and allocator blocks), then
        # the stats start afresh
        dummy = np.zeros((batch_size, dim), np.float32)
        self.search_with(dummy, self.state)
        if self._host is not None:
            self._submit_pipelined(np.concatenate([dummy, dummy]))
            self.stats = ServeStats(window=stats_window)

    @property
    def version(self) -> int:
        return int(self.state.version)

    @property
    def n_compiles(self) -> int:
        """Distinct query-batch shapes the serving step has run."""
        return len(self._shapes)

    def search_with(self, queries, state: msearch.ServingState) -> np.ndarray:
        """One search of ``queries`` against ``state`` without installing
        it or touching the stats (the lifecycle layer's canary and the
        frontend's dispatcher). Over a host tier the candidate rows come
        from ``state``'s own store. Returns (m, k) int32 ids."""
        q = torch.as_tensor(np.asarray(queries, np.float32),
                            device=self.device)
        self._shapes.add(int(q.shape[0]))
        ids = msearch.state_search(q, state, self.k, self.kappa)
        return ids.cpu().numpy().astype(np.int32, copy=False)

    def _check_swap_compatible(self, state: msearch.ServingState) -> None:
        """Raise ``ValueError`` unless ``state`` keeps the installed one's
        structure and every leaf's shape, dtype and device. Never mutates
        the engine."""
        paths, old, old_def = tree.flatten_with_paths(self.state)
        _, new, new_def = tree.flatten_with_paths(state)
        if old_def != new_def:
            raise ValueError("swap would change the state's structure "
                             f"(treedef):\n  installed: {old_def}\n"
                             f"  offered:   {new_def}")
        for p, o, n in zip(paths, old, new):
            if _aval(o) != _aval(n):
                raise ValueError(f"swap would change leaf {p}'s shape, "
                                 f"dtype or device (aval): {_aval(o)} -> "
                                 f"{_aval(n)}")

    def swap(self, state: msearch.ServingState) -> None:
        """Install ``state`` (raises before touching the engine if the
        check fails); the version continues from the engine's clock."""
        self._check_swap_compatible(state)
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            self._adopt(state)
        self.n_swaps += 1
        self.state = state._replace(version=self._version0 + self.n_swaps)
        if self._host is not None:
            self._host = msearch.host_tier(self.state.artifacts)
        self.stats.swap_ms.append((time.perf_counter() - t0) * 1e3)

    def _adopt(self, state: msearch.ServingState) -> None:
        """A state made on another CUDA stream (a background refresh's):
        finish that stream's work, and mark the state's tensors as used by
        the default stream the engine serves on, so the caching allocator
        does not reuse their memory for that stream's next refresh while a
        batch still reads them. Allocates nothing."""
        cur = torch.cuda.current_stream(self.device)
        serving = torch.cuda.default_stream(self.device)
        if cur == serving:
            return
        cur.synchronize()
        for leaf in tree.leaves(state):
            if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                leaf.record_stream(serving)

    def submit(self, queries: np.ndarray) -> np.ndarray:
        """Answer all queries in fixed-size batches (the tail is padded).

        An empty batch returns ``(0, k)``; a malformed one raises
        ``ValueError``; rows with non-finite values are zeroed before
        batching and answered with all ``-1`` ids (``stats.n_sanitized``).
        Over a host tier the batches are pipelined (module docstring)."""
        queries = np.asarray(queries)
        if queries.size == 0 and queries.ndim <= 2:
            return np.zeros((0, self.k), np.int32)
        queries, bad_rows = sanitize_queries(queries, self.dim)
        if bad_rows.any():
            self.stats.n_sanitized += int(bad_rows.sum())
        if self._host is not None:
            result = self._submit_pipelined(queries)
        else:
            result = self._submit_steps(queries)
        result = result.astype(np.int32, copy=False)
        if bad_rows.any():
            result[bad_rows] = -1
        return result

    def _batches(self, queries: np.ndarray):
        """(padded chunk, rows kept, live rows) per fixed-size batch."""
        n = queries.shape[0]
        for s in range(0, n, self.batch_size):
            chunk = queries[s:s + self.batch_size]
            pad = self.batch_size - chunk.shape[0]
            if pad:
                chunk = np.pad(chunk, ((0, pad), (0, 0)))
            yield chunk, self.batch_size - pad, min(self.batch_size, n - s)

    def _submit_steps(self, queries: np.ndarray) -> np.ndarray:
        out = []
        for chunk, keep, n_live in self._batches(queries):
            t0 = time.perf_counter()
            q = torch.as_tensor(chunk, device=self.device)
            ids = msearch.state_search(q, self.state, self.k,
                                       self.kappa).cpu().numpy()
            dt = time.perf_counter() - t0
            self.stats.n_batches += 1
            self.stats.n_queries += n_live
            self.stats.total_s += dt
            self.stats.latencies_ms.append(dt * 1e3)
            out.append(ids[:keep])
        return np.concatenate(out, axis=0)

    def _submit_pipelined(self, queries: np.ndarray) -> np.ndarray:
        """Two batches in flight (host tier): launch batch i+1's scan,
        then drain batch i (:meth:`_finish`) while the card runs it. QPS
        comes from the submit's wall time, since the batches' windows
        overlap."""
        out, pending = [], None
        t_submit = time.perf_counter()
        for i, (chunk, keep, n_live) in enumerate(self._batches(queries)):
            t0 = time.perf_counter()
            state = self.state
            slot = self._slots[i % 2]
            q = torch.as_tensor(chunk, device=self.device)
            cand = msearch.state_candidates(q, state, self.kappa)
            q_full = msearch._rotate_queries(q, state.artifacts)
            if slot.ev_cand is not None:
                if slot.cand is None or slot.cand.shape != cand.shape \
                        or slot.cand.dtype != cand.dtype:
                    slot.cand = torch.empty(cand.shape, dtype=cand.dtype,
                                            pin_memory=True)
                slot.cand.copy_(cand, non_blocking=True)
                slot.ev_cand.record()
            else:
                slot.cand = cand
            if pending is not None:
                out.append(self._finish(*pending))
            pending = (slot, msearch.host_tier(state.artifacts), cand, q_full,
                       keep, n_live, t0)
        out.append(self._finish(*pending))
        self.stats.total_s += time.perf_counter() - t_submit
        return np.concatenate(out, axis=0)

    def _finish(self, slot: _Slot, store, cand, q_full, keep: int,
                n_live: int, t0: float) -> np.ndarray:
        """Drain one in-flight batch: wait for its candidate ids, fetch
        their rows from the host store into the slot's buffers (chunks
        copied to the card on the side stream while the next is gathered)
        and rerank there after the copies (not behind the next batch's
        scan on the default stream)."""
        m, kappa = cand.shape
        if slot.ev_cand is not None:
            slot.ev_cand.synchronize()
        tp = time.perf_counter()
        side = self._copy_stream
        with torch.cuda.stream(side):       # None on the CPU: a no-op
            if side is not None:
                side.wait_event(slot.ev_cand)  # q_full and cand are made
            rows, gathers, nbytes = rerank_tier.fetch(
                store, slot.cand, self.device, staging=slot.staging,
                out=slot.rows, chunks=rerank_tier.COPY_CHUNKS,
                events=slot.ev_copy)
            ids = msearch.rerank_candidates(q_full, rows.view(m, kappa, -1),
                                            cand, self.k).cpu()
        ids = ids.numpy()
        now = time.perf_counter()
        st = self.stats
        st.prefetch_ms.append((now - tp) * 1e3)
        st.gather_ms.append(sum(gathers) * 1e3)
        if slot.ev_copy is not None:
            st.copy_ms.append(sum(a.elapsed_time(b) for a, b
                                  in slot.ev_copy[:len(gathers)]))
        st.host_bytes += nbytes
        st.host_bytes_lb += m * self.kappa * store.shape[1] \
            * rows.element_size()
        st.n_batches += 1
        st.n_queries += n_live
        st.latencies_ms.append((now - t0) * 1e3)
        return ids[:keep]
