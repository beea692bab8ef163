"""Deterministic fault injectors for the serving lifecycle (port of
``repro/serve/faults.py``).

Each injector produces one corruption a streamed serving stack meets --
non-finite moments from a poisoned query batch, a corrupted scorer leaf,
an exception mid-refresh, a truncated snapshot, a poisoned or mis-shaped
query batch -- as a pure function of its inputs (and an explicit seed), so
the recovery tests and the drills replay the same failures. ``FAULTS``
names the kinds ``launch/serve.py --stream --inject-fault`` drills;
``FRONTEND_FAULTS`` the concurrency drills of ``--frontend``: a stuck
refresh worker, a slow refresh, a poisoned query burst and an overflowing
admission queue.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import search as msearch
from repro_torch.core import streaming
from repro_torch.train import checkpoint

__all__ = ["FAULTS", "FRONTEND_FAULTS", "nan_moments",
           "corrupt_scorer_leaf", "scramble_scorer_leaf", "failing",
           "truncate_snapshot", "poison_queries", "wrong_dim_queries",
           "slow_refresh", "stuck_worker", "burst_overflow"]

FAULTS = ("nan-moments", "corrupt-scorer", "scramble-scorer",
          "refresh-exception", "truncated-snapshot", "poison-queries",
          "wrong-dim-queries")

FRONTEND_FAULTS = ("stuck-worker", "slow-refresh", "poison-burst",
                   "queue-overflow")


def nan_moments(stream: streaming.StreamingState,
                n: int = 4) -> streaming.StreamingState:
    """NaN in the first ``n`` entries of K_X, as a batch with non-finite
    rows leaves the Eq. 11 updates: every later ``refresh`` fits a
    non-finite model from them."""
    flat = stream.k_x.reshape(-1).clone()
    flat[:n] = float("nan")
    return stream._replace(k_x=flat.reshape(stream.k_x.shape))


def _scorer_leaves(scorer):
    return tree.flatten(scorer)


def _replace_leaf(state: msearch.ServingState, idx: int, leaf):
    leaves, treedef = _scorer_leaves(state.artifacts.scorer)
    leaves[idx] = leaf
    arts = state.artifacts._replace(scorer=treedef.unflatten(leaves))
    return state._replace(artifacts=arts)


def corrupt_scorer_leaf(state: msearch.ServingState, n: int = 8,
                        value: float = float("nan")
                        ) -> msearch.ServingState:
    """``value`` (NaN) in the first ``n`` entries of the scorer's largest
    float leaf: the candidate a guarded swap's finite scan must refuse."""
    leaves, _ = _scorer_leaves(state.artifacts.scorer)
    floats = [i for i, lf in enumerate(leaves)
              if isinstance(lf, torch.Tensor) and lf.is_floating_point()]
    if not floats:
        raise ValueError("scorer has no float leaves to corrupt")
    idx = max(floats, key=lambda i: leaves[i].numel())
    lf = leaves[idx]
    bad = lf.reshape(-1).clone()
    bad[:n] = value
    return _replace_leaf(state, idx, bad.reshape(lf.shape))


def scramble_scorer_leaf(state: msearch.ServingState) -> msearch.ServingState:
    """Roll the rows of the scorer's largest >= 2-d leaf by half: every
    value stays finite, but the row <-> id map is garbage -- only the
    canary can catch it."""
    leaves, _ = _scorer_leaves(state.artifacts.scorer)
    wide = [i for i, lf in enumerate(leaves)
            if isinstance(lf, torch.Tensor) and lf.ndim >= 2]
    if not wide:
        raise ValueError("scorer has no >=2-d leaves to scramble")
    idx = max(wide, key=lambda i: leaves[i].numel())
    lf = leaves[idx]
    return _replace_leaf(state, idx, torch.roll(lf, lf.shape[0] // 2, 0))


class failing:
    """Wrap ``fn`` so its first ``n_failures`` calls raise, then delegate:
    the exception mid-refresh for the supervisor's retry path."""

    def __init__(self, fn, n_failures: int = 1, exc: type = RuntimeError):
        self.fn = fn
        self.n_failures = n_failures
        self.exc = exc
        self.calls = 0
        self.failures = 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if self.failures < self.n_failures:
            self.failures += 1
            raise self.exc(
                f"injected refresh failure {self.failures}/{self.n_failures}")
        return self.fn(*args, **kwargs)


def truncate_snapshot(snap_dir: str, step: Optional[int] = None,
                      what: str = "leaf") -> str:
    """Halve a durable step's manifest (``what="manifest"``: undecodable
    json) or its largest leaf file (``"leaf"``: ``np.load`` fails short);
    returns the path. ``lifecycle.restore`` must fall back a step."""
    steps = checkpoint.available_steps(snap_dir)
    if not steps:
        raise FileNotFoundError(f"no snapshot steps under {snap_dir}")
    step = steps[-1] if step is None else step
    d = os.path.join(snap_dir, f"step_{step:08d}")
    if what == "manifest":
        path = os.path.join(d, "manifest.json")
    elif what == "leaf":
        npys = [os.path.join(d, f) for f in os.listdir(d)
                if f.endswith(".npy")]
        path = max(npys, key=os.path.getsize)
    else:
        raise ValueError(f"unknown truncation target {what!r}")
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:len(data) // 2])
    return path


def poison_queries(queries: np.ndarray, rows: Sequence[int] = (0,),
                   value: float = float("nan")) -> np.ndarray:
    """A copy of ``queries`` with ``value`` planted in the given rows:
    ``submit`` must answer them with -1 and leave their batch-mates
    exact."""
    q = np.array(queries, np.float32, copy=True)
    q[list(rows), 0] = value
    return q


def wrong_dim_queries(queries: np.ndarray) -> np.ndarray:
    """The batch without its last feature: must raise ``ValueError``."""
    return np.asarray(queries)[:, :-1]


class slow_refresh:
    """Wrap a refresh so every call first sleeps ``delay_s`` (a latency
    spike): a frontend with a background worker keeps serving throughout.
    ``sleep`` is injectable; ``calls`` counts calls."""

    def __init__(self, fn=streaming.refresh, delay_s: float = 0.2,
                 sleep=time.sleep):
        self.fn = fn
        self.delay_s = delay_s
        self.sleep = sleep
        self.calls = 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        self.sleep(self.delay_s)
        return self.fn(*args, **kwargs)


class stuck_worker:
    """Wrap a refresh so every call blocks until ``release`` is set (hung
    I/O, a deadlocked solve), then delegates; ``timeout_s`` is a backstop
    that raises. The serving path must be unaffected and
    ``RefreshWorker.stuck`` must turn true."""

    def __init__(self, release: threading.Event, fn=streaming.refresh,
                 timeout_s: float = 30.0):
        self.release = release
        self.fn = fn
        self.timeout_s = timeout_s
        self.calls = 0
        self.releases = 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if not self.release.wait(self.timeout_s):
            raise TimeoutError(
                f"stuck_worker held past its {self.timeout_s}s backstop")
        self.releases += 1
        return self.fn(*args, **kwargs)


def burst_overflow(dim: int, n: int, seed: int = 0,
                   poison_frac: float = 0.0) -> np.ndarray:
    """A seeded (n, dim) query burst (pick ``n`` > capacity + one bucket to
    overflow a queue); ``poison_frac`` of its rows carry a NaN."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, dim)).astype(np.float32)
    if poison_frac > 0:
        n_bad = max(1, int(round(poison_frac * n)))
        rows = rng.choice(n, size=n_bad, replace=False)
        q[rows, 0] = np.nan
    return q
