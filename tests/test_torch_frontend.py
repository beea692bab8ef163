"""The port's coalescing frontend and background refresh worker
(``serve/frontend.py``, the frontend injectors of ``serve/faults.py``)
against the JAX reference.

On the CPU (JAX imported inside the fixtures and tests, so the card can
collect the file):

* ``bucket_shapes`` and ``MAX_BUCKETS`` equal the reference's;
* admission, shedding and deadline misses: the same request script under
  the same ticking clock gives every request the reference's outcome
  (served, or refused with the same reason at enqueue or at dispatch) and
  the same counters, dispatched shapes and per-request latencies;
* a request coalesced into any bucket gets exactly the ids ``submit``
  gives it (both tiers), and a poisoned row is -1 without touching its
  bucket-mates;
* the worker: a failing refresh degrades, recovers and swaps; a stuck
  refresh is flagged while the threaded frontend keeps serving the stale
  state, and a release swaps;
* every ``--frontend --inject-fault`` kind, and a plain run with the host
  tier and a deadline, through ``launch.serve.main`` with ``--device cpu``.

On the card (``cuda`` marker): coalesced ids equal ``submit``'s in every
bucket over both tiers; the dispatcher completes batches while the
worker refreshes on its own CUDA stream; that stream waits for the default
stream's pending writes before a cycle reads them.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import search, streaming
from repro_torch.serve import faults, frontend, lifecycle
from repro_torch.serve.engine import ServingEngine

D, N, N0, CAP = 32, 512, 384, 512
K, KAPPA = 10, 30


class _World:
    def __init__(self):
        import jax
        import jax.numpy as jnp
        from repro.core import gleanvec as rgv
        from repro.core import streaming as rst
        from repro.data import vectors as rvectors
        self.ds = rvectors.make_dataset("frontend", n=N, d=D, n_queries=256,
                                        ood=True, seed=9)
        x = jnp.asarray(self.ds.database)
        self.model = rgv.fit(jax.random.PRNGKey(0),
                             jnp.asarray(self.ds.queries_learn), x[:N0], c=4,
                             d=8)
        self.ref_arts = {}
        self.arts = {}
        for mode in ("gleanvec-int8", "gleanvec-int8-sorted"):
            ra = rst.build_streaming_artifacts(mode, x[:N0], self.model,
                                               capacity=CAP, sort_block=64,
                                               slack_blocks=2)
            self.ref_arts[mode] = ra
            self.arts[mode] = search.SearchArtifacts(
                scorer=convert.scorer(type(ra.scorer).__name__,
                                      convert.arrays_of(ra.scorer), "cpu"),
                x_full=torch.from_numpy(np.array(ra.x_full)),
                model=convert.gleanvec_model(convert.arrays_of(self.model),
                                             "cpu"))
        self.queries = self.ds.queries_test


@pytest.fixture(scope="module")
def world():
    return _World()


def _engine(world, mode="gleanvec-int8", host=False, batch=16):
    arts = world.arts[mode]
    if host:
        arts = search.demote_rerank_tier(arts)
    return ServingEngine(search.make_state(arts), k=K, kappa=KAPPA,
                         batch_size=batch, dim=D)


def test_bucket_shapes_match_reference():
    from repro.serve import frontend as rfe
    assert frontend.MAX_BUCKETS == rfe.MAX_BUCKETS
    for b in (1, 2, 3, 16, 48, 64, 100, 1024, 2048):
        assert frontend.bucket_shapes(b) == rfe.bucket_shapes(b)
    for b in (0, 4096):
        with pytest.raises(ValueError):
            frontend.bucket_shapes(b)
        with pytest.raises(ValueError):
            rfe.bucket_shapes(b)


class _Ticking:
    """A clock that moves ``step`` seconds at every read."""

    def __init__(self, step):
        self.t, self.step = 0.0, step

    def __call__(self):
        self.t += self.step
        return self.t


# (operation, deadline_ms): "q" enqueues the next query, "p" a poisoned
# one, "d" drains once
SCRIPT = [("q", None), ("q", 100.0), ("q", 5.0), ("p", 60.0), ("q", 18.0),
          ("d", None), ("q", 40.0), ("q", None), ("q", 9.0), ("q", None),
          ("q", 500.0), ("q", None), ("q", 30.0), ("d", None), ("q", 12.0),
          ("d", None), ("d", None), ("q", 200.0), ("d", None)]


def _run_script(fe_cls, rejected, engine, queries):
    fe = fe_cls(engine, capacity=5, buckets=(1, 2, 4), est_batch_ms=10.0,
                ewma_alpha=0.5, clock=_Ticking(0.004), start=False,
                warmup=False)
    futures, outcome = [], []
    i = 0
    for op, deadline in SCRIPT:
        if op == "d":
            fe.drain_once()
            continue
        q = queries[i].copy()
        i += 1
        if op == "p":
            q[3] = np.nan
        try:
            futures.append((len(outcome), fe.enqueue(q, deadline_ms=deadline)))
            outcome.append(None)
        except rejected as e:
            outcome.append(f"refused:{e.reason}")
    for pos, f in futures:
        try:
            ids = np.asarray(f.result(5))
            outcome[pos] = "minus-one" if (ids == -1).all() else "served"
        except rejected as e:
            outcome[pos] = f"failed:{e.reason}"
    s = engine.stats
    return outcome, (s.n_rejected, s.n_shed, s.n_deadline_miss, s.n_queries,
                     s.n_batches, s.n_sanitized,
                     sorted(fe.dispatched_shapes),
                     [round(v, 6) for v in s.request_ms])


def test_admission_shed_and_miss_match_reference(world):
    from repro.core import search as rsearch
    from repro.serve import frontend as rfe
    from repro.serve.engine import ServingEngine as RefEngine
    ref_engine = RefEngine(rsearch.make_state(world.ref_arts["gleanvec-int8"]),
                           k=K, kappa=KAPPA, batch_size=4, dim=D)
    want = _run_script(rfe.ServingFrontend, rfe.Rejected, ref_engine,
                       world.queries)
    got = _run_script(frontend.ServingFrontend, frontend.Rejected,
                      _engine(world, batch=4), world.queries)
    assert got == want
    kinds = set(got[0])
    assert {"served", "minus-one", "refused:deadline", "refused:queue-full",
            "failed:shed"} <= kinds, kinds
    assert got[1][2] > 0                   # a deadline miss, served late


@pytest.mark.parametrize("host", [False, True], ids=["device", "host"])
@pytest.mark.parametrize("mode", ["gleanvec-int8", "gleanvec-int8-sorted"])
def test_coalesced_ids_equal_submit(world, mode, host):
    engine = _engine(world, mode, host)
    fe = frontend.ServingFrontend(engine, capacity=64, start=False)
    assert engine.n_compiles == len(fe.buckets) == 5     # 1 .. 16
    q = world.queries[:16].copy()
    q[5, 0] = np.inf
    for b in fe.buckets:
        futs = [fe.enqueue(row) for row in q[:b]]
        assert fe.drain_once() == b
        got = np.stack([f.result(5) for f in futs])
        np.testing.assert_array_equal(got, engine.submit(q[:b]))
        if b > 5:
            assert (got[5] == -1).all() and (got[:5] >= 0).all()
    assert fe.dispatched_shapes == set(fe.buckets)
    assert engine.n_compiles == 5
    with pytest.raises(ValueError):
        fe.enqueue(q[:2])
    fe.close()
    with pytest.raises(frontend.Rejected, match="shutdown"):
        fe.enqueue(q[0])


def _supervised(world, host=False, **kw):
    engine = _engine(world, host=host)
    guarded = lifecycle.GuardedEngine(engine,
                                      canary_queries=world.queries[:16])
    sup = lifecycle.RefreshSupervisor(guarded, **kw)
    stream = streaming.init_from_artifacts(engine.state.artifacts,
                                           world.ds.queries_learn[:128],
                                           refresh_every=64)
    return engine, guarded, sup, stream


def test_worker_degrades_then_recovers(world):
    engine, guarded, sup, stream = _supervised(world, max_retries=1,
                                               backoff_s=0.0)
    fn = faults.failing(streaming.refresh, n_failures=100)
    worker = frontend.RefreshWorker(sup, stream, refresh_fn=fn)
    worker.observe(world.queries[:64])
    assert worker.run_cycle().outcome == "degraded" and worker.degraded
    assert not lifecycle.nonfinite_leaves(guarded.state)
    assert engine.submit(world.queries[:4]).shape == (4, K)
    v0 = guarded.version
    fn.n_failures = 0
    worker.observe(world.queries[64:128])
    rep = worker.run_cycle()
    assert rep.outcome == "ok" and guarded.version == v0 + 1
    assert sup.n_recoveries == 1 and not worker.degraded
    assert len(worker.cycle_spans) == 2 and worker.n_cycles == 2


@pytest.mark.parametrize("host", [False, True], ids=["device", "host"])
def test_stuck_worker_serves_stale_then_swaps(world, host):
    engine, guarded, sup, stream = _supervised(world, host=host)
    release = threading.Event()
    stuck = faults.stuck_worker(release, timeout_s=30.0)
    worker = frontend.RefreshWorker(sup, stream, refresh_fn=stuck).start()
    fe = frontend.ServingFrontend(guarded, capacity=64)
    try:
        v0 = guarded.version
        before = engine.submit(world.queries[:32])
        worker.observe(world.queries[:64])
        worker.request_refresh()
        t0 = time.monotonic()
        while stuck.calls < 1 and time.monotonic() - t0 < 30:
            time.sleep(0.01)
        time.sleep(0.05)
        assert worker.stuck(0.02) and guarded.version == v0
        futs = [fe.enqueue(q) for q in world.queries[:32]]
        got = np.stack([f.result(30) for f in futs])
        np.testing.assert_array_equal(got, before)    # the stale state
        release.set()
        t0 = time.monotonic()
        while guarded.version == v0 and time.monotonic() - t0 < 30:
            time.sleep(0.01)
        assert guarded.version == v0 + 1 and stuck.releases == 1
        assert worker.staleness_s < 30 and worker.healthy
    finally:
        release.set()
        fe.close()
        assert worker.stop(timeout=30)


CLI = ["--frontend", "--mode", "gleanvec-int8", "--n", "1500", "--dim",
       "32", "--d", "8", "--clusters", "4", "--batch", "32", "--device",
       "cpu"]


@pytest.mark.parametrize("kind", faults.FRONTEND_FAULTS)
def test_cli_frontend_drill(kind, capsys):
    from repro_torch.launch import serve
    serve.main(CLI + ["--host-rerank", "--inject-fault", kind])
    out = capsys.readouterr().out
    assert "drill PASS" in out and "drill FAIL" not in out, out
    assert "stopped=True" in out


def test_cli_frontend_deadline_and_refusals(capsys):
    from repro_torch.launch import serve
    serve.main(CLI + ["--host-rerank", "--deadline-ms", "1000",
                      "--queue-capacity", "64"])
    out = capsys.readouterr().out
    assert "shed_rate=" in out and "worker: cycles=1" in out, out
    for bad in (["--stream"], ["--index", "ivf"], ["--mode", "full"],
                ["--inject-fault", "nan-moments"]):
        with pytest.raises(SystemExit):
            serve.main(CLI + bad)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _cuda_stream_state(cuda, host, n=200000, dim=128):
    from repro_torch.launch import serve
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(n, dim, generator=gen, device=cuda)
    q = torch.randn(512, dim, generator=gen, device=cuda)
    model = serve.fit_model("gleanvec-int8-sorted", q, x, 32, 16, cuda)
    state = serve.build_stream("gleanvec-int8-sorted", x, n, n, model,
                               slack_blocks=2, host_rerank=host, device=cuda)
    return state, q


@pytest.mark.cuda
@pytest.mark.parametrize("host", [False, True], ids=["device", "host"])
def test_cuda_coalesced_ids_equal_submit(cuda, host):
    state, q = _cuda_stream_state(cuda, host, n=50000, dim=64)
    engine = ServingEngine(state, k=K, kappa=100, batch_size=256, dim=64)
    fe = frontend.ServingFrontend(engine, capacity=256, start=False)
    qn = q.cpu().numpy()
    for b in fe.buckets:
        futs = [fe.enqueue(row) for row in qn[:b]]
        fe.drain_once()
        got = np.stack([f.result(60) for f in futs])
        np.testing.assert_array_equal(got, engine.submit(qn[:b]))


@pytest.mark.cuda
def test_cuda_dispatch_runs_while_worker_refreshes(cuda):
    """The worker refreshes on its own CUDA stream; batches served by the
    dispatcher start and finish inside the refresh."""
    state, q = _cuda_stream_state(cuda, host=True)
    engine = ServingEngine(state, k=K, kappa=100, batch_size=256, dim=128)
    guarded = lifecycle.GuardedEngine(engine, canary_queries=q[:256].cpu()
                                      .numpy())
    sup = lifecycle.RefreshSupervisor(guarded)
    stream = streaming.init_from_artifacts(state.artifacts, q)
    del state
    worker = frontend.RefreshWorker(sup, stream).start()
    assert worker._cuda_stream is not None
    fe = frontend.ServingFrontend(guarded, capacity=256)
    stop = threading.Event()
    qn = q.cpu().numpy()

    def feed():
        while not stop.is_set():
            for f in [fe.enqueue(r) for r in qn[:8]]:
                f.result(60)

    feeder = threading.Thread(target=feed)
    feeder.start()
    try:
        time.sleep(0.3)
        v0, spans0 = guarded.version, len(fe.batch_spans)
        worker.request_refresh()
        t0 = time.monotonic()
        while worker.n_cycles < 1 and time.monotonic() - t0 < 60:
            time.sleep(0.01)
        time.sleep(0.2)
    finally:
        stop.set()
        feeder.join(60)
        fe.close()
        assert worker.stop(timeout=60)
    assert worker.n_cycles == 1 and guarded.version == v0 + 1
    c0, c1 = worker.cycle_spans[-1]
    inside = [s for s in list(fe.batch_spans)[spans0:]
              if s[0] >= c0 and s[1] <= c1]
    assert inside, (c1 - c0, len(fe.batch_spans) - spans0)


@pytest.mark.cuda
def test_cuda_worker_waits_for_the_default_stream(cuda):
    """The worker's stream waits for the default stream's work before a
    cycle: with the default stream held busy (``torch.cuda._sleep``) while
    it still has to write the stream state handed to the worker, the
    worker's K_Q and refreshed model equal a serial refresh of the same
    observations. A first cycle loads every kernel of the refresh (a
    module's first load can synchronize the context and hide the race),
    on other observations, so no freed block holds the values the second
    cycle must read."""
    from repro_torch import tree
    state, q = _cuda_stream_state(cuda, host=False, n=50000, dim=64)
    engine = ServingEngine(state, k=K, kappa=100, batch_size=256, dim=64)
    qn = q.cpu().numpy()
    guarded = lifecycle.GuardedEngine(engine, canary_queries=qn[:256])
    sup = lifecycle.RefreshSupervisor(guarded)
    stream = streaming.init_from_artifacts(state.artifacts, q)
    del state
    worker = frontend.RefreshWorker(sup, stream)
    worker.observe(qn[:100])
    assert worker.run_cycle().outcome == "ok"
    torch.cuda.synchronize()
    torch.cuda._sleep(int(3e9))             # ~1.5 s on the default stream
    worker.stream = streaming.observe_queries(stream, q[:256])   # behind it
    worker.observe(qn[256:])
    rep = worker.run_cycle()
    assert rep.outcome == "ok", rep
    torch.cuda.synchronize()
    want = streaming.refresh(streaming.observe_queries(
        streaming.observe_queries(stream, q[:256]), qn[256:]))
    assert torch.equal(worker.stream.k_q, want.k_q)
    for got, ref in zip(tree.leaves(worker.stream.model),
                        tree.leaves(want.model)):
        if isinstance(got, torch.Tensor):
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
