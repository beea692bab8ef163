"""The port's host rerank tier (``core/rerank_tier.py``), its search path and
the engine's pipelined submit, against the JAX reference and against the
port's own device tier.

On the CPU (JAX imported inside these tests, so the card can collect the
file):

* the ``HostStore`` / ``ShardedHostStore`` surface against the reference's
  on the same numpy data: ``take`` with -1 pads and repeats, ``set_rows``
  (the store it was called on keeps its rows), ``host_arrays`` round trip,
  identity by (type, shape, dtype); every earlier store of a history
  reading its own rows after later writes, a write from a displaced store,
  and gathers racing writes from other threads;
* search with the store in host memory: all 7 modes x ID / OOD queries
  over the flat index, the k-means IVF with the reduced-space probe, the
  aligned IVF, and the fused graph -- equal to the port's device tier (the
  same candidate rows, the same product: ids exact) and to the reference's
  own host-tier search (ids through ``testing.assert_topk_close`` at
  ``testing.dot_tol`` of their exact scores: fp32 sums in another order);
* the engine's pipelined submit: ids equal to the one-step engine's over a
  device store, poisoned rows -1, ``host_bytes == host_bytes_lb``;
  ``fetch``'s chunks and byte count, and both the one-batch rerank and the
  pipelined submit taking their rows through it;
* the streaming bridge over a host store (inserts, removes, refresh from
  the store, moments, graph inserts) equal to the device tier's exactly.

On the card (``cuda`` marker): the store and the staging buffers are
pinned, and the H2D copies of the candidate rows and the rerank run on the
engine's side stream, not the scan's; one batch through ``search_with``
copies its rows from pinned memory.
"""
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import rerank_tier, search, streaming
from repro_torch.index import graph, ivf
from repro_torch.index.protocol import FlatIndex
from repro_torch.serve.engine import ServingEngine, make_search_fn
from repro_torch.testing import assert_topk_close, dot_tol

N, D, DR, C, BLOCK, KAPPA, K = 2048, 64, 16, 8, 64, 40, 10
MODES = ("full", "sphering", "gleanvec", "sphering-int8", "gleanvec-int8",
         "gleanvec-sorted", "gleanvec-int8-sorted")


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# The store's surface.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [0, 4], ids=["single", "sharded"])
def test_store_surface_matches_reference(shards):
    from repro.core import rerank_tier as rrt
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 8)).astype(np.float32)
    ref = rrt.demote(x, shards=shards)
    port = rerank_tier.demote(torch.from_numpy(x), shards=shards)
    assert type(port).__name__ == type(ref).__name__
    assert tuple(port.shape) == ref.shape and port.nbytes == ref.nbytes
    assert not port.pinned                  # a CPU source is not pinned
    ids = np.array([[3, -1, 63, 3, 17], [0, 40, -1, -1, 5], [16, 15, 47, 48,
                                                             31]])
    np.testing.assert_array_equal(port.take(ids).numpy(), ref.take(ids))
    np.testing.assert_array_equal(port.take(torch.from_numpy(ids)).numpy(),
                                  ref[ids])
    w_ids = np.array([5, 33, 63, 0], np.int64)
    rows = rng.standard_normal((4, 8)).astype(np.float32)
    ref2, port2 = ref.set_rows(w_ids, rows), port.set_rows(w_ids, rows)
    np.testing.assert_array_equal(port2.numpy(), np.asarray(ref2))
    np.testing.assert_array_equal(port.numpy(), x)     # the old one keeps
    np.testing.assert_array_equal(port2.take(ids).numpy(), ref2.take(ids))
    arrays, want = rerank_tier.host_arrays(port2), rrt.host_arrays(ref2)
    assert sorted(arrays) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(arrays[key].numpy(), want[key])
    back = rerank_tier.from_host_arrays(arrays)
    np.testing.assert_array_equal(back.numpy(), np.asarray(ref2))
    assert back == port and hash(back) == hash(port)
    assert port != rerank_tier.demote(torch.from_numpy(x[:32]),
                                      shards=shards // 2)
    assert rerank_tier.host_arrays(torch.from_numpy(x)) is None
    with pytest.raises(ValueError):
        rerank_tier.HostStore(np.zeros(4, np.float32))


def test_every_version_reads_its_own_rows():
    """A history of writes: each store reads its own rows (through the
    chain of patches), and a write from a displaced store starts a new
    history without touching the others."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((40, 6)).astype(np.float32)
    stores, want = [rerank_tier.HostStore(x)], [x.copy()]
    for ids in ([1, 2, 3], [2, 3, 30], [1], [39, 0, 2]):
        rows = rng.standard_normal((len(ids), 6)).astype(np.float32)
        stores.append(stores[-1].set_rows(ids, rows))
        nxt = want[-1].copy()
        nxt[ids] = rows
        want.append(nxt)
    probe = np.array([0, 1, 2, 3, 30, 39, -1, 5])
    for s, w in zip(stores, want):
        np.testing.assert_array_equal(s.numpy(), w)
        np.testing.assert_array_equal(s.take(probe).numpy(),
                                      w[np.maximum(probe, 0)])
    branch = stores[1].set_rows([7], np.ones((1, 6), np.float32))
    expect = want[1].copy()
    expect[7] = 1
    np.testing.assert_array_equal(branch.numpy(), expect)
    for s, w in zip(stores, want):
        np.testing.assert_array_equal(s.numpy(), w)
    # the store owns its buffer: a write never reaches the caller's array
    np.testing.assert_array_equal(x, want[0])


def test_gathers_race_writes():
    """Readers gather from every version while a writer extends the
    history; each gather sees exactly its version's rows (more reader
    threads than cores, a short switch interval)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((256, 16)).astype(np.float32)
    history = [(rerank_tier.HostStore(x), x.copy())]
    lock = threading.Lock()
    stop = threading.Event()
    errors = []

    def writer():
        for _ in range(60):
            ids = rng.choice(256, 12, replace=False)
            rows = rng.standard_normal((12, 16)).astype(np.float32)
            store, arr = history[-1]
            new = arr.copy()
            new[ids] = rows
            with lock:
                history.append((store.set_rows(ids, rows), new))
        stop.set()

    def reader(seed):
        r = np.random.default_rng(seed)
        while not stop.is_set() or r.random() < 0.5:
            with lock:
                store, arr = history[r.integers(len(history))]
            ids = r.integers(-1, 256, 40)
            got = store.take(ids).numpy()
            if not np.array_equal(got, arr[np.maximum(ids, 0)]):
                errors.append(seed)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer)] + [
            threading.Thread(target=reader, args=(s,))
            for s in range((os.cpu_count() or 4) + 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors and len(history) == 61


# ---------------------------------------------------------------------------
# Search with the store in host memory.
# ---------------------------------------------------------------------------


class _Case:
    """One dataset and both reference models, fitted once per query
    kind."""

    def __init__(self, ood: bool):
        import jax
        import jax.numpy as jnp
        from repro.core import gleanvec as rgv
        from repro.core import leanvec_sphering as rlvs
        from repro.data import vectors as rvectors
        self.ds = rvectors.make_dataset("s", n=N, d=D, n_queries=96,
                                        ood=ood, seed=11)
        self.x = jnp.asarray(self.ds.database)
        q = jnp.asarray(self.ds.queries_learn)
        self.models = {
            "sphering": rlvs.fit(q, self.x, DR),
            "gleanvec": rgv.fit(jax.random.PRNGKey(0), q, self.x, c=C, d=DR,
                                kmeans_iters=6),
        }
        self.queries = self.ds.queries_test[:16]

    def model(self, mode):
        if mode == "full":
            return None
        return self.models["sphering" if mode.startswith("sphering")
                           else "gleanvec"]

    def ref_artifacts(self, mode):
        from repro.core import scorer as rsc
        from repro.core import search as rsearch
        art = rsearch.build_artifacts(mode, self.x, self.model(mode))
        if mode.endswith("sorted"):      # the test size wants a small block
            art = art._replace(scorer=rsc.build_scorer(
                mode, self.x, art.model, block=BLOCK))
        return art


@pytest.fixture(scope="module")
def cases():
    return {False: _Case(False), True: _Case(True)}


def _port_artifacts(ref_art, mode):
    s = ref_art.scorer
    model = ref_art.model
    if model is not None:
        build = convert.sphering_model if mode.startswith("sphering") \
            else convert.gleanvec_model
        model = build(convert.arrays_of(model), "cpu")
    return search.SearchArtifacts(
        scorer=convert.scorer(type(s).__name__, convert.arrays_of(s), "cpu"),
        x_full=torch.from_numpy(np.array(ref_art.x_full)),
        rerank_a=None if ref_art.rerank_a is None
        else torch.from_numpy(np.array(ref_art.rerank_a)), model=model)


def _exact(queries, x, ids):
    safe = np.where(ids >= 0, ids, 0)
    s = np.einsum("md,mkd->mk", queries.astype(np.float64), x[safe])
    return np.where(ids >= 0, s, -3.4e38)


def _three_ways(case, ref_art, ref_index, index, kappa, label):
    """Port host tier == port device tier (exactly); port host tier ~
    reference host tier (near-ties)."""
    import jax.numpy as jnp
    from repro.core import search as rsearch
    q_np = case.queries
    q = torch.from_numpy(q_np)
    art = _port_artifacts(ref_art, label.split()[0])
    dev_ids = search.multi_step_search(q, art, index, K, kappa).numpy()
    host = search.demote_rerank_tier(art)
    assert search.host_tier(host) is not None and search.host_tier(art) is None
    host_ids = search.multi_step_search(q, host, index, K, kappa).numpy()
    np.testing.assert_array_equal(host_ids, dev_ids)
    np.testing.assert_array_equal(
        make_search_fn(host, K, kappa, index=index)(q).numpy(), dev_ids)
    back = search.promote_rerank_tier(host)
    assert torch.equal(back.x_full, art.x_full)
    ref_ids = np.asarray(rsearch.multi_step_search(
        jnp.asarray(q_np), rsearch.demote_rerank_tier(ref_art), ref_index,
        K, kappa))
    x = case.ds.database
    if ref_art.rerank_a is not None:    # the store holds the rotated x'
        x = np.asarray(ref_art.x_full)
        q_np = q_np @ np.asarray(ref_art.rerank_a).T
    tol = dot_tol(float(np.linalg.norm(q_np, axis=1).max()),
                  float(np.linalg.norm(x, axis=1).max()), x.shape[1])
    assert_topk_close((_exact(q_np, x, host_ids), host_ids),
                      (_exact(q_np, x, ref_ids), ref_ids), tol, label)


@pytest.mark.parametrize("ood", [False, True], ids=["ID", "OOD"])
@pytest.mark.parametrize("mode", MODES)
def test_flat_host_tier(cases, mode, ood):
    from repro.index.protocol import FlatIndex as RefFlat
    case = cases[ood]
    kappa = K if mode == "full" else KAPPA
    _three_ways(case, case.ref_artifacts(mode), RefFlat(), FlatIndex(),
                kappa, f"{mode} flat")


@pytest.mark.parametrize("mode,aligned", [("gleanvec-int8", False),
                                          ("gleanvec-int8-sorted", True)],
                         ids=["kmeans", "aligned"])
def test_ivf_host_tier(cases, mode, aligned):
    import jax
    from repro.index import ivf as rivf
    case = cases[True]
    ref_art = case.ref_artifacts(mode)
    if aligned:
        ridx = rivf.build_aligned(ref_art.model, case.x, nprobe=3)
    else:
        ridx = rivf.build(jax.random.PRNGKey(1), case.x, n_lists=16,
                          nprobe=4)
    ridx = rivf.with_reduced_centers(ridx, ref_art.scorer, ref_art.model)
    _three_ways(case, ref_art, ridx, convert.ivf_index(ridx, "cpu"), KAPPA,
                f"{mode} ivf")


def test_fused_graph_host_tier(cases):
    from repro.index import graph as rgraph
    from repro.index.protocol import replace as rreplace
    case = cases[True]
    mode = "gleanvec-int8-sorted"
    ref_art = case.ref_artifacts(mode)
    rg = rgraph.with_fused_scan(rreplace(
        rgraph.build(case.ds.database, r=16, n_iters=4, seed=0), beam=48,
        max_hops=64, expand=4), ref_art.scorer)
    pg = convert.graph_index(rg, "cpu")
    assert pg.fused
    _three_ways(case, ref_art, rg, pg, KAPPA, f"{mode} graph")


# ---------------------------------------------------------------------------
# The engine's pipelined submit.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["sphering", "gleanvec-int8-sorted"])
def test_pipelined_submit_equals_one_step(cases, mode):
    """Over a host store ``submit`` runs two batches in flight; its ids
    equal the one-step engine's over the device store, a poisoned row is
    -1, and the host-to-device bytes equal their kappa-row bound."""
    case = cases[True]
    art = _port_artifacts(case.ref_artifacts(mode), mode)
    q = np.concatenate([case.ds.queries_test[:29]])
    q[4, 1] = np.nan
    one = ServingEngine(search.make_state(art), k=K, kappa=KAPPA,
                        batch_size=8, dim=D)
    host = ServingEngine(search.make_state(search.demote_rerank_tier(art)),
                         k=K, kappa=KAPPA, batch_size=8, dim=D)
    want, got = one.submit(q), host.submit(q)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and (got[4] == -1).all()
    st = host.stats
    assert st.n_batches == 4 and st.n_queries == 29 and st.n_sanitized == 1
    assert st.host_bytes == st.host_bytes_lb == 4 * 8 * KAPPA * D * 4
    assert st.host_bytes_ratio == 1.0
    assert len(st.prefetch_ms) == len(st.gather_ms) == 4
    assert not st.copy_ms                  # no card: no H2D copy
    assert one.stats.host_bytes == 0 and one.stats.host_bytes_ratio == 0.0
    assert host.n_compiles == one.n_compiles == 1     # the batch shape
    # the pipeline's ids also equal one batch at a time through search_with
    for s in range(0, 29, 8):
        chunk = np.nan_to_num(q[s:s + 8], nan=0.0)
        rows = host.search_with(chunk, host.state)
        keep = np.isfinite(q[s:s + 8]).all(axis=1)
        np.testing.assert_array_equal(rows[keep], got[s:s + 8][keep])
    assert host.n_compiles == 2                       # and the tail's 5


# ---------------------------------------------------------------------------
# The streaming bridge over a host store.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,chunks", [(5, 4), (1, 4), (40, 4), (12, 1)])
def test_fetch_chunks_and_bytes(n, chunks):
    """``fetch`` gathers the rows of any ids (-1 reads row 0) in chunks of
    ceil(n / chunks) and counts the bytes it wrote chunk by chunk."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 8)).astype(np.float32)
    store = rerank_tier.demote(torch.from_numpy(x))
    ids = rng.integers(-1, 64, n)
    rows, gathers, nbytes = rerank_tier.fetch(store, ids, "cpu",
                                              chunks=chunks)
    np.testing.assert_array_equal(rows.numpy(), x[np.maximum(ids, 0)])
    assert len(gathers) == len(range(0, n, -(-n // chunks)))
    assert nbytes == n * 8 * 4


def test_one_batch_and_pipelined_rerank_share_fetch(cases, monkeypatch):
    """``search_with`` (one batch: the frontend, the canary) and the
    pipelined ``submit`` both take the candidate rows through
    ``rerank_tier.fetch``: the first with a staging buffer of its own, the
    second with its slot's."""
    mode = "gleanvec-int8-sorted"
    case = cases[True]
    art = _port_artifacts(case.ref_artifacts(mode), mode)
    eng = ServingEngine(search.make_state(search.demote_rerank_tier(art)),
                        k=K, kappa=KAPPA, batch_size=8, dim=D)
    inner, calls = rerank_tier.fetch, []

    def spy(store, ids, device, staging=None, **kw):
        calls.append(staging)
        return inner(store, ids, device, staging=staging, **kw)

    monkeypatch.setattr(rerank_tier, "fetch", spy)
    q = case.ds.queries_test[:16]
    got = eng.submit(q)
    slots = [s.staging for s in eng._slots]
    assert len(calls) == 2 and all(any(c is s for s in slots)
                                   for c in calls)
    one = eng.search_with(q[:8], eng.state)
    assert len(calls) == 3 and calls[-1] is None
    np.testing.assert_array_equal(one, got[:8])


@pytest.mark.parametrize("mode", ["sphering-int8", "gleanvec-int8-sorted"])
def test_streaming_host_tier_equals_device_tier(cases, mode):
    from repro_torch.launch import serve
    case = cases[True]
    model = _port_artifacts(case.ref_artifacts(mode), mode).model
    x = torch.from_numpy(np.array(case.ds.database))
    n0, cap = 1536, N
    kw = dict(capacity=cap, sort_block=BLOCK, slack_blocks=4, device="cpu")
    dev = streaming.build_streaming_artifacts(mode, x[:n0], model, **kw)
    host = streaming.build_streaming_artifacts(mode, x[:n0], model,
                                               host_rerank=True, **kw)
    assert isinstance(host.x_full, rerank_tier.HostStore)
    np.testing.assert_array_equal(host.x_full.numpy(), dev.x_full.numpy())
    q = case.ds.queries_test[:32]
    s_dev = streaming.init_from_artifacts(dev, q)
    s_host = streaming.init_from_artifacts(host, q)
    assert torch.equal(s_dev.k_x, s_host.k_x)
    rows = x[n0:n0 + 300]
    dev, ids = streaming.insert_rows(dev, rows)
    host_before = host
    host, ids_h = streaming.insert_rows(host, rows)
    assert torch.equal(ids, ids_h)
    np.testing.assert_array_equal(host.x_full.numpy(), dev.x_full.numpy())
    np.testing.assert_array_equal(host_before.x_full.numpy()[n0:n0 + 300],
                                  np.repeat(x[:1].numpy(), 300, 0))
    gone = np.arange(10, 40)
    dev, host = streaming.remove_rows(dev, gone), streaming.remove_rows(
        host, gone)
    s_dev = streaming.refresh(streaming.insert(s_dev, rows))
    for source in ("stored", "full"):
        a = streaming.refresh_artifacts(dev, s_dev, source=source)
        b = streaming.refresh_artifacts(host, s_dev, source=source)
        for la, lb in zip(a.scorer, b.scorer):
            if isinstance(la, torch.Tensor):
                assert torch.equal(la, lb), source
    # the CLI's recall helper and a graph insert read the host store alike
    eng_d = ServingEngine(search.make_state(dev), k=K, kappa=KAPPA,
                          batch_size=16, dim=D)
    eng_h = ServingEngine(search.make_state(host), k=K, kappa=KAPPA,
                          batch_size=16, dim=D)
    served = eng_d.submit(q)
    np.testing.assert_array_equal(eng_h.submit(q), served)
    assert serve.live_recall(eng_d, q, served) == \
        serve.live_recall(eng_h, q, served)
    g = graph.with_capacity(graph.build(x[:n0].numpy(), r=8, n_iters=2,
                                        seed=0, device="cpu"), cap)
    more = x[n0 + 300:n0 + 340]
    dev2, new_ids = streaming.insert_rows(dev, more)
    host2, _ = streaming.insert_rows(host, more)
    gd = graph.insert_ids(g, more, new_ids, dev2.scorer, dev2.x_full)
    gh = graph.insert_ids(g, more, new_ids, host2.scorer, host2.x_full)
    assert torch.equal(gd.neighbors, gh.neighbors)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (pinned memory and CUDA streams)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_store_pinned_and_prefetch_on_side_stream(cuda, tmp_path):
    """The demoted store and the engine's staging buffers are pinned; the
    candidate rows' H2D copies, and the rerank after them, run on the
    engine's side stream, not the scan's (read from a ``torch.profiler``
    trace); ids equal the device tier's."""
    from repro_torch.core import leanvec_sphering as lvs
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(20000, 64, generator=gen, device=cuda)
    q = torch.randn(300, 64, generator=gen, device=cuda)
    model = lvs.fit(q, x, 16, device=cuda)
    art = search.build_artifacts("sphering-int8", x.clone(), model,
                                 device=cuda)
    want = ServingEngine(search.make_state(art), k=K, kappa=KAPPA,
                         batch_size=64, dim=64).submit(q.cpu().numpy())
    host = search.demote_rerank_tier(art)
    store = search.host_tier(host)
    assert store.pinned
    eng = ServingEngine(search.make_state(host), k=K, kappa=KAPPA,
                        batch_size=64, dim=64)
    assert all(s.staging.is_pinned() for s in eng._slots)
    side = eng._copy_stream
    assert side is not None and side != torch.cuda.default_stream(cuda)
    trace = tmp_path / "trace.json"
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = eng.submit(q.cpu().numpy())
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    np.testing.assert_array_equal(got, want)
    assert all(s.cand.is_pinned() for s in eng._slots if s.cand is not None)
    events = json.loads(trace.read_text())["traceEvents"]
    h2d = {e["args"]["stream"] for e in events
           if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")
           and "Pinned" in e.get("name", "")}
    scans = {e["args"]["stream"] for e in events
             if e.get("cat") == "kernel" and "ip_scan" in e.get("name", "")}
    others = {e["args"]["stream"] for e in events
              if e.get("cat") == "kernel" and "ip_scan" not in
              e.get("name", "")}
    assert h2d and scans, "the profiler recorded no device activity"
    assert not h2d & scans, (h2d, scans)     # not the scan's stream
    assert h2d & others, (h2d, others)       # the rerank runs after them
    assert eng.stats.copy_ms and eng.stats.host_bytes_ratio == 1.0


@pytest.mark.cuda
def test_cuda_search_with_copies_from_pinned_memory(cuda, tmp_path):
    """One batch through ``search_with`` over a host store (the frontend's
    and the canary's path) copies its candidate rows to the card from
    pinned memory in ``COPY_CHUNKS`` copies; ids equal ``submit``'s."""
    from repro_torch.core import leanvec_sphering as lvs
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(20000, 64, generator=gen, device=cuda)
    q = torch.randn(64, 64, generator=gen, device=cuda)
    model = lvs.fit(q, x, 16, device=cuda)
    art = search.demote_rerank_tier(search.build_artifacts(
        "sphering-int8", x.clone(), model, device=cuda))
    eng = ServingEngine(search.make_state(art), k=K, kappa=KAPPA,
                        batch_size=64, dim=64)
    qn = q.cpu().numpy()
    trace = tmp_path / "trace.json"
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = eng.search_with(qn, eng.state)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    np.testing.assert_array_equal(got, eng.submit(qn))
    events = json.loads(trace.read_text())["traceEvents"]
    h2d = [e for e in events if e.get("cat") == "gpu_memcpy"
           and "HtoD" in e.get("name", "")]
    pinned = [e for e in h2d if "Pinned" in e["name"]]
    assert h2d, "the profiler recorded no device activity"
    assert len(pinned) == rerank_tier.COPY_CHUNKS, [e["name"] for e in h2d]


# ---------------------------------------------------------------------------
# The CLI.
# ---------------------------------------------------------------------------


SMALL = ["--n", "1200", "--dim", "32", "--d", "8", "--clusters", "4",
         "--batch", "32", "--device", "cpu", "--host-rerank"]


@pytest.mark.parametrize("flags", [
    ["--mode", "sphering-int8"],
    ["--mode", "gleanvec-int8-sorted", "--index", "ivf", "--aligned",
     "--reduced-probe", "--nprobe", "3"],
    ["--mode", "gleanvec-int8-sorted", "--index", "graph", "--fused-graph",
     "--beam", "32", "--expand", "2", "--stream", "--cycles", "2"],
], ids=["flat", "ivf", "graph-stream"])
def test_cli_host_rerank(flags, capsys):
    from repro_torch.launch import serve
    serve.main(flags + SMALL)
    out = capsys.readouterr().out
    assert "host_rerank=True" in out, out
    if "--stream" in flags:
        assert "  cycle 1:" in out and "rejected=0" in out, out
    else:
        assert "host_bytes_ratio=1.00" in out, out
        assert float(out.split("recall@10=")[1].split()[0]) > 0.9, out
