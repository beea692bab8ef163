"""The port's serving lifecycle (``serve/lifecycle.py``, ``serve/faults.py``,
``train/checkpoint.py``, ``tree.py``) against the JAX reference.

The reference fits and encodes a streaming store once; ``repro_torch.
convert`` carries the store, the model and the stream state across, so the
two guarded engines start from the same state. On the CPU (JAX imported
inside the fixtures and tests, so the card can collect the file):

* ``tree.flatten_with_paths`` names a serving state's leaves as
  ``jax.tree_util.keystr`` names the reference's;
* checkpoints: the reference's ``checkpoint.save`` of a dict of numpy
  arrays restored by the port and the other way round, exactly; the port
  restores a snapshot the reference's ``lifecycle.snapshot`` wrote;
* each guarded-swap refusal (non-finite, canary-overlap, treedef, aval,
  stale-version) gives the reference's reason, and leaves the engine as it
  was (the same state object, ``n_swaps``, results);
* rollback restores results bit for bit, on either rerank tier;
* snapshot -> restore -> ``restore_into``: leaves exact, the version clock
  continuing from the snapshot's, fallback past a truncated manifest and a
  truncated leaf;
* the refresh supervisor's outcomes under the same scripted faults (an
  exception, an ill-conditioned transition, poisoned moments, then
  ``recover``): outcome, source, attempts, escalation, backoff sleeps and
  counters equal to the reference's;
* every lifecycle ``--inject-fault`` kind and a snapshot / restore run
  through ``launch.serve.main`` with ``--device cpu``.

On the card (``cuda`` marker): a guarded swap leaves
``torch.cuda.memory_allocated`` unchanged or lower.
"""
import numpy as np
import pytest
import torch

from repro_torch import convert, tree
from repro_torch.core import search, streaming
from repro_torch.serve import faults, lifecycle
from repro_torch.serve.engine import ServingEngine
from repro_torch.train import checkpoint

D, N, N0, CAP = 32, 512, 384, 512
BATCH, K, KAPPA = 16, 10, 30
MODE = "gleanvec-int8"


class _World:
    """The reference's streaming store, model and stream state, and the
    port's copies of them."""

    def __init__(self):
        import jax
        import jax.numpy as jnp
        from repro.core import gleanvec as rgv
        from repro.core import streaming as rst
        from repro.data import vectors as rvectors
        self.ds = rvectors.make_dataset("lifecycle", n=N, d=D, n_queries=256,
                                        ood=True, seed=9)
        x = jnp.asarray(self.ds.database)
        rng = np.random.default_rng(0)
        self.q_init = self.ds.database[rng.integers(0, N0, 256)] \
            + 0.1 * rng.standard_normal((256, D)).astype(np.float32)
        self.ref_model = rgv.fit(jax.random.PRNGKey(0),
                                 jnp.asarray(self.q_init), x[:N0], c=4, d=8)
        self.ref_arts = rst.build_streaming_artifacts(
            MODE, x[:N0], self.ref_model, capacity=CAP, sort_block=64,
            slack_blocks=2)
        self.ref_stream = rst.init_from_artifacts(
            self.ref_arts, jnp.asarray(self.q_init), refresh_every=64)
        s = self.ref_arts.scorer
        self.arts = search.SearchArtifacts(
            scorer=convert.scorer(type(s).__name__, convert.arrays_of(s),
                                  "cpu"),
            x_full=torch.from_numpy(np.array(self.ref_arts.x_full)),
            model=convert.gleanvec_model(convert.arrays_of(self.ref_model),
                                         "cpu"))
        self.stream = convert.streaming_state(self.ref_stream, "cpu")
        self.obs = self.ds.queries_test[:BATCH]

    def guarded(self, host=False, **kw):
        arts = search.demote_rerank_tier(self.arts) if host else self.arts
        engine = ServingEngine(search.make_state(arts), k=K, kappa=KAPPA,
                               batch_size=BATCH, dim=D)
        return engine, lifecycle.GuardedEngine(
            engine, canary_queries=self.ds.queries_test[:BATCH], **kw)

    def ref_guarded(self, **kw):
        from repro.core import search as rsearch
        from repro.serve import lifecycle as rlc
        from repro.serve.engine import ServingEngine as RefEngine
        engine = RefEngine(rsearch.make_state(self.ref_arts), k=K,
                           kappa=KAPPA, batch_size=BATCH, dim=D)
        return engine, rlc.GuardedEngine(
            engine, canary_queries=self.ds.queries_test[:BATCH], **kw)


@pytest.fixture(scope="module")
def world():
    return _World()


def _candidate(engine, stream, obs):
    """A legitimate refresh candidate."""
    stream = streaming.refresh(streaming.observe_queries(stream, obs))
    return streaming.refresh_state(engine.state, stream, source="full"), \
        stream


# ---------------------------------------------------------------------------
# Trees and checkpoints.
# ---------------------------------------------------------------------------


def test_tree_paths_match_reference_keystr(world):
    import jax
    from repro.core import search as rsearch
    ref = {"serving": rsearch.make_state(world.ref_arts),
           "stream": world.ref_stream, "extra": [np.zeros(2), None, (1, 2)]}
    flat, _ = jax.tree_util.tree_flatten_with_path(ref)
    want = [jax.tree_util.keystr(kp) for kp, _ in flat]
    port = {"serving": search.make_state(world.arts), "stream": world.stream,
            "extra": [np.zeros(2), None, (1, 2)]}
    paths, leaves, treedef = tree.flatten_with_paths(port)
    assert paths == want
    back = treedef.unflatten(leaves)
    assert tree.structure(back) == treedef
    assert back["serving"].artifacts.scorer.codes is \
        world.arts.scorer.codes


def test_checkpoint_interop_with_reference(tmp_path):
    from repro.train import checkpoint as rckpt
    rng = np.random.default_rng(3)
    data = {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": {"c": np.arange(7, dtype=np.int32),
                  "d": rng.integers(0, 255, (4, 2)).astype(np.uint8)},
            "e": [np.ones(3, np.float64), np.zeros((), np.int32)]}
    zeros = {"a": np.zeros((5, 3), np.float32),
             "b": {"c": np.zeros(7, np.int32), "d": np.zeros((4, 2),
                                                            np.uint8)},
             "e": [np.zeros(3), np.zeros((), np.int32)]}
    rckpt.save(str(tmp_path / "ref"), 3, data, meta={"by": "reference"})
    got, step, meta = checkpoint.restore(str(tmp_path / "ref"), zeros)
    assert step == 3 and meta == {"by": "reference"}
    for p, a, b in zip(*tree.flatten_with_paths(got)[:2],
                       tree.leaves(data)):
        np.testing.assert_array_equal(a, b, err_msg=p)
        assert a.dtype == b.dtype
    checkpoint.save(str(tmp_path / "port"), 7, {
        k: v for k, v in data.items()}, meta={"by": "port"})
    assert checkpoint.latest_step(str(tmp_path / "port")) == 7
    got, step, meta = rckpt.restore(str(tmp_path / "port"), zeros)
    assert step == 7 and meta == {"by": "port"}
    import jax
    for a, b in zip(jax.tree_util.tree_leaves(got), tree.leaves(data)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(str(tmp_path / "ref"),
                           {**zeros, "a": np.zeros((2, 3), np.float32)})


def test_port_restores_reference_snapshot(world, tmp_path):
    """A snapshot the reference wrote restores into the port's templates
    (same paths), leaves exact, and serves."""
    from repro.core import search as rsearch
    from repro.serve import lifecycle as rlc
    rlc.snapshot(str(tmp_path), rsearch.make_state(world.ref_arts),
                 world.ref_stream, meta={"cycle": 4})
    model = lifecycle.template_model(MODE, D, 8, clusters=4, device="cpu")
    t_arts = streaming.build_streaming_artifacts(
        MODE, world.ds.database[:N0], model, capacity=CAP, device="cpu")
    serving, stream, step, meta = lifecycle.restore(
        str(tmp_path), search.make_state(t_arts),
        lifecycle.template_stream(model, refresh_every=64))
    assert step == 0 and meta["cycle"] == 4 and meta["has_stream"]
    for a, b in zip(tree.leaves(serving), tree.leaves(search.make_state(
            world.arts))):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert stream.refresh_every == 64 and torch.equal(stream.k_x,
                                                      world.stream.k_x)
    eng = ServingEngine(serving, k=K, kappa=KAPPA, batch_size=BATCH, dim=D)
    ref_eng = ServingEngine(search.make_state(world.arts), k=K, kappa=KAPPA,
                            batch_size=BATCH, dim=D)
    np.testing.assert_array_equal(eng.submit(world.obs),
                                  ref_eng.submit(world.obs))


# ---------------------------------------------------------------------------
# Guarded swaps.
# ---------------------------------------------------------------------------


REJECTIONS = {
    "non-finite": ({}, lambda s, np_: faults.corrupt_scorer_leaf(s)),
    # at this size the rerank recovers part of a scrambled candidate set
    # (the reference's own test sets the floor between the two)
    "canary-overlap": ({"min_overlap": 0.7},
                       lambda s, np_: faults.scramble_scorer_leaf(s)),
    "treedef": ({}, lambda s, np_: s._replace(version=None)),
    "aval": ({}, lambda s, np_: s._replace(version=np_.zeros(2, np.int32))),
}


@pytest.mark.parametrize("reason", list(REJECTIONS) + ["stale-version"])
def test_rejections_match_reference(world, reason):
    import jax.numpy as jnp
    from repro.core import streaming as rst
    from repro.serve import faults as rfaults
    from repro.serve import lifecycle as rlc
    obs = world.obs
    kw, corrupt = REJECTIONS.get(reason, ({}, None))
    engine, guarded = world.guarded(**kw)
    ref_engine, ref_guarded = world.ref_guarded(**kw)
    if reason == "stale-version":
        stale, ref_stale = engine.state, ref_engine.state
        guarded.swap(_candidate(engine, world.stream, obs)[0])
        rs = rst.refresh(rst.observe_queries(world.ref_stream,
                                             jnp.asarray(obs)))
        ref_guarded.swap(rst.refresh_state(ref_engine.state, rs,
                                           source="full"))
        bad, ref_bad = stale, ref_stale
    else:
        ref_corrupt = {"non-finite": rfaults.corrupt_scorer_leaf,
                       "canary-overlap": rfaults.scramble_scorer_leaf}.get(
            reason, lambda s: corrupt(s, jnp))
        bad, ref_bad = corrupt(engine.state, np), ref_corrupt(
            ref_engine.state)
    results0 = guarded.submit(obs)
    state0, swaps0 = engine.state, engine.n_swaps
    with pytest.raises(rlc.SwapRejected) as want:
        ref_guarded.swap(ref_bad)
    with pytest.raises(lifecycle.SwapRejected) as got:
        guarded.swap(bad)
    assert got.value.reason == want.value.reason == reason
    assert guarded.health.rejections[-1] == reason
    assert engine.state is state0 and engine.n_swaps == swaps0
    np.testing.assert_array_equal(guarded.submit(obs), results0)


@pytest.mark.parametrize("host", [False, True], ids=["device", "host"])
def test_rollback_bit_identical(world, host):
    """An insert and a refresh swapped in, then rolled back: the same ids
    as before the swap (over a host store, through the rows the displaced
    store kept), the version moving on, no new batch shape."""
    engine, guarded = world.guarded(host=host)
    obs = world.obs
    before = guarded.submit(obs)
    arts, _ = streaming.insert_rows(engine.state.artifacts,
                                    world.ds.database[N0:N0 + 64])
    guarded.swap(engine.state._replace(artifacts=arts))
    guarded.rollback()
    np.testing.assert_array_equal(guarded.submit(obs), before)
    cand, _ = _candidate(engine, world.stream, obs)
    guarded.swap(cand)
    after = guarded.submit(obs)
    back = guarded.rollback()
    np.testing.assert_array_equal(guarded.submit(obs), before)
    assert back is engine.state and guarded.version == 4
    assert guarded.health.rollbacks == 2 and guarded.n_compiles == 1
    with pytest.raises(RuntimeError, match="roll back"):
        guarded.rollback()
    assert after.shape == before.shape


# ---------------------------------------------------------------------------
# Snapshots.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("host", [False, True], ids=["device", "host"])
def test_snapshot_restore_and_fallback(world, tmp_path, host):
    d = str(tmp_path)
    engine, guarded = world.guarded(host=host)
    obs = world.obs
    cand, stream = _candidate(engine, world.stream, obs)
    guarded.swap(cand)                                  # version 1
    lifecycle.snapshot(d, guarded.state, stream, meta={"cycle": 0})
    want1 = guarded.submit(obs)
    arts, _ = streaming.insert_rows(engine.state.artifacts,
                                    world.ds.database[N0:N0 + 32])
    guarded.swap(engine.state._replace(artifacts=arts))  # version 2
    lifecycle.snapshot(d, guarded.state, stream, meta={"cycle": 1})
    want2 = guarded.submit(obs)
    assert checkpoint.available_steps(d) == [0, 1]
    serving, got_stream, step, meta = lifecycle.restore(d, engine.state,
                                                        stream)
    assert step == 1 and meta["cycle"] == 1 and int(serving.version) == 2
    for a, b in zip(tree.leaves(serving), tree.leaves(guarded.state)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert (search.host_tier(serving.artifacts) is not None) == host
    if host:
        np.testing.assert_array_equal(serving.artifacts.x_full.numpy(),
                                      guarded.state.artifacts.x_full.numpy())
    for a, b in zip(tree.leaves(got_stream), tree.leaves(stream)):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b)
    # a restore may rewind the clock: the version becomes the snapshot's
    # and continues from there
    faults.truncate_snapshot(d, what="leaf")
    serving, _, step, meta = lifecycle.restore(d, engine.state, stream)
    assert step == 0 and meta["cycle"] == 0
    lifecycle.restore_into(guarded, serving)
    assert guarded.version == 1
    np.testing.assert_array_equal(guarded.submit(obs), want1)
    guarded.swap(_candidate(engine, stream, obs)[0])
    assert guarded.version == 2
    faults.truncate_snapshot(d, step=0, what="manifest")
    with pytest.raises(FileNotFoundError, match="no restorable"):
        lifecycle.restore(d, engine.state, stream)
    assert want2.shape == want1.shape


# ---------------------------------------------------------------------------
# The refresh supervisor.
# ---------------------------------------------------------------------------


def _supervise(pkg, guarded, stream, script, sleeps):
    """Run ``script`` through one package's supervisor; returns its reports
    and counters."""
    import jax.numpy as jnp
    if pkg == "ref":
        from repro.core import streaming as st
        from repro.serve import faults as fl
        from repro.serve import lifecycle as lc
        queries = jnp.asarray(np.asarray(guarded.engine.state.artifacts
                                         .x_full)[:64])
    else:
        st, fl, lc = streaming, faults, lifecycle
        queries = guarded.engine.state.artifacts.x_full[:64].numpy()
    sup = lc.RefreshSupervisor(guarded, sleep=sleeps.append,
                               cond_threshold=0.0 if script == "escalate"
                               else 1e6)
    reports = []
    if script == "retry":
        reports.append(sup.refresh_and_swap(
            stream, refresh_fn=fl.failing(st.refresh, n_failures=1))[1])
    elif script == "escalate":
        reports.append(sup.refresh_and_swap(stream)[1])
    else:
        bad, rep = sup.refresh_and_swap(fl.nan_moments(stream))
        reports.append(rep)
        reports.append(sup.refresh_and_swap(sup.recover(bad, queries))[1])
    return ([(r.outcome, r.source, r.attempts, r.escalated, len(r.errors))
             for r in reports],
            (sup.n_refreshes, sup.n_retries, sup.n_escalations,
             sup.n_degraded, sup.n_recoveries, sup.degraded))


@pytest.mark.parametrize("script", ["retry", "escalate", "degrade-recover"])
def test_supervisor_matches_reference(world, script):
    engine, guarded = world.guarded()
    _, ref_guarded = world.ref_guarded()
    sleeps, ref_sleeps = [], []
    v0 = guarded.version
    got = _supervise("port", guarded, world.stream, script, sleeps)
    want = _supervise("ref", ref_guarded, world.ref_stream, script,
                      ref_sleeps)
    assert got == want
    assert sleeps == ref_sleeps
    assert guarded.version == v0 + 1       # the one swap that succeeded
    assert not lifecycle.nonfinite_leaves(guarded.state)


# ---------------------------------------------------------------------------
# The CLI.
# ---------------------------------------------------------------------------


CLI = ["--stream", "--mode", "gleanvec-int8", "--n", "1500", "--dim", "32",
       "--d", "8", "--clusters", "4", "--batch", "32", "--device", "cpu"]


@pytest.mark.parametrize("kind", faults.FAULTS)
def test_cli_lifecycle_drill(kind, capsys, tmp_path):
    from repro_torch.launch import serve
    extra = ["--snapshot-dir", str(tmp_path)] \
        if kind == "truncated-snapshot" else []
    serve.main(CLI + ["--host-rerank", "--inject-fault", kind] + extra)
    out = capsys.readouterr().out
    assert "drill PASS" in out and "drill FAIL" not in out, out


def test_cli_snapshot_and_restore(capsys, tmp_path):
    from repro_torch.launch import serve
    d = str(tmp_path)
    serve.main(CLI + ["--cycles", "2", "--snapshot-dir", d])
    assert checkpoint.available_steps(d) == [0, 1]
    serve.main(CLI + ["--cycles", "3", "--snapshot-dir", d, "--restore"])
    out = capsys.readouterr().out
    assert "restored snapshot step 1 -> resuming at cycle 2" in out, out
    assert "  cycle 2:" in out and "  cycle 0:" in out.split("restored")[0]
    for bad in (["--restore"], ["--inject-fault", "stuck-worker"]):
        with pytest.raises(SystemExit):
            serve.main(CLI + bad)
    with pytest.raises(SystemExit, match="single-device index"):
        serve.main(CLI + ["--shards", "2"])
    with pytest.raises(SystemExit, match="--stream"):
        serve.main(CLI[1:] + ["--snapshot-dir", d])


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("host", [False, True], ids=["device", "host"])
def test_cuda_swap_allocates_nothing(cuda, host):
    from repro_torch.launch import serve
    from repro_torch.serve.lifecycle import template_model
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(30000, 64, generator=gen, device=cuda)
    model = template_model("gleanvec-int8-sorted", 64, 16, clusters=8,
                           device=cuda)
    state = serve.build_stream("gleanvec-int8-sorted", x, 20000, 30000,
                               model, slack_blocks=serve.stream_slack_blocks(
                                   model, x[20000:]),
                               host_rerank=host, device=cuda)
    engine = ServingEngine(state, k=K, kappa=KAPPA, batch_size=64, dim=64)
    guarded = lifecycle.GuardedEngine(engine, canary_queries=x[:64].cpu()
                                      .numpy(), min_overlap=0.0)
    stream = streaming.init_from_artifacts(state.artifacts, x[:256])
    del state
    deltas = []
    inner = engine.swap

    def swap(s):
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        inner(s)
        torch.cuda.synchronize()
        deltas.append(torch.cuda.memory_allocated() - m0)

    engine.swap = swap
    for c in range(2):
        stream = serve.stream_insert(guarded, stream,
                                     x[20000 + c * 5000:20000 + (c + 1) * 5000])
        stream = streaming.refresh(stream)
        guarded.swap(streaming.refresh_state(guarded.state, stream))
    assert len(deltas) == 4 and all(d <= 0 for d in deltas), deltas
