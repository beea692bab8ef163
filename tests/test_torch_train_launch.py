"""The port's training entry points against the JAX reference: the
recommenders' losses under autograd, the step bundles, the training
driver's drill and the int8 all-reduce over a process group.

* Each recommender's ``ctr_loss`` and gradients on the reference's
  parameters (``convert.recsys_params``): f32 towers within 1e-5 (loss)
  and 1e-4 of each gradient's norm (f32 sums in another order); DLRM's
  bf16 towers within 2e-2 and 5e-2 (its serving test's bf16 tolerance).
* ``launch/steps.build_bundle`` for all 41 of the reference's cells:
  the abstract arguments, the optimizer, the model flops and the
  partition specs of the reference's bundles under the host mesh (equal).
* ``launch/train.py`` in subprocesses, each with its own
  ``PYTHONHASHSEED``: a run that exits 42 at ``REPRO_FAIL_AT_STEP``, then
  ``--resume``, ends bit for bit where an uninterrupted run ends (CPU), for
  danube's, MIND's and the GCN minibatch's smoke configs (the GCN's graph
  drawn from the seed, its seeds and sampling draws from each step). A
  dependence on ``hash()`` (the reference's seeding, ROADMAP C6) would
  show here.
* ``compressed_psum_mean`` on 2 gloo ranks against the reference's on 2
  fake CPU devices (the same int8 grid, exact int32 sums: equal to 1e-6).
"""
import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.launch import steps as ref_steps
from repro.launch.mesh import make_host_mesh
from repro.models import recsys as ref_recsys
from repro.models.sharding import MeshRules
from repro_torch import convert, tree
from repro_torch.configs import registry
from repro_torch.launch import steps
from repro_torch.launch import train as train_cli
from repro_torch.models import recsys
from repro_torch.train import checkpoint, data
from repro_torch.train.optimizer import AdafactorState, AdamWState
from repro_torch.train.trainstep import value_and_grad

ROOT = Path(__file__).resolve().parents[1]
RULES = MeshRules(dp=(), fsdp=(), tp=None, ep=None)



@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The steps here are small: one intra-op thread each. The test
    workers share the cores, and a pool of spinning threads a worker slows
    small ops down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close_grads(got, want, rel):
    """Each gradient leaf within ``rel`` of its norm."""
    paths, leaves, _ = tree.flatten_with_paths(got)
    ref = jax.tree.leaves(want)
    assert len(ref) == len(leaves)
    for path, g, w in zip(paths, leaves, ref):
        g, w = _np(g), _np(w)
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= rel, (path, err)


# ---------------------------------------------------------------------------
# The recommenders' losses
# ---------------------------------------------------------------------------

def _recsys_batch(name, cfg, rng, b=24):
    if name in ("dlrm", "fm"):
        vocab = cfg.vocab_sizes if name == "dlrm" else \
            (cfg.vocab_per_field,) * cfg.n_sparse
        out = {"sparse": np.stack([rng.integers(0, v, b) for v in vocab],
                                  1).astype(np.int32),
               "label": rng.integers(0, 2, b).astype(np.int32)}
        if name == "dlrm":
            out["dense"] = rng.standard_normal((b, cfg.n_dense)).astype(
                np.float32)
        return out
    out = {"seq": rng.integers(0, cfg.n_items, (b, cfg.seq_len)).astype(
        np.int32), "target": rng.integers(0, cfg.n_items, b).astype(np.int32)}
    if name == "bst":
        out["label"] = rng.integers(0, 2, b).astype(np.int32)
    return out


@pytest.mark.parametrize("arch", ["dlrm-mlperf", "fm", "bst", "mind"])
def test_ctr_loss_grads_match_reference(arch, monkeypatch):
    """Each recommender's ``ctr_loss`` and its gradients on the
    reference's parameters; MIND with chunks of 8 users (each recomputed
    in the backward) over a batch of 24."""
    monkeypatch.setattr(recsys, "MIND_LOSS_CHUNK", 8)
    mod = ref_registry.get(arch)
    name = mod.MODEL
    rc = mod.make_config(smoke=True)
    pc = registry.get(arch).make_config(smoke=True)
    ref_ns = getattr(ref_recsys, name)
    params = ref_ns.init(jax.random.PRNGKey(0), rc)
    b = _recsys_batch(name, rc, np.random.default_rng(5))
    want_l, want_g = jax.jit(jax.value_and_grad(
        lambda p, bt: ref_ns.ctr_loss(p, bt, rc, RULES)))(
        params, {k: jnp.asarray(v) for k, v in b.items()})
    tp = convert.recsys_params(jax.tree.map(np.asarray, params), pc,
                               device="cpu")
    ns = getattr(recsys, name)
    got_l, got_g = value_and_grad(lambda p, bt: ns.ctr_loss(p, bt, pc), tp,
                                  {k: torch.from_numpy(v)
                                   for k, v in b.items()})
    bf16 = pc.compute_dtype == torch.bfloat16         # DLRM's towers
    assert abs(float(got_l) - float(want_l)) <= \
        (2e-2 if bf16 else 1e-5) * abs(float(want_l))
    _close_grads(got_g, jax.tree.map(np.asarray, want_g),
                 5e-2 if bf16 else 1e-4)


def test_mind_loss_chunks_are_recomputed_in_the_backward(monkeypatch):
    """MIND's in-batch softmax keeps no chunk's (users, K, B) tensors for
    the backward: with chunks of 8 users over 64, autograd saves no
    chunk's (8, K, 64) similarities or (8, 64) scores."""
    monkeypatch.setattr(recsys, "MIND_LOSS_CHUNK", 8)
    cfg = registry.get("mind").make_config(smoke=True)
    params = recsys.mind.init(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    batch = data.mind_batch(0, 0, 64, cfg.seq_len, cfg.n_items, device="cpu")
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    leaf = params["item_emb"].requires_grad_()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = recsys.mind.ctr_loss({**params, "item_emb": leaf}, batch, cfg)
    chunk_shapes = {(8, cfg.n_interests, 64), (8, 64)}   # sims, scores
    assert saved and not chunk_shapes & set(saved)
    loss.backward()
    assert float(leaf.grad.abs().sum()) > 0


# ---------------------------------------------------------------------------
# Step bundles
# ---------------------------------------------------------------------------

def _gnn_sampling_draws(got_batch, want_batch, cfg):
    """The one batch leaf of a GNN minibatch bundle that differs: the
    reference's ``rng`` key is the port's ``rand1 (B, f1)`` and ``rand2
    (B, f1, f2)`` int32 draws (``models/gnn.py``). Checks them and returns
    both batches without them."""
    if "rng" not in want_batch:
        return got_batch, want_batch
    b = want_batch["seeds"].shape[0]
    f1, f2 = cfg.fanouts
    got = dict(got_batch)
    draws = [got.pop(k) for k in ("rand1", "rand2")]
    assert [(tuple(x.shape), x.dtype) for x in draws] == \
        [((b, f1), torch.int32), ((b, f1, f2), torch.int32)]
    assert want_batch["rng"].shape == (2,)
    return got, {k: v for k, v in want_batch.items() if k != "rng"}


def _without_draws(got, want):
    """The batch's specs without the GNN minibatch's sampling draws (the
    port's ``rand1`` / ``rand2``, the reference's ``rng``)."""
    got = {k: v for k, v in got.items() if k not in ("rand1", "rand2")}
    return got, {k: v for k, v in want.items() if k != "rng"}


# every (arch, shape) cell of the reference's registry: 13 training, 5
# prefill, 6 decode, 8 recsys serving, 4 retrieval and the paper's 5
BUNDLE_CELLS = [(arch, shape) for arch, mod in ref_registry.ARCHS.items()
                for shape in mod.SHAPES]


@pytest.mark.parametrize("arch,shape", BUNDLE_CELLS)
def test_bundles_match_reference(arch, shape):
    """Smoke and full, under the host mesh: the name, notes, model flops,
    trip counts, the abstract arguments' shapes and dtypes (parameters in
    the reference's blocked layout for qwen2 and grok-1 training, the flat
    one for serving; the optimizer state, AdamW or Adafactor as the config
    module says; a decode step's 0-d int32 ``pos``), all ``meta``, and the
    in / out partition specs, bar the GNN minibatch's sampling draws
    (:func:`_gnn_sampling_draws`). Nothing is allocated."""
    mesh = make_host_mesh()
    assert len(BUNDLE_CELLS) == 41
    for smoke in (True, False):
        want = ref_steps.build_bundle(arch, shape, mesh, smoke=smoke)
        got = steps.build_bundle(arch, shape, smoke=smoke, device="cpu")
        assert (got.name, got.notes) == (want.name, want.notes)
        assert got.model_flops == want.model_flops
        assert got.trip_counts == want.trip_counts
        got_args, want_args = list(got.args), list(want.args)
        in_specs, want_in = list(got.in_specs), list(want.in_shardings)
        if "rng" in getattr(want_args[-1], "keys", lambda: ())():
            got_args[2], want_args[2] = _gnn_sampling_draws(
                got_args[2], want_args[2], got.config)
            in_specs[2], want_in[2] = _without_draws(in_specs[2], want_in[2])
        gl = [(tuple(x.shape), str(x.dtype).split(".")[-1])
              for x in tree.leaves(tuple(got_args))]
        wl = [(tuple(x.shape), jnp.dtype(x.dtype).name)
              for x in jax.tree.leaves(tuple(want_args))]
        assert gl == wl
        assert all(x.device.type == "meta"
                   for x in tree.leaves(tuple(got_args)))
        assert in_specs == want_in
        assert got.out_specs == want.out_shardings
        if len(got.args) == 3 and hasattr(want.args[1], "_fields"):
            assert type(got.args[1]).__name__ == type(want.args[1]).__name__
            assert isinstance(got.args[1], (AdamWState, AdafactorState))


def test_lm_batch_is_a_pure_function_of_seed_and_step():
    b1 = data.lm_batch(0, 5, 4, 16, 100, device="cpu")
    b2 = data.lm_batch(0, 5, 4, 16, 100, device="cpu")
    b3 = data.lm_batch(0, 6, 4, 16, 100, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert b1["tokens"].dtype == torch.int32 and b1["tokens"].shape == (4, 16)
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    assert int(b1["tokens"].max()) < 100


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------

DRILL_ARCHS = {"h2o-danube-3-4b": "train_4k", "mind": "train_batch",
               "gcn-cora": "minibatch_lg"}


def _cli(args, hash_seed, fail_at=None):
    """The driver in a process of its own (started, not waited for)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PYTHONHASHSEED=str(hash_seed), OMP_NUM_THREADS="1")
    env.pop("REPRO_FAIL_AT_STEP", None)
    if fail_at is not None:
        env["REPRO_FAIL_AT_STEP"] = str(fail_at)
    return subprocess.Popen([sys.executable, "-m",
                             "repro_torch.launch.train"] + args, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _drill_args(arch):
    return ["--arch", arch, "--shape", DRILL_ARCHS[arch], "--smoke",
            "--steps", "8", "--ckpt-every", "2", "--device", "cpu"]


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    """Each arch's drill (exit 42 at step 5, hash seed 1), then its resume
    (hash seed 2), the archs' processes side by side: {arch: (ckpt dir,
    (rc, stdout, stderr) of the drill, of the resume)}."""
    root = tmp_path_factory.mktemp("drills")
    out = {arch: [root / arch.split("-")[0]] for arch in DRILL_ARCHS}
    for stage in ("drill", "resume"):
        procs = {arch: _cli(_drill_args(arch) + ["--ckpt-dir", str(d[0])]
                            + (["--resume"] if stage == "resume" else []),
                            1 if stage == "drill" else 2,
                            fail_at=5 if stage == "drill" else None)
                 for arch, d in out.items()}
        for arch, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=120)
            out[arch].append((proc.returncode, stdout, stderr))
    return out


@pytest.mark.parametrize("arch", sorted(DRILL_ARCHS))
def test_drill_resume_equals_uninterrupted_run(arch, drills, tmp_path,
                                               monkeypatch):
    """8 steps, checkpoints every 2: the drill exits 42 at step 5, the
    resume restores step 4 and runs 4-7; its step-8 checkpoint and final
    loss equal an uninterrupted run's bit for bit (each run in its own
    process and hash seed, the uninterrupted one in this process)."""
    ckpt, (rc, stdout, stderr), resume = drills[arch]
    assert rc == train_cli.FAIL_EXIT, stderr[-2000:]
    assert "[drill] injected failure at step 5" in stdout
    rc, stdout, stderr = resume
    assert rc == 0, stderr[-2000:]
    assert "[resume] restored step 4" in stdout
    resumed = [ln for ln in stdout.splitlines() if ln.startswith("final")]
    monkeypatch.delenv("REPRO_FAIL_AT_STEP", raising=False)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert train_cli.main(_drill_args(arch)
                              + ["--ckpt-dir", str(tmp_path)]) == 0
    whole = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("final")]
    assert resumed == whole and len(whole) == 1
    a, b = _checkpoint_arrays(ckpt), _checkpoint_arrays(tmp_path)
    assert sorted(a) == sorted(b) and len(a) > 3
    for path in a:
        np.testing.assert_array_equal(a[path], b[path], err_msg=path)


def _checkpoint_arrays(ckpt_dir):
    """{leaf path: array} of the newest checkpoint under ``ckpt_dir``."""
    step = checkpoint.latest_step(str(ckpt_dir))
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest["step"] == 8
    return {leaf["path"]: np.load(d / leaf["file"])
            for leaf in manifest["leaves"]}


# ---------------------------------------------------------------------------
# The int8 all-reduce over a process group
# ---------------------------------------------------------------------------

REF_PSUM = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    sys.path.insert(0, {src!r})
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.train.grad_compress import compressed_psum_mean
    from repro.utils.jax_compat import make_mesh, set_mesh, shard_map
    g = np.load({data!r})
    mesh = make_mesh((2,), ("data",))
    fn = shard_map(lambda x: compressed_psum_mean({{"g": x}}, "data")["g"],
                   mesh=mesh, in_specs=P("data", None),
                   out_specs=P("data", None))
    with set_mesh(mesh):
        xs = jax.device_put(jnp.asarray(g), NamedSharding(mesh,
                                                          P("data", None)))
        np.save({out!r}, np.asarray(jax.jit(fn)(xs)))
""")

PORT_PSUM = textwrap.dedent("""
    import datetime, sys
    sys.path.insert(0, {src!r})
    import numpy as np
    import torch
    import torch.distributed as dist
    rank = int(sys.argv[1])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="tcp://localhost:{port}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    from repro_torch.train.grad_compress import compressed_psum_mean
    g = np.load({data!r})
    half = g.shape[0] // 2
    mine = torch.from_numpy(g[rank * half:(rank + 1) * half])
    out = compressed_psum_mean({{"g": mine,
                                 "b": [mine[:1].to(torch.bfloat16)]}})
    assert out["b"][0].dtype == torch.bfloat16
    np.save({out!r} + f".{{rank}}.npy", out["g"].numpy())
    dist.destroy_process_group()
""")


def test_compressed_psum_mean_two_gloo_ranks_match_reference(tmp_path):
    """Rank r holds rows [4r, 4r + 4) of an (8, 32) gradient; both ranks
    get the int8 mean of the two halves, as the reference's shard_map over
    2 fake devices gives it (each data shard's rows)."""
    g = np.random.default_rng(2).standard_normal((8, 32)).astype(np.float32)
    np.save(tmp_path / "g.npy", g)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    runs = []
    for name, script, argv in (("ref", REF_PSUM, [[]]),
                               ("port", PORT_PSUM, [["0"], ["1"]])):
        path = tmp_path / f"{name}.py"
        path.write_text(script.format(src=str(ROOT / "src"), port=port,
                                      data=str(tmp_path / "g.npy"),
                                      out=str(tmp_path / name)))
        runs += [subprocess.Popen([sys.executable, str(path)] + a, env=env,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for a in argv]
    for proc in runs:
        _, stderr = proc.communicate(timeout=120)
        assert proc.returncode == 0, stderr[-3000:]
    want = np.load(tmp_path / "ref.npy")
    for rank in (0, 1):
        got = np.load(tmp_path / f"port.{rank}.npy")
        np.testing.assert_allclose(got, want[rank * 4:(rank + 1) * 4],
                                   rtol=1e-6, atol=1e-7)
    exact = (g[:4] + g[4:]) / 2
    assert np.abs(want[:4] - exact).max() <= 0.02 * np.abs(exact).max()
