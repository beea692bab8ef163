"""The port's model sharding against the JAX reference.

* ``MeshRules.for_mesh`` and ``logical_to_spec`` equal the reference's for
  every logical name on the host, production and partial meshes (the
  reference's ``for_mesh`` reads only ``axis_names``; its spec is a
  ``jax.sharding.PartitionSpec``, which the port's compares equal to);
* ``transformer.param_specs`` / ``cache_specs`` of the five LM configs at
  full size and the four recommenders' parameter specs equal the
  reference's under the single- and multi-pod rules;
* ``launch/mesh.py``'s descriptions: the production meshes' axes and
  sizes, the host mesh of one process, ``device_mesh`` refusing a mesh the
  live group does not match;
* one spawn of 4 gloo CPU processes on a (2, 2) ("data", "model") mesh:
  ``embedding.make_sharded_lookup`` equal to ``table[idx]`` exactly (the
  reference's ``MAXERR 0.0``) and its table gradient to the dense one's
  block (f32 sums of the same values, in another order: 1e-6); the
  vocab-parallel ``transformer._embed_lookup`` equal to ``take`` exactly;
  the ``vs_learn``, ``vs_search`` and ``vs_search_sorted`` bundles at
  smoke, each rank on its own blocks (``sharding.local_block`` under the
  bundle's ``in_specs``), equal to the one-process bundle on the whole
  arrays (ids exactly, values 1e-5; the learned centers 1e-6 and the
  model's scores of learning queries against the rows within 1e-3 of the
  largest: f32 moments summed over the ranks in another order, through a
  pseudo-inverse of 256 queries in D 512, :func:`_model_scores`);
  ``local_block`` equal to the ``torch.distributed.tensor`` shard of the
  same spec (``sharding.placements``) and its shape to the reference's
  ``NamedSharding.shard_shape``.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as ref_registry
from repro.launch import steps as ref_steps
from repro.models import recsys as ref_recsys
from repro.models import sharding as ref_sharding
from repro.models import transformer as ref_tfm
from repro_torch.configs import registry
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps
from repro_torch.models import sharding
from repro_torch.models import transformer as tfm

ROOT = Path(__file__).resolve().parents[1]
LOGICAL = ("batch", "fsdp", "tp", "vocab", "seq_tp", "ep", None)
MESHES = {"host": (("data",), (1,)), "single_pod": (("data", "model"),
                                                    (16, 16)),
          "multi_pod": (("pod", "data", "model"), (2, 16, 16)),
          "model_only": (("model",), (4,)), "pods": (("pod", "data"), (2, 8))}
PRODUCTION = ("single_pod", "multi_pod")
LM_ARCHS = ("h2o-danube-3-4b", "qwen2-72b", "nemotron-4-15b", "grok-1-314b",
            "llama4-maverick-400b-a17b")


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: the test workers share the cores, and the
    one-process fits (49 ``eigh`` of 512 x 512) slow down many times over
    under a pool of spinning threads a worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stand_in(name):
    names, sizes = MESHES[name]
    return SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes)))


def _rules(name):
    """(the reference's, the port's) rules of a mesh."""
    mesh = _stand_in(name)
    return (ref_sharding.MeshRules.for_mesh(mesh),
            sharding.MeshRules.for_mesh(mesh))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_rules_and_logical_specs_match_reference(mesh):
    for fsdp in (True, False):
        want = ref_sharding.MeshRules.for_mesh(_stand_in(mesh), fsdp=fsdp)
        got = sharding.MeshRules.for_mesh(_stand_in(mesh), fsdp=fsdp)
        assert (got.dp, got.fsdp, got.tp, got.ep) == \
            (want.dp, want.fsdp, want.tp, want.ep)
        assert got.batch(None, "model") == want.batch(None, "model")
        assert got.replicated() == want.replicated()
        for name in LOGICAL:
            assert sharding.logical_to_spec(got, (name, None)) == \
                ref_sharding.logical_to_spec(want, (name, None)), name
        assert sharding.logical_to_spec(got, LOGICAL) == \
            ref_sharding.logical_to_spec(want, LOGICAL)
        with pytest.raises(ValueError, match="unknown logical axis"):
            sharding.logical_to_spec(got, ("heads",))
    x = torch.ones(3)
    assert sharding.constrain(x, got, ("batch",)) is x


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_and_cache_specs_match_reference(arch):
    """Full-size configs (the blocked layout of qwen2 and grok-1, the MoE
    experts' ep / tp axes) under both production meshes' rules."""
    rc = ref_registry.get(arch).make_config(smoke=False)
    pc = registry.get(arch).make_config(smoke=False)
    for mesh in PRODUCTION:
        want_rules, got_rules = _rules(mesh)
        assert tfm.param_specs(pc, got_rules) == \
            ref_tfm.param_specs(rc, want_rules)
        assert tfm.cache_specs(pc, got_rules) == \
            ref_tfm.cache_specs(rc, want_rules)
        assert tfm.param_logical_axes(pc) == ref_tfm.param_logical_axes(rc)


@pytest.mark.parametrize("arch", ["dlrm-mlperf", "fm", "bst", "mind"])
def test_recsys_param_specs_match_reference(arch):
    name = ref_registry.get(arch).MODEL
    rc = ref_registry.get(arch).make_config(smoke=False)
    pc = registry.get(arch).make_config(smoke=False)
    want_shapes = jax.eval_shape(lambda: getattr(ref_recsys, name).init(
        jax.random.PRNGKey(0), rc))
    got_shapes = steps._abstract(lambda: steps._RECSYS_MODELS[name].init(
        torch.Generator(), pc, device="cpu"))
    for mesh in PRODUCTION + ("host",):
        want_rules, got_rules = _rules(mesh)
        assert steps._recsys_param_specs(name, got_shapes, got_rules) == \
            ref_steps._recsys_param_specs(name, want_shapes, want_rules)


def test_meshes():
    for multi, key in ((False, "single_pod"), (True, "multi_pod")):
        m = mesh_mod.make_production_mesh(multi_pod=multi)
        names, sizes = MESHES[key]
        assert (m.axis_names, tuple(m.shape.values())) == (names, sizes)
        assert m.size == int(np.prod(sizes))
        want = ref_steps.build_bundle(
            "gleanvec-paper", "search_oi13m", AbstractMesh(sizes, names))
        got = steps.build_bundle("gleanvec-paper", "search_oi13m",
                                 device="cpu", mesh=m)
        assert got.in_specs == want.in_shardings
        assert (got.args[1].shape, got.trip_counts) == \
            (want.args[1].shape, want.trip_counts)
    host = mesh_mod.make_host_mesh()
    assert (host.axis_names, host.size) == (("data",), 1)
    with pytest.raises(RuntimeError, match="process group"):
        mesh_mod.device_mesh(mesh_mod.make_production_mesh(), "cpu")
    with pytest.raises(ValueError, match="one size per axis"):
        mesh_mod.Mesh(("data",), (2, 2))
    with pytest.raises(ValueError, match="equal blocks"):
        sharding.local_block(torch.zeros(6), ("data",),
                             SimpleNamespace(shape={"data": 4}), {"data": 0})


# ---------------------------------------------------------------------------
# Four gloo processes on a (2, 2) ("data", "model") mesh.
# ---------------------------------------------------------------------------

BLOCK_SPECS = [["model", ["data"]], [["data", "model"], None],
               [None, "data", "model"], [["data", "model"]], []]
VS_SHAPES = ("learn_oi13m", "search_oi13m", "search_oi13m_sorted")

GLOO_SCRIPT = textwrap.dedent("""
    import datetime, json, sys
    sys.path.insert(0, {src!r})
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def spec(s):
        return tuple(tuple(e) if isinstance(e, list) else e for e in s)

    def run(rank, world, port):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{{port}}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=60))
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.launch import mesh as mesh_mod, steps
        from repro_torch.models import embedding, sharding
        from repro_torch.models import transformer as tfm
        d = np.load({data!r})
        meta = json.loads(open({meta!r}).read())
        mesh = mesh_mod.Mesh(("data", "model"), (2, 2))
        dm = mesh_mod.device_mesh(mesh, "cpu")
        coords = dict(zip(mesh.axis_names, dm.get_coordinate()))

        def mine(name, s):
            return sharding.local_block(torch.from_numpy(d[name]), spec(s),
                                        mesh, coords)

        # the DLRM 2D lookup: rows over "model", dim over "data"
        table = mine("table", ["model", ["data"]]).clone().requires_grad_()
        lookup = embedding.make_sharded_lookup(dm, *d["table"].shape)
        emb = lookup(table, mine("idx", [["data"], None]))
        want = mine("take", [["data"], None, None])
        assert torch.equal(emb, want), float((emb - want).abs().max())
        (emb * mine("w", [["data"], None, None])).sum().backward()
        torch.testing.assert_close(
            table.grad, mine("grad", ["model", ["data"]]), rtol=1e-6,
            atol=1e-6)
        # the vocab-parallel LM embedding: vocab over "model"
        got = tfm._embed_lookup(mine("vocab", ["model", None]),
                                mine("tokens", [["data"], None]),
                                torch.float32, tp_group=dm.get_group("model"))
        assert torch.equal(got, mine("embed", [["data"], None, None]))
        # the paper's bundles, each rank on its blocks
        for shape in meta["vs_shapes"]:
            b = steps.build_bundle("gleanvec-paper", shape, smoke=True,
                                   device="cpu", mesh=mesh)
            args = [sharding.local_block(torch.from_numpy(d[f"{{shape}}{{i}}"]),
                                         s, mesh, coords)
                    for i, s in enumerate(b.in_specs)]
            out = b.fn(*args)
            if shape.startswith("learn"):
                torch.testing.assert_close(
                    out[0], torch.from_numpy(d[shape + "_centers"]),
                    rtol=1e-6, atol=1e-6)
                np.savez({out!r} + f".{{rank}}.npz", a=out[1].numpy(),
                         b=out[2].numpy())
            else:
                assert torch.equal(out[1], torch.from_numpy(
                    d[shape + "_ids"])), shape
                torch.testing.assert_close(
                    out[0], torch.from_numpy(d[shape + "_vals"]), rtol=1e-5,
                    atol=1e-5)
        # local_block against DTensor's shard and the reference's shape
        x = torch.arange(8 * 12 * 4, dtype=torch.float32).view(8, 12, 4)
        shapes = []
        for s in meta["block_specs"]:
            blk = sharding.local_block(x, spec(s), mesh, coords)
            dt = distribute_tensor(x, dm, sharding.placements(spec(s), dm))
            assert torch.equal(blk, dt.to_local()), s
            shapes.append(list(blk.shape))
        assert shapes == meta["ref_shapes"], (shapes, meta["ref_shapes"])
        dist.barrier()
        if rank == 0:
            print("GLOO_SHARDING_OK", flush=True)
        dist.destroy_process_group()

    if __name__ == "__main__":
        import socket
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        mp.spawn(run, args=(4, port), nprocs=4)
""")


def _tags(x, centers):
    """The rows' clusters under the centers the data pass starts from."""
    x = torch.as_tensor(x)
    x_unit = x / x.norm(dim=1, keepdim=True)
    return torch.argmax(x_unit @ torch.as_tensor(centers).T, dim=1).numpy()


def _model_scores(a, b, x, q, tags):
    """<A_t q, B_t x> of every row x (in its cluster t) against 32 of the
    learning queries ``q``. The smoke config learns from 256 queries in D
    512, so the sphering's pseudo-inverse has noise-determined directions
    outside the queries' span (and a cluster of ~43 rows leaves a null
    space in its moment, d = 160): A^T B itself differs with the f32
    rounding of the moments. Queries from that span see only the
    determined part."""
    x = torch.as_tensor(x)
    rec = torch.zeros_like(x)
    for c in range(a.shape[0]):
        rows = torch.as_tensor(np.flatnonzero(tags == c))
        rec[rows] = (x[rows] @ b[c].T) @ a[c]
    return torch.as_tensor(q[:32]) @ rec.T


def _vs_inputs(rng, shape, noise=0.0):
    """The smoke bundle's arguments at the (2, 2) mesh's padded size. The
    search's full rows are their cluster's view of the reduced rows plus
    ``noise`` N(0, 1) in every coordinate (x_full = A_t^T x_low + noise z,
    A_c with orthonormal rows). At ``noise`` 0 the reduced scores are the
    full ones and every shard's top kappa holds its share of the global
    top k: the sharded step and the one-process step agree exactly. Above
    0 the rerank reorders the reduced scan's candidates. The products run
    in torch (one thread here): numpy's BLAS pool spins on the test
    workers' shared cores."""
    b = steps.build_bundle("gleanvec-paper", shape, smoke=True,
                           device="cpu",
                           mesh=mesh_mod.Mesh(("data", "model"), (2, 2)))
    args = [rng.standard_normal(a.shape).astype(np.float32)
            for a in b.args]
    if shape.startswith("learn"):
        return args
    q, _, x_low, _, a = args
    c, d, dim = a.shape
    a = torch.linalg.qr(torch.from_numpy(rng.standard_normal(
        (c, dim, d)).astype(np.float32)))[0].transpose(1, 2).contiguous()
    tags = rng.integers(0, c, b.args[1].shape).astype(np.int32)
    row_tags = torch.from_numpy(np.repeat(tags, x_low.shape[0]
                                          // tags.shape[0]))
    x_low_t = torch.from_numpy(x_low)
    x_full = torch.empty((x_low.shape[0], dim))
    for t in range(c):
        rows = row_tags == t
        x_full[rows] = x_low_t[rows] @ a[t]
    if noise:
        x_full += noise * torch.from_numpy(
            rng.standard_normal(x_full.shape).astype(np.float32))
    return [q, tags, x_low, x_full.numpy(), a.numpy()]


def test_gloo_four_ranks_match_one_process(tmp_path):
    rng = np.random.default_rng(11)
    v, dim, b, f = 64, 8, 16, 3
    table = rng.standard_normal((v, dim)).astype(np.float32)
    idx = rng.integers(0, v, (b, f)).astype(np.int32)
    w = rng.standard_normal((b, f, dim)).astype(np.float32)
    t = torch.from_numpy(table).requires_grad_()
    (t[torch.from_numpy(idx).long()] * torch.from_numpy(w)).sum().backward()
    vocab = rng.standard_normal((64, 16)).astype(np.float32)
    tokens = rng.integers(0, 64, (4, 8)).astype(np.int32)
    data = {"table": table, "idx": idx, "w": w, "take": table[idx],
            "grad": t.grad.numpy(), "vocab": vocab, "tokens": tokens,
            "embed": vocab[tokens]}
    for shape in VS_SHAPES:
        args = _vs_inputs(rng, shape)
        one = steps.build_bundle("gleanvec-paper", shape, smoke=True,
                                 device="cpu")
        out = one.fn(*[torch.from_numpy(a) for a in args])
        data.update({f"{shape}{i}": a for i, a in enumerate(args)})
        if shape.startswith("learn"):
            data[shape + "_centers"] = out[0].numpy()
            data[shape + "_tags"] = _tags(args[0], args[2])
            data[shape + "_scores"] = _model_scores(
                out[1], out[2], args[0], args[1],
                data[shape + "_tags"]).numpy()
        else:
            data[shape + "_vals"], data[shape + "_ids"] = \
                out[0].numpy(), out[1].numpy()
    np.savez(tmp_path / "data.npz", **data)
    ref_mesh = AbstractMesh((2, 2), ("data", "model"))
    ref_shapes = [list(NamedSharding(ref_mesh, JP(*[
        tuple(e) if isinstance(e, list) else e for e in s])).shard_shape(
            (8, 12, 4))) for s in BLOCK_SPECS]
    (tmp_path / "meta.json").write_text(json.dumps(
        {"vs_shapes": VS_SHAPES, "block_specs": BLOCK_SPECS,
         "ref_shapes": ref_shapes}))
    script = tmp_path / "gloo_sharding.py"
    script.write_text(GLOO_SCRIPT.format(
        src=str(ROOT / "src"), data=str(tmp_path / "data.npz"),
        out=str(tmp_path / "learn"),
        meta=str(tmp_path / "meta.json")))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=180, env=env)
    assert out.returncode == 0 and "GLOO_SHARDING_OK" in out.stdout, \
        f"stdout:\n{out.stdout}\nstderr:\n{out.stderr[-4000:]}"
    shape = VS_SHAPES[0]
    for rank in range(4):
        got = np.load(tmp_path / f"learn.{rank}.npz")
        scores = _model_scores(
            torch.from_numpy(got["a"]), torch.from_numpy(got["b"]),
            data[shape + "0"], data[shape + "1"], data[shape + "_tags"])
        want = data[shape + "_scores"]
        assert np.abs(scores.numpy() - want).max() <= \
            1e-3 * np.abs(want).max()
