"""LM training partitioned under the bundles' specs
(``transformer.train_loss`` / ``trainstep.make_train_step`` with
``groups=``) against the one-process step and the JAX reference.

Without a spawn:

* each autograd collective of ``models/partitioned.py`` on a one-rank
  gloo group: its forward is its value and its backward the identity
  (``max_tp`` passes no gradient);
* ``optimizer.global_norm`` and Adafactor (a factored leaf cut over
  "data" in its rows and "model" in its columns, a 3-axis stack cut over
  "model", a vector cut over "data", a replicated matrix, two matrices
  whose columns are cut one over "data", one over "model") on the blocks of
  a (2, 2) ("data", "model") mesh, one thread a rank over in-process gloo
  groups, against the whole leaves;
* ``trainstep.rank_major``: each rank's block holds its block of every
  microbatch.

One spawn of 4 gloo CPU processes (one intra-op thread each) on a (2, 2)
mesh, each rank on its ``sharding.local_block``s under
``transformer.param_specs`` and the batch laid out by ``rank_major``, f32
compute, 5 cases at smoke widths: danube with AdamW and accumulation 2;
qwen2 with Adafactor (its factored moments cut over fsdp and tp, the qkv
bias; 4 layers in the blocked layout of its production config, two a
block, under hierarchical remat: a block of one would make each of its
(1, n) factored moments elementwise, and Adafactor's first step a sign,
as AdamW's); grok-1 with its tp MoE (accumulation 2: a microbatch's 16 tokens a
rank are half a routing group, spread over the data ranks); maverick with
its ep MoE; danube with 3 q heads on 1 KV head (a head cut across the
"model" ranks, q gathered over them). For each case the rank's gradient
blocks, the loss and two steps' ``grad_norm`` against the one-process
step, then its parameter and optimizer-state blocks after the two steps.
Also the five LM ``train_4k`` smoke bundles built with ``mesh=`` against
the one-process bundles (one step), and the danube case against the
reference's own ``make_train_step`` jitted with the bundle's shardings on
a (2, 2) mesh of 4 fake CPU devices (a subprocess, one XLA thread; the
reference's math does not depend on the batch's layout).

Tolerances (f32 compute). The LM head is a bf16 x bf16 product in every
form of the step (the reference's own), and its backward rounds the
gradient of the hidden state to bf16. The partitioned step takes that
product over each "model" rank's vocab slice, so the gradient reaching the
residual stream is the sum of two bf16-rounded halves where the
one-process step rounds the whole sum once: one more bf16 rounding
(2^-9 relative to the halves) in every gradient below the head. (With the
head's product made in f32 on both sides the gradients agree to f32
rounding: the head sets these tolerances.)
Hence: the loss within 5e-5 relative (the second step's after parameters
that differ as below; measured 5e-6), each gradient leaf within 2^-7 of
its norm (measured up to 3.5e-3), ``grad_norm`` within 2^-8 relative
(measured 2.9e-4), the optimizer's moments after two steps within 2^-7 of
their leaf's norm (measured 4.7e-3). Adafactor's parameters within 2^-5 of
the learning rate plus 1e-5 relative (an update is a gradient over a
root-mean-square: measured 1.3e-2 of it). AdamW's first steps move an
element by about the learning rate times the sign of its gradient
whatever the gradient's size, so an element whose gradient is near zero
may move the other way: its parameters are held, bit for bit, to AdamW's
arithmetic on the rank's own moments in the last step. Against the
reference's partitioned step (danube, whose GSPMD step splits the head's
product too): the loss within 5e-5 relative, ``grad_norm`` within 2^-8,
the gradients and the first moment within 2^-7 of their norm (measured
4.5e-6, 1.2e-4, 1.8e-3 and 2.0e-3). The smoke bundles compute in bf16: the
loss within 2e-3 relative and ``grad_norm`` within 4e-2
(``tests/test_torch_train.py``'s bf16 tolerances; measured 6.8e-4 and
1.4e-3); their first step's learning rate is 0 under the warm-up.
"""
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.models import partitioned as part
from repro_torch.models.sharding import P, local_block
from repro_torch.train import optimizer
from repro_torch.train.trainstep import rank_major

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# No spawn.
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank_group():
    """A one-rank gloo default group over an in-process store, destroyed
    after the test."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("op", ["gather_dim", "sum", "copy", "max", "mean"])
def test_collective_on_one_rank_is_the_identity_backward(op, one_rank_group):
    """The autograd collectives on a one-rank group (their ``Function``s;
    the public names leave out the collective there): the forward gives the
    value, the backward passes the gradient unchanged (``max_tp``: none)."""
    from repro_torch.models import sharding
    pg = one_rank_group
    x = torch.randn(3, 4, 5, dtype=torch.float64, requires_grad=True)
    fn = {"gather_dim": lambda t: part._GatherDim.apply(t, 1, pg, 1),
          "sum": lambda t: sharding._SumOverGroup.apply(t, pg),
          "copy": lambda t: part._CopyToGroup.apply(t, pg),
          "max": lambda t: part._MaxOverGroup.apply(t, pg),
          "mean": lambda t: part._MeanOverGroup.apply(t, pg, 1)}[op]
    y = fn(x)
    assert torch.equal(y, x)
    up = torch.randn_like(y)
    (got,) = torch.autograd.grad(y, x, up, allow_unused=True,
                                 materialize_grads=True)
    assert torch.equal(got, torch.zeros_like(x) if op == "max" else up)


def _on_mesh(fn):
    """``fn(groups, coords)`` on each position of a (2, 2) ("data",
    "model") mesh, one thread a rank over in-process gloo groups; the
    results by (data, model)."""
    import torch.distributed as dist
    store = dist.HashStore()
    out, errors = {}, []

    def run(d, m):
        try:
            tp = dist.ProcessGroupGloo(dist.PrefixStore(f"tp{d}", store), m,
                                       2)
            dp = dist.ProcessGroupGloo(dist.PrefixStore(f"dp{m}", store), d,
                                       2)
            g = part.Groups(tp=tp, batch=dp, fsdp=dp, tp_rank=m, tp_size=2,
                            batch_size=2, fsdp_size=2, fsdp_axes=("data",),
                            tp_axis="model", batch_axes=("data",))
            out[d, m] = fn(g, {"data": d, "model": m})
        except Exception as e:          # re-raised in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(d, m)) for d in range(2)
               for m in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    if errors:
        raise errors[0]
    return out


class _Mesh:
    shape = {"data": 2, "model": 2}


def _hand_cut_tree():
    rng = np.random.default_rng(7)
    leaves = {"w": (rng.standard_normal((6, 8)), P(("data",), "model")),
              "stack": (rng.standard_normal((3, 4, 6)), P(None, None,
                                                           "model")),
              "v": (rng.standard_normal((10,)), P(("data",))),
              "norm": (rng.standard_normal((5, 3)), P()),
              # the same dimension cut over "data" in one, "model" in the
              # other: each sum of squares over its own group
              "wk": (rng.standard_normal((4, 6)), P(None, ("data",))),
              "head": (rng.standard_normal((6, 4)), P(None, "model"))}
    params = {k: torch.from_numpy(v.astype(np.float32))
              for k, (v, _) in leaves.items()}
    specs = {k: s for k, (_, s) in leaves.items()}
    grads = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(
        np.float32)) for k, (v, _) in leaves.items()}
    return params, grads, specs


def _blocks(t, spec, coords):
    return local_block(t, spec, _Mesh, coords).clone()


def test_global_norm_and_adafactor_on_hand_cut_blocks(monkeypatch):
    """Each rank's blocks through ``global_norm`` and two Adafactor steps
    (a row mean over "model", a column mean and ``denom`` over "data", the
    RMS clip over the whole leaf; the 3-axis stack read slice by slice)
    against the whole leaves in one process: the norm within 1e-6
    relative, the blocks of the parameters and of ``vr`` / ``vc`` within
    1e-5 relative (f32 means in another order)."""
    monkeypatch.setattr(optimizer, "SLICE_ELEMENTS", 24)
    params, grads, specs = _hand_cut_tree()
    cfg = optimizer.AdafactorConfig(lr=0.1, clip_threshold=0.5)
    want_norm = optimizer.global_norm(grads)
    whole = {k: v.clone() for k, v in params.items()}
    state = optimizer.adafactor_init(whole, cfg)
    for _ in range(2):
        optimizer.adafactor_update(grads, state, whole, cfg)

    def rank(g, coords):
        lp = {k: _blocks(v, specs[k], coords) for k, v in params.items()}
        lg = {k: _blocks(v, specs[k], coords) for k, v in grads.items()}
        norm = optimizer.global_norm(lg, g, specs)
        st = optimizer.adafactor_init(lp, cfg)
        for _ in range(2):
            _, _, gn = optimizer.adafactor_update(lg, st, lp, cfg, groups=g,
                                                  specs=specs)
        return norm, gn, lp, st

    from repro_torch.launch.steps import _adafactor_specs
    sspecs = _adafactor_specs(specs, params, False)
    for coords, (norm, gn, lp, st) in _on_mesh(rank).items():
        c = dict(zip(("data", "model"), coords))
        for got in (norm, gn):
            torch.testing.assert_close(got, want_norm, rtol=1e-6, atol=0)
        for k in params:
            torch.testing.assert_close(lp[k], _blocks(whole[k], specs[k], c),
                                       rtol=1e-5, atol=1e-7, msg=k)
            for field in ("vr", "vc"):
                torch.testing.assert_close(
                    getattr(st, field)[k],
                    _blocks(getattr(state, field)[k],
                            getattr(sspecs, field)[k], c),
                    rtol=1e-5, atol=1e-9, msg=f"{field} {k}")


def test_global_norm_counts_replicated_leaves_once():
    """A leaf every rank holds whole counts once, not once a rank."""
    params, grads, specs = _hand_cut_tree()
    grads = {"norm": grads["norm"]}
    got = _on_mesh(lambda g, c: optimizer.global_norm(
        grads, g, {"norm": specs["norm"]}))
    for norm in got.values():
        assert torch.equal(norm, optimizer.global_norm(grads))


def test_rank_major_holds_each_ranks_block_of_every_microbatch():
    x = torch.arange(24).reshape(12, 2)
    laid = rank_major({"x": x}, 3, 2)["x"]
    for r in range(2):
        mine = laid[r * 6:(r + 1) * 6]
        for i in range(3):
            assert torch.equal(mine[i * 2:(i + 1) * 2],
                               x[i * 4 + r * 2:i * 4 + (r + 1) * 2])
    assert rank_major({"x": x}, 1, 2)["x"] is x


# ---------------------------------------------------------------------------
# Four gloo processes on a (2, 2) ("data", "model") mesh.
# ---------------------------------------------------------------------------

# name: (arch, optimizer, accumulation, MoE sharding, (q heads, KV heads),
# sequence)
CASES = {"danube-adamw": ("h2o-danube-3-4b", "adamw", 2, None, None, 32),
         "qwen2-adafactor": ("qwen2-72b", "adafactor", 1, None, None, 32),
         "grok-tp": ("grok-1-314b", "adamw", 2, "tp", None, 16),
         "maverick-ep": ("llama4-maverick-400b-a17b", "adamw", 1, "ep", None,
                         32),
         "danube-h3": ("h2o-danube-3-4b", "adamw", 1, None, (3, 1), 32)}
B, STEPS, LR, WARMUP = 4, 2, 1e-2, 2
LM_ARCHS = ("h2o-danube-3-4b", "qwen2-72b", "nemotron-4-15b", "grok-1-314b",
            "llama4-maverick-400b-a17b")


def config(arch, moe=None, heads=None):
    """``arch``'s smoke config in f32 compute, its MoE under ``moe``
    sharding and ``heads`` (q heads, KV heads) in place of its own."""
    import dataclasses

    from repro_torch.configs import registry
    cfg = dataclasses.replace(registry.get(arch).make_config(smoke=True),
                              compute_dtype=torch.float32)
    if moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, sharding=moe))
    if heads is not None:
        cfg = dataclasses.replace(cfg, n_heads=heads[0],
                                  n_kv_heads=heads[1])
    if arch == "qwen2-72b":     # its production layout: blocked layers
        cfg = dataclasses.replace(cfg, n_layers=4, remat_block=2,
                                  remat_policy="nothing")
    return cfg


def init_params(cfg, seed):
    """Parameters in ``cfg``'s training layout (blocked where it is)."""
    from repro_torch.models import transformer as tfm
    return tfm.blocked_view(tfm.init(cfg, seed=seed, device="cpu"), cfg)


def make_step(name, groups=None, specs=None):
    """(config, step, optimizer init, batches) of case ``name``; the step
    on ``groups`` where given."""
    from repro_torch.models import transformer as tfm
    from repro_torch.train import data
    from repro_torch.train.trainstep import make_train_step
    arch, opt, accum, moe, heads, seq = CASES[name]
    cfg = config(arch, moe, heads)
    if opt == "adafactor":
        ocfg = optimizer.AdafactorConfig(lr=LR)

        def init(p):
            return optimizer.adafactor_init(p, ocfg)
    else:
        ocfg, init = optimizer.AdamWConfig(lr=LR), optimizer.adamw_init
    step = make_train_step(
        lambda p, b: tfm.train_loss(p, b, cfg, groups or part.NO_GROUPS,
                                    specs),
        ocfg, warmup=WARMUP, total_steps=50, accum_steps=accum,
        groups=groups, specs=specs)
    batches = [data.lm_batch(0, i, B, seq, cfg.vocab, device="cpu")
               for i in range(STEPS)]
    return cfg, step, init, batches


def state_specs(state, p_specs, params):
    """The optimizer state's spec tree (``launch/steps.py``'s)."""
    from repro_torch.launch import steps
    if isinstance(state, optimizer.AdafactorState):
        return steps._adafactor_specs(p_specs, params, False)
    return steps._opt_specs(p_specs)


def state_pairs(state, sspecs):
    """[(leaf, spec)] of an optimizer state (its step excluded)."""
    out = []
    for field in state._fields[1:]:
        out += list(zip(tree.leaves(getattr(state, field)),
                        part.spec_leaves(getattr(sspecs, field))))
    return out


def close_by_norm(got, want, rel, label):
    err = float(torch.linalg.vector_norm(got.double() - want.double()))
    scale = max(float(torch.linalg.vector_norm(want.double())), 1e-30)
    assert err <= rel * scale, f"{label}: {err / scale:.3e} of the norm"


GLOO_SCRIPT = textwrap.dedent("""
    import datetime, json, sys
    sys.path.insert(0, {src!r})
    sys.path.insert(0, {tests!r})
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, world, port):
        torch.set_num_threads(1)
        dist.init_process_group("gloo",
                                init_method=f"tcp://localhost:{{port}}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=90))
        from repro_torch import tree
        from repro_torch.launch import mesh as mesh_mod, steps
        from repro_torch.models import partitioned as part, sharding
        from repro_torch.models import transformer as tfm
        from repro_torch.models.sharding import MeshRules, P
        from repro_torch.train.trainstep import rank_major
        from test_torch_train_partitioned import (CASES, LM_ARCHS, LR,
            check_rank, init_params, make_step, state_pairs, state_specs)
        d = np.load({data!r})
        mesh = mesh_mod.Mesh(("data", "model"), (2, 2))
        dm = mesh_mod.device_mesh(mesh, "cpu")
        coords = dict(zip(mesh.axis_names, dm.get_coordinate()))
        rules = MeshRules.for_mesh(mesh)
        groups = part.groups_on(mesh, rules, "cpu")

        def blk(x, spec):
            return sharding.local_block(x, spec, mesh, coords)

        for name, (arch, opt, accum, moe, heads, seq) in CASES.items():
            cfg = make_step(name)[0]
            specs = tfm.param_specs(cfg, rules)
            _, step, init, batches = make_step(name, groups, specs)
            params = init_params(cfg, 0)
            lp = tree.structure(params).unflatten(
                [blk(x, s).clone() for x, s in zip(
                    tree.leaves(params), part.spec_leaves(specs))])
            opt_state = init(lp)
            sspecs = state_specs(opt_state, specs, params)
            local = [{{k: blk(v, P(("data",), None)) for k, v in
                      rank_major(b, accum, 2).items()}} for b in batches]
            check_rank(name, d, step, lp, specs, opt_state, sspecs, local,
                       blk, opt == "adamw")

        # the LM train_4k bundles at smoke built for the mesh, one step
        for arch in LM_ARCHS:
            b = steps.build_bundle(arch, "train_4k", smoke=True,
                                   device="cpu", mesh=mesh)
            key = f"bundle/{{arch}}"
            params = tfm.init(b.config, seed=1, device="cpu")
            specs, o_specs, b_specs = b.in_specs
            lp = tree.structure(params).unflatten(
                [blk(x, s).clone() for x, s in zip(
                    tree.leaves(params), part.spec_leaves(specs))])
            batch = {{k: blk(torch.from_numpy(d[f"{{key}}/{{k}}"]), b_specs[k])
                     for k in ("tokens", "labels")}}
            _, _, m = b.fn(lp, b.opt_init(lp), batch)
            for k, rel in (("loss", 2e-3), ("grad_norm", 4e-2)):
                want = float(d[f"{{key}}/{{k}}"])
                assert abs(float(m[k]) - want) <= rel * abs(want), (key, k)
        dist.barrier()
        if rank == 0:
            print("GLOO_TRAIN_OK", flush=True)
        dist.destroy_process_group()

    if __name__ == "__main__":
        import socket
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        mp.spawn(run, args=(4, port), nprocs=4)
""")


GRAD_REL, NORM_REL, LOSS_REL = 2.0 ** -7, 2.0 ** -8, 5e-5


def check_rank(name, d, step, lp, specs, opt_state, sspecs, local, blk,
               adamw):
    """One rank of the spawn, case ``name``: its gradient blocks and loss,
    two steps' metrics, then its parameter and state blocks (the stated
    tolerances); the danube case against the reference too."""
    ref = name == "danube-adamw"
    loss, grads = step.grads(lp, local[0])
    pairs = list(zip(tree.leaves(grads), part.spec_leaves(specs)))
    assert abs(float(loss) - float(d[f"{name}/loss"])) <= \
        LOSS_REL * abs(float(d[f"{name}/loss"])), name
    for i, (g, s) in enumerate(pairs):
        want = blk(torch.from_numpy(d[f"{name}/grad/{i}"]), s)
        close_by_norm(g, want, GRAD_REL, f"{name} grad {i}")
        if ref:
            close_by_norm(g, blk(torch.from_numpy(d[f"{name}/ref/grad/{i}"]),
                                 s), GRAD_REL, f"{name} grad {i} (reference)")
    sides = ("", "ref/") if ref else ("",)
    for i, batch in enumerate(local):
        before = [x.clone() for x in tree.leaves(lp)]
        lp, opt_state, m = step(lp, opt_state, batch)
        for side in sides:
            for k, rel in (("loss", LOSS_REL), ("grad_norm", NORM_REL)):
                want = float(d[f"{name}/{side}{k}{i}"])
                assert abs(float(m[k]) - want) <= rel * abs(want), \
                    (name, side, k, i)
    for i, (x, s) in enumerate(state_pairs(opt_state, sspecs)):
        close_by_norm(x, blk(torch.from_numpy(d[f"{name}/state/{i}"]), s),
                      GRAD_REL, f"{name} state {i}")
        if ref and i < len(pairs):              # AdamW's first moment
            close_by_norm(x, blk(torch.from_numpy(
                d[f"{name}/ref/mu/{i}"]), s), GRAD_REL,
                f"{name} mu {i} (reference)")
    if not adamw:
        for i, (x, s) in enumerate(zip(tree.leaves(lp),
                                       part.spec_leaves(specs))):
            want = blk(torch.from_numpy(d[f"{name}/param/{i}"]), s)
            torch.testing.assert_close(x, want, rtol=1e-5,
                                       atol=2.0 ** -5 * LR,
                                       msg=lambda m: f"{name} param {i}: {m}")
        return
    lr, stepf = m["lr"], opt_state.step.to(torch.float32)
    bc1, bc2 = 1.0 - torch.pow(0.9, stepf), 1.0 - torch.pow(0.95, stepf)
    for i, (x, old, mu, nu) in enumerate(zip(
            tree.leaves(lp), before, tree.leaves(opt_state.mu),
            tree.leaves(opt_state.nu))):
        upd = (mu / bc1) / (torch.sqrt(nu / bc2) + 1e-8) + 0.1 * old
        assert torch.equal(x, old - lr * upd), f"{name} param {i}"


REF_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec
    from repro.configs import registry
    from repro.launch import steps
    from repro.models import transformer as tfm
    from repro.models.sharding import MeshRules
    from repro.train import optimizer, trainstep
    from repro.utils.jax_compat import make_mesh, set_mesh
    arch, accum, lr, warmup = {arch!r}, {accum}, {lr}, {warmup}
    d = np.load({data!r})
    mesh = make_mesh((2, 2), ("data", "model"))
    rules = MeshRules.for_mesh(mesh)
    cfg = dataclasses.replace(registry.get(arch).make_config(smoke=True),
                              compute_dtype=jnp.float32)
    b = steps.build_bundle(arch, "train_4k", mesh, smoke=True)
    is_spec = lambda x: isinstance(x, PartitionSpec)
    shard = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                   is_leaf=is_spec)
    p_sh, o_sh, b_sh = (shard(s) for s in b.in_shardings)
    leaves, treedef = jax.tree.flatten(b.args[0])
    params = treedef.unflatten([jnp.asarray(d[f"param/{{i}}"])
                                for i in range(len(leaves))])
    batches = [{{k: jnp.asarray(d[f"batch{{i}}/{{k}}"]) for k in
                ("tokens", "labels")}} for i in range({steps})]

    def loss_fn(p, bt):
        return tfm.train_loss(p, bt, cfg, rules)

    step = trainstep.make_train_step(loss_fn, optimizer.AdamWConfig(lr=lr),
                                     warmup=warmup, total_steps=50,
                                     accum_steps=accum)

    def grads_of(p, bt):        # the step's mean gradient over microbatches
        micro = jax.tree.map(lambda x: x.reshape((accum, -1) + x.shape[1:]),
                             bt)
        gs = [jax.grad(loss_fn)(p, jax.tree.map(lambda x: x[i], micro))
              for i in range(accum)]
        return jax.tree.map(lambda *g: sum(g) / accum, *gs)

    out = {{}}
    with set_mesh(mesh):
        grads = jax.jit(grads_of, in_shardings=(p_sh, b_sh))(params,
                                                             batches[0])
        for i, g in enumerate(jax.tree.leaves(grads)):
            out[f"grad/{{i}}"] = np.asarray(g)
        jitted = jax.jit(step, in_shardings=(p_sh, o_sh, b_sh),
                         out_shardings=(p_sh, o_sh, None))
        state = jax.device_put(optimizer.adamw_init(params), o_sh)
        params = jax.device_put(params, p_sh)
        for i, bt in enumerate(batches):
            params, state, m = jitted(params, state, bt)
            out[f"loss{{i}}"] = np.asarray(m["loss"])
            out[f"grad_norm{{i}}"] = np.asarray(m["grad_norm"])
    for i, x in enumerate(jax.tree.leaves(state.mu)):
        out[f"mu/{{i}}"] = np.asarray(x)
    np.savez({out!r}, **out)
    print("REF_OK")
""")


def _one_process(name, data):
    """Case ``name``'s one-process results into ``data`` (the AdamW cases'
    parameters are held to AdamW's arithmetic instead)."""
    from repro_torch.models import transformer as tfm
    cfg, step, opt_init, batches = make_step(name)
    params = init_params(cfg, 0)
    loss, grads = step.grads(params, batches[0])
    data[f"{name}/loss"] = float(loss)
    for i, g in enumerate(tree.leaves(grads)):
        data[f"{name}/grad/{i}"] = g.numpy()
    opt_state = opt_init(params)
    for i, batch in enumerate(batches):
        params, opt_state, m = step(params, opt_state, batch)
        data[f"{name}/loss{i}"] = float(m["loss"])
        data[f"{name}/grad_norm{i}"] = float(m["grad_norm"])
    for i, x in enumerate(tree.leaves(params)):
        data[f"{name}/param/{i}"] = x.numpy()
    for i, x in enumerate(tree.leaves(opt_state)[1:]):
        data[f"{name}/state/{i}"] = x.to(torch.float32).numpy()


def _bundle_data(arch, data):
    """The one-process smoke bundle's batch and one step's results."""
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.train import data as data_mod
    b = steps.build_bundle(arch, "train_4k", smoke=True, device="cpu")
    key = f"bundle/{arch}"
    params = tfm.init(b.config, seed=1, device="cpu")
    nb, s = b.args[2]["tokens"].shape
    batch = data_mod.lm_batch(1, 0, nb, s, b.config.vocab, device="cpu")
    for k, v in batch.items():
        data[f"{key}/{k}"] = v.numpy()
    _, _, m = b.fn(params, b.opt_init(params), batch)
    for k in ("loss", "grad_norm"):
        data[f"{key}/{k}"] = float(m[k])


def _start_reference(tmp_path):
    """The reference's danube steps in a subprocess (4 fake CPU devices,
    one XLA thread), started on the case's parameters and batches."""
    from repro_torch.models import transformer as tfm
    name = "danube-adamw"
    arch, _, accum = CASES[name][:3]
    cfg, _, _, batches = make_step(name)
    inputs = {f"param/{i}": x.numpy() for i, x in enumerate(
        tree.leaves(tfm.init(cfg, seed=0, device="cpu")))}
    for i, b in enumerate(batches):
        for k, v in b.items():
            inputs[f"batch{i}/{k}"] = v.numpy()
    np.savez(tmp_path / "ref_in.npz", **inputs)
    script = tmp_path / "ref.py"
    script.write_text(REF_SCRIPT.format(
        arch=arch, accum=accum, lr=LR, warmup=WARMUP, steps=STEPS,
        data=str(tmp_path / "ref_in.npz"), out=str(tmp_path / "ref.npz")))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    return subprocess.Popen([sys.executable, str(script)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def test_gloo_four_ranks_match_one_process_and_reference(tmp_path):
    ref = _start_reference(tmp_path)
    data = {}
    try:
        for name in CASES:
            _one_process(name, data)
        for arch in LM_ARCHS:
            _bundle_data(arch, data)
        out, err = ref.communicate(timeout=240)
    finally:
        ref.kill()
    assert ref.returncode == 0 and "REF_OK" in out, err[-4000:]
    with np.load(tmp_path / "ref.npz") as r:
        for k in r.files:
            data[f"danube-adamw/ref/{k}"] = r[k]
    np.savez(tmp_path / "data.npz", **data)
    script = tmp_path / "gloo_train.py"
    script.write_text(GLOO_SCRIPT.format(
        src=str(ROOT / "src"), tests=str(ROOT / "tests"),
        data=str(tmp_path / "data.npz")))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=240, env=env)
    assert run.returncode == 0 and "GLOO_TRAIN_OK" in run.stdout, \
        f"stdout:\n{run.stdout}\nstderr:\n{run.stderr[-6000:]}"
