"""LM serving partitioned under the bundles' specs (``models/partitioned.py``)
against the one-process port and the JAX reference.

Without a spawn:

* ``partitioned.local_kv``: the KV heads and the local GQA group of a
  rank's q heads at groups 1, 2 and 3 (danube's 2 local heads a KV head at
  tp 16, grok-1's 3, and heads that straddle a KV group), and the
  attention of those local heads on their KV heads equal to the same
  heads' rows of the whole attention;
* ``partitioned.lse_combine`` of a sequence cut into slices (one of them
  with no valid position) equal to the softmax over the whole sequence;
* the ring prefill's slice runs (``transformer._ring_runs``) against the
  per-position rule.

One spawn of 4 gloo CPU processes (one intra-op thread each) on a (2, 2)
("data", "model") mesh, each rank on its own blocks (``sharding.local_block``
under the specs). The parameters are the reference's own
(``repro.models.transformer.init``), carried across by
``convert.transformer_params``. For h2o-danube-3-4b's smoke config (f32
and bf16 compute; and in f32 with 3 q heads on one KV head, so that each
"model" rank's q columns hold one and a half heads, llama4-maverick's case
of 40 heads over tp 16) and grok-1's MoE smoke config under
``sharding="tp"`` and ``sharding="ep"`` (f32):

* the prefill's logits (each rank's vocab slice) and its cache block;
* 4 decode steps on a cache whose sequence the two "model" ranks split,
  the steps' positions one on each side of the split (danube: the ring
  slots 6, 7 | 8, 9 of its window of 16);
* greedy ``generate(..., mesh=...)``'s tokens;

each against the one-process port and against the reference on the same
inputs. The step bundles at smoke, run through ``build_bundle(...,
mesh=...)``: prefill_32k, decode_32k and the windowed long_500k step of
danube, and the MoE bundles (grok-1's, llama4-maverick's), each against
the one-process bundle on the same arguments (bf16 compute).

Tolerances. In f32 compute the KV caches (every layer's K and V, made
from its hidden state) within 1e-5 relative of the one-process port's (f32
sums of the row-parallel products in another order) and 1e-4 of the
reference's (``tests/test_torch_lm.py``'s). The logits come from the LM
head, a bf16 x bf16 product rounded to bf16 whatever the compute type, so
a hidden state that differs in its last f32 bits may round one of its
bf16 inputs the other way: logits within 2^-7 relative of the one-process
port's (one bf16 rounding) and 2^-6 of the reference's (the LM tests'),
each plus that share of the row's largest logit and 1e-5. Tokens equal. In
bf16 compute: the LM tests' 2e-2 relative and 2e-1 absolute.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import partitioned as part

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# No spawn: the local GQA mapping and the log-sum-exp combine.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h0,n_q,n_heads,n_kv,heads,group", [
    (2, 2, 32, 8, [0], 2),          # danube at tp 16: 2 local heads
    (6, 3, 48, 8, [1], 3),          # grok-1 / nemotron at tp 16
    (0, 8, 16, 4, [0, 1], 4),       # whole KV groups
    (2, 4, 8, 2, [0, 0, 1, 1], 1),  # straddles a KV group: one a head
    (3, 1, 8, 8, [3], 1),           # MHA
])
def test_local_kv_groups(h0, n_q, n_heads, n_kv, heads, group):
    assert part.local_kv(h0, n_q, n_heads, n_kv) == (heads, group)
    rng = np.random.default_rng(h0 + n_q)
    b, s, dh = 2, 24, 8
    q = torch.from_numpy(rng.standard_normal((b, n_heads, s, dh))
                         .astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, n_kv, s, dh))
                             .astype(np.float32)) for _ in range(2))
    whole = flash_attention_plain(q, k, v, True, None)
    kv = torch.tensor(heads)
    got = flash_attention_plain(q[:, h0:h0 + n_q], k[:, kv], v[:, kv], True,
                                None)
    assert torch.equal(got, whole[:, h0:h0 + n_q])


def test_lse_combine_equals_whole_softmax():
    rng = np.random.default_rng(3)
    b, h, s, dh = 2, 4, 30, 8
    scores = torch.from_numpy(rng.standard_normal((b, h, s))
                              .astype(np.float32)) * 3
    v = torch.from_numpy(rng.standard_normal((s, dh)).astype(np.float32))
    valid = torch.arange(s) < 20                   # the last slice: none
    want = torch.softmax(scores.masked_fill(~valid, -3.4e38), -1) @ v
    parts = []
    for lo in range(0, s, 10):
        sc = scores[..., lo:lo + 10].masked_fill(~valid[lo:lo + 10],
                                                 -3.4e38)
        m = sc.amax(-1, keepdim=True)
        e = torch.exp(sc - m).masked_fill(~valid[lo:lo + 10], 0.0)
        parts.append((m, e.sum(-1, keepdim=True), e @ v[lo:lo + 10]))
    # the combine's arithmetic, the collectives summed by hand
    top = torch.stack([p[0] for p in parts]).amax(0)
    l_ = sum(p[1] * torch.exp(p[0] - top) for p in parts)
    o = sum(p[2] * torch.exp(p[0] - top) for p in parts)
    torch.testing.assert_close(o / l_, want, rtol=1e-5, atol=1e-6)
    # one rank: the function itself, with no collective
    m, l1, o1 = parts[0]
    torch.testing.assert_close(part.lse_combine(m, l1, o1, None, 1),
                               torch.softmax(scores[..., :10], -1) @ v[:10],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("s,keep,ring,tp", [
    (22, 16, 16, 2),        # danube's window: the ring wraps in a block
    (12, 12, 20, 2),        # a prompt shorter than the ring
    (37, 16, 16, 4),        # several wraps, four blocks
    (30, 30, 30, 1),        # one process, the ring as long as the prompt
])
def test_ring_runs_cover_each_kept_position_once(s, keep, ring, tp):
    """``transformer._ring_runs``: a rank's slice runs of the prefill's
    kept positions equal the per-position rule (position p at slot
    ``p % ring``, held by the rank whose block has the slot)."""
    from repro_torch.models.transformer import _ring_runs
    n_loc = ring // tp
    for rank in range(tp):
        off = rank * n_loc
        want = sorted((p, p % ring - off) for p in range(s - keep, s)
                      if off <= p % ring < off + n_loc)
        got = sorted((src + j, dst + j) for src, dst, n in
                     _ring_runs(s, keep, ring, off, n_loc) for j in range(n))
        assert got == want, rank


# ---------------------------------------------------------------------------
# Four gloo processes on a (2, 2) ("data", "model") mesh.
# ---------------------------------------------------------------------------

# name: (arch, f32 compute, the MoE's sharding, prompt length, (q heads,
# KV heads) in place of the config's)
CASES = {"danube-f32": ("h2o-danube-3-4b", True, None, 22, None),
         "danube-bf16": ("h2o-danube-3-4b", False, None, 22, None),
         "danube-h3-f32": ("h2o-danube-3-4b", True, None, 22, (3, 1)),
         "grok-tp-f32": ("grok-1-314b", True, "tp", 32, None),
         "grok-ep-f32": ("grok-1-314b", True, "ep", 32, None)}
B, STEPS, NEW = 4, 4, 4
BUNDLES = (("h2o-danube-3-4b", "prefill_32k"), ("h2o-danube-3-4b",
                                                 "decode_32k"),
           ("h2o-danube-3-4b", "long_500k"), ("grok-1-314b", "prefill_32k"),
           ("grok-1-314b", "decode_32k"),
           ("llama4-maverick-400b-a17b", "prefill_32k"),
           ("llama4-maverick-400b-a17b", "decode_32k"))

GLOO_SCRIPT = textwrap.dedent("""
    import dataclasses, datetime, json, sys
    sys.path.insert(0, {src!r})
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, world, port):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{{port}}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=60))
        from repro_torch import convert
        from repro_torch.launch import mesh as mesh_mod, steps
        from repro_torch.models import partitioned as part, sharding
        from repro_torch.models import transformer as tfm
        from repro_torch.models.sharding import MeshRules, P
        from repro_torch.serve import decode
        sys.path.insert(0, {tests!r})
        from test_torch_lm_partitioned import config, close
        d = np.load({data!r})
        meta = json.loads(open({meta!r}).read())
        mesh = mesh_mod.Mesh(("data", "model"), (2, 2))
        dm = mesh_mod.device_mesh(mesh, "cpu")
        coords = dict(zip(mesh.axis_names, dm.get_coordinate()))
        rules = MeshRules.for_mesh(mesh)
        groups = part.groups_on(mesh, rules, "cpu")

        def blk(x, spec):
            if isinstance(x, dict):
                return {{k: blk(x[k], spec[k]) for k in x}}
            return sharding.local_block(x, spec, mesh, coords)

        def tree(prefix, tensors=False):
            out = {{}}
            for key in d.files:
                if key.startswith(prefix + "/"):
                    node, path = out, key[len(prefix) + 1:].split("/")
                    for p in path[:-1]:
                        node = node.setdefault(p, {{}})
                    node[path[-1]] = torch.from_numpy(d[key]) if tensors \
                        else d[key]
            return out

        logit_spec = P(("data",), "model")
        for name, (arch, f32, moe, s0, heads) in meta["cases"].items():
            cfg = config(arch, f32, moe, heads)
            params = convert.transformer_params(tree(name + "/params"), cfg,
                                                device="cpu")
            specs = tfm.param_specs(cfg, rules)
            cspecs = tfm.cache_specs(cfg, rules)
            lp = blk(params, specs)
            tok = torch.from_numpy(d[name + "/tokens"])
            lt = blk(tok, P(("data",), None))
            label = f"{{name}} rank {{rank}}"

            def check(got, key, spec, cache=False):
                for side in ("port", "ref"):
                    want = blk(torch.from_numpy(d[f"{{name}}/{{side}}/{{key}}"]),
                               spec)
                    close(got, want, f32, side, cache, f"{{label}} {{key}}")

            logits, cache = tfm.prefill_step(lp, lt[:, :s0], cfg, groups,
                                             specs)
            check(logits, "prefill", logit_spec)
            for kk in ("k", "v"):
                check(cache[kk], "prefill_" + kk, cspecs[kk], cache=True)
            lc = {{kk: blk(torch.from_numpy(d[f"{{name}}/cache0_{{kk}}"]).to(
                cfg.compute_dtype), cspecs[kk]).clone() for kk in ("k", "v")}}
            for i in range(meta["steps"]):
                t = blk(tok[:, s0 + i], P(("data",)))
                logits, lc = tfm.decode_step(lp, lc, t, s0 + i, cfg, groups,
                                             specs)
                check(logits, f"decode{{i}}", logit_spec)
            for kk in ("k", "v"):
                check(lc[kk], "decode_" + kk, cspecs[kk], cache=True)
            g0 = meta["gen_s0"][name]
            out = decode.generate(lp, lt[:, :g0], meta["new"], cfg, mesh=mesh)
            for side in ("port", "ref"):
                want = blk(torch.from_numpy(d[f"{{name}}/{{side}}/generate"]),
                           P(("data",), None))
                assert torch.equal(out, want.to(out.dtype)), (label, side)

        # the bundles at smoke, each rank on its blocks
        for arch, shape in meta["bundles"]:
            b = steps.build_bundle(arch, shape, smoke=True, device="cpu",
                                   mesh=mesh)
            key = f"bundle/{{arch}}/{{shape}}"
            args = [blk(tree(key + "/params", tensors=True), b.in_specs[0])]
            for i, (a, s) in enumerate(zip(b.args[1:], b.in_specs[1:]), 1):
                if isinstance(a, dict):             # the decode cache
                    args.append({{kk: blk(torch.from_numpy(
                        d[f"{{key}}/cache_{{kk}}"]).to(a[kk].dtype),
                        s[kk]).clone() for kk in ("k", "v")}})
                else:
                    args.append(blk(torch.from_numpy(d[f"{{key}}/arg{{i}}"]),
                                    s))
            out = b.fn(*args)
            close(out[0], blk(torch.from_numpy(d[key + "/logits"]),
                              b.out_specs[0]), False, "port", False, key)
            for kk in ("k", "v"):
                close(out[1][kk], blk(torch.from_numpy(
                    d[f"{{key}}/out_{{kk}}"]), b.out_specs[1][kk]),
                    False, "port", True, key)
        dist.barrier()
        if rank == 0:
            print("GLOO_LM_OK", flush=True)
        dist.destroy_process_group()

    if __name__ == "__main__":
        import socket
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        mp.spawn(run, args=(4, port), nprocs=4)
""")


def config(arch, f32: bool, moe, heads=None, ref: bool = False):
    """The smoke config of ``arch`` (the reference's with ``ref``), in f32
    compute where asked, its MoE under ``moe`` sharding and ``heads`` (q
    heads, KV heads) in place of its own where given."""
    if ref:
        import jax.numpy as jnp
        from repro.configs import registry as ref_registry
        cfg = ref_registry.get(arch).make_config(smoke=True)
        dt = jnp.float32
    else:
        cfg = registry.get(arch).make_config(smoke=True)
        dt = torch.float32
    if f32:
        cfg = dataclasses.replace(cfg, compute_dtype=dt)
    if moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, sharding=moe))
    if heads is not None:
        cfg = dataclasses.replace(cfg, n_heads=heads[0],
                                  n_kv_heads=heads[1])
    return cfg


def close(got, want, f32: bool, side: str, cache: bool, label: str):
    """The stated tolerances (module docstring)."""
    got, want = got.to(torch.float32), want.to(torch.float32)
    if not f32:
        rtol, atol = 2e-2, 2e-1
    elif cache:
        rtol, atol = (1e-5, 1e-5) if side == "port" else (1e-4, 1e-4)
    else:       # bf16 roundings of the head at the row's scale
        rtol = 2.0 ** -7 if side == "port" else 2.0 ** -6
        atol = 1e-5 + rtol * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{label}: {m}")


def _flat(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(v, f"{prefix}/{k}", out)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v, np.float32)


def _f32(x):
    """A copy in f32 (a decode step writes its cache in place)."""
    return np.array(x.detach().to(torch.float32).numpy()
                    if torch.is_tensor(x) else x, np.float32)


def _ring_cache(cache, s0, cl, make):
    """``cache`` (position order, its trailing positions) placed in a ring
    of ``cl`` slots: position p at slot p % cl."""
    keep = cache["k"].shape[2]
    slots = np.arange(s0 - keep, s0) % cl
    full = {k: make(k) for k in ("k", "v")}
    for k in ("k", "v"):
        full[k][:, :, slots] = cache[k]
    return full


def _reference(arch, f32, heads, s0, gen_s0, known):
    """The reference's parameters, tokens and results at ``arch`` in f32 or
    bf16 compute, made once: the MoE's sharding changes its specs only, so
    both shardings of a config read the same results."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as ref_tfm
    from repro.models.sharding import MeshRules as RefRules
    from repro.serve import decode as ref_decode

    if (arch, f32, heads) in known:
        return known[arch, f32, heads]
    rc = config(arch, f32, None, heads, ref=True)
    rules = RefRules(dp=(), fsdp=(), tp=None, ep=None)
    rp = ref_tfm.init(jax.random.PRNGKey(0), rc)
    rng = np.random.default_rng(s0 + f32)
    tok = rng.integers(0, rc.vocab, (B, s0 + STEPS)).astype(np.int32)
    out = {"params": jax.tree.map(np.asarray, rp), "tokens": tok}
    rl, rcache = ref_tfm.prefill_step(rp, jnp.asarray(tok[:, :s0]), rc,
                                      rules)
    out["prefill"] = _f32(rl)
    for k in ("k", "v"):
        out["prefill_" + k] = _f32(rcache[k])
    cl = tfm_cache_len(arch, s0 + STEPS)
    rfull = _ring_cache({k: np.asarray(rcache[k]) for k in ("k", "v")}, s0,
                        cl, lambda k: np.zeros((rc.n_layers, B, cl)
                                               + rcache[k].shape[3:],
                                               np.asarray(rcache[k]).dtype))
    rfull = {k: jnp.asarray(v) for k, v in rfull.items()}
    for i in range(STEPS):
        rl, rfull = ref_tfm.decode_step(rp, rfull, jnp.asarray(tok[:, s0 + i]),
                                        jnp.asarray(s0 + i, jnp.int32), rc,
                                        rules)
        out[f"decode{i}"] = _f32(rl)
    for k in ("k", "v"):
        out["decode_" + k] = _f32(rfull[k])
    out["generate"] = np.asarray(ref_decode.generate(
        rp, jnp.asarray(tok[:, :gen_s0]), NEW, rc))
    known[arch, f32, heads] = out
    return out


def tfm_cache_len(arch, max_seq):
    from repro_torch.models import transformer as tfm
    return tfm.cache_len(registry.get(arch).make_config(smoke=True), max_seq)


def _case_data(name, arch, f32, moe, s0, heads, data, gen_s0, known):
    """The one-process port's and the reference's results of one case."""
    from repro_torch import convert
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import decode

    ref = _reference(arch, f32, heads, s0, gen_s0, known)
    pc = config(arch, f32, moe, heads)
    _flat(ref["params"], name + "/params", data)
    pp = convert.transformer_params(ref["params"], pc, device="cpu")
    tok = ref["tokens"]
    data[name + "/tokens"] = tok
    for key, val in ref.items():
        if key not in ("params", "tokens"):
            data[f"{name}/ref/{key}"] = val
    cl = tfm.cache_len(pc, s0 + STEPS)
    pl, pcache = tfm.prefill_step(pp, torch.from_numpy(tok[:, :s0]), pc)
    data[name + "/port/prefill"] = _f32(pl)
    for k in ("k", "v"):
        data[f"{name}/port/prefill_{k}"] = _f32(pcache[k])
    pfull = _ring_cache(pcache, s0, cl, lambda k: torch.zeros(
        (pc.n_layers, B, cl) + tuple(pcache[k].shape[3:]),
        dtype=pc.compute_dtype))
    for k in ("k", "v"):
        data[f"{name}/cache0_{k}"] = _f32(pfull[k])
    for i in range(STEPS):
        pl, pfull = tfm.decode_step(pp, pfull,
                                    torch.from_numpy(tok[:, s0 + i]), s0 + i,
                                    pc)
        data[f"{name}/port/decode{i}"] = _f32(pl)
    for k in ("k", "v"):
        data[f"{name}/port/decode_{k}"] = _f32(pfull[k])
    data[name + "/port/generate"] = decode.generate(
        pp, torch.from_numpy(tok[:, :gen_s0]), NEW, pc, device="cpu").numpy()


def _bundle_data(arch, shape, data):
    """The smoke bundle's arguments and its one-process results."""
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm

    b = steps.build_bundle(arch, shape, smoke=True, device="cpu")
    key = f"bundle/{arch}/{shape}"
    params = tfm.init(b.config, seed=1, device="cpu")
    _flat(params, key + "/params", data)
    rng = np.random.default_rng(len(key))
    args = [params]
    for i, a in enumerate(b.args[1:], 1):
        if isinstance(a, dict):                 # the decode cache
            cache = {}
            for k, v in a.items():
                x = rng.standard_normal(tuple(v.shape)).astype(np.float32)
                data[f"{key}/cache_{k}"] = x
                cache[k] = torch.from_numpy(x).to(v.dtype)
            args.append(cache)
        elif a.ndim == 0:                       # the position
            s_c = b.args[1]["k"].shape[2]
            # past the ring's end (SWA), else in the cache's second half
            pos = s_c * 3 // 2 + 1 if b.config.swa_window else s_c // 2 + 1
            pos = np.asarray(pos, np.int64)
            data[f"{key}/arg{i}"] = pos
            args.append(torch.from_numpy(pos))
        else:
            x = rng.integers(0, b.config.vocab, tuple(a.shape)).astype(
                np.int32)
            data[f"{key}/arg{i}"] = x
            args.append(torch.from_numpy(x))
    logits, cache = b.fn(*args)
    data[key + "/logits"] = _f32(logits)
    for k in ("k", "v"):
        data[f"{key}/out_{k}"] = _f32(cache[k])


def test_gloo_four_ranks_match_one_process_and_reference(tmp_path):
    data, gen_s0, known = {}, {}, {}
    for name, (arch, f32, moe, s0, heads) in CASES.items():
        # the reference's generate re-homes a prompt longer than the
        # window wrongly (ROADMAP C3): its prompt stays within the window
        gen_s0[name] = 16 if arch == "h2o-danube-3-4b" else s0
        _case_data(name, arch, f32, moe, s0, heads, data, gen_s0[name],
                   known)
    for arch, shape in BUNDLES:
        _bundle_data(arch, shape, data)
    np.savez(tmp_path / "data.npz", **data)
    (tmp_path / "meta.json").write_text(json.dumps(
        {"cases": CASES, "steps": STEPS, "new": NEW, "gen_s0": gen_s0,
         "bundles": BUNDLES}))
    script = tmp_path / "gloo_lm.py"
    script.write_text(GLOO_SCRIPT.format(
        src=str(ROOT / "src"), tests=str(ROOT / "tests"),
        data=str(tmp_path / "data.npz"), meta=str(tmp_path / "meta.json")))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=240, env=env)
    assert out.returncode == 0 and "GLOO_LM_OK" in out.stdout, \
        f"stdout:\n{out.stdout}\nstderr:\n{out.stderr[-4000:]}"


def test_generate_over_a_mesh_refuses_sampling():
    """``generate(..., mesh=)`` is greedy only: sampling raises before any
    process group is touched."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import decode
    cfg = config("h2o-danube-3-4b", True, None)
    params = tfm.init(cfg, seed=0, device="cpu")
    mesh = mesh_mod.Mesh(("data", "model"), (2, 2))
    with pytest.raises(ValueError, match="greedy only"):
        decode.generate(params, torch.zeros((2, 4), dtype=torch.int32), 2,
                        cfg, temperature=1.0, mesh=mesh)
