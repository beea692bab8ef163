"""The port's LM serving slice against the JAX reference.

Same numpy inputs through both sides: the attention kernel's plain version
(what ``kernels.flash_attention`` runs on a CPU tensor) against the Pallas
kernel in interpret mode and its ``ref.py`` oracle; ``rmsnorm``, ``rope``
and ``decode_attention``; ``prefill_step`` and ``decode_step`` of the three
dense smoke configs on the reference's own parameters carried across by
``convert.transformer_params``; greedy ``generate``; and the reference's
sliding-window cache fault (ROADMAP C3), which the port does not have.

Tolerances:

* attention and layers in f32: 2e-4, the reference's own for its kernel
  (the same f32 sums in another order); bf16: 3e-2, the reference's own;
* whole models in f32 compute: logits within 2^-6 relative (each side's
  LM head is a bf16 x bf16 product rounded to bf16, so a logit may land
  one bf16 ulp, 2^-7 relative, away; twice that for margin) and 1e-5
  absolute; KV caches within 1e-4 (f32 products of width 64 in another
  order);
* whole models in bf16 compute: rtol 2e-2, atol 2e-1, the reference's own
  for its bf16 LM (``tests/test_archs.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gcn_cora as ref_gcn_cora
from repro.configs import h2o_danube3_4b as ref_danube
from repro.configs import lm_common as ref_lm_common
from repro.configs import nemotron4_15b as ref_nemotron
from repro.configs import qwen2_72b as ref_qwen
from repro.kernels.flash_attention import flash_attention, flash_attention_ref
from repro.models import attention as ref_attention
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tfm
from repro.models.sharding import MeshRules
from repro.serve import decode as ref_decode
from repro_torch import convert
from repro_torch import kernels as K
from repro_torch.configs import lm_common, registry
from repro_torch.kernels.flash_attention import Q_CHUNK
from repro_torch.models import attention, layers
from repro_torch.models import transformer as tfm
from repro_torch.serve import decode

RULES = MeshRules(dp=(), fsdp=(), tp=None, ep=None)
REF_CONFIGS = {m.ARCH_ID: m for m in (ref_danube, ref_qwen, ref_nemotron)}
ARCHS = sorted(REF_CONFIGS)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# (a) the kernel's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,kv,s,dh,bq,bk,window,causal,dtype", [
    (1, 4, 4, 64, 16, 32, 32, None, True, "f32"),     # MHA
    (2, 4, 2, 96, 32, 32, 32, None, True, "f32"),     # GQA
    (2, 8, 2, 128, 16, 64, 32, None, True, "f32"),    # GQA group 4
    (1, 4, 2, 128, 32, 32, 32, 48, True, "f32"),      # sliding window
    (2, 4, 2, 80, 32, 32, 32, None, True, "f32"),     # padded seq
    (1, 4, 2, 64, 16, 32, 32, None, False, "f32"),    # not causal
    (1, 2, 2, 64, 32, 32, 32, None, True, "bf16"),
])
def test_flash_attention_plain_matches_reference(b, h, kv, s, dh, bq, bk,
                                                 window, causal, dtype):
    rng = np.random.default_rng(0)
    q, k, v = (_randn(rng, b, n, s, dh) for n in (h, kv, kv))
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    tol = 3e-2 if dtype == "bf16" else 2e-4
    qj, kj, vj = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    want_kernel = flash_attention(qj, kj, vj, causal=causal, window=window,
                                  bq=bq, bk=bk, interpret=True)
    want_ref = flash_attention_ref(qj, kj, vj, causal=causal, window=window)
    got = K.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                            causal=causal, window=window)
    assert got.dtype == tdt and got.shape == (b, h, s, dh)
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_flash_attention_plain_chunks_and_strides():
    """Query chunks (S over three chunks, the last one ragged, a window
    across chunk edges) and strided (transposed) inputs change nothing:
    the plain version on (B, heads, S, dh) views of (B, S, heads, dh)
    arrays against the reference's dense oracle, and against itself on
    contiguous copies."""
    rng = np.random.default_rng(1)
    s = 2 * Q_CHUNK + 76
    x = _randn(rng, 1, s, 4, 16)                        # (B, S, H, dh)
    kv = _randn(rng, 1, s, 2, 16)
    q = torch.from_numpy(x).transpose(1, 2)
    k = torch.from_numpy(kv).transpose(1, 2)
    got = K.flash_attention_plain(q, k, k, window=Q_CHUNK + 88)
    want = flash_attention_ref(jnp.asarray(x.transpose(0, 2, 1, 3)),
                               jnp.asarray(kv.transpose(0, 2, 1, 3)),
                               jnp.asarray(kv.transpose(0, 2, 1, 3)),
                               window=Q_CHUNK + 88)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(
        K.flash_attention_plain(q.contiguous(), k.contiguous(),
                                k.contiguous(), window=Q_CHUNK + 88),
        got, rtol=2e-6, atol=2e-6)
    with pytest.raises(ValueError, match="window"):
        K.flash_attention(q, k, k, window=0)
    with pytest.raises(ValueError, match="H % KV"):
        K.flash_attention(q, k[:, :1].expand(1, 3, s, 16), k[:, :1].expand(
            1, 3, s, 16))


def _bf16_weights_attention(q, k, v, window):
    """The kernel's bf16 arithmetic in torch (q, k, v with H == KV): f32
    scores and row sums, the unnormalised weights rounded to bf16 for the
    PV product, the output rounded to bf16."""
    s = q.shape[2]
    i = torch.arange(s)
    mask = (i[:, None] >= i[None]) & (i[:, None] - i[None] < window)
    sc = (q.float() / q.shape[-1] ** 0.5) @ k.float().transpose(-1, -2)
    sc = sc.masked_fill(~mask, float("-inf"))
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    o = (p.bfloat16().float() @ v.float()) / p.sum(-1, keepdim=True)
    return o.bfloat16()


@pytest.mark.parametrize("case,caught", [
    ("bf16 weights", False),        # the kernel's own rounding: admitted
    ("window edge tile", True),     # each row's oldest 64 keys dropped
    ("row sum 3 %", True),          # every output 3 % off
])
def test_attention_tolerance_admits_rounding_and_catches_faults(case,
                                                                caught):
    """``testing.attention_error``'s bf16 tolerance, scaled element by
    element with ``attention_abs_mix``: it admits the kernel's rounding of
    the weights and rejects a KV tile skipped at the window's edge or a
    row sum a few percent off, at a window of 1,024 keys."""
    from repro_torch import testing
    rng = np.random.default_rng(9)
    s, window = 1300, 1024
    q, k, v = (torch.from_numpy(_randn(rng, 1, 2, s, 64)).bfloat16()
               for _ in range(3))
    want = K.flash_attention_plain(q, k, v, window=window)
    if case == "bf16 weights":
        got = _bf16_weights_attention(q, k, v, window)
    elif case == "window edge tile":
        got = K.flash_attention_plain(q, k, v, window=window - 64)
    else:
        got = (want.float() * 1.03).bfloat16()
    _, used = testing.attention_error(
        got, want, testing.attention_abs_mix(q, k, v, window=window))
    assert (used > 1) == caught


# ---------------------------------------------------------------------------
# (b) layers and decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_and_rope_match_reference(dtype):
    rng = np.random.default_rng(2)
    x = _randn(rng, 2, 9, 4, 16)
    scale = _randn(rng, 16)
    pos = np.broadcast_to(np.arange(3, 12)[None], (2, 9)).astype(np.int32)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    tol = 3e-2 if dtype == "bf16" else 2e-4
    xj, xt = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    got = layers.rmsnorm({"scale": torch.from_numpy(scale)}, xt)
    want = ref_layers.rmsnorm({"scale": jnp.asarray(scale)}, xj)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    got = layers.rope(xt, torch.from_numpy(pos), 1e4)
    want = ref_layers.rope(xj, jnp.asarray(pos), 1e4)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu", "squared_relu"])
def test_activation_matches_reference(name):
    x = _randn(np.random.default_rng(3), 5, 7)
    np.testing.assert_allclose(
        _np(layers.activation(name, torch.from_numpy(x))),
        _np(ref_layers.activation(name, jnp.asarray(x))), rtol=2e-6,
        atol=2e-6)


@pytest.mark.parametrize("length", [7, np.array([3, 12])])
def test_decode_attention_matches_reference(length):
    rng = np.random.default_rng(4)
    q = _randn(rng, 2, 8, 16)
    kc, vc = _randn(rng, 2, 12, 2, 16), _randn(rng, 2, 12, 2, 16)
    got = attention.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.as_tensor(length))
    want = ref_attention.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                          jnp.asarray(vc),
                                          jnp.asarray(length))
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


def test_prefill_attention_is_the_kernel_on_transposed_views(monkeypatch):
    """The transformer's attention lowers to ``flash_attention`` on
    (B, heads, S, dh) views of its (B, S, heads, dh) tensors."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(_randn(rng, 2, 30, 4, 16))
    k = torch.from_numpy(_randn(rng, 2, 30, 2, 16))
    seen = []

    def spy(qq, kk, vv, causal=True, window=None):
        seen.append((qq.shape, kk.shape, causal, window))
        return K.flash_attention(qq, kk, vv, causal=causal, window=window)

    monkeypatch.setattr(attention, "flash_attention", spy)
    got = attention.prefill_attention(q, k, k, window=8)
    assert seen == [((2, 4, 30, 16), (2, 2, 30, 16), True, 8)]
    want = ref_attention.chunked_attention(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(k.numpy()), window=8, q_chunk=16)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# (c) prefill and decode steps of the dense smoke configs
# ---------------------------------------------------------------------------

def _configs(arch, f32: bool):
    rc = REF_CONFIGS[arch].make_config(smoke=True)
    pc = registry.get(arch).make_config(smoke=True)
    if f32:
        rc = dataclasses.replace(rc, compute_dtype=jnp.float32)
        pc = dataclasses.replace(pc, compute_dtype=torch.float32)
    return rc, pc


def _ref_params(rc, seed: int = 0):
    params = ref_tfm.init(jax.random.PRNGKey(seed), rc)
    if rc.qkv_bias:                 # nonzero biases, so they are exercised
        lay = dict(params["layers"])
        for i, name in enumerate(("bq", "bk", "bv")):
            lay[name] = 0.1 * jax.random.normal(jax.random.PRNGKey(10 + i),
                                                lay[name].shape,
                                                lay[name].dtype)
        params = dict(params, layers=lay)
    return params


def _close(got, want, f32: bool, cache: bool = False):
    if f32:
        rtol, atol = (1e-4, 1e-4) if cache else (2.0 ** -6, 1e-5)
    else:
        rtol, atol = 2e-2, 2e-1
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, f32):
    rc, pc = _configs(arch, f32)
    params = _ref_params(rc)
    tp = convert.transformer_params(jax.tree.map(np.asarray, params), pc,
                                    device="cpu")
    rng = np.random.default_rng(6)
    s0 = 24                        # past danube's window of 16
    tokens = rng.integers(0, rc.vocab, (2, s0 + 1)).astype(np.int32)
    want_l, want_c = ref_tfm.prefill_step(params, jnp.asarray(tokens[:, :s0]),
                                          rc, RULES)
    got_l, got_c = tfm.prefill_step(tp, torch.from_numpy(tokens[:, :s0]), pc)
    assert got_l.dtype == torch.float32 and got_l.shape == (2, rc.vocab)
    assert got_c["k"].shape == tuple(want_c["k"].shape)
    _close(got_l, want_l, f32)
    for kk in ("k", "v"):
        _close(got_c[kk], want_c[kk], f32, cache=True)
    # one decode step on the same cache: the ring slot s0 % 16 for danube,
    # the plain slot s0 otherwise
    max_seq = s0 + 4
    rfull = ref_tfm.init_cache(rc, 2, max_seq, dtype=want_c["k"].dtype)
    keep = want_c["k"].shape[2]
    slots = np.arange(s0 - keep, s0) % rfull["k"].shape[2]
    rfull = {kk: rfull[kk].at[:, :, slots].set(want_c[kk])
             for kk in ("k", "v")}
    pfull = {kk: torch.from_numpy(np.array(rfull[kk], np.float32)).to(
        pc.compute_dtype) for kk in ("k", "v")}
    want_l, want_c = ref_tfm.decode_step(params, rfull,
                                         jnp.asarray(tokens[:, s0]),
                                         jnp.asarray(s0, jnp.int32), rc,
                                         RULES)
    got_l, got_c = tfm.decode_step(tp, pfull, torch.from_numpy(tokens[:, s0]),
                                   s0, pc)
    _close(got_l, want_l, f32)
    for kk in ("k", "v"):
        _close(got_c[kk], want_c[kk], f32, cache=True)


def test_full_configs_match_reference():
    """The port's copies hold the reference's numbers, in torch dtypes."""
    for arch in ARCHS:
        for smoke in (True, False):
            rc = REF_CONFIGS[arch].make_config(smoke=smoke)
            pc = registry.get(arch).make_config(smoke=smoke)
            for f in dataclasses.fields(pc):
                want, got = getattr(rc, f.name), getattr(pc, f.name)
                if f.name.endswith("_dtype"):
                    assert str(got).split(".")[-1] == jnp.dtype(want).name
                else:
                    assert got == want, (arch, smoke, f.name)
    assert lm_common.LM_SHAPES == ref_lm_common.LM_SHAPES
    gcn = registry.get("gcn-cora")          # the GNN's config, its model
    for name in ("ARCH_ID", "FAMILY", "SHAPES", "SKIPS"):  # models/gnn.py
        assert getattr(gcn, name) == getattr(ref_gcn_cora, name), name
    for shape in gcn.SHAPES.values():
        for smoke in (True, False):
            kw = {"d_feat": shape["d_feat"], "n_classes": shape["n_classes"]}
            rc = ref_gcn_cora.make_config(smoke=smoke, **kw)
            pc = gcn.make_config(smoke=smoke, **kw)
            for f in dataclasses.fields(pc):
                want, got = getattr(rc, f.name), getattr(pc, f.name)
                if f.name.endswith("_dtype"):
                    assert str(got).split(".")[-1] == jnp.dtype(want).name
                else:
                    assert got == want, (shape, smoke, f.name)


def test_init_scales_follow_the_reference():
    cfg = registry.get("qwen2-72b").make_config(smoke=True)
    p = tfm.init(cfg, seed=3, device="cpu")
    want = jax.tree.map(np.shape, ref_tfm.init(jax.random.PRNGKey(0),
                        REF_CONFIGS["qwen2-72b"].make_config(smoke=True)))
    got = jax.tree.map(lambda t: tuple(t.shape), p)
    assert got == jax.tree.map(tuple, want, is_leaf=lambda x: isinstance(
        x, tuple))
    assert tfm.param_count(p) == sum(np.prod(s) for s in jax.tree.leaves(
        want, is_leaf=lambda x: isinstance(x, tuple)))
    lay = p["layers"]
    assert abs(float(lay["wq"].std()) - cfg.d_model ** -0.5) < 0.01
    assert abs(float(lay["w_down"].std()) - cfg.d_ff ** -0.5) < 0.01
    assert abs(float(p["embed"].std()) - 0.02) < 0.002
    assert float(lay["bq"].abs().max()) == 0.0
    assert torch.equal(tfm.init(cfg, seed=3, device="cpu")["lm_head"],
                       p["lm_head"])


# ---------------------------------------------------------------------------
# (d) greedy generation, and the reference's ring fault (ROADMAP C3)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,s0", [("h2o-danube-3-4b", 12),
                                     ("h2o-danube-3-4b", 32),
                                     ("qwen2-72b", 12)])
def test_generate_greedy_matches_reference(arch, s0):
    """s0 <= W and s0 = 2W (where the reference's cache re-homing is
    right), f32 compute: the same greedy tokens."""
    rc, pc = _configs(arch, f32=True)
    params = _ref_params(rc)
    tp = convert.transformer_params(jax.tree.map(np.asarray, params), pc,
                                    device="cpu")
    prompt = np.random.default_rng(7).integers(0, rc.vocab, (2, s0)).astype(
        np.int32)
    want = ref_decode.generate(params, jnp.asarray(prompt), 6, rc)
    got = decode.generate(tp, torch.from_numpy(prompt), 6, pc, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_samples_with_a_generator():
    cfg = registry.get("nemotron-4-15b").make_config(smoke=True)
    params = tfm.init(cfg, seed=1, device="cpu")
    prompt = torch.zeros((2, 5), dtype=torch.int64)
    outs = [decode.generate(params, prompt, 4, cfg, temperature=0.8,
                            generator=torch.Generator().manual_seed(s),
                            device="cpu") for s in (0, 0, 1)]
    assert outs[0].shape == (2, 9) and torch.equal(outs[0], outs[1])
    assert int(outs[0].min()) >= 0 and int(outs[0].max()) < cfg.vocab


class _ArgmaxSpy:
    """Stands in for ``jax.numpy`` inside the reference's ``serve/decode.py``
    and records the logits each ``argmax`` is given: the prefill's, then
    each decode step's, as concrete arrays."""

    def __init__(self):
        self.seen = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def argmax(self, x, *a, **k):
        self.seen.append(np.asarray(x))
        return jnp.argmax(x, *a, **k)


@pytest.mark.parametrize("s0", [16, 20, 32])
def test_reference_ring_fault_and_port_agreement(monkeypatch, s0):
    """ROADMAP C3: with a prompt past the window and s0 % W != 0 (W = 16,
    s0 = 20), the reference's ``generate`` re-homes the prefill's window
    into slots 0..W-1 while ``decode_step`` reads a ring (slot p % W), so
    its first decode step disagrees with its own ``prefill_step`` over the
    same s0 + 1 tokens; at s0 = W and 2W it agrees. The port's ring
    re-homing agrees with that prefill at every s0."""
    rc, pc = _configs("h2o-danube-3-4b", f32=True)
    assert rc.swa_window == 16
    params = _ref_params(rc)
    tp = convert.transformer_params(jax.tree.map(np.asarray, params), pc,
                                    device="cpu")
    prompt = np.random.default_rng(8).integers(0, rc.vocab, (2, s0)).astype(
        np.int32)
    spy = _ArgmaxSpy()
    monkeypatch.setattr(ref_decode, "jnp", spy)
    ref_tokens = np.asarray(ref_decode.generate(params, jnp.asarray(prompt),
                                                2, rc))
    monkeypatch.undo()
    ref_step = spy.seen[1]                    # the first decode step
    truth, _ = ref_tfm.prefill_step(params, jnp.asarray(ref_tokens[:, :s0 + 1]),
                                    rc, RULES)
    if s0 % rc.swa_window:
        assert np.abs(ref_step - np.asarray(truth)).max() > 0.1
    else:
        _close(ref_step, truth, f32=True)

    port_steps = []
    orig = tfm.decode_step

    def spy_step(*a):
        out = orig(*a)
        port_steps.append(out[0].clone())
        return out

    monkeypatch.setattr(tfm, "decode_step", spy_step)
    got = decode.generate(tp, torch.from_numpy(prompt), 2, pc, device="cpu")
    np.testing.assert_array_equal(got.numpy()[:, :s0 + 1],
                                  ref_tokens[:, :s0 + 1])
    _close(port_steps[0], truth, f32=True)


# ---------------------------------------------------------------------------
# (e) a blocked-layout parameter tree
# ---------------------------------------------------------------------------

def test_blocked_layout_params_carry_across():
    """A reference tree in the blocked layout (n_blocks, block, ...) comes
    across flattened to (L, ...), equal to the flat tree of the same
    draw, and serves the reference's logits."""
    rc = dataclasses.replace(ref_danube.make_config(smoke=True),
                             compute_dtype=jnp.float32, remat_block=1)
    assert ref_tfm.blocked_layout(rc)
    pc = dataclasses.replace(registry.get("h2o-danube-3-4b").make_config(
        smoke=True), compute_dtype=torch.float32)
    blocked = ref_tfm.init(jax.random.PRNGKey(0), rc)
    flat = ref_tfm.init(jax.random.PRNGKey(0),
                        dataclasses.replace(rc, remat_block=0))
    assert blocked["layers"]["wq"].ndim == 4
    tb = convert.transformer_params(jax.tree.map(np.asarray, blocked), pc,
                                    device="cpu")
    tf = convert.transformer_params(jax.tree.map(np.asarray, flat), pc,
                                    device="cpu")
    assert tb["layers"]["wq"].shape == (2, 64, 64)
    for a, b in zip(jax.tree.leaves(tb), jax.tree.leaves(tf)):
        assert torch.equal(a, b)
    tokens = np.random.default_rng(9).integers(0, rc.vocab, (2, 10)).astype(
        np.int32)
    want, _ = ref_tfm.prefill_step(blocked, jnp.asarray(tokens), rc, RULES)
    got, _ = tfm.prefill_step(tb, torch.from_numpy(tokens), pc)
    _close(got, want, f32=True)


def test_bf16_leaves_cross_exactly():
    rc = ref_danube.make_config(smoke=True)
    pc = registry.get("h2o-danube-3-4b").make_config(smoke=True)
    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                          ref_tfm.init(jax.random.PRNGKey(0), rc))
    tp = convert.transformer_params(jax.tree.map(np.asarray, params), pc,
                                    device="cpu")
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(params)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.to(torch.float32).numpy(),
                                      np.asarray(b, np.float32))
