"""The port's MoE serving slice against the JAX reference.

Same numpy inputs through both sides: ``moe_apply`` of both smoke MoE
configs (4 experts top-2, 8 experts top-1) on the reference's own
parameters, its slot assignment (every choice's slot, so the same choices
dropped) also where a skewed router overflows the capacity, ``_capacity``,
the refusal of a token count off the group; ``prefill_step``,
``decode_step`` and greedy ``generate`` of both smoke configs on the
reference's parameters carried across by ``convert.transformer_params``
(flat and blocked); ``init``'s tree and scales; the full configs' fields;
and ROADMAP C2, grok-1's prefill against its own decode chain.

Tolerances:

* ``moe_apply`` in f32 compute: 1e-5 (f32 products of width 64 and 128
  in another order); in bf16: rtol 2e-2, atol 2e-1, the reference's own
  for its bf16 LM (``tests/test_archs.py``); the aux loss, f32 on both
  sides whatever the compute type: 1e-6;
* whole models: ``tests/test_torch_lm.py``'s (f32: logits within 2^-6
  relative and 1e-5 absolute, KV caches 1e-4; bf16: 2e-2 / 2e-1).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import grok1_314b as ref_grok
from repro.configs import lm_common as ref_lm_common
from repro.configs import llama4_maverick as ref_maverick
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tfm
from repro.models.sharding import MeshRules
from repro.serve import decode as ref_decode
from repro_torch import convert
from repro_torch.configs import lm_common, registry
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.serve import decode

RULES = MeshRules(dp=(), fsdp=(), tp=None, ep=None)
REF_CONFIGS = {m.ARCH_ID: m for m in (ref_grok, ref_maverick)}
ARCHS = sorted(REF_CONFIGS)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else
            torch.from_numpy(np.array(v, np.float32)) for k, v in tree.items()}


def _configs(arch, f32: bool):
    rc = REF_CONFIGS[arch].make_config(smoke=True)
    pc = registry.get(arch).make_config(smoke=True)
    if f32:
        rc = dataclasses.replace(rc, compute_dtype=jnp.float32)
        pc = dataclasses.replace(pc, compute_dtype=torch.float32)
    return rc, pc


def _port_moe(rcfg) -> moe.MoEConfig:
    return moe.MoEConfig(**dataclasses.asdict(rcfg))


class _RefRouting:
    """Stands in for ``jax`` inside the reference's ``models/moe.py`` and
    records each ``moe_apply`` call's router probabilities and choices (the
    arguments and indices of its ``lax.top_k``) and the slot each choice
    claimed (the array it one-hots over the capacity; the expert one-hot
    is int32), one (G, T_g) array a slot in priority order. The arrays
    reach the host through ordered ``jax.debug.callback``s, so calls
    inside the reference's ``scan`` over layers are recorded in order."""

    def __init__(self):
        self.calls = []
        calls = self.calls

        def new_call(probs, idx):
            calls.append({"probs": np.asarray(probs), "idx": np.asarray(idx),
                          "pos": []})

        def slot(pos):
            calls[-1]["pos"].append(np.asarray(pos))

        class _Lax:
            def __getattr__(self, name):
                return getattr(jax.lax, name)

            def top_k(self, x, k):
                vals, idx = jax.lax.top_k(x, k)
                jax.debug.callback(new_call, x, idx, ordered=True)
                return vals, idx

        class _NN:
            def __getattr__(self, name):
                return getattr(jax.nn, name)

            def one_hot(self, x, n, dtype=jnp.float32, **kw):
                if jnp.dtype(dtype) != jnp.int32:
                    jax.debug.callback(slot, x, ordered=True)
                return jax.nn.one_hot(x, n, dtype=dtype, **kw)

        self.lax, self.nn = _Lax(), _NN()

    def __getattr__(self, name):
        return getattr(jax, name)

    def slots(self, i: int, k: int) -> np.ndarray:
        """Call ``i``'s slots (G, T_g, K) (its last f32 one-hot is the aux
        loss's, of the first choices)."""
        return np.stack(self.calls[i]["pos"][:k], axis=-1)


def _port_routing(monkeypatch):
    """Records every ``moe.route`` result of the port (one a layer)."""
    seen = []
    orig = moe.route

    def spy(*a):
        seen.append(orig(*a))
        return seen[-1]

    monkeypatch.setattr(moe, "route", spy)
    return seen


# the largest gap between a token's k-th and (k+1)-th router probability
# (or between two of its first k) at which bf16 compute may route it
# otherwise than the reference: the router is f32 on both sides, but its
# bf16 input differs by bf16 roundings in another order upstream (the
# attention), which moves a probability by up to ~3e-3 at the smoke widths
NEAR_TIE = 1e-2


def _first_flips(ref: "_RefRouting", port, k: int) -> np.ndarray:
    """Tokens (flattened, in the groups' row-major order) whose choices
    differ between the two sides in some layer, checking that each first
    differs at a near-tie of the reference's probabilities: a choice that
    differs there is bf16 noise, not a routing fault. Returns the
    (layers, tokens) mask of tokens routed otherwise in an earlier layer
    or this one."""
    assert len(ref.calls) == len(port)
    masks, earlier = [], None
    for call, r in zip(ref.calls, port):
        want, got = call["idx"].reshape(-1, k), r.idx.numpy().reshape(-1, k)
        flip = (want != got).any(-1)
        srt = -np.sort(-call["probs"].reshape(want.shape[0], -1), axis=-1)
        gap = (srt[:, :k] - srt[:, 1:k + 1]).min(-1)
        new = flip if earlier is None else flip & ~earlier
        assert (gap[new] < NEAR_TIE).all(), gap[new]
        earlier = flip if earlier is None else flip | earlier
        masks.append(earlier.copy())
    return np.stack(masks)


def _moe_pair(monkeypatch, rcfg, params, x, glu, jdt, tdt):
    """Both sides' ``moe_apply`` on the same numpy ``x`` and parameters:
    (reference y, aux, slots (G, T_g, K)), (port y, aux, Routing)."""
    spy = _RefRouting()
    monkeypatch.setattr(ref_moe, "jax", spy)
    want_y, want_aux = jax.jit(ref_moe.moe_apply, static_argnums=range(
        2, 7))(params, jnp.asarray(x), rcfg, "silu", glu, RULES, jdt)
    jax.effects_barrier()
    monkeypatch.undo()
    seen = _port_routing(monkeypatch)
    got_y, got_aux = moe.moe_apply(_torch_tree(params), torch.from_numpy(x),
                                   _port_moe(rcfg), "silu", glu, tdt)
    monkeypatch.undo()
    return ((want_y, want_aux, spy.slots(0, rcfg.top_k)),
            (got_y, got_aux, seen[0]))


# ---------------------------------------------------------------------------
# (a) moe_apply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(monkeypatch, arch, f32):
    rc = REF_CONFIGS[arch].make_config(smoke=True)
    params = ref_moe.moe_init(jax.random.PRNGKey(1), rc.d_model, rc.d_ff,
                              rc.moe, rc.glu)
    x = np.random.default_rng(0).standard_normal(
        (2, 48, rc.d_model)).astype(np.float32)          # 3 groups of 32
    jdt, tdt = (jnp.float32, torch.float32) if f32 else (jnp.bfloat16,
                                                         torch.bfloat16)
    (want_y, want_aux, want_pos), (got_y, got_aux, r) = _moe_pair(
        monkeypatch, rc.moe, params, x, rc.glu, jdt, tdt)
    assert got_y.shape == x.shape and got_y.dtype == torch.float32
    np.testing.assert_array_equal(r.pos.numpy(), want_pos)
    tol = dict(rtol=1e-5, atol=1e-5) if f32 else dict(rtol=2e-2, atol=2e-1)
    np.testing.assert_allclose(_np(got_y), _np(want_y), **tol)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_overflow_drops_the_same_choices(monkeypatch, arch):
    """A router skewed toward expert 0 on tokens that share a direction:
    more first choices want expert 0 than its capacity holds. Both sides
    give every choice the same slot, so the same choices are dropped, and
    a token whose every choice is dropped comes out as 0 (the residual
    stream carries it)."""
    rc = REF_CONFIGS[arch].make_config(smoke=True)
    rng = np.random.default_rng(2)
    params = jax.tree.map(np.asarray, ref_moe.moe_init(
        jax.random.PRNGKey(2), rc.d_model, rc.d_ff, rc.moe, rc.glu))
    u = rng.standard_normal(rc.d_model).astype(np.float32)
    u /= np.linalg.norm(u)
    router = np.array(params["router"])
    router[:, 0] += 2.0 * u
    params = dict(params, router=router)
    x = (3.0 * u + 0.5 * rng.standard_normal((64, rc.d_model))).astype(
        np.float32)                                         # 2 groups of 32
    (want_y, want_aux, want_pos), (got_y, got_aux, r) = _moe_pair(
        monkeypatch, rc.moe, params, x, rc.glu, jnp.float32, torch.float32)
    cap = r.capacity
    assert cap == ref_moe._capacity(32, rc.moe)
    np.testing.assert_array_equal(r.pos.numpy(), want_pos)
    dropped = ~r.keep.numpy()
    assert dropped[..., 0].sum() > 0, "the case must overflow expert 0"
    assert (r.idx.numpy()[..., 0][dropped[..., 0]] == 0).all()
    none_kept = dropped.all(-1).reshape(-1)
    assert none_kept.any() == (rc.moe.top_k == 1)
    np.testing.assert_array_equal(_np(got_y)[none_kept], 0.0)
    np.testing.assert_array_equal(_np(want_y)[none_kept], 0.0)
    np.testing.assert_allclose(_np(got_y), _np(want_y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6,
                               atol=1e-6)


def test_capacity_matches_reference():
    for e, k, cf in ((4, 2, 1.25), (8, 1, 1.25), (8, 2, 1.0), (128, 1, 1.25),
                     (3, 2, 2.0), (16, 4, 0.5)):
        rcfg = ref_moe.MoEConfig(n_experts=e, top_k=k, capacity_factor=cf)
        for tg in (1, 3, 4, 5, 31, 32, 100, 128, 256, 1024, 4097):
            got = moe._capacity(tg, _port_moe(rcfg))
            assert got == ref_moe._capacity(tg, rcfg), (e, k, cf, tg)
            assert got >= 4 and got % 4 == 0


def test_token_count_off_the_group_raises():
    rc = ref_grok.make_config(smoke=True)
    params = ref_moe.moe_init(jax.random.PRNGKey(0), rc.d_model, rc.d_ff,
                              rc.moe, rc.glu)
    x = np.zeros((40, rc.d_model), np.float32)       # 40 % 32 != 0
    with pytest.raises(AssertionError, match="not divisible"):
        ref_moe.moe_apply(params, jnp.asarray(x), rc.moe, "silu", True, RULES)
    with pytest.raises(ValueError, match="not divisible by group 32"):
        moe.moe_apply(_torch_tree(params), torch.from_numpy(x),
                      _port_moe(rc.moe), "silu", True)
    y, _ = moe.moe_apply(_torch_tree(params), torch.from_numpy(x[:24]),
                         _port_moe(rc.moe), "silu", True)   # one group of 24
    assert y.shape == (24, rc.d_model)


# ---------------------------------------------------------------------------
# (b) prefill, decode and generate of the MoE smoke configs
# ---------------------------------------------------------------------------

def _close(got, want, f32: bool, cache: bool = False):
    if f32:
        rtol, atol = (1e-4, 1e-4) if cache else (2.0 ** -6, 1e-5)
    else:
        rtol, atol = 2e-2, 2e-1
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


_REF_PARAMS = {}


def _ref_init(rc):
    """The reference's ``init(PRNGKey(0), rc)``, drawn once per parameter
    layout (the compute type does not enter it; each draw compiles)."""
    key = (rc.name, rc.remat_block, jnp.dtype(rc.param_dtype).name)
    if key not in _REF_PARAMS:
        _REF_PARAMS[key] = ref_tfm.init(jax.random.PRNGKey(0), rc)
    return _REF_PARAMS[key]


def _carried(rc, pc):
    params = _ref_init(rc)
    return params, convert.transformer_params(
        jax.tree.map(np.asarray, params), pc, device="cpu")


def _both(monkeypatch, ref_call, port_call, k: int):
    """``ref_call()`` and ``port_call()``, the routing of each recorded:
    (ref out, port out, the (layers, tokens) mask of ``_first_flips``)."""
    spy = _RefRouting()
    monkeypatch.setattr(ref_moe, "jax", spy)
    want = jax.block_until_ready(ref_call())
    jax.effects_barrier()
    monkeypatch.undo()
    seen = _port_routing(monkeypatch)
    got = port_call()
    monkeypatch.undo()
    return want, got, _first_flips(spy, seen, k)


def _close_caches(got_c, want_c, moved, f32):
    """Layer l's keys and values on the tokens routed alike in layers
    before l (layer 0's come before any MoE layer): ``moved`` (L, B, S)."""
    for kk in ("k", "v"):
        got, want = _np(got_c[kk]), _np(want_c[kk])
        for layer in range(got.shape[0]):
            keep = (np.ones(moved.shape[1:], bool) if layer == 0
                    else ~moved[layer - 1])
            _close(got[layer][keep], want[layer][keep], f32, cache=True)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(monkeypatch, arch, f32):
    """A prompt of 2 x 32 tokens (2 groups of 32, in (batch, position)
    order), then one decode step (its 2 tokens one group). In f32 every
    token is routed as the reference routes it. In bf16 a token may be
    routed otherwise at a near-tie of its router probabilities
    (``NEAR_TIE``); its hidden state then differs, so later layers' caches
    are compared on the other tokens, and the logits on the rows whose
    last token was routed alike."""
    rc, pc = _configs(arch, f32)
    params, tp = _carried(rc, pc)
    k, s0 = rc.moe.top_k, 32
    tokens = np.random.default_rng(6).integers(0, rc.vocab, (2, s0 + 1)) \
        .astype(np.int32)
    (want_l, want_c), (got_l, got_c), flips = _both(
        monkeypatch,
        lambda: jax.jit(ref_tfm.prefill_step, static_argnums=(2, 3))(
            params, jnp.asarray(tokens[:, :s0]), rc, RULES),
        lambda: tfm.prefill_step(tp, torch.from_numpy(tokens[:, :s0]), pc),
        k)
    assert got_l.dtype == torch.float32 and got_l.shape == (2, rc.vocab)
    assert not (f32 and flips.any())
    moved = flips.reshape(len(flips), 2, s0)
    _close_caches(got_c, want_c, moved, f32)
    rows = ~moved[-1, :, -1]
    _close(got_l[rows], _np(want_l)[rows], f32)

    rfull = ref_tfm.init_cache(rc, 2, s0 + 4, dtype=want_c["k"].dtype)
    rfull = {kk: rfull[kk].at[:, :, :s0].set(want_c[kk]) for kk in ("k", "v")}
    pfull = {kk: torch.from_numpy(np.array(rfull[kk], np.float32)).to(
        pc.compute_dtype) for kk in ("k", "v")}
    (want_l, want_c), (got_l, got_c), flips = _both(
        monkeypatch,
        lambda: jax.jit(ref_tfm.decode_step, static_argnums=(4, 5))(
            params, rfull, jnp.asarray(tokens[:, s0]),
            jnp.asarray(s0, jnp.int32), rc, RULES),
        lambda: tfm.decode_step(tp, pfull, torch.from_numpy(tokens[:, s0]),
                                s0, pc),
        k)
    assert not (f32 and flips.any())
    moved = np.zeros((len(flips), 2, s0 + 4), bool)
    moved[:, :, s0] = flips
    _close_caches(got_c, want_c, moved, f32)
    rows = ~flips[-1]
    _close(got_l[rows], _np(want_l)[rows], f32)


class _ArgmaxSpy:
    """Stands in for ``jax.numpy`` inside the reference's
    ``serve/decode.py`` and records the logits each ``argmax`` is given:
    the prefill's, then each decode step's."""

    def __init__(self):
        self.seen = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def argmax(self, x, *a, **k):
        self.seen.append(np.asarray(x))
        return jnp.argmax(x, *a, **k)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_matches_reference(monkeypatch, arch):
    """f32 compute: the same greedy tokens, step by step, up to a step
    where the reference's best logits tie within the logits' tolerance
    (the LM head is rounded to bf16, so exact ties occur, and the
    reference's jitted step and its eager one may break them apart):
    there the port's pick must be one of the tied tokens, and that row's
    continuations may part."""
    rc, pc = _configs(arch, f32=True)
    params, tp = _carried(rc, pc)
    s0 = 16
    prompt = np.random.default_rng(7).integers(0, rc.vocab, (2, s0)).astype(
        np.int32)
    spy = _ArgmaxSpy()
    monkeypatch.setattr(ref_decode, "jnp", spy)
    want = np.asarray(ref_decode.generate(params, jnp.asarray(prompt), 6, rc))
    monkeypatch.undo()
    got = decode.generate(tp, torch.from_numpy(prompt), 6, pc, device="cpu")
    assert got.dtype == torch.int32 and got.shape == want.shape
    got = got.numpy()
    np.testing.assert_array_equal(got[:, :s0], prompt)
    parted = np.zeros(2, bool)
    for step, logits in enumerate(spy.seen):   # the prefill's, then steps'
        col = s0 + step
        top = logits.max(-1)
        slack = 2 * (1e-5 + 2.0 ** -6 * np.abs(top))
        tied = (logits >= (top - slack)[:, None]).sum(-1) > 1
        picked = logits[np.arange(2), got[:, col]]
        same = got[:, col] == want[:, col]
        assert (parted | same | (tied & (picked >= top - slack))).all(), step
        parted |= ~same
    assert not parted.all()


@pytest.mark.parametrize("arch", ARCHS)
def test_blocked_layout_params_carry_across(arch):
    """The reference's blocked layout, (n_blocks, block, E, D, F) for an
    expert leaf (its ``init`` reshapes the flat draw so; the shapes are
    checked against ``init``'s own), comes across flattened to (L, E, D,
    F), bit for bit the flat tree, which serves the reference's logits
    (``test_prefill_and_decode_match_reference``)."""
    rc, pc = _configs(arch, f32=True)
    rc = dataclasses.replace(rc, remat_block=1)
    assert ref_tfm.blocked_layout(rc)
    flat = _ref_init(dataclasses.replace(rc, remat_block=0))
    blocked = dict(flat, layers=jax.tree.map(
        lambda a: a.reshape((2, 1) + a.shape[1:]), flat["layers"]))
    shapes = jax.eval_shape(lambda: ref_tfm.init(jax.random.PRNGKey(0), rc))
    assert jax.tree.map(np.shape, blocked) == jax.tree.map(
        lambda t: t.shape, shapes)
    assert blocked["layers"]["moe"]["w_up"].ndim == 5
    tb = convert.transformer_params(jax.tree.map(np.asarray, blocked), pc,
                                    device="cpu")
    tf = convert.transformer_params(jax.tree.map(np.asarray, flat), pc,
                                    device="cpu")
    e = rc.moe.n_experts
    assert tb["layers"]["moe"]["w_up"].shape == (2, e, 64, 128)
    assert tb["layers"]["moe"]["w_down"].shape == (2, e, 128, 64)
    assert jax.tree.structure(tb) == jax.tree.structure(tf)
    for x, y in zip(jax.tree.leaves(tb), jax.tree.leaves(tf)):
        assert torch.equal(x, y)


def test_bf16_expert_leaves_cross_exactly():
    rc = ref_grok.make_config(smoke=True)
    pc = registry.get("grok-1-314b").make_config(smoke=True)
    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                          _ref_init(rc))
    tp = convert.transformer_params(jax.tree.map(np.asarray, params), pc,
                                    device="cpu")
    assert set(tp["layers"]["moe"]) == {"router", "w_up", "w_gate", "w_down"}
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(params)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.to(torch.float32).numpy(),
                                      np.asarray(b, np.float32))


def test_prefill_matches_own_decode_chain():
    """ROADMAP C2: the reference's ``test_lm_decode_matches_prefill`` for
    grok-1 (bf16, 2 x 12 tokens: one prefill group of 24, then 12 decode
    steps of one group of 2) on the port, with the reference's
    tolerance."""
    rc, pc = _configs("grok-1-314b", f32=False)
    _, tp = _carried(rc, pc)
    tokens = torch.from_numpy(np.array(jax.random.randint(
        jax.random.PRNGKey(1), (2, 12), 0, rc.vocab)))
    logits_p, cache = tfm.prefill_step(tp, tokens, pc)
    cache_d = tfm.init_cache(pc, 2, 12, device="cpu")
    for t in range(12):
        logits_d, cache_d = tfm.decode_step(tp, cache_d, tokens[:, t], t, pc)
    np.testing.assert_allclose(_np(logits_p), _np(logits_d), rtol=2e-2,
                               atol=2e-1)


# ---------------------------------------------------------------------------
# (c) parameters and configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_follows_the_reference(arch):
    rc = REF_CONFIGS[arch].make_config(smoke=True)
    cfg = registry.get(arch).make_config(smoke=True)
    p = tfm.init(cfg, seed=3, device="cpu")
    want = jax.tree.map(np.shape, _ref_init(rc))
    got = jax.tree.map(lambda t: tuple(t.shape), p)
    assert got == jax.tree.map(tuple, want, is_leaf=lambda x: isinstance(
        x, tuple))
    lay = p["layers"]
    assert "w_up" not in lay and "w_gate" not in lay
    scales = {"router": cfg.d_model ** -0.5, "w_up": cfg.d_model ** -0.5,
              "w_gate": cfg.d_model ** -0.5, "w_down": cfg.d_ff ** -0.5}
    for name, scale in scales.items():
        assert abs(float(lay["moe"][name].std()) / scale - 1) < 0.05, name
    one = moe.moe_init(cfg.d_model, cfg.d_ff, cfg.moe, cfg.glu,
                       torch.float32, torch.Generator().manual_seed(0),
                       device="cpu")
    ref_one = ref_moe.moe_init(jax.random.PRNGKey(0), rc.d_model, rc.d_ff,
                               rc.moe, rc.glu)
    assert {k: tuple(v.shape) for k, v in one.items()} == \
        {k: tuple(v.shape) for k, v in ref_one.items()}
    assert torch.equal(tfm.init(cfg, seed=3, device="cpu")["layers"]["moe"][
        "w_up"], lay["moe"]["w_up"])


def test_full_configs_match_reference():
    """The port's copies hold the reference's numbers, in torch dtypes."""
    for arch in ARCHS:
        ref_mod, mod = REF_CONFIGS[arch], registry.get(arch)
        for smoke in (True, False):
            rc = ref_mod.make_config(smoke=smoke)
            pc = mod.make_config(smoke=smoke)
            for f in dataclasses.fields(pc):
                want, got = getattr(rc, f.name), getattr(pc, f.name)
                if f.name.endswith("_dtype"):
                    assert str(got).split(".")[-1] == jnp.dtype(want).name
                elif f.name == "moe":
                    assert dataclasses.asdict(got) == dataclasses.asdict(want)
                else:
                    assert got == want, (arch, smoke, f.name)
        for name in ("ARCH_ID", "FAMILY", "SHAPES", "SKIPS"):
            assert getattr(mod, name) == getattr(ref_mod, name), (arch, name)
    assert lm_common.FULL_ATTN_LONG_SKIP == ref_lm_common.FULL_ATTN_LONG_SKIP
