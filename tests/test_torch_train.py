"""The port's training substrate against the JAX reference.

Same numpy inputs through both sides: the optimizers (AdamW, Adafactor
with and without momentum, f32 and bf16 leaves, at step 1 and from a
state carried across by ``convert`` at step 3), ``cosine_warmup_lr`` and
``global_norm``; ``chunked_attention`` (value and gradients); the LM's
``train_loss`` (value and gradients) on the dense smoke configs and on
grok-1's MoE; ``make_train_step`` at accumulation 1 and 4; the remat
policies and the hierarchical remat against the reference's blocked tree;
a checkpoint restart (bit for bit on the CPU); the int8 codes and the
error feedback. The recommenders' losses, the step bundles and the
driver are in ``tests/test_torch_train_launch.py``.

Tolerances (each comparison names its own):

* optimizer results: f32 leaves within 2e-6 relative (+1e-9 absolute:
  the same f32 arithmetic, XLA free to fuse it into other roundings); bf16
  leaves within one bf16 step (2^-7 relative) of the reference, since an
  f32 value one ulp apart can round to the neighbouring bf16;
* f32 compute: a loss within 1e-5 relative, each gradient leaf within
  1e-3 of its norm (the LM head is a bf16 x bf16 product in both, whose
  bf16 rounding of a logit may land one step apart, 2^-8 of the logit:
  measured 1.4e-6 and 2.1e-4);
* bf16 compute: a loss within 2e-3 relative, each gradient leaf within
  4e-2 of its norm (bf16 roundings in another order through two layers:
  measured up to 1.6e-2); the reference's own bf16 LM tolerance is rtol
  2e-2 on logits;
* attention: f32 2e-5 of the output's and each gradient's largest value.
"""
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import grok1_314b as ref_grok
from repro.configs import h2o_danube3_4b as ref_danube
from repro.configs import nemotron4_15b as ref_nemotron
from repro.configs import qwen2_72b as ref_qwen
from repro.models import attention as ref_attention
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tfm
from repro.models.sharding import MeshRules
from repro.train import grad_compress as ref_gc
from repro.train import optimizer as ref_opt
from repro.train import trainstep as ref_trainstep
from repro_torch import convert, tree
from repro_torch.configs import registry
from repro_torch.models import attention, moe
from repro_torch.models import transformer as tfm
from repro_torch.train import checkpoint, data, grad_compress, optimizer
from repro_torch.train.trainstep import make_train_step, value_and_grad

RULES = MeshRules(dp=(), fsdp=(), tp=None, ep=None)
LM_REF = {m.ARCH_ID: m for m in (ref_danube, ref_qwen, ref_nemotron,
                                 ref_grok)}



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


def _port(tree_):
    """A reference tree (dicts and lists, jax or numpy leaves) as tensors
    of the same types."""
    if isinstance(tree_, dict):
        return {k: _port(v) for k, v in tree_.items()}
    if isinstance(tree_, (list, tuple)):
        return [_port(v) for v in tree_]
    return convert._leaf(np.asarray(tree_), "cpu")


def _pairs(got, want):
    """(path, port leaf, reference leaf) over both trees in the port's
    order (sorted dict keys, as ``jax.tree`` orders them)."""
    paths, leaves, _ = tree.flatten_with_paths(got)
    ref = jax.tree.leaves(want)
    assert len(ref) == len(leaves)
    return zip(paths, leaves, ref)


def _close_leaf(path, got, want, dtype_step=None, rel=2e-6):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, path
    if dtype_step is not None:              # bf16: one step of 2^-7
        tol = dtype_step * np.abs(w) + 1e-30
    else:
        tol = rel * np.abs(w) + 1e-9
    assert np.all(np.abs(g - w) <= tol), (path, float(np.abs(g - w).max()))


def _close_grads(got, want, rel):
    """Each gradient leaf within ``rel`` of its norm."""
    for path, g, w in _pairs(got, want):
        g, w = _np(g), _np(w)
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= rel, (path, err)


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------

def _opt_tree(rng, dtype):
    """A factored leaf, a stacked (3-axis) factored leaf and a vector."""
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "stack": rng.standard_normal((3, 4, 5)).astype(np.float32),
            "v": rng.standard_normal((7,)).astype(np.float32)}, dtype


def _as(tree_, dtype):
    if dtype == "bf16":
        return jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), tree_)
    return jax.tree.map(jnp.asarray, tree_)


def _run_both(ref_update, port_update, ref_state, port_state, params, steps,
              rng, scale, lr):
    """``steps`` updates on both sides from the same gradients; returns the
    final (reference params, state), (port params, state), grad norms."""
    dtype = jax.tree.leaves(params)[0].dtype
    tp = _port(params)
    norms = []
    for _ in range(steps):
        grads = jax.tree.map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape) * scale,
                                  dtype), params)
        params, ref_state, n_ref = ref_update(grads, ref_state, params,
                                              jnp.float32(lr))
        tp, port_state, n_port = port_update(_port(grads), port_state, tp,
                                             torch.tensor(lr))
        norms.append((float(n_ref), float(n_port)))
    return (params, ref_state), (tp, port_state), norms


@pytest.mark.parametrize("dtype,start,clip", [
    ("f32", "init", True), ("f32", "carried", False),
    ("bf16", "init", False), ("bf16", "carried", True)])
def test_adamw_update_matches_reference(dtype, start, clip, monkeypatch):
    """From a fresh state (step 1) or from the reference's state after two
    steps carried across (step 3); gradients above the clip norm or below
    it; stacked leaves cut into slices (``SLICE_ELEMENTS`` lowered)."""
    monkeypatch.setattr(optimizer, "SLICE_ELEMENTS", 8)
    rng = np.random.default_rng(1)
    raw, _ = _opt_tree(rng, dtype)
    params = _as(raw, dtype)
    cfg_r = ref_opt.AdamWConfig(lr=1e-2)
    cfg_p = optimizer.AdamWConfig(lr=1e-2)
    ref_update = jax.jit(lambda g, s, p, lr: ref_opt.adamw_update(
        g, s, p, cfg_r, lr))
    scale = 1.0 if clip else 1e-3
    state = ref_opt.adamw_init(params)
    if start == "carried":
        (params, state), _, _ = _run_both(
            ref_update, lambda *a: (a[2], a[1], torch.zeros(())), state,
            None, params, 2, rng, scale, 1e-2)
    port_state = convert.adamw_state(jax.tree.map(np.asarray, state),
                                     device="cpu")
    (want_p, want_s), (got_p, got_s), norms = _run_both(
        ref_update, lambda g, s, p, lr: optimizer.adamw_update(
            g, s, p, cfg_p, lr), state, port_state, params, 1, rng, scale,
        1e-2)
    assert int(got_s.step) == int(want_s.step) == (3 if start == "carried"
                                                   else 1)
    step = 2.0 ** -7 if dtype == "bf16" else None
    for path, g, w in _pairs(got_p, want_p):
        _close_leaf(path, g, w, step)
    for got, want in ((got_s.mu, want_s.mu), (got_s.nu, want_s.nu)):
        for path, g, w in _pairs(got, want):
            _close_leaf(path, g, w)
    for n_ref, n_port in norms:
        assert abs(n_ref - n_port) <= 2e-6 * n_ref


@pytest.mark.parametrize("dtype,momentum,start", [
    ("f32", None, "init"), ("f32", 0.9, "carried"),
    ("bf16", None, "carried"), ("bf16", 0.9, "init")])
def test_adafactor_update_matches_reference(dtype, momentum, start,
                                            monkeypatch):
    """Factored (2- and 3-axis) and vector leaves, with and without bf16
    momentum, at step 1 and from a carried state at step 3; the stacked
    leaf cut into slices, its RMS clip over the whole leaf."""
    monkeypatch.setattr(optimizer, "SLICE_ELEMENTS", 8)
    rng = np.random.default_rng(2)
    raw, _ = _opt_tree(rng, dtype)
    params = _as(raw, dtype)
    cfg_r = ref_opt.AdafactorConfig(lr=1e-2, momentum=momentum,
                                    weight_decay=0.01)
    cfg_p = optimizer.AdafactorConfig(lr=1e-2, momentum=momentum,
                                      weight_decay=0.01)
    ref_update = jax.jit(lambda g, s, p, lr: ref_opt.adafactor_update(
        g, s, p, cfg_r, lr))
    state = ref_opt.adafactor_init(params, cfg_r)
    if start == "carried":
        (params, state), _, _ = _run_both(
            ref_update, lambda *a: (a[2], a[1], torch.zeros(())), state,
            None, params, 2, rng, 1.0, 1e-2)
    port_state = convert.adafactor_state(jax.tree.map(np.asarray, state),
                                         device="cpu")
    (want_p, want_s), (got_p, got_s), _ = _run_both(
        ref_update, lambda g, s, p, lr: optimizer.adafactor_update(
            g, s, p, cfg_p, lr), state, port_state, params, 1, rng, 1.0,
        1e-2)
    step = 2.0 ** -7 if dtype == "bf16" else None
    for path, g, w in _pairs(got_p, want_p):
        _close_leaf(path, g, w, step, rel=1e-5)
    for got, want in ((got_s.vr, want_s.vr), (got_s.vc, want_s.vc)):
        for path, g, w in _pairs(got, want):
            _close_leaf(path, g, w, rel=1e-5)
    if momentum is not None:
        for path, g, w in _pairs(got_s.mu, want_s.mu):
            assert g.dtype == torch.bfloat16
            _close_leaf(path, g, w, 2.0 ** -7)
    assert got_s.vr["stack"].shape == (3, 4)     # factored: O(m + n)


def test_lr_schedule_and_global_norm_match_reference():
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        want = float(ref_opt.cosine_warmup_lr(jnp.asarray(step), 1e-3, 10,
                                              100))
        got = float(optimizer.cosine_warmup_lr(torch.tensor(step), 1e-3, 10,
                                               100))
        assert abs(got - want) <= 1e-6 * abs(want) + 1e-12, step
    assert float(optimizer.cosine_warmup_lr(torch.tensor(0), 1.0, 10,
                                            100)) == 0.0
    rng = np.random.default_rng(3)
    raw, _ = _opt_tree(rng, "f32")
    want = float(ref_opt.global_norm(_as(raw, "bf16")))
    got = float(optimizer.global_norm(_port(_as(raw, "bf16"))))
    assert abs(got - want) <= 1e-6 * want


# ---------------------------------------------------------------------------
# chunked_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,kv,s,dh,qc,window", [
    (1, 8, 2, 48, 16, 16, None),      # GQA group 4
    (2, 4, 2, 40, 8, 16, 12),         # GQA 2, a window, a short last chunk
])
def test_chunked_attention_value_and_grads(b, h, kv, s, dh, qc, window):
    rng = np.random.default_rng(4)
    q, k, v, ct = (rng.standard_normal(shape).astype(np.float32) for shape in
                   ((b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh),
                    (b, s, h, dh)))
    out, vjp = jax.vjp(lambda q_, k_, v_: ref_attention.chunked_attention(
        q_, k_, v_, True, window, qc), *(jnp.asarray(x) for x in (q, k, v)))
    want = (out,) + vjp(jnp.asarray(ct))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got_out = attention.chunked_attention(tq, tk, tv, True, window, qc)
    got = (got_out,) + torch.autograd.grad(got_out, (tq, tk, tv),
                                           torch.from_numpy(ct))
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        g, w = _np(g), _np(w)
        assert np.abs(g - w).max() <= 2e-5 * np.abs(w).max(), name


# ---------------------------------------------------------------------------
# The LM loss
# ---------------------------------------------------------------------------

_REF_LOSS = {}
def _ref_init(rc, pc):
    """Parameters for both sides: the port's ``init`` (the reference's
    shapes and scales) as the reference's tree of jax arrays, in the
    reference's blocked (n_blocks, block, ...) layout where its config
    asks for it. The reference's own ``init`` draws other numbers and
    takes seconds eagerly; parity needs only equal inputs."""
    tp = tfm.init(pc, seed=0, device="cpu")
    tp = tfm.blocked_view(tp, pc)
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)


def _ref_value_and_grad(rc):
    key = (rc.name, jnp.dtype(rc.compute_dtype).name, rc.remat_block,
           rc.n_layers)
    if key not in _REF_LOSS:
        _REF_LOSS[key] = jax.jit(jax.value_and_grad(
            lambda p, b: ref_tfm.train_loss(p, b, rc, RULES)))
    return _REF_LOSS[key]


def _lm_case(arch, f32, seq=32, batch=2):
    rc = LM_REF[arch].make_config(smoke=True)
    pc = registry.get(arch).make_config(smoke=True)
    if f32:
        rc = dataclasses.replace(rc, compute_dtype=jnp.float32)
        pc = dataclasses.replace(pc, compute_dtype=torch.float32)
    params = _ref_init(rc, pc)
    toks = np.random.default_rng(0).integers(0, rc.vocab,
                                                (batch, seq + 1)).astype(
        np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return rc, pc, params, b


def _both_losses(rc, pc, params, b, flat_layers=True):
    want_l, want_g = _ref_value_and_grad(rc)(
        params, {k: jnp.asarray(v) for k, v in b.items()})
    tp = convert.transformer_params(jax.tree.map(np.asarray, params), pc,
                                    device="cpu") if flat_layers \
        else _port(params)
    got_l, got_g = value_and_grad(lambda p, bt: tfm.train_loss(p, bt, pc),
                                  tp, {k: torch.from_numpy(v)
                                       for k, v in b.items()})
    return (float(want_l), want_g), (float(got_l), got_g)


@pytest.mark.parametrize("arch,f32", [
    ("h2o-danube-3-4b", True), ("h2o-danube-3-4b", False),
    ("qwen2-72b", True), ("nemotron-4-15b", True)],
    ids=["danube-f32", "danube-bf16", "qwen2-f32", "nemotron-f32"])
def test_train_loss_and_grads_match_reference(arch, f32):
    """danube (SWA 16 over 32 positions: the window masks), qwen2 (QKV
    bias), nemotron (squared ReLU, no GLU): the loss and every parameter's
    gradient on the reference's own parameters, in f32 compute and in the
    smoke config's own bf16."""
    rc, pc, params, b = _lm_case(arch, f32)
    (want_l, want_g), (got_l, got_g) = _both_losses(rc, pc, params, b)
    assert abs(got_l - want_l) <= (1e-5 if f32 else 2e-3) * want_l
    want_g = jax.tree.map(np.asarray, want_g)
    _close_grads(got_g, want_g, 1e-3 if f32 else 4e-2)


class _RefTopK:
    """Stands in for ``jax`` inside the reference's ``models/moe.py`` and
    records each ``lax.top_k`` of its router (probabilities and choices)
    through ordered ``jax.debug.callback``s, one call a layer."""

    def __init__(self):
        self.calls = []
        calls = self.calls

        class _Lax:
            def __getattr__(self, name):
                return getattr(jax.lax, name)

            def top_k(self, x, k):
                vals, idx = jax.lax.top_k(x, k)
                jax.debug.callback(lambda p, i: calls.append(
                    (np.asarray(p), np.asarray(i))), x, idx, ordered=True)
                return vals, idx

        self.lax = _Lax()

    def __getattr__(self, name):
        return getattr(jax, name)


def _routed_alike(spy, pc, params, b, monkeypatch):
    """The reference's router choices (``spy``: its forward's, the first
    ``n_layers`` calls; the backward's recomputation records more) against
    the port's forward's, layer by layer: asserts that every choice that
    differs is at a near-tie of the reference's probabilities
    (``tests/test_torch_moe.py``'s ``NEAR_TIE`` = 1e-2, bf16 noise upstream
    of the f32 router) and returns whether every token routed alike."""
    seen, orig = [], moe.route

    def port_route(*a):
        seen.append(orig(*a))
        return seen[-1]

    monkeypatch.setattr(moe, "route", port_route)
    with torch.no_grad():
        tfm.train_loss(convert.transformer_params(
            jax.tree.map(np.asarray, params), pc, device="cpu"),
            {k: torch.from_numpy(v) for k, v in b.items()}, pc)
    monkeypatch.undo()
    assert len(seen) == pc.n_layers <= len(spy.calls)
    alike = True
    k = pc.moe.top_k
    for (probs, idx), r in zip(spy.calls, seen):
        flip = np.any(np.sort(idx, -1) != np.sort(r.idx.numpy(), -1), -1)
        if flip.any():
            alike = False
            top = -np.sort(-probs, -1)
            gap = np.min(np.abs(np.diff(top[..., :k + 1], axis=-1)), -1)
            assert (gap[flip] < 1e-2).all(), gap[flip]
    return alike


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_moe_train_loss_and_grads_match_reference(f32, monkeypatch):
    """grok-1 smoke (4 experts top-2, groups of 32): the loss and every
    gradient, the router's and the experts' included. In f32 every token
    routes as in the reference. In bf16 a token may route otherwise at a
    near-tie of its router probabilities (``tests/test_torch_moe.py``'s
    ``NEAR_TIE``): each choice that differs must be at one; where every
    token routed alike the loss and gradients are compared at the bf16
    tolerance, and where one did not only the loss, at the reference's
    own bf16 LM tolerance (rtol 2e-2)."""
    rc, pc, params, b = _lm_case("grok-1-314b", f32)
    spy = _RefTopK()
    if not f32:                 # traced with the spy (this case's compile)
        monkeypatch.setattr(ref_moe, "jax", spy)
    (want_l, want_g), (got_l, got_g) = _both_losses(rc, pc, params, b)
    jax.effects_barrier()
    monkeypatch.undo()
    # f32: the same routing (a differing choice would move the loss and
    # the router's gradient past their tolerances)
    alike = f32 or _routed_alike(spy, pc, params, b, monkeypatch)
    moe_g = got_g["layers"]["moe"]
    for name in ("router", "w_up", "w_gate", "w_down"):
        assert float(moe_g[name].abs().sum()) > 0, name
    if not alike:
        assert abs(got_l - want_l) <= 2e-2 * want_l
        return
    assert abs(got_l - want_l) <= (1e-5 if f32 else 2e-3) * want_l
    _close_grads(got_g, jax.tree.map(np.asarray, want_g),
                 1e-3 if f32 else 4e-2)


def test_moe_dispatch_grads_skip_dropped_choices():
    """``moe_apply``'s gradients on a skewed router that overflows the
    capacity: a token whose every choice was dropped gets no gradient
    through the experts, and the gradient equals a finite difference."""
    cfg = moe.MoEConfig(n_experts=2, top_k=1, group_size=16)
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_init(8, 16, cfg, True, torch.float64, gen, device="cpu")
    p["router"] = torch.zeros_like(p["router"])
    p["router"][:, 0] = 5.0                         # every token -> expert 0
    x = torch.randn(16, 8, generator=gen, dtype=torch.float64) + 1.0
    x.requires_grad_()
    y, aux = moe.moe_apply(p, x, cfg, "silu", True, torch.float64)
    r = moe.route(p["router"], x.detach()[None], cfg)
    dropped = ~r.keep[0, :, 0]
    assert bool(dropped.any()) and not bool(dropped.all())
    (gx,) = torch.autograd.grad(y.sum(), x)
    assert float(gx[dropped].abs().max()) == 0.0
    assert float(gx[~dropped].abs().min()) > 0.0
    assert torch.autograd.gradcheck(
        lambda w: moe.moe_apply({**p, "w_up": w}, x.detach(), cfg, "silu",
                                True, torch.float64)[0],
        (p["w_up"].clone().requires_grad_(),), eps=1e-6, atol=1e-5,
        fast_mode=True)


@pytest.mark.parametrize("policy", ["nothing", "dots", "none"])
def test_remat_policies_give_the_same_loss_and_grads(policy):
    """Each policy only decides what the backward recomputes: the loss and
    gradients are bit for bit the "none" run's, and the reference's
    within the f32 tolerance."""
    rc, pc, params, b = _lm_case("h2o-danube-3-4b", True)
    pc = dataclasses.replace(pc, remat_policy=policy)
    (want_l, want_g), (got_l, got_g) = _both_losses(rc, pc, params, b)
    tp = convert.transformer_params(jax.tree.map(np.asarray, params), pc,
                                    device="cpu")
    bt = {k: torch.from_numpy(v) for k, v in b.items()}
    base_l, base_g = value_and_grad(lambda p, x: tfm.train_loss(
        p, x, dataclasses.replace(pc, remat_policy="none")), tp, bt)
    assert got_l == float(base_l)
    for g, w in zip(tree.leaves(got_g), tree.leaves(base_g)):
        assert torch.equal(g, w)
    assert abs(got_l - want_l) <= 1e-5 * want_l
    _close_grads(got_g, jax.tree.map(np.asarray, want_g), 1e-3)
    with pytest.raises(ValueError, match="remat"):
        tfm.train_loss(tp, bt, dataclasses.replace(pc, remat_policy="all"))


def test_hierarchical_remat_matches_reference_blocked_tree():
    """``remat_block=2`` on 4 layers: the reference keeps its layers as
    (2, 2, ...) and checkpoints each block; the port's flat stacks, and
    ``blocked_view``'s (2, 2, ...) views of them, give the reference's loss
    and gradients (the blocked ones in the reference's shapes)."""
    rc, pc, _, b = _lm_case("h2o-danube-3-4b", True)
    over = dict(n_layers=4, remat_block=2, remat_policy="nothing")
    rc = dataclasses.replace(rc, **over)
    pc = dataclasses.replace(pc, **over)
    assert tfm.blocked_layout(pc)
    params = _ref_init(rc, pc)
    assert params["layers"]["wq"].shape[:2] == (2, 2)
    (want_l, want_g), (got_l, got_g) = _both_losses(rc, pc, params, b)
    assert abs(got_l - want_l) <= 1e-5 * want_l
    flat = jax.tree.map(np.asarray, want_g)
    flat["layers"] = jax.tree.map(
        lambda x: x.reshape((-1,) + x.shape[2:]), flat["layers"])
    _close_grads(got_g, flat, 1e-3)
    (_, _), (got_bl, got_bg) = _both_losses(rc, pc, params, b,
                                            flat_layers=False)
    assert got_bg["layers"]["wq"].shape == (2, 2) + tuple(
        got_g["layers"]["wq"].shape[1:])
    assert abs(got_bl - want_l) <= 1e-5 * want_l
    _close_grads(got_bg, jax.tree.map(np.asarray, want_g), 1e-3)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accum", [1, 4])
def test_train_step_matches_reference(accum):
    """One ``make_train_step`` step (AdamW, warm-up 2) on danube's smoke
    config at f32 compute, batch 4, accumulation 1 and 4: the loss, the
    grad norm, the lr and the new parameters and moments."""
    rc, pc, params, b = _lm_case("h2o-danube-3-4b", True, batch=4)
    cfg_r, cfg_p = ref_opt.AdamWConfig(lr=1e-2), optimizer.AdamWConfig(
        lr=1e-2)
    ref_step = jax.jit(ref_trainstep.make_train_step(
        lambda p, bt: ref_tfm.train_loss(p, bt, rc, RULES), cfg_r, warmup=2,
        total_steps=50, accum_steps=accum))
    state = ref_opt.adamw_init(params)
    rb = {k: jnp.asarray(v) for k, v in b.items()}
    params, state, _ = ref_step(params, state, rb)     # carried: step 1
    tp = convert.transformer_params(jax.tree.map(np.asarray, params), pc,
                                    device="cpu")
    paths, leaves, _ = tree.flatten_with_paths(tp)
    before = {k: v.clone() for k, v in zip(paths, leaves)}
    ts = convert.adamw_state(jax.tree.map(np.asarray, state), device="cpu")
    want_p, want_s, want_m = ref_step(params, state, rb)
    step = make_train_step(lambda p, bt: tfm.train_loss(p, bt, pc), cfg_p,
                           warmup=2, total_steps=50, accum_steps=accum)
    got_p, got_s, got_m = step(tp, ts, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
    assert got_p is tp and got_s is ts                 # consumed in place
    for key in ("loss", "grad_norm", "lr"):
        assert got_m[key].dtype == torch.float32 and got_m[key].ndim == 0
        assert abs(float(got_m[key]) - float(want_m[key])) <= \
            2e-4 * abs(float(want_m[key])), key
    # the moments (linear and quadratic in the gradients) against the
    # reference's; the parameters against AdamW applied to the port's own
    # moments. Adam moves an element by ~lr whatever its gradient's size,
    # so an element whose gradient nearly cancels would amplify the
    # gradients' 2e-4 of their norm into a share of lr: the update's
    # arithmetic is held against the reference on equal gradients in
    # test_adamw_update_matches_reference.
    _close_grads(got_s.mu, jax.tree.map(np.asarray, want_s.mu), 2e-3)
    _close_grads(got_s.nu, jax.tree.map(np.asarray, want_s.nu), 4e-3)
    lr, stepf = got_m["lr"], got_s.step.to(torch.float32)
    bc1, bc2 = 1.0 - torch.pow(0.9, stepf), 1.0 - torch.pow(0.95, stepf)
    for (path, g), m, v in zip(zip(*tree.flatten_with_paths(got_p)[:2]),
                               tree.leaves(got_s.mu), tree.leaves(got_s.nu)):
        old = before[path]
        upd = (m / bc1) / (torch.sqrt(v / bc2) + 1e-8) + 0.1 * old
        assert torch.equal(g, old - lr * upd), path


def test_bf16_accumulation_close_to_f32():
    """The reference's own check (``tests/test_train.py``): accumulating 4
    microbatches' gradients in bf16 keeps the grad norm within 5 %."""
    pc = registry.get("h2o-danube-3-4b").make_config(smoke=True)
    b = data.lm_batch(0, 0, 8, 32, pc.vocab, device="cpu")
    norms = []
    for dt in (torch.float32, torch.bfloat16):
        p = tfm.init(pc, seed=0, device="cpu")
        step = make_train_step(lambda q, bt: tfm.train_loss(q, bt, pc),
                               optimizer.AdamWConfig(lr=1e-3),
                               accum_steps=4, accum_dtype=dt)
        norms.append(float(step(p, optimizer.adamw_init(p), b)[2][
            "grad_norm"]))
    assert abs(norms[1] - norms[0]) <= 5e-2 * norms[0]


def test_checkpoint_restart_is_bit_exact():
    """Kill and restore reproduces the trajectory exactly on the CPU: the
    stateless data stream and an exact state round trip (a bf16 leaf
    included)."""
    pc = registry.get("qwen2-72b").make_config(smoke=True)
    step = make_train_step(lambda p, bt: tfm.train_loss(p, bt, pc),
                           optimizer.AdamWConfig(lr=1e-3), warmup=2,
                           total_steps=50)
    params = tfm.init(pc, seed=0, device="cpu")
    params["lm_head"] = params["lm_head"].to(torch.bfloat16)
    opt = optimizer.adamw_init(params)

    def batch(i):
        return data.lm_batch(7, i, 2, 16, pc.vocab, device="cpu")

    with tempfile.TemporaryDirectory() as d:
        for i in range(2):
            params, opt, _ = step(params, opt, batch(i))
        checkpoint.save(d, 2, {"params": params, "opt": opt})
        for i in range(2, 4):
            params, opt, m_a = step(params, opt, batch(i))
        template = {"params": tfm.init(pc, seed=1, device="cpu"),
                    "opt": optimizer.adamw_init(params)}
        template["params"]["lm_head"] = template["params"]["lm_head"].to(
            torch.bfloat16)
        restored, at, _ = checkpoint.restore(d, template)
        assert at == 2
        leaves = [torch.as_tensor(x) for x in tree.leaves(restored)]
        state = tree.structure(restored).unflatten(leaves)
        p2, o2 = state["params"], state["opt"]
        assert p2["lm_head"].dtype == torch.bfloat16
        for i in range(2, 4):
            p2, o2, m_b = step(p2, o2, batch(i))
    assert float(m_a["loss"]) == float(m_b["loss"])
    for a, b in zip(tree.leaves(params), tree.leaves(p2)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Gradient compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_int8_and_error_feedback_exact(dtype):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((5, 33)).astype(np.float32) * 3
    jx = _as({"x": x}, dtype)["x"]
    codes, scale = ref_gc.quantize_int8(jx)
    got_c, got_s = grad_compress.quantize_int8(_port(jx))
    assert got_c.dtype == torch.int8
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(codes))
    assert float(got_s) == float(scale)
    np.testing.assert_array_equal(
        grad_compress.dequantize_int8(got_c, got_s).numpy(),
        np.asarray(ref_gc.dequantize_int8(codes, scale)))
    grads = {"a": jx, "b": [jx[:2]]}
    res = {"a": jnp.asarray(x * 0.01), "b": [jnp.asarray(x[:2] * 0.02)]}
    applied = jax.tree.map(lambda g: jnp.round(g.astype(jnp.float32)), grads)
    for residuals in (None, res):
        want_c, want_fn = ref_gc.apply_error_feedback(grads, residuals)
        got_c, got_fn = grad_compress.apply_error_feedback(
            _port(grads), None if residuals is None else _port(residuals))
        for _, g, w in _pairs(got_c, want_c):
            np.testing.assert_array_equal(_np(g), _np(w))
        for _, g, w in _pairs(got_fn(_port(applied)), want_fn(applied)):
            np.testing.assert_array_equal(_np(g), _np(w))
