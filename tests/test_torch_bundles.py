"""One step of each serving and search bundle kind against the reference's
``bundle.fn`` on the same numpy inputs, at smoke size on the CPU (the
reference's bundles under its host mesh, each step under ``jax.jit``).

Tolerances:

* danube's bf16 prefill and decode: rtol 2e-2, atol 2e-1, the reference's
  own for its bf16 LM (``tests/test_torch_lm.py``); a decode step with a
  0-d int32 tensor ``pos`` equals the same step with an int ``pos`` bit
  for bit (logits and the cache written in place);
* the recommenders' scores: f32 towers 1e-5 relative to the largest,
  DLRM's bf16 towers 2e-2 (``tests/test_torch_recsys.py``);
* retrieval: the top 10 of the same user tower's scores
  (``testing.assert_topk_close`` at 1e-4 of the scores' scale);
* ``vs_search`` / ``vs_search_sorted``: ``testing.assert_topk_close`` at
  1e-5 of the scores' scale (f32 views and rerank summed in another order),
  on full rows that differ from their reduced view, so the rerank shows;
* ``vs_learn``: the centers within 1e-6, and the model's scores of
  learning queries against the rows within 1e-3 of the largest
  (``test_torch_sharding._model_scores``: 256 queries in D 512 leave the
  pseudo-inverse noise-determined outside their span); the reference's
  step in a process of its own with one XLA thread.
"""
import dataclasses
import os
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
from repro.models import transformer as ref_tfm
from repro.models.sharding import MeshRules
from repro_torch import convert, testing
from repro_torch.launch import steps
from test_torch_sharding import _model_scores, _tags, _vs_inputs

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bundles(arch, shape):
    """(the reference's bundle with its step under ``jax.jit``: one compile
    in place of one an op, the port's)."""
    want = ref_steps.build_bundle(arch, shape, make_host_mesh(), smoke=True)
    return (dataclasses.replace(want, fn=jax.jit(want.fn)),
            steps.build_bundle(arch, shape, smoke=True, device="cpu"))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _danube_params(got):
    """The reference's smoke parameters and the port's copy of them."""
    rc = ref_registry.get("h2o-danube-3-4b").make_config(smoke=True)
    params = jax.jit(lambda: ref_tfm.init(jax.random.PRNGKey(0), rc))()
    return params, convert.transformer_params(
        jax.tree.map(np.asarray, params), got.config, device="cpu")


def test_danube_prefill_matches_reference():
    want, got = _bundles("h2o-danube-3-4b", "prefill_32k")
    params, tp = _danube_params(got)
    tokens = np.random.default_rng(0).integers(
        0, got.config.vocab, got.args[1].shape).astype(np.int32)
    w_logits, w_cache = want.fn(params, jnp.asarray(tokens))
    g_logits, g_cache = got.fn(tp, torch.from_numpy(tokens))
    for g, w in ((g_logits, w_logits), (g_cache["k"], w_cache["k"]),
                 (g_cache["v"], w_cache["v"])):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(_np(g), _np(w), rtol=2e-2, atol=2e-1)


def test_danube_decode_matches_reference_with_a_tensor_pos():
    """The ring slot ``pos % 16`` of the smoke window, on a cache of
    random keys and values."""
    want, got = _bundles("h2o-danube-3-4b", "decode_32k")
    params, tp = _danube_params(got)
    rng = np.random.default_rng(1)
    cache = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in want.args[1].items()}
    tokens = rng.integers(0, got.config.vocab, got.args[2].shape).astype(
        np.int32)
    pos = 45
    assert got.args[3].shape == () and got.args[3].dtype == torch.int32
    w_logits, w_cache = want.fn(
        params, {k: jnp.asarray(v, jnp.bfloat16) for k, v in cache.items()},
        jnp.asarray(tokens), jnp.asarray(pos, jnp.int32))

    def port_cache():
        return {k: torch.from_numpy(v).to(torch.bfloat16)
                for k, v in cache.items()}

    g_logits, g_cache = got.fn(tp, port_cache(), torch.from_numpy(tokens),
                               torch.tensor(pos, dtype=torch.int32))
    i_logits, i_cache = got.fn(tp, port_cache(), torch.from_numpy(tokens),
                               pos)
    assert torch.equal(g_logits, i_logits)
    for k in ("k", "v"):
        assert torch.equal(g_cache[k], i_cache[k])
        np.testing.assert_allclose(_np(g_cache[k]), _np(w_cache[k]),
                                   rtol=2e-2, atol=2e-1)
    np.testing.assert_allclose(_np(g_logits), _np(w_logits), rtol=2e-2,
                               atol=2e-1)


def _recsys_inputs(want, rng):
    """(the reference's model namespace, its smoke parameters and config,
    a batch at the bundle's shapes with ids below each field's vocab)."""
    mod = ref_registry.get(want.name.split(":")[0])
    rc = mod.make_config(smoke=True)
    ns = getattr(ref_recsys, mod.MODEL)
    params = jax.jit(lambda: ns.init(jax.random.PRNGKey(0), rc))()
    batch = {}
    for k, v in want.args[1].items():
        if v.dtype == jnp.float32:
            batch[k] = rng.standard_normal(v.shape).astype(np.float32)
        elif k == "sparse":
            vocab = rc.vocab_sizes if mod.MODEL == "dlrm" else \
                (rc.vocab_per_field,) * rc.n_sparse
            batch[k] = np.stack([rng.integers(0, n, v.shape[0])
                                 for n in vocab], 1).astype(np.int32)
        elif k == "label":
            batch[k] = rng.integers(0, 2, v.shape).astype(np.int32)
        else:
            batch[k] = rng.integers(0, rc.n_items, v.shape).astype(np.int32)
    return ns, params, rc, batch


@pytest.mark.parametrize("arch", ["dlrm-mlperf", "fm", "bst", "mind"])
def test_recsys_serve_matches_reference(arch):
    want, got = _bundles(arch, "serve_p99")
    _, params, _, batch = _recsys_inputs(want, np.random.default_rng(2))
    tp = convert.recsys_params(jax.tree.map(np.asarray, params), got.config,
                               device="cpu")
    w = _np(want.fn(params, {k: jnp.asarray(v) for k, v in batch.items()}))
    g = _np(got.fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()}))
    assert g.shape == w.shape == (32,)
    rel = 2e-2 if got.config.compute_dtype == torch.bfloat16 else 1e-5
    assert np.abs(g - w).max() <= rel * np.abs(w).max()


@pytest.mark.parametrize("arch", ["dlrm-mlperf", "mind"])
def test_retrieval_matches_reference(arch):
    want, got = _bundles(arch, "retrieval_cand")
    rng = np.random.default_rng(3)
    ns, params, rc, batch = _recsys_inputs(want, rng)
    cands = rng.standard_normal(want.args[2].shape).astype(np.float32)
    tp = convert.recsys_params(jax.tree.map(np.asarray, params), got.config,
                               device="cpu")
    w_ids = np.asarray(want.fn(params, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                               jnp.asarray(cands)))
    g_ids = got.fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                   torch.from_numpy(cands))
    assert g_ids.dtype == torch.int32 and tuple(g_ids.shape) == w_ids.shape
    user = np.asarray(ns.user_embedding(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, rc,
        MeshRules(dp=(), fsdp=(), tp=None, ep=None)))
    scores = (torch.as_tensor(np.array(user))
              @ torch.from_numpy(cands).T).numpy()
    g = g_ids.numpy()
    testing.assert_topk_close(
        (np.take_along_axis(scores, g, 1), g),
        (np.take_along_axis(scores, w_ids, 1), w_ids),
        1e-4 * np.abs(scores).max(), arch)


def _reduced_top(args, k):
    """The reduced scan's own top ``k`` ids (B, k) of the search inputs:
    what a step that skipped the rerank, or scanned at kappa = k, would
    return."""
    q, tags, x_low, _, a = (torch.from_numpy(x) for x in args)
    views = torch.einsum("cdk,mk->mcd", a, q)                 # (B, C, d)
    row_tags = tags.long().repeat_interleave(x_low.shape[0]
                                             // tags.shape[0])
    scores = (views[:, row_tags] * x_low[None]).sum(-1)       # (B, n)
    return torch.topk(scores, k, dim=1).indices


@pytest.mark.parametrize("shape", ["search_oi13m", "search_oi13m_sorted"])
def test_vs_search_matches_reference(shape):
    """On smoke data whose full rows are their cluster's view of the
    reduced rows plus N(0, 0.05^2) noise, so the full-precision rerank
    reorders the reduced scan's candidates: the reference's one-device
    step and the port's agree on the top 10, and that top 10 differs from
    the reduced scan's own (a step without the rerank, or at kappa = k,
    would not pass)."""
    want, got = _bundles("gleanvec-paper", shape)
    args = _vs_inputs(np.random.default_rng(4), shape, noise=0.05)
    w_vals, w_ids = want.fn(*[jnp.asarray(a) for a in args])
    g_vals, g_ids = got.fn(*[torch.from_numpy(a) for a in args])
    assert g_ids.dtype == torch.int32 and g_ids.shape == (32, 10)
    testing.assert_topk_close((g_vals, g_ids), (np.asarray(w_vals),
                                                np.asarray(w_ids)),
                              1e-5 * float(np.abs(np.asarray(w_vals)).max()),
                              shape)
    reduced = torch.sort(_reduced_top(args, 10), dim=1).values
    moved = (torch.sort(g_ids.long(), dim=1).values != reduced).any(1)
    assert int(moved.sum()) >= 8, int(moved.sum())


REF_LEARN = textwrap.dedent("""
    import sys
    sys.path.insert(0, {src!r})
    import jax, jax.numpy as jnp, numpy as np
    from repro.launch import steps
    from repro.launch.mesh import make_host_mesh
    d = np.load({inp!r})
    b = steps.build_bundle("gleanvec-paper", "learn_oi13m",
                           make_host_mesh(), smoke=True)
    c, a, b_ = jax.jit(b.fn)(*(jnp.asarray(d[k]) for k in ("x", "q", "c")))
    np.savez({out!r}, c=np.asarray(c), a=np.asarray(a), b=np.asarray(b_))
""")


def test_vs_learn_matches_reference(tmp_path):
    """The reference's data pass runs in a process of its own with one
    XLA thread: its 48 masked (512, 2048) x (2048, 512) products under a
    pool of spinning threads take minutes on the test workers' shared
    cores."""
    got = steps.build_bundle("gleanvec-paper", "learn_oi13m", smoke=True,
                             device="cpu")
    x, q, centers = _vs_inputs(np.random.default_rng(5), "learn_oi13m")
    np.savez(tmp_path / "in.npz", x=x, q=q, c=centers)
    script = tmp_path / "ref_learn.py"
    script.write_text(REF_LEARN.format(src=str(ROOT / "src"),
                                       inp=str(tmp_path / "in.npz"),
                                       out=str(tmp_path / "out.npz")))
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    run = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=300, env=env)
    assert run.returncode == 0, run.stderr[-3000:]
    want = np.load(tmp_path / "out.npz")
    g_centers, g_a, g_b = got.fn(torch.from_numpy(x), torch.from_numpy(q),
                                 torch.from_numpy(centers))
    np.testing.assert_allclose(_np(g_centers), want["c"], rtol=1e-6,
                               atol=1e-6)
    tags = _tags(x, centers)
    got_scores = _model_scores(g_a, g_b, x, q, tags).numpy()
    want_scores = _model_scores(torch.from_numpy(want["a"]),
                                torch.from_numpy(want["b"]), x, q,
                                tags).numpy()
    assert np.abs(got_scores - want_scores).max() <= \
        1e-3 * np.abs(want_scores).max()
