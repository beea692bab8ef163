"""The port's recommenders, embedding bag, configs and candidate retrieval
against the JAX reference.

Each arch runs at its smoke config on parameters drawn by the reference's
``init`` and carried across with ``convert.recsys_params``, on one numpy
batch fed to both packages.
Tolerances: the f32 archs (FM, BST, MIND) within atol 1e-5 (plus 1e-5 of
the largest |value|); DLRM computes its towers in bf16, where the two
packages round products in another order: rtol 2e-2 (atol 2e-2 for
values near zero).

Retrieval: one fitted model (LeanVec-Sphering and GleanVec, fitted by the
reference on MIND user embeddings) and the reference's encoded scorer are
carried across, as ``test_torch_search`` does, and the port's
``retrieve`` answers the reference's in all seven modes and behind an
IVF, compared through the candidates' exact scores with
``testing.assert_topk_close`` at the fp32 reordering bound.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import registry as ref_registry
from repro.core import gleanvec as rgv
from repro.core import leanvec_sphering as rlvs
from repro.index import ivf as rivf
from repro.models import recsys as rrec
from repro.models.sharding import MeshRules
from repro.serve import retrieval as rret
from repro_torch import convert
from repro_torch.configs import recsys_common, registry
from repro_torch.core.scorer import MODES
from repro_torch.models import embedding, recsys
from repro_torch.serve import retrieval
from repro_torch.testing import assert_topk_close, dot_tol
from repro_torch.train import data

RULES = MeshRules(dp=(), fsdp=(), tp=None, ep=None)
RECSYS = ("dlrm-mlperf", "fm", "bst", "mind")
BATCH = 16


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jit(fn, *static):
    """The reference function compiled once (op-by-op dispatch of the
    smoke archs costs seconds a call); ``static``: its config argnums."""
    return jax.jit(fn, static_argnums=static)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, bf16=False):
    got = np.asarray(got.detach().to(torch.float32), np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    assert got.shape == want.shape
    if bf16:
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 + 1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# EmbeddingBag
# ---------------------------------------------------------------------------


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 30), st.integers(1, 5), st.sampled_from(["sum", "mean"]),
       st.booleans())
def test_embedding_bag_matches_per_bag_numpy(n_items, bags, combiner,
                                             weighted):
    rng = np.random.default_rng(n_items * 13 + bags)
    table = rng.standard_normal((50, 4)).astype(np.float32)
    idx = rng.integers(0, 50, n_items)
    seg = rng.integers(0, bags, n_items)            # unsorted bags
    w = rng.random(n_items).astype(np.float32) if weighted else None
    out = embedding.embedding_bag(
        _t(table), _t(idx), _t(seg), bags, combiner=combiner,
        weights=None if w is None else _t(w)).numpy()
    for b in range(bags):
        sel = seg == b
        rows = table[idx[sel]] * (w[sel][:, None] if weighted else 1.0)
        expect = rows.sum(0) if len(rows) else np.zeros(4)
        if combiner == "mean" and len(rows):
            expect = expect / len(rows)
        np.testing.assert_allclose(out[b], expect, rtol=1e-5, atol=1e-6)


def test_embedding_bag_refuses_unknown_combiner():
    with pytest.raises(ValueError, match="combiner"):
        embedding.embedding_bag(torch.zeros(3, 2), torch.zeros(2, dtype=int),
                                torch.zeros(2, dtype=int), 1, combiner="max")


def test_lookup_and_offsets_match_reference():
    from repro.models import embedding as remb
    sizes = (7, 3, 11)
    np.testing.assert_array_equal(embedding.pack_table_offsets(sizes),
                                  remb.pack_table_offsets(sizes))
    rng = np.random.default_rng(0)
    table = rng.standard_normal((21, 5)).astype(np.float32)
    idx = rng.integers(0, 3, (6, 3))
    offs = embedding.pack_table_offsets(sizes)
    np.testing.assert_array_equal(
        embedding.embedding_lookup(_t(table), _t(idx), _t(offs)).numpy(),
        np.asarray(remb.embedding_lookup(jnp.asarray(table), jnp.asarray(idx),
                                         jnp.asarray(offs))))


# ---------------------------------------------------------------------------
# The four archs
# ---------------------------------------------------------------------------


def _batch(arch, cfg):
    """One batch of the arch's fields, from numpy with a seed."""
    rng = np.random.default_rng(1)
    label = rng.integers(0, 2, BATCH).astype(np.int32)
    if arch == "dlrm-mlperf":
        return {"dense": rng.standard_normal(
                    (BATCH, cfg.n_dense)).astype(np.float32),
                "sparse": np.stack([rng.integers(0, v, BATCH)
                                    for v in cfg.vocab_sizes],
                                   1).astype(np.int32),
                "label": label}
    if arch == "fm":
        return {"sparse": rng.integers(0, cfg.vocab_per_field,
                                       (BATCH, cfg.n_sparse)).astype(np.int32),
                "label": label}
    return {"seq": rng.integers(0, cfg.n_items,
                                (BATCH, cfg.seq_len)).astype(np.int32),
            "target": rng.integers(0, cfg.n_items, BATCH).astype(np.int32),
            "label": label}


@pytest.fixture(scope="module")
def archs():
    """{arch: (ref cfg, port cfg, ref params, port params, batch)}."""
    out = {}
    for i, arch in enumerate(RECSYS):
        rcfg = ref_registry.get(arch).make_config(smoke=True)
        pcfg = registry.get(arch).make_config(smoke=True)
        ns = getattr(rrec, ref_registry.get(arch).MODEL)
        rp = _jit(ns.init, 1)(jax.random.PRNGKey(i), rcfg)
        if arch == "fm":      # zero-initialised biases: give them values
            rng = np.random.default_rng(2)
            rp = dict(rp, w=jnp.asarray(rng.standard_normal(
                rp["w"].shape).astype(np.float32) * 0.1), w0=jnp.float32(0.3))
        pp = convert.recsys_params(_np_tree(rp), pcfg, "cpu")
        out[arch] = (rcfg, pcfg, rp, pp, _batch(arch, rcfg))
    return out


@pytest.mark.parametrize("arch", RECSYS)
def test_recsys_arch_matches_reference(archs, arch, monkeypatch):
    rcfg, pcfg, rp, pp, b = archs[arch]
    model = ref_registry.get(arch).MODEL
    rns, pns = getattr(rrec, model), getattr(recsys, model)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: _t(v) for k, v in b.items()}
    bf16 = arch == "dlrm-mlperf"
    _close(pns.user_embedding(pp, tb, pcfg),
           _jit(rns.user_embedding, 2, 3)(rp, jb, rcfg, RULES), bf16)
    _close(pns.ctr_loss(pp, tb, pcfg),
           _jit(rns.ctr_loss, 2, 3)(rp, jb, rcfg, RULES), bf16)
    if arch == "dlrm-mlperf":
        offs = jnp.asarray(rrec.dlrm.offsets(rcfg))
        emb = jnp.take(rp["table"], jb["sparse"] + offs[None, :], axis=0)
        want = _jit(rrec.dlrm.forward, 3, 4)(rp, jb["dense"], emb, rcfg,
                                             RULES)
        got = recsys.dlrm.forward(pp, tb["dense"], _t(emb), pcfg)
        assert got.dtype == torch.bfloat16
        _close(got, want, bf16)
        np.testing.assert_array_equal(recsys.dlrm.offsets(pcfg),
                                      rrec.dlrm.offsets(rcfg))
    elif arch == "fm":
        _close(recsys.fm.logits(pp, tb["sparse"], pcfg),
               rrec.fm.logits(rp, jb["sparse"], rcfg, RULES))
    elif arch == "bst":
        _close(recsys.bst._encode(pp, tb["seq"], tb["target"], pcfg),
               _jit(rrec.bst._encode, 3, 4)(rp, jb["seq"], jb["target"],
                                            rcfg, RULES))
    else:
        caps = _jit(rrec.mind.interests, 2, 3)(rp, jb["seq"], rcfg, RULES)
        _close(recsys.mind.interests(pp, tb["seq"], pcfg), caps)
        t_emb = jnp.take(rp["item_emb"], jb["target"], axis=0)
        _close(recsys.mind.score_against(_t(caps), _t(t_emb), pcfg.pow_p),
               rrec.mind.score_against(caps, t_emb, rcfg.pow_p))
        # the in-batch softmax in chunks of 3 users (16 = 5 x 3 + 1)
        monkeypatch.setattr(recsys, "MIND_LOSS_CHUNK", 3)
        _close(recsys.mind.ctr_loss(pp, tb, pcfg),
               _jit(rrec.mind.ctr_loss, 2, 3)(rp, jb, rcfg, RULES))


@pytest.mark.parametrize("arch", RECSYS)
def test_init_shapes_and_scales_follow_the_reference(arch):
    rcfg = ref_registry.get(arch).make_config(smoke=True)
    pcfg = registry.get(arch).make_config(smoke=True)
    ns = ref_registry.get(arch).MODEL
    want = _np_tree(_jit(getattr(rrec, ns).init, 1)(jax.random.PRNGKey(0),
                                                    rcfg))
    got = getattr(recsys, ns).init(torch.Generator().manual_seed(0), pcfg,
                                   device="cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), got))[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert g.shape == w.shape and g.dtype == np.float32, path
        if w.size > 100:          # the same scale (std within 15 %)
            np.testing.assert_allclose(g.std(), w.std(), rtol=0.15,
                                       err_msg=str(path))


def test_configs_and_registry_match_reference():
    """The port's copies hold the reference's numbers, in torch dtypes,
    and ``gleanvec-paper``'s shapes letter for letter."""
    for arch in RECSYS:
        for smoke in (True, False):
            rc = ref_registry.get(arch).make_config(smoke=smoke)
            pc = registry.get(arch).make_config(smoke=smoke)
            for f in dataclasses.fields(pc):
                want, got = getattr(rc, f.name), getattr(pc, f.name)
                if f.name.endswith("_dtype"):
                    assert str(got).split(".")[-1] == jnp.dtype(want).name
                else:
                    assert got == want, (arch, smoke, f.name)
        assert registry.get(arch).SHAPES == ref_registry.get(arch).SHAPES
        assert registry.get(arch).MODEL == ref_registry.get(arch).MODEL
    assert recsys_common.RECSYS_SHAPES == \
        __import__("repro.configs.recsys_common",
                   fromlist=["x"]).RECSYS_SHAPES
    paper = registry.get("gleanvec-paper")
    ref_paper = ref_registry.get("gleanvec-paper")
    assert paper.SHAPES == ref_paper.SHAPES and paper.FAMILY == "vectorsearch"
    assert paper.make_config(True) == ref_paper.make_config(True)
    full = registry.get("dlrm-mlperf").make_config()
    assert full.total_vocab == 187_767_399
    assert full.padded_total_vocab == 187_767_808      # 96.1 GB in f32
    gcn, ref_gcn = registry.get("gcn-cora"), ref_registry.get("gcn-cora")
    assert gcn.SHAPES == ref_gcn.SHAPES and gcn.FAMILY == "gnn"
    for smoke in (True, False):
        rc, pc = ref_gcn.make_config(smoke), gcn.make_config(smoke)
        assert (pc.name, pc.n_layers, pc.d_hidden, pc.d_feat, pc.n_classes,
                pc.aggregator, pc.norm, pc.fanouts) == \
            (rc.name, rc.n_layers, rc.d_hidden, rc.d_feat, rc.n_classes,
             rc.aggregator, rc.norm, rc.fanouts)


def test_synthetic_batches_are_pure_functions_of_seed_and_step():
    a = data.criteo_batch(3, 5, 64, 13, (7, 100, 3), device="cpu")
    b = data.criteo_batch(3, 5, 64, 13, (7, 100, 3), device="cpu")
    c = data.criteo_batch(3, 6, 64, 13, (7, 100, 3), device="cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["dense"], c["dense"])
    assert a["dense"].shape == (64, 13) and a["sparse"].shape == (64, 3)
    assert bool((a["sparse"] < torch.tensor([7, 100, 3])).all())
    assert set(a["label"].unique().tolist()) <= {0, 1}
    s = data.bst_batch(0, 0, 32, 20, 1000, device="cpu")
    m = data.mind_batch(0, 0, 32, 50, 1000, device="cpu")
    assert s["seq"].shape == (32, 20) and s["target"].shape == (32,)
    assert m["seq"].shape == (32, 50) and int(m["seq"].max()) < 1000
    assert not torch.equal(s["seq"][:, :20], m["seq"][:, :20])


# ---------------------------------------------------------------------------
# Candidate retrieval
# ---------------------------------------------------------------------------

DR, C, K, KAPPA = 8, 4, 10, 40


class _Retrieval:
    """MIND smoke: its items are the candidates, its users the queries."""

    def __init__(self):
        cfg = ref_registry.get("mind").make_config(smoke=True)
        params = _jit(rrec.mind.init, 1)(jax.random.PRNGKey(7), cfg)
        self.x = jnp.asarray(params["item_emb"])
        rng = np.random.default_rng(7)
        learn, test = ({"seq": jnp.asarray(rng.integers(
            0, cfg.n_items, (m, cfg.seq_len)).astype(np.int32))}
            for m in (64, 12))
        user = _jit(rrec.mind.user_embedding, 2, 3)
        q = user(params, learn, cfg, RULES)
        self.users = np.asarray(user(params, test, cfg, RULES))
        self.models = {
            "sphering": rlvs.fit(q, self.x, DR),
            "gleanvec": rgv.fit(jax.random.PRNGKey(0), q, self.x, c=C, d=DR,
                                kmeans_iters=5)}


@pytest.fixture(scope="module")
def ret():
    return _Retrieval()


def _ref_model(ret, mode):
    if mode == "full":
        return None
    return ret.models["sphering" if mode.startswith("sphering")
                      else "gleanvec"]


def _carried(ref_idx, mode, index=None):
    """The reference's encoded retrieval index carried across."""
    s = ref_idx.scorer
    model = ref_idx.artifacts.model
    if model is not None:
        build = convert.sphering_model if mode.startswith("sphering") \
            else convert.gleanvec_model
        model = build(convert.arrays_of(model), "cpu")
    return retrieval.build_retrieval_index(
        np.array(ref_idx.x_full), mode, model, index=index,
        scorer=convert.scorer(type(s).__name__, convert.arrays_of(s), "cpu"),
        device="cpu")


def _exact(users, x, ids):
    s = np.einsum("md,mkd->mk", users.astype(np.float64),
                  x[np.where(ids >= 0, ids, 0)])
    return np.where(ids >= 0, s, -3.4e38)


def _assert_same(ret, got, want, label):
    x = np.asarray(ret.x)
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape == (ret.users.shape[0], K), label
    tol = dot_tol(float(np.linalg.norm(ret.users, axis=1).max()),
                  float(np.linalg.norm(x, axis=1).max()), x.shape[1])
    assert_topk_close((_exact(ret.users, x, got), got),
                      (_exact(ret.users, x, want), want), tol, label)


@pytest.mark.parametrize("mode", MODES)
def test_retrieve_matches_reference(ret, mode):
    ref_idx = rret.build_retrieval_index(ret.x, mode, _ref_model(ret, mode))
    if mode.endswith("sorted"):          # a small layout block at this n
        from repro.core import scorer as rsc
        ref_idx = ref_idx._replace(artifacts=ref_idx.artifacts._replace(
            scorer=rsc.build_scorer(mode, ret.x, _ref_model(ret, mode),
                                    block=64)))
    want = rret.retrieve(ref_idx, jnp.asarray(ret.users), K, KAPPA)
    idx = _carried(ref_idx, mode)
    got = retrieval.retrieve(idx, ret.users, K, KAPPA)
    assert got.dtype == torch.int32
    _assert_same(ret, got, want, mode)
    if mode != "full":                   # the state is built once a key
        built = idx.fn_cache[(K, KAPPA)]
        assert built[0] is idx.artifacts and built[1] is None
        again = retrieval.retrieve(idx, torch.from_numpy(ret.users), K,
                                   KAPPA)
        assert idx.fn_cache[(K, KAPPA)][2] is built[2]
        assert len(idx.fn_cache) == 1 and torch.equal(again, got)
    else:
        assert idx.fn_cache == {}        # exact: no rerank, no state


def test_retrieve_behind_ivf_matches_reference(ret):
    mode = "gleanvec-int8"
    ref_ivf = rivf.build(jax.random.PRNGKey(3), ret.x, 8, n_iters=5,
                         nprobe=4)
    ref_idx = rret.build_retrieval_index(ret.x, mode, _ref_model(ret, mode),
                                         index=ref_ivf)
    want = rret.retrieve(ref_idx, jnp.asarray(ret.users), K, KAPPA)
    idx = _carried(ref_idx, mode, index=convert.ivf_index(ref_ivf, "cpu"))
    got = retrieval.retrieve(idx, ret.users, K, KAPPA)
    _assert_same(ret, got, want, "ivf")
    # a second kappa is a second state; the first is kept
    retrieval.retrieve(idx, ret.users, K, 2 * KAPPA)
    assert set(idx.fn_cache) == {(K, KAPPA), (K, 2 * KAPPA)}
    assert all(b[1] is idx.index for b in idx.fn_cache.values())


def test_retrieve_from_host_tier_equals_device_tier(ret):
    from repro_torch.core import search
    mode = "gleanvec-int8-sorted"
    model = convert.gleanvec_model(convert.arrays_of(ret.models["gleanvec"]),
                                   "cpu")
    idx = retrieval.build_retrieval_index(np.asarray(ret.x), mode, model,
                                          device="cpu")
    want = retrieval.retrieve(idx, ret.users, K, KAPPA)
    host = idx._replace(artifacts=search.demote_rerank_tier(idx.artifacts))
    assert search.host_tier(host.artifacts) is not None
    assert torch.equal(retrieval.retrieve(host, ret.users, K, KAPPA), want)


@pytest.mark.parametrize("mode", ["sphering", "gleanvec-int8-sorted"])
def test_retrieve_serves_replaced_artifacts(ret, mode):
    """``_replace(artifacts=...)`` shares ``fn_cache``: the state mounted
    for the old rows must not answer for the new ones."""
    model = convert.gleanvec_model(convert.arrays_of(ret.models["gleanvec"]),
                                   "cpu") if mode.startswith("gleanvec") \
        else convert.sphering_model(convert.arrays_of(
            ret.models["sphering"]), "cpu")
    x = np.asarray(ret.x)
    idx = retrieval.build_retrieval_index(x, mode, model, device="cpu")
    before = retrieval.retrieve(idx, ret.users, K, KAPPA)
    fresh = retrieval.build_retrieval_index(x[::-1].copy(), mode, model,
                                            device="cpu")
    swapped = idx._replace(artifacts=fresh.artifacts)
    assert swapped.fn_cache is idx.fn_cache
    got = retrieval.retrieve(swapped, ret.users, K, KAPPA)
    want = retrieval.retrieve(fresh, ret.users, K, KAPPA)
    assert torch.equal(got, want)
    assert torch.equal(torch.sort(got, dim=1).values, torch.sort(
        x.shape[0] - 1 - before, dim=1).values)
    assert idx.fn_cache[(K, KAPPA)][0] is fresh.artifacts
