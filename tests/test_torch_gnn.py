"""The port's GCN (``repro_torch.models.gnn``) against the JAX reference
(``repro.models.gnn``) on the CPU, and the GNN's graph makers
(``repro_torch.train.data``).

Every comparison runs in f32 at the smoke widths (d_feat 32, d_hidden 16)
on the reference's parameters (``convert.gnn_params``) and the same
graphs, op by op in JAX (no ``jit``). Tolerances: logits within 1e-5 +
1e-5 |x|, the loss within 1e-5 relative and each gradient leaf within
1e-4 of its norm (f32 sums in another order: the port's ``index_add``
against ``segment_sum``, its products against XLA's).

The minibatch feeds the port the reference's own draws: ``k1, k2 =
jax.random.split(key)`` and ``jax.random.randint(k, shape, 0, 2^30)`` are
what ``repro.models.gnn.sample_neighbors`` draws inside its step, so the
port's sampled ids equal the reference's exactly, an isolated node at the
end of the CSR (which starts at E) included.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gcn_cora as ref_gcn_cora
from repro.models import gnn as ref_gnn
from repro.models.sharding import MeshRules
from repro_torch import convert, tree
from repro_torch.configs import registry
from repro_torch.models import gnn
from repro_torch.train import data
from repro_torch.train.trainstep import value_and_grad

RULES = MeshRules(dp=(), fsdp=(), tp=None, ep=None)
LOGIT_ATOL = LOGIT_RTOL = 1e-5
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
D_FEAT = 32


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(n_classes, **kw):
    """(reference, port) smoke configs at D_FEAT."""
    rc = ref_gcn_cora.make_config(smoke=True, d_feat=D_FEAT,
                                  n_classes=n_classes)
    pc = registry.get("gcn-cora").make_config(smoke=True, d_feat=D_FEAT,
                                              n_classes=n_classes)
    return dataclasses.replace(rc, **kw), dataclasses.replace(pc, **kw)


def _params(rc, seed=0):
    """The reference's init with nonzero biases; (jax tree, port tree)."""
    p = ref_gnn.init(jax.random.PRNGKey(seed), rc)
    rng = np.random.default_rng(seed)
    p = {"w": [{"w": np.asarray(w["w"]),
                "b": (0.1 * rng.standard_normal(w["b"].shape)).astype(
                    np.float32)} for w in p["w"]]}
    return jax.tree.map(jnp.asarray, p), convert.gnn_params(p, device="cpu")


def _check(want_logits, got_logits, ref_loss_and_grad, port_loss_and_grad):
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    want_l, want_g = ref_loss_and_grad
    got_l, got_g = port_loss_and_grad
    assert abs(float(got_l) - float(want_l)) <= LOSS_RTOL * abs(float(want_l))
    paths, leaves, _ = tree.flatten_with_paths(got_g)
    ref = jax.tree.leaves(want_g)
    assert len(ref) == len(leaves) == 4
    for path, g, w in zip(paths, leaves, ref):
        g, w = g.numpy(), np.asarray(w)
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= GRAD_RTOL, (path, err)


def _edges(rng, n, e, isolated_last=True):
    """``e / 2`` undirected pairs without self-loops, both directions; the
    last node left isolated."""
    m = n - 1 if isolated_last else n
    a = rng.integers(0, m, e // 2)
    b = (a + 1 + rng.integers(0, m - 1, e // 2)) % m
    return np.stack([np.concatenate([a, b]),
                     np.concatenate([b, a])]).astype(np.int32)


# ---------------------------------------------------------------------------
# The three regimes against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["sym", "mean"])
def test_full_graph_matches_reference(norm):
    """Logits, the masked loss and every gradient on a graph of 48 nodes
    and 160 edges with an isolated node."""
    rc, pc = _configs(7, norm=norm)
    jp, tp = _params(rc)
    rng = np.random.default_rng(1)
    n = 48
    b = {"feats": rng.standard_normal((n, D_FEAT)).astype(np.float32),
         "edges": _edges(rng, n, 160),
         "labels": rng.integers(0, 7, n).astype(np.int32),
         "mask": (rng.random(n) < 0.5).astype(np.float32)}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    _check(ref_gnn.full_graph_logits(jp, jb["feats"], jb["edges"], rc, RULES),
           gnn.full_graph_logits(tp, tb["feats"], tb["edges"], pc),
           jax.value_and_grad(lambda p: ref_gnn.full_graph_loss(
               p, jb, rc, RULES))(jp),
           value_and_grad(lambda p, bt: gnn.full_graph_loss(p, bt, pc), tp,
                          tb))


def _csr(n, edges):
    order = np.argsort(edges[0], kind="stable")
    indptr = np.searchsorted(edges[0][order], np.arange(n + 1)).astype(
        np.int32)
    return indptr, edges[1][order].astype(np.int32)


def test_minibatch_samples_and_grads_match_reference():
    """The sampled ids of both hops equal the reference's exactly from its
    own draws (the isolated last node, whose CSR range starts at E, is a
    seed and samples itself); then logits, loss and gradients."""
    rc, pc = _configs(5)
    jp, tp = _params(rc, seed=2)
    rng = np.random.default_rng(3)
    n, bsz = 40, 12
    f1, f2 = rc.fanouts
    indptr, indices = _csr(n, _edges(rng, n, 120))
    assert indptr[n - 1] == indptr[n] == indices.shape[0]
    seeds = np.concatenate([[n - 1], rng.integers(0, n, bsz - 1)]).astype(
        np.int32)
    feats = rng.standard_normal((n, D_FEAT)).astype(np.float32)
    labels = rng.integers(0, 5, bsz).astype(np.int32)
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    rand1 = np.array(jax.random.randint(k1, (bsz, f1), 0, 1 << 30))
    rand2 = np.array(jax.random.randint(k2, (bsz, f1, f2), 0, 1 << 30))

    j = jnp.asarray
    want1 = ref_gnn.sample_neighbors(k1, j(indptr), j(indices), j(seeds), f1)
    want2 = ref_gnn.sample_neighbors(k2, j(indptr), j(indices), want1, f2)
    t = torch.from_numpy
    got1 = gnn.sample_neighbors(t(indptr), t(indices), t(seeds), t(rand1))
    got2 = gnn.sample_neighbors(t(indptr), t(indices), got1, t(rand2))
    np.testing.assert_array_equal(got1.numpy(), np.asarray(want1))
    np.testing.assert_array_equal(got2.numpy(), np.asarray(want2))
    assert (got1[0] == n - 1).all() and (got2[0] == n - 1).all()

    jb = {"feats": feats, "indptr": indptr, "indices": indices,
          "seeds": seeds, "labels": labels}
    tb = {k: t(v) for k, v in jb.items()}
    tb.update(rand1=t(rand1), rand2=t(rand2))
    jb = {k: jnp.asarray(v) for k, v in jb.items()}
    jb["rng"] = key
    _check(ref_gnn.minibatch_logits(jp, key, jb["feats"], jb["indptr"],
                                    jb["indices"], jb["seeds"], rc, RULES),
           gnn.minibatch_logits(tp, tb["feats"], tb["indptr"],
                                tb["indices"], tb["seeds"], tb["rand1"],
                                tb["rand2"], pc),
           jax.value_and_grad(lambda p: ref_gnn.minibatch_loss(
               p, jb, rc, RULES))(jp),
           value_and_grad(lambda p, bt: gnn.minibatch_loss(p, bt, pc), tp,
                          tb))


@pytest.mark.parametrize("n_classes", [1, 3], ids=["binary", "classes"])
def test_batched_graphs_match_reference(n_classes):
    """Six graphs of 10 nodes and 24 edges (the port's molecule maker) as
    one disjoint union against the reference's vmap: the binary logistic
    loss at one class, the NLL at three. ``norm="mean"`` in the config
    changes nothing here (symmetric whatever it says, as the
    reference)."""
    rc, pc = _configs(n_classes, norm="mean")
    jp, tp = _params(rc, seed=4)
    tb = data.molecule_batch(0, 3, 6, 10, 24, D_FEAT, n_classes,
                             device="cpu")
    jb = {k: jnp.asarray(v.numpy()) for k, v in tb.items()}
    _check(ref_gnn.batched_graphs_logits(jp, jb["feats"], jb["edges"], rc,
                                         RULES),
           gnn.batched_graphs_logits(tp, tb["feats"], tb["edges"], pc),
           jax.value_and_grad(lambda p: ref_gnn.batched_graphs_loss(
               p, jb, rc, RULES))(jp),
           value_and_grad(lambda p, bt: gnn.batched_graphs_loss(p, bt, pc),
                          tp, tb))


def test_init_matches_reference_shapes_and_scale():
    rc, pc = _configs(7)
    want = jax.tree.map(np.shape, ref_gnn.init(jax.random.PRNGKey(0), rc))
    got = gnn.init(pc, seed=3, device="cpu")
    assert [{k: tuple(v.shape) for k, v in w.items()} for w in got["w"]] \
        == [{k: tuple(v) for k, v in w.items()} for w in want["w"]]
    w0 = got["w"][0]["w"]
    assert float(w0.abs().max()) <= D_FEAT ** -0.5
    assert float(w0.std()) > 0.4 * D_FEAT ** -0.5       # uniform: 0.577
    assert not got["w"][0]["b"].any()
    again = gnn.init(pc, generator=torch.Generator().manual_seed(3),
                     device="cpu")
    assert torch.equal(again["w"][1]["w"], got["w"][1]["w"])


# ---------------------------------------------------------------------------
# The graph makers
# ---------------------------------------------------------------------------

def _pairs(src, dst):
    return sorted(zip(src.tolist(), dst.tolist()))


def test_full_graph_maker_is_valid_and_a_function_of_the_seed():
    g = data.gnn_graph(5, 300, 2000, 8, 7, device="cpu")
    again = data.gnn_graph(5, 300, 2000, 8, 7, device="cpu")
    other = data.gnn_graph(6, 300, 2000, 8, 7, device="cpu")
    for k in g:
        assert torch.equal(g[k], again[k]), k
    assert not torch.equal(g["edges"], other["edges"])
    src, dst = g["edges"]
    assert g["edges"].dtype == torch.int32 and g["edges"].shape == (2, 2000)
    assert int(g["edges"].min()) >= 0 and int(g["edges"].max()) < 300
    assert not bool((src == dst).any())
    assert _pairs(src, dst) == _pairs(dst, src)              # symmetric
    assert g["feats"].shape == (300, 8) and g["feats"].dtype == torch.float32
    assert g["labels"].dtype == torch.int32
    assert set(g["labels"].tolist()) == set(range(7))
    assert set(g["mask"].tolist()) == {0.0, 1.0}
    with pytest.raises(ValueError, match="even"):
        data.gnn_graph(0, 10, 7, 4, 3, device="cpu")


def test_csr_and_minibatch_are_valid_and_pure_functions_of_seed_and_step():
    n = 200
    g = data.gnn_graph(1, n, 1000, 8, 5, device="cpu")
    csr = data.gnn_csr(g["edges"], n)
    indptr, indices = csr["indptr"], csr["indices"]
    assert indptr.dtype == indices.dtype == torch.int32
    assert int(indptr[0]) == 0 and int(indptr[-1]) == 1000
    assert bool((indptr[1:] >= indptr[:-1]).all())            # monotone
    rows = torch.repeat_interleave(torch.arange(n),
                                   (indptr[1:] - indptr[:-1]).long())
    assert _pairs(rows, indices) == _pairs(*g["edges"])
    graph = {"feats": g["feats"], "labels": g["labels"], **csr}
    a = data.gnn_minibatch(graph, 1, 4, 32, (15, 10))
    b = data.gnn_minibatch(graph, 1, 4, 32, (15, 10))
    c = data.gnn_minibatch(graph, 1, 5, 32, (15, 10))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["seeds"], c["seeds"])
    assert not torch.equal(a["rand2"], c["rand2"])
    assert torch.equal(a["seeds"], data.graph_minibatch_seeds(1, 4, 32, n,
                                                              device="cpu"))
    assert a["seeds"].dtype == torch.int32 and int(a["seeds"].max()) < n
    assert torch.equal(a["labels"], g["labels"][a["seeds"].long()])
    assert a["rand1"].shape == (32, 15) and a["rand2"].shape == (32, 15, 10)
    for r in (a["rand1"], a["rand2"]):
        assert r.dtype == torch.int32 and 0 <= int(r.min())
        assert int(r.max()) < 1 << 30


def test_molecule_maker_is_valid_and_a_function_of_seed_and_step():
    a = data.molecule_batch(2, 7, 16, 30, 64, 16, 1, device="cpu")
    b = data.molecule_batch(2, 7, 16, 30, 64, 16, 1, device="cpu")
    c = data.molecule_batch(2, 8, 16, 30, 64, 16, 1, device="cpu")
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["edges"], c["edges"])
    e = a["edges"]
    assert e.shape == (16, 64, 2) and e.dtype == torch.int32
    assert int(e.min()) >= 0 and int(e.max()) < 30
    assert not bool((e[..., 0] == e[..., 1]).any())
    for one in e:
        assert _pairs(one[:, 0], one[:, 1]) == _pairs(one[:, 1], one[:, 0])
    assert a["feats"].shape == (16, 30, 16)
    assert set(a["labels"].tolist()) <= {0, 1}
    many = data.molecule_batch(2, 7, 64, 30, 64, 16, 5, device="cpu")
    assert int(many["labels"].max()) < 5 and int(many["labels"].max()) > 1
