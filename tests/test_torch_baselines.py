"""The port's linear baselines, the paper-core helpers and the flat search
functions against the JAX reference.

Same numpy inputs into both packages. Eigenvector signs and tie order
differ between backends (and Frank-Wolfe is equivariant under the sign
flips of its SVD start), so fits are compared through the score map
A^T B (D, D) -- within 1e-3 of its largest entry -- and through their
Problem-(3) loss: SVD within rtol 1e-4, ES, FW and ES+FW within 1e-3.
The helpers compare elementwise within 1e-5 of the largest entry (scores
reach ~75 here, where one f32 ulp is 7.6e-6, so a fixed atol of 1e-5
would test the summation order); the searches through
``testing.assert_topk_close`` at the fp32 reordering bound
``testing.dot_tol``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as rbase
from repro.core import gleanvec as rgv
from repro.core import leanvec_sphering as rlvs
from repro.core import linalg as rlinalg
from repro.core import metrics as rmetrics
from repro.core import quantization as rquant
from repro.data import vectors as rvectors
from repro.index import bruteforce as rbf
from repro_torch import convert
from repro_torch.core import baselines
from repro_torch.core import gleanvec as gv
from repro_torch.core import leanvec_sphering as lvs
from repro_torch.core import linalg, metrics, quantization
from repro_torch.index import bruteforce as bf
from repro_torch.testing import assert_topk_close, dot_tol

D, DR = 48, 8
N_BCD, N_FW = 2, 3


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel=1e-3):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


class _Data:
    def __init__(self):
        ds = rvectors.make_dataset("b", n=1500, d=D, n_queries=96, ood=True,
                                   seed=7)
        self.ds = ds
        self.x = ds.database
        # well-conditioned learning queries (m > D), as test_torch_fit
        self.q = np.random.default_rng(7).standard_normal(
            (200, D)).astype(np.float32)
        self.k_q = self.q.T @ self.q
        self.k_x = self.x.T @ self.x
        self.glv = rgv.fit(jax.random.PRNGKey(0), jnp.asarray(self.q),
                           jnp.asarray(self.x), c=4, d=DR, kmeans_iters=4)


@pytest.fixture(scope="module")
def data():
    return _Data()


FITS = {
    "svd": (lambda kq, kx: rbase.svd_fit(kx, DR),
            lambda kq, kx: baselines.svd_fit(kx, DR), 1e-4),
    "es": (lambda kq, kx: rbase.leanvec_es(kq, kx, DR),
           lambda kq, kx: baselines.leanvec_es(kq, kx, DR), 1e-3),
    "fw": (lambda kq, kx: rbase.leanvec_fw(kq, kx, DR, n_bcd=N_BCD,
                                           n_fw=N_FW),
           lambda kq, kx: baselines.leanvec_fw(kq, kx, DR, n_bcd=N_BCD,
                                               n_fw=N_FW), 1e-3),
    "es_fw": (lambda kq, kx: rbase.leanvec_es_fw(kq, kx, DR, n_bcd=N_BCD,
                                                 n_fw=N_FW),
              lambda kq, kx: baselines.leanvec_es_fw(kq, kx, DR,
                                                     n_bcd=N_BCD,
                                                     n_fw=N_FW), 1e-3),
}


@pytest.mark.parametrize("name", sorted(FITS))
def test_baseline_fit_matches_reference(data, name):
    ref_fit, port_fit, loss_rtol = FITS[name]
    ref = ref_fit(jnp.asarray(data.k_q), jnp.asarray(data.k_x))
    got = port_fit(_t(data.k_q), _t(data.k_x))
    assert got.a.shape == got.b.shape == (DR, D) and got.dim == DR
    _close((got.a.T @ got.b).numpy(), np.asarray(ref.a).T @ np.asarray(ref.b))
    # the loss on the raw moments, and each package's loss of its own fit
    want = float(rbase.leanvec_loss_from_moments(ref.a, ref.b,
                                                 jnp.asarray(data.k_q),
                                                 jnp.asarray(data.k_x)))
    loss = float(baselines.leanvec_loss_from_moments(
        got.a, got.b, _t(data.k_q), _t(data.k_x)))
    np.testing.assert_allclose(loss, want, rtol=loss_rtol)
    # the same function on the same (reference) matrices
    carried = convert.linear_dr(convert.arrays_of(ref), "cpu")
    same = float(baselines.leanvec_loss_from_moments(
        carried.a, carried.b, _t(data.k_q), _t(data.k_x)))
    np.testing.assert_allclose(same, want, rtol=1e-4)


def test_fw_and_es_lower_the_loss_below_svd(data):
    """The query-aware baselines improve on the query-agnostic SVD (ES's
    grid holds SVD at alpha = 0: its loss is SVD's up to the rounding of
    the normalized moments), and ES+FW on ES."""
    kq, kx = _t(data.k_q), _t(data.k_x)
    loss = {name: float(baselines.leanvec_loss_from_moments(
        *FITS[name][1](kq, kx), kq, kx)) for name in FITS}
    assert loss["fw"] < loss["svd"]
    assert loss["es"] <= loss["svd"] * (1 + 1e-5)
    assert loss["es_fw"] <= loss["es"] * (1 + 1e-5)


def test_linalg_helpers_match_reference(data):
    w = np.random.default_rng(1).random(data.x.shape[0]).astype(np.float32)
    _close(linalg.cross_moment(_t(data.x), _t(w)).numpy(),
           rlinalg.cross_moment(jnp.asarray(data.x), jnp.asarray(w)),
           rel=1e-5)
    a = np.random.default_rng(2).standard_normal((DR, D)).astype(np.float32)
    for port_fn, ref_fn in ((linalg.polar, rlinalg.polar),
                            (linalg.orthonormalize_rows,
                             rlinalg.orthonormalize_rows)):
        got = port_fn(_t(a)).numpy()
        np.testing.assert_allclose(got, np.asarray(ref_fn(jnp.asarray(a))),
                                   atol=1e-5)
        np.testing.assert_allclose(got @ got.T, np.eye(DR), atol=1e-5)


def test_metrics_match_reference(data):
    rng = np.random.default_rng(3)
    a, b = (rng.standard_normal((DR, D)).astype(np.float32) * 0.2
            for _ in range(2))
    q, x = data.q[:50], data.x[:300]
    want = float(rmetrics.leanvec_loss(jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(q), jnp.asarray(x)))
    got = float(metrics.leanvec_loss(_t(a), _t(b), _t(q), _t(x)))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    approx = rng.standard_normal((20, 30)).astype(np.float32)
    exact = rng.standard_normal((20, 30)).astype(np.float32)
    np.testing.assert_allclose(
        float(metrics.ip_relative_error(_t(approx), _t(exact))),
        float(rmetrics.ip_relative_error(jnp.asarray(approx),
                                         jnp.asarray(exact))), rtol=1e-5)
    prof = metrics.captured_variance_profile(_t(data.k_x)).numpy()
    np.testing.assert_allclose(
        prof, np.asarray(rmetrics.captured_variance_profile(
            jnp.asarray(data.k_x))), atol=1e-5)
    assert prof.shape == (D,) and abs(prof[-1] - 1.0) < 1e-6


def test_truncate_is_prefix(data):
    """Both models' ``truncate`` keep a row prefix (per cluster for
    GleanVec), with the reference's shapes."""
    full = lvs.full_rotation_model(data.q, data.x, device="cpu")
    m = full.truncate(DR)
    ref = rlvs.full_rotation_model(jnp.asarray(data.q), jnp.asarray(data.x))
    assert m.a.shape == m.b.shape == m.p.shape == ref.truncate(DR).a.shape
    for f in ("a", "b", "p"):
        np.testing.assert_array_equal(getattr(m, f).numpy(),
                                      getattr(full, f)[:DR].numpy())
    assert m.dim == DR and m.w is full.w
    g = convert.gleanvec_model(convert.arrays_of(data.glv), "cpu")
    gt = g.truncate(3)
    rt = data.glv.truncate(3)
    assert gt.a.shape == rt.a.shape == (4, 3, D) and gt.dim == 3
    np.testing.assert_array_equal(gt.a.numpy(), np.asarray(rt.a))
    np.testing.assert_array_equal(gt.b.numpy(), np.asarray(rt.b))


def test_inner_products_match_reference(data):
    g = convert.gleanvec_model(convert.arrays_of(data.glv), "cpu")
    tags, x_low = rgv.encode_database(data.glv, jnp.asarray(data.x))
    q = data.ds.queries_test[0]
    want = np.asarray(rgv.inner_products_lazy(data.glv, jnp.asarray(q), tags,
                                              x_low))
    got = gv.inner_products_lazy(g, _t(q), _t(tags), _t(x_low)).numpy()
    _close(got, want, rel=1e-5)
    views = rgv.project_queries_eager(data.glv, jnp.asarray(q[None]))[0]
    want_e = np.asarray(rgv.inner_products_eager(views, tags, x_low))
    got_e = gv.inner_products_eager(
        gv.project_queries_eager(g, _t(q[None]))[0], _t(tags),
        _t(x_low)).numpy()
    _close(got_e, want_e, rel=1e-5)
    _close(got_e, got, rel=1e-5)                    # Alg. 3 == Alg. 4
    db = rquant.quantize(x_low)
    sq = quantization.SQDatabase(codes=_t(db.codes), lo=_t(db.lo),
                                 delta=_t(db.delta))
    qd = np.asarray(views[0])
    _close(quantization.quantized_inner_products(_t(qd), sq).numpy(),
           np.asarray(rquant.quantized_inner_products(jnp.asarray(qd), db)),
           rel=1e-5)


@pytest.mark.parametrize("block,slack", [(64, 0), (100, 1)])
def test_sort_by_tag_with_full_rows(block, slack):
    rng = np.random.default_rng(4)
    tags = rng.integers(0, 5, 700).astype(np.int32)
    tags[tags == 2] = 1                          # an empty cluster
    x_low = rng.standard_normal((700, 6)).astype(np.float32)
    x_full = rng.standard_normal((700, 11)).astype(np.float32)
    want = rgv.sort_by_tag(jnp.asarray(tags), jnp.asarray(x_low),
                           jnp.asarray(x_full), block=block,
                           slack_blocks=slack)
    got = gv.sort_by_tag(_t(tags), _t(x_low), _t(x_full), block=block,
                         slack_blocks=slack)
    assert len(got) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert len(gv.sort_by_tag(_t(tags), _t(x_low), block=block)) == 3


def _tol(q, rows):
    q = np.asarray(q, np.float32).reshape(-1, np.shape(q)[-1])
    return dot_tol(float(np.linalg.norm(q, axis=1).max()),
                   float(np.linalg.norm(np.asarray(rows, np.float32),
                                        axis=1).max()), q.shape[1])


def test_bruteforce_searches_match_reference(data):
    k = 17
    x = data.x
    q = data.ds.queries_test[:24]
    got = bf.search(q, x, k, device="cpu")
    assert_topk_close(got, rbf.search(jnp.asarray(q), jnp.asarray(x), k),
                      _tol(q, x), "search")

    tags, x_low = rgv.encode_database(data.glv, jnp.asarray(x))
    views = rgv.project_queries_eager(data.glv, jnp.asarray(q))
    got = bf.search_gleanvec(views, tags, x_low, k, device="cpu")
    assert_topk_close(got, rbf.search_gleanvec(views, tags, x_low, k),
                      _tol(views, x_low), "search_gleanvec")

    xs, btags, perm, _ = rgv.sort_by_tag(tags, x_low, block=64)
    got = bf.search_gleanvec_sorted(views, btags, xs, k, device="cpu")
    want = rbf.search_gleanvec_sorted(views, btags, xs, k)
    assert_topk_close(got, want, _tol(views, xs), "search_gleanvec_sorted")
    # ids are sorted rows: through perm they are the gathered search's
    ids = np.asarray(perm)[got[1].numpy()]
    assert_topk_close((got[0], ids), bf.search_gleanvec(
        views, tags, x_low, k, device="cpu"), _tol(views, x_low),
        "sorted ids through perm")

    q_low = np.asarray(q @ np.asarray(data.glv.a[0]).T)
    db = rquant.quantize(jnp.asarray(x @ np.asarray(data.glv.b[0]).T))
    got = bf.search_quantized(q_low, db.codes, db.lo, db.delta, k,
                              device="cpu")
    want = rbf.search_quantized(jnp.asarray(q_low), db.codes, db.lo,
                                db.delta, k)
    assert_topk_close(got, want, dot_tol(
        float(np.linalg.norm(q_low * np.asarray(db.delta), axis=1).max()),
        255.0 * np.sqrt(DR), DR,
        float(np.abs(q_low @ np.asarray(db.lo)).max())), "search_quantized")

    scorer = convert.scorer("LinearScorer", {"x_low": x}, "cpu")
    assert_topk_close(bf.search_scorer(_t(q), scorer, k),
                      rbf.search(jnp.asarray(q), jnp.asarray(x), k),
                      _tol(q, x), "search_scorer")
