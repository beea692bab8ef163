"""The port's data, fitting and encoding against the JAX reference.

Same numpy inputs into both packages. Eigenvectors differ in sign and in
the order of tied eigenvalues between backends, so fits are compared
through the sign-free products they serve: the sphering matrix W and the
score map A^T B (D, D), whose query/database inner products <Aq, Bx> =
q^T A^T B x are what search uses. Tolerances are relative to each
matrix's largest entry (1e-3): fp32 eigensolvers agree to that on a
well-conditioned query moment. The fits therefore learn from Gaussian
queries (m = 256 >= D = 64); the OOD queries of ``make_dataset`` have a
low intrinsic dimension, their K_Q a condition number near the pseudo-
inverse cutoff, and W^+ there depends on eigenvectors neither backend
determines to fp32 accuracy -- the search tests carry one fitted model
across instead (``repro_torch.convert``).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gleanvec as rgv
from repro.core import leanvec_sphering as rlvs
from repro.core import linalg as rlinalg
from repro.core import metrics as rmetrics
from repro.core import quantization as rquant
from repro.core import spherical_kmeans as rsk
from repro.data import vectors as rvectors
from repro_torch.core import gleanvec as gv
from repro_torch.core import leanvec_sphering as lvs
from repro_torch.core import linalg, metrics, quantization, spherical_kmeans
from repro_torch.data import vectors

REL = 1e-3


def _close(a, b, rel=REL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-30)
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale)


class _Data:
    def __init__(self):
        ds = rvectors.make_dataset("fit", n=2000, d=64, n_queries=128,
                                   ood=True, seed=3)
        self.database = ds.database
        self.queries_test, self.gt = ds.queries_test, ds.gt
        self.queries_learn = np.random.default_rng(3).standard_normal(
            (256, 64)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    return _Data()


@pytest.mark.parametrize("ood", [False, True])
def test_make_dataset_is_bit_identical(ood):
    a = rvectors.make_dataset("x", n=1500, d=32, n_queries=40, ood=ood,
                              seed=5, k_gt=20)
    b = vectors.make_dataset("x", n=1500, d=32, n_queries=40, ood=ood,
                             seed=5, k_gt=20)
    for f in ("database", "queries_learn", "queries_test", "gt"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_exact_topk_torch_matches_numpy_ids(data):
    """The torch ground-truth path gives the numpy path's ids (no exact
    ties in continuous random data)."""
    want = vectors.exact_topk(data.queries_test, data.database, 50)
    got = vectors.exact_topk(data.queries_test, data.database, 50,
                             block=512, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_recall_at_k_matches_reference(data):
    rng = np.random.default_rng(0)
    ret = rng.integers(0, 2000, (128, 10))
    ret[:, :3] = data.gt[:, :3]
    want = float(rmetrics.recall_at_k(jnp.asarray(ret),
                                      jnp.asarray(data.gt[:, :10])))
    assert metrics.recall_at_k(ret, data.gt[:, :10]) == pytest.approx(want)


def test_sphering_from_moment_matches(data):
    k_q = np.asarray(rlinalg.second_moment(jnp.asarray(data.queries_learn)))
    w_r, wp_r = rlinalg.sphering_from_moment(jnp.asarray(k_q))
    w, wp = linalg.sphering_from_moment(torch.from_numpy(k_q.copy()))
    _close(w.numpy(), w_r)
    _close(wp.numpy(), wp_r)
    np.testing.assert_allclose(
        linalg.second_moment(torch.from_numpy(data.queries_learn)).numpy(),
        k_q, rtol=1e-4, atol=1e-3)


def test_topk_eigvecs_same_subspace(data):
    k_x = data.database.T.astype(np.float64) @ data.database
    k_x = k_x.astype(np.float32)
    p_r = np.asarray(rlinalg.topk_eigvecs(jnp.asarray(k_x), 12))
    p = linalg.topk_eigvecs(torch.from_numpy(k_x), 12).numpy()
    _close(p.T @ p, p_r.T @ p_r)                 # projectors, sign-free


def test_safe_inv_sqrt_spectrum_matches():
    s = np.array([4.0, 1e-6, 0.0, 2.0, 1e-3], np.float32)
    np.testing.assert_allclose(
        linalg.safe_inv_sqrt_spectrum(torch.from_numpy(s)).numpy(),
        np.asarray(rlinalg.safe_inv_sqrt_spectrum(jnp.asarray(s))))


@pytest.mark.parametrize("d", [16, 64])
def test_leanvec_sphering_fit_matches(data, d):
    ref = rlvs.fit(jnp.asarray(data.queries_learn), jnp.asarray(data.database),
                   d)
    port = lvs.fit(data.queries_learn, data.database, d, device="cpu")
    assert port.a.shape == (d, 64) and port.b.shape == (d, 64)
    _close((port.a.T @ port.b).numpy(), np.asarray(ref.a.T @ ref.b))
    _close((port.p.T @ port.p).numpy(), np.asarray(ref.p.T @ ref.p))


def test_full_rotation_model_matches(data):
    ref = rlvs.full_rotation_model(jnp.asarray(data.queries_learn),
                                   jnp.asarray(data.database))
    port = lvs.full_rotation_model(data.queries_learn, data.database,
                                   device="cpu")
    assert port.dim == 64
    _close((port.a.T @ port.b).numpy(), np.asarray(ref.a.T @ ref.b))


def test_sphering_warns_on_few_learning_queries(data):
    with pytest.warns(UserWarning, match="rank-deficient"):
        lvs.fit(data.queries_learn[:10], data.database, 8, device="cpu")


def _ref_start(x, c, key):
    """The reference k-means's own start: kmeanspp_init(split(key)[0])."""
    init_key, _ = jax.random.split(key)
    return np.asarray(rsk.kmeanspp_init(
        init_key, rsk.normalize_rows(jnp.asarray(x)), c))


def test_spherical_kmeans_same_start_same_result(data):
    key = jax.random.PRNGKey(7)
    ref = rsk.fit(key, jnp.asarray(data.database), 8, n_iters=10)
    port = spherical_kmeans.fit(data.database, 8, n_iters=10,
                                init_centers=_ref_start(data.database, 8, key),
                                device="cpu")
    np.testing.assert_allclose(port.centers.numpy(), np.asarray(ref.centers),
                               atol=1e-4)
    assert port.inertia == pytest.approx(float(ref.inertia), rel=1e-5)
    x_unit = spherical_kmeans.normalize_rows(torch.from_numpy(data.database))
    np.testing.assert_array_equal(
        spherical_kmeans.assign(x_unit, port.centers).numpy(),
        np.asarray(rsk.assign(rsk.normalize_rows(jnp.asarray(data.database)),
                              ref.centers)))


def test_kmeanspp_init_picks_unit_data_rows():
    x = spherical_kmeans.normalize_rows(torch.randn(300, 16))
    gen = torch.Generator().manual_seed(0)
    c = spherical_kmeans.kmeanspp_init(x, 6, gen)
    dots = c @ x.T
    assert torch.allclose(dots.max(dim=1).values, torch.ones(6), atol=1e-5)


def test_gleanvec_fit_and_encode_match(data):
    """d = 8 stays below each cluster's intrinsic rank (~10 here); past it
    the per-cluster subspace is arbitrary on both sides."""
    key = jax.random.PRNGKey(1)
    ref = rgv.fit(key, jnp.asarray(data.queries_learn),
                  jnp.asarray(data.database), c=6, d=8, kmeans_iters=8)
    port = gv.fit(data.queries_learn, data.database, c=6, d=8,
                  kmeans_iters=8,
                  init_centers=_ref_start(data.database, 6, key),
                  device="cpu")
    np.testing.assert_allclose(port.centers.numpy(), np.asarray(ref.centers),
                               atol=1e-4)
    _close(port.w.numpy(), np.asarray(ref.w))
    for c in range(6):
        _close((port.a[c].T @ port.b[c]).numpy(),
               np.asarray(ref.a[c].T @ ref.b[c]))
    # encoding under the reference's own model: same tags, same x_low
    from repro_torch import convert
    model = convert.gleanvec_model(convert.arrays_of(ref), device="cpu")
    tags_r, low_r = rgv.encode_database(ref, jnp.asarray(data.database))
    tags, low = gv.encode_database(model, torch.from_numpy(data.database))
    np.testing.assert_array_equal(tags.numpy(), np.asarray(tags_r))
    np.testing.assert_allclose(low.numpy(), np.asarray(low_r), rtol=1e-4,
                               atol=1e-4 * float(np.abs(low_r).max()))
    views_r = rgv.project_queries_eager(ref, jnp.asarray(data.queries_test))
    views = gv.project_queries_eager(model,
                                     torch.from_numpy(data.queries_test))
    np.testing.assert_allclose(views.numpy(), np.asarray(views_r),
                               rtol=1e-4, atol=1e-4 * float(
                                   np.abs(views_r).max()))


def test_per_cluster_moments_match(data):
    rng = np.random.default_rng(2)
    tags = rng.integers(0, 5, 2000).astype(np.int32)
    tags[tags == 3] = 4                          # cluster 3 left empty
    ref = rgv.per_cluster_moments(jnp.asarray(data.database),
                                  jnp.asarray(tags), 5)
    port = gv.per_cluster_moments(torch.from_numpy(data.database),
                                  torch.from_numpy(tags), 5)
    _close(port.numpy(), np.asarray(ref), rel=1e-5)


@pytest.mark.parametrize("block", [64, 100])
def test_sort_by_tag_and_inverse_match(block):
    rng = np.random.default_rng(block)
    tags = rng.integers(0, 5, 700).astype(np.int32)
    tags[tags == 2] = 1                          # an empty cluster
    x = rng.integers(0, 256, (700, 8)).astype(np.uint8)
    xs_r, bt_r, perm_r, _ = rgv.sort_by_tag(jnp.asarray(tags),
                                            jnp.asarray(x), block=block)
    xs, bt, perm = gv.sort_by_tag(torch.from_numpy(tags), torch.from_numpy(x),
                                  block=block)
    np.testing.assert_array_equal(xs.numpy(), np.asarray(xs_r))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bt_r))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(perm_r))
    np.testing.assert_array_equal(
        gv.inverse_permutation(perm, 700).numpy(),
        np.asarray(rgv.inverse_permutation(perm_r, 700)))


def _codes_agree(got, want, x, lo, delta):
    """Codes equal, except +-1 where (x - lo) / delta sits at a .5 tie
    (the two sides compute the quotient in different fp32 orders)."""
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    diff = got != want
    assert np.abs(got - want).max(initial=0) <= 1
    frac = ((x - lo) / delta) % 1.0
    assert np.all(np.abs(frac[diff] - 0.5) < 1e-3)


def test_quantize_matches(data):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((900, 16)).astype(np.float32) * 3
    ref = rquant.quantize(jnp.asarray(x))
    port = quantization.quantize(torch.from_numpy(x))
    np.testing.assert_allclose(port.lo.numpy(), np.asarray(ref.lo))
    np.testing.assert_allclose(port.delta.numpy(), np.asarray(ref.delta),
                               rtol=1e-6)
    _codes_agree(port.codes.numpy(), ref.codes, x, np.asarray(ref.lo),
                 np.asarray(ref.delta))
    assert port.codes.dtype == torch.uint8


def test_quantize_per_cluster_matches():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1200, 16)).astype(np.float32)
    tags = rng.integers(0, 6, 1200).astype(np.int32)
    tags[tags == 4] = 0                          # cluster 4 empty
    ref = rquant.quantize_per_cluster(jnp.asarray(x), jnp.asarray(tags), 6)
    port = quantization.quantize_per_cluster(torch.from_numpy(x),
                                             torch.from_numpy(tags), 6)
    np.testing.assert_allclose(port.lo.numpy(), np.asarray(ref.lo))
    np.testing.assert_allclose(port.delta.numpy(), np.asarray(ref.delta),
                               rtol=1e-6)
    lo, delta = np.asarray(ref.lo)[tags], np.asarray(ref.delta)[tags]
    _codes_agree(port.codes.numpy(), ref.codes, x, lo, delta)


def test_torch_round_is_half_to_even():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        r = torch.round(torch.tensor([0.5, 1.5, 2.5, -0.5]))
    assert r.tolist() == [0.0, 2.0, 2.0, -0.0]
    assert np.asarray(jnp.round(jnp.asarray([0.5, 1.5, 2.5, -0.5]))).tolist() \
        == r.tolist()
