"""The port's kernel plain versions against the JAX reference's kernels.

Each plain version (what a port wrapper runs on a CPU tensor) is held
against both the Pallas kernel in interpret mode and the kernel's jnp
``ref.py`` oracle, on the same numpy inputs. Tolerance: the two sides add
the same fp32 products in different orders, so values agree within
``repro_torch.testing.dot_tol`` (2 d eps |q| |x|), and ids may differ only
at near-ties of the k-th value (``assert_topk_close``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import (gleanvec_ip, gleanvec_ip_ref, gleanvec_sq,
                           gleanvec_sq_ref, gleanvec_sq_sorted_ref,
                           gleanvec_sq_topk, gleanvec_sq_topk_ref, ip_topk,
                           ip_topk_ref, ivf_scan_topk, ivf_scan_topk_ref,
                           kmeans_assign, kmeans_assign_ref, sq_dot,
                           sq_dot_ref)
from repro_torch import kernels as K
from repro_torch.testing import assert_topk_close, dot_tol


def _rng(seed):
    return np.random.default_rng(seed)


def _codes(rng, n, d, u8):
    if u8:
        return rng.integers(0, 256, (n, d)).astype(np.uint8)
    return rng.standard_normal((n, d)).astype(np.float32)


def _norm(a):
    a = np.asarray(a, np.float64)
    return float(np.linalg.norm(a.reshape(-1, a.shape[-1]), axis=1).max())


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("m,n,d,k,u8", [
    (13, 1000, 16, 10, False),      # ragged M and N
    (16, 4096, 16, 100, False),     # k = kappa = 100
    (5, 777, 16, 100, True),        # u8 rows, ragged N
    (9, 3000, 64, 10, False),       # the full mode's shape family (d = D)
])
def test_ip_topk_plain_matches_pallas_and_ref(m, n, d, k, u8):
    rng = _rng(m * 1000 + n)
    q = rng.standard_normal((m, d)).astype(np.float32)
    x = _codes(rng, n, d, u8)
    tol = dot_tol(_norm(q), _norm(x), d)
    port = K.ip_topk(_t(q), _t(x), k)                    # CPU -> plain
    pallas = ip_topk(jnp.asarray(q), jnp.asarray(x), k, interpret=True)
    ref = ip_topk_ref(jnp.asarray(q), jnp.asarray(x), k)
    assert port[0].dtype == torch.float32 and port[1].dtype == torch.int32
    assert_topk_close(port, pallas, tol, "plain vs pallas")
    assert_topk_close(port, ref, tol, "plain vs ref")


def _sq_case(rng, m, n, c, d, u8, masked):
    q_scaled = rng.standard_normal((m, c, d)).astype(np.float32)
    q_lo = rng.standard_normal((m, c)).astype(np.float32)
    codes = _codes(rng, n, d, u8)
    row_ids = None
    if masked:
        row_ids = np.arange(n, dtype=np.int32)
        row_ids[rng.random(n) < 0.15] = -1
    return q_scaled, q_lo, codes, row_ids


@pytest.mark.parametrize("m,n,c,d,k,u8,masked", [
    (7, 1000, 8, 16, 10, True, True),     # ragged, row_ids with -1
    (16, 4096, 8, 16, 100, True, False),  # kappa = 100
    (5, 513, 3, 16, 10, False, True),     # f32 rows
])
def test_gleanvec_sq_topk_gathered_plain_matches(m, n, c, d, k, u8, masked):
    rng = _rng(n + c)
    q_scaled, q_lo, codes, row_ids = _sq_case(rng, m, n, c, d, u8, masked)
    tags = rng.integers(0, c, n).astype(np.int32)
    tol = dot_tol(_norm(q_scaled), _norm(codes), d, float(np.abs(q_lo).max()))
    port = K.gleanvec_sq_topk(_t(q_scaled), _t(q_lo), _t(tags), _t(codes), k,
                              row_ids=None if row_ids is None
                              else _t(row_ids))
    jrid = None if row_ids is None else jnp.asarray(row_ids)
    args = (jnp.asarray(q_scaled), jnp.asarray(q_lo), jnp.asarray(tags),
            jnp.asarray(codes), k)
    pallas = gleanvec_sq_topk(*args, row_ids=jrid, tm=4, tn=128,
                              interpret=True)
    ref = gleanvec_sq_topk_ref(*args, row_ids=jrid)
    assert_topk_close(port, pallas, tol, "plain vs pallas")
    assert_topk_close(port, ref, tol, "plain vs ref")
    if masked:
        dropped = set(np.nonzero(row_ids < 0)[0].tolist())
        assert not dropped & set(port[1].numpy().ravel().tolist())


@pytest.mark.parametrize("m,nb,c,d,k,u8", [
    (6, 20, 4, 16, 10, True),
    (11, 64, 8, 16, 100, False),
])
def test_gleanvec_sq_topk_sorted_plain_matches(m, nb, c, d, k, u8):
    """Tag-sorted layout (block 64) with a permutation holding -1 padding."""
    lb = 64
    n = nb * lb
    rng = _rng(nb * 7 + c)
    q_scaled, q_lo, codes, _ = _sq_case(rng, m, n, c, d, u8, False)
    block_tags = rng.integers(0, c, nb).astype(np.int32)
    perm = np.full(n, -1, np.int32)
    live = np.sort(rng.permutation(n)[: n - n // 5])
    perm[live] = rng.permutation(live.size).astype(np.int32)
    tol = dot_tol(_norm(q_scaled), _norm(codes), d, float(np.abs(q_lo).max()))
    port = K.gleanvec_sq_topk(_t(q_scaled), _t(q_lo), _t(block_tags),
                              _t(codes), k, row_ids=_t(perm),
                              layout_block=lb)
    args = (jnp.asarray(q_scaled), jnp.asarray(q_lo), jnp.asarray(block_tags),
            jnp.asarray(codes), k)
    pallas = gleanvec_sq_topk(*args, row_ids=jnp.asarray(perm),
                              layout_block=lb, tm=4, interpret=True)
    ref = gleanvec_sq_topk_ref(*args, row_ids=jnp.asarray(perm),
                               layout_block=lb)
    assert_topk_close(port, pallas, tol, "plain vs pallas")
    assert_topk_close(port, ref, tol, "plain vs ref")
    assert (port[1].numpy() >= 0).all()            # padding never wins


@pytest.mark.parametrize("n,d,c", [(1000, 64, 8), (4096, 64, 5), (77, 16, 3)])
def test_kmeans_assign_plain_matches_pallas_and_ref(n, d, c):
    """Tags equal (no near-ties at these random inputs); max similarities
    within the fp32 reordering bound."""
    rng = _rng(n + d + c)
    x = rng.standard_normal((n, d)).astype(np.float32)
    cent = rng.standard_normal((c, d)).astype(np.float32)
    tags, sims = K.kmeans_assign(_t(x), _t(cent))
    tol = dot_tol(_norm(x), _norm(cent), d)
    for other in (kmeans_assign(jnp.asarray(x), jnp.asarray(cent), tn=256,
                                interpret=True),
                  kmeans_assign_ref(jnp.asarray(x), jnp.asarray(cent))):
        np.testing.assert_array_equal(tags.numpy(), np.asarray(other[0]))
        np.testing.assert_allclose(sims.numpy(), np.asarray(other[1]),
                                   rtol=0, atol=tol)


def _ivf_case(rng, m, c, d, lb, nb, s, u8, slack):
    """A sorted layout of ``nb`` blocks (the last ``slack`` all padding,
    ~15 % of the other rows -1) and a schedule with pad slots in the middle
    and at the end of each row; row 1 is all padding."""
    n = nb * lb
    q_scaled = rng.standard_normal((m, c, d)).astype(np.float32)
    q_lo = rng.standard_normal((m, c)).astype(np.float32)
    codes = _codes(rng, n, d, u8)
    block_tags = rng.integers(0, c, nb).astype(np.int32)
    row_ids = rng.permutation(n).astype(np.int32)
    row_ids[rng.random(n) < 0.15] = -1
    if slack:
        row_ids[(nb - slack) * lb:] = -1
    sched = np.stack([rng.permutation(nb)[:s] for _ in range(m)]
                     ).astype(np.int32)
    sched[:, s // 2] = -1                   # a pad slot in the middle
    sched[::2, -1] = -1                     # and at the end
    sched[1] = -1                           # an all-pad row
    return q_scaled, q_lo, block_tags, row_ids, codes, sched


@pytest.mark.parametrize("m,c,d,lb,nb,s,k,u8,slack", [
    (7, 5, 16, 64, 12, 6, 10, True, 2),     # ragged M, u8, slack blocks
    (5, 3, 24, 32, 8, 4, 100, False, 0),    # k above every row's valid count
    (9, 4, 16, 48, 10, 5, 100, True, 1),    # kappa = 100, layout block 48
])
def test_ivf_scan_topk_plain_matches_pallas_and_ref(m, c, d, lb, nb, s, k,
                                                    u8, slack):
    rng = _rng(m * 100 + nb)
    q_scaled, q_lo, block_tags, row_ids, codes, sched = _ivf_case(
        rng, m, c, d, lb, nb, s, u8, slack)
    tol = dot_tol(_norm(q_scaled), _norm(codes), d, float(np.abs(q_lo).max()))
    port = K.ivf_scan_topk(_t(q_scaled), _t(q_lo), _t(block_tags),
                           _t(row_ids), _t(codes), _t(sched), k, lb)
    args = tuple(jnp.asarray(a) for a in (q_scaled, q_lo, block_tags,
                                          row_ids, codes, sched))
    pallas = ivf_scan_topk(*args, k, layout_block=lb, interpret=True)
    ref = ivf_scan_topk_ref(*args, k, layout_block=lb)
    assert port[0].dtype == torch.float32 and port[1].dtype == torch.int32
    for other, label in ((pallas, "plain vs pallas"), (ref, "plain vs ref")):
        assert_topk_close(port, other, tol, label)
        np.testing.assert_array_equal(port[1].numpy() < 0,
                                      np.asarray(other[1]) < 0, label)
    ids = port[1].numpy()
    assert (ids[1] == -1).all()                       # the all-pad row
    assert set(ids[ids >= 0].tolist()) <= set(row_ids[row_ids >= 0].tolist())


def test_ivf_scan_topk_plain_ties_and_empty_schedule():
    """Identical rows: equal scores come out in ascending id order; an
    empty schedule (S = 0) gives only (-inf, -1)."""
    lb, nb, d = 32, 4, 8
    codes = np.ones((lb * nb, d), np.float32)
    row_ids = np.arange(lb * nb, dtype=np.int32)[::-1].copy()
    q = np.ones((2, 3, d), np.float32)
    qlo = np.zeros((2, 3), np.float32)
    tags = np.zeros(nb, np.int32)
    sched = np.array([[2, 0], [3, -1]], np.int32)
    vals, ids = K.ivf_scan_topk(_t(q), _t(qlo), _t(tags), _t(row_ids),
                                _t(codes), _t(sched), 40, lb)
    rows0 = np.concatenate([row_ids[64:96], row_ids[0:32]])
    assert ids[0].tolist() == sorted(rows0.tolist())[:40]
    assert ids[1, :32].tolist() == sorted(row_ids[96:].tolist())
    assert (ids[1, 32:] == -1).all() and (vals[1, 32:] < -1e37).all()
    vals, ids = K.ivf_scan_topk(_t(q), _t(qlo), _t(tags), _t(row_ids),
                                _t(codes), _t(np.zeros((2, 0), np.int32)),
                                5, lb)
    assert (ids == -1).all() and (vals < -1e37).all()


def test_kmeans_assign_plain_ties_go_to_first_center():
    cent = np.eye(4, 8, dtype=np.float32)
    cent[3] = cent[1]
    x = np.tile(cent[1], (5, 1))
    tags, _ = K.kmeans_assign(_t(x), _t(cent))
    assert (tags.numpy() == 1).all()
    assert (np.asarray(kmeans_assign_ref(jnp.asarray(x),
                                         jnp.asarray(cent))[0]) == 1).all()


def test_topk_plain_ties_break_toward_smaller_id():
    """Equal scores come out in ascending row order (the kernels' rule)."""
    q = torch.ones(2, 4)
    x = torch.ones(300, 4)
    vals, ids = K.ip_topk_plain(q, x, 10, block=64)
    assert ids.tolist() == [list(range(10))] * 2
    assert (vals == 4.0).all()


def test_plain_fills_unfilled_slots_with_neg_inf_and_minus_one():
    """Fewer rows than k: the tail holds (NEG_INF, -1), as the kernels."""
    vals, ids = K.ip_topk(torch.randn(3, 8), torch.randn(5, 8), 10)
    assert (ids[:, 5:] == -1).all() and (vals[:, 5:] < -1e37).all()
    assert sorted(ids[0, :5].tolist()) == list(range(5))


@pytest.mark.parametrize("m,n,d", [(13, 1000, 16), (5, 777, 40),
                                   (9, 2049, 8)])
def test_sq_dot_plain_matches_pallas_and_ref(m, n, d):
    """Dense int8 scores: the wrapper's fold and the folded entry against
    the Pallas kernel (interpret) and ``sq_dot_ref``."""
    rng = _rng(m + n + d)
    q = rng.standard_normal((m, d)).astype(np.float32)
    codes = _codes(rng, n, d, True)
    lo = rng.standard_normal(d).astype(np.float32)
    delta = (rng.random(d) + 0.01).astype(np.float32)
    port = K.sq_dot(_t(q), _t(codes), _t(lo), _t(delta)).numpy()
    qs, qlo = _t(q) * _t(delta), _t(q) @ _t(lo)
    folded = K.sq_dot_folded(qs, qlo, _t(codes)).numpy()
    args = tuple(jnp.asarray(a) for a in (q, codes, lo, delta))
    tol = dot_tol(_norm(qs.numpy()), _norm(codes), d,
                  float(qlo.abs().max()))
    assert port.shape == (m, n) and port.dtype == np.float32
    for other in (sq_dot(*args, interpret=True), sq_dot_ref(*args),
                  folded):
        np.testing.assert_allclose(port, np.asarray(other), rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("m,n,c,d", [(7, 1000, 8, 16), (3, 513, 3, 24)])
def test_gleanvec_ip_plain_matches_pallas_and_ref(m, n, c, d):
    rng = _rng(n + c + d)
    qv = rng.standard_normal((m, c, d)).astype(np.float32)
    tags = rng.integers(0, c, n).astype(np.int32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    port = K.gleanvec_ip(_t(qv), _t(tags), _t(x)).numpy()
    args = tuple(jnp.asarray(a) for a in (qv, tags, x))
    tol = dot_tol(_norm(qv), _norm(x), d)
    for other in (gleanvec_ip(*args, tm=4, tn=128, interpret=True),
                  gleanvec_ip_ref(*args)):
        np.testing.assert_allclose(port, np.asarray(other), rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("m,n,c,d,u8,lb", [
    (7, 1000, 8, 16, True, 0),      # gathered, ragged N
    (5, 513, 3, 16, False, 0),      # gathered f32
    (6, 1280, 4, 16, True, 128),    # sorted, one view per block
    (4, 640, 5, 24, False, 64),     # sorted f32, block under the tile
])
def test_gleanvec_sq_dense_plain_matches_pallas_and_ref(m, n, c, d, u8, lb):
    rng = _rng(n * 3 + c + lb)
    q_scaled, q_lo, codes, _ = _sq_case(rng, m, n, c, d, u8, False)
    tags = rng.integers(0, c, n // lb if lb else n).astype(np.int32)
    port = K.gleanvec_sq(_t(q_scaled), _t(q_lo), _t(tags), _t(codes),
                         layout_block=lb).numpy()
    args = tuple(jnp.asarray(a) for a in (q_scaled, q_lo, tags, codes))
    pallas = gleanvec_sq(*args, layout_block=lb, tm=4, tn=128,
                         interpret=True)
    ref = gleanvec_sq_sorted_ref(*args, lb) if lb else gleanvec_sq_ref(*args)
    tol = dot_tol(_norm(q_scaled), _norm(codes), d, float(np.abs(q_lo).max()))
    for other in (pallas, ref):
        np.testing.assert_allclose(port, np.asarray(other), rtol=0,
                                   atol=tol)


def test_cpu_wrappers_count_no_launches():
    before = (K.ip_topk.launches, K.gleanvec_sq_topk.launches,
              K.kmeans_assign.launches, K.ivf_scan_topk.launches,
              K.sq_dot.launches, K.gleanvec_ip.launches,
              K.gleanvec_sq.launches)
    K.ip_topk(torch.randn(2, 4), torch.randn(9, 4), 3)
    K.gleanvec_sq_topk(torch.randn(2, 3, 4), torch.zeros(2, 3),
                       torch.zeros(9, dtype=torch.int32), torch.randn(9, 4), 3)
    K.kmeans_assign(torch.randn(9, 4), torch.randn(3, 4))
    K.ivf_scan_topk(torch.randn(2, 3, 4), torch.zeros(2, 3),
                    torch.zeros(3, dtype=torch.int32),
                    torch.arange(9, dtype=torch.int32), torch.randn(9, 4),
                    torch.tensor([[0, 2], [1, -1]], dtype=torch.int32), 3, 3)
    K.sq_dot(torch.randn(2, 4), torch.zeros(9, 4, dtype=torch.uint8),
             torch.zeros(4), torch.ones(4))
    K.gleanvec_ip(torch.randn(2, 3, 4), torch.zeros(9, dtype=torch.int32),
                  torch.randn(9, 4))
    K.gleanvec_sq(torch.randn(2, 3, 4), torch.zeros(2, 3),
                  torch.zeros(3, dtype=torch.int32), torch.randn(9, 4),
                  layout_block=3)
    assert (K.ip_topk.launches, K.gleanvec_sq_topk.launches,
            K.kmeans_assign.launches, K.ivf_scan_topk.launches,
            K.sq_dot.launches, K.gleanvec_ip.launches,
            K.gleanvec_sq.launches) == before


def test_fine_step_bytes_matches_reference():
    from repro.kernels import fine_step_bytes as ref_bytes
    from repro_torch.kernels.ivf_scan import fine_step_bytes
    for args in [(1024, 12000, 4096, 160, 48, 1, 100), (3, 7, 64, 16, 8, 4,
                                                        10)]:
        assert fine_step_bytes(*args) == ref_bytes(*args)




_TOP3 = [5.0, 4.0, 4.0 - 1e-6]          # ids 2 and 9 are a near-tie


@pytest.mark.parametrize("ids,agree", [
    ([7, 2, 9], True),                  # the same result
    ([2, 9, 7], False),                 # ids rotated against their values
    ([2, 7, 9], False),                 # two ids swapped
    ([7, 9, 2], True),                  # the near-tie swapped, within tol
], ids=["same", "rotated", "swapped", "near-tie"])
def test_topk_comparator_checks_value_id_pairs(ids, agree):
    """Right ids and right values paired wrongly (a shifted merge or
    write-back) must fail the comparator the kernels are held to."""
    from repro_torch.testing import topk_agreement
    vals = np.array([_TOP3], np.float32)
    res = topk_agreement((vals, np.array([ids])), (vals, np.array([[7, 2, 9]])),
                         2e-6)
    assert res["ok"] is agree
