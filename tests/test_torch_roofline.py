"""The port's roofline model (``repro_torch/utils/roofline.py``): with a
one-peak spec of v5e's numbers it is the reference's ``compute_terms``
field for field; on the H100 spec it charges flops by dtype and each
collective by the link its group uses. Exact: the same float operations."""
import pytest

from repro.utils import roofline as ref
from repro_torch.utils import roofline

CASES = [
    ({"flops": 1e12, "bytes accessed": 1e9},
     {"dot_flops": 2e12, "write_bytes": 1e12, "collective_bytes": 1e10},
     1e14, 256),
    ({"flops": 5e12, "bytes accessed": 3e12},
     {"dot_flops": 1e12, "write_bytes": 1e9, "collective_bytes": 0.0},
     2e13, 512),
    ({}, {"dot_flops": 3e15, "write_bytes": 2e10,
          "collective_bytes": 4e12}, 7e17, 1),
    ({"flops": 0.0}, {}, 0.0, 16),
]


@pytest.mark.parametrize("cost,stats,model_flops,n", CASES)
def test_v5e_spec_gives_the_reference_terms(cost, stats, model_flops, n):
    got = roofline.compute_terms(cost, stats, model_flops, n, roofline.V5E)
    want = ref.compute_terms(cost, stats, model_flops, n)
    assert got.to_dict() == want.to_dict()


def test_h100_charges_flops_by_dtype():
    h = roofline.H100
    assert (h.peak_flops, h.peak_flops_f32) == (989.4e12, 66.9e12)
    assert (h.hbm_bw, h.hbm_bytes, h.ici_bw, h.net_bw) == (
        3.35e12, 80e9, 450e9, 50e9)
    stats = {"dot_flops": 2e12, "write_bytes": 0.0,
             "dot_flops_by_dtype": {"bfloat16": 1e12, "float32": 1e12}}
    t = roofline.compute_terms({"flops": 2e12}, stats, 2e12, 1)
    assert t.compute_s == 1e12 / 989.4e12 + 1e12 / 66.9e12
    assert t.bottleneck == "compute"
    # the f32 half costs ~15x the bf16 half; one peak would charge both
    # at the bf16 rate
    one = roofline.compute_terms({"flops": 2e12}, {"dot_flops": 2e12},
                                 2e12, 1)
    assert t.compute_s > 7 * one.compute_s
    # the step's own peak: all its flops over the compute term
    assert t.peak_fraction == pytest.approx(1.0)


@pytest.mark.parametrize("ranks,link", [
    ([0, 1, 2, 3, 4, 5, 6, 7], 450e9), ([8, 15], 450e9),
    (list(range(16)), 50e9), ([0, 8], 50e9), ([7, 8], 50e9),
    ([100], 450e9)])
def test_collectives_take_nvlink_within_a_node(ranks, link):
    assert roofline.collective_link_bw(ranks) == link
    stats = {"collective_bytes": 9e9,
             "collectives": [{"bytes": 9e9, "ranks": ranks}]}
    t = roofline.compute_terms({}, stats, 0.0, 16)
    assert t.collective_s == 9e9 / link and t.collective_bytes == 9e9


def test_collectives_add_up_by_group():
    stats = {"collective_bytes": 3e9, "collectives": [
        {"bytes": 1e9, "ranks": list(range(8))},
        {"bytes": 2e9, "ranks": list(range(0, 256, 16))}]}
    t = roofline.compute_terms({}, stats, 0.0, 256)
    assert t.collective_s == 1e9 / 450e9 + 2e9 / 50e9
    assert t.bottleneck == "collective"
