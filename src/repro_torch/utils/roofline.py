"""Three-term roofline model on NVIDIA H100 (port of the reference's
``repro/utils/roofline.py``, whose only hardware is a TPU v5e).

    compute    = sum over dtypes of flops(dtype) / peak(dtype)
    memory     = max(2 x write_bytes, bytes accessed) / HBM bandwidth
    collective = sum over collectives of bytes / the link its group uses

Every quantity is per device: a record of ``launch/dryrun.py`` divides or
traces per device before it gets here, so the terms are per-device step
times already.

The numbers of :data:`H100` are NVIDIA's data sheet for the H100 SXM5 80GB
HBM3 (dense rates, no sparsity, at the full 700 W power limit), not
measured: 989.4 TFLOP/s bf16 / fp16 on the tensor cores, 66.9 TFLOP/s
fp32 outside them (TF32 stays off, as the port's parity rules say), HBM3
at 3.35 TB/s and 80 GB, 132 SMs; fourth-generation NVLink at 900 GB/s a
GPU, 450 GB/s each way, within a node of 8 GPUs (NVSwitch); across nodes
one 400 Gb/s NIC a GPU (ConnectX-7), 50 GB/s. ``chip_smoke.py``'s phase 3p holds
the terms against steps measured on the card.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Optional

__all__ = ["HWSpec", "H100", "V5E", "RooflineTerms", "compute_terms",
           "collective_link_bw"]

_HALF = ("bfloat16", "float16")


@dataclass(frozen=True)
class HWSpec:
    """``peak_flops`` the bf16 / fp16 rate, ``peak_flops_f32`` every other
    dtype's; ``ici_bw`` a collective inside one node of ``node_size``
    consecutive ranks (NVLink on the H100, an ICI link on the v5e),
    ``net_bw`` one across nodes; ``hbm_bytes`` the device memory,
    ``n_sms`` its streaming multiprocessors (cores)."""

    peak_flops: float = 989.4e12
    peak_flops_f32: float = 66.9e12
    hbm_bw: float = 3.35e12
    ici_bw: float = 450e9
    net_bw: float = 50e9
    hbm_bytes: float = 80e9
    node_size: int = 8
    n_sms: int = 132

    def peak_for(self, dtype: str) -> float:
        """The peak FLOP/s of products in ``dtype`` (a torch dtype's name
        without the ``torch.`` prefix)."""
        return self.peak_flops if dtype in _HALF else self.peak_flops_f32


H100 = HWSpec()
# The reference's v5e, with one peak for every dtype and one link.
V5E = HWSpec(peak_flops=197e12, peak_flops_f32=197e12, hbm_bw=819e9,
             ici_bw=50e9, net_bw=50e9, hbm_bytes=16e9, node_size=1 << 30,
             n_sms=1)


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float                # per device
    hlo_bytes: float                # per device
    collective_bytes: float         # per device
    raw_cost_flops: float           # the record's ``cost`` flops
    raw_cost_bytes: float
    model_flops_total: float        # analytic 6ND-style, whole step, all chips
    n_chips: int
    useful_flops_ratio: float       # MODEL_FLOPS / (flops * chips)
    bottleneck: str
    bound_s: float
    peak_fraction: float            # useful model FLOP/s / peak, at bound_s

    def to_dict(self) -> Dict:
        return asdict(self)


def collective_link_bw(ranks, hw: HWSpec = H100) -> float:
    """The bandwidth a collective over the global ``ranks`` runs at:
    ``hw.ici_bw`` when they all lie in one node of ``hw.node_size``
    consecutive ranks, else ``hw.net_bw``."""
    nodes = {r // hw.node_size for r in ranks}
    return hw.ici_bw if len(nodes) <= 1 else hw.net_bw


def compute_terms(cost: Dict[str, float], hlo_stats: Dict,
                  model_flops_total: float, n_chips: int,
                  hw: HWSpec = H100,
                  flop_correction: Optional[float] = None) -> RooflineTerms:
    """Build the three terms from per-device counts.

    ``cost``: ``flops`` and ``bytes accessed`` (raw counts, a floor).
    ``hlo_stats``: ``dot_flops`` and ``write_bytes`` (the products' flops
    and the bytes the step's ops write), ``collective_bytes``. Two keys
    refine them where present: ``dot_flops_by_dtype`` ({dtype name:
    flops}, each at ``hw.peak_for(dtype)``; without it every flop runs at
    ``hw.peak_flops``) and ``collectives`` (a list of {``bytes``,
    ``ranks``}, each over ``collective_link_bw(ranks)``; without it
    ``collective_bytes`` runs at ``hw.ici_bw``). With :data:`V5E` and the
    reference's dicts this is the reference's ``compute_terms``.
    ``peak_fraction`` takes the step's own mix of peaks: flops over the
    compute term."""
    raw_flops = float(cost.get("flops", 0.0))
    raw_bytes = float(cost.get("bytes accessed", 0.0))
    dot = float(hlo_stats.get("dot_flops", 0.0))
    flops = max(dot, raw_flops)
    bytes_ = max(2.0 * float(hlo_stats.get("write_bytes", 0.0)), raw_bytes)
    coll = float(hlo_stats.get("collective_bytes", 0.0))

    by_dtype = hlo_stats.get("dot_flops_by_dtype")
    if by_dtype:
        compute_s = sum(float(f) / hw.peak_for(dt)
                        for dt, f in by_dtype.items()) \
            + (flops - dot) / hw.peak_flops
    else:
        compute_s = flops / hw.peak_flops
    colls = hlo_stats.get("collectives")
    if colls is not None:
        collective_s = sum(float(c["bytes"]) / collective_link_bw(
            c["ranks"], hw) for c in colls)
    else:
        collective_s = coll / hw.ici_bw
    memory_s = bytes_ / hw.hbm_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    bound_s = terms[bottleneck]
    useful = model_flops_total / max(flops * n_chips, 1.0)
    peak = flops / compute_s if by_dtype and compute_s > 0 \
        else hw.peak_flops
    peak_fraction = (model_flops_total / max(bound_s, 1e-12)
                     / (n_chips * peak))
    return RooflineTerms(
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        hlo_flops=flops, hlo_bytes=bytes_, collective_bytes=coll,
        raw_cost_flops=raw_flops, raw_cost_bytes=raw_bytes,
        model_flops_total=model_flops_total, n_chips=n_chips,
        useful_flops_ratio=useful, bottleneck=bottleneck, bound_s=bound_s,
        peak_fraction=peak_fraction)
