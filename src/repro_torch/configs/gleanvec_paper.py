"""The paper's own workload: GleanVec learning + multi-step search over the
Table-1 scale datasets (OI-13M / RQA-10M / T2I-10M shapes). The port's
copy of the reference's ``repro/configs/gleanvec_paper.py``.

learn  -- Algorithm 5 (spherical k-means, the query moment, per-cluster
          moments and fits) over the whole database.
search -- Algorithm 1 with eager GleanVec scoring (Algorithm 4): the
          reduced scan (gathered, or over the tag-sorted layout) and the
          full-precision rerank.
"""
ARCH_ID = "gleanvec-paper"
FAMILY = "vectorsearch"
SHAPES = {
    "learn_oi13m": {"kind": "vs_learn", "n": 13_000_000, "D": 512,
                    "d": 160, "C": 48, "m_queries": 10_000},
    "search_oi13m": {"kind": "vs_search", "n": 13_000_000, "D": 512,
                     "d": 160, "C": 48, "batch": 1024, "k": 10,
                     "kappa": 100},
    "search_oi13m_sorted": {"kind": "vs_search_sorted", "n": 13_000_000,
                            "D": 512, "d": 160, "C": 48, "batch": 1024,
                            "k": 10, "kappa": 100},
    "search_rqa10m": {"kind": "vs_search", "n": 10_000_000, "D": 768,
                      "d": 160, "C": 48, "batch": 1024, "k": 10,
                      "kappa": 100},
    "search_t2i10m": {"kind": "vs_search", "n": 10_000_000, "D": 200,
                      "d": 192, "C": 48, "batch": 1024, "k": 10,
                      "kappa": 100},
}
SKIPS = {}


def make_config(smoke: bool = False):
    return {"smoke": smoke}
