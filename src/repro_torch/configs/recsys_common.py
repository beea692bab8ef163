"""Shared shape set of the recsys architectures (the port's copy of the
reference's ``repro/configs/recsys_common.py``)."""
RECSYS_SHAPES = {
    "train_batch": {"kind": "recsys_train", "batch": 65536},
    "serve_p99": {"kind": "recsys_serve", "batch": 512},
    "serve_bulk": {"kind": "recsys_serve", "batch": 262144},
    "retrieval_cand": {"kind": "recsys_retrieval", "batch": 1,
                       "n_candidates": 1_000_000},
}
