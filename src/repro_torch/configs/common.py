"""Shape table of the recsys cells, as ``repro.configs.common``.

The LM and GNN shape tables wait for their models.
"""

RECSYS_SHAPES = {
    "train_batch":    {"kind": "recsys_train", "batch": 65536},
    "serve_p99":      {"kind": "recsys_serve", "batch": 512},
    "serve_bulk":     {"kind": "recsys_serve", "batch": 262144},
    "retrieval_cand": {"kind": "recsys_retrieval", "batch": 1,
                       "n_candidates": 1_000_000, "k": 100},
}
