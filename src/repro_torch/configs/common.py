"""Shape tables of the LM and recsys cells, as ``repro.configs.common``.

The GNN shape table waits for its models.
"""

# LM-family transformers: seq_len × global_batch per the assignment block.
LM_SHAPES = {
    "train_4k":    {"kind": "lm_train",   "seq": 4096,    "batch": 256},
    "prefill_32k": {"kind": "lm_prefill", "seq": 32768,   "batch": 32},
    "decode_32k":  {"kind": "lm_decode",  "seq": 32768,   "batch": 128},
    # long_500k is a DECODE shape: one new token against a 524,288-entry KV
    # cache — linear per-token cost, so full-attention archs run it too.
    "long_500k":   {"kind": "lm_decode",  "seq": 524288,  "batch": 1},
}

RECSYS_SHAPES = {
    "train_batch":    {"kind": "recsys_train", "batch": 65536},
    "serve_p99":      {"kind": "recsys_serve", "batch": 512},
    "serve_bulk":     {"kind": "recsys_serve", "batch": 262144},
    "retrieval_cand": {"kind": "recsys_retrieval", "batch": 1,
                       "n_candidates": 1_000_000, "k": 100},
}
