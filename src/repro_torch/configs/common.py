"""Shape tables of the LM, GNN and recsys cells, as
``repro.configs.common``."""

# LM-family transformers: seq_len × global_batch per the assignment block.
LM_SHAPES = {
    "train_4k":    {"kind": "lm_train",   "seq": 4096,    "batch": 256},
    "prefill_32k": {"kind": "lm_prefill", "seq": 32768,   "batch": 32},
    "decode_32k":  {"kind": "lm_decode",  "seq": 32768,   "batch": 128},
    # long_500k is a DECODE shape: one new token against a 524,288-entry KV
    # cache — linear per-token cost, so full-attention archs run it too.
    "long_500k":   {"kind": "lm_decode",  "seq": 524288,  "batch": 1},
}

# GNN shapes.  Node/edge counts padded to 512-divisible (mesh-shardable)
# sizes with edge pads chosen divisible by the edge-chunk.
GNN_SHAPES = {
    "full_graph_sm": {"kind": "gnn_train", "n_nodes": 2708, "n_edges": 10556,
                      "d_feat": 1433, "n_classes": 7,
                      "pad_nodes": 3072, "pad_edges": 12288,
                      "edge_chunk": 4096, "task": "node_class"},
    "minibatch_lg": {"kind": "gnn_train", "n_nodes": 169984,
                     "n_edges": 168960, "d_feat": 602, "n_classes": 41,
                     "pad_nodes": 169984, "pad_edges": 172032,
                     "edge_chunk": 8192, "task": "node_class",
                     "sampled": True, "batch_nodes": 1024,
                     "fanout": (15, 10), "full_nodes": 232965,
                     "full_edges": 114615892},
    "ogb_products": {"kind": "gnn_train", "n_nodes": 2449029,
                     "n_edges": 61859140, "d_feat": 100, "n_classes": 47,
                     "pad_nodes": 2449408, "pad_edges": 61865984,
                     "edge_chunk": 65536, "task": "node_class"},
    "molecule": {"kind": "gnn_train", "n_nodes": 3840, "n_edges": 8192,
                 "d_feat": 16, "n_classes": 1,
                 "pad_nodes": 4096, "pad_edges": 8192,
                 "edge_chunk": 8192, "task": "energy_force",
                 "batch_graphs": 128, "nodes_per": 30, "edges_per": 64},
}

RECSYS_SHAPES = {
    "train_batch":    {"kind": "recsys_train", "batch": 65536},
    "serve_p99":      {"kind": "recsys_serve", "batch": 512},
    "serve_bulk":     {"kind": "recsys_serve", "batch": 262144},
    "retrieval_cand": {"kind": "recsys_retrieval", "batch": 1,
                       "n_candidates": 1_000_000, "k": 100},
}
