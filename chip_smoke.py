#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py [--seed 0] [--docs 1114112]

Drives the port's main path on one CUDA card at the size of one 8-way
shard of the paper's MS MARCO deployment (``serve_msmarco``: n=30,000,
m=64, h=1, max_nnz=128, k=10; 8,912,896 docs / 8 = 1,114,112 slots):

1. device   — the card's name, count and power limit;
2. build    — the six CUDA kernels from ``src/repro_torch/kernels/csrc``
              (one nvcc per source, started together), with ptxas's
              registers and shared memory, and kernel C's registers and
              spills per instance (cell type x tile words);
3. kernels  — each kernel against its plain twin on the card, at the main
              paths' shapes: kernel A + merge bit-equal to the twin + merge
              and kernel C bit-equal to its twin (bf16 and f8 cells, signed
              queries, padded coordinates); kernel B's dense-query forms
              (``csr_score``: rerank and LinScan) within rtol = atol = 1e-5
              (the sum order differs); its sparse-query rerank with top-k
              (``csr_rerank_topk``) with ids and slots equal to its twin's
              and scores within rtol = atol = 1e-5, and bit-equal on an
              integer-valued batch full of ties; kernel D
              bit-equal to its twin (f32 and bf16 tables, D in {18, 64},
              F in {1, 4, 40}, pads, signed weights, and ``mean``), and its
              stacked form (26 fields, hot 1 and 4, weights and none)
              into rows 1.. of a [512, 27, 64] buffer, row 0 untouched;
4. main     — the fused path: ``open_index`` + ``insert_many`` of the
              shard, ``delete_many`` of 1/16 of it and re-insert into the
              dirty slots, serve batches of 16 and 256 through
              ``QueryServer.query_many`` (k=10, k'=800), one staged batch;
              kernel-path ids == plain-twin ids; recall@10 against kernel
              B's exact LinScan, at least ``RECALL_MIN``; a small index
              whose answer must equal the exact top-10; kernel B's LinScan
              launches for the recall ground truth;
4b. dense   — the same index served through the ``score_fn`` hook
              (``ops.make_engine_score_fn()``: kernel C + ``topk_desc``),
              20 batches of 16: candidates bit-equal to the on-card
              ``reference`` backend, ids equal to the fused path's, recall@10
              at least ``RECALL_MIN``;
5. times    — CUDA-event times of each kernel and its twin, the library
              yardstick for the LinScan (one torch.sparse CSR mat-vec), the
              rerank kernel beside the route it replaced (densify +
              ``csr_score`` + gate + ``topk_desc`` + gathers) on the same
              candidates at B=256 and B=16, against the sparse-query bound
              and the old dense-query one,
              request latency p50/p99 (the wall time of each ``query_many``
              batch: every request of a batch waits for all of it) and
              throughput in queries/s of both paths; the dense request at
              B=16 split into operand prep, kernel C, the gate, topk_desc
              over 16 x C keys and B's rerank; candidate selection in one
              pass (kernel A over every tile + the merge) beside the two
              passes (a sample of every s-th tile, then kernel A's
              threshold form) at B=256 and B=16, bit-equal, and the
              threshold form alone beside its twin and its bound;
4c. eval    — run after 5, once the served index is freed: the paper's
              evaluation path (``repro_torch.eval``) on the same 1,114,112
              documents and 256 queries: the recall frontier over three
              lever points with the Eq. (13) bound check (no Theorem 5.1
              undershoot beyond the quantization margin), and the
              churn -> compact drift trajectory on a sample (compaction must
              return the drift to 0);
4d. durable — the same documents through ``open_index(IndexConfig(...,
              durability=DurabilityConfig(wal_dir, snapshot_dir, fsync=True,
              snapshot_keep=1)))`` under ``build/``: logged and applied in
              batches of 32,768 (each batch copied to the host, appended
              and fsync'd before it is applied), a snapshot (~5.33 GB:
              the 4.18 GB bitmap, 285 MB sketch, 855 MB store; the WAL it
              covers is pruned), a WAL tail of phase 4's churn (one batched
              delete of every 16th doc, their re-insert into the dirty
              slots, a logged ``compact()``), then the index is dropped and
              a new one recovered from snapshot + tail: every state leaf,
              the free list and the id map bit-equal to the live index's,
              256 queries (k=10, k'=800, fused) giving its ids and scores
              bit for bit, kernel A and B's rerank kernel launched on the
              recovered index and C, D and the LinScan not.  Prints the
              WAL append rate with fsync, WAL and snapshot bytes, the
              snapshot's seconds (device-to-host, write), the recovery's
              (manifest + npz read, host-to-device, tail replay), the
              recovered index's first-batch and p50 latency at B=256 and
              the phase's wall time; fails loudly when the disk is short;
6a. recsys  — DLRM-rm2 (``repro_torch.configs.dlrm_rm2.full_config()``:
              26 × 1,000,000 × 64 f32 tables, 6.66 GB, drawn on the card
              from ``--seed``) served through ``models.recsys``: 1,000
              batches at ``serve_p99`` (B=512; p99 then has 10 samples
              beyond it) and 5 at ``serve_bulk`` (B=262,144) through
              ``score``, 1,000 ``retrieval_cand`` requests (B=1,
              ``retrieval_scores`` + top-100); request latency p50/p99 (the
              features copied to the card, the forward, the result copied
              back), samples/s and, under torch.profiler, the device busy
              share and the largest kernels of each request kind; logits
              finite, kernel-path logits and bags bit-equal to the twin
              path's (indices past row 8,388,607: 64-bit offsets), kernel D
              once per forward and A, B (both forms), C never; kernel D's
              stacked form (one launch from the request's indices into
              rows 1.. of the [B, 27, 64] interaction buffer) beside the
              route it replaced (field-offset operands,
              the flat form with a ones weight tensor, ``torch.cat``), its
              flat form against its twin on the flattened 6.66 GB table, the
              byte bounds and ``F.embedding_bag``; at B=512 the wrapper's
              host-time split, the forward's device kernels and its host
              time issued without a sync; the forward's time against its
              f32 FLOP bound and, at B=262,144, the device memory it
              allocates;
6b. recsys retrieval — the item catalog (field 0's 1,000,000 rows)
              sparsified to its top-16 |value| coordinates in a Sinnamon
              index (n=64, m=8, h=1, f32 raw values), 256 users'
              ``user_repr`` served through ``search_many`` (k=10, k'=200):
              recall@10 against the dense exact top-10 (the cost of
              sparsifying) and against the exact sparse top-10 (kernel B's
              LinScan); kernel-path ids == twin-path ids; A and B's rerank
              kernel launch.
9.  sharded — after 4d, with phase 4's index and corpus freed: 4 of
              ``serve_msmarco``'s 8 shards (1,114,112 slots each, 4,456,448
              documents drawn on the card) in one ``ShardedSinnamonIndex``
              on this card (cut: 8 shards would hold ≈42.8 GB of state);
              shard 0 bit-equal to a lone index fed its documents; 1/16 of
              each shard churned; batches of 16 and 256 at k' = 800 and at
              the deployment's 64: p50/p99, q/s, kernel A and B's rerank
              launched 4 times a batch; recall@10 against the LinScan's
              exact top-10 (at least ``RECALL_MIN`` at k'=800); kernel-path
              ids == twin-path ids; the ``score_fn`` hook's candidates
              bit-equal to the on-card ``reference`` backend; each shard's
              candidate and rerank time and the merge's; the busy share at
              B=16.  9b: 4 shards × 65,536 documents in the tiered sharded
              index (48 and 6 MiB a shard) bit-equal to the resident one
              before and after churn + compact, and in the durable sharded
              index (fsync) recovered bit-equal onto 4 shards, then
              elastically onto 2 and onto one device, equal to fresh
              builds.
              Peak device memory stays < 40 GB.
10. train   — after 6a/6b, every earlier index and model freed: recsys
              training.  10a: dlrm-rm2 at full width (26 × 1,000,000 × 64
              f32 tables) at ``train_batch`` (B=65,536, batches from
              ``loaders.recsys_batch`` on the host): kernel D's backward
              (``embed_bag_backward`` on rows 1.. of the [B, 27, 64]
              buffer's gradient) bit-equal to its twin on the host copy
              and to a second launch, with its time, the sort's, the
              kernel's alone on prepared operands (and with every slot a
              pad: the writes alone), ``torch.zeros`` of the output (the
              card's write rate for it), the twin's on the card,
              ``index_add_`` into zeros, the byte bound and the kernel's
              share of it; a twin-path step (``use_kernel=False``) against
              the kernel path's first step from the same drawn state (loss
              within rtol 1e-5, parameters within rtol 1e-5 / atol 1e-6);
              ``train.loop.make_train_step`` with the launcher's AdamW for
              one warm-up and 8 timed steps (wall p50 / max, samples/s,
              losses and grad norms finite, D and its backward once a
              step), a CUDA-event split of one more step (forward,
              backward with D's backward, clip + AdamW), peak memory < 40
              GB.  10b: din, sasrec and mind at full config: 3 train steps
              at B=65,536 (walls, losses, peak memory), 200 ``score``
              requests at B=512 and 200 ``retrieval_scores`` + top-100 at
              B=1 (p50 / p99 from host features to host results).  10c:
              dlrm-rm2 at full widths with 65,536 rows a field (cut from
              1,000,000): 6 straight steps against 3 + a train-state
              checkpoint under ``build/`` + restore + 3 (parameters within
              rtol 1e-5; bitwise reported).
11. lm      — after 10, every earlier model freed: the LM family (no
              kernel; cuBLAS's reduced-precision bf16 reduction off, timed
              on and off first).  11a: stablelm-12b at full width and all
              40 layers, bf16 weights drawn on the card (24.3 GB), a
              prefill of 32,736 tokens, its cache copied into a
              32,768-position ``init_cache``, 32 decode steps, one step
              under torch.profiler; one ``forward`` over the 32,768 tokens
              whose f32 logits at the prefill's and every decode step's
              position must match theirs (``LM_LOGIT_TOL``); prefill
              tokens/s and decode p50/p99 beside their bounds, peak memory.
              11b: moonshot-v1-16b-a3b at full width, 4 of 48 layers, a
              28,672-token prompt (whole groups of 4,096), the same checks
              (``LM_MOE_WITHIN`` of the decode positions: a route near a
              tie may flip), the tokens each expert kept and the choices
              dropped.  11c: 2 stablelm layers at full width trained at
              2 x 4,096 tokens with f32 parameters and the launcher's
              AdamW (a warm-up and 3 timed steps, a CUDA-event split,
              losses and grad norms finite).  11d: ``launch.train`` for
              the five LM archs' smoke configs, 12 steps with a checkpoint
              under ``build/``, then ``--resume``.
12. gnn     — after 11, every earlier model freed: the GNN family
              (equiformer-v2: 12 layers, c=128, l_max=6, m_max=2, 8 heads;
              f32 weights drawn on the card, graphs on the host from
              ``--seed``; no kernel; TF32 off, asserted).  12a
              ``full_graph_sm`` (``random_geometric_graph`` of 2,708 nodes
              and 10,556 edges padded to 3,072 / 12,288, 1,433 features, 7
              classes) and 12b ``molecule`` (``molecule_batch`` of 128
              molecules of 30 atoms and 64 edges, energy + forces), each
              at full width and depth: ``make_train_step`` with the
              launcher's AdamW, one warm-up and 3 timed steps (wall p50 /
              max, nodes/s beside the edge-path FLOP bound, losses and
              grad norms finite), a CUDA-event split of one more (forward,
              backward, clip + AdamW), the busy share and largest kernels
              of a step under torch.profiler, peak memory; then, forward
              only on the trained weights, the reference's properties at
              full width (``GNN_INVARIANT_TOL`` / ``GNN_EQUIVARIANT_TOL``:
              l = 0 outputs and energies invariant, l = 1 rows and forces
              rotating with D₁(R) under a rotation of ``edge_vec``;
              ``GNN_ORDER_TOL``: padded edges' payloads inert, ``edge_chunk``
              halved, a second forward, reported bit-equal or not), and on
              12a the edge loop's hand-written backward against autograd
              through the reference's form of the loop.  12c
              ``minibatch_lg``: the port's ``NeighborSampler`` over a
              synthetic graph of Reddit's 232,965 nodes × 602 features and
              41 classes with each in-degree cut to 50, 1,024 seeds at
              fanout (15, 10) padded to 169,984 nodes / 172,032 edges;
              ``predict`` at all 12 layers without gradients (walls,
              nodes/s, the FLOP and accumulator-byte bounds, one chunk's
              accumulator rescale and scatter timed alone, one layer's
              busy share, peak), then training at full width with the
              deepest layer count whose peak, extrapolated from 1- and
              2-layer steps, stays under 39 GB.  12d: ``launch.train
              --arch equiformer-v2``, 12 steps with a checkpoint under
              ``build/`` at step 10, then ``--resume``.
13. mesh    — after 12: the mesh tooling.  13a: the dry run
              (``launch/dryrun.py``) of ``MESH_CELLS`` on the 16x16 and
              2x16x16 production meshes, one subprocess a cell and mesh
              (a fake process group of 256 / 512 ranks each; the GNN's
              ``ogb_products`` cell, whose one-device node tensor is
              61.5 GB, as two, its 1- and 2-layer traces, extrapolated
              to 12 layers), side by side on the host's cores: bytes,
              FLOPs and collectives a device with H100 constants, and
              the cells above 80 GB a device (the GNN cell above it
              fails the run).  13b: dlrm-rm2 ``serve_p99`` and ``train_batch``
              dry-run on a 1x1 mesh against phases 6a and 10a: state bytes
              equal to the card's exactly, the peak, FLOP and roofline-time
              ratios printed.  13c: a one-device ``cuda`` mesh (gloo over
              ``tcp://localhost``, world 1): the mesh search step on a
              65,536-document index (B=16), the DLRM B=512 forward, a
              2-layer stablelm decode step and the GNN ``full_graph_sm``
              forward (``index_add_`` deterministic) bit-equal to
              ``mesh=None``, launching the same kernels
              (``launches_mesh``).
14. gnn mesh — on the card while 13a's traces finish: the sharded GNN
              (``models/gnn_sharded.py``) on a one-rank ``cuda`` mesh
              (gloo, world 1).  14a: equiformer-v2 at full width and
              depth (12 layers, c=128, l_max=6, H=8) on ``full_graph_sm``
              and ``molecule`` through ``loss_fn_sharded`` against
              ``gnn.loss_fn`` on the same weights and graph (the loss and
              every gradient leaf within 1e-4 of scale), a train step of
              each path timed side by side, the sharded loss + backward's
              peak.  14b: 3 ``full_graph_sm`` steps of
              ``make_train_step(compress_axis="pod")``: the residual
              bit-equal to the host's quantisation of the same gradients,
              the parameters within 1e-6 of the host's AdamW.  No kernel
              launches (``launches_gnn_mesh``).

Launch counts are read per path: kernel A and B's rerank kernel
(``csr_rerank_topk``) must launch on the fused path, C and the rerank
kernel on the dense path (and A not at all there), D on neither, and
``csr_score`` on none of them (it launches for the recall ground truth); D
alone on the recsys path; A and the rerank kernel on the recsys
retrieval; A and the rerank kernel (``launches_durable``) on the recovered
durable index; A and the rerank kernel once a shard per batch
(``launches_sharded``) on the sharded index; D and its backward once a
step (``launches_train``, and ``launches`` of the backward's row) on the
DLRM train steps, no kernel on DIN / SASRec / MIND, the LM path
(``launches_lm``), the GNN path (``launches_gnn``) or the sharded GNN
(``launches_gnn_mesh``).  Ends with JSON lines of the recsys, durability,
front-door, tiered, sharded, train, lm, gnn, mesh and gnn_mesh numbers, a JSON line of per-kernel numbers, the card's ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.  Any failed phase raises, so the script
exits non-zero and prints no result; so does a machine without CUDA or a
directory without the package.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM (NVIDIA data sheet)
F32_OPS_PER_S = 67e12              # f32 outside the tensor cores

N, M, H, P, K, KPRIME = 30_000, 64, 1, 128, 10, 800
SHARD_DOCS = 8_912_896 // 8
PSI_DOC, PSI_QUERY, Q_PAD = 119, 43, 64     # splade_like (synth.py:44)
RECALL_MIN = 0.95                           # recall@10 limit of PERF.md §2
PEAK_MEMORY_MAX = 40e9                      # device-memory limit of PERF.md §2
#: the run's peak device memory before a phase reset the counter to read its
#: own peak
_PEAK_BEFORE_RESET = [0]
DENSE_BATCHES = 20                          # phase 4b: batches of 16
CHURN_DOCS = 65_536                         # phase 4c: churn sample
DURABLE_BATCH = 32_768                      # phase 4d: docs per logged batch
DURABLE_BATCHES = 20                        # phase 4d: timed B=256 batches
#: free disk phase 4d needs: WAL (~1.15 GB) + snapshot (~5.33 GB) + margin
DURABLE_DISK_BYTES = 8 * 10**9
P99_BATCHES, BULK_BATCHES, RETRIEVAL_REQUESTS = 1000, 5, 1000  # phase 6a
ITEM_NNZ, ITEM_M, ITEM_KPRIME, USERS = 16, 8, 200, 256      # phase 6b


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Host-clock ms per call of ``fn`` over ``reps`` calls issued without a
    sync: the caller's own time per launch while the card keeps up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return t


def device_profile(fn, calls: int):
    """(wall ms per call, {kernel name: device ms per call}) over ``calls``
    calls of ``fn`` under ``torch.profiler`` (CUDA activity only).  An
    empty dict means the profiler saw no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    by_name = {e.key: e.self_device_time_total / 1e3 / calls
               for e in prof.key_averages() if e.self_device_time_total > 0}
    return wall, by_name


def busy_summary(wall: float, by_name: dict, top: int = 5) -> dict:
    """Device busy share of a profiled window and its largest kernels (by
    the first 80 characters of their names, which many templated kernels
    share: their times are summed)."""
    busy = sum(by_name.values())
    short = {}
    for k, v in by_name.items():
        short[k[:80]] = short.get(k[:80], 0.0) + v
    ranked = sorted(short.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall, "device_ms": busy if by_name else None,
            "busy_share": busy / wall if by_name else None,
            "top_kernels_ms": dict(ranked)}


def draw_sparse(gen, rows: int, psi: int, pad: int, cdf, device):
    """``rows`` splade_like vectors drawn on the card.

    Same spec as ``synth.sample_sparse_batch`` (ψ ~ Poisson(psi) clipped to
    [1, pad]; 2ψ Zipf(1.3) draws with replacement, deduplicated, shuffled,
    the first ψ kept; |lognormal(0, 0.6)| values), vectorised with a
    torch.Generator: the draws differ from synth's numpy draws.
    """
    import torch
    counts = torch.poisson(torch.full((rows,), float(psi), device=device),
                           generator=gen).long().clamp(1, pad)
    u = torch.rand((rows, 2 * pad), generator=gen, device=device,
                   dtype=torch.float64)
    draws = torch.searchsorted(cdf, u).clamp_max(N - 1)
    live = torch.arange(2 * pad, device=device)[None] < 2 * counts[:, None]
    draws = torch.where(live, draws, N)                 # sentinel sorts last
    srt, _ = torch.sort(draws, dim=1)
    dup = torch.zeros_like(srt, dtype=torch.bool)
    dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
    dup |= srt == N
    keys = torch.rand(srt.shape, generator=gen, device=device)
    keys = torch.where(dup, 2.0, keys)                  # uniques first, shuffled
    order = torch.argsort(keys, dim=1)[:, :pad]
    coords = srt.gather(1, order)
    c = torch.minimum(counts, (~dup).sum(1))
    valid = torch.arange(pad, device=device)[None] < c[:, None]
    coords, _ = torch.sort(torch.where(valid, coords, N), dim=1)
    valid = coords < N
    vals = torch.exp(0.6 * torch.randn((rows, pad), generator=gen,
                                       device=device))
    vals = torch.where(vals == 0, 1e-6, vals)
    return (torch.where(valid, coords, -1).to(torch.int32),
            torch.where(valid, vals, 0.0).to(torch.float32))


def zipf_cdf(device):
    import torch
    w = torch.arange(1, N + 1, dtype=torch.float64, device=device) ** -1.3
    return torch.cumsum(w / w.sum(), 0)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def finite_max_err(a, b) -> float:
    import torch
    both_inf = torch.isinf(a) & torch.isinf(b) & (torch.sign(a) == torch.sign(b))
    diff = torch.where(both_inf, 0.0, (a.double() - b.double()).abs())
    return float(diff.max()) if diff.numel() else 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--docs", type=int, default=SHARD_DOCS)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to measure",
              file=sys.stderr)
        return 2

    import repro_torch.kernels as kernels
    from repro_torch.api import IndexConfig, open_index
    from repro_torch.core import engine as eng
    from repro_torch.kernels import _build, csr_rerank, csr_score, ops
    from repro_torch.kernels import sinnamon_score
    from repro_torch.serving.serve import QueryServer
    from repro_torch.storage import vecstore

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    C = ((args.docs + 31) // 32) * 32
    t_start = time.perf_counter()

    # -- 1. device ------------------------------------------------------------
    card = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"[1 device] {name} x{count}; nvidia-smi: {card}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    for b in built.values():
        if b.name == "sinnamon_dense":      # one line per instance below
            continue
        for line in b.ptxas_log.splitlines():
            if any(w in line for w in ("Function properties", "registers",
                                       "spill", "smem")):
                log(f"[2 build] {b.name}: {line.strip()}")
    dense_ptxas = dense_instances(built["sinnamon_dense"].ptxas_log)
    log("[2 build] sinnamon_dense instances (registers, spill stores / "
        "loads in bytes): " + "; ".join(
            f"{k} {r} regs {st}/{ld}" for k, (r, st, ld)
            in dense_ptxas.items()))
    log(f"[2 build] ok: {', '.join(built)} for sm_90a in "
        f"{time.perf_counter() - t0:.1f}s")

    # -- 3. kernels against their plain twins at main-path shapes -------------
    Bc, Lc = 16, 64
    for cell in (torch.bfloat16, torch.float8_e4m3fn):
        qv = torch.randn((Bc, Lc), generator=gen, device=dev)
        qv[:, -1] = 0
        rows = torch.randint(0, M, (Bc, Lc, H), generator=gen, device=dev,
                             dtype=torch.int32)
        rows = torch.where((qv > 0)[..., None], rows, rows + M).contiguous()
        brows = torch.randint(-1, 512, (Bc, Lc), generator=gen, device=dev,
                              dtype=torch.int32)
        bits = torch.randint(-2**31, 2**31, (512, C // 32), generator=gen,
                             device=dev, dtype=torch.int64).to(torch.int32)
        ok = torch.rand(C, generator=gen, device=dev) < 0.9
        if cell == torch.float8_e4m3fn:
            sk = torch.randint(0, 0x7F, (2 * M, C), generator=gen, device=dev,
                               dtype=torch.uint8).view(cell)
        else:
            sk = torch.randn((2 * M, C), generator=gen, device=dev).to(cell)
        opnds = (qv, rows, brows, bits, ok, sk)
        kp = min(KPRIME, sinnamon_score.TILE_C)
        kv, ks = sinnamon_score.sinnamon_score_topk(*opnds, kp=kp)
        kv, ks = sinnamon_score.merge_tile_topk(kv, ks, KPRIME)
        tv, ts = sinnamon_score.sinnamon_score_topk_plain(*opnds, kp=kp)
        tv, ts = sinnamon_score.merge_tile_topk(tv, ts, KPRIME)
        torch.cuda.synchronize()
        if not (torch.equal(ks, ts) and torch.equal(
                kv.view(torch.int32), tv.view(torch.int32))):
            raise AssertionError(f"kernel A != twin for {cell} cells")
        log(f"[3 kernels] sinnamon_score_topk {cell}: merged slots and values "
            f"bit-equal to the twin (B={Bc}, L={Lc}, h={H}, m={M}, C={C}, "
            f"kprime={KPRIME})")
        dense_opnds = (qv, rows, brows, bits, sk)
        kc = sinnamon_score.sinnamon_score(*dense_opnds)
        tc = sinnamon_score.sinnamon_score_plain(*dense_opnds)
        torch.cuda.synchronize()
        if kc.shape != (Bc, C) or not torch.equal(kc.view(torch.int32),
                                                  tc.view(torch.int32)):
            raise AssertionError(f"kernel C != twin for {cell} cells")
        log(f"[3 kernels] sinnamon_score (dense) {cell}: f32[{Bc}, {C}] "
            f"bit-equal to the twin (L={Lc}, h={H}, m={M}, "
            f"{int((brows < 0).sum())} padded and "
            f"{int(((qv <= 0) & (brows >= 0)).sum())} non-positive "
            f"coordinates)")
    del bits, sk, opnds, dense_opnds, kc, tc

    n_rows = C
    idx = torch.randint(-1, N, (n_rows, P), generator=gen, device=dev,
                        dtype=torch.int32)
    val = torch.randn((n_rows, P), generator=gen,
                      device=dev).to(torch.bfloat16)
    qd = torch.randn((Bc, N), generator=gen, device=dev)
    slots = torch.randint(0, n_rows, (Bc, KPRIME), generator=gen, device=dev,
                          dtype=torch.int32)
    got = csr_score.csr_score(qd, idx, val, slots)
    want = csr_score.csr_score_plain(qd, idx, val, slots)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    err_rerank = finite_max_err(got, want)
    got = csr_score.csr_score(qd[:2], idx, val)
    want = csr_score.csr_score_plain(qd[:2], idx, val)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    err_scan = finite_max_err(got, want)
    log(f"[3 kernels] csr_score rerank (B={Bc}, k'={KPRIME}, P={P}) max abs "
        f"err {err_rerank:.3g}; LinScan over {n_rows} rows max abs err "
        f"{err_scan:.3g} (rtol=atol=1e-5)")
    # its own generator: the main path's corpus and queries stay the draws
    # of earlier runs
    rerank_gen = torch.Generator(device=dev)
    rerank_gen.manual_seed(args.seed + 1)
    rerank_against_twin(csr_rerank, rerank_gen, dev, idx, val, slots, Bc, Lc)
    del idx, val, got, want
    kernel_d_against_twin(gen, dev, args.seed)
    torch.cuda.empty_cache()

    # -- 4. main path at full width -------------------------------------------
    t0 = time.perf_counter()
    cdf = zipf_cdf(dev)
    corpus_idx = torch.empty((args.docs, P), dtype=torch.int32, device=dev)
    corpus_val = torch.empty((args.docs, P), dtype=torch.float32, device=dev)
    for lo in range(0, args.docs, 65_536):
        hi = min(lo + 65_536, args.docs)
        corpus_idx[lo:hi], corpus_val[lo:hi] = draw_sparse(
            gen, hi - lo, PSI_DOC, P, cdf, dev)
    q_idx, q_val = draw_sparse(gen, 512, PSI_QUERY, Q_PAD, cdf, dev)
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t0

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    index = open_index(IndexConfig(n=N, capacity=C, m=M, h=H, max_nnz=P,
                                   seed=args.seed), device="cuda")
    ins_batch = 32_768
    for lo in range(0, args.docs, ins_batch):
        hi = min(lo + ins_batch, args.docs)
        index.insert_many(range(lo, hi), corpus_idx[lo:hi],
                          corpus_val[lo:hi])
    torch.cuda.synchronize()
    t_insert = time.perf_counter() - t0
    churn = list(range(0, args.docs, 16))
    t0 = time.perf_counter()
    index.delete_many(churn)
    torch.cuda.synchronize()
    t_delete = time.perf_counter() - t0
    churn_t = torch.tensor(churn, device=dev)
    t0 = time.perf_counter()
    for lo in range(0, len(churn), ins_batch):
        part = churn_t[lo:lo + ins_batch]
        index.insert_many(part, corpus_idx[part], corpus_val[part])
    torch.cuda.synchronize()
    t_reinsert = time.perf_counter() - t0
    n_dirty = int(index.state.dirty.sum())
    if index.size != args.docs or n_dirty != len(churn):
        raise AssertionError(f"index holds {index.size} docs, {n_dirty} "
                             f"dirty; want {args.docs}, {len(churn)}")
    log(f"[4 main] indexed {index.size} docs (data {t_data:.1f}s, insert "
        f"{t_insert:.1f}s); deleted {len(churn)} in {t_delete * 1e3:.1f} ms "
        f"and re-inserted them into {n_dirty} dirty slots in {t_reinsert:.1f}s; "
        f"memory {index.memory_bytes()}")

    server = QueryServer(index, k=K, kprime=KPRIME)
    server.query_many(q_idx[:16], q_val[:16])               # warm-up
    lat = {}
    answers = {}
    for bsz, n_batches in ((16, 100), (256, 30)):
        walls = []
        for i in range(n_batches):
            lo = (i * bsz) % (512 - bsz + 1)
            t0 = time.perf_counter()    # the result comes back on the host
            res = server.query_many(q_idx[lo:lo + bsz], q_val[lo:lo + bsz])
            walls.append((time.perf_counter() - t0) * 1e3)
            if res.ids.shape != (bsz, K) or not np_all_finite(res.scores):
                raise AssertionError(f"bad result for batch {bsz}: "
                                     f"{res.ids.shape}")
        answers[bsz] = (lo, res)
        lat[f"fused B={bsz}"] = request_latency(walls, bsz)
    counts = kernels.launch_counts()
    log(f"[4 main] served batches of 16 and 256 (k={K}, k'={KPRIME}); "
        f"launches {counts}")
    check_path_launches(counts, "fused",
                        ("sinnamon_score_topk", "sinnamon_score_threshold",
                         "csr_rerank_topk"),
                        ("sinnamon_score", "embed_bag", "csr_score"))

    staged = QueryServer(index, k=K, kprime=KPRIME, trace_every=1)
    lo, res16 = answers[16]
    sres = staged.query_many(q_idx[lo:lo + 16], q_val[lo:lo + 16])
    if not (sres.ids == res16.ids).all():
        raise AssertionError("staged ids != fused ids")
    log("[4 main] staged batch (B=16) spans: " + ", ".join(
        f"{s.name} {s.ms:.3f} ms" for s in staged.last_trace.spans))

    qi16 = q_idx[lo:lo + 16].contiguous()
    qv16 = q_val[lo:lo + 16].contiguous()
    ids_k, sc_k, _ = eng.search_batch(index.state, index.spec, qi16, qv16, K,
                                      KPRIME)
    ids_p, sc_p, _ = eng.search_batch(index.state, index.spec, qi16, qv16, K,
                                      KPRIME, use_kernel=False)
    if not torch.equal(ids_k, ids_p):
        raise AssertionError("kernel-path ids != plain-twin ids")
    log(f"[4 main] kernel-path ids == plain-twin ids on one batch of 16 "
        f"(score max abs diff {finite_max_err(sc_k, sc_p):.3g})")

    lo, res256 = answers[256]
    qi256, qv256 = q_idx[lo:lo + 256], q_val[lo:lo + 256]
    kernels.reset_launch_counts()
    recall = recall_at_k(res256.ids, exact_top_ids(index, qi256, qv256))
    linscan_counts = kernels.launch_counts()
    check_path_launches(linscan_counts, "recall ground truth",
                        ("csr_score",), ())
    log(f"[4 main] recall@{K}={recall:.4f} over 256 queries against the "
        f"exact LinScan (csr_score)")
    if recall < RECALL_MIN:
        raise AssertionError(f"recall@{K}={recall:.4f} < {RECALL_MIN}")

    small_ok = exact_small_index(open_index, IndexConfig, QueryServer,
                                 ops, vecstore, sinnamon_score, gen, cdf, dev)
    log(f"[4 main] small index (2,048 docs, k'=capacity) answers equal the "
        f"exact top-{K}: {small_ok}")

    # -- 4b. the dense path: kernel C behind the score_fn hook -------------------
    score_fn = ops.make_engine_score_fn()
    dense = QueryServer(index, k=K, kprime=KPRIME, score_fn=score_fn)
    kernels.reset_launch_counts()
    dense.query_many(q_idx[:16], q_val[:16])                # warm-up
    walls, dense_answers = [], []
    for i in range(DENSE_BATCHES):
        lo = (i * 16) % (512 - 16 + 1)
        t0 = time.perf_counter()
        res = dense.query_many(q_idx[lo:lo + 16], q_val[lo:lo + 16])
        walls.append((time.perf_counter() - t0) * 1e3)
        if res.ids.shape != (16, K) or not np_all_finite(res.scores) \
                or res.backend != "custom":
            raise AssertionError(f"bad dense result: {res.ids.shape} "
                                 f"{res.backend}")
        dense_answers.append((lo, res))
    dense_counts = kernels.launch_counts()
    lat["dense B=16"] = request_latency(walls, 16)
    log(f"[4b dense] served {DENSE_BATCHES} batches of 16 through "
        f"QueryServer(score_fn=ops.make_engine_score_fn()) (k={K}, "
        f"k'={KPRIME}); launches {dense_counts}")
    check_path_launches(dense_counts, "dense",
                        ("sinnamon_score", "csr_rerank_topk"),
                        ("sinnamon_score_topk", "sinnamon_score_threshold",
                         "embed_bag", "csr_score"))

    lo, res_d = dense_answers[-1]
    qi_d, qv_d = q_idx[lo:lo + 16].contiguous(), q_val[lo:lo + 16].contiguous()
    cv, cs = eng.topk_candidates(index.state, index.spec, qi_d, qv_d, KPRIME,
                                 score_fn=score_fn)
    rv, rs = eng.topk_candidates(index.state, index.spec, qi_d, qv_d, KPRIME,
                                 backend="reference")
    if not (torch.equal(cs, rs) and torch.equal(cv.view(torch.int32),
                                                rv.view(torch.int32))):
        raise AssertionError("dense-path candidates != reference backend's")
    log(f"[4b dense] one batch of 16: kernel C candidates (upper bounds and "
        f"slots, k'={KPRIME}) bit-equal to the on-card reference backend")
    res_f = server.query_many(qi_d, qv_d)
    if (res_f.ids == res_d.ids).all():
        log("[4b dense] ids == the fused path's ids on the same batch")
    else:
        # Kernel A adds the coordinates in the same order, so its candidates
        # are the same; ids can then differ only between equal exact scores.
        log(f"[4b dense] ids differ from the fused path's at "
            f"{int((res_f.ids != res_d.ids).sum())} places; exact scores "
            f"must be equal")
        if not np.array_equal(res_f.scores, res_d.scores):
            raise AssertionError("dense-path answer != fused-path answer")
    truth = np.concatenate([exact_top_ids(index, q_idx[lo:lo + 16],
                                          q_val[lo:lo + 16])
                            for lo, _ in dense_answers])
    recall_dense = recall_at_k(np.concatenate([r.ids for _, r in
                                               dense_answers]), truth)
    log(f"[4b dense] recall@{K}={recall_dense:.4f} over "
        f"{DENSE_BATCHES * 16} queries against the exact LinScan")
    if recall_dense < RECALL_MIN:
        raise AssertionError(f"dense recall@{K}={recall_dense:.4f} < "
                             f"{RECALL_MIN}")

    # -- 5. times ---------------------------------------------------------------
    kernel_rows = times(index, card, q_idx, q_val, answers, counts,
                        dense_counts, linscan_counts, lat, t_start,
                        dense_ptxas)

    # -- 7. the front door over phase 5's index ---------------------------------
    frontdoor_counts, frontdoor_line = frontdoor_path(
        server, index, q_idx, q_val, lat, card)

    # -- 8. the tiered index beside the resident one ----------------------------
    del staged, dense, res_f, cv, cs, rv, rs
    gc.collect()
    torch.cuda.empty_cache()
    tiered_counts, tiered_line = tiered_path(
        index, corpus_idx, corpus_val, churn, q_idx, q_val, args.seed, dev,
        card)

    # -- 4c. the evaluation path (after the served index is freed) -------------
    del index, server
    gc.collect()
    torch.cuda.empty_cache()
    eval_path(corpus_idx, corpus_val, q_idx[:256], q_val[:256], args.seed,
              dev)

    # -- 4d. durability: log, snapshot, recover the shard ----------------------
    gc.collect()
    torch.cuda.empty_cache()
    durable_counts, durable_line = durable_path(
        corpus_idx, corpus_val, q_idx[:256], q_val[:256], args.seed, dev)

    # -- 9. the sharded index: 4 shards of the deployment on the card ---------
    del corpus_idx, corpus_val
    gc.collect()
    torch.cuda.empty_cache()
    sharded_counts, sharded_line = sharded_path(q_idx, q_val, args.seed, dev,
                                                card, cdf)

    # -- 6a / 6b. DLRM-rm2 serving and its users' retrieval --------------------
    del q_idx, q_val
    gc.collect()
    torch.cuda.empty_cache()
    with torch.no_grad():               # serving: no autograd graph
        d_row, recsys_line = recsys_path(args.seed, dev, card)
    kernel_rows.append(d_row)

    # -- 10. recsys training: dlrm-rm2, din, sasrec, mind; resume ------------
    gc.collect()
    torch.cuda.empty_cache()
    bwd_row, train_line, train_counts = train_path(args.seed, dev, card)
    kernel_rows.append(bwd_row)

    # -- 11. the LM family: stablelm-12b served and trained, the MoE --------
    gc.collect()
    torch.cuda.empty_cache()
    lm_line, lm_counts = lm_path(args.seed, dev, card)

    # -- 12. the GNN family: equiformer-v2 trained at full width -------------
    gc.collect()
    torch.cuda.empty_cache()
    gnn_line, gnn_counts = gnn_path(args.seed, dev, card)

    # -- 13. the mesh tooling: dry run on the host, 1x1 mesh on the card ----
    gc.collect()
    torch.cuda.empty_cache()
    # -- 14. the sharded GNN and compressed gradients, while 13a traces --------
    mesh_line, mesh_counts, (gnn_mesh_line, gnn_mesh_counts) = mesh_path(
        args.seed, dev, card, recsys_line, train_line, cdf,
        then=lambda: gnn_mesh_path(args.seed, dev, card))
    paths = {"fused": counts, "durable": durable_counts,
             "frontdoor": frontdoor_counts, "tiered": tiered_counts,
             "sharded": sharded_counts, "mesh": mesh_counts}
    kernel_rows[0]["threshold_form"]["launches"] = {
        path: c.get("sinnamon_score_threshold", 0)
        for path, c in paths.items()}
    for row in kernel_rows:
        row["launches_durable"] = durable_counts[row["name"]]
        row["launches_frontdoor"] = frontdoor_counts[row["name"]]
        row["launches_tiered"] = tiered_counts[row["name"]]
        row["launches_sharded"] = sharded_counts[row["name"]]
        row["launches_train"] = train_counts[row["name"]]
        row["launches_lm"] = lm_counts[row["name"]]
        row["launches_gnn"] = gnn_counts[row["name"]]
        row["launches_mesh"] = mesh_counts[row["name"]]
        row["launches_gnn_mesh"] = gnn_mesh_counts[row["name"]]

    peak = max(torch.cuda.max_memory_allocated(), _PEAK_BEFORE_RESET[0])
    log(f"[end] peak device memory {peak / 2**30:.2f} GiB; whole run "
        f"{time.perf_counter() - t_start:.1f}s")
    if peak >= PEAK_MEMORY_MAX:
        raise AssertionError(f"peak device memory {peak / 1e9:.2f} GB >= "
                             f"{PEAK_MEMORY_MAX / 1e9:.0f} GB")
    print(json.dumps({"recsys": recsys_line}), flush=True)
    print(json.dumps({"durable": durable_line}), flush=True)
    print(json.dumps({"frontdoor": frontdoor_line}), flush=True)
    print(json.dumps({"tiered": tiered_line}), flush=True)
    print(json.dumps({"sharded": sharded_line}), flush=True)
    print(json.dumps({"train": train_line}), flush=True)
    print(json.dumps({"lm": lm_line}), flush=True)
    print(json.dumps({"gnn": gnn_line}), flush=True)
    print(json.dumps({"mesh": mesh_line}), flush=True)
    print(json.dumps({"gnn_mesh": gnn_mesh_line}), flush=True)
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


def times(index, card, q_idx, q_val, answers, counts, dense_counts,
          linscan_counts, lat, t_start, dense_ptxas):
    """Phase 5: CUDA-event times of every kernel and its twin at the main
    paths' shapes, their bounds, the serving latencies; returns the kernels
    JSON rows."""
    import torch

    from repro_torch.core import engine as eng
    from repro_torch.kernels import csr_rerank, csr_score, ops, sinnamon_score
    from repro_torch.storage import vecstore

    st, spec = index.state, index.spec
    C = st.sketch.shape[1]
    lo, _ = answers[16]
    qi16, qv16 = q_idx[lo:lo + 16].contiguous(), q_val[lo:lo + 16].contiguous()
    lo, _ = answers[256]
    qi256, qv256 = q_idx[lo:lo + 256], q_val[lo:lo + 256]
    q_dense = vecstore.densify_query(N, qi256, qv256)
    qv_op, rows_op, brows_op, sk_op, one_sided = ops.prepare_fused_operands(
        st, spec, qi256, qv256)
    tile = sinnamon_score.TILE_C
    kp = min(KPRIME, tile)
    a_args = (qv_op, rows_op, brows_op, st.bits, st.active, sk_op)
    a_ms = cuda_ms(lambda: sinnamon_score.sinnamon_score_topk(
        *a_args, kp=kp, one_sided=one_sided), reps=5)
    a_plain_ms = cuda_ms(lambda: sinnamon_score.sinnamon_score_topk_plain(
        *a_args, kp=kp, one_sided=one_sided), reps=2)
    # the same launch with no coordinates: selection and writes alone
    sel_args = (qv_op[:, :0].contiguous(), rows_op[:, :0].contiguous(),
                brows_op[:, :0].contiguous()) + a_args[3:]
    a_sel_ms = cuda_ms(lambda: sinnamon_score.sinnamon_score_topk(
        *sel_args, kp=kp, one_sided=one_sided), reps=5)
    a16 = ops.prepare_fused_operands(st, spec, qi16, qv16)
    a16_ms = cuda_ms(lambda: sinnamon_score.sinnamon_score_topk(
        *a16[:3], st.bits, st.active, a16[3], kp=kp, one_sided=one_sided),
        reps=10)
    tv, ts = sinnamon_score.sinnamon_score_topk(*a_args, kp=kp,
                                                one_sided=one_sided)
    merge_ms = cuda_ms(lambda: sinnamon_score.merge_tile_topk(tv, ts, KPRIME),
                       reps=5)
    pv, ps = sinnamon_score.sinnamon_score_topk_plain(*a_args, kp=kp,
                                                      one_sided=one_sided)
    a_err = finite_max_err(tv, pv)
    if not (torch.equal(ts, ps) and torch.equal(tv.view(torch.int32),
                                                pv.view(torch.int32))):
        raise AssertionError("kernel A != twin on the main-path batch")
    a_bytes, a_ops = kernel_a_work(st, qv_op, rows_op, brows_op, C, kp)
    # candidate selection: the single pass beside the two passes at B=16
    # (the front door's batch) and from 32 to 256 (where the cut lies), and
    # the threshold form alone at B=256
    selection = {16: selection_times(sinnamon_score, a16[:3] + (
        st.bits, st.active, a16[3]), one_sided)}
    for bsz in (32, 64, 128, 256):
        selection[bsz] = selection_times(sinnamon_score, tuple(
            t[:bsz].contiguous() for t in a_args[:3]) + a_args[3:],
            one_sided)
    thr = threshold_times(sinnamon_score, st, a_args, one_sided)
    a_bound = max(a_bytes / HBM_BYTES_PER_S, a_ops / F32_OPS_PER_S) * 1e3
    # the per-query form: [U; L] once per batch, every query's bitmap rows
    a_bound_pq = (st.sketch.numel() * st.sketch.element_size()
                  + int((brows_op >= 0).sum()) * C // 8) / HBM_BYTES_PER_S * 1e3

    cand_v, cand_s = sinnamon_score.merge_tile_topk(tv, ts, KPRIME)
    cand_s = cand_s.contiguous()
    b_args = (q_dense, st.store.indices, st.store.values, cand_s)
    b_ms = cuda_ms(lambda: csr_score.csr_score(*b_args), reps=10)
    b_plain_ms = cuda_ms(lambda: csr_score.csr_score_plain(*b_args), reps=3)
    b_got = csr_score.csr_score(*b_args)
    b_want = csr_score.csr_score_plain(*b_args)
    torch.testing.assert_close(b_got, b_want, rtol=1e-5, atol=1e-5)
    b_err = finite_max_err(b_got, b_want)
    b_bytes, b_ops = kernel_b_work(st.store, cand_s, q_dense)
    b_bound = max(b_bytes / HBM_BYTES_PER_S, b_ops / F32_OPS_PER_S) * 1e3
    row_bytes = P * (4 + st.store.values.element_size())
    b_bound_pq = cand_s.numel() * row_bytes / HBM_BYTES_PER_S * 1e3

    # kernel B's rerank form on the same candidates: the kernel, its twin,
    # the route it replaced, the wrapper's host time per call
    qi256c, qv256c = qi256.contiguous(), qv256.contiguous()
    r256 = rerank_stage(csr_rerank, st, cand_v.contiguous(), cand_s, qi256c,
                        qv256c, reps=20)

    q1 = q_dense[:1].contiguous()
    s_ms = cuda_ms(lambda: csr_score.csr_score(q1, st.store.indices,
                                               st.store.values), reps=5)
    s_plain_ms = cuda_ms(lambda: csr_score.csr_score_plain(
        q1, st.store.indices, st.store.values), reps=2)
    s_err = finite_max_err(
        csr_score.csr_score(q1, st.store.indices, st.store.values),
        csr_score.csr_score_plain(q1, st.store.indices, st.store.values))
    s_bytes, s_ops = kernel_b_work(st.store, None, q1)
    s_bound = max(s_bytes / HBM_BYTES_PER_S, s_ops / F32_OPS_PER_S) * 1e3
    csr = library_csr(st.store, N)
    qcol = q1[0][:, None].contiguous()
    s_lib_ms = cuda_ms(lambda: csr @ qcol, reps=5)
    lib_err = finite_max_err((csr @ qcol)[:, 0],
                             csr_score.csr_score(q1, st.store.indices,
                                                 st.store.values)[0])
    del csr, qcol

    # kernel C at the dense path's shape (B=16) and at B=256
    c16 = ops.prepare_fused_operands(st, spec, qi16, qv16)
    c16_args = c16[:3] + (st.bits, c16[3])
    c_ms = cuda_ms(lambda: sinnamon_score.sinnamon_score(
        *c16_args, one_sided=one_sided), reps=10)
    c_plain_ms = cuda_ms(lambda: sinnamon_score.sinnamon_score_plain(
        *c16_args, one_sided=one_sided), reps=3)
    c256_args = (qv_op, rows_op, brows_op, st.bits, sk_op)
    c256_ms = cuda_ms(lambda: sinnamon_score.sinnamon_score(
        *c256_args, one_sided=one_sided), reps=5)
    kc = sinnamon_score.sinnamon_score(*c16_args, one_sided=one_sided)
    pc = sinnamon_score.sinnamon_score_plain(*c16_args, one_sided=one_sided)
    if not torch.equal(kc.view(torch.int32), pc.view(torch.int32)):
        raise AssertionError("kernel C != twin on the dense-path batch")
    c_err = finite_max_err(kc, pc)
    del kc, pc
    c_bytes, c_ops = kernel_c_work(st, *c16[:3], one_sided)
    c_bound = max(c_bytes / HBM_BYTES_PER_S, c_ops / F32_OPS_PER_S) * 1e3
    c256_bytes, c256_ops = kernel_c_work(st, qv_op, rows_op, brows_op,
                                         one_sided)
    c256_bound = max(c256_bytes / HBM_BYTES_PER_S,
                     c256_ops / F32_OPS_PER_S) * 1e3
    # the per-query form: each query's own sketch and bitmap rows
    n_coords = int((c16[2] >= 0).sum())
    c_bound_pq = (n_coords * (H * C * st.sketch.element_size() + C // 8)
                  + 16 * C * 4) / HBM_BYTES_PER_S * 1e3
    words, c_smem = sinnamon_score.dense_tile(st.sketch.shape[0],
                                              st.sketch.element_size(), H)
    c_instance = (f"{CELL_NAMES[str(st.sketch.dtype).split('.')[-1]]}"
                  f"x{words}")
    # share of the (coordinate, 32-slot word) pairs whose word is non-zero
    live16 = c16[2][c16[2] >= 0].long()
    nz_share = float((st.bits[live16] != 0).float().mean())

    # the dense request at B=16, split on the card: operand prep, kernel C,
    # the gate and topk_desc over 16 x C keys (engine.topk_candidates), and
    # B's rerank (densify, csr_score over k' rows, top-k, ids)
    prep_ms = cuda_ms(lambda: ops.prepare_fused_operands(st, spec, qi16,
                                                         qv16), reps=10)
    s16 = sinnamon_score.sinnamon_score(*c16_args, one_sided=one_sided)
    gate_ms = cuda_ms(lambda: torch.where(st.active[None, :], s16,
                                          -torch.inf), reps=10)
    gated16 = torch.where(st.active[None, :], s16, -torch.inf)
    topk_ms = cuda_ms(lambda: sinnamon_score.topk_desc(gated16, KPRIME),
                      reps=10)
    cv16, cs16 = sinnamon_score.topk_desc(gated16, KPRIME)
    rerank_ms = cuda_ms(lambda: eng.rerank_topk(st, cv16, cs16, qi16, qv16,
                                                K), reps=10)
    qd16 = vecstore.densify_query(N, qi16, qv16)
    cs16 = cs16.contiguous()
    b16_ms = cuda_ms(lambda: csr_score.csr_score(
        qd16, st.store.indices, st.store.values, cs16), reps=10)
    r16 = rerank_stage(csr_rerank, st, cv16, cs16, qi16, qv16, reps=20)
    del s16, gated16
    dense_p50 = lat["dense B=16"]["p50"]
    split = {"p50_ms": dense_p50, "prep_ms": prep_ms, "kernel_c_ms": c_ms,
             "gate_ms": gate_ms, "topk_desc_ms": topk_ms,
             "rerank_ms": rerank_ms, "rerank_kernel_ms": r16["ms"],
             "rerank_old_route_ms": r16["old_route_ms"],
             "rerank_old_csr_score_ms": b16_ms}
    split["rest_ms"] = dense_p50 - (prep_ms + c_ms + gate_ms + topk_ms
                                    + rerank_ms)

    log(f"[5 times] on {card}:")
    log(f"[5 times]   sinnamon_score_topk B=256 L={qv_op.shape[1]}: "
        f"{a_ms:.3f} ms (twin {a_plain_ms:.3f} ms, bound {a_bound:.3f} ms, "
        f"per-query bitmap form {a_bound_pq:.3f} ms); "
        f"with no coordinates (selection only) {a_sel_ms:.3f} ms, so "
        f"scoring {a_ms - a_sel_ms:.3f} ms; B=16 {a16_ms:.3f} ms; merge "
        f"{merge_ms:.3f} ms")
    log(f"[5 times]   sinnamon_score_threshold B=256 (stride "
        f"{thr['stride']}, {thr['tiles']} tiles): {thr['ms']:.3f} ms (twin "
        f"{thr['plain_ms']:.3f} ms, bound {thr['bound_ms']:.4f} ms, "
        f"{thr['bound_by']}); survivors a query mean "
        f"{thr['survivors_mean']:.1f}, max {thr['survivors_max']} (cap "
        f"{thr['cap']})")
    for bsz, sel in selection.items():
        log(f"[5 times]   candidate selection B={bsz} (the cut takes the "
            f"{sel['path']} pass): single pass {sel['single_ms']:.3f} ms "
            f"(synced call {sel['single_call_ms']:.3f}), two passes "
            f"{sel['two_ms']:.3f} ms (synced call {sel['two_call_ms']:.3f});"
            f" bit-equal")
    log(f"[5 times]   csr_score rerank B=256 k'={KPRIME}: {b_ms:.4f} ms (twin "
        f"{b_plain_ms:.3f} ms, bound {b_bound:.4f} ms, every gathered row "
        f"{b_bound_pq:.4f} ms)")
    for bsz, r in ((256, r256), (16, r16)):
        log(f"[5 times]   csr_rerank_topk B={bsz} k'={KPRIME} k={K}: "
            f"{r['ms']:.4f} ms, device alone {r['device_ms']} ms "
            f"(S={r['blocks_per_query']} blocks a query; twin "
            f"{r['plain_ms']:.3f} ms; sparse-query bound "
            f"{r['bound_ms']:.4f} ms, {r['bound_by']}; the old route "
            f"densify + csr_score + gate + topk_desc + gathers "
            f"{r['old_route_ms']:.4f} ms, its kernels on the device "
            f"{r['old_route_device_ms']} ms, its dense-query bound "
            f"{r['old_bound_ms']:.4f} ms; wrapper host time "
            f"{r['host_ms']:.4f} ms a call; ids and slots == twin's, "
            f"max abs err {r['max_abs_err']:.3g}; ids == the old route's: "
            f"{r['same_as_old_route']})")
    log(f"[5 times]   csr_score LinScan B=1 C={C}: {s_ms:.4f} ms (twin "
        f"{s_plain_ms:.3f} ms, torch.sparse CSR mv {s_lib_ms:.4f} ms, "
        f"bound {s_bound:.4f} ms; library max abs diff {lib_err:.3g})")
    log(f"[5 times]   sinnamon_score (dense) B=16 L={c16[0].shape[1]}: "
        f"{c_ms:.3f} ms (twin {c_plain_ms:.3f} ms, bound {c_bound:.4f} ms, "
        f"per-query form {c_bound_pq:.3f} ms); B=256 {c256_ms:.3f} ms "
        f"(bound {c256_bound:.4f} ms); instance {c_instance} "
        f"({32 * words}-slot tiles, {c_smem} B of shared memory a block, "
        f"{dense_ptxas[c_instance][0]} registers, spills "
        f"{dense_ptxas[c_instance][1]}/{dense_ptxas[c_instance][2]} B); "
        f"non-zero share of the B=16 batch's bitmap words {nz_share:.4f}")
    log(f"[5 times]   dense request B=16: p50 {dense_p50:.4f} ms = operand "
        f"prep {prep_ms:.4f} + kernel C {c_ms:.4f} + gate {gate_ms:.4f} + "
        f"topk_desc over 16 x {C} keys {topk_ms:.4f} + rerank "
        f"{rerank_ms:.4f} (kernel {r16['ms']:.4f}; the old route "
        f"{r16['old_route_ms']:.4f}, its csr_score {b16_ms:.4f}) + the rest "
        f"(host, copies) {split['rest_ms']:.4f} ms")
    for key, p in lat.items():
        log(f"[5 times]   serving {key}: request latency (batch wall "
            f"time) p50 {p['p50']:.4f} ms, p99 {p['p99']:.4f} ms over "
            f"{p['batches']} batches; throughput {p['qps']:.1f} queries/s")
    log(f"[5 times]   peak device memory so far "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"{time.perf_counter() - t_start:.1f}s into the run")

    src = "src/repro_torch/kernels/csrc"
    kernel_rows = [
        {"name": "sinnamon_score_topk", "route": "cuda",
         "source": f"{src}/sinnamon_score.cu",
         "replaces": "src/repro/kernels/sinnamon_score.py:263",
         "launches": counts["sinnamon_score_topk"], "max_abs_err": a_err,
         "ms": a_ms, "plain_ms": a_plain_ms, "bound_ms": a_bound,
         "bound_by": "bytes" if a_bytes / HBM_BYTES_PER_S
         >= a_ops / F32_OPS_PER_S else "operations",
         "library_ms": None, "shape": f"B=256 L={qv_op.shape[1]} C={C}",
         "merge_ms": merge_ms, "selection_only_ms": a_sel_ms,
         "scoring_ms": a_ms - a_sel_ms,
         "bound_ms_per_query_bitmap": a_bound_pq,
         "ms_b16": a16_ms, "threshold_form": thr,
         "selection": {str(b): v for b, v in selection.items()}},
        {"name": "csr_score", "route": "cuda",
         "source": f"{src}/csr_score.cu",
         "replaces": "src/repro/kernels/csr_score.py:50",
         "launches": linscan_counts["csr_score"], "max_abs_err": s_err,
         "ms": s_ms, "plain_ms": s_plain_ms, "bound_ms": s_bound,
         "bound_by": "bytes" if s_bytes / HBM_BYTES_PER_S
         >= s_ops / F32_OPS_PER_S else "operations",
         "library_ms": s_lib_ms, "shape": f"LinScan B=1 C={C} P={P}",
         "launches_from": "phase 4's recall ground truth (LinScan); 0 on "
                          "the fused, dense and 6b paths",
         "rerank_form_ms": b_ms, "rerank_form_plain_ms": b_plain_ms,
         "rerank_form_bound_ms": b_bound,
         "rerank_form_max_abs_err": b_err,
         "rerank_form_bound_ms_every_gathered_row": b_bound_pq},
        {"name": "csr_rerank_topk", "route": "cuda",
         "source": f"{src}/csr_rerank.cu",
         "replaces": "src/repro/kernels/csr_score.py:50",
         "launches": counts["csr_rerank_topk"],
         "max_abs_err": r256["max_abs_err"], "ms": r256["ms"],
         "plain_ms": r256["plain_ms"], "bound_ms": r256["bound_ms"],
         "bound_by": r256["bound_by"], "library_ms": None,
         "shape": f"B=256 k'={KPRIME} k={K} P={P} Lq={qi256c.shape[1]}",
         "launches_dense": dense_counts["csr_rerank_topk"],
         "blocks_per_query": r256["blocks_per_query"],
         "host_ms": r256["host_ms"], "device_ms": r256["device_ms"],
         "old_route_ms": r256["old_route_ms"],
         "old_route_device_ms": r256["old_route_device_ms"],
         "old_bound_ms": r256["old_bound_ms"],
         "b16": r16},
        {"name": "sinnamon_score", "route": "cuda",
         "source": f"{src}/sinnamon_dense.cu",
         "replaces": "src/repro/kernels/sinnamon_score.py:211",
         "launches": dense_counts["sinnamon_score"], "max_abs_err": c_err,
         "ms": c_ms, "plain_ms": c_plain_ms, "bound_ms": c_bound,
         "bound_by": "bytes" if c_bytes / HBM_BYTES_PER_S
         >= c_ops / F32_OPS_PER_S else "operations",
         "library_ms": None, "shape": f"B=16 L={c16[0].shape[1]} C={C}",
         "bound_ms_per_query": c_bound_pq, "ms_b256": c256_ms,
         "bound_ms_b256": c256_bound, "tile_slots": 32 * words,
         "ptxas": {k: {"registers": r, "spill_stores": st_b,
                       "spill_loads": ld_b}
                   for k, (r, st_b, ld_b) in dense_ptxas.items()},
         "nonzero_word_share_b16": nz_share,
         "dense_request_b16": split},
    ]
    return kernel_rows


def eval_path(doc_idx, doc_val, q_idx, q_val, seed, dev) -> None:
    """Phase 4c: the recall frontier with the bound check over three lever
    points, and the churn -> compact drift trajectory on a sample."""
    from repro_torch.core import theory
    from repro_torch.eval import bounds, recall

    t0 = time.perf_counter()
    points = [dict(m=M, sketch_kind="full", kprime=KPRIME),
              dict(m=M, sketch_kind="lite", kprime=KPRIME),
              dict(m=M, sketch_kind="full", kprime=KPRIME, budget=16)]
    pts = recall.frontier(
        doc_idx, doc_val, q_idx, q_val, N, points, k=K, h=H, seed=seed,
        bounds_params=dict(value_dist=theory.lognormal_dist(sigma=0.6)),
        device=dev)
    for pt in pts:
        b = pt["bounds"]
        tails = ", ".join(f"d={c['delta']}: {c['empirical']:.4f} vs "
                          f"{c['bound']:.4f}" for c in b["checks"])
        log(f"[4c eval] m={pt['m']} {pt['sketch_kind']} {pt['cell_dtype']} "
            f"k'={pt['kprime']} budget={pt['budget']}: recall@{K}="
            f"{pt['recall_at_k']:.4f} MRR={pt['mrr']:.4f} p50="
            f"{pt['p50_ms']:.4f} ms p99={pt['p99_ms']:.4f} ms per query "
            f"(B={len(q_idx)}); sketch {pt['sketch_bytes']} B, index "
            f"{pt['index_bytes']} B; bound check ok={b['ok']} min_err="
            f"{b['min_err']:.3g} margin={b['margin']:.3g} sum_p="
            f"{b['sum_p']:.2f} over {b['n_coords']} coords ({tails})")
        if b["min_err"] < -b["margin"]:
            raise AssertionError(f"Theorem 5.1 violated at {pt}: an upper "
                                 f"bound undershoots by {-b['min_err']}")
    if pts[0]["recall_at_k"] < RECALL_MIN:
        raise AssertionError(f"frontier full point recall@{K}="
                             f"{pts[0]['recall_at_k']:.4f} < {RECALL_MIN}")
    spec = recall.lever_spec(N, CHURN_DOCS, P, m=M, h=H, seed=seed)
    ch = bounds.churn_overestimate(spec, doc_idx[:CHURN_DOCS],
                                   doc_val[:CHURN_DOCS], rounds=2, frac=0.25,
                                   seed=seed, device=dev)
    log(f"[4c eval] churn on {CHURN_DOCS} docs (2 rounds of 25%): "
        + "; ".join(f"{k} err_max={ch[k]['err_max']:.4f} err_mean="
                    f"{ch[k]['err_mean']:.4f} drift_max={ch[k]['drift_max']}"
                    for k in ("clean", "churned", "compacted"))
        + f"; {ch['columns_rebuilt']} columns rebuilt")
    # The store keeps f32 values (lever_spec), so a compacted column is the
    # exact re-encoding of its document: no storage rounding is left, and
    # the drift must be exactly 0.
    if ch["compacted"]["drift_max"] != 0.0 or ch["churned"]["drift_max"] <= 0:
        raise AssertionError(f"compaction did not remove the drift: {ch}")
    log(f"[4c eval] done in {time.perf_counter() - t0:.1f}s")


def dir_bytes(path: str) -> int:
    """Bytes of every file under ``path``."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def durable_path(doc_idx, doc_val, q_idx, q_val, seed, dev):
    """Phase 4d: the shard through the durable index — logged inserts, a
    snapshot, a churn tail, then recovery into a new index checked bit for
    bit against the dropped one.  Works under a scratch directory in
    ``build/`` (removed at the end); refuses to start when the disk there
    lacks ``DURABLE_DISK_BYTES``.  Returns (launch counts on the recovered
    index, the numbers)."""
    import torch

    from repro_torch.obs import metrics as obs_metrics

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    free = shutil.disk_usage(root).free
    if free < DURABLE_DISK_BYTES:
        raise RuntimeError(f"phase 4d needs {DURABLE_DISK_BYTES} B of free "
                           f"disk under {root} for its WAL and snapshot; "
                           f"{free} B are free")
    log(f"[4d durable] {free / 1e9:.1f} GB free under build/ "
        f"(needs {DURABLE_DISK_BYTES / 1e9:.0f} GB)")
    scratch = tempfile.mkdtemp(prefix="durable-4d-", dir=root)
    _PEAK_BEFORE_RESET[0] = max(_PEAK_BEFORE_RESET[0],
                                torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    prev = obs_metrics.set_registry(obs_metrics.MetricsRegistry())
    try:
        return durable_run(doc_idx, doc_val, q_idx, q_val, seed, dev,
                           scratch)
    finally:
        obs_metrics.set_registry(prev)
        shutil.rmtree(scratch, ignore_errors=True)


def durable_run(doc_idx, doc_val, q_idx, q_val, seed, dev, scratch):
    import numpy as np
    import torch

    import repro_torch.kernels as kernels
    from repro_torch.api import DurabilityConfig, IndexConfig, open_index
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.serving.serve import QueryServer

    t_phase = time.perf_counter()
    reg = obs_metrics.get_registry()
    docs = doc_idx.shape[0]
    wd, sd = os.path.join(scratch, "wal"), os.path.join(scratch, "snap")
    cfg = IndexConfig(n=N, capacity=((docs + 31) // 32) * 32, m=M, h=H,
                      max_nnz=P, seed=seed,
                      durability=DurabilityConfig(wal_dir=wd,
                                                  snapshot_dir=sd, fsync=True,
                                                  snapshot_keep=1))
    index = open_index(cfg, device=dev)
    if index.size:
        raise AssertionError(f"a fresh durable index holds {index.size} docs")
    t0 = time.perf_counter()
    for lo in range(0, docs, DURABLE_BATCH):
        hi = min(lo + DURABLE_BATCH, docs)
        index.insert_many(range(lo, hi), doc_idx[lo:hi], doc_val[lo:hi])
    torch.cuda.synchronize()
    t_log = time.perf_counter() - t0
    snap = reg.snapshot()
    append = snap["repro_wal_append_ms"]["series"][0]
    fsync = snap["repro_wal_fsync_ms"]["series"][0]
    wal_bytes = dir_bytes(wd)
    out = {"docs": docs, "batch": DURABLE_BATCH, "log_apply_s": t_log,
           "wal_records": append["count"], "wal_bytes": wal_bytes,
           "wal_append_s": append["sum"] / 1e3,
           "wal_fsync_s": fsync["sum"] / 1e3}
    out["append_docs_per_s"] = docs / out["wal_append_s"]
    out["append_mb_per_s"] = wal_bytes / 1e6 / out["wal_append_s"]
    log(f"[4d durable] logged and applied {docs} docs in {t_log:.2f}s "
        f"({docs / t_log:.0f} docs/s end to end); WAL {append['count']} "
        f"records, {wal_bytes} B; appends with fsync {out['wal_append_s']:.3f}"
        f"s (fsync {out['wal_fsync_s']:.3f}s): {out['append_docs_per_s']:.0f} "
        f"docs/s, {out['append_mb_per_s']:.1f} MB/s")

    t0 = time.perf_counter()
    path = index.snapshot()
    out["snapshot_s"] = time.perf_counter() - t0
    out.update({f"snapshot_{k}": v for k, v in index.snapshot_timings.items()})
    out["snapshot_bytes"] = dir_bytes(path)
    out["wal_bytes_after_prune"] = dir_bytes(wd)
    log(f"[4d durable] snapshot {out['snapshot_bytes']} B in "
        f"{out['snapshot_s']:.2f}s (device-to-host "
        f"{out['snapshot_to_host_s']:.2f}s, write + fsync "
        f"{out['snapshot_write_s']:.2f}s); WAL after prune "
        f"{out['wal_bytes_after_prune']} B")

    churn = list(range(0, docs, 16))
    t0 = time.perf_counter()
    index.delete_many(churn)
    churn_t = torch.tensor(churn, device=dev)
    for lo in range(0, len(churn), DURABLE_BATCH):
        part = churn_t[lo:lo + DURABLE_BATCH]
        index.insert_many(part, doc_idx[part], doc_val[part])
    rebuilt = index.compact()
    torch.cuda.synchronize()
    out["tail_s"] = time.perf_counter() - t0
    out["tail_wal_bytes"] = dir_bytes(wd)
    if rebuilt != len(churn) or index.size != docs:
        raise AssertionError(f"tail: compact rebuilt {rebuilt} columns, "
                             f"index holds {index.size}; want {len(churn)}, "
                             f"{docs}")
    want_ids, want_scores = index.search_many(q_idx, q_val, k=K,
                                              kprime=KPRIME)
    live, spec = index.state, index.spec
    live_free, live_map = list(index._free), dict(index._id2slot)
    for w in index._writers.values():
        w.close()
    del index
    gc.collect()
    log(f"[4d durable] tail: deleted {len(churn)} docs (one record), "
        f"re-inserted them into the dirty slots, compacted {rebuilt} "
        f"columns in {out['tail_s']:.2f}s; WAL tail "
        f"{out['tail_wal_bytes']} B; live index dropped")

    t0 = time.perf_counter()
    rec = open_index(cfg, device=dev)
    torch.cuda.synchronize()
    out["recover_s"] = time.perf_counter() - t0
    rt = rec.recovery_timings
    out.update({"recover_read_s": rt["read_s"],
                "recover_to_device_s": rt["to_device_s"],
                "recover_replay_s": rt["replay_s"],
                "replayed_ops": rt["replayed_ops"]})
    log(f"[4d durable] recovered {rec.size} docs in {out['recover_s']:.2f}s: "
        f"manifest + npz read {rt['read_s']:.2f}s, host-to-device "
        f"{rt['to_device_s']:.2f}s, tail replay {rt['replay_s']:.2f}s "
        f"({rt['replayed_ops']} ops)")
    if rec.spec != spec or rec._free != live_free or rec._id2slot != live_map:
        raise AssertionError("recovered spec, free list or id map != live")
    bits = lambda t: t.view(torch.uint8) if t.dtype.is_floating_point \
        else t                                               # noqa: E731
    st = rec.state
    for name, a, b in (("mappings", st.mappings, live.mappings),
                       ("sketch", st.sketch, live.sketch),
                       ("bits", st.bits, live.bits),
                       ("store.indices", st.store.indices,
                        live.store.indices),
                       ("store.values", st.store.values, live.store.values),
                       ("active", st.active, live.active),
                       ("ids", st.ids, live.ids),
                       ("dirty", st.dirty, live.dirty)):
        if a.dtype != b.dtype or not torch.equal(bits(a), bits(b)):
            raise AssertionError(f"recovered {name} != live {name}")
    del live, st
    gc.collect()

    kernels.reset_launch_counts()
    server = QueryServer(rec, k=K, kprime=KPRIME)
    walls = []
    for _ in range(1 + DURABLE_BATCHES):
        t0 = time.perf_counter()
        res = server.query_many(q_idx, q_val)
        walls.append((time.perf_counter() - t0) * 1e3)
        if not (np.array_equal(res.ids, want_ids) and np.array_equal(
                res.scores.view(np.int32), want_scores.view(np.int32))):
            raise AssertionError("recovered answers != live answers")
    counts = kernels.launch_counts()
    check_path_launches(counts, "recovered durable",
                        ("sinnamon_score_topk", "csr_rerank_topk"),
                        ("sinnamon_score", "embed_bag", "csr_score"))
    out["first_batch_ms"] = walls[0]
    out["p50_ms_b256"] = float(np.percentile(walls[1:], 50))
    peak = torch.cuda.max_memory_allocated()
    out["peak_bytes"] = peak
    if peak >= PEAK_MEMORY_MAX:
        raise AssertionError(f"phase 4d peak device memory {peak / 1e9:.2f} "
                             f"GB >= {PEAK_MEMORY_MAX / 1e9:.0f} GB")
    del rec, server
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[4d durable] {len(q_idx)} queries (k={K}, k'={KPRIME}): ids and "
        f"scores bit-equal to the live index's; state leaves, free list and "
        f"id map bit-equal; launches {counts}; B={len(q_idx)} first batch "
        f"{out['first_batch_ms']:.2f} ms, p50 {out['p50_ms_b256']:.2f} ms "
        f"over {DURABLE_BATCHES}; peak {peak / 2**30:.2f} GiB; phase "
        f"{out['wall_s']:.1f}s")
    return counts, out


#: phase 7's saturation point: 50,000 q/s offered for 1 s, 50,000 arrivals
#: (3 s and 150,000 arrivals took ≈38 s of the run at ≈4,000 q/s; cut to
#: keep the whole script near 600 s beside phases 13a and 14)
FRONTDOOR_SAT_S = 1.0


def frontdoor_path(server, index, q_idx, q_val, lat, card):
    """Phase 7: ``ServingFrontend`` over phase 5's ``QueryServer``.

    (a) 16 client threads submit 256 queries (max_batch=16, 2 ms window,
    query_pad=32): ids and scores bit-equal to ``query()`` once per query,
    ids equal to one ``query_many`` at B=256; (b) ``loadgen.run_point`` with
    64 clients: a saturation point offered 50,000 q/s for FRONTDOOR_SAT_S
    (achieved X), then 0.25·X, 0.5·X and 0.9·X for 3 s each (device busy share under
    torch.profiler at 0.5·X); (c) a ``FrontendServer`` on 127.0.0.1:0
    answers 64 POSTs equal to (a), ``/metrics`` parses, ``/readyz`` is 200;
    (d) A and B's rerank launch, C, D and the LinScan do not.  Also the
    cost of the all-padding dummy rows: kernel A's search at B=16 with 4
    live rows against the 4 rows alone.  Returns (launch counts, numbers).
    """
    import threading
    import urllib.request

    import numpy as np
    import torch

    import repro_torch.kernels as kernels
    from repro_torch.core import engine as eng
    from repro_torch.obs import MetricsRegistry
    from repro_torch.obs.metrics import parse_exposition
    from repro_torch.serving import loadgen
    from repro_torch.serving.frontend import FrontendServer, ServingFrontend

    t_phase = time.perf_counter()
    qi = q_idx[:256].cpu().numpy()
    qv = q_val[:256].cpu().numpy()
    queries = [(qi[b], qv[b]) for b in range(256)]
    single = [server.query(qi[b], qv[b]) for b in range(256)]
    whole = server.query_many(qi, qv)
    out = {"card": card}

    def front(reg):
        return ServingFrontend(server, max_batch=16, batch_window_ms=2.0,
                               query_pad=32, registry=reg)

    def batch_fill(reg):
        h = json.loads(reg.to_json())["repro_frontend_batch_size"]["series"]
        return h[0]["sum"] / h[0]["count"] if h and h[0]["count"] else None

    kernels.reset_launch_counts()
    # (a) coalescing on the card
    reg = MetricsRegistry()
    fe = front(reg)
    got = [None] * 256
    try:
        def client(c):
            for b in range(c, 256, 16):
                got[b] = fe.query(*queries[b])
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(16)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
    finally:
        fe.close()
    for b in range(256):
        if not (np.array_equal(got[b].ids, single[b].ids)
                and np.array_equal(got[b].scores, single[b].scores)
                and np.array_equal(got[b].ids, whole.ids[b])):
            raise AssertionError(f"front door answer {b} != query() / "
                                 f"query_many at B=256")
    out["coalesce"] = {"queries": 256, "clients": 16, "wall_s": wall,
                       "mean_batch_fill": batch_fill(reg)}
    log(f"[7 frontdoor] 256 queries from 16 threads through "
        f"ServingFrontend(max_batch=16, 2 ms, query_pad=32): ids and scores "
        f"bit-equal to query() per query and ids to one query_many at "
        f"B=256; mean batch fill {out['coalesce']['mean_batch_fill']:.2f}")

    # (b) load points
    def point(offered, profile=False, duration_s=3.0):
        reg = MetricsRegistry()
        fe = front(reg)
        try:
            call = loadgen.frontend_client(fe)
            if profile:
                from torch.profiler import ProfilerActivity
                from torch.profiler import profile as prof_ctx
                with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
                    p = loadgen.run_point(call, queries, offered, clients=64,
                                          duration_s=duration_s)
                    torch.cuda.synchronize()
                busy = sum(e.self_device_time_total
                           for e in prof.key_averages()) / 1e3
            else:
                p = loadgen.run_point(call, queries, offered, clients=64,
                                      duration_s=duration_s)
        finally:
            fe.close()
        row = p.to_row()
        row["wall_s"] = p.duration_s
        row["mean_batch_fill"] = batch_fill(reg)
        if profile:
            row["device_busy_share"] = (busy / (p.duration_s * 1e3)
                                        if busy else None)
        log(f"[7 frontdoor] offered {offered:.1f} q/s: achieved "
            f"{row['achieved_qps']:.1f}, goodput {row['goodput_qps']:.1f} "
            f"q/s, p50/p99/p999 {row['p50_ms']:.3f} / {row['p99_ms']:.3f} "
            f"/ {row['p999_ms']:.3f} ms, rejected {row['rejected']}, "
            f"expired {row['expired']}, errors {row['errors']}, mean batch "
            f"fill {row['mean_batch_fill']:.2f}"
            + (f", device busy {row['device_busy_share']:.3f}"
               if profile and row["device_busy_share"] is not None else ""))
        if row["errors"]:
            raise AssertionError(f"{row['errors']} front-door errors at "
                                 f"{offered} q/s")
        return row

    sat = point(50_000.0, duration_s=FRONTDOOR_SAT_S)
    x = sat["achieved_qps"]
    out["load"] = {"saturation": sat,
                   "0.25X": point(0.25 * x), "0.5X": point(0.5 * x, True),
                   "0.9X": point(0.9 * x),
                   "closed_loop_B16_p50_ms": lat["fused B=16"]["p50"]}

    # (c) HTTP
    reg = MetricsRegistry()
    fe = front(reg)
    try:
        with FrontendServer(fe, host="127.0.0.1", port=0,
                            registry=reg) as door:
            docs = [None] * 64

            def poster(c):
                for b in range(c, 64, 16):
                    body = json.dumps({"indices": qi[b].tolist(),
                                       "values": qv[b].tolist()}).encode()
                    req = urllib.request.Request(door.url + "/v1/query",
                                                 data=body, method="POST")
                    docs[b] = json.loads(urllib.request.urlopen(
                        req, timeout=60).read())
            threads = [threading.Thread(target=poster, args=(c,))
                       for c in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            for b in range(64):
                if docs[b]["ids"] != got[b].ids.tolist() or not np.array_equal(
                        np.asarray(docs[b]["scores"], np.float32),
                        got[b].scores):
                    raise AssertionError(f"HTTP answer {b} != in-process")
            scrape = urllib.request.urlopen(door.url + "/metrics",
                                            timeout=60).read().decode()
            names = {n for n, _ in parse_exposition(scrape)}
            if not any(n.startswith("repro_frontend_requests_total")
                       for n in names):
                raise AssertionError("/metrics lacks the front door's series")
            ready = urllib.request.urlopen(door.url + "/readyz",
                                           timeout=60).status
            if ready != 200:
                raise AssertionError(f"/readyz answered {ready}")
    finally:
        fe.close()
    log(f"[7 frontdoor] HTTP: 64 POST /v1/query from 16 threads equal the "
        f"in-process answers; /metrics parses ({len(names)} series); "
        f"/readyz 200")
    counts = kernels.launch_counts()
    check_path_launches(counts, "front door",
                        ("sinnamon_score_topk", "csr_rerank_topk"),
                        ("sinnamon_score", "embed_bag", "csr_score"))

    # the all-padding dummy rows of a part-filled dispatch
    width = q_idx.shape[1]
    pad_i = torch.full((16, width), -1, dtype=torch.int32,
                       device=q_idx.device)
    pad_v = torch.zeros((16, width), dtype=torch.float32,
                        device=q_idx.device)
    pad_i[:4], pad_v[:4] = q_idx[:4], q_val[:4]
    st, spec = index.state, index.spec
    ms_padded = cuda_ms(lambda: eng.search_batch(st, spec, pad_i, pad_v, K,
                                                 KPRIME), 20)
    ms_live = cuda_ms(lambda: eng.search_batch(st, spec, pad_i[:4].clone(),
                                               pad_v[:4].clone(), K,
                                               KPRIME), 20)
    out["dummy_rows"] = {"live": 4, "rows": 16, "search_ms_padded": ms_padded,
                         "search_ms_live_only": ms_live}
    out["launches"] = counts
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[7 frontdoor] a B=16 dispatch of 4 live queries and 12 dummy rows "
        f"{ms_padded:.3f} ms on the card, the 4 alone {ms_live:.3f} ms; "
        f"launches {counts}; phase {out['wall_s']:.1f}s")
    return counts, out


TIER_BUDGETS_MB = (816, 102)      # phase 8: the whole store, then 1/8 of it
TIER_BATCHES = 20                 # phase 8: timed batches per batch size
TIER_DURABLE_DOCS = 65_536        # phase 8: the durable round trip


def tiered_path(resident, corpus_idx, corpus_val, churn, q_idx, q_val, seed,
                dev, card):
    """Phase 8: phase 5's documents in ``TieredSinnamonIndex`` at
    ``TIER_BUDGETS_MB`` beside the resident index of phase 4 (same inserts,
    same churn).  At each budget: 256 queries' ids and scores at B=16 and
    B=256 bit-equal to the resident index's; 20 batches of each size timed
    (p50/p99 beside the resident's, tier counters and host-to-device bytes
    per batch, one staged batch's spans); phase 4's churn applied again to
    both, each compacted, answers bit-equal again.  Then the durable round
    trip of ``TIER_DURABLE_DOCS`` documents under ``build/``: tiered ->
    snapshot -> resident -> tiered, answers equal at every step.  Returns
    (launch counts of the tiered searches, numbers)."""
    import numpy as np
    import torch

    import repro_torch.kernels as kernels
    from repro_torch.api import DurabilityConfig, IndexConfig, open_index
    from repro_torch.serving.serve import QueryServer

    t_phase = time.perf_counter()
    docs = corpus_idx.shape[0]
    C = resident.spec.capacity
    out = {"card": card, "budgets": {}}
    counts = {}
    qi, qv = q_idx[:256], q_val[:256]

    def answers(ix, bsz):
        parts = [ix.search_many(qi[lo:lo + bsz], qv[lo:lo + bsz], k=K,
                                kprime=KPRIME) for lo in range(0, 256, bsz)]
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))

    def same(a, b):
        return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])

    def churn_again(ix):
        ix.delete_many(churn)
        churn_t = torch.tensor(churn, device=dev)
        for lo in range(0, len(churn), 32_768):
            part = churn_t[lo:lo + 32_768]
            ix.insert_many(part, corpus_idx[part], corpus_val[part])
        return ix.compact()

    # the resident index's answers as phase 4 left it, then after phase 4's
    # churn once more and a compact(); each tiered index is held to both
    want = {bsz: answers(resident, bsz) for bsz in (16, 256)}
    n_res = churn_again(resident)
    want_after = {bsz: answers(resident, bsz) for bsz in (16, 256)}
    res_server = QueryServer(resident, k=K, kprime=KPRIME)
    for budget in TIER_BUDGETS_MB:
        t0 = time.perf_counter()
        tiered = open_index(IndexConfig(n=N, capacity=C, m=M, h=H,
                                        max_nnz=P, seed=seed,
                                        device_budget_mb=budget),
                            device="cuda")
        for lo in range(0, docs, 32_768):
            hi = min(lo + 32_768, docs)
            tiered.insert_many(range(lo, hi), corpus_idx[lo:hi],
                               corpus_val[lo:hi])
        tiered.delete_many(churn)
        churn_t = torch.tensor(churn, device=dev)
        for lo in range(0, len(churn), 32_768):
            part = churn_t[lo:lo + 32_768]
            tiered.insert_many(part, corpus_idx[part], corpus_val[part])
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        tier = tiered.tiered
        row = {"cache_chunks": tier.cache_chunks, "num_chunks":
               tier.num_chunks, "cache_bytes": tier.device_bytes(),
               "host_bytes": tier.host_bytes(), "build_s": t_build}
        kernels.reset_launch_counts()
        for bsz in (16, 256):
            if not same(answers(tiered, bsz), want[bsz]):
                raise AssertionError(f"tiered ({budget} MiB) answers at "
                                     f"B={bsz} != the resident index's")
        server = QueryServer(tiered, k=K, kprime=KPRIME)
        for bsz in (16, 256):
            walls, res_walls = [], []
            s0, b0 = tier.stats(), tier.h2d_bytes
            for i in range(TIER_BATCHES):
                lo = (i * bsz) % (512 - bsz + 1)
                t0 = time.perf_counter()
                server.query_many(q_idx[lo:lo + bsz], q_val[lo:lo + bsz])
                walls.append((time.perf_counter() - t0) * 1e3)
            s1, b1 = tier.stats(), tier.h2d_bytes
            for i in range(TIER_BATCHES):
                lo = (i * bsz) % (512 - bsz + 1)
                t0 = time.perf_counter()
                res_server.query_many(q_idx[lo:lo + bsz], q_val[lo:lo + bsz])
                res_walls.append((time.perf_counter() - t0) * 1e3)
            per = {k: (s1[k] - s0[k]) / TIER_BATCHES
                   for k in ("hits", "misses", "promotions", "evictions",
                             "fallbacks")}
            per["h2d_bytes"] = (b1 - b0) / TIER_BATCHES
            staged = QueryServer(tiered, k=K, kprime=KPRIME, trace_every=1)
            staged.query_many(q_idx[:bsz], q_val[:bsz])
            spans = {sp.name: sp.ms for sp in staged.last_trace.spans}
            row[f"B={bsz}"] = {"tiered": request_latency(walls, bsz),
                               "resident": request_latency(res_walls, bsz),
                               "per_batch": per, "staged_spans_ms": spans}
            log(f"[8 tiered] {budget} MiB ({tier.cache_chunks} of "
                f"{tier.num_chunks} chunks) B={bsz}: p50/p99 "
                f"{row[f'B={bsz}']['tiered']['p50']:.3f} / "
                f"{row[f'B={bsz}']['tiered']['p99']:.3f} ms (resident "
                f"{row[f'B={bsz}']['resident']['p50']:.3f} / "
                f"{row[f'B={bsz}']['resident']['p99']:.3f}); per batch "
                f"{per}; staged spans " + ", ".join(
                    f"{k} {v:.3f}" for k, v in spans.items()))
        for name, n in kernels.launch_counts().items():
            counts[name] = counts.get(name, 0) + n
        n_tier = churn_again(tiered)
        if n_res != n_tier:
            raise AssertionError(f"compact rebuilt {n_tier} columns, the "
                                 f"resident index {n_res}")
        for bsz in (16, 256):
            if not same(answers(tiered, bsz), want_after[bsz]):
                raise AssertionError(f"tiered ({budget} MiB) answers after "
                                     f"churn + compact != the resident's")
        row["stats"] = tier.stats()
        out["budgets"][str(budget)] = row
        log(f"[8 tiered] {budget} MiB: built in {t_build:.1f}s; answers "
            f"bit-equal to the resident index at B=16 and 256, before and "
            f"after phase 4's churn + compact ({n_tier} columns); stats "
            f"{row['stats']}")
        del tiered, server, staged, tier
        gc.collect()
        torch.cuda.empty_cache()
    check_path_launches(counts, "tiered",
                        ("sinnamon_score_topk", "csr_rerank_topk"),
                        ("sinnamon_score", "embed_bag", "csr_score"))

    # the durable round trip: tiered -> snapshot -> resident -> tiered
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    scratch = tempfile.mkdtemp(prefix="tiered-8-", dir=root)
    try:
        n = TIER_DURABLE_DOCS
        def cfg(budget):
            return IndexConfig(
                n=N, capacity=n, m=M, h=H, max_nnz=P, seed=seed,
                device_budget_mb=budget, durability=DurabilityConfig(
                    wal_dir=os.path.join(scratch, "wal"),
                    snapshot_dir=os.path.join(scratch, "snap"),
                    snapshot_keep=1))
        t0 = time.perf_counter()
        dt = open_index(cfg(16.0), device="cuda")
        for lo in range(0, n, 32_768):
            hi = min(lo + 32_768, n)
            dt.insert_many(range(lo, hi), corpus_idx[lo:hi],
                           corpus_val[lo:hi])
        dt.delete_many(list(range(0, n, 16)))
        dt.insert_many(list(range(0, n, 16)), corpus_idx[0:n:16],
                       corpus_val[0:n:16])
        ref = answers(dt, 16)
        dt.snapshot()
        del dt
        gc.collect()
        dr = open_index(cfg(None), device="cuda")
        if not same(answers(dr, 16), ref):
            raise AssertionError("resident answers from the tiered "
                                 "snapshot != the tiered index's")
        dr.compact()                       # a logged op: a newer snapshot
        ref = answers(dr, 16)
        dr.snapshot()
        del dr
        gc.collect()
        dt2 = open_index(cfg(16.0), device="cuda")
        if not same(answers(dt2, 16), ref):
            raise AssertionError("tiered answers from the resident "
                                 "snapshot != the resident index's")
        del dt2
        out["durable_round_trip"] = {"docs": n,
                                     "wall_s": time.perf_counter() - t0}
        log(f"[8 tiered] durable round trip of {n} docs (tiered -> "
            f"snapshot -> resident -> compact + snapshot -> tiered): answers "
            f"equal at every step, "
            f"{out['durable_round_trip']['wall_s']:.1f}s")
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    out["launches"] = counts
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[8 tiered] launches {counts}; phase {out['wall_s']:.1f}s")
    return counts, out


SHARDS = 4                        # phase 9: 4 of serve_msmarco's 8 shards
SHARD_KPRIMES = (800, 64)         # phase 9: k'=800, and the deployment's 64
SHARD_BATCHES = {16: 40, 256: 8}  # phase 9: timed batches per batch size
SHARD_UPDATE_BLOCK = 16_384       # phase 9: docs per shard per write step
SHARD_SMALL = 65_536              # phase 9b: docs per shard
SHARD_TIER_MB = (48, 6)           # phase 9b: every chunk of a shard, 1/8
SHARD_TWIN_SLICE = 16             # phase 9: queries per twin-path call


def sharded_churn(docs: int) -> list:
    """1/16 of every shard's documents: ids 16j + j mod 4 (the Knuth hash
    sends id i to shard i mod 4, so every 16th id would all be shard 0's)."""
    return [16 * j + j % SHARDS for j in range(docs // 16)]


def sharded_exact_ids(index, qi, qv):
    """Exact top-K ids over a sharded index's live documents: kernel B's
    LinScan over each shard, gated and cut to K, then the shard merge."""
    import torch

    from repro_torch.distributed import topk
    from repro_torch.kernels import ops
    from repro_torch.storage import vecstore

    out = []
    for lo in range(0, qi.shape[0], 64):
        vals, pays = [], []
        for st in index.states:
            q_dense = vecstore.densify_query(N, qi[lo:lo + 64],
                                             qv[lo:lo + 64])
            exact = ops.exact_scores_all(st.store, q_dense)
            exact = torch.where(st.active[None, :], exact, -torch.inf)
            v, ids = topk.local_candidates(exact, st.ids, K)
            vals.append(v)
            pays.append(ids)
            del exact
        out.append(topk.merge_shards(vals, pays, K)[1].cpu().numpy())
    import numpy as np
    return np.concatenate(out)


def sharded_path(q_idx, q_val, seed, dev, card, cdf):
    """Phase 9: the sharded index (``serving/sharded.py``) on the card.

    (a) ``open_index(IndexConfig(shards=4, ...))`` at ``serve_msmarco``'s
    widths (n=30,000, m=64, h=1, max_nnz=128, bf16 cells and raw values),
    1,114,112 slots a shard, 4,456,448 documents drawn with phase 4's
    ``splade_like`` statistics (the Knuth hash sends id i to shard i mod 4,
    so every shard fills exactly).  Cut: 4 of the deployment's 8 shards, on
    one card; the full 8 would hold ≈42.8 GB of state (8 × (4.18 GB bitmap
    + 285 MB sketch + 855 MB rows)), above the run's own
    ``PEAK_MEMORY_MAX``.  Four shards are ≈21.4 GB.  The index writes in
    blocks of ``SHARD_UPDATE_BLOCK`` documents per shard (a block's size
    changes the number of write steps, not the state).  Shard 0's leaves
    are held bit for bit against a lone ``SinnamonIndex`` fed the documents
    the hash routes to shard 0, in the same order.  1/16 of each shard's
    documents are churned (deleted, re-inserted into the dirty slots;
    :func:`sharded_churn`), then batches
    of 16 and 256 are served at k' = 800 and 64 (the deployment's
    ``kprime_local``): p50 / p99 and q/s, launches (A and B's rerank S
    times a batch, C and D never), each shard's candidate and rerank time
    and the merge's (CUDA events), the device busy share at B=16 under
    ``torch.profiler``; recall@10 against the LinScan's exact top-10
    (gated at k'=800); the kernel path against the twin path at every k'
    and B (:func:`sharded_twin_check`); the ``score_fn``
    hook (kernel C, S launches a batch) with candidates bit-equal to the
    on-card ``reference`` backend.

    (b) 4 shards × ``SHARD_SMALL`` of the same documents: the tiered
    sharded index at ``SHARD_TIER_MB`` per shard, answers bit-equal to the
    resident sharded index before and after churn + ``compact()``; the
    durable sharded index (fsync): logged build, snapshot, a WAL tail of
    churn, the index dropped and recovered onto 4 shards bit-equal (leaves,
    free lists, id map, answers), then recovered elastically onto 2 shards
    and onto one device, answers equal to indexes built fresh from the
    live documents in ``_reinsert_live``'s order.

    Returns (launch counts of (a)'s fused batches, numbers)."""
    import numpy as np
    import torch

    import repro_torch.kernels as kernels
    from repro_torch.api import IndexConfig, open_index
    from repro_torch.core import engine as eng
    from repro_torch.kernels import sinnamon_score
    from repro_torch.serving.serve import QueryServer
    from repro_torch.serving.sharded import route_many

    t_phase = time.perf_counter()
    _PEAK_BEFORE_RESET[0] = max(_PEAK_BEFORE_RESET[0],
                                torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    docs = SHARDS * SHARD_DOCS
    out = {"card": card, "shards": SHARDS, "docs": docs,
           "update_block": SHARD_UPDATE_BLOCK}

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 9)
    corpus_idx = torch.empty((docs, P), dtype=torch.int32, device=dev)
    corpus_val = torch.empty((docs, P), dtype=torch.float32, device=dev)
    for lo in range(0, docs, 65_536):
        hi = min(lo + 65_536, docs)
        corpus_idx[lo:hi], corpus_val[lo:hi] = draw_sparse(
            gen, hi - lo, PSI_DOC, P, cdf, dev)
    torch.cuda.synchronize()
    out["data_s"] = time.perf_counter() - t0

    cfg = IndexConfig(n=N, capacity=docs, m=M, h=H, max_nnz=P, seed=seed,
                      shards=SHARDS, update_block=SHARD_UPDATE_BLOCK)
    t0 = time.perf_counter()
    index = open_index(cfg, device=dev)
    for lo in range(0, docs, 65_536):
        hi = min(lo + 65_536, docs)
        index.insert_many(range(lo, hi), corpus_idx[lo:hi],
                          corpus_val[lo:hi])
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    sizes = [SHARD_DOCS - len(f) for f in index._free]
    if index.size != docs or index.spec.capacity != SHARD_DOCS \
            or sizes != [SHARD_DOCS] * SHARDS:
        raise AssertionError(f"sharded index holds {index.size} docs, "
                             f"{sizes} a shard, capacity "
                             f"{index.spec.capacity}")
    out["memory_bytes"] = index.memory_bytes()
    log(f"[9 sharded] built {SHARDS} shards x {SHARD_DOCS} docs on one card "
        f"in {out['build_s']:.1f}s (data {out['data_s']:.1f}s); memory "
        f"{out['memory_bytes']}")

    # shard 0 against a lone index fed the documents the hash routes there
    t0 = time.perf_counter()
    lone = eng.SinnamonIndex(index.spec, device=dev)
    for lo in range(0, docs, 65_536):
        ids = np.arange(lo, min(lo + 65_536, docs))
        ids = ids[route_many(ids, SHARDS) == 0]
        lone.insert_many(ids.tolist(), corpus_idx[ids], corpus_val[ids])
    a, b = lone.state, index.states[0]
    ints = eng._ints
    same0 = (torch.equal(ints(a.sketch), ints(b.sketch))
             and torch.equal(a.bits, b.bits)
             and torch.equal(a.store.indices, b.store.indices)
             and torch.equal(ints(a.store.values), ints(b.store.values))
             and torch.equal(a.active, b.active)
             and torch.equal(a.ids, b.ids) and torch.equal(a.dirty, b.dirty)
             and torch.equal(a.mappings, b.mappings)
             and lone._free == index._free[0]
             and lone._id2slot == {e: t for e, (s, t)
                                   in index._id2slot.items() if s == 0})
    del lone, a, b
    gc.collect()
    torch.cuda.empty_cache()
    if not same0:
        raise AssertionError("shard 0 != a lone SinnamonIndex fed its "
                             "documents")
    log(f"[9 sharded] shard 0's leaves, free list and slot map bit-equal to "
        f"a lone SinnamonIndex fed the {SHARD_DOCS} documents routed there "
        f"({time.perf_counter() - t0:.1f}s)")

    churn = sharded_churn(docs)
    t0 = time.perf_counter()
    index.delete_many(churn)
    churn_t = torch.tensor(churn, device=dev)
    for lo in range(0, len(churn), 65_536):
        part = churn_t[lo:lo + 65_536]
        index.insert_many(part, corpus_idx[part], corpus_val[part])
    torch.cuda.synchronize()
    out["churn_s"] = time.perf_counter() - t0
    n_dirty = sum(int(st.dirty.sum()) for st in index.states)
    if index.size != docs or n_dirty != len(churn):
        raise AssertionError(f"after churn: {index.size} docs, {n_dirty} "
                             f"dirty")
    log(f"[9 sharded] churned {len(churn)} docs (delete + re-insert into "
        f"{n_dirty} dirty slots) in {out['churn_s']:.1f}s")

    # serving: batches of 16 and 256 at k' = 800 and 64
    t_serve = time.perf_counter()
    counts = {name: 0 for name in kernels.launch_counts()}
    out["serve"] = {}
    answers = {}
    for kp in SHARD_KPRIMES:
        server = QueryServer(index, k=K, kprime=kp)
        server.query_many(q_idx[:16], q_val[:16])               # warm-up
        for bsz, n_batches in SHARD_BATCHES.items():
            kernels.reset_launch_counts()
            walls, ids = [], []
            for i in range(n_batches):
                lo = (i * bsz) % (512 - bsz + 1)
                t0 = time.perf_counter()
                res = server.query_many(q_idx[lo:lo + bsz],
                                        q_val[lo:lo + bsz])
                walls.append((time.perf_counter() - t0) * 1e3)
                if res.ids.shape != (bsz, K) or not np_all_finite(res.scores):
                    raise AssertionError(f"bad sharded result at B={bsz}")
                ids.append((lo, res))
            got = kernels.launch_counts()
            tiles = -(-index.states[0].sketch.shape[1]
                      // sinnamon_score.TILE_C)
            two = sinnamon_score.two_pass_stride(bsz, tiles, kp) > 0
            want = {"sinnamon_score_topk": SHARDS * n_batches,
                    "sinnamon_score_threshold": SHARDS * n_batches * two,
                    "csr_rerank_topk": SHARDS * n_batches,
                    "sinnamon_score": 0, "embed_bag": 0, "csr_score": 0,
                    "embed_bag_backward": 0}
            if got != want:
                raise AssertionError(f"sharded launches at B={bsz}, "
                                     f"k'={kp}: {got}, want {want}")
            for name, n in got.items():
                counts[name] += n
            answers[(kp, bsz)] = ids
            out["serve"][f"k'={kp} B={bsz}"] = request_latency(walls, bsz)
            r = out["serve"][f"k'={kp} B={bsz}"]
            log(f"[9 sharded] k'={kp} B={bsz}: p50 / p99 {r['p50']:.3f} / "
                f"{r['p99']:.3f} ms, {r['qps']:.0f} q/s over {n_batches} "
                f"batches; launches {got}")
    staged = QueryServer(index, k=K, kprime=KPRIME, trace_every=1)
    lo, res16 = answers[(KPRIME, 16)][-1]
    sres = staged.query_many(q_idx[lo:lo + 16], q_val[lo:lo + 16])
    if not (sres.ids == res16.ids).all():
        raise AssertionError("staged sharded ids != served ids")
    out["staged_spans_ms"] = {sp.name: sp.ms for sp in staged.last_trace.spans}
    log(f"[9 sharded] staged batch (B=16): {out['staged_spans_ms']}")

    # recall@10 against the exact top-10 (LinScan per shard + merge)
    steps = out["steps_s"] = {"serve": time.perf_counter() - t_serve}
    t0 = time.perf_counter()
    qi256, qv256 = q_idx[:256], q_val[:256]
    kernels.reset_launch_counts()
    truth = sharded_exact_ids(index, qi256, qv256)
    ls_counts = kernels.launch_counts()
    check_path_launches(ls_counts, "sharded recall ground truth",
                        ("csr_score",), ("sinnamon_score_topk",
                                         "sinnamon_score_threshold"))
    out["recall"] = {}
    for kp in SHARD_KPRIMES:
        ids = np.concatenate([index.search_many(
            qi256[lo:lo + 64], qv256[lo:lo + 64], K, kprime=kp)[0]
            for lo in range(0, 256, 64)])
        out["recall"][f"k'={kp}"] = recall_at_k(ids, truth)
    log(f"[9 sharded] recall@{K} over 256 queries against the exact LinScan "
        f"({ls_counts['csr_score']} LinScan launches): {out['recall']}")
    recall = out["recall"][f"k'={KPRIME}"]
    if recall < RECALL_MIN:
        raise AssertionError(f"sharded recall@{K} at k'={KPRIME} "
                             f"{recall:.4f} < {RECALL_MIN}")

    steps["recall"] = time.perf_counter() - t0

    # kernel path == twin path at every k' and B; the score_fn hook == the
    # reference backend
    t0 = time.perf_counter()
    out["twin_max_abs_diff"] = sharded_twin_check(index, q_idx, q_val)
    steps["twin"] = time.perf_counter() - t0
    qi16, qv16 = q_idx[:16].contiguous(), q_val[:16].contiguous()
    ids_k, _ = index.search_many(qi16, qv16, K, kprime=KPRIME)
    t0 = time.perf_counter()
    hook_counts, out["hook_ids_equal_fused"] = sharded_hook(
        index, qi16, qv16, ids_k)
    steps["hook"] = time.perf_counter() - t0
    log(f"[9 sharded] score_fn hook (kernel C): launches {hook_counts}; "
        f"every shard's candidates bit-equal to the on-card reference "
        f"backend; ids == fused ids: {out['hook_ids_equal_fused']}")
    t0 = time.perf_counter()
    out["stages_ms"] = sharded_stage_times(index, q_idx, q_val)
    steps["stages"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # device busy share at B=16, k'=800 (a profiler window costs seconds)
    server = QueryServer(index, k=K, kprime=KPRIME)
    wall, by_name = device_profile(lambda: server.query_many(qi16, qv16), 20)
    out["busy_B=16"] = busy_summary(wall, by_name)
    log(f"[9 sharded] k'={KPRIME} B=16 under torch.profiler: "
        f"{out['busy_B=16']}")
    steps["busy"] = time.perf_counter() - t0
    log(f"[9 sharded] seconds per step: {steps}")
    del index, server, staged
    gc.collect()
    torch.cuda.empty_cache()
    out["peak_a_bytes"] = torch.cuda.max_memory_allocated()

    small = sharded_small(corpus_idx, corpus_val, q_idx[:256], q_val[:256],
                          seed, dev)
    out.update(small)
    del corpus_idx, corpus_val
    gc.collect()
    torch.cuda.empty_cache()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    if out["peak_bytes"] >= PEAK_MEMORY_MAX:
        raise AssertionError(f"phase 9 peak device memory "
                             f"{out['peak_bytes'] / 1e9:.2f} GB >= "
                             f"{PEAK_MEMORY_MAX / 1e9:.0f} GB")
    out["launches"] = counts
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[9 sharded] launches {counts}; peak {out['peak_bytes'] / 2**30:.2f}"
        f" GiB; phase {out['wall_s']:.1f}s ({card})")
    return counts, out


def sharded_twin_check(index, q_idx, q_val) -> dict:
    """Phase 9: the sharded kernel path against its twin path
    (``use_kernel=False``: kernel A's, the tile merge's and B's rerank's
    plain versions) at every k' of ``SHARD_KPRIMES`` and B of
    ``SHARD_BATCHES``.  Ids and (shard, slot) locators must be equal and
    scores within kernel B's rtol = atol = 1e-5.  The kernel path takes the
    whole batch in one call, at the main path's shapes; the twin path takes
    it ``SHARD_TWIN_SLICE`` queries a call (at B=256 its dense [B, C]
    intermediates over a 1,114,112-slot shard would pass the run's memory
    bound), which gives every query the same answer.  Returns the largest
    score difference per k' and B."""
    import numpy as np

    out = {}
    for kp in SHARD_KPRIMES:
        for bsz in SHARD_BATCHES:
            qi, qv = q_idx[:bsz].contiguous(), q_val[:bsz].contiguous()
            ids_k, sc_k, loc_k = index.search_many(qi, qv, K, kprime=kp,
                                                   return_locators=True)
            twin = [index.search_many(qi[lo:lo + SHARD_TWIN_SLICE],
                                      qv[lo:lo + SHARD_TWIN_SLICE], K,
                                      kprime=kp, return_locators=True,
                                      use_kernel=False)
                    for lo in range(0, bsz, SHARD_TWIN_SLICE)]
            ids_p, sc_p, loc_p = (np.concatenate(x) for x in zip(*twin))
            what = f"k'={kp} B={bsz}"
            if not (np.array_equal(ids_k, ids_p)
                    and np.array_equal(loc_k, loc_p)):
                raise AssertionError(f"sharded kernel-path ids/locators != "
                                     f"twin-path ones at {what}")
            np.testing.assert_allclose(sc_k, sc_p, rtol=1e-5, atol=1e-5,
                                       err_msg=f"sharded scores at {what}")
            out[what] = float(np.max(np.abs(sc_k - sc_p)))
    log(f"[9 sharded] kernel path == twin path (ids and locators equal, "
        f"scores within rtol=atol=1e-5) at every k' and B; score max abs "
        f"diff {out}")
    return out


def sharded_hook(index, qi, qv, fused_ids):
    """The ``score_fn`` hook (kernel C) on a sharded batch: its launches (C
    and B's rerank once a shard, A never), every shard's candidates
    bit-equal to the on-card ``reference`` backend's; returns (launch
    counts, ids equal to the fused path's)."""
    import numpy as np
    import torch

    import repro_torch.kernels as kernels
    from repro_torch.core import engine as eng
    from repro_torch.kernels import ops

    score_fn = ops.make_engine_score_fn()
    kernels.reset_launch_counts()
    hook_ids, _ = index.search_many(qi, qv, K, kprime=KPRIME,
                                    score_fn=score_fn)
    counts = kernels.launch_counts()
    if counts != {"sinnamon_score_topk": 0, "sinnamon_score_threshold": 0,
                  "csr_score": 0,
                  "sinnamon_score": index.n_shards, "embed_bag": 0,
                  "csr_rerank_topk": index.n_shards,
                  "embed_bag_backward": 0}:
        raise AssertionError(f"hook launches {counts}")
    for s, st in enumerate(index.states):
        cv, cs = eng.topk_candidates(st, index.spec, qi, qv, KPRIME,
                                     score_fn=score_fn)
        rv, rs = eng.topk_candidates(st, index.spec, qi, qv, KPRIME,
                                     backend="reference")
        if not (torch.equal(cs, rs) and torch.equal(cv.view(torch.int32),
                                                    rv.view(torch.int32))):
            raise AssertionError(f"shard {s}: hook candidates != the "
                                 f"reference backend's")
    return counts, bool(np.array_equal(hook_ids, fused_ids))


def sharded_stage_times(index, q_idx, q_val) -> dict:
    """CUDA-event ms of each shard's candidates (kernel A + tile merge) and
    rerank (B's rerank kernel), and of the shard merge, per k' and B."""
    from repro_torch.core import engine as eng

    out = {}
    for kp in SHARD_KPRIMES:
        for bsz in SHARD_BATCHES:
            qi, qv = q_idx[:bsz].contiguous(), q_val[:bsz].contiguous()
            row = {"candidates": [], "rerank": []}
            parts = []
            for st in index.states:
                def cand(st=st):
                    return eng.topk_candidates(st, index.spec, qi, qv, kp)
                row["candidates"].append(cuda_ms(cand, 5))
                ub, sl = cand()

                def rerank(st=st, ub=ub, sl=sl):
                    return eng.rerank_topk(st, ub, sl, qi, qv, min(K, kp))
                row["rerank"].append(cuda_ms(rerank, 20))
                ids, sc, slots = rerank()
                parts.append((sc, ids, slots))
            row["merge"] = cuda_ms(lambda: index._merge(parts, K), 50)
            row["sum"] = (sum(row["candidates"]) + sum(row["rerank"])
                          + row["merge"])
            row["merge_share"] = row["merge"] / row["sum"]
            out[f"k'={kp} B={bsz}"] = row
            log(f"[9 sharded] k'={kp} B={bsz} CUDA events: candidates per "
                f"shard {[round(x, 4) for x in row['candidates']]} ms, "
                f"rerank {[round(x, 4) for x in row['rerank']]} ms, merge "
                f"{row['merge']:.4f} ms ({100 * row['merge_share']:.2f}% of "
                f"{row['sum']:.3f} ms)")
    return out


def sharded_small(corpus_idx, corpus_val, qi, qv, seed, dev) -> dict:
    """Phase 9b: the tiered and durable sharded indexes on 4 shards ×
    ``SHARD_SMALL`` documents (see :func:`sharded_path`)."""
    import numpy as np
    import torch

    from repro_torch.api import DurabilityConfig, IndexConfig, open_index
    from repro_torch import convert
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.serving.serve import QueryServer

    n = SHARDS * SHARD_SMALL
    out = {"small_docs": n}
    churn = sharded_churn(n)
    churn_t = torch.tensor(churn, device=dev)

    def cfg(**kw):
        return IndexConfig(n=N, capacity=n, m=M, h=H, max_nnz=P, seed=seed,
                           update_block=SHARD_UPDATE_BLOCK,
                           **{"shards": SHARDS, **kw})

    def build(ix):
        for lo in range(0, n, 32_768):
            hi = min(lo + 32_768, n)
            ix.insert_many(range(lo, hi), corpus_idx[lo:hi],
                           corpus_val[lo:hi])
        return ix

    def churn_in(ix):
        ix.delete_many(churn)
        for lo in range(0, len(churn), 32_768):
            part = churn_t[lo:lo + 32_768]
            ix.insert_many(part, corpus_idx[part], corpus_val[part])

    def answers(ix):
        parts = [ix.search_many(qi[lo:lo + 16], qv[lo:lo + 16], K,
                                kprime=KPRIME) for lo in range(0, 256, 16)]
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))

    def same(a, b):
        return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])

    # -- tiered sharded beside the resident sharded index ---------------------
    def p50_b16(ix) -> dict:
        server = QueryServer(ix, k=K, kprime=KPRIME)
        server.query_many(qi[:16], qv[:16])                      # warm-up
        walls = []
        for i in range(20):
            lo = (i * 16) % (256 - 16 + 1)
            t1 = time.perf_counter()
            server.query_many(qi[lo:lo + 16], qv[lo:lo + 16])
            walls.append((time.perf_counter() - t1) * 1e3)
        return request_latency(walls, 16)

    t0 = time.perf_counter()
    resident = build(open_index(cfg(), device=dev))
    want = answers(resident)
    out["resident_B=16"] = p50_b16(resident)
    churn_in(resident)
    n_res = resident.compact()
    want_after = answers(resident)
    del resident
    gc.collect()
    out["tiered"] = {}
    for mb in SHARD_TIER_MB:
        tiered = build(open_index(cfg(device_budget_mb=mb), device=dev))
        t = tiered.tiers[0]
        if not same(answers(tiered), want):
            raise AssertionError(f"tiered sharded ({mb} MiB) != resident")
        s0 = [x.stats() for x in tiered.tiers]
        lat = p50_b16(tiered)
        s1 = [x.stats() for x in tiered.tiers]
        per = {k: sum(b[k] - a[k] for a, b in zip(s0, s1)) / 21
               for k in ("hits", "misses", "fallbacks", "promotions")}
        staged = QueryServer(tiered, k=K, kprime=KPRIME, trace_every=1)
        staged.query_many(qi[:16], qv[:16])
        spans = {sp.name: sp.ms for sp in staged.last_trace.spans}
        churn_in(tiered)
        n_tier = tiered.compact()
        if n_tier != n_res or not same(answers(tiered), want_after):
            raise AssertionError(f"tiered sharded ({mb} MiB) after churn + "
                                 f"compact != resident ({n_tier} vs {n_res}"
                                 f" columns)")
        out["tiered"][f"{mb} MiB"] = {
            "cache_chunks": t.cache_chunks, "num_chunks": t.num_chunks,
            "B=16": lat, "per_batch_all_shards": per,
            "staged_spans_ms": spans}
        log(f"[9b tiered] {mb} MiB a shard ({t.cache_chunks} of "
            f"{t.num_chunks} chunks): answers bit-equal to the resident "
            f"sharded index before and after churn + compact ({n_tier} "
            f"columns); B=16 p50 {lat['p50']:.3f} ms (resident sharded "
            f"{out['resident_B=16']['p50']:.3f}); per batch over the shards "
            f"{per}; spans {spans}")
        del tiered, staged, t
        gc.collect()
    torch.cuda.empty_cache()
    out["tiered_s"] = time.perf_counter() - t0

    # -- durable sharded: log, snapshot, tail, recover, elastic --------------
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    scratch = tempfile.mkdtemp(prefix="sharded-9-", dir=root)
    prev = obs_metrics.set_registry(obs_metrics.MetricsRegistry())
    try:
        t_d = time.perf_counter()
        dur = DurabilityConfig(wal_dir=os.path.join(scratch, "wal"),
                               snapshot_dir=os.path.join(scratch, "snap"),
                               fsync=True, snapshot_keep=1)
        live = open_index(cfg(durability=dur), device=dev)
        t0 = time.perf_counter()
        build(live)
        torch.cuda.synchronize()
        d = {"log_apply_s": time.perf_counter() - t0}
        app = obs_metrics.get_registry().snapshot()["repro_wal_append_ms"]
        app = app["series"][0]
        d["wal_records"] = app["count"]
        d["wal_bytes"] = dir_bytes(dur.wal_dir)
        d["append_mb_per_s"] = d["wal_bytes"] / 1e6 / (app["sum"] / 1e3)
        t0 = time.perf_counter()
        path = live.snapshot()
        d["snapshot_s"] = time.perf_counter() - t0
        d["snapshot_bytes"] = dir_bytes(path)
        churn_in(live)
        live.compact()
        want = answers(live)
        leaves = convert.state_to_numpy(live.logical_state(), live.spec)
        free, id2slot = [list(f) for f in live._free], dict(live._id2slot)
        for w in live._writers.values():
            w.close()
        del live
        gc.collect()
        t0 = time.perf_counter()
        rec = open_index(cfg(durability=dur), device=dev)
        torch.cuda.synchronize()
        d["recover_s"] = time.perf_counter() - t0
        d["recovery_timings"] = rec.recovery_timings
        got = convert.state_to_numpy(rec.logical_state(), rec.spec)
        if not (sorted(got) == sorted(leaves)
                and all(np.array_equal(got[k], leaves[k]) for k in leaves)
                and rec._free == free and rec._id2slot == id2slot
                and same(answers(rec), want)):
            raise AssertionError("recovered sharded index != the live one")
        log(f"[9b durable] logged build of {n} docs in "
            f"{d['log_apply_s']:.2f}s ({d['wal_records']} records, "
            f"{d['wal_bytes']} B, appends with fsync "
            f"{d['append_mb_per_s']:.1f} MB/s); snapshot "
            f"{d['snapshot_bytes']} B in {d['snapshot_s']:.2f}s; recovered "
            f"onto {SHARDS} shards in {d['recover_s']:.2f}s "
            f"({d['recovery_timings']}): leaves, free lists, id map and 256 "
            f"answers bit-equal to the live index")
        t0 = time.perf_counter()
        rec.snapshot()             # covers the tail: elastic = fresh re-insert
        d["snapshot_again_s"] = time.perf_counter() - t0
        live_ids = rec.doc_ids()
        for w in rec._writers.values():
            w.close()
        del rec, got, leaves
        gc.collect()
        ordered = torch.tensor(live_ids, device=dev)
        d["elastic"] = {}
        for shards in (2, 1):
            t0 = time.perf_counter()
            el = open_index(cfg(durability=dur, shards=shards), device=dev)
            torch.cuda.synchronize()
            el_s = time.perf_counter() - t0
            fresh = open_index(cfg(shards=shards), device=dev)
            vals = corpus_val[:n].to(torch.bfloat16).float()  # stored rows
            for lo in range(0, len(live_ids), 512):
                part = ordered[lo:lo + 512]
                fresh.insert_many(part, corpus_idx[part], vals[part])
            del vals
            if el.doc_ids() != live_ids or not same(answers(el),
                                                    answers(fresh)):
                raise AssertionError(f"elastic recovery onto {shards} "
                                     f"shard(s) != a fresh build")
            d["elastic"][f"{shards} shard(s)"] = {
                "recover_s": el_s, "type": type(el).__name__,
                "recovery_timings": el.recovery_timings}
            log(f"[9b durable] elastic recovery onto {shards} shard(s) "
                f"({type(el).__name__}) in {el_s:.2f}s "
                f"({el.recovery_timings}; the rest is the rebased snapshot): "
                f"answers equal to an index built fresh in _reinsert_live's "
                f"order")
            for w in el._writers.values():
                w.close()
            del el, fresh
            gc.collect()
        d["wall_s"] = time.perf_counter() - t_d
        out["durable"] = d
    finally:
        obs_metrics.set_registry(prev)
        shutil.rmtree(scratch, ignore_errors=True)
    return out


def kernel_d_against_twin(gen, dev, seed: int) -> None:
    """Phase 3, kernel D: the flat form bit-equal to its twin for f32 and
    bf16 tables, D in {18, 64} (scalar and 16-byte loads), F in {1, 4, 40},
    20% pads and signed weights, and ``mean`` through ``ops.embed_bag``;
    the stacked form (26 fields, hot 1 and 4, weights and none) bit-equal
    to its twin, written into rows 1.. of a
    [B, 27, D] buffer whose row 0 it leaves as it was."""
    import torch

    from repro_torch.kernels import embed_bag, ops
    V, bags = 5_000, 4_096
    cases = 0
    for cell in (torch.float32, torch.bfloat16):
        for D in (18, 64):
            table = torch.randn((V, D), generator=gen, device=dev).to(cell)
            for F in (1, 4, 40):
                idx = torch.randint(0, V, (bags, F), generator=gen,
                                    device=dev, dtype=torch.int32)
                pad = torch.rand((bags, F), generator=gen, device=dev) < 0.2
                idx = torch.where(pad, -1, idx)
                w = torch.randn((bags, F), generator=gen, device=dev)
                pairs = [(embed_bag.embed_bag(table, idx, w),
                          embed_bag.embed_bag_plain(table, idx, w)),
                         (ops.embed_bag(table, idx, w, mode="mean"),
                          ops.embed_bag(table, idx, w, mode="mean",
                                        use_kernel=False))]
                torch.cuda.synchronize()
                for got, want in pairs:
                    if got.shape != (bags, D) or not torch.equal(
                            got.view(torch.int32), want.view(torch.int32)):
                        raise AssertionError(f"kernel D != twin for {cell} "
                                             f"D={D} F={F}")
                cases += 2
    log(f"[3 kernels] embed_bag: {cases} cases bit-equal to the twin "
        f"({bags} bags, V={V}; f32 and bf16 tables, D in (18, 64), F in "
        f"(1, 4, 40), 20% pads, signed weights; sum and mean)")
    # its own generator: the main path's corpus and queries stay the draws
    # of earlier runs
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 2)
    Fs, Bs, cases = 26, 512, 0
    for cell in (torch.float32, torch.bfloat16):
        tables = torch.randn((Fs, V, 64), generator=gen,
                             device=dev).to(cell)
        for hot in (1, 4):
            idx = torch.randint(0, V, (Bs, Fs, hot), generator=gen,
                                device=dev, dtype=torch.int32)
            pad = torch.rand((Bs, Fs, hot), generator=gen, device=dev) < 0.2
            idx = torch.where(pad, -1, idx)
            w = torch.randn((Bs, Fs, hot), generator=gen, device=dev)
            for weights in (w, None):
                want = embed_bag.stacked_embed_bag_plain(tables, idx, weights)
                vecs = torch.full((Bs, Fs + 1, 64), torch.nan, device=dev)
                embed_bag.embed_bag(tables, idx, weights, out=vecs[:, 1:])
                torch.cuda.synchronize()
                if not torch.equal(vecs[:, 1:].contiguous().view(
                        torch.int32), want.view(torch.int32)) or \
                        not torch.isnan(vecs[:, 0]).all():
                    raise AssertionError(f"stacked kernel D != twin for "
                                         f"{cell} hot={hot}")
                cases += 1
    log(f"[3 kernels] embed_bag stacked form: {cases} cases bit-equal to "
        f"the twin ({Bs} x {Fs} bags into a [{Bs}, {Fs + 1}, 64] buffer, "
        f"row 0 untouched; f32 and bf16 tables, hot 1 and 4, weights and "
        f"none)")


TRAIN_TIMED = 8                   # phase 10a: timed steps after one warm-up
SEQ_TRAIN_STEPS = 3               # phase 10b: train steps a model
SEQ_REQUESTS = 200                # phase 10b: requests a serving shape
RESUME_VOCAB = 65_536             # phase 10c: rows a field (of 1,000,000)
RESUME_STEPS = 6                  # phase 10c: 3 + save + restore + 3


def train_path(seed: int, dev, card: str):
    """Phase 10: recsys training on the card (10a dlrm-rm2 at full width
    and the train batch, 10b din / sasrec / mind at full config, 10c
    resume).  Returns (kernel D's backward JSON row, the train JSON line,
    the launch counts of 10a's train steps)."""
    import torch

    from repro_torch.configs import dlrm_rm2

    t_phase = time.perf_counter()
    cfg = dlrm_rm2.full_config()
    B = dlrm_rm2.SHAPES["train_batch"]["batch"]
    bwd_row, line, counts = dlrm_train(cfg, B, seed, dev, card)
    for arch in ("din", "sasrec", "mind"):
        line[arch] = seq_model_train_serve(arch, B, seed, dev)
    line["resume"] = train_resume(cfg, B, seed, dev)
    line["wall_s"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    log(f"[10 train] phase {line['wall_s']:.1f}s ({card})")
    return bwd_row, line, counts


def _fresh_dlrm(cfg, seed, dev, draw=True):
    import torch

    from repro_torch.models import recsys
    gen = torch.Generator(device=dev).manual_seed(seed) if draw else None
    return recsys.DLRM(cfg, gen, device=dev, draw=draw)


def _dlrm_on_card(hb, dev):
    """The fields DLRM's loss reads, copied to the card."""
    return hb._replace(dense=hb.dense.to(dev), sparse=hb.sparse.to(dev),
                       labels=hb.labels.to(dev))


def _seq_on_card(hb, dev):
    """The fields DIN / SASRec / MIND read, copied to the card."""
    return hb._replace(hist=hb.hist.to(dev), target=hb.target.to(dev),
                       labels=hb.labels.to(dev))


def _new_peak() -> None:
    """Keep the run's peak so far, then count a new phase's own."""
    import torch
    _PEAK_BEFORE_RESET[0] = max(_PEAK_BEFORE_RESET[0],
                                torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()


def dlrm_train(cfg, B: int, seed: int, dev, card: str):
    """10a: kernel D's backward against its twin at the train batch, a
    twin-path step against the kernel path's first step from the same
    state, then 8 timed steps and a CUDA-event split of one more."""
    import torch

    import repro_torch.kernels as kernels
    from repro_torch.data import loaders
    from repro_torch.kernels import embed_bag
    from repro_torch.models import recsys
    from repro_torch.optim import adamw
    from repro_torch.train import loop

    _new_peak()
    steps = 1 + TRAIN_TIMED
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=10, decay_steps=steps)
    t0 = time.perf_counter()
    hbs = [loaders.recsys_batch(seed, s, B, cfg, device="cpu")
           for s in range(steps + 1)]
    log(f"[10a train] {cfg.name}: {steps + 1} host batches of {B} drawn in "
        f"{time.perf_counter() - t0:.1f}s")
    F, V, D = cfg.n_sparse, cfg.vocab_per_field, cfg.embed_dim

    # -- kernel D's backward at the train batch, against its twin ----------
    model = _fresh_dlrm(cfg, seed, dev)
    b0 = _dlrm_on_card(hbs[0], dev)
    vecs = model.interaction_input(b0.dense, b0.sparse)
    loss = recsys._bce(model.head(vecs), b0.labels)
    (g_vecs,) = torch.autograd.grad(loss, vecs)
    del vecs, loss
    grad = g_vecs[:, 1:]                     # the view the backward reads
    sparse = b0.sparse.to(torch.int32).contiguous()
    got = embed_bag.embed_bag_backward(grad, sparse, V)
    again = embed_bag.embed_bag_backward(grad, sparse, V)
    torch.cuda.synchronize()
    same = torch.equal(got.view(torch.int32), again.view(torch.int32))
    del again
    t0 = time.perf_counter()
    got_host = got.cpu()
    del got
    want = embed_bag.embed_bag_backward_plain(grad.cpu(), sparse.cpu(), V)
    bit_equal = torch.equal(got_host.view(torch.int32),
                            want.view(torch.int32))
    err = 0.0 if bit_equal else finite_max_err(got_host, want)
    del got_host, want
    log(f"[10a train] embed_bag_backward at B={B}: [{F}, {V}, {D}] f32 "
        f"gradient from rows 1.. of the [{B}, {F + 1}, {D}] buffer's "
        f"gradient: {'bit-equal' if bit_equal else 'NOT bit-equal'} to the "
        f"twin on the host copy (max abs err {err:.3g}; host check "
        f"{time.perf_counter() - t0:.1f}s); two launches "
        f"{'bit-equal' if same else 'DIFFER'}")
    if not (bit_equal and same):
        raise AssertionError("kernel D's backward != its twin, or not "
                             "deterministic")
    row = backward_times(grad, sparse, V, card)
    row["max_abs_err"] = err
    del g_vecs, grad, model
    gc.collect()
    torch.cuda.empty_cache()

    # -- a twin-path step from the fresh state ---------------------------
    t0 = time.perf_counter()
    model = _fresh_dlrm(cfg, seed, dev)
    step = loop.make_train_step(
        lambda p, b: (recsys.loss(p, b, cfg, use_kernel=False), {}), opt_cfg)
    st, m = step(loop.init_state(model), b0)
    twin_loss = float(m["loss"])
    twin = {k: t.detach().cpu() for k, t in model.leaves().items()}
    del st, m, model, step
    gc.collect()
    torch.cuda.empty_cache()
    t_twin = time.perf_counter() - t0

    # -- the kernel path: one warm-up step, then the timed steps ------------
    model = _fresh_dlrm(cfg, seed, dev)
    state = loop.init_state(model)
    torch.cuda.synchronize()
    state_bytes = sum(t.numel() * t.element_size() for t in (
        *model.leaves().values(), *state.opt.m.values(),
        *state.opt.v.values()))
    step = loop.make_train_step(
        lambda p, b: (recsys.loss(p, b, cfg), {}), opt_cfg)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    state, m = step(state, _dlrm_on_card(hbs[0], dev))
    losses, norms = [float(m["loss"])], [float(m["grad_norm"])]
    t_first = time.perf_counter() - t0
    diffs = {}
    for k, t in model.leaves().items():
        a = t.detach().cpu()
        diffs[k] = float((a - twin[k]).abs().max())
        if not torch.allclose(a, twin[k], rtol=1e-5, atol=1e-6):
            raise AssertionError(f"kernel-path step != twin-path step at "
                                 f"{k}: max abs diff {diffs[k]:.3g}")
        del a
    del twin
    if abs(losses[0] - twin_loss) > 1e-5 * abs(twin_loss):
        raise AssertionError(f"kernel-path loss {losses[0]} != twin-path "
                             f"loss {twin_loss}")
    log(f"[10a train] first step from the drawn state: kernel path loss "
        f"{losses[0]!r}, twin path {twin_loss!r}; parameters within rtol "
        f"1e-5 / atol 1e-6, max abs diff {max(diffs.values()):.3g} "
        f"(tables {diffs['tables']:.3g}); twin step + host copy "
        f"{t_twin:.1f}s, kernel step {t_first * 1e3:.1f} ms")
    walls = []
    for s in range(1, steps):
        t0 = time.perf_counter()
        state, m = step(state, _dlrm_on_card(hbs[s], dev))
        losses.append(float(m["loss"]))
        walls.append((time.perf_counter() - t0) * 1e3)
        norms.append(float(m["grad_norm"]))
    counts = kernels.launch_counts()
    if not np_all_finite(losses + norms):
        raise AssertionError(f"non-finite loss or grad norm: {losses} "
                             f"{norms}")
    for k in ("embed_bag", "embed_bag_backward"):
        if counts[k] != steps:
            raise AssertionError(f"{k} launched {counts[k]} times in "
                                 f"{steps} train steps")
    check_path_launches(counts, "train", ("embed_bag", "embed_bag_backward"),
                        ("sinnamon_score_topk", "sinnamon_score_threshold",
                         "csr_score", "sinnamon_score", "csr_rerank_topk"))
    split = step_split(model, state, hbs[steps], cfg, opt_cfg, dev)
    peak = torch.cuda.max_memory_allocated()
    w = sorted(walls)
    p50 = w[len(w) // 2] if len(w) % 2 else (w[len(w) // 2 - 1]
                                             + w[len(w) // 2]) / 2
    log(f"[10a train] {TRAIN_TIMED} timed steps at B={B}: wall p50 "
        f"{p50:.2f} ms, max {max(walls):.2f} ms, "
        f"{B * len(walls) / (sum(walls) / 1e3):.0f} samples/s (batch "
        f"copied to the card inside the clock); losses {losses}; grad "
        f"norms {norms}; launches {counts}")
    log(f"[10a train] one step split (CUDA events): forward "
        f"{split['forward_ms']:.3f} ms, backward {split['backward_ms']:.3f} "
        f"ms (kernel D's backward {split['d_backward_ms']:.3f} ms of it, "
        f"operand sort included), clip + AdamW {split['update_ms']:.3f} ms; "
        f"train state {state_bytes} B; peak device memory "
        f"{peak / 1e9:.2f} GB ({card})")
    if peak >= PEAK_MEMORY_MAX:
        raise AssertionError(f"phase 10a peak device memory "
                             f"{peak / 1e9:.2f} GB >= "
                             f"{PEAK_MEMORY_MAX / 1e9:.0f} GB")
    row["launches"] = counts["embed_bag_backward"]
    line = {"dlrm": {"model": cfg.name, "batch": B, "timed_steps":
                     len(walls), "step_p50_ms": p50,
                     "step_max_ms": max(walls), "step_walls_ms": walls,
                     "samples_per_s": B * len(walls) / (sum(walls) / 1e3),
                     "split_ms": split, "losses": losses,
                     "grad_norms": norms, "state_bytes": state_bytes,
                     "peak_bytes": peak, "twin_step": {
                         "loss": twin_loss, "kernel_loss": losses[0],
                         "max_abs_param_diff": diffs},
                     "backward_bit_equal": bit_equal,
                     "backward_deterministic": same}}
    del state, model, step
    gc.collect()
    torch.cuda.empty_cache()
    return row, line, counts


def step_split(model, state, hb, cfg, opt_cfg, dev) -> dict:
    """CUDA events around one train step's forward, backward (and kernel D's
    backward inside it, through ``ops.embed_bag_backward``) and the clip +
    AdamW update, the step the train loop takes."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import recsys
    from repro_torch.optim import adamw

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    orig = ops.embed_bag_backward

    def timed(*a, **k):
        ev[4].record()
        out = orig(*a, **k)
        ev[5].record()
        return out

    b = _dlrm_on_card(hb, dev)
    for p in model.parameters():
        p.grad = None
    ops.embed_bag_backward = timed
    try:
        ev[0].record()
        loss = recsys.loss(model, b, cfg)
        ev[1].record()
        loss.backward()
        ev[2].record()
        adamw.update(model.leaves(grad=True), state.opt,
                     model.leaves(), opt_cfg)
        ev[3].record()
        torch.cuda.synchronize()
    finally:
        ops.embed_bag_backward = orig
        for p in model.parameters():
            p.grad = None
    return {"forward_ms": ev[0].elapsed_time(ev[1]),
            "backward_ms": ev[1].elapsed_time(ev[2]),
            "d_backward_ms": ev[4].elapsed_time(ev[5]),
            "update_ms": ev[2].elapsed_time(ev[3])}


def backward_times(grad, sparse, V: int, card: str) -> dict:
    """Kernel D's backward at the train batch: CUDA events of the wrapper
    (operand sort + kernel), of the sort alone, of the kernel alone on
    prepared operands (``kernel_ms``; ``pads_only_ms`` with every slot a
    pad: the spans' writes without the runs), of ``torch.zeros`` of the
    [F·V, D] output (``memset_ms``: the card's write rate for this
    buffer), of the twin on the card (``index_add_`` with atomics) and of
    ``index_add_`` into a zeroed buffer over the same flat rows (the
    library yardstick; its rows and sources prepared outside the clock),
    and the byte bound with the kernel's share of it."""
    import torch

    from repro_torch.kernels import embed_bag
    B, F, D = grad.shape
    hot = sparse.shape[-1]
    ms = cuda_ms(lambda: embed_bag.embed_bag_backward(grad, sparse, V), 5)
    prep_ms = cuda_ms(lambda: embed_bag.backward_operands(sparse, V), 5)
    keys, slots = embed_bag.backward_operands(sparse, V)
    kernel_ms = cuda_ms(lambda: embed_bag.backward_kernel(
        grad, keys, slots, hot, V), 5)
    # the same launch with every slot a pad: the spans' zeros, the pre-pass
    # and the heads scan, no run; the rest of kernel_ms is the runs' work
    pads = torch.full_like(keys, F * V)
    order = torch.arange(keys.numel(), device=keys.device)
    pads_ms = cuda_ms(lambda: embed_bag.backward_kernel(
        grad, pads, order, hot, V), 5)
    del keys, slots, pads, order
    memset_ms = cuda_ms(lambda: torch.zeros((F * V, D), device=grad.device),
                        5)
    plain_ms = cuda_ms(lambda: embed_bag.embed_bag_backward_plain(
        grad, sparse, V), 3)
    offs = torch.arange(F, device=sparse.device)[None, :, None] * V
    rows = torch.where(sparse >= 0, sparse.long() + offs, -1).reshape(-1)
    keep = rows >= 0
    rows_v = rows[keep]
    src = grad.reshape(B, F, 1, D).expand(B, F, hot, D).reshape(-1, D)[keep]
    lib_ms = cuda_ms(lambda: torch.zeros((F * V, D), device=grad.device)
                     .index_add_(0, rows_v, src), 5)
    n_valid = int(keep.sum())
    bags_read = int((sparse >= 0).any(-1).sum())
    nbytes = F * V * D * 4 + bags_read * D * 4 + sparse.numel() * 4
    ops_ = n_valid * D
    bound = max(nbytes / HBM_BYTES_PER_S, ops_ / F32_OPS_PER_S) * 1e3
    del rows, keep, rows_v, src
    log(f"[10a train] embed_bag_backward: {ms:.4f} ms a call (operand sort "
        f"{prep_ms:.4f} ms of it); kernel alone {kernel_ms:.4f} ms (every "
        f"slot a pad {pads_ms:.4f}), bound / kernel {bound / kernel_ms:.1%}; "
        f"torch.zeros of the output "
        f"{memset_ms:.4f} ms; twin "
        f"on the card {plain_ms:.4f} ms, index_add_ into zeros "
        f"{lib_ms:.4f} ms; bound {bound:.4f} ms (bytes: {nbytes} B = the "
        f"dense f32 gradient written once, {bags_read} bag gradient rows "
        f"with a valid slot, the indices; {n_valid} valid slots) ({card})")
    return {"name": "embed_bag_backward", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/embed_bag_backward.cu",
            "replaces": "src/repro/kernels/embed_bag.py:60",
            "replaces_note": "the gradient of kernel D; the TPU kernel has "
                             "none (the reference differentiates its jnp "
                             "gather, src/repro/models/recsys.py:105-113)",
            "ms": ms, "prep_ms": prep_ms, "kernel_ms": kernel_ms,
            "pads_only_ms": pads_ms,
            "memset_ms": memset_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes",
            "bound_share": bound / kernel_ms, "library_ms": lib_ms,
            "library": "torch.zeros + Tensor.index_add_ over the flat rows",
            "bound_bytes": nbytes, "valid_slots": n_valid,
            "shape": [B, F, D, hot, V]}


def seq_model_train_serve(arch: str, B: int, seed: int, dev) -> dict:
    """10b: ``arch`` at full config: 3 train steps at the train batch
    (wall time, loss, peak memory), one more under ``torch.profiler``
    (busy share, largest kernels), then ``score`` at serve_p99 and
    ``retrieval_scores`` + top-100 at retrieval_cand, each request timed
    from host features to host results."""
    import torch

    import repro_torch.kernels as kernels
    from repro_torch.configs import registry
    from repro_torch.data import loaders
    from repro_torch.models import recsys
    from repro_torch.optim import adamw
    from repro_torch.train import loop

    mod = registry.get(arch)
    cfg = mod.full_config()
    _new_peak()
    t0 = time.perf_counter()
    model = recsys.init_params(torch.Generator(device=dev).manual_seed(seed),
                               cfg, device=dev)
    hbs = [loaders.recsys_batch(seed, s, B, cfg, device="cpu")
           for s in range(SEQ_TRAIN_STEPS)]
    t_setup = time.perf_counter() - t0
    step = loop.make_train_step(
        lambda p, b: (recsys.loss(p, b, cfg), {}),
        adamw.AdamWConfig(lr=1e-3, warmup_steps=10,
                          decay_steps=SEQ_TRAIN_STEPS))
    state = loop.init_state(model)
    kernels.reset_launch_counts()
    walls, losses = [], []
    for s in range(SEQ_TRAIN_STEPS):
        t1 = time.perf_counter()
        state, m = step(state, _seq_on_card(hbs[s], dev))
        losses.append(float(m["loss"]))
        walls.append((time.perf_counter() - t1) * 1e3)
    train_peak = torch.cuda.max_memory_allocated()
    if not np_all_finite(losses):
        raise AssertionError(f"{arch}: non-finite losses {losses}")
    held = [state]
    b_prof = _seq_on_card(hbs[0], dev)

    def one_step():
        held[0], _ = step(held[0], b_prof)

    prof = busy_summary(*device_profile(one_step, 1))
    log(f"[10b {arch}] one train step under torch.profiler: wall "
        f"{prof['wall_ms']:.2f} ms, device busy "
        + ("not measured" if prof["busy_share"] is None else
           f"{prof['device_ms']:.2f} ms ({prof['busy_share']:.3f}); "
           "largest: " + "; ".join(f"{k} {v:.2f} ms" for k, v in
                                   prof["top_kernels_ms"].items())))
    del state, step, hbs, held, b_prof
    gc.collect()
    out = {"train_batch": B, "train_walls_ms": walls, "losses": losses,
           "train_peak_bytes": train_peak, "setup_s": t_setup,
           "train_profile": prof}
    k_ret = mod.SHAPES["retrieval_cand"]["k"]
    for name, bsz in (("serve_p99", mod.SHAPES["serve_p99"]["batch"]),
                      ("retrieval_cand",
                       mod.SHAPES["retrieval_cand"]["batch"])):
        reqs = [loaders.recsys_batch(seed, 20_000 + i, bsz, cfg,
                                     device="cpu")
                for i in range(SEQ_REQUESTS + 1)]

        def serve(hb, name=name):
            b = _seq_on_card(hb, dev)
            if name == "serve_p99":
                return recsys.score(model, b, cfg).cpu()
            top = torch.topk(recsys.retrieval_scores(model, b, cfg), k_ret)
            return top.values.cpu()

        serve(reqs[-1])
        lat = []
        for hb in reqs[:-1]:
            t1 = time.perf_counter()
            res = serve(hb)
            lat.append((time.perf_counter() - t1) * 1e3)
            want = (bsz,) if name == "serve_p99" else (bsz, k_ret)
            if tuple(res.shape) != want or not torch.isfinite(res).all():
                raise AssertionError(f"{arch} {name}: bad output "
                                     f"{tuple(res.shape)}")
        out[name] = {"batch": bsz, **request_latency(lat, bsz)}
    counts = kernels.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"{arch}: a kernel ran ({counts}); its gathers "
                             f"are torch indexing")
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"[10b {arch}] {cfg.name} (D={cfg.embed_dim}, "
        f"{cfg.n_items} items, seq {cfg.seq_len}): {SEQ_TRAIN_STEPS} train "
        f"steps at B={B}: walls {[round(x, 2) for x in walls]} ms, losses "
        f"{losses}, peak {train_peak / 1e9:.2f} GB; serve_p99 p50 "
        f"{out['serve_p99']['p50']:.3f} / p99 {out['serve_p99']['p99']:.3f}"
        f" ms; retrieval_cand p50 {out['retrieval_cand']['p50']:.3f} / p99 "
        f"{out['retrieval_cand']['p99']:.3f} ms ({SEQ_REQUESTS} requests "
        f"each)")
    if out["peak_bytes"] >= PEAK_MEMORY_MAX:
        raise AssertionError(f"{arch} peak device memory "
                             f"{out['peak_bytes'] / 1e9:.2f} GB")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_resume(cfg, B: int, seed: int, dev) -> dict:
    """10c: dlrm-rm2 at full widths with each field cut to RESUME_VOCAB
    rows: 6 straight steps against 3 steps, a train-state checkpoint
    (``launch.train.save``) under ``build/``, a restore into an
    uninitialised model and 3 more steps."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import convert
    from repro_torch.data import loaders
    from repro_torch.launch import train as launcher
    from repro_torch.models import recsys
    from repro_torch.optim import adamw
    from repro_torch.train import loop

    cfg = dataclasses.replace(cfg, vocab_per_field=RESUME_VOCAB,
                              n_items=RESUME_VOCAB)
    hbs = [loaders.recsys_batch(seed, s, B, cfg, device="cpu")
           for s in range(RESUME_STEPS)]
    step = loop.make_train_step(
        lambda p, b: (recsys.loss(p, b, cfg), {}),
        adamw.AdamWConfig(lr=1e-3, warmup_steps=10,
                          decay_steps=RESUME_STEPS))
    half = RESUME_STEPS // 2

    def run(state, lo, hi):
        for s in range(lo, hi):
            state, _ = step(state, _dlrm_on_card(hbs[s], dev))
        return state

    straight, _ = convert.train_state_to_numpy(
        run(loop.init_state(_fresh_dlrm(cfg, seed, dev)), 0, RESUME_STEPS))
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    scratch = tempfile.mkdtemp(prefix="train-10c-", dir=root)
    try:
        state = run(loop.init_state(_fresh_dlrm(cfg, seed, dev)), 0, half)
        t0 = time.perf_counter()
        path = launcher.save(scratch, half, state)
        t_save = time.perf_counter() - t0
        ckpt_bytes = dir_bytes(path)
        del state
        t0 = time.perf_counter()
        fresh = loop.init_state(_fresh_dlrm(cfg, seed, dev, draw=False))
        state, at = launcher.restore(scratch, fresh)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    if at != half:
        raise AssertionError(f"restored step {at}, saved {half}")
    resumed, _ = convert.train_state_to_numpy(run(state, half, RESUME_STEPS))
    diffs, bitwise = {}, True
    for k, a in straight.items():
        b = resumed[k]
        bitwise &= a.tobytes() == b.tobytes()
        if not k.startswith(".params/"):
            continue
        diffs[k] = float(np.abs(a - b).max())
        if not np.allclose(b, a, rtol=1e-5, atol=1e-7):
            raise AssertionError(f"resumed {k} differs from the straight "
                                 f"run: max abs diff {diffs[k]:.3g}")
    log(f"[10c resume] {cfg.name} cut to {RESUME_VOCAB} rows a field: "
        f"{RESUME_STEPS} straight steps against {half} + save ({ckpt_bytes} "
        f"B in {t_save:.2f}s) + restore ({t_restore:.2f}s) + "
        f"{RESUME_STEPS - half}: parameters within rtol 1e-5, max abs diff "
        f"{max(diffs.values()):.3g}; every leaf (m, v, step too) "
        f"{'bit-equal' if bitwise else 'NOT bit-equal'}")
    gc.collect()
    torch.cuda.empty_cache()
    return {"vocab_per_field": RESUME_VOCAB, "steps": RESUME_STEPS,
            "checkpoint_bytes": ckpt_bytes, "save_s": t_save,
            "restore_s": t_restore, "bitwise": bitwise,
            "max_abs_param_diff": max(diffs.values())}


def dlrm_flops(cfg, B: int) -> int:
    """f32 operations of one DLRM forward at batch B: both MLPs and the
    (F+1)² Gram interaction, as ``src/repro/launch/cells.py:181-192``
    counts them."""
    D = cfg.embed_dim
    dims_b = (cfg.n_dense,) + tuple(cfg.bot_mlp)
    dims_t = (cfg.bot_mlp[-1] + (cfg.n_sparse + 1) * cfg.n_sparse // 2,
              ) + tuple(cfg.top_mlp)
    mlp = sum(a * b for a, b in zip(dims_b[:-1], dims_b[1:])) + \
        sum(a * b for a, b in zip(dims_t[:-1], dims_t[1:]))
    inter = (cfg.n_sparse + 1) ** 2 * D
    return 2 * B * (mlp + inter)


# -- 11. the LM family: stablelm-12b served and trained, moonshot's MoE -------

BF16_OPS_PER_S = 989e12            # dense bf16 on the tensor cores
LM_SEQ = 32_768                    # prefill_32k's seq, decode_32k's cache
LM_DECODE_STEPS = 32               # phase 11a/b: decode steps after prefill
LM_MOE_LAYERS = 4                  # phase 11b: 4 of moonshot's 48 layers
LM_TRAIN_LAYERS = 2                # phase 11c: 2 of stablelm's 40 layers
LM_TRAIN_SEQ = 4_096               # phase 11c: train_4k's seq
LM_TRAIN_BATCH = 2                 # phase 11c: of train_4k's 256
LM_TRAIN_TIMED = 3                 # phase 11c: timed steps after one warm-up
LM_LAUNCH_STEPS = 12               # phase 11d: launcher steps, ckpt at 10
#: Largest |prefill or decode logit - forward logit| over the vocabulary
#: allowed, as a share of the forward logits' standard deviation at that
#: position.  Both sides run the bf16 program with f32 attention; they
#: differ in the GEMM shapes cuBLAS picks kernels for (32,736 or 1 rows
#: against 32,768), in decode's one-pass softmax against prefill's running
#: one, and in GEMV against GEMM sums, and each bf16 rounding that lands the
#: other way moves every later layer: stablelm-12b's 40 layers read
#: 0.12-0.14 on an H100 (PERF.md §6).  A wrong position, cache slot or
#: mask gives logits unrelated to the forward's, whose largest difference
#: over 100k entries is several standard deviations.
LM_LOGIT_TOL = 0.25
#: Share of an MoE model's decode positions that must be within
#: LM_LOGIT_TOL: a token whose top-k experts are near a tie routes by the
#: last bit of its router input, which those roundings move, and a flipped
#: route moves its logits by O(1) (seen on an H100: 1 of 32 positions at
#: 0.36, the median 0.012).
LM_MOE_WITHIN = 0.9


def lm_path(seed: int, dev, card: str):
    """Phase 11: the LM family on the card (11a stablelm-12b served at full
    width and depth, 11b moonshot-v1-16b-a3b's MoE at full width, 11c
    stablelm-12b layers trained, 11d the launcher for the five LM archs).
    Returns (the lm JSON line, the kernels' launch counts over it)."""
    import dataclasses

    import torch

    import repro_torch.kernels as kernels
    from repro_torch.configs import moonshot_v1_16b_a3b, stablelm_12b

    t_phase = time.perf_counter()
    line = {"card": card, "bf16_reduction": bf16_reduction_probe(dev)}
    # cuBLAS may otherwise sum split-K partials of a bf16 GEMM in bf16; the
    # reference's dots accumulate in f32
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    kernels.reset_launch_counts()
    try:
        with torch.no_grad():
            line["stablelm_12b"] = lm_serve(
                stablelm_12b.full_config(), LM_SEQ - LM_DECODE_STEPS, seed,
                dev, card, "11a")
            moe = dataclasses.replace(moonshot_v1_16b_a3b.full_config(),
                                      n_layers=LM_MOE_LAYERS)
            # whole groups: the reference's moe_layer needs T % g == 0
            prompt = (LM_SEQ - LM_DECODE_STEPS) // moe.group_size \
                * moe.group_size
            line["moonshot_v1_16b_a3b"] = lm_serve(moe, prompt, seed, dev,
                                                   card, "11b")
        line["train"] = lm_train(stablelm_12b.full_config(), seed, dev, card)
        line["launcher"] = lm_launcher(dev)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            flag
    counts = kernels.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"the LM path launched a kernel: {counts}")
    line["wall_s"] = time.perf_counter() - t_phase
    log(f"[11 lm] phase {line['wall_s']:.1f}s; kernels A-D' launched "
        f"{counts} ({card})")
    return line, counts


def bf16_reduction_probe(dev) -> dict:
    """CUDA-event ms and max |difference| of stablelm-12b's MLP products
    (decode [1, 5120] x [5120, 13824] and prefill [32768, 5120] x [5120,
    13824], bf16) with cuBLAS's reduced-precision bf16 reduction allowed
    and not."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(1)
    w = (torch.randn((5120, 13824), generator=gen, device=dev)
         / 5120 ** 0.5).to(torch.bfloat16)
    out = {}
    for name, rows in (("decode", 1), ("prefill", LM_SEQ)):
        x = torch.randn((rows, 5120), generator=gen, device=dev).to(
            torch.bfloat16)
        res = {}
        for allow in (True, False, True, False):
            torch.backends.cuda.matmul.\
                allow_bf16_reduced_precision_reduction = allow
            ms = cuda_ms(lambda: torch.matmul(x, w), 20 if rows == 1 else 5)
            res.setdefault(allow, []).append(ms)
            res[f"y{allow}"] = torch.matmul(x, w).float()
        out[name] = {"ms_allowed": res[True], "ms_not_allowed": res[False],
                     "max_abs_diff": float((res["yTrue"] - res["yFalse"])
                                           .abs().max())}
        del x, res
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    log("[11 lm] bf16 GEMM with reduced-precision reduction allowed / not: "
        + "; ".join(f"{k} {v['ms_allowed']} / {v['ms_not_allowed']} ms, "
                    f"max abs diff {v['max_abs_diff']:.3g}"
                    for k, v in out.items()))
    return out


def lm_work(cfg, T: int, kept: int = None) -> dict:
    """Operations of a causal forward over T positions of ``cfg`` (no
    window): GEMM FLOPs of the projections, router and MLPs (the MoE's
    ``kept`` routed choices over all layers, or T·k a layer), and f32
    attention FLOPs (q·k and p·v over the causal keys, T(T+1)/2 pairs a
    head)."""
    d, H, KV, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    proj = 2 * d * (H + 2 * KV) * hd + 2 * H * hd * d
    if cfg.moe:       # kept: routed choices over all layers
        kept = T * cfg.moe_top_k * cfg.n_layers if kept is None else kept
        gemm = cfg.n_layers * T * (proj + 2 * d * cfg.n_experts) \
            + kept * 2 * 3 * d * f
    else:
        gemm = cfg.n_layers * T * (proj + 2 * 3 * d * f)
    attn = cfg.n_layers * 4 * H * hd * T * (T + 1) // 2
    return {"gemm_flops": gemm, "attn_flops": attn}


def lm_serve(cfg, prompt: int, seed: int, dev, card: str, tag: str) -> dict:
    """11a / 11b: ``cfg``'s bf16 weights drawn on the card, a prefill of
    ``prompt`` tokens, its cache copied into the first positions of
    ``init_cache(cfg, 1, LM_SEQ)``, ``LM_DECODE_STEPS`` decode steps, one
    step under ``torch.profiler``; then one ``forward`` over the LM_SEQ
    tokens, whose f32 logits at positions prompt - 1 .. prompt + 31 the
    prefill's and each decode step's logits must match."""
    import numpy as np
    import torch

    from repro_torch.models import transformer as tr

    _new_peak()
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    model = tr.init_params(gen, cfg, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in model.parameters())
    toks = torch.randint(0, cfg.vocab, (1, LM_SEQ), generator=gen,
                         device=dev, dtype=torch.int32)
    tr.prefill(model, toks[:, :1024], cfg)           # cuBLAS's first calls
    stats = [] if cfg.moe else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits_p, pcache = tr.prefill(model, toks[:, :prompt], cfg,
                                  moe_stats=stats)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    prefill_peak = torch.cuda.max_memory_allocated()
    cache = tr.init_cache(cfg, 1, LM_SEQ, device=dev)
    for n in cache:
        cache[n][:, :, :, :prompt] = pcache[n]
    del pcache
    walls, dec = [], []
    for i in range(LM_DECODE_STEPS):
        pos = prompt + i
        t0 = time.perf_counter()
        lg, cache = tr.decode_step(model, cache, toks[:, pos:pos + 1], pos,
                                   cfg)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        dec.append(lg)
    # the last step again: it rewrites its slot with the same values
    prof = busy_summary(*device_profile(
        lambda: tr.decode_step(model, cache, toks[:, pos:pos + 1], pos, cfg),
        3))
    serve_peak = torch.cuda.max_memory_allocated()
    del cache
    gc.collect()
    torch.cuda.empty_cache()

    fwd_stats = [] if cfg.moe else None
    t0 = time.perf_counter()
    hidden, _ = tr.forward(model, toks, cfg, moe_stats=fwd_stats)
    ref = tr.logits_f32(model, hidden[0, prompt - 1:prompt + LM_DECODE_STEPS])
    torch.cuda.synchronize()
    t_forward = time.perf_counter() - t0
    del hidden
    got = torch.cat([logits_p] + dec)
    if not bool(torch.isfinite(got).all()) or got.shape != ref.shape:
        raise AssertionError(f"{tag}: bad logits {tuple(got.shape)}")
    diff = (got - ref).abs().amax(dim=1)
    spread = ref.std(dim=1)
    rel = (diff / spread).tolist()
    checked = list(range(len(rel)))
    drops = None
    if cfg.moe:
        # decode routes each token alone (never dropped); the forward's
        # group holding the decoded positions must drop nothing for the two
        # to be the same function there
        grp = prompt // cfg.group_size
        drops = [int(s["dropped"][grp]) for s in fwd_stats]
        if any(drops):
            checked = [0]
    within = [rel[i] <= LM_LOGIT_TOL for i in checked]
    log(f"[{tag} lm] {cfg.name} ({cfg.n_layers} layers, d={cfg.d_model}, "
        f"{weight_bytes / 1e9:.2f} GB bf16 weights drawn in {t_init:.1f}s): "
        f"logits vs one forward over {LM_SEQ} tokens (forward "
        f"{t_forward:.1f}s): prefill max abs diff {float(diff[0]):.4g} "
        f"({rel[0]:.4f} of the logits' std {float(spread[0]):.4g}); decode "
        f"steps max {max(rel[1:]):.4f}, median "
        f"{float(np.median(rel[1:])):.4f} of std; {sum(within)} of "
        f"{len(checked)} checked positions within {LM_LOGIT_TOL}"
        + ("" if drops is None else f"; the decoded positions' group drops "
           f"{drops} a layer"))
    need = len(checked) if not cfg.moe else \
        max(1, int(np.ceil(LM_MOE_WITHIN * len(checked))))
    if not within[0] or sum(within) < need:
        raise AssertionError(f"{tag}: logits differ from the forward's by "
                             f"{[round(rel[i], 4) for i in checked]} of "
                             f"their std; {sum(within)} within "
                             f"{LM_LOGIT_TOL}, {need} needed")

    T = prompt
    kept = sum(int(s["received"].sum()) for s in stats) if stats else None
    work = lm_work(cfg, T, kept)
    bound_prefill = max(work["gemm_flops"] / BF16_OPS_PER_S
                        + work["attn_flops"] / F32_OPS_PER_S,
                        (weight_bytes + 2 * cfg.n_layers * T * cfg.n_kv_heads
                         * cfg.head_dim * 2) / HBM_BYTES_PER_S)
    active = cfg.active_param_count() - cfg.vocab * cfg.d_model
    cache_bytes = [2 * cfg.n_layers * (prompt + i + 1) * cfg.n_kv_heads
                   * cfg.head_dim * 2 for i in range(LM_DECODE_STEPS)]
    bound_decode = (2 * active + float(np.mean(cache_bytes))) \
        / HBM_BYTES_PER_S * 1e3
    lat = request_latency(walls, 1)
    out = {"layers": cfg.n_layers, "weight_bytes": weight_bytes,
           "init_s": t_init, "prompt": prompt, "cache_positions": LM_SEQ,
           "prefill_s": t_prefill, "prefill_tokens_per_s": T / t_prefill,
           "prefill_bound_s": bound_prefill, **work,
           "decode_ms_p50": lat["p50"], "decode_ms_p99": lat["p99"],
           "decode_walls_ms": walls, "decode_bound_ms": bound_decode,
           "decode_profile": prof, "forward_s": t_forward,
           "prefill_peak_bytes": prefill_peak,
           "serve_peak_bytes": serve_peak,
           "logit_max_abs_diff": diff.tolist(), "logit_std": spread.tolist(),
           "logit_diff_over_std": rel, "checked_positions": len(checked)}
    if cfg.moe:
        out["expert_tokens"] = [s["received"].tolist() for s in stats]
        out["dropped"] = [int(s["dropped"].sum()) for s in stats]
        out["forward_group_drops"] = drops
    log(f"[{tag} lm] prefill {T} tokens in {t_prefill:.2f}s "
        f"({T / t_prefill:.0f} tokens/s; bound {bound_prefill:.2f}s: "
        f"{work['gemm_flops']:.3g} bf16 GEMM FLOPs at 989 TFLOP/s + "
        f"{work['attn_flops']:.3g} f32 attention FLOPs at 67 TFLOP/s); "
        f"decode p50 {lat['p50']:.2f} / p99 {lat['p99']:.2f} ms a token "
        f"(bound {bound_decode:.2f} ms); decode step busy "
        + ("not measured" if prof["busy_share"] is None else
           f"{prof['busy_share']:.3f} of {prof['wall_ms']:.2f} ms, largest: "
           + "; ".join(f"{k} {v:.2f} ms" for k, v in
                       prof["top_kernels_ms"].items()))
        + f"; peak {prefill_peak / 1e9:.2f} GB in prefill, "
        f"{serve_peak / 1e9:.2f} GB with the cache ({card})")
    if cfg.moe:
        log(f"[{tag} lm] prefill routing: tokens each expert kept, per "
            f"layer (min / max of {cfg.n_experts}): "
            + "; ".join(f"{min(r)} / {max(r)}" for r in out["expert_tokens"])
            + f"; choices dropped past cap a layer {out['dropped']}")
    if max(prefill_peak, serve_peak) >= PEAK_MEMORY_MAX:
        raise AssertionError(f"{tag}: peak device memory "
                             f"{max(prefill_peak, serve_peak) / 1e9:.2f} GB")
    del model, toks, dec, got, ref
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_train(cfg, seed: int, dev, card: str) -> dict:
    """11c: ``LM_TRAIN_LAYERS`` of ``cfg``'s layers at full width, f32
    parameters (the launcher's), ``make_train_step`` with the launcher's
    AdamW at seq LM_TRAIN_SEQ: one warm-up and LM_TRAIN_TIMED timed steps,
    a CUDA-event split of one more."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.data import loaders
    from repro_torch.models import transformer as tr
    from repro_torch.optim import adamw
    from repro_torch.train import loop

    cfg = dataclasses.replace(cfg, n_layers=LM_TRAIN_LAYERS)
    B = LM_TRAIN_BATCH
    _new_peak()
    model = tr.init_params(torch.Generator(device=dev).manual_seed(seed),
                           cfg, device=dev)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=10,
                                decay_steps=LM_TRAIN_TIMED + 2)
    step = loop.make_train_step(
        lambda p, b: tr.lm_loss(p, b[0], b[1], cfg), opt_cfg)
    state = loop.init_state(model)
    batches = [loaders.lm_batch(seed, s, B, LM_TRAIN_SEQ, cfg.vocab,
                                device=dev)
               for s in range(LM_TRAIN_TIMED + 2)]
    walls, losses, norms = [], [], []
    for s in range(LM_TRAIN_TIMED + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batches[s])
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        walls.append((time.perf_counter() - t0) * 1e3)
    if not (np_all_finite(losses) and np_all_finite(norms)):
        raise AssertionError(f"11c: non-finite losses {losses} or grad "
                             f"norms {norms}")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    toks, labels = batches[-1]
    ev[0].record()
    loss, _ = tr.lm_loss(model, toks, labels, cfg)
    ev[1].record()
    loss.backward()
    ev[2].record()
    adamw.update(model.leaves(grad=True), state.opt, model.leaves(), opt_cfg)
    ev[3].record()
    torch.cuda.synchronize()
    for p in model.parameters():
        p.grad = None
    split = {"forward_ms": ev[0].elapsed_time(ev[1]),
             "backward_ms": ev[1].elapsed_time(ev[2]),
             "update_ms": ev[2].elapsed_time(ev[3])}
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in model.parameters())
    T = B * LM_TRAIN_SEQ
    work = lm_work(cfg, LM_TRAIN_SEQ)
    gemm = 3 * (B * work["gemm_flops"] + 2 * T * cfg.d_model * cfg.vocab)
    attn = 3 * B * work["attn_flops"]        # forward, 2x in the backward
    bound_ms = (gemm / BF16_OPS_PER_S + attn / F32_OPS_PER_S
                + 7 * 4 * n_params / HBM_BYTES_PER_S) * 1e3
    p50 = float(np.percentile(walls[1:], 50))
    log(f"[11c lm train] {cfg.name} cut to {cfg.n_layers} layers "
        f"({n_params / 1e9:.3f} B f32 parameters), B={B} x {LM_TRAIN_SEQ}: "
        f"step walls {[round(w, 1) for w in walls]} ms (first: warm-up), "
        f"p50 {p50:.1f} ms, {T / p50 * 1e3:.0f} tokens/s (bound "
        f"{bound_ms:.1f} ms); losses {[round(x, 4) for x in losses]}, grad "
        f"norms {[round(x, 3) for x in norms]}; one step's CUDA events: "
        f"forward {split['forward_ms']:.1f}, backward "
        f"{split['backward_ms']:.1f}, clip + AdamW {split['update_ms']:.1f} "
        f"ms; peak {peak / 1e9:.2f} GB ({card})")
    if peak >= PEAK_MEMORY_MAX:
        raise AssertionError(f"11c: peak device memory {peak / 1e9:.2f} GB")
    del model, state, step, batches, loss
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": cfg.n_layers, "batch": B, "seq": LM_TRAIN_SEQ,
            "params": n_params, "walls_ms": walls, "step_ms_p50": p50,
            "tokens_per_s": T / p50 * 1e3, "losses": losses,
            "grad_norms": norms, "split": split, "bound_ms": bound_ms,
            "peak_bytes": peak}


def lm_launcher(dev) -> dict:
    """11d: ``repro_torch.launch.train`` on the card for each LM arch's
    smoke config: LM_LAUNCH_STEPS steps with a checkpoint at step 10 under
    ``build/``, then ``--resume``, which must print ``resumed from step
    10``."""
    import contextlib
    import io

    from repro_torch.configs import registry
    from repro_torch.launch import train as launcher

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    out = {}
    archs = [a for a in registry.ARCHS if registry.get(a).FAMILY == "lm"]
    for arch in archs:
        scratch = tempfile.mkdtemp(prefix="lm-11d-", dir=root)
        try:
            t0 = time.perf_counter()
            runs = []
            for extra in ([], ["--resume"]):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    launcher.main(["--arch", arch, "--steps",
                                   str(LM_LAUNCH_STEPS), "--ckpt-dir",
                                   scratch, "--ckpt-every", "10", *extra])
                runs.append(buf.getvalue().splitlines())
        finally:
            shutil.rmtree(scratch, ignore_errors=True)
        first, resumed = runs
        if not (first and first[0].startswith(f"[{arch}] step    1 loss=")
                and resumed and resumed[0] == "resumed from step 10"):
            raise AssertionError(f"11d {arch}: launcher printed {runs}")
        out[arch] = {"wall_s": time.perf_counter() - t0,
                     "lines": first + resumed}
        log(f"[11d lm launcher] {arch}: {' | '.join(first + resumed)} "
            f"({out[arch]['wall_s']:.1f}s)")
    return out


# -- 12. the GNN family: equiformer-v2 trained at full width -----------------

GNN_TIMED = 3                      # 12a / 12b: timed steps after a warm-up
GNN_LG_DEGREE = 50                 # 12c: in-degree the Reddit-sized graph
                                   # is cut to (from 492 on average)
GNN_LG_TIMED = 2                   # 12c: timed train steps after a warm-up
GNN_LAUNCH_STEPS = 12              # 12d: launcher steps, ckpt at 10
#: 12a / 12b rotation checks, tests/test_gnn.py's tolerances as shares of
#: the forward's largest |value| (at least 1): the l = 0 outputs (and
#: energies) within 1e-3, the l = 1 rows (and forces) rotated with
#: D₁(R) within 2e-3.  The J matrices are least-squares fits and every
#: rotation is f32, so an equivariant model misses by f32 rounding alone;
#: a wrong frame misses by O(1).
GNN_INVARIANT_TOL, GNN_EQUIVARIANT_TOL = 1e-3, 2e-3
#: Padded edges' payloads changed, ``edge_chunk`` halved, the hand-written
#: backward against autograd through the reference's form of the loop:
#: max |difference| within 1e-4 of the reference side's largest |value|
#: (the reference's chunking test: rtol 1e-4 at 2 layers).  Each side sums
#: the same f32 terms in another order (``index_add_`` on the card sums
#: with atomics, so not even two forwards are bit-equal); a pad that leaks
#: or a wrong chunk boundary moves outputs by O(1).
GNN_ORDER_TOL = 1e-4


def gnn_path(seed: int, dev, card: str):
    """Phase 12: the GNN family on the card (12a ``full_graph_sm`` and 12b
    ``molecule`` trained at full width and depth, with the reference's
    properties checked at full width; 12c ``minibatch_lg``'s sampled
    subgraph: a forward at all 12 layers and training at the deepest cut
    that stays under PEAK_MEMORY_MAX; 12d the launcher).  Returns (the gnn
    JSON line, the kernels' launch counts over it)."""
    import torch

    import repro_torch.kernels as kernels
    from repro_torch.configs import common
    from repro_torch.configs import equiformer_v2 as eq
    from repro_torch.data import graph as graphdata

    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("12: TF32 is on; the reference's f32 matrix "
                             "products are full f32")
    t_phase = time.perf_counter()
    line = {"card": card}
    kernels.reset_launch_counts()
    shapes = common.GNN_SHAPES
    sm = shapes["full_graph_sm"]
    hg = graphdata.random_geometric_graph(
        seed, sm["n_nodes"], sm["n_edges"], sm["d_feat"], sm["n_classes"],
        sm["pad_nodes"], sm["pad_edges"])
    line["full_graph_sm"] = gnn_train(eq.full_config(sm), hg, sm["n_nodes"],
                                      seed, dev, card, "12a")
    mol = shapes["molecule"]
    hg = graphdata.molecule_batch(seed, mol["batch_graphs"],
                                  mol["nodes_per"], mol["edges_per"],
                                  mol["d_feat"])
    line["molecule"] = gnn_train(eq.full_config(mol), hg,
                                 hg.node_feat.shape[0], seed, dev, card,
                                 "12b")
    line["minibatch_lg"] = gnn_minibatch(shapes["minibatch_lg"], seed, dev,
                                         card)
    line["launcher"] = gnn_launcher()
    counts = kernels.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"the GNN path launched a kernel: {counts}")
    line["wall_s"] = time.perf_counter() - t_phase
    log(f"[12 gnn] phase {line['wall_s']:.1f}s; kernels A-D' launched "
        f"{counts} ({card})")
    return line, counts


def gnn_edge_flops(cfg, edges: int) -> int:
    """f32 FLOPs of one layer's edge path over ``edges`` edges: the SO(2)
    convolution (one (n0·C)² product for m = 0, four ((l_max+1-m)·C)² for
    each m ≥ 1) and the two rotations (Σ (2l+1)² · C each way), a
    multiply-add counted as 2."""
    C, n0 = cfg.c, cfg.l_max + 1
    conv = (n0 * C) ** 2 + sum(4 * ((n0 - m) * C) ** 2
                               for m in range(1, cfg.m_max + 1))
    rot = 2 * sum((2 * l + 1) ** 2 for l in range(n0)) * C
    return 2 * (conv + rot) * edges


def gnn_step_split(model, state, g, cfg, opt_cfg) -> dict:
    """CUDA-event ms of one more step: forward (loss), backward, clip +
    AdamW."""
    import torch

    from repro_torch.models import gnn
    from repro_torch.optim import adamw

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    loss, _ = gnn.loss_fn(model, g, cfg)
    ev[1].record()
    loss.backward()
    ev[2].record()
    adamw.update(model.leaves(grad=True), state.opt, model.leaves(), opt_cfg)
    ev[3].record()
    torch.cuda.synchronize()
    for p in model.parameters():
        p.grad = None
    return {"forward_ms": ev[0].elapsed_time(ev[1]),
            "backward_ms": ev[1].elapsed_time(ev[2]),
            "update_ms": ev[2].elapsed_time(ev[3])}


def gnn_fit(cfg, g, seed: int, dev, steps: int):
    """``cfg``'s model drawn on the card from ``seed``, trained on ``g`` by
    ``make_train_step`` with the launcher's AdamW for ``steps`` steps: (the
    model, its state, the AdamW config, step walls ms, losses, grad
    norms), losses and grad norms finite."""
    import torch

    from repro_torch.models import gnn
    from repro_torch.optim import adamw
    from repro_torch.train import loop

    model = gnn.init_params(torch.Generator(device=dev).manual_seed(seed),
                            cfg, device=dev)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=10,
                                decay_steps=steps + 2)
    step = loop.make_train_step(lambda p, b: gnn.loss_fn(p, b, cfg),
                                opt_cfg)
    state = loop.init_state(model)
    walls, losses, norms = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, g)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        walls.append((time.perf_counter() - t0) * 1e3)
    if not (np_all_finite(losses) and np_all_finite(norms)):
        raise AssertionError(f"{cfg.name}: non-finite losses {losses} or "
                             f"grad norms {norms}")
    return model, state, step, opt_cfg, walls, losses, norms


def gnn_train(cfg, hg, n_real: int, seed: int, dev, card: str,
              tag: str) -> dict:
    """12a / 12b: ``cfg`` at full width and depth on the host graph ``hg``:
    one warm-up and GNN_TIMED timed train steps, a CUDA-event split of one
    more, the busy share of a step under torch.profiler, peak memory; then
    the reference's properties on the trained weights, forward only
    (:func:`gnn_properties`), and on 12a the edge loop's backward against
    the reference's form (:func:`gnn_backward_check`)."""
    import numpy as np
    import torch

    from repro_torch.data import graph as graphdata

    _new_peak()
    g = graphdata.to_device(hg, dev)
    model, state, step, opt_cfg, walls, losses, norms = gnn_fit(
        cfg, g, seed, dev, GNN_TIMED + 1)
    split = gnn_step_split(model, state, g, cfg, opt_cfg)
    prof_wall, by_name = device_profile(lambda: step(state, g), 1)
    busy = busy_summary(prof_wall, by_name, top=8)
    peak = torch.cuda.max_memory_allocated()
    valid = int((hg.edge_src >= 0).sum())
    flops = 4 * cfg.n_layers * gnn_edge_flops(cfg, valid)
    bound_ms = flops / F32_OPS_PER_S * 1e3
    p50 = float(np.percentile(walls[1:], 50))
    n_params = sum(t.numel() for t in model.parameters())
    log(f"[{tag} gnn train] {cfg.name} {cfg.task}, {cfg.n_layers} layers, "
        f"c={cfg.c}, l_max={cfg.l_max} ({n_params / 1e6:.2f} M f32 "
        f"parameters), N={hg.node_feat.shape[0]} ({n_real} real), "
        f"E={hg.edge_src.shape[0]} ({valid} real), edge_chunk "
        f"{cfg.edge_chunk}: step walls {[round(w, 1) for w in walls]} ms "
        f"(first: warm-up), p50 {p50:.1f} ms, max {max(walls[1:]):.1f}, "
        f"{n_real / p50 * 1e3:.0f} nodes/s (bound {bound_ms:.1f} ms: "
        f"{flops / 1e12:.2f} T edge-path f32 FLOPs at 67 TFLOP/s); losses "
        f"{[round(x, 4) for x in losses]}, grad norms "
        f"{[round(x, 3) for x in norms]}; one step's CUDA events: forward "
        f"{split['forward_ms']:.1f}, backward {split['backward_ms']:.1f}, "
        f"clip + AdamW {split['update_ms']:.1f} ms; busy "
        f"{busy['busy_share']}, top {busy['top_kernels_ms']}; peak "
        f"{peak / 1e9:.2f} GB ({card})")
    if peak >= PEAK_MEMORY_MAX:
        raise AssertionError(f"{tag}: peak device memory {peak / 1e9:.2f} GB")
    out = {"layers": cfg.n_layers, "nodes": hg.node_feat.shape[0],
           "real_nodes": n_real, "edges": hg.edge_src.shape[0],
           "real_edges": valid, "params": n_params, "walls_ms": walls,
           "step_ms_p50": p50, "step_ms_max": max(walls[1:]),
           "nodes_per_s": n_real / p50 * 1e3, "losses": losses,
           "grad_norms": norms, "split": split, "busy": busy,
           "bound_ms": bound_ms, "edge_flops": flops, "peak_bytes": peak}
    with torch.no_grad():
        out["checks"] = gnn_properties(model, cfg, g, seed, tag)
    if tag == "12a":
        out["backward_check"] = gnn_backward_check(model, cfg, g, seed)
    del model, state, step, g
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _rel_err(got, want) -> float:
    """max |got - want| over want's largest |value|."""
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def gnn_properties(model, cfg, g, seed: int, tag: str) -> dict:
    """The reference's properties (tests/test_gnn.py) at full width:
    rotation of ``edge_vec`` by a random R leaves the l = 0 outputs (and
    energies) unchanged and rotates the l = 1 rows (and forces) with
    D₁(R); changed padded-edge payloads change nothing; ``edge_chunk``
    halved gives the same output; two forwards compared bit for bit.
    Raises after logging every number when a check fails."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models import gnn, sh

    gen = np.random.Generator(np.random.Philox(key=seed + 12))
    Q, _ = np.linalg.qr(gen.normal(size=(3, 3)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    R = torch.from_numpy(Q.astype(np.float32)).to(g.edge_vec.device)
    D1 = torch.from_numpy(sh.fit_wigner_numpy(1, Q).astype(
        np.float32)).to(R.device)
    g_rot = g._replace(edge_vec=g.edge_vec @ R.T)
    f1 = gnn.forward(model, g, cfg)
    f1b = gnn.forward(model, g, cfg)
    f2 = gnn.forward(model, g_rot, cfg)
    scale = max(float(f1.abs().max()), 1.0)
    res = {"bit_equal_rerun": bool(torch.equal(f1, f1b)),
           "rerun_rel_err": _rel_err(f1b, f1),
           "invariant_err": float((f1[:, 0] - f2[:, 0]).abs().max()) / scale,
           "equivariant_err": float(
               (torch.einsum("ij,njc->nic", D1, f1[:, 1:4])
                - f2[:, 1:4]).abs().max()) / scale}
    del f1b, f2
    limits = {"invariant_err": GNN_INVARIANT_TOL,
              "equivariant_err": GNN_EQUIVARIANT_TOL,
              "rerun_rel_err": GNN_ORDER_TOL}
    if cfg.task == "energy_force":
        e1, F1 = gnn.predict(model, g, cfg)
        e2, F2 = gnn.predict(model, g_rot, cfg)
        res["energy_invariant_err"] = float((e1 - e2).abs().max()) / max(
            float(e1.abs().max()), 1.0)
        res["force_equivariant_err"] = float(
            (F1 @ D1.T - F2).abs().max()) / max(float(F1.abs().max()), 1.0)
        limits["energy_invariant_err"] = GNN_INVARIANT_TOL
        limits["force_equivariant_err"] = GNN_EQUIVARIANT_TOL
    pads = g.edge_src < 0
    if bool(pads.any()):
        vec = g.edge_vec.clone()
        vec[pads] = 123.0
        res["pad_payload_rel_err"] = _rel_err(
            gnn.forward(model, g._replace(edge_vec=vec), cfg), f1)
        limits["pad_payload_rel_err"] = GNN_ORDER_TOL
    half = dataclasses.replace(cfg, edge_chunk=cfg.edge_chunk // 2)
    res["chunk_halved_rel_err"] = _rel_err(gnn.forward(model, g, half), f1)
    limits["chunk_halved_rel_err"] = GNN_ORDER_TOL
    log(f"[{tag} gnn checks] {res} (limits {limits}; pads "
        f"{int(pads.sum())})")
    bad = {k: res[k] for k, lim in limits.items() if not res[k] <= lim}
    if bad:
        raise AssertionError(f"{tag}: properties fail at full width: {bad}")
    return res


def gnn_backward_check(model, cfg, g, seed: int) -> dict:
    """12a: the edge loop's gradients (its input and every edge weight) for
    a random upstream gradient through the autograd.Function
    (``edge_attention``) against autograd through the reference's form of
    the loop (``edge_attention_reference``), on layer 0's weights and a
    random input with every degree filled."""
    import torch

    from repro_torch.models import gnn

    gen = torch.Generator(device=g.edge_vec.device).manual_seed(seed + 1)
    N = g.node_feat.shape[0]
    shape = (N, cfg.k, cfg.c)
    f = torch.randn(shape, generator=gen, device=gen.device).requires_grad_()
    up = torch.randn(shape, generator=gen, device=gen.device)
    names, per_layer = model.layer_weights()
    lp = gnn._nest(names, [w.detach().requires_grad_()
                           for w in per_layer[0]])
    ws = [*lp["so2"].values(), lp["rad1"], lp["rad2"], lp["wa1"],
          lp["wa2"]]
    _new_peak()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = gnn.edge_attention(f, lp, g, cfg)
    got = torch.autograd.grad(out, (f, *ws), up)
    torch.cuda.synchronize()
    fn_ms = (time.perf_counter() - t0) * 1e3
    fn_peak = torch.cuda.max_memory_allocated()
    _new_peak()
    t0 = time.perf_counter()
    ref = gnn.edge_attention_reference(f, lp, g, cfg)
    want = torch.autograd.grad(ref, (f, *ws), up)
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) * 1e3
    ref_peak = torch.cuda.max_memory_allocated()
    errs = {"output": _rel_err(out, ref)}
    errs.update({k: _rel_err(a, b) for k, a, b in
                 zip(["f", *names], got, want)})
    res = {"rel_err": errs, "max_rel_err": max(errs.values()),
           "function_ms": fn_ms, "reference_form_ms": ref_ms,
           "function_peak_bytes": fn_peak, "reference_peak_bytes": ref_peak}
    log(f"[12a gnn backward] autograd.Function vs the reference's form, "
        f"forward + backward of one layer's edge loop: max rel err "
        f"{res['max_rel_err']:.3g} ({errs}); {fn_ms:.1f} vs {ref_ms:.1f} "
        f"ms, peak {fn_peak / 1e9:.2f} vs {ref_peak / 1e9:.2f} GB")
    if not res["max_rel_err"] <= GNN_ORDER_TOL:
        raise AssertionError(f"12a: the edge loop's backward differs from "
                             f"the reference's form: {errs}")
    del out, ref, got, want, f, up
    gc.collect()
    torch.cuda.empty_cache()
    return res


def gnn_minibatch(shape: dict, seed: int, dev, card: str) -> dict:
    """12c: ``minibatch_lg``.  A synthetic graph of Reddit's node count,
    feature width and classes, each node's in-degree cut to GNN_LG_DEGREE,
    through the port's ``NeighborSampler`` (``batch_nodes`` seeds, fanout
    (15, 10), padded to the shape's nodes and edges); ``predict`` at all 12
    layers without gradients (wall, nodes/s, peak, both bounds; busy share
    and largest kernels of one layer under torch.profiler); then training
    at full width with the deepest layer count whose peak (extrapolated
    from 1- and 2-layer steps) stays under PEAK_MEMORY_MAX."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import equiformer_v2 as eq
    from repro_torch.data import graph as graphdata
    from repro_torch.models import gnn

    t0 = time.perf_counter()
    n, deg = shape["full_nodes"], GNN_LG_DEGREE
    gen = np.random.Generator(np.random.Philox(key=seed))
    dst = np.repeat(np.arange(n), deg)
    src = (dst + gen.integers(1, n, n * deg)) % n       # no self loops
    feats = gen.standard_normal((n, shape["d_feat"]), dtype=np.float32)
    labels = gen.integers(0, shape["n_classes"], n).astype(np.int32)
    sampler = graphdata.NeighborSampler(seed, n, np.stack([src, dst]), feats,
                                        labels)
    del src, dst
    draw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    seeds = gen.choice(n, shape["batch_nodes"], replace=False)
    hg = sampler.sample(seeds, shape["fanout"], shape["pad_nodes"],
                        shape["pad_edges"])
    sample_s = time.perf_counter() - t0
    del sampler, feats
    valid = hg.edge_src >= 0
    E_real = int(valid.sum())
    N_real = int(max(hg.edge_src.max(), hg.edge_dst.max())) + 1
    cfg = eq.full_config(shape)
    nch = hg.edge_src.shape[0] // gnn._chunk_size(hg.edge_src.shape[0],
                                                  cfg.edge_chunk)
    log(f"[12c gnn minibatch_lg] synthetic graph of {n} nodes x "
        f"{shape['d_feat']} features, in-degree {deg} ({n * deg} edges, cut "
        f"from {shape['full_edges']}) drawn in {draw_s:.1f}s; "
        f"{shape['batch_nodes']} seeds at fanout {shape['fanout']} sampled "
        f"in {sample_s:.1f}s: {N_real} nodes reached, {E_real} edges, padded "
        f"to {hg.node_feat.shape[0]} / {hg.edge_src.shape[0]} ({nch} chunks "
        f"of {cfg.edge_chunk})")

    g = graphdata.to_device(hg, dev)
    _new_peak()
    model = gnn.init_params(torch.Generator(device=dev).manual_seed(seed),
                            cfg, device=dev)
    walls = []
    with torch.no_grad():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = gnn.predict(model, g, cfg)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        ok = (tuple(logits.shape) == (hg.node_feat.shape[0], cfg.n_out)
              and bool(torch.isfinite(logits).all()))
        del logits
    fwd_peak = torch.cuda.max_memory_allocated()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    one = dataclasses.replace(cfg, n_layers=1)
    model = gnn.init_params(torch.Generator(device=dev).manual_seed(seed),
                            one, device=dev)
    with torch.no_grad():
        prof_wall, by_name = device_profile(
            lambda: gnn.predict(model, g, one), 1)
    busy = busy_summary(prof_wall, by_name, top=8)
    del model
    acc_bytes = hg.node_feat.shape[0] * cfg.k * cfg.c * 4
    acc_ms = gnn_accumulator_ms(g, cfg)
    flops = cfg.n_layers * gnn_edge_flops(cfg, E_real)
    flop_ms = flops / F32_OPS_PER_S * 1e3
    byte_ms = cfg.n_layers * nch * 2 * acc_bytes / HBM_BYTES_PER_S * 1e3
    fwd = {"walls_ms": walls, "ms": walls[-1],
           "nodes_per_s": N_real / walls[-1] * 1e3,
           "flop_bound_ms": flop_ms, "byte_bound_ms": byte_ms,
           "peak_bytes": fwd_peak, "one_layer_busy": busy,
           "accumulator_ms_a_chunk": acc_ms,
           "accumulator_share": cfg.n_layers * nch * sum(acc_ms.values())
           / walls[-1], "finite": ok}
    log(f"[12c gnn forward] predict at {cfg.n_layers} layers without "
        f"gradients: walls {[round(w, 1) for w in walls]} ms (first: "
        f"warm-up), {fwd['nodes_per_s']:.0f} nodes/s; bounds: FLOPs "
        f"{flop_ms:.1f} ms ({flops / 1e12:.2f} T at 67 TFLOP/s), bytes "
        f"{byte_ms:.1f} ms ({cfg.n_layers} x {nch} chunks x 2 x "
        f"{acc_bytes / 1e9:.2f} GB of accumulator rescaled and summed at "
        f"3.35 TB/s); the accumulator a chunk: {acc_ms} ms, "
        f"{fwd['accumulator_share']:.3f} of the forward; one layer under "
        f"torch.profiler: busy "
        f"{busy['busy_share']}, {busy['device_ms']} of {prof_wall:.1f} ms, "
        f"top {busy['top_kernels_ms']}; peak {fwd_peak / 1e9:.2f} GB "
        f"({card})")
    if not ok:
        raise AssertionError("12c: the forward's logits are not finite or "
                             "not [N, n_out]")

    # the deepest cut: each layer the remat keeps adds its input, so the
    # peak grows by one 1- to 2-layer step difference a layer
    probe = {}
    for layers in (1, 2):
        _new_peak()
        m, *_ = gnn_fit(dataclasses.replace(cfg, n_layers=layers), g, seed,
                        dev, 1)
        probe[layers] = torch.cuda.max_memory_allocated()
        del m, _
        gc.collect()
        torch.cuda.empty_cache()
    per_layer = probe[2] - probe[1]
    room = PEAK_MEMORY_MAX - 1e9 - probe[1]
    depth = int(min(cfg.n_layers, 1 + room // per_layer))
    if depth < 1:
        raise AssertionError(f"12c: one layer's train step peaks at "
                             f"{probe[1] / 1e9:.2f} GB")
    cut = dataclasses.replace(cfg, n_layers=depth)
    _new_peak()
    model, state, step, opt_cfg, twalls, losses, norms = gnn_fit(
        cut, g, seed, dev, GNN_LG_TIMED + 1)
    split = gnn_step_split(model, state, g, cut, opt_cfg)
    peak = torch.cuda.max_memory_allocated()
    p50 = float(np.percentile(twalls[1:], 50))
    bound_ms = 4 * depth * gnn_edge_flops(cfg, E_real) / F32_OPS_PER_S * 1e3
    train = {"layers": depth, "probe_peak_bytes": probe,
             "walls_ms": twalls, "step_ms_p50": p50,
             "nodes_per_s": N_real / p50 * 1e3, "losses": losses,
             "grad_norms": norms, "split": split, "bound_ms": bound_ms,
             "peak_bytes": peak}
    log(f"[12c gnn train] {depth} of {cfg.n_layers} layers at full width "
        f"(peaks at 1 / 2 layers {probe[1] / 1e9:.2f} / "
        f"{probe[2] / 1e9:.2f} GB): step walls "
        f"{[round(w, 1) for w in twalls]} ms (first: warm-up), p50 "
        f"{p50:.1f} ms (bound {bound_ms:.1f} ms), losses "
        f"{[round(x, 4) for x in losses]}, grad norms "
        f"{[round(x, 3) for x in norms]}; one step's CUDA events: forward "
        f"{split['forward_ms']:.1f}, backward {split['backward_ms']:.1f}, "
        f"clip + AdamW {split['update_ms']:.1f} ms; peak {peak / 1e9:.2f} "
        f"GB ({card})")
    if peak >= PEAK_MEMORY_MAX:
        raise AssertionError(f"12c: peak device memory {peak / 1e9:.2f} GB")
    del model, state, step, g
    gc.collect()
    torch.cuda.empty_cache()
    return {"full_nodes": n, "in_degree": deg, "draw_s": draw_s,
            "sample_s": sample_s, "nodes": hg.node_feat.shape[0],
            "real_nodes": N_real, "edges": hg.edge_src.shape[0],
            "real_edges": E_real, "chunks": nch, "forward": fwd,
            "train": train}


def gnn_accumulator_ms(g, cfg) -> dict:
    """CUDA-event ms of one chunk's two passes over the streaming softmax's
    [N, K, H, C/H] accumulator, on its shapes: the rescale (``mul_`` by a
    per-node, per-head scale) and the scatter of the chunk's weighted
    messages (``index_add_`` at its first chunk's destinations)."""
    import torch

    from repro_torch.models import gnn

    N = g.node_feat.shape[0]
    H = cfg.n_heads
    acc = torch.zeros((N, cfg.k, H, cfg.c // H), device=g.node_feat.device)
    scale = torch.ones((N, H), device=acc.device)
    chunk = gnn._chunk_size(g.edge_src.shape[0], cfg.edge_chunk)
    dst = g.edge_dst[:chunk].long().clamp_min(0)
    msg = torch.ones((chunk,) + acc.shape[1:], device=acc.device)
    out = {"rescale": cuda_ms(lambda: acc.mul_(scale[:, None, :, None]), 5),
           "scatter": cuda_ms(lambda: acc.index_add_(0, dst, msg), 5)}
    del acc, msg
    torch.cuda.empty_cache()
    return out


def gnn_launcher() -> dict:
    """12d: ``repro_torch.launch.train --arch equiformer-v2`` on the card:
    GNN_LAUNCH_STEPS steps with a checkpoint at step 10 under ``build/``,
    then ``--resume``, which must print ``resumed from step 10``."""
    import contextlib
    import io

    from repro_torch.launch import train as launcher

    arch = "equiformer-v2"
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    scratch = tempfile.mkdtemp(prefix="gnn-12d-", dir=root)
    t0 = time.perf_counter()
    runs = []
    try:
        for extra in ([], ["--resume"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                launcher.main(["--arch", arch, "--steps",
                               str(GNN_LAUNCH_STEPS), "--ckpt-dir", scratch,
                               "--ckpt-every", "10", *extra])
            runs.append(buf.getvalue().splitlines())
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    first, resumed = runs
    if not (first and first[0].startswith(f"[{arch}] step    1 loss=")
            and resumed and resumed[0] == "resumed from step 10"):
        raise AssertionError(f"12d {arch}: launcher printed {runs}")
    out = {"wall_s": time.perf_counter() - t0, "lines": first + resumed}
    log(f"[12d gnn launcher] {arch}: {' | '.join(first + resumed)} "
        f"({out['wall_s']:.1f}s)")
    return out


def recsys_path(seed: int, dev, card: str):
    """Phases 6a and 6b on DLRM-rm2 at full width; returns (kernel D's
    JSON row, the recsys JSON line)."""
    import torch

    import repro_torch.kernels as kernels
    from repro_torch.configs import dlrm_rm2
    from repro_torch.data import loaders
    from repro_torch.models import recsys

    cfg = dlrm_rm2.full_config()
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model = recsys.DLRM(cfg, generator=gen, device=dev)
    torch.cuda.synchronize()
    table_bytes = model.tables.numel() * model.tables.element_size()
    mlp_bytes = sum(p.numel() * p.element_size()
                    for n, p in model.named_parameters() if n != "tables")
    log(f"[6a recsys] {cfg.name} drawn on the card in "
        f"{time.perf_counter() - t_phase:.1f}s: tables "
        f"{tuple(model.tables.shape)} f32 = {table_bytes} B "
        f"({table_bytes / 1e9:.2f} GB), MLPs {mlp_bytes} B")

    def host_batch(step, B):
        """The client's batch, on the host (drawn before any clock)."""
        return loaders.recsys_batch(seed, step, B, cfg, device="cpu")

    def on_card(hb):
        """The features DLRM reads, copied to the card."""
        return hb._replace(dense=hb.dense.to(dev), sparse=hb.sparse.to(dev))

    def serve(hb):
        return recsys.score(model, on_card(hb), cfg).cpu()

    k_ret = dlrm_rm2.SHAPES["retrieval_cand"]["k"]

    def retrieve(hb):
        s = recsys.retrieval_scores(model, on_card(hb), cfg)
        top = torch.topk(s, k_ret)
        return top.values.cpu(), top.indices.cpu()

    B_p99 = dlrm_rm2.SHAPES["serve_p99"]["batch"]
    B_bulk = dlrm_rm2.SHAPES["serve_bulk"]["batch"]
    B_ret = dlrm_rm2.SHAPES["retrieval_cand"]["batch"]
    serve(host_batch(0, B_p99))                         # warm-up
    serve(host_batch(1, B_bulk))
    retrieve(host_batch(2, B_ret))
    kernels.reset_launch_counts()
    lat, forwards = {}, 0
    for name, B, n in (("serve_p99", B_p99, P99_BATCHES),
                       ("serve_bulk", B_bulk, BULK_BATCHES),
                       ("retrieval_cand", B_ret, RETRIEVAL_REQUESTS)):
        walls = []
        for i in range(n):
            hb = host_batch(1000 * (len(lat) + 1) + i, B)
            t0 = time.perf_counter()
            out = serve(hb) if name != "retrieval_cand" else retrieve(hb)
            walls.append((time.perf_counter() - t0) * 1e3)
            forwards += 1
            want = (B,) if name != "retrieval_cand" else (B, k_ret)
            vals = out if name != "retrieval_cand" else out[0]
            if tuple(vals.shape) != want or not torch.isfinite(vals).all():
                raise AssertionError(f"bad {name} output: "
                                     f"{tuple(vals.shape)}, want {want}")
        lat[name] = request_latency(walls, B)
    counts = kernels.launch_counts()
    log(f"[6a recsys] served {P99_BATCHES} batches at B={B_p99}, "
        f"{BULK_BATCHES} at B={B_bulk} and {RETRIEVAL_REQUESTS} "
        f"retrieval_cand requests (top-{k_ret} of {cfg.n_items}): "
        f"{forwards} forwards; launches {counts}")
    if counts["embed_bag"] != forwards:
        raise AssertionError(f"kernel D launched {counts['embed_bag']} "
                             f"times in {forwards} forwards")
    check_path_launches(counts, "recsys", ("embed_bag",),
                        ("sinnamon_score_topk", "sinnamon_score_threshold",
                         "csr_score", "sinnamon_score", "csr_rerank_topk"))

    b = on_card(host_batch(0, B_p99))
    lk = recsys.score(model, b, cfg)
    lp = recsys.score(model, b, cfg, use_kernel=False)
    ek = recsys.stacked_embedding_bag(model.tables, b.sparse)
    ep = recsys.stacked_embedding_bag(model.tables, b.sparse,
                                      use_kernel=False)
    _, fidx = recsys.stacked_bag_operands(model.tables, b.sparse)
    torch.cuda.synchronize()
    max_row = int(fidx.max())
    if not torch.equal(lk.view(torch.int32), lp.view(torch.int32)):
        raise AssertionError("kernel-path logits != twin-path logits")
    if not torch.equal(ek.view(torch.int32), ep.view(torch.int32)):
        raise AssertionError("kernel D bags != twin bags on the rm2 table")
    if max_row < 2**23:
        raise AssertionError(f"indices reach row {max_row} only")
    log(f"[6a recsys] B={B_p99}: kernel-path logits bit-equal to the "
        f"twin path's; the [{B_p99}, {cfg.n_sparse}, {cfg.embed_dim}] bags "
        f"bit-equal to the twin's on the flattened "
        f"[{cfg.n_sparse * cfg.vocab_per_field}, {cfg.embed_dim}] table "
        f"(rows up to {max_row})")
    del lk, lp, ek, ep, fidx

    profiles = {}
    for name, B, calls, fn in (("serve_p99", B_p99, 20, serve),
                               ("serve_bulk", B_bulk, 2, serve),
                               ("retrieval_cand", B_ret, 20, retrieve)):
        hb = host_batch(9000, B)
        profiles[name] = busy_summary(*device_profile(lambda: fn(hb), calls))
        p = profiles[name]
        log(f"[6a recsys]   {name} under torch.profiler: wall "
            f"{p['wall_ms']:.4f} ms per request, device busy "
            + ("not measured (no device activity recorded)"
               if p["busy_share"] is None else
               f"{p['device_ms']:.4f} ms ({p['busy_share']:.3f}); largest: "
               + "; ".join(f"{k} {v:.4f} ms"
                           for k, v in p["top_kernels_ms"].items())))

    d_row, fwd = kernel_d_times(model, cfg, host_batch, on_card, counts,
                                card)
    for name in ("serve_p99", "serve_bulk"):
        lat[name].update(fwd[name])
    for name, p in lat.items():
        log(f"[6a recsys]   {name}: request latency p50 {p['p50']:.4f} ms, "
            f"p99 {p['p99']:.4f} ms over {p['batches']} requests; "
            f"{p['qps']:.1f} samples/s"
            + (f"; forward alone {p['forward_ms']:.4f} ms (f32 FLOP bound "
               f"{p['flop_bound_ms']:.4f} ms)" if "forward_ms" in p else "")
            + (f"; one forward allocates {p['forward_alloc_bytes']} B above "
               f"what is resident" if "forward_alloc_bytes" in p else ""))
    log(f"[6a recsys] done in {time.perf_counter() - t_phase:.1f}s")

    retrieval = recsys_retrieval(model, cfg, host_batch, on_card, seed, dev)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    line = {"model": cfg.name, "table_bytes": table_bytes,
            "mlp_bytes": mlp_bytes, "forwards": forwards,
            "sinnamon_retrieval": retrieval, "profiles": profiles}
    for name, p in lat.items():
        line[name] = {"batch": {"retrieval_cand": B_ret, "serve_p99": B_p99,
                                "serve_bulk": B_bulk}[name],
                      "p50_ms": p["p50"], "p99_ms": p["p99"],
                      "requests": p["batches"], "samples_per_s": p["qps"],
                      **{k: p[k] for k in ("forward_ms", "flop_bound_ms",
                                           "forward_kernels",
                                           "forward_host_ms",
                                           "forward_alloc_bytes") if k in p}}
    return d_row, line


def kernel_d_times(model, cfg, host_batch, on_card, counts, card):
    """Kernel D at both serving shapes: CUDA events per call, device time
    alone (torch.profiler) and host time per call.

    The stacked form as the forward launches it (the request's indices as
    they are, the bags written into rows 1.. of a [B, 27, D] buffer) beside
    the route it replaced on the same batches (``stacked_bag_operands``,
    the flat form with a ``torch.ones`` weight tensor, ``torch.cat`` after
    x0), against its twin and its byte bound.  The
    flat form (field-offset indices into the [26,000,000, 64] table, signed
    0/1 weights) against its twin, ``F.embedding_bag`` on the same operands
    (the yardstick; the port never calls it) and its byte bound.  At B=512
    also the wrapper's host-time split, and the forward's device kernels
    (torch.profiler) and host time issued without a sync.  The DLRM forward
    against its f32 FLOP bound; at B=262,144 also the device memory one
    forward allocates above what is resident before it.  At B=512 each launch takes the next of 32
    batches' indices (109 MB of rows, more than the 50 MB L2), so rows come
    from HBM, as they do for a stream of requests."""
    import itertools

    import torch
    import torch.nn.functional as Fn

    from repro_torch.configs import dlrm_rm2
    from repro_torch.kernels import embed_bag
    from repro_torch.models import recsys

    tables = model.tables
    nF, _, D = tables.shape
    elt = tables.element_size()
    dev = tables.device
    out, fwd, errs = {}, {}, []
    for name, n_sets, reps in (("serve_p99", 32, 256), ("serve_bulk", 1, 10)):
        B = dlrm_rm2.SHAPES[name]["batch"]
        sets = []
        for i in range(n_sets):
            b = on_card(host_batch(5000 + i, B))
            flat, fidx = recsys.stacked_bag_operands(tables, b.sparse)
            valid = fidx >= 0
            sets.append(dict(b=b, flat=flat, fidx=fidx,
                             w=valid.to(torch.float32),
                             safe=torch.where(valid, fidx, 0).long()))
        cyc = itertools.cycle(sets)
        # the twins first: the interaction buffers below are not yet held
        r = {"B": B, "bags": B * nF}
        r["plain_ms"] = cuda_ms(lambda: embed_bag.stacked_embed_bag_plain(
            tables, next(cyc)["b"].sparse), max(2, reps // 32))
        r["flat_plain_ms"] = cuda_ms(lambda: embed_bag.embed_bag_plain(
            *(lambda s: (s["flat"], s["fidx"], s["w"]))(next(cyc))),
            max(2, reps // 32))
        for s in sets:
            s["vecs"] = model.interaction_input(s["b"].dense, s["b"].sparse)
            s["out"], s["x0"] = s["vecs"][:, 1:], s["vecs"][:, 0].contiguous()

        def stacked():
            s = next(cyc)
            return embed_bag.embed_bag(tables, s["b"].sparse, out=s["out"])

        def old_route(s=None):
            s = s or next(cyc)
            flat, fidx = recsys.stacked_bag_operands(tables, s["b"].sparse)
            ones = torch.ones(fidx.shape, dtype=torch.float32, device=dev)
            emb = embed_bag.embed_bag(flat, fidx, ones).view(B, nF, D)
            return torch.cat([s["x0"][:, None, :], emb], dim=1)

        def flat_kernel():
            s = next(cyc)
            return embed_bag.embed_bag(s["flat"], s["fidx"], s["w"])

        def library():
            s = next(cyc)
            return Fn.embedding_bag(s["safe"], s["flat"], mode="sum",
                                    per_sample_weights=s["w"])

        for key, fn in (("ms", stacked), ("old_route_ms", old_route),
                        ("flat_ms", flat_kernel), ("library_ms", library)):
            r[key] = cuda_ms(fn, reps)
        for key, fn in (("host_ms", stacked), ("old_route_host_ms", old_route),
                        ("flat_host_ms", flat_kernel),
                        ("library_host_ms", library)):
            r[key] = host_ms(fn, reps)
        # device time alone (the CUDA-event time includes any host gap
        # between launches): kernel D's kernel per launch the profiler
        # recorded; every kernel of the old route and the library per call
        for key, fn in (("device_ms", stacked),
                        ("flat_device_ms", flat_kernel)):
            r[key], recorded = launch_device_ms(fn, reps, "embed_bag_kernel")
            r[key.replace("device_ms", "records")] = recorded
        for key, fn in (("old_route_device_ms", old_route),
                        ("library_device_ms", library)):
            _, by_name = device_profile(fn, reps)
            r[key] = sum(by_name.values()) or None
        s = sets[0]
        if name == "serve_p99":
            r["split"] = wrapper_split(tables, s["b"].sparse, s["out"], B)

        sparse, fidx, w = s["b"].sparse, s["fidx"], s["w"]
        want = embed_bag.stacked_embed_bag_plain(tables, sparse)
        got = embed_bag.embed_bag(tables, sparse, out=s["out"])
        torch.cuda.synchronize()
        if not torch.equal(got.contiguous().view(torch.int32),
                           want.view(torch.int32)):
            raise AssertionError(f"stacked kernel D != twin at {name}")
        del got, want
        if not torch.equal(old_route(s).view(torch.int32),
                           s["vecs"].view(torch.int32)):
            raise AssertionError(f"old bag route != stacked form at {name}")
        for t in sets:                  # the buffers are not needed below
            del t["vecs"], t["out"], t["x0"]
        got = embed_bag.embed_bag(s["flat"], fidx, w)
        flat_want = embed_bag.embed_bag_plain(s["flat"], fidx, w)
        lib = Fn.embedding_bag(s["safe"], s["flat"], mode="sum",
                               per_sample_weights=w)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), flat_want.view(torch.int32)):
            raise AssertionError(f"kernel D (flat) != twin at {name}")
        errs.append(finite_max_err(got, flat_want))
        r["library_err"] = finite_max_err(got, lib)
        del got, flat_want, lib
        # the function reads each distinct row the batch references once;
        # the per-slot count (a row read at every valid slot) is kept beside
        n_valid = int((fidx >= 0).sum())
        n_rows = torch.unique(fidx[fidx >= 0]).numel()
        out_bytes = B * nF * D * 4
        n_ops = 2 * n_valid * D
        for key, io_bytes in (("", sparse.numel() * 4 + out_bytes),
                              ("flat_", fidx.numel() * 8 + out_bytes)):
            nbytes = n_rows * D * elt + io_bytes
            r[f"{key}bytes"] = nbytes
            r[f"{key}bound_ms"] = max(nbytes / HBM_BYTES_PER_S,
                                      n_ops / F32_OPS_PER_S) * 1e3
            r[f"{key}bound_by"] = "bytes" if nbytes / HBM_BYTES_PER_S \
                >= n_ops / F32_OPS_PER_S else "operations"
            r[f"{key}bound_ms_per_slot"] = max(
                (n_valid * D * elt + io_bytes) / HBM_BYTES_PER_S,
                n_ops / F32_OPS_PER_S) * 1e3
        r.update(rows=n_rows, valid_slots=n_valid)
        b = s["b"]
        f_ms = cuda_ms(lambda: recsys.score(model, b, cfg), max(3, reps // 4))
        fwd[name] = {"forward_ms": f_ms, "flop_bound_ms":
                     dlrm_flops(cfg, B) / F32_OPS_PER_S * 1e3}
        if name in ("serve_bulk", "serve_p99"):
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            _PEAK_BEFORE_RESET[0] = max(_PEAK_BEFORE_RESET[0],
                                        torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            recsys.score(model, b, cfg)
            torch.cuda.synchronize()
            fwd[name]["forward_alloc_bytes"] = \
                torch.cuda.max_memory_allocated() - resident
        if name == "serve_p99":
            r["forward_kernels"], names = device_kernels(
                lambda: recsys.score(model, b, cfg), 200)
            r["forward_host_ms"] = host_ms(
                lambda: recsys.score(model, b, cfg), reps)
            fwd[name].update(forward_kernels=r["forward_kernels"],
                             forward_host_ms=r["forward_host_ms"])
        out[name] = r
        prof = lambda ms: "not measured" if ms is None else f"{ms:.4f} ms"
        log(f"[6a recsys]   embed_bag {name} (B={B}, {B * nF} bags of "
            f"{sparse.shape[2]}, {n_valid} valid slots on {n_rows} distinct "
            f"rows) on {card}: stacked form {r['ms']:.4f} ms, device alone "
            f"{prof(r['device_ms'])} ({r['records']:.2f} launches recorded "
            f"a call), host {r['host_ms']:.4f} ms per call "
            f"(bound {r['bound_ms']:.4f} ms = {r['bytes']} B; twin "
            f"{r['plain_ms']:.4f} ms); the old route (operands + flat + ones + cat) "
            f"{r['old_route_ms']:.4f} ms, device alone "
            f"{prof(r['old_route_device_ms'])}, host "
            f"{r['old_route_host_ms']:.4f} ms")
        log(f"[6a recsys]   embed_bag {name} flat form: {r['flat_ms']:.4f} "
            f"ms, device alone {prof(r['flat_device_ms'])}, host "
            f"{r['flat_host_ms']:.4f} ms per call (twin "
            f"{r['flat_plain_ms']:.4f} ms; F.embedding_bag "
            f"{r['library_ms']:.4f} ms, device alone "
            f"{prof(r['library_device_ms'])}, host "
            f"{r['library_host_ms']:.4f} ms; bound {r['flat_bound_ms']:.4f} "
            f"ms = {r['flat_bytes']} B, {r['flat_bound_ms_per_slot']:.4f} ms "
            f"reading a row per slot; library max abs diff "
            f"{r['library_err']:.3g})")
        if name == "serve_p99":
            log(f"[6a recsys]   embed_bag wrapper host split at B={B} (us "
                f"per call): " + ", ".join(f"{k} {v * 1e3:.2f}"
                                          for k, v in r["split"].items()))
            log(f"[6a recsys]   forward at B={B} (features on the card): "
                f"{r['forward_kernels']:.2f} device kernels per forward, "
                f"host {r['forward_host_ms']:.4f} ms per forward issued "
                f"without a sync; kernels per forward: "
                + "; ".join(f"{k} x{n:.2f}" for k, n in names.items()))
        del sets, s
        torch.cuda.empty_cache()
    bulk, p99 = out["serve_bulk"], out["serve_p99"]
    row = {"name": "embed_bag", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/embed_bag.cu",
           "replaces": "src/repro/kernels/embed_bag.py:60",
           "launches": counts["embed_bag"], "max_abs_err": max(errs),
           "ms": bulk["ms"], "plain_ms": bulk["plain_ms"],
           "bound_ms": bulk["bound_ms"], "bound_by": bulk["bound_by"],
           "library_ms": bulk["library_ms"],
           "shape": f"stacked: B={bulk['B']} x {nF} bags of "
                    f"{cfg.multi_hot}, D={D}, tables [{nF}, "
                    f"{cfg.vocab_per_field}, {D}], into rows 1.. of "
                    f"[B, {nF + 1}, {D}]"}
    for tag, r in (("", bulk), ("_b512", p99)):
        for key in ("device_ms", "host_ms", "old_route_ms",
                    "old_route_device_ms", "old_route_host_ms",
                    "bound_ms_per_slot", "flat_ms", "flat_device_ms",
                    "flat_host_ms", "flat_plain_ms", "flat_bound_ms",
                    "library_device_ms", "library_host_ms"):
            row[key + tag] = r[key]
        if tag:
            for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
                row[key + tag] = r[key]
    row.update(host_split_b512=p99["split"],
               forward_kernels_b512=p99["forward_kernels"],
               forward_host_ms_b512=p99["forward_host_ms"])
    return row, fwd


def wrapper_split(tables, sparse, out, B: int, reps: int = 2000) -> dict:
    """Host ms per call of each step of kernel D's wrapper on the stacked
    form, timed alone with the host clock over ``reps`` calls, the whole
    call beside them: the layout key and its lookup, the pointers, the
    stream, the ctypes call (which launches the kernel); the checks and the
    plan, which run once per layout; and the steps the wrapper before this
    design took on every call that this one does not (a ``torch.ones``
    weight tensor, the output's ``torch.empty``,
    ``torch.cuda.current_stream(dev).cuda_stream``, ``_build.sm_count``).
    Every ctypes call's return code goes through ``_build.check``, so a
    launch that failed raises."""
    import torch

    from repro_torch.kernels import _build, embed_bag

    dev = tables.device
    key = embed_bag.layout_key(tables, sparse, None, out)
    fn = embed_bag._launcher()
    # the struct is held for as long as its address is used
    addr, st = embed_bag._new_launch(tables, sparse, out)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    ptrs = (tables.data_ptr(), sparse.data_ptr(), None, out.data_ptr())
    steps = {
        "layout_key": lambda: embed_bag.layout_key(tables, sparse, None,
                                                   out),
        "lookup": lambda: embed_bag._LAUNCHES.get(key),
        "data_ptrs": lambda: (tables.data_ptr(), sparse.data_ptr(),
                              out.data_ptr()),
        "stream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "ctypes_launch": lambda: _build.check(fn(addr, *ptrs, stream),
                                              "embed_bag"),
        "whole_call": lambda: embed_bag.embed_bag(tables, sparse, out=out),
        "once_checks": lambda: embed_bag.check_operands(tables, sparse, None,
                                                        out),
        "once_plan": lambda: embed_bag._new_launch(tables, sparse, out),
        "gone_ones": lambda: torch.ones(sparse.shape, dtype=torch.float32,
                                        device=dev),
        "gone_empty": lambda: torch.empty((B * tables.shape[0],
                                           tables.shape[-1]),
                                          dtype=torch.float32, device=dev),
        "gone_current_stream": lambda:
            torch.cuda.current_stream(dev).cuda_stream,
        "gone_sm_count": lambda: _build.sm_count(dev),
    }
    return {k: host_ms(f, reps) for k, f in steps.items()}


def device_kernels(fn, calls: int):
    """(device kernels per call of ``fn`` under torch.profiler, {name: per
    call}); copies and memsets not counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    names = {e.key[:60]: e.count / calls for e in prof.key_averages()
             if e.self_device_time_total > 0
             and not e.key.startswith(("Memcpy", "Memset"))}
    return sum(names.values()), names


def launch_device_ms(fn, calls: int, name: str):
    """(device ms per launch of the kernels whose name holds ``name``,
    launches recorded per call) under torch.profiler: the mean over the
    launches the profiler recorded, so that a dropped record does not lower
    it; (None, 0) when it recorded none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if name in e.key]
    n = sum(e.count for e in hits)
    if not n:
        return None, 0
    return sum(e.self_device_time_total for e in hits) / 1e3 / n, n / calls


def recsys_retrieval(model, cfg, host_batch, on_card, seed, dev) -> dict:
    """Phase 6b: the item catalog sparsified into a Sinnamon index, the
    model's users served through ``search_many``."""
    import numpy as np
    import torch

    import repro_torch.kernels as kernels
    from repro_torch.core import engine as eng
    from repro_torch.kernels import ops
    from repro_torch.kernels.sinnamon_score import topk_desc
    from repro_torch.models import recsys

    t0 = time.perf_counter()
    items = recsys.item_embeddings(model, cfg)
    s_idx, s_val = recsys.sparsify_items(items, ITEM_NNZ)
    spec = eng.EngineSpec(n=cfg.embed_dim, m=ITEM_M,
                          capacity=-(-cfg.n_items // 32) * 32,
                          max_nnz=ITEM_NNZ, h=1, value_dtype="float32",
                          seed=seed)
    index = eng.SinnamonIndex(spec, device=dev)
    for lo in range(0, cfg.n_items, 32_768):
        hi = min(lo + 32_768, cfg.n_items)
        index.insert_many(range(lo, hi), s_idx[lo:hi], s_val[lo:hi])
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    users = recsys.user_repr(model, on_card(host_batch(7000, USERS)), cfg)
    q_idx = torch.arange(cfg.embed_dim, dtype=torch.int32,
                         device=dev).expand(USERS, -1).contiguous()
    index.search_many(q_idx[:16], users[:16], k=K, kprime=ITEM_KPRIME)
    kernels.reset_launch_counts()
    walls = []
    for _ in range(5):
        t1 = time.perf_counter()
        ids, scores = index.search_many(q_idx, users, k=K,
                                        kprime=ITEM_KPRIME)
        walls.append((time.perf_counter() - t1) * 1e3)
    counts = kernels.launch_counts()
    log(f"[6b recsys retrieval] {cfg.n_items} items sparsified to their "
        f"top-{ITEM_NNZ} coordinates and indexed (n={cfg.embed_dim}, "
        f"m={ITEM_M}, h=1, f32 values) in {t_build:.1f}s; 5 batches of "
        f"{USERS} users (k={K}, k'={ITEM_KPRIME}); launches {counts}")
    check_path_launches(counts, "recsys retrieval",
                        ("sinnamon_score_topk", "csr_rerank_topk"),
                        ("sinnamon_score", "embed_bag", "csr_score"))
    if ids.shape != (USERS, K) or not np.isfinite(scores).all():
        raise AssertionError(f"bad retrieval result {ids.shape}")

    dense_top = torch.topk(users @ items.t(), K).indices.cpu().numpy()
    exact = ops.exact_scores_all(index.state.store, users.contiguous())
    exact = torch.where(index.state.active[None, :], exact, -torch.inf)
    _, top = topk_desc(exact, K)
    sparse_top = index.state.ids[top.long()].cpu().numpy()
    del exact, top
    r_dense, r_sparse = recall_at_k(ids, dense_top), recall_at_k(ids,
                                                                  sparse_top)
    ids_k, _, _ = eng.search_batch(index.state, spec, q_idx[:16],
                                   users[:16], K, ITEM_KPRIME)
    ids_p, _, _ = eng.search_batch(index.state, spec, q_idx[:16],
                                   users[:16], K, ITEM_KPRIME,
                                   use_kernel=False)
    if not torch.equal(ids_k, ids_p):
        raise AssertionError("recsys retrieval: kernel-path ids != "
                             "twin-path ids")
    p = request_latency(walls, USERS)
    log(f"[6b recsys retrieval] batch wall p50 {p['p50']:.4f} ms, p99 "
        f"{p['p99']:.4f} ms ({p['qps']:.1f} users/s); recall@{K} "
        f"{r_dense:.4f} against the dense exact top-{K} (the cost of "
        f"keeping {ITEM_NNZ} of {cfg.embed_dim} coordinates), {r_sparse:.4f} "
        f"against the exact sparse top-{K} (LinScan); kernel-path ids == "
        f"twin-path ids on a batch of 16; {time.perf_counter() - t0:.1f}s")
    del index
    return {"items": cfg.n_items, "nnz": ITEM_NNZ, "m": ITEM_M,
            "kprime": ITEM_KPRIME, "batch": USERS, "p50_ms": p["p50"],
            "p99_ms": p["p99"], "users_per_s": p["qps"],
            "recall_at_10_vs_dense": r_dense,
            "recall_at_10_vs_sparse_exact": r_sparse,
            "build_s": t_build}


CELL_NAMES = {"float32": "f32", "bfloat16": "bf16", "float8_e4m3fn": "f8"}


def dense_instances(ptxas_log: str) -> dict:
    """Kernel C's instances in an ``nvcc -Xptxas -v`` log: {"bf16x8":
    (registers, spill store bytes, spill load bytes), ...} (cell type x
    32-slot words per tile), plus ``mark_rows``."""
    cells = {"f": "f32", "4Bf16": "bf16", "6F8E4M3": "f8"}
    out, name, spill = {}, None, (0, 0)
    for line in ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            k = re.search(r"sinnamon_dense_kernelI(\w+?)Li(\d+)E", name)
            key = (f"{cells[k.group(1)]}x{k.group(2)}" if k
                   else "mark_rows" if "mark_rows" in name else name)
            out[key] = (int(m.group(1)), *spill)
            name = None
    return out


def check_path_launches(counts: dict, path: str, launched, not_launched):
    """Each kernel of ``launched`` ran on this path, none of
    ``not_launched`` did."""
    for kname in launched:
        if counts[kname] <= 0:
            raise AssertionError(f"kernel {kname} was not launched on the "
                                 f"{path} path")
    for kname in not_launched:
        if counts[kname] != 0:
            raise AssertionError(f"kernel {kname} ran on the {path} path")


def recall_at_k(ids, truth) -> float:
    return sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(ids, truth)) / (len(truth) * K)


def exact_top_ids(index, qi, qv):
    """Exact top-K ids of queries [b, Lq] over the live documents: kernel B's
    LinScan, gated to active slots, then ``topk_desc``."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.sinnamon_score import topk_desc
    from repro_torch.storage import vecstore

    st = index.state
    exact = ops.exact_scores_all(st.store, vecstore.densify_query(N, qi, qv))
    exact = torch.where(st.active[None, :], exact, -torch.inf)
    _, top = topk_desc(exact, K)
    return st.ids[top.long()].cpu().numpy()


def request_latency(walls_ms, bsz) -> dict:
    """p50 / p99 of the batches' wall times (each request's latency is its
    batch's) and the throughput over them."""
    import numpy as np
    w = np.asarray(walls_ms, np.float64)
    return {"p50": float(np.percentile(w, 50)),
            "p99": float(np.percentile(w, 99)), "batches": len(w),
            "qps": bsz * len(w) / (w.sum() / 1e3)}


def np_all_finite(x) -> bool:
    import numpy as np
    return bool(np.isfinite(x).all())


def kernel_c_work(state, qv, rows, brows, one_sided):
    """Bytes and f32 operations kernel C needs for this batch: the sketch
    and bitmap rows of :func:`scoring_work`, the operands, the f32[B, C]
    output written once.  Without a lower sketch a coordinate with q <= 0
    reads nothing."""
    valid = brows >= 0
    if not one_sided:
        valid &= qv > 0
    C = state.sketch.shape[1]
    nbytes, ops = scoring_work(state, rows, brows, valid)
    return (nbytes + qv.shape[0] * C * 4 + qv.numel() * 8 + rows.numel() * 4,
            ops)


def kernel_a_work(state, qv, rows, brows, C, kp):
    """Bytes and f32 operations kernel A needs for this batch: the sketch
    and bitmap rows of :func:`scoring_work`, the per-slot gate, the
    outputs written once."""
    nbytes, ops = scoring_work(state, rows, brows, brows >= 0)
    from repro_torch.kernels import sinnamon_score
    B, T = qv.shape[0], -(-C // sinnamon_score.TILE_C)
    return nbytes + C + B * T * kp * 8 + qv.numel() * 12, ops


def selection_times(sinnamon_score, args, one_sided, reps: int = 10):
    """Candidate selection over one batch of kernel A's operands: the
    single pass (kernel A over every tile, ``merge_tile_topk``) and the two
    passes (the sample's stride given, so taken even under the cut),
    CUDA-event ms and the median host ms of a synced call; raises unless
    both give the same candidates bit for bit with the flag clear."""
    import statistics

    import torch
    S = sinnamon_score
    B = args[0].shape[0]
    T = -(-args[5].shape[1] // S.TILE_C)
    kp = min(KPRIME, S.TILE_C)
    kw = dict(one_sided=one_sided, use_kernel=None, tile_c=S.TILE_C)

    def single():
        return S.merge_tile_topk(
            *S.sinnamon_score_topk(*args, kp=kp, one_sided=one_sided), KPRIME)

    def two():
        keys, flag = S._scan(args, KPRIME, S.SAMPLE_STRIDE, kw)
        return S.merge_keys(keys, KPRIME), flag

    (wv, ws), ((gv, gs), flag) = single(), two()
    if int(flag) or not (torch.equal(ws, gs) and torch.equal(
            wv.view(torch.int32), gv.view(torch.int32))):
        raise AssertionError(f"two passes != single pass at B={B} (flag "
                             f"{int(flag)})")

    def call_ms(fn):
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(walls)

    return {"path": "two" if S.two_pass_stride(B, T, KPRIME) else "single",
            "single_ms": cuda_ms(single, reps), "two_ms": cuda_ms(two, reps),
            "single_call_ms": call_ms(single), "two_call_ms": call_ms(two)}


def threshold_times(sinnamon_score, state, args, one_sided) -> dict:
    """Kernel A's threshold form over the tiles outside the sample, on the
    sample's bound: CUDA-event ms, its twin's, and its bound (the sketch
    and bitmap rows of those tiles read once, their gate, the survivors
    written; a multiply-add per member slot there).  Raises unless the
    kernel's counts and flag equal the twin's and each query's survivors
    are the twin's (the kernel appends in no set order)."""
    import torch
    S = sinnamon_score
    qv, rows, brows = args[:3]
    B, C = qv.shape[0], args[5].shape[1]
    T = -(-C // S.TILE_C)
    s = S.SAMPLE_STRIDE
    kp = min(KPRIME, S.TILE_C)
    sv, ss = S.sinnamon_score_topk(*args, kp=kp, one_sided=one_sided)
    sv, ss = sv[:, ::s], ss[:, ::s]          # the sample's tiles
    head = torch.topk(S.order_key(sv, ss).reshape(B, -1), KPRIME,
                      largest=False, sorted=True).values
    theta = head[:, -1].contiguous()
    cap = S.survivor_cap(KPRIME, s)

    def run(use_kernel=None, cap=cap):
        return S.sinnamon_score_threshold(*args, theta, head, stride=s,
                                          cap=cap, one_sided=one_sided,
                                          use_kernel=use_kernel)

    ms = cuda_ms(run, reps=5)
    plain_ms = cuda_ms(lambda: run(False, C), reps=1)
    keys, counts, flag = run()
    tkeys, tcounts, tflag = run(False, C)
    if not (torch.equal(counts, tcounts) and int(flag) == int(tflag)):
        raise AssertionError("threshold form != twin: counts or flag")
    n = int(counts.max())
    if n > cap:
        raise AssertionError(f"{n} survivors of a query at B={B} pass the "
                             f"cap {cap}")
    H = head.shape[1]
    got = torch.sort(keys[:, H:H + n], dim=1).values
    if not torch.equal(got, tkeys[:, H:H + n]):
        raise AssertionError("threshold form != twin: the survivors")
    share = (T - -(-T // s)) / T
    nbytes, ops = scoring_work(state, rows, brows, brows >= 0)
    nbytes = (nbytes + C) * share + int(counts.sum()) * 8 + qv.numel() * 12
    ops = ops * share
    return {"ms": ms, "plain_ms": plain_ms, "stride": s,
            "tiles": T - -(-T // s), "cap": cap,
            "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                            ops / F32_OPS_PER_S) * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
            >= ops / F32_OPS_PER_S else "operations",
            "survivors_mean": float(counts.float().mean()),
            "survivors_max": n, "flag": int(flag)}


def scoring_work(state, rows, brows, valid):
    """Each sketch row and bitmap row the ``valid`` coordinates reference,
    read once, in bytes; one multiply-add per (coordinate, member slot)
    pair of this run's posting lists."""
    import torch
    C = state.sketch.shape[1]
    sk_rows = torch.unique(rows[valid]).numel()
    bit_rows = torch.unique(brows[valid]).numel()
    df = doc_freq(state)
    pairs = int(torch.where(valid, df[brows.clamp_min(0).long()], 0).sum())
    return (sk_rows * C * state.sketch.element_size() + bit_rows * C // 8,
            2 * pairs)


def doc_freq(state):
    """Set bits per bitmap row (posting-list lengths) from the store."""
    import torch
    idx = state.store.indices
    live = idx[(idx >= 0) & state.active[:, None]].long()
    return torch.bincount(live, minlength=state.bits.shape[0])


def rerank_against_twin(csr_rerank, gen, dev, idx, val, slots, B, Lq):
    """Phase 3: kernel B's rerank form against its twin on the card.  First
    the rows and candidate lists of the dense-query check with sparse
    queries (a duplicate and four pads each) and a tenth of the candidates
    gated: ids and slots equal, scores within rtol = atol = 1e-5.  Then an
    integer-valued batch full of ties (65,536 rows over 2,000 coordinates)
    at B=16 and B=256 (every cluster split the main path takes), k=10 and
    k=k': ids, scores and slots bit-equal."""
    import torch
    ids = torch.randint(0, 2**40, (idx.shape[0],), generator=gen, device=dev)
    qi = torch.randint(0, N, (B, Lq), generator=gen, device=dev,
                       dtype=torch.int32)
    qi[:, 1] = qi[:, 0]
    qi[:, -4:] = -1
    qv = torch.randn((B, Lq), generator=gen, device=dev)
    cand = torch.randn(slots.shape, generator=gen, device=dev)
    cand[torch.rand(slots.shape, generator=gen, device=dev) < 0.1] = -torch.inf
    args = (qi, qv, idx, val, ids, cand, slots, K)
    got = csr_rerank.csr_rerank_topk(*args)
    want = csr_rerank.csr_rerank_topk_plain(*args)
    torch.cuda.synchronize()
    check_rerank(got, want, "phase 3's batch")
    err = finite_max_err(got[1], want[1])
    rows, vocab = 65_536, 2_000
    t_idx = torch.randint(-1, vocab, (rows, P), generator=gen, device=dev,
                          dtype=torch.int32)
    t_val = torch.randint(-3, 4, (rows, P), generator=gen,
                          device=dev).to(torch.bfloat16)
    t_ids = torch.arange(rows, device=dev) * 7
    ties = 0
    for bt in (16, 256):
        qi = torch.randint(0, vocab, (bt, Lq), generator=gen, device=dev,
                           dtype=torch.int32)
        qi[:, -4:] = -1
        qv = torch.randint(-2, 3, (bt, Lq), generator=gen,
                           device=dev).float()
        sl = torch.randint(0, rows, (bt, KPRIME), generator=gen, device=dev,
                           dtype=torch.int32)
        cand = torch.randn((bt, KPRIME), generator=gen, device=dev)
        cand[torch.rand((bt, KPRIME), generator=gen, device=dev)
             < 0.1] = -torch.inf
        for k in (K, KPRIME):
            a = (qi, qv, t_idx, t_val, t_ids, cand, sl, k)
            got = csr_rerank.csr_rerank_topk(*a)
            want = csr_rerank.csr_rerank_topk_plain(*a)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[2], want[2])
                    and torch.equal(got[1].view(torch.int32),
                                    want[1].view(torch.int32))):
                raise AssertionError(f"csr_rerank_topk != twin on the "
                                     f"integer tie batch (B={bt}, k={k})")
            fin = torch.isfinite(want[1])
            ties += int(((want[1][:, 1:] == want[1][:, :-1])
                         & fin[:, 1:]).sum())
    log(f"[3 kernels] csr_rerank_topk (B={B}, k'={KPRIME}, k={K}, P={P}, "
        f"Lq={Lq}, sparse queries, a tenth gated): ids and slots == twin's, "
        f"max abs err {err:.3g} (rtol=atol=1e-5); integer batch at B=16 "
        f"and 256, k={K} and {KPRIME}: ids, scores and slots bit-equal "
        f"({ties} adjacent finite ties)")


def check_rerank(got, want, what: str) -> None:
    """Kernel B's rerank form against its twin: ids and slots equal, scores
    within rtol = atol = 1e-5."""
    import torch
    if not (torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])):
        raise AssertionError(f"csr_rerank_topk ids/slots != its twin's on "
                             f"{what}")
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)


def old_rerank(state, cand_scores, cand_slots, q_idx, q_val, k):
    """The rerank route the kernel replaced, kept as a yardstick: the
    queries densified to f32[B, n], ``csr_score``'s slots form, the gate,
    ``topk_desc`` and the gathers."""
    import torch

    from repro_torch.kernels import csr_score
    from repro_torch.kernels.sinnamon_score import topk_desc
    from repro_torch.storage import vecstore
    q_dense = vecstore.densify_query(N, q_idx, q_val)
    exact = csr_score.csr_score(q_dense, state.store.indices,
                                state.store.values, cand_slots)
    exact = torch.where(torch.isneginf(cand_scores), -torch.inf, exact)
    top, pos = topk_desc(exact, k)
    slots = cand_slots.gather(-1, pos.long())
    return state.ids[slots.long()], top, slots


def rerank_stage(csr_rerank, st, cand_v, cand_s, qi, qv, reps):
    """Kernel B's rerank form on one batch of the main path's candidates:
    its CUDA-event time, its twin's, the old route's on the same inputs,
    the wrapper's host time per call, the kernel's device time alone and
    the old route's kernels' summed (torch.profiler), the sparse-query
    bound and the old dense-query one; its answer held against the
    twin's."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.storage import vecstore
    args = (qi, qv, st.store.indices, st.store.values, st.ids, cand_v,
            cand_s, K)
    ms = cuda_ms(lambda: csr_rerank.csr_rerank_topk(*args), reps=reps)
    plain_ms = cuda_ms(lambda: csr_rerank.csr_rerank_topk_plain(*args),
                       reps=2)
    old_ms = cuda_ms(lambda: old_rerank(st, cand_v, cand_s, qi, qv, K),
                     reps=reps)
    host = host_ms(lambda: csr_rerank.csr_rerank_topk(*args), reps=200)
    # device time alone: at small B a call's host time exceeds its kernel
    _, by_name = device_profile(lambda: csr_rerank.csr_rerank_topk(*args), 50)
    _, old_by_name = device_profile(
        lambda: old_rerank(st, cand_v, cand_s, qi, qv, K), 50)
    got = csr_rerank.csr_rerank_topk(*args)
    want = csr_rerank.csr_rerank_topk_plain(*args)
    old = old_rerank(st, cand_v, cand_s, qi, qv, K)
    torch.cuda.synchronize()
    check_rerank(got, want, f"the main path's B={qi.shape[0]} batch")
    nbytes, ops = rerank_work(st.store, qi, cand_v, cand_s, K)
    o_bytes, o_ops = kernel_b_work(st.store, cand_s,
                                   vecstore.densify_query(N, qi, qv))
    return {"ms": ms, "plain_ms": plain_ms, "old_route_ms": old_ms,
            "host_ms": host,
            "device_ms": sum(v for n, v in by_name.items()
                             if "csr_rerank" in n) if by_name else None,
            "old_route_device_ms": sum(old_by_name.values())
            if old_by_name else None,
            "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                            ops / F32_OPS_PER_S) * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
            >= ops / F32_OPS_PER_S else "operations",
            "old_bound_ms": max(o_bytes / HBM_BYTES_PER_S,
                                o_ops / F32_OPS_PER_S) * 1e3,
            "max_abs_err": finite_max_err(got[1], want[1]),
            "blocks_per_query": csr_rerank.split(
                qi.shape[0], cand_s.shape[1], _build.sm_count(qi.device)),
            "same_as_old_route": bool(torch.equal(got[0], old[0]))}


def rerank_work(store, q_idx, cand_scores, cand_slots, k):
    """Bytes and f32 operations the rerank kernel needs: each distinct
    candidate row that is not gated read once, the candidate scores and
    slots, the sparse queries, the ids it gathers and its outputs written
    once; one multiply-add per stored entry of each scored (query,
    candidate) pair."""
    import torch
    rows = cand_slots[~torch.isneginf(cand_scores)].long()
    row_bytes = store.indices.shape[1] * (4 + store.values.element_size())
    n_rows = torch.unique(rows).numel()
    nnz = int((store.indices[rows] >= 0).sum())
    out = cand_slots.shape[0] * k
    nbytes = (n_rows * row_bytes + cand_slots.numel() * 8
              + q_idx.numel() * 8 + out * (8 + 8 + 4 + 4))
    return nbytes, 2 * nnz


def kernel_b_work(store, slots, q_dense):
    """Bytes and f32 operations kernel B needs: the scored CSR rows read
    once, the dense queries, the outputs; one multiply-add per stored
    non-zero of a scored row."""
    import torch
    row_bytes = store.indices.shape[1] * (4 + store.values.element_size())
    if slots is None:
        n_rows, nnz = store.indices.shape[0], int((store.indices >= 0).sum())
        n_rows *= q_dense.shape[0]
        nnz *= q_dense.shape[0]
    else:
        n_rows = torch.unique(slots).numel()
        nnz = int((store.indices[slots.long()] >= 0).sum())
    k_out = n_rows if slots is None else slots.numel()
    nbytes = n_rows * row_bytes + q_dense.numel() * 4 + k_out * 8
    return nbytes, 2 * nnz


def library_csr(store, n):
    """The store as a torch.sparse CSR matrix [C, n] (f32 values) for the
    library yardstick."""
    import torch
    idx = store.indices
    valid = idx >= 0
    counts = valid.sum(1)
    crow = torch.zeros(idx.shape[0] + 1, dtype=torch.int64, device=idx.device)
    crow[1:] = torch.cumsum(counts, 0)
    return torch.sparse_csr_tensor(crow, idx[valid].long(),
                                   store.values[valid].to(torch.float32),
                                   size=(idx.shape[0], n),
                                   check_invariants=False)


def exact_small_index(open_index, IndexConfig, QueryServer, ops, vecstore,
                      sinnamon_score, gen, cdf, dev) -> bool:
    """A 2,048-doc index served with k' = capacity reranks every live doc,
    so its answer must be the exact top-k."""
    import torch
    idx, val = draw_sparse(gen, 2048, PSI_DOC, P, cdf, dev)
    qi, qv = draw_sparse(gen, 16, PSI_QUERY, Q_PAD, cdf, dev)
    index = open_index(IndexConfig(n=N, capacity=2048, m=M, h=H, max_nnz=P,
                                   store_dtype="float32"), device=dev)
    index.insert_many(range(2048), idx, val)
    res = QueryServer(index, k=K, kprime=2048).query_many(qi, qv)
    exact = ops.exact_scores_all(index.state.store,
                                 vecstore.densify_query(N, qi, qv))
    want, top = sinnamon_score.topk_desc(exact, K)
    ids = index.state.ids[top.long()].cpu().numpy()
    ok = bool((res.ids == ids).all()) and bool(
        torch.allclose(torch.from_numpy(res.scores), want.cpu(), rtol=1e-5,
                       atol=1e-5))
    if not ok:
        raise AssertionError("small index: answer != exact top-k")
    return ok


# -- 13. the mesh tooling ------------------------------------------------------

#: the dry run's cells on the card's host (13a), each on both meshes
MESH_CELLS = (("equiformer-v2", "ogb_products"),
              ("stablelm-12b", "train_4k"), ("deepseek-67b", "decode_32k"),
              ("moonshot-v1-16b-a3b", "train_4k"), ("dlrm-rm2", "train_batch"),
              ("sinnamon-engine", "serve_msmarco"))
#: 13a cells traced at 1 and 2 layers in two subprocesses side by side (the
#: GNN's layer walks its edge chunks four times, ~76 s a traced layer on
#: one CPU core at ogb_products) and extrapolated here
MESH_DEPTH_SPLIT = ("equiformer-v2",)
CARD_BYTES = 80e9                  # the H100's device memory
MESH_DOCS = 65_536                 # 13c: the index the mesh step searches
MESH_LM_LAYERS = 2                 # 13c: stablelm layers of the decode step
MESH_LM_CACHE = 4_096              # 13c: cache positions of the decode step
PEAK_BF16_NOTE = ("989 TFLOP/s bf16 dense, 67 TFLOP/s f32, 3.35 TB/s HBM, "
                  "50 GB/s a device for collectives (NDR InfiniBand)")

_DRYRUN_CELL = r"""
import json, sys, time
from repro_torch.configs import registry
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import production_shape
arch, shape, mp = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
if len(sys.argv) > 4:                   # one depth: (figures, meta, seconds)
    t0 = time.time()
    mod = registry.get(arch)
    fig, meta, _ = dryrun.trace(mod, mod.SHAPES[shape], *production_shape(mp),
                                n_layers=int(sys.argv[4]))
    res = {"fig": fig, "meta": meta, "t": time.time() - t0}
else:
    res = dryrun.run_cell(arch, shape, multi_pod=mp)
print("JSON" + json.dumps(res))
"""

_DRYRUN_1X1 = r"""
import json
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.distributed import mesh as meshlib
from repro_torch.launch import cells, dryrun

out = {}
for shape in ("serve_p99", "train_batch"):
    with dryrun.fake_world(1):
        mesh = meshlib.make_mesh((1, 1), ("data", "model"), "cpu")
        with FakeTensorMode(allow_non_fake_inputs=True):
            b = cells.build("dlrm-rm2", shape, mesh)
            st = b.args[0]
            leaves = (list(st.params.leaves().values()) + list(
                st.opt.m.values()) + list(st.opt.v.values())
                if shape == "train_batch" else list(st.leaves().values()))
            state = sum(t.numel() * t.element_size() for t in leaves)
            fig = dryrun.measure(b.fn, b.args)
    out[shape] = dict(fig, state_bytes=state)
print("JSON" + json.dumps(out))
"""


def _json_of(stdout: str) -> dict:
    lines = [x for x in stdout.splitlines() if x.startswith("JSON")]
    if not lines:
        raise AssertionError("a dry-run subprocess printed no result")
    return json.loads(lines[-1][4:])


def _depth_result(arch: str, shape: str, mp: bool, parts: list) -> dict:
    """A 13a cell's result from its 1- and 2-layer traces."""
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import production_shape

    mod = registry.get(arch)
    n = mod.full_config(mod.SHAPES[shape]).n_layers
    fig = dryrun.extrapolate(parts[0]["fig"], parts[1]["fig"], n)
    return dryrun.report(arch, shape, production_shape(mp)[0], fig,
                         parts[0]["meta"], dryrun.depth_note(n, ["1", "2"]),
                         max(p["t"] for p in parts))


def mesh_path(seed: int, dev, card: str, recsys_line: dict,
              train_line: dict, cdf, then=None):
    """Phase 13: 13a the dry run of ``MESH_CELLS`` on both production
    meshes (a fake process group of 256 / 512 ranks, one subprocess a cell
    and mesh, run side by side on the host's cores); 13b dlrm-rm2's
    ``serve_p99`` and ``train_batch`` dry-run on a 1x1 mesh against what
    phases 6a and 10a measured; 13c a one-device ``cuda`` mesh on the
    card: the mesh search step, a DLRM forward, a 2-layer stablelm decode
    step and a GNN forward bit-equal to ``mesh=None`` with the same
    launches.  ``then`` (phase 14) runs on the card while 13a's traces
    finish.  Returns (the mesh JSON line, the launch counts of 13c's mesh
    runs, ``then()``'s result)."""
    import torch

    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "src"))

    def spawn(*argv):
        return subprocess.Popen([sys.executable, "-c", _DRYRUN_CELL, *argv],
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    jobs = [((arch, shape, mp), [spawn(arch, shape, "1" if mp else "0", d)
                                 for d in ("1", "2")]
             if arch in MESH_DEPTH_SPLIT else
             [spawn(arch, shape, "1" if mp else "0")])
            for arch, shape in MESH_CELLS for mp in (False, True)]
    one = subprocess.Popen([sys.executable, "-c", _DRYRUN_1X1], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        line13c, counts = mesh_on_card(seed, dev, cdf)
        out, err = one.communicate(timeout=600)
        if one.returncode:
            raise AssertionError(f"13b dry run failed: {err[-2000:]}")
        dry = _json_of(out)
        line13b = mesh_against_card(dry, recsys_line, train_line, card)
        extra = then() if then is not None else None
        results = []
        for (arch, shape, mp), procs in jobs:
            tag = f"{arch}/{shape}/{'2x16x16' if mp else '16x16'}"
            parts = []
            for job in procs:
                out, err = job.communicate(timeout=900)
                if job.returncode:
                    log(f"[13a mesh] [FAIL] {tag}: {err[-1500:]}")
                    raise AssertionError(f"13a: the dry run of {tag} failed")
                parts.append(_json_of(out))
            res = (_depth_result(arch, shape, mp, parts) if len(parts) > 1
                   else parts[0])
            results.append(res)
            log(f"[13a mesh] [OK] {tag}: {res['bytes_per_device']} B a "
                f"device ({res['arg_bytes']} arguments + "
                f"{res['temp_bytes']} temporaries), "
                f"{res['hlo_flops_per_device']:.4g} FLOPs, "
                f"{res['collectives']['count']} collectives "
                f"({res['collectives']['counts']}) of "
                f"{res['collective_bytes_per_device']} B; t = "
                f"{res['t_compute']:.4g} / {res['t_memory']:.4g} / "
                f"{res['t_collective']:.4g} s, {res['bottleneck']}-bound; "
                f"traced in {res['trace_s']} s"
                + (f" (depth extrapolated from {res['depth']['traced']})"
                   if (res.get('depth') or {}).get('extrapolated') else ""))
    finally:
        for _, procs in jobs:
            for job in procs:
                if job.poll() is None:
                    job.kill()
        if one.poll() is None:
            one.kill()
    over = [f"{r['arch']}/{r['shape']}/{r['mesh']}" for r in results
            if r["bytes_per_device"] > CARD_BYTES]
    log(f"[13a mesh] H100 constants: {PEAK_BF16_NOTE}; cells above the "
        f"card's {CARD_BYTES / 1e9:.0f} GB a device: {over or 'none'} "
        f"({card})")
    if any(o.startswith("equiformer-v2/") for o in over):
        raise AssertionError(f"13a: the sharded GNN needs more than "
                             f"{CARD_BYTES / 1e9:.0f} GB a device: {over}")
    line = {"card": card, "dryrun": results, "over_80GB": over,
            "vs_card": line13b, "one_device": line13c,
            "wall_s": time.perf_counter() - t_phase}
    log(f"[13 mesh] phase {line['wall_s']:.1f}s (phase 14 inside it)")
    return line, counts, extra



def mesh_against_card(dry: dict, recsys_line: dict, train_line: dict,
                      card: str) -> dict:
    """13b: the 1x1 dry run's figures against phases 6a and 10a."""
    from repro_torch.configs import dlrm_rm2
    from repro_torch.launch import dryrun

    cfg = dlrm_rm2.full_config()
    p99, tr = recsys_line["serve_p99"], train_line["dlrm"]
    card_nums = {
        "serve_p99": {"state_bytes": recsys_line["table_bytes"]
                      + recsys_line["mlp_bytes"],
                      "peak_bytes": p99["forward_alloc_bytes"],
                      "flops": dlrm_flops(cfg, p99["batch"]),
                      "ms": p99["forward_ms"]},
        "train_batch": {"state_bytes": tr["state_bytes"],
                        "peak_bytes": tr["peak_bytes"],
                        "flops": 3 * dlrm_flops(cfg, tr["batch"]),
                        "ms": tr["step_p50_ms"]}}
    out = {}
    for shape, c in card_nums.items():
        d = dry[shape]
        if d["state_bytes"] != c["state_bytes"]:
            raise AssertionError(f"13b {shape}: dry-run state bytes "
                                 f"{d['state_bytes']} != the card's "
                                 f"{c['state_bytes']}")
        # serving: the forward's allocations above what is resident; the
        # train step: its whole peak (state, batch and temporaries)
        pred_peak = d["temp_bytes"] if shape == "serve_p99" else \
            d["arg_bytes"] + d["temp_bytes"]
        # f32 FLOPs at the f32 peak (dlrm-rm2 runs in f32, TF32 off)
        t_roof = max(dryrun.compute_time(d), d["bytes"] / dryrun.HBM_BW)
        r = {"state_bytes": d["state_bytes"], "card_state_bytes":
             c["state_bytes"], "peak_pred": pred_peak,
             "peak_card": c["peak_bytes"],
             "peak_ratio": pred_peak / c["peak_bytes"],
             "flops_pred": d["flops"], "flops_model": c["flops"],
             "flops_ratio": d["flops"] / c["flops"],
             "roofline_ms": t_roof * 1e3, "card_ms": c["ms"],
             "time_ratio": t_roof * 1e3 / c["ms"],
             "bytes_moved_pred": d["bytes"]}
        out[shape] = r
        log(f"[13b mesh] dlrm-rm2/{shape} on a 1x1 mesh: state "
            f"{r['state_bytes']} B == the card's; peak predicted "
            f"{pred_peak} B vs the card's {c['peak_bytes']} B (x"
            f"{r['peak_ratio']:.3f}); FLOPs {d['flops']} vs the model's "
            f"{c['flops']} (x{r['flops_ratio']:.3f}); roofline "
            f"{r['roofline_ms']:.4f} ms vs {c['ms']:.4f} ms measured (x"
            f"{r['time_ratio']:.3f}) ({card})")
    return out


def mesh_on_card(seed: int, dev, cdf):
    """13c: a one-device ``cuda`` mesh (a process group of one rank over
    ``tcp://localhost``); each path with ``mesh`` must give ``mesh=None``'s
    answer bit for bit and launch the same kernels.  Returns (the line,
    the launch counts of the mesh runs)."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    import repro_torch.kernels as kernels
    from repro_torch.api import IndexConfig, open_index
    from repro_torch.configs import common
    from repro_torch.configs import dlrm_rm2, equiformer_v2, stablelm_12b
    from repro_torch.data import graph as graphdata
    from repro_torch.data import loaders
    from repro_torch.distributed import mesh as meshlib
    from repro_torch.models import gnn, recsys
    from repro_torch.models import transformer as tr
    from repro_torch.serving import sharded

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    line, mesh_counts = {}, {}

    def twice(name, plain, meshed, same):
        kernels.reset_launch_counts()
        a = plain()
        torch.cuda.synchronize()
        c0 = kernels.launch_counts()
        kernels.reset_launch_counts()
        b = meshed()
        torch.cuda.synchronize()
        c1 = kernels.launch_counts()
        if c0 != c1:
            raise AssertionError(f"13c {name}: launches {c1} with the mesh, "
                                 f"{c0} without")
        if not same(a, b):
            raise AssertionError(f"13c {name}: the 1x1 mesh's answer != "
                                 "mesh=None's")
        for k, n in c1.items():
            mesh_counts[k] = mesh_counts.get(k, 0) + n
        line[name] = {"bit_equal": True, "launches": c1}
        log(f"[13c mesh] {name}: bit-equal to mesh=None, launches {c1}")

    eq = lambda x, y: torch.equal(x, y)                      # noqa: E731
    try:
        mesh = meshlib.single_device_mesh(("data", "model"), "cuda")
        gen = torch.Generator(device=dev).manual_seed(seed)
        # the fused search through the mesh step vs the index's own
        idx, val = draw_sparse(gen, MESH_DOCS, PSI_DOC, P, cdf, dev)
        qi, qv = draw_sparse(gen, 16, PSI_QUERY, Q_PAD, cdf, dev)
        index = open_index(IndexConfig(n=N, capacity=MESH_DOCS, m=M, h=H,
                                       max_nnz=P), device=dev)
        index.insert_many(range(MESH_DOCS), idx, val)
        step = sharded.make_search_step(mesh, index.spec, k=K,
                                        kprime_local=KPRIME)
        twice("search B=16",
              lambda: index.search_many(qi, qv, K, kprime=KPRIME),
              lambda: step(index.state, qi, qv),
              lambda a, b: (np.array_equal(a[0], b[1].cpu().numpy())
                            and np.array_equal(
                                np.asarray(a[1]).view(np.int32),
                                b[0].cpu().numpy().view(np.int32))))
        del index, idx, val
        # DLRM at full width, B=512
        cfg = dlrm_rm2.full_config()
        model = recsys.DLRM(cfg, generator=gen, device=dev)
        hb = loaders.recsys_batch(seed, 0, 512, cfg, device="cpu")
        b = hb._replace(dense=hb.dense.to(dev), sparse=hb.sparse.to(dev))
        twice("dlrm forward B=512", lambda: recsys.score(model, b, cfg),
              lambda: recsys.score(model, b, cfg, mesh=mesh), eq)
        del model, b
        torch.cuda.empty_cache()
        # stablelm-12b at full width, 2 layers: one decode step
        lcfg = dataclasses.replace(stablelm_12b.full_config(),
                                   n_layers=MESH_LM_LAYERS)
        lm = tr.init_params(gen, lcfg, dtype=torch.bfloat16, device=dev)
        tok = torch.randint(0, lcfg.vocab, (1, 1), generator=gen, device=dev)
        caches = [tr.init_cache(lcfg, 1, MESH_LM_CACHE, device=dev)
                  for _ in range(2)]
        twice("stablelm decode step (2 layers)",
              lambda: tr.decode_step(lm, caches[0], tok, 100, lcfg)[0],
              lambda: tr.decode_step(lm, caches[1], tok, 100, lcfg,
                                     mesh=mesh)[0],
              lambda a, b: eq(a, b) and eq(caches[0]["k"], caches[1]["k"]))
        del lm, caches
        torch.cuda.empty_cache()
        # the GNN's full_graph_sm forward at full width and depth
        sm = common.GNN_SHAPES["full_graph_sm"]
        hg = graphdata.random_geometric_graph(
            seed, sm["n_nodes"], sm["n_edges"], sm["d_feat"],
            sm["n_classes"], sm["pad_nodes"], sm["pad_edges"])
        g = graphdata.to_device(hg, dev)
        gcfg = equiformer_v2.full_config(sm)
        net = gnn.init_params(gen, gcfg, device=dev)
        # index_add_'s atomics make no two plain forwards bit-equal;
        # its deterministic form (sorted) makes the comparison exact
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with torch.no_grad():
                twice("gnn full_graph_sm forward (deterministic index_add_)",
                      lambda: gnn.forward(net, g, gcfg),
                      lambda: gnn.forward(net, g, gcfg, mesh=mesh), eq)
        finally:
            torch.use_deterministic_algorithms(False)
        del net, g
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    for k in kernels.launch_counts():
        mesh_counts.setdefault(k, 0)
    return line, mesh_counts



# -- 14. the sharded GNN and compressed gradients on a one-rank mesh -----------

GNN_MESH_TIMED = 2                 # 14: timed train steps a path, after one
GNN_MESH_STEPS = 3                 # 14b: compressed train steps
#: 14a: the loss and every gradient leaf of ``loss_fn_sharded`` against
#: ``gnn.loss_fn`` on the same weights and graph, max |difference| within
#: 1e-4 of ``gnn.loss_fn``'s largest |value| (GNN_ORDER_TOL's reason: the
#: sharded pass 2 sums exp(logit - M) against the final maximum where the
#: one-device loop rescales a running sum, and ``index_add_`` sums with
#: atomics on the card; the same comparison on the CPU at full width, 12
#: layers, reads at most 1.8e-6).  A dropped collective or a wrong
#: gradient transpose moves values by O(1); the reference's head faults
#: move the loss by less (2e-4–4e-4 at the CPU tests' width, where
#: ``tests/test_torch_gnn_sharded.py`` pins them).
GNN_MESH_TOL = 1e-4


def gnn_mesh_path(seed: int, dev, card: str):
    """Phase 14: ``models/gnn_sharded.py`` and compressed gradients on a
    one-rank ``cuda`` mesh (gloo over ``tcp://localhost``, world 1; an axis
    of one device issues no collective).  14a: equiformer-v2 at full width
    and depth on ``full_graph_sm`` and ``molecule`` through
    ``loss_fn_sharded`` against ``gnn.loss_fn`` on the same inputs (loss
    and every gradient within GNN_MESH_TOL), a train step of each path
    timed side by side, the sharded step's peak memory.  14b:
    ``make_train_step(compress_axis="pod")`` for GNN_MESH_STEPS
    ``full_graph_sm`` steps against the same steps quantised on the host
    from the same gradients.  Returns (the gnn_mesh JSON line, the launch
    counts over the phase)."""
    import socket

    import torch
    import torch.distributed as dist

    import repro_torch.kernels as kernels
    from repro_torch.configs import common
    from repro_torch.configs import equiformer_v2 as eq
    from repro_torch.data import graph as graphdata
    from repro_torch.distributed import mesh as meshlib

    t_phase = time.perf_counter()
    line = {"card": card}
    kernels.reset_launch_counts()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = meshlib.single_device_mesh(("data", "model"), "cuda")
        sm = common.GNN_SHAPES["full_graph_sm"]
        hg_sm = graphdata.random_geometric_graph(
            seed, sm["n_nodes"], sm["n_edges"], sm["d_feat"],
            sm["n_classes"], sm["pad_nodes"], sm["pad_edges"])
        line["full_graph_sm"] = gnn_mesh_check(
            eq.full_config(sm), hg_sm, seed, dev, mesh, card, "14a")
        mol = common.GNN_SHAPES["molecule"]
        hg = graphdata.molecule_batch(seed, mol["batch_graphs"],
                                      mol["nodes_per"], mol["edges_per"],
                                      mol["d_feat"])
        line["molecule"] = gnn_mesh_check(eq.full_config(mol), hg, seed, dev,
                                          mesh, card, "14a")
        pod = meshlib.single_device_mesh(("pod",), "cuda")
        line["compressed"] = gnn_compressed_steps(
            eq.full_config(sm), hg_sm, seed, dev, pod, card)
    finally:
        dist.destroy_process_group()
    counts = kernels.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"the sharded GNN path launched a kernel: "
                             f"{counts}")
    line["wall_s"] = time.perf_counter() - t_phase
    log(f"[14 gnn mesh] phase {line['wall_s']:.1f}s; kernels A-D' launched "
        f"{counts} ({card})")
    return line, counts


def _timed_steps(step, state, g, n: int):
    """(the state after ``n`` steps, each step's host-clock ms)."""
    import torch
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, g)
        float(m["loss"])
        walls.append((time.perf_counter() - t0) * 1e3)
    return state, walls


def gnn_mesh_check(cfg, hg, seed: int, dev, mesh, card: str,
                   tag: str) -> dict:
    """14a on one graph: ``loss_fn_sharded`` and ``gnn.loss_fn`` of one
    model drawn on the card from ``seed``; then a train step of each path
    (one warm-up, GNN_MESH_TIMED timed, alternating), the sharded path's
    peak memory."""
    import numpy as np
    import torch

    from repro_torch.data import graph as graphdata
    from repro_torch.models import gnn
    from repro_torch.models import gnn_sharded as gs
    from repro_torch.optim import adamw
    from repro_torch.train import loop

    g = graphdata.to_device(hg, dev)
    model = gnn.init_params(torch.Generator(device=dev).manual_seed(seed),
                            cfg, device=dev)
    lp, _ = gnn.loss_fn(model, g, cfg)
    lp.backward()
    want = {k: t.clone() for k, t in model.leaves(grad=True).items()}
    for p in model.parameters():
        p.grad = None
    _new_peak()
    ls, _ = gs.loss_fn_sharded(model, g, cfg, mesh)
    ls.backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    got = model.leaves(grad=True)
    errs = {"loss": _rel_err(ls, lp)}
    errs.update({k: _rel_err(got[k], want[k]) for k in want})
    worst = max(errs, key=errs.get)
    for p in model.parameters():
        p.grad = None
    del want, got
    if not (torch.isfinite(ls) and errs[worst] <= GNN_MESH_TOL):
        raise AssertionError(f"{tag} {cfg.task}: loss_fn_sharded vs "
                             f"gnn.loss_fn: {worst} off by {errs[worst]:.3g} "
                             f"of its scale (> {GNN_MESH_TOL})")
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=10, decay_steps=20)
    paths = {"sharded": lambda p, b: gs.loss_fn_sharded(p, b, cfg, mesh),
             "one_device": lambda p, b: gnn.loss_fn(p, b, cfg)}
    walls = {k: [] for k in paths}
    for rnd in range(GNN_MESH_TIMED + 1):
        for k, fn in paths.items():
            state = loop.init_state(model)
            _, w = _timed_steps(loop.make_train_step(fn, opt_cfg), state, g,
                                1)
            if rnd:
                walls[k] += w
    p50 = {k: float(np.percentile(v, 50)) for k, v in walls.items()}
    n_real = int((hg.labels >= 0).sum()) if cfg.task == "node_class" \
        else hg.node_feat.shape[0]
    log(f"[{tag} gnn mesh] {cfg.name} {cfg.task}, {cfg.n_layers} layers, "
        f"c={cfg.c}, l_max={cfg.l_max}, H={cfg.n_heads}, N="
        f"{hg.node_feat.shape[0]}, E={hg.edge_src.shape[0]} on a 1x1 cuda "
        f"mesh: loss_fn_sharded {float(ls):.6f} vs gnn.loss_fn "
        f"{float(lp):.6f}; worst of the loss and {len(errs) - 1} gradient "
        f"leaves {worst} at {errs[worst]:.3g} of its scale (tolerance "
        f"{GNN_MESH_TOL}); train step p50 sharded {p50['sharded']:.1f} ms, "
        f"one-device {p50['one_device']:.1f} ms (walls {walls}); sharded "
        f"loss + backward peak {peak / 1e9:.2f} GB ({card})")
    if peak >= PEAK_MEMORY_MAX:
        raise AssertionError(f"{tag}: peak device memory {peak / 1e9:.2f} GB")
    out = {"loss_sharded": float(ls), "loss_one_device": float(lp),
           "rel_errs": errs, "worst": [worst, errs[worst]],
           "tol": GNN_MESH_TOL, "walls_ms": walls, "step_ms_p50": p50,
           "nodes_per_s_sharded": n_real / p50["sharded"] * 1e3,
           "peak_bytes": peak}
    del model, g
    gc.collect()
    torch.cuda.empty_cache()
    return out


def gnn_compressed_steps(cfg, hg, seed: int, dev, pod, card: str) -> dict:
    """14b: GNN_MESH_STEPS steps of ``make_train_step(compress_axis="pod",
    mesh=pod)`` on ``full_graph_sm``, every ``compressed_psum`` call's
    gradients copied to the host on the way; the same steps on the host
    (the quantisation in numpy f32, the update by ``adamw.update`` on CPU
    tensors) from those gradients: the residual bit-equal, the
    parameters within 1e-6 of their scale."""
    import numpy as np
    import torch

    from repro_torch.data import graph as graphdata
    from repro_torch.models import gnn
    from repro_torch.optim import adamw, compress
    from repro_torch.train import loop

    g = graphdata.to_device(hg, dev)
    model = gnn.init_params(torch.Generator(device=dev).manual_seed(seed),
                            cfg, device=dev)
    host = {k: t.detach().cpu().clone() for k, t in model.leaves().items()}
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0)
    seen = []
    orig = compress.compressed_psum

    def recorded(grads, residual, axis, mesh):
        seen.append({k: t.detach().cpu().numpy().copy()
                     for k, t in grads.items()})
        return orig(grads, residual, axis, mesh)

    step = loop.make_train_step(lambda p, b: gnn.loss_fn(p, b, cfg),
                                opt_cfg, compress_axis="pod", mesh=pod)
    state = loop.init_state(model, use_compression=True)
    compress.compressed_psum = recorded
    try:
        state, walls = _timed_steps(step, state, g, GNN_MESH_STEPS)
    finally:
        compress.compressed_psum = orig
    h_opt = adamw.init(host)
    h_res = {k: np.zeros(t.shape, np.float32) for k, t in host.items()}
    for grads in seen:
        mean = {}
        for k, gr in grads.items():
            x = gr.astype(np.float32) + h_res[k]
            scale = np.maximum(np.float32(np.abs(x).max()) / np.float32(127),
                               np.float32(1e-12))
            q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
            h_res[k] = x - q.astype(np.float32) * scale
            mean[k] = torch.from_numpy(q.astype(np.float32) * scale)
        _, h_opt, _ = adamw.update(mean, h_opt, host, opt_cfg)
    res_equal = all(np.array_equal(
        state.ef_residual[k].cpu().numpy().view(np.int32),
        h_res[k].view(np.int32)) for k in h_res)
    leaves = model.leaves()
    p_err = max(_rel_err(leaves[k].cpu(), host[k]) for k in host)
    p_equal = all(torch.equal(leaves[k].cpu(), host[k]) for k in host)
    log(f"[14b gnn mesh] make_train_step(compress_axis='pod') on a one-rank "
        f"cuda mesh, {cfg.name} full_graph_sm: {len(seen)} steps, walls "
        f"{[round(w, 1) for w in walls]} ms; residual bit-equal to the "
        f"host's quantisation of the same gradients: {res_equal}; "
        f"parameters against the host's AdamW: max {p_err:.3g} of scale, "
        f"bit-equal {p_equal} ({card})")
    if len(seen) != GNN_MESH_STEPS or not res_equal or p_err > 1e-6:
        raise AssertionError("14b: the compressed steps differ from the "
                             "host's")
    out = {"steps": len(seen), "walls_ms": walls,
           "residual_bit_equal": res_equal, "params_rel_err": p_err,
           "params_bit_equal": p_equal}
    del model, state, g
    gc.collect()
    torch.cuda.empty_cache()
    return out

if __name__ == "__main__":
    sys.exit(main())
