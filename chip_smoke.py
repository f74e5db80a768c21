#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py [--seed 0] [--docs 1114112]

Drives the port's main path on one CUDA card at the size of one 8-way
shard of the paper's MS MARCO deployment (``serve_msmarco``: n=30,000,
m=64, h=1, max_nnz=128, k=10; 8,912,896 docs / 8 = 1,114,112 slots):

1. device   — the card's name, count and power limit;
2. build    — the five CUDA kernels from ``src/repro_torch/kernels/csrc``
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
              over 16 x C keys and B's rerank;
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
              Peak device memory stays < 40 GB.

Launch counts are read per path: kernel A and B's rerank kernel
(``csr_rerank_topk``) must launch on the fused path, C and the rerank
kernel on the dense path (and A not at all there), D on neither, and
``csr_score`` on none of them (it launches for the recall ground truth); D
alone on the recsys path; A and the rerank kernel on the recsys
retrieval; A and the rerank kernel (``launches_durable``) on the recovered
durable index.  Ends with a JSON line of the recsys numbers, one of the
durability numbers, a JSON line of per-kernel numbers, the card's ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.  Any failed phase raises, so the script
exits non-zero and prints no result; so does a machine without CUDA or a
directory without the package.
"""

from __future__ import annotations

import argparse
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
    """Device busy share of a profiled window and its largest kernels."""
    busy = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall, "device_ms": busy if by_name else None,
            "busy_share": busy / wall if by_name else None,
            "top_kernels_ms": {k[:80]: v for k, v in ranked}}


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
                        ("sinnamon_score_topk", "csr_rerank_topk"),
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
                        ("sinnamon_score_topk", "embed_bag", "csr_score"))

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

    # -- 4c. the evaluation path (after the served index is freed) -------------
    del index, server, staged, dense, res_f, cv, cs, rv, rs
    gc.collect()
    torch.cuda.empty_cache()
    eval_path(corpus_idx, corpus_val, q_idx[:256], q_val[:256], args.seed,
              dev)

    # -- 4d. durability: log, snapshot, recover the shard ----------------------
    gc.collect()
    torch.cuda.empty_cache()
    durable_counts, durable_line = durable_path(
        corpus_idx, corpus_val, q_idx[:256], q_val[:256], args.seed, dev)

    # -- 6a / 6b. DLRM-rm2 serving and its users' retrieval --------------------
    del corpus_idx, corpus_val, q_idx, q_val
    gc.collect()
    torch.cuda.empty_cache()
    d_row, recsys_line = recsys_path(args.seed, dev, card)
    kernel_rows.append(d_row)
    for row in kernel_rows:
        row["launches_durable"] = durable_counts[row["name"]]

    peak = max(torch.cuda.max_memory_allocated(), _PEAK_BEFORE_RESET[0])
    log(f"[end] peak device memory {peak / 2**30:.2f} GiB; whole run "
        f"{time.perf_counter() - t_start:.1f}s")
    if peak >= PEAK_MEMORY_MAX:
        raise AssertionError(f"peak device memory {peak / 1e9:.2f} GB >= "
                             f"{PEAK_MEMORY_MAX / 1e9:.0f} GB")
    print(json.dumps({"recsys": recsys_line}), flush=True)
    print(json.dumps({"durable": durable_line}), flush=True)
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
         "ms_b16": a16_ms},
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
                        ("sinnamon_score_topk", "csr_score",
                         "sinnamon_score", "csr_rerank_topk"))

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
        if name == "serve_bulk":
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


if __name__ == "__main__":
    sys.exit(main())
