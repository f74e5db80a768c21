#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py [--seed 0] [--docs 1114112]

Drives the port's main path on one CUDA card at the size of one 8-way
shard of the paper's MS MARCO deployment (``serve_msmarco``: n=30,000,
m=64, h=1, max_nnz=128, k=10; 8,912,896 docs / 8 = 1,114,112 slots):

1. device   — the card's name, count and power limit;
2. build    — both CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
              nvcc per source, started together), with ptxas's registers
              and shared memory;
3. kernels  — each kernel against its plain twin on the card, at the main
              path's shapes: kernel A + merge bit-equal to the twin + merge
              (bf16 and f8 cells); kernel B's rerank and LinScan within
              rtol = atol = 1e-5 (the sum order differs);
4. main     — ``open_index`` + ``insert_many`` of the shard,
              ``delete_many`` of 1/16 of it and re-insert into the dirty
              slots, serve batches of 16 and 256 through
              ``QueryServer.query_many`` (k=10, k'=800), one staged batch;
              kernel-path ids == plain-twin ids; recall@10 against kernel
              B's exact LinScan, at least ``RECALL_MIN``; a small index
              whose answer must equal the exact top-10;
5. times    — CUDA-event times of each kernel and its twin, the library
              yardstick for the LinScan (one torch.sparse CSR mat-vec),
              request latency p50/p99 (the wall time of each ``query_many``
              batch: every request of a batch waits for all of it) and
              throughput in queries/s, peak device memory.

Ends with a JSON line of per-kernel numbers, the card's ``nvidia-smi`` line
and ``{"ok": true, "device": {...}}``.  Any failed phase raises, so the
script exits non-zero and prints no result; so does a machine without CUDA
or a directory without the package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM (NVIDIA data sheet)
F32_OPS_PER_S = 67e12              # f32 outside the tensor cores

N, M, H, P, K, KPRIME = 30_000, 64, 1, 128, 10, 800
SHARD_DOCS = 8_912_896 // 8
PSI_DOC, PSI_QUERY, Q_PAD = 119, 43, 64     # splade_like (synth.py:44)
RECALL_MIN = 0.95                           # recall@10 limit of PERF.md §2


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

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to measure",
              file=sys.stderr)
        return 2

    import repro_torch.kernels as kernels
    from repro_torch.api import IndexConfig, open_index
    from repro_torch.core import engine as eng
    from repro_torch.kernels import _build, csr_score, ops, sinnamon_score
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
        for line in b.ptxas_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[2 build] {b.name}: {line.strip()}")
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
    del bits, sk, opnds

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
    del idx, val, got, want
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
        lat[bsz] = request_latency(walls, bsz)
    counts = kernels.launch_counts()
    log(f"[4 main] served batches of 16 and 256 (k={K}, k'={KPRIME}); "
        f"launches {counts}")
    for kname, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {kname} was not launched on the "
                                 f"main path")

    staged = QueryServer(index, k=K, kprime=KPRIME, trace_every=1)
    lo, res16 = answers[16]
    sres = staged.query_many(q_idx[lo:lo + 16], q_val[lo:lo + 16])
    if not (sres.ids == res16.ids).all():
        raise AssertionError("staged ids != fused ids")
    log("[4 main] staged batch (B=16) spans: " + ", ".join(
        f"{n} {ms:.3f} ms" for n, ms in staged.last_trace.spans))

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
    q_dense = vecstore.densify_query(N, qi256, qv256)
    exact = ops.exact_scores_all(index.state.store, q_dense)
    exact = torch.where(index.state.active[None, :], exact, -torch.inf)
    _, top = sinnamon_score.topk_desc(exact, K)
    truth = index.state.ids[top.long()].cpu().numpy()
    recall = sum(len(set(a.tolist()) & set(b.tolist()))
                 for a, b in zip(res256.ids, truth)) / (256 * K)
    del exact
    log(f"[4 main] recall@{K}={recall:.4f} over 256 queries against the "
        f"exact LinScan (csr_score)")
    if recall < RECALL_MIN:
        raise AssertionError(f"recall@{K}={recall:.4f} < {RECALL_MIN}")

    small_ok = exact_small_index(open_index, IndexConfig, QueryServer,
                                 ops, vecstore, sinnamon_score, gen, cdf, dev)
    log(f"[4 main] small index (2,048 docs, k'=capacity) answers equal the "
        f"exact top-{K}: {small_ok}")

    # -- 5. times ---------------------------------------------------------------
    st, spec = index.state, index.spec
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

    q1 = q_dense[:1].contiguous()
    s_ms = cuda_ms(lambda: csr_score.csr_score(q1, st.store.indices,
                                               st.store.values), reps=5)
    s_plain_ms = cuda_ms(lambda: csr_score.csr_score_plain(
        q1, st.store.indices, st.store.values), reps=2)
    s_bytes, s_ops = kernel_b_work(st.store, None, q1)
    s_bound = max(s_bytes / HBM_BYTES_PER_S, s_ops / F32_OPS_PER_S) * 1e3
    csr = library_csr(st.store, N)
    qcol = q1[0][:, None].contiguous()
    s_lib_ms = cuda_ms(lambda: csr @ qcol, reps=5)
    lib_err = finite_max_err((csr @ qcol)[:, 0],
                             csr_score.csr_score(q1, st.store.indices,
                                                 st.store.values)[0])
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    log(f"[5 times] on {card}:")
    log(f"[5 times]   sinnamon_score_topk B=256 L={qv_op.shape[1]}: "
        f"{a_ms:.3f} ms (twin {a_plain_ms:.3f} ms, bound {a_bound:.3f} ms, "
        f"per-query bitmap form {a_bound_pq:.3f} ms); "
        f"with no coordinates (selection only) {a_sel_ms:.3f} ms; B=16 "
        f"{a16_ms:.3f} ms; merge {merge_ms:.3f} ms")
    log(f"[5 times]   csr_score rerank B=256 k'={KPRIME}: {b_ms:.4f} ms (twin "
        f"{b_plain_ms:.3f} ms, bound {b_bound:.4f} ms, every gathered row "
        f"{b_bound_pq:.4f} ms)")
    log(f"[5 times]   csr_score LinScan B=1 C={C}: {s_ms:.4f} ms (twin "
        f"{s_plain_ms:.3f} ms, torch.sparse CSR mv {s_lib_ms:.4f} ms, "
        f"bound {s_bound:.4f} ms; library max abs diff {lib_err:.3g})")
    for bsz, p in lat.items():
        log(f"[5 times]   serving B={bsz}: request latency (batch wall "
            f"time) p50 {p['p50']:.4f} ms, p99 {p['p99']:.4f} ms over "
            f"{p['batches']} batches; throughput {p['qps']:.1f} queries/s")
    log(f"[5 times]   peak device memory {peak_gb:.2f} GiB; whole run "
        f"{time.perf_counter() - t_start:.1f}s")

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
         "bound_ms_per_query_bitmap": a_bound_pq,
         "ms_b16": a16_ms},
        {"name": "csr_score", "route": "cuda",
         "source": f"{src}/csr_score.cu",
         "replaces": "src/repro/kernels/csr_score.py:50",
         "launches": counts["csr_score"], "max_abs_err": b_err,
         "ms": b_ms, "plain_ms": b_plain_ms, "bound_ms": b_bound,
         "bound_by": "bytes" if b_bytes / HBM_BYTES_PER_S
         >= b_ops / F32_OPS_PER_S else "operations",
         "library_ms": None, "shape": f"rerank B=256 k'={KPRIME} P={P}",
         "bound_ms_every_gathered_row": b_bound_pq,
         "linscan_ms": s_ms, "linscan_plain_ms": s_plain_ms,
         "linscan_bound_ms": s_bound, "linscan_library_ms": s_lib_ms},
    ]
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


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


def kernel_a_work(state, qv, rows, brows, C, kp):
    """Bytes and f32 operations kernel A needs for this batch: each sketch
    row and bitmap row the batch references read once, the per-slot gate,
    the outputs written once; one multiply-add per (coordinate, member
    slot) pair of this run's posting lists."""
    import torch
    valid = brows >= 0
    cell = state.sketch.element_size()
    sk_rows = torch.unique(rows[valid]).numel()
    bit_rows = torch.unique(brows[valid]).numel()
    B, T = qv.shape[0], -(-C // 8192)
    nbytes = (sk_rows * C * cell + bit_rows * C // 8 + C
              + B * T * kp * 8 + qv.numel() * 12)
    df = doc_freq(state)
    b_idx = brows.clamp_min(0).long()
    pairs = int(torch.where(valid, df[b_idx], 0).sum())
    return nbytes, 2 * pairs


def doc_freq(state):
    """Set bits per bitmap row (posting-list lengths) from the store."""
    import torch
    idx = state.store.indices
    live = idx[(idx >= 0) & state.active[:, None]].long()
    return torch.bincount(live, minlength=state.bits.shape[0])


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
