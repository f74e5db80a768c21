// Exact rerank with top-k selection for Hopper (sm_90a): Algorithm 7's back
// half in one launch.
//
// Replaces the rerank form of the Pallas TPU kernel `csr_score` of
// src/repro/kernels/csr_score.py (body `_kernel`, called with the gathered
// candidate rows) together with the XLA work the reference's
// `rerank_topk` (src/repro/core/engine.py) does around it: the sparse
// query's duplicate coordinates combined, each candidate row matched
// against it, candidates gated to -inf, `lax.top_k`, the slot and id
// gathers.  For query b and candidate position i < K':
//
//   score = -inf                          if cand_scores[b, i] is -inf
//           sum_p q[idx[s, p]] * val[s, p] otherwise (s = cand_slots[b, i];
//                                          pad index -1 and coordinates
//                                          absent from the query count 0)
//
// and the k smallest keys (score desc, i asc) -- the twin's order key --
// give out_scores[b], out_slots[b] = cand_slots[b, i], out_ids[b] =
// ids[out_slots[b]].
//
// What bounds it on an H100: bytes.  Each scored row is P * (4 + value
// bytes) read once (768 B at P = 128, bf16), one multiply-add per entry;
// the sparse queries, candidates and outputs are small.  The design:
// * no dense query: each block stages its query's coordinates in shared
//   memory as an open-addressed hash of (coordinate, value) pairs,
//   duplicates added in query order by one warp: 64 Lq power-of-two
//   entries up to 8,192 (at least 4 Lq), so a row entry nearly always
//   costs one probe (a second probe in a lane stalls its warp), and a block
//   needs about 35 KB at Lq = 64, not the 120 KB of a dense f32[30,000]
//   query;
// * the block's candidate slots (with the gate folded in as slot -1) are
//   read into shared memory by one coalesced pass before any row;
// * a group of G lanes scores one row (G = 32 at P = 128; 4 at P = 16), with
//   16-byte loads of indices and 16- or 8-byte loads of values where P % 4
//   == 0 and the rows are aligned, and every group keeps two rows' loads in
//   flight before it adds; lane partials meet in an xor-shuffle tree
//   (`__fmul_rn`/`__fadd_rn`), so the sum order differs from the twin's and
//   the two agree to f32 rounding (bit for bit when every sum is exact);
// * selection without block-wide sorts: each warp sorts its slice of the
//   block's order keys in registers (a bitonic network over shuffles, no
//   barrier) and keeps its first min(k, .); a key's place in the block is
//   its place in its warp's list plus, by binary search, the keys below it
//   in the other warps' lists (a block-wide bitonic sort of 1,024 keys was
//   half the kernel's time);
// * enough blocks at small B: each query's K' positions are split over a
//   thread-block cluster of S <= 8 blocks (the wrapper picks S so that the
//   grid covers the SMs).  Each block selects its positions' top keys as
//   above; after `cluster.sync()` rank 0 reads the S lists' first
//   min(k, .) keys through distributed shared memory, ranks them the same
//   way, and writes scores, slots and ids.
//
// Caps (the wrapper checks them and raises): Lq <= 2,048 query
// coordinates, K' <= 32,768 candidates (at most 4,096 a block).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sketch_cells.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 2;                // rows a lane group loads at once
constexpr int kMaxCluster = 8;          // portable cluster size
constexpr int kMaxQuery = 2048;         // query coordinates (Lq)
constexpr int kMaxTable = 8192;         // hash entries at 64 Lq
constexpr int kMaxBlockPositions = 4096;
constexpr int kMaxLocalMerge = 2048;    // S * k keys rank 0 copies locally
constexpr uint32_t kHashMul = 0x9E3779B1u;
constexpr int kMaxDevices = 64;         // devices whose attribute is cached

typedef unsigned long long u64;

// Order word of a score: ascending u is descending score.  Equal to the
// twin's order key's high word with its sign bit flipped (as kernel A's).
__device__ __forceinline__ uint32_t order_word(float score) {
  const uint32_t b = __float_as_uint(score);
  const uint32_t asc = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ~asc;
}

__device__ __forceinline__ float order_score(uint32_t u) {
  const uint32_t asc = ~u;
  return __uint_as_float((asc & 0x80000000u) ? (asc & 0x7FFFFFFFu) : ~asc);
}

__host__ __device__ inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

__host__ __device__ inline int log2_pow2(int x) {
  int b = 0;
  while ((1 << b) < x) ++b;
  return b;
}

// Shared-memory layout of one block, in bytes; the launcher sizes the
// launch by it and `csr_rerank_smem` reports it.
struct Layout {
  int table, top, merge, chunk;
  size_t keys, tops, merged, hash, query, slots, total;
  __host__ __device__ Layout(int Lq, int Kp, int k, int S) {
    chunk = (Kp + S - 1) / S;
    table = next_pow2(64 * Lq);
    if (table > kMaxTable) table = kMaxTable;
    if (table < next_pow2(4 * Lq)) table = next_pow2(4 * Lq);
    if (table < 32) table = 32;
    top = S > 1 ? (k < chunk ? k : chunk) : 0;
    merge = (S > 1 && S * k <= kMaxLocalMerge) ? S * k : 0;
    keys = 0;
    tops = keys + sizeof(u64) * chunk;
    merged = tops + sizeof(u64) * top;
    hash = merged + sizeof(u64) * merge;
    query = hash + (sizeof(int) + sizeof(float)) * table;
    slots = query + sizeof(int2) * Lq;
    total = slots + sizeof(int) * chunk;
  }
};

// The query's hash: coordinates and their values in separate arrays, so
// a probe is one 4-byte load (fewer bank conflicts than 8-byte entries)
// and only a match reads its value.
struct Hash {
  int* keys;
  float* vals;
  int bits;
  __device__ __forceinline__ uint32_t home(int j) const {
    return (static_cast<uint32_t>(j) * kHashMul) >> (32 - bits);
  }
  // The query's value at coordinate j (0 if absent).  An empty entry's key
  // is -1, so a pad (j = -1) matches one and reads its 0.  The table is at
  // most a quarter full, at Lq <= 128 a sixty-fourth: the first probe
  // nearly always decides.
  __device__ __forceinline__ float lookup(int j) const {
    uint32_t h = home(j);
    int x = keys[h];
    while (x != j && x >= 0) {
      h = (h + 1u) & ((1u << bits) - 1u);
      x = keys[h];
    }
    return x == j ? vals[h] : 0.0f;
  }
};

// Up to kVec consecutive entries of row `slot` from entry p (pad entries
// and a gated slot read as index -1, value 0).
template <typename Val, int kVec>
struct Entries {
  int j[kVec];
  float v[kVec];
  __device__ __forceinline__ void load(const int* __restrict__ idx,
                                       const Val* __restrict__ val,
                                       int slot, int p, int P) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      j[e] = -1;
      v[e] = 0.0f;
    }
    if (slot < 0 || p >= P) return;
    const size_t off = static_cast<size_t>(slot) * P + p;
    if constexpr (kVec >= 4) {
#pragma unroll
      for (int q = 0; q < kVec; q += 4) {
        const int4 ji = __ldg(reinterpret_cast<const int4*>(idx + off + q));
        j[q] = ji.x; j[q + 1] = ji.y; j[q + 2] = ji.z; j[q + 3] = ji.w;
        if constexpr (sizeof(Val) == 4) {
          const float4 vf =
              __ldg(reinterpret_cast<const float4*>(val + off + q));
          v[q] = vf.x; v[q + 1] = vf.y; v[q + 2] = vf.z; v[q + 3] = vf.w;
        } else {
          const uint2 vb =
              __ldg(reinterpret_cast<const uint2*>(val + off + q));
          v[q] = __uint_as_float(vb.x << 16);
          v[q + 1] = __uint_as_float(vb.x & 0xFFFF0000u);
          v[q + 2] = __uint_as_float(vb.y << 16);
          v[q + 3] = __uint_as_float(vb.y & 0xFFFF0000u);
        }
      }
    } else {
      j[0] = __ldg(idx + off);
      v[0] = to_f32(val[off]);
    }
  }
};

// Adds the entries' products to a lane partial, in entry order.  A
// one-entry row's score is its product itself, signed zero included: the
// reference's sum over a length-1 axis is that product.
template <typename Val, int kVec>
__device__ __forceinline__ float accumulate(float acc,
                                            const Entries<Val, kVec>& r,
                                            const Hash& hash, bool single) {
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const float prod = __fmul_rn(hash.lookup(r.j[e]), r.v[e]);
    if constexpr (kVec == 1) {
      acc = single ? prod : __fadd_rn(acc, prod);
    } else {
      acc = __fadd_rn(acc, prod);           // P % 4 == 0: never one entry
    }
  }
  return acc;
}

__device__ __forceinline__ int list_len(int r, int chunk, int Kp, int k) {
  const int n = min(chunk, Kp - r * chunk);
  return max(0, min(k, n));
}

// Keys of `list` [0, n) below `key` (the list is ascending).
__device__ __forceinline__ int lower_bound(const u64* list, int n, u64 key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (list[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Bitonic sort, ascending, of the warp's 32 E keys held E a lane (lane l
// holds elements l E .. l E + E - 1): in-lane compare-exchanges below
// distance E, shuffles above.
template <int E>
__device__ __forceinline__ void warp_sort(u64 (&v)[E], int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * E; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= E) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int x = lane * E + e;
          const u64 o = __shfl_xor_sync(0xFFFFFFFFu, v[e], stride / E);
          const bool keep_min = ((x & stride) == 0) == ((x & size) == 0);
          v[e] = keep_min ? (o < v[e] ? o : v[e]) : (o > v[e] ? o : v[e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (e & stride) continue;
          const bool asc = ((lane * E + e) & size) == 0;
          const u64 a = v[e], c = v[e + stride];
          if ((a > c) == asc) {
            v[e] = c;
            v[e + stride] = a;
          }
        }
      }
    }
  }
}

// The warp's slice [0, n) of `keys`, sorted; its first min(k, n) keys are
// written back to the slice's start.
template <int E>
__device__ __forceinline__ void warp_select(u64* keys, int n, int k,
                                            int lane) {
  u64 v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int x = lane * E + e;
    v[e] = x < n ? keys[x] : ~0ull;
  }
  warp_sort<E>(v, lane);
  __syncwarp();
  const int keep = min(k, n);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int x = lane * E + e;
    if (x < keep) keys[x] = v[e];
  }
}

template <typename Val, int kVec>
__global__ void __launch_bounds__(kThreads)
csr_rerank_kernel(const int* __restrict__ q_idx,      // [B, Lq]
                  const float* __restrict__ q_val,    // [B, Lq]
                  int Lq,
                  const int* __restrict__ idx,        // [C, P]
                  const Val* __restrict__ val,        // [C, P]
                  int P, int gbits,
                  const long long* __restrict__ ids,  // [C]
                  const float* __restrict__ cand_scores,  // [B, Kp]
                  const int* __restrict__ cand_slots,     // [B, Kp]
                  int Kp, int k, int S,
                  long long* __restrict__ out_ids,    // [B, k]
                  float* __restrict__ out_scores,     // [B, k]
                  int* __restrict__ out_slots) {      // [B, k]
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(Lq, Kp, k, S);
  u64* s_keys = reinterpret_cast<u64*>(smem + lay.keys);
  u64* s_top = reinterpret_cast<u64*>(smem + lay.tops);
  u64* s_merged = reinterpret_cast<u64*>(smem + lay.merged);
  const Hash hash{reinterpret_cast<int*>(smem + lay.hash),
                  reinterpret_cast<float*>(smem + lay.hash +
                                           sizeof(int) * lay.table),
                  log2_pow2(lay.table)};
  int2* s_query = reinterpret_cast<int2*>(smem + lay.query);
  int* s_slot = reinterpret_cast<int*>(smem + lay.slots);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int b = blockIdx.x / S;
  const int rank = blockIdx.x - b * S;
  const int lo = rank * lay.chunk;
  const int n_s = max(0, min(lay.chunk, Kp - lo));
  const size_t cand_base = static_cast<size_t>(b) * Kp + lo;

  // -- stage: empty hash, the query's coordinates, the slots (a gated
  //    candidate's as ~slot, so its row is not read) ----------------------
  for (int t = tid; t < lay.table; t += kThreads) {
    hash.keys[t] = -1;
    hash.vals[t] = 0.0f;
  }
  for (int t = tid; t < Lq; t += kThreads) {
    const size_t at = static_cast<size_t>(b) * Lq + t;
    s_query[t] = make_int2(q_idx[at], __float_as_int(q_val[at]));
  }
  for (int t = tid; t < n_s; t += kThreads) {
    const float c = cand_scores[cand_base + t];
    const int s = cand_slots[cand_base + t];
    s_slot[t] = (isinf(c) && c < 0.0f) ? ~s : s;
  }
  __syncthreads();

  // -- one warp builds the hash in query order: duplicates add -------------
  if (tid < 32) {
    for (int c0 = 0; c0 < Lq; c0 += 32) {
      const int t = c0 + lane;
      const int j = t < Lq ? s_query[t].x : -1;
      const unsigned peers = __match_any_sync(0xFFFFFFFFu, j);
      if (j >= 0 && lane == __ffs(peers) - 1) {
        uint32_t h = hash.home(j);
        while (true) {
          const int old = atomicCAS(&hash.keys[h], -1, j);
          if (old == -1 || old == j) break;
          h = (h + 1u) & ((1u << hash.bits) - 1u);
        }
        float acc = hash.vals[h];
        for (unsigned m = peers; m; m &= m - 1u) {
          acc = __fadd_rn(acc, __int_as_float(s_query[c0 + __ffs(m) - 1].y));
        }
        hash.vals[h] = acc;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // -- score: a group of G lanes per row, kRows rows in flight ------------
  const int G = 1 << gbits;
  const int groups = kThreads >> gbits;
  const int grp = tid >> gbits;
  const int gl = tid & (G - 1);
  const int span = G * kVec;
  const int nchunks = (P + span - 1) / span;
  const bool single = P == 1;
  for (int base = 0; base < n_s; base += kRows * groups) {
    int slot[kRows];
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = base + r * groups + grp;
      slot[r] = i < n_s ? s_slot[i] : -1;
      acc[r] = 0.0f;
    }
    for (int c = 0; c < nchunks; ++c) {
      const int p = c * span + gl * kVec;
      Entries<Val, kVec> rows[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) rows[r].load(idx, val, slot[r], p, P);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        acc[r] = accumulate(acc[r], rows[r], hash, single);
      }
    }
    for (int off = G >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        acc[r] = __fadd_rn(acc[r], __shfl_xor_sync(0xFFFFFFFFu, acc[r], off));
      }
    }
    if (gl == 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = base + r * groups + grp;
        if (i < n_s) {
          const float sc = slot[r] < 0 ? -INFINITY : acc[r];
          s_keys[i] = (static_cast<u64>(order_word(sc)) << 32) |
                      static_cast<uint32_t>(lo + i);
        }
      }
    }
  }
  __syncthreads();

  // -- select: each warp sorts its slice, keeps its first min(k, .) --------
  const int warp = tid >> 5;
  const int per_warp = (n_s + kWarps - 1) / kWarps;
  const int w_lo = min(n_s, warp * per_warp);
  const int w_n = min(n_s, w_lo + per_warp) - w_lo;
  const int e_lane = next_pow2((per_warp + 31) / 32);
  if (e_lane <= 1) warp_select<1>(s_keys + w_lo, w_n, k, lane);
  else if (e_lane == 2) warp_select<2>(s_keys + w_lo, w_n, k, lane);
  else if (e_lane == 4) warp_select<4>(s_keys + w_lo, w_n, k, lane);
  else warp_select<8>(s_keys + w_lo, w_n, k, lane);
  __syncthreads();

  // ... and a key's place in the block is its place in its warp's list
  // plus the keys below it in the other warps' lists
  const size_t out_base = static_cast<size_t>(b) * k;
  auto emit = [&](int at, u64 key) {
    const int pos = static_cast<int>(static_cast<uint32_t>(key));
    int slot;
    if (S == 1) {
      slot = s_slot[pos];
      slot = slot < 0 ? ~slot : slot;
    } else {
      slot = cand_slots[static_cast<size_t>(b) * Kp + pos];
    }
    out_scores[out_base + at] = order_score(static_cast<uint32_t>(key >> 32));
    out_slots[out_base + at] = slot;
    out_ids[out_base + at] = ids[slot];
  };
  const int per_list = min(k, per_warp);
  const int block_top = min(k, n_s);
  for (int e = tid; e < kWarps * per_list; e += kThreads) {
    const int w = e / per_list, i = e - w * per_list;
    const int wl = min(n_s, w * per_warp);
    if (i >= min(k, min(n_s, wl + per_warp) - wl)) continue;
    const u64 key = s_keys[wl + i];
    int at = i;
    for (int w2 = 0; w2 < kWarps && at < block_top; ++w2) {
      if (w2 == w) continue;
      const int l2 = min(n_s, w2 * per_warp);
      at += lower_bound(s_keys + l2,
                        min(k, min(n_s, l2 + per_warp) - l2), key);
    }
    if (at < block_top) {
      if (S == 1) emit(at, key); else s_top[at] = key;
    }
  }
  if (S == 1) return;

  // -- merge the cluster's S sorted lists at rank 0 ------------------------
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                       // every block's list is ready
  const bool local = lay.merge > 0;     // uniform over the cluster
  if (local) {
    if (rank == 0) {
      for (int e = tid; e < S * k; e += kThreads) {
        const int r = e / k, i = e - r * k;
        const u64* list = cluster.map_shared_rank(s_top, r);
        s_merged[e] = i < list_len(r, lay.chunk, Kp, k) ? list[i] : ~0ull;
      }
    }
    cluster.sync();                     // copied; the other blocks may exit
  }
  if (rank == 0) {
    for (int e = tid; e < S * k; e += kThreads) {
      const int r = e / k, i = e - r * k;
      if (i >= list_len(r, lay.chunk, Kp, k)) continue;
      const u64* own = local ? s_merged + r * k
                             : cluster.map_shared_rank(s_top, r);
      const u64 key = own[i];
      int at = i;
      for (int r2 = 0; r2 < S && at < k; ++r2) {
        if (r2 == r) continue;
        const u64* other = local ? s_merged + r2 * k
                                 : cluster.map_shared_rank(s_top, r2);
        at += lower_bound(other, list_len(r2, lay.chunk, Kp, k), key);
      }
      if (at < k) emit(at, key);
    }
  }
  if (!local) cluster.sync();           // rank 0 read the others' lists
}

template <typename Val, int kVec>
int launch(const void* q_idx, const void* q_val, int B, int Lq,
           const void* idx, const void* val, int P, int gbits,
           const void* ids, const void* cand_scores, const void* cand_slots,
           int Kp, int k, int S, void* out_ids, void* out_scores,
           void* out_slots, cudaStream_t stream) {
  const Layout lay(Lq, Kp, k, S);
  auto kernel = csr_rerank_kernel<Val, kVec>;
  // The attribute is raised once per device, not on every launch.
  static size_t allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t* have = dev < kMaxDevices ? &allowed[dev] : nullptr;
  if (lay.total > 48 * 1024 && (have == nullptr || lay.total > *have)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(lay.total));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (have != nullptr) *have = lay.total;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * S, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = lay.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const int*>(q_idx),
      static_cast<const float*>(q_val), Lq, static_cast<const int*>(idx),
      static_cast<const Val*>(val), P, gbits,
      static_cast<const long long*>(ids),
      static_cast<const float*>(cand_scores),
      static_cast<const int*>(cand_slots), Kp, k, S,
      static_cast<long long*>(out_ids), static_cast<float*>(out_scores),
      static_cast<int*>(out_slots));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory of one block for these sizes, in bytes (the wrapper's
// tests hold its own sizing against it).
extern "C" long long csr_rerank_smem(int Lq, int Kp, int k, int S) {
  return static_cast<long long>(Layout(Lq, Kp, k, S).total);
}

// value_kind: 0 = float32, 1 = bfloat16; vec: entries a lane loads at
// once, 8 or 4 by 16-byte index loads (P % vec == 0, rows aligned) or 1
// by scalar loads; gbits: log2 of the lanes that score one row; S: blocks
// per query (cluster size, 1..8).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int csr_rerank_launch(int value_kind, int vec, const void* q_idx,
                                 const void* q_val, int B, int Lq,
                                 const void* idx, const void* val, int P,
                                 int gbits, const void* ids,
                                 const void* cand_scores,
                                 const void* cand_slots, int Kp, int k, int S,
                                 void* out_ids, void* out_scores,
                                 void* out_slots, void* stream) {
  if (S < 1 || S > kMaxCluster || Lq > kMaxQuery ||
      (Kp + S - 1) / S > kMaxBlockPositions || k < 1 || k > Kp ||
      gbits < 0 || gbits > 5 || (P == 1 && gbits != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CSR_RERANK_ARGS                                                     \
  q_idx, q_val, B, Lq, idx, val, P, gbits, ids, cand_scores, cand_slots,   \
      Kp, k, S, out_ids, out_scores, out_slots, s
  if (value_kind == 0 && vec == 8) return launch<float, 8>(CSR_RERANK_ARGS);
  if (value_kind == 0 && vec == 4) return launch<float, 4>(CSR_RERANK_ARGS);
  if (value_kind == 0 && vec == 1) return launch<float, 1>(CSR_RERANK_ARGS);
  if (value_kind == 1 && vec == 8) return launch<Bf16, 8>(CSR_RERANK_ARGS);
  if (value_kind == 1 && vec == 4) return launch<Bf16, 4>(CSR_RERANK_ARGS);
  if (value_kind == 1 && vec == 1) return launch<Bf16, 1>(CSR_RERANK_ARGS);
#undef CSR_RERANK_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
