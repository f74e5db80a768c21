// Fused Algorithm 6 candidate generation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `sinnamon_score_topk` of
// src/repro/kernels/sinnamon_score.py (body `_topk_kernel` ->
// `_fused_tile_scores`).  One block scores one (query, slot tile) pair:
// one-sided decode of the stacked [U; L] sketch (min over the h U-rows of a
// positive coordinate, max over the h L-rows of a negative one), mask by the
// coordinate's membership bits, sum over the budgeted coordinates, gate
// inactive / filtered / pad slots to -inf, and then, in one of two forms:
// * the top-k form keeps the tile's kp best candidates in (score desc,
//   slot asc) order, over every tile or over tiles 0, s, 2s, ... (the
//   sample of the two-pass selection, sinnamon_score.candidate_scan);
// * the threshold form, over the other tiles, appends every key below its
//   query's bound (the sample's k'-th key) to the query's survivor row.
// Both forms share the scoring loop below, so the float program is one.
//
// Where the time goes at the whole MS MARCO index (1,088 tiles, B=256,
// L=64; PERF.md section 6): the top-k form over every tile took 87-88 ms, of
// which selection (radix select, tie scan, sort, writes) about 30 and
// scoring 57-58; a query needs only its k' = 800 best of 870,400 such
// candidates.  The two passes spend the top-k form on 1/s of the tiles and
// scoring alone on the rest: the threshold form is bound by the scoring
// loop, as is the whole path now.
//
// Why the threshold form keeps the answer bit for bit: the bound is the
// k'-th smallest key of a subset of the slots, so it is >= the global k'-th;
// a global top-k' key outside the sample is <= the global k'-th and, keys
// being unique, below the bound.  The k' smallest of the sample's k' and
// the survivors are therefore the single pass's, whatever order the
// warp-aggregated atomics appended them in.  A query whose count passes
// the row's cap, or whose bound is a gated (-inf) key, sets a flag, and the
// host redoes the batch in one pass.
//
// What bounds it on an H100.  The byte bound is small (each query reads its
// coordinates' bitmap words of the tile; the sketch cells are shared by the
// batch and come from L2, as the grid puts the query index fastest), so the
// kernel is bound by what a block does per slot, in two phases:
// * Selection.  kp (800 on the main path) of the tile's 8,192 keys are kept.
//   Sorting all 8,192 keys took 91 block-wide stages.  Instead an MSB radix
//   select over the keys' order words finds the kp-th key's word H* (up to
//   4 passes of 8 bits; 256-bin histograms in shared memory filled by one
//   warp-aggregated atomic per distinct digit of a warp, so the counts do
//   not depend on thread order; two histograms alternate, so a pass costs
//   two barriers; the passes stop once the target's bin is kept whole).
//   Every key below H* is kept, and the first kp - n_less keys equal to H*
//   in slot order, found by a block-wide exclusive scan of the tie flags
//   (thread t owns slots t + j*512, so the scan is j-major).  Ties are the
//   usual case: every slot no coordinate touches scores exactly +0.0 and
//   every gated slot -inf.  Only the kp survivors are sorted, bitonically
//   over the next power of two >= kp: at kp <= 1,024 two keys a thread in
//   registers, exchanged by shuffles inside a warp, so only the 15 stages
//   (at 1,024) whose partner lies in another warp touch shared memory.  The
//   keys stay in registers, where the accumulators were, until compaction.
// * Scoring.  A warp covers 32 consecutive slots, i.e. exactly one bitmap
//   word per coordinate, so a zero word predicates off the whole warp's
//   sketch loads and the sketch traffic follows the posting lists, not C.
//   Padded coordinates are dropped first.  The tile's words of kChunk
//   coordinates at a time are staged in shared memory by coalesced
//   cp.async copies (a warp copies 128 B of one bitmap row), double-
//   buffered so the next chunk's copies overlap this chunk's sums; a
//   coordinate then costs one L2 round trip (its cells) instead of two
//   dependent ones (its word, then its cells).  A thread issues a row's
//   loads for kAhead = 8 of its 16 slots before their adds, so their
//   latencies overlap (4, 16, or the loads of several coordinates at once
//   were slower on the card).
// * Occupancy.  512 threads of 16 slots, at most 64 registers a thread, so
//   two blocks share an SM and one block's barrier-bound selection overlaps
//   the other's scoring.  1,024 threads of 8 slots ran either one block per
//   SM or, at 32 registers, spilled (PERF.md, PR 15).
//
// Why it is bit-equal to the plain twin (repro_torch/kernels/
// sinnamon_score.py):
// * Coordinates are added one at a time, in order, with __fmul_rn /
//   __fadd_rn (and the file is built with -fmad=false).  Skipping a slot
//   whose bit is 0 is the same as adding +0.0, because a sum that starts at
//   +0.0 never becomes -0.0.
// * The order word u is the order-preserving bits of -score; (u, slot)
//   ascending is the twin's int64 key ascending, i.e. (score desc, slot
//   asc).  The threshold and the tie scan pick exactly the set of the kp
//   smallest (u, slot) pairs, and the keys are unique, so the sorted
//   survivors are the twin's top-kp whatever order they were compacted in.
//
// Differences from the TPU kernel, and why:
// * The kernel reads membership words straight from the bitmap by each
//   coordinate's bitmap row (`brows`, -1 = padded coordinate) instead of a
//   pre-gathered qbits[B, L, C/32] operand, which would be L*C/8 bytes per
//   query materialised in HBM.
// * The tile is 8192 slots (TPU: 2048, sized for VMEM).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sketch_cells.cuh"

namespace {

constexpr int kTileC = 8192;
constexpr int kThreads = 512;       // two blocks per SM at <= 64 registers
constexpr int kWarps = kThreads / 32;
constexpr int kSlotsPerThread = kTileC / kThreads;
constexpr int kPacks = kSlotsPerThread / 4;    // u64 packs of 16-bit flags
constexpr int kRadixBins = 256;
constexpr int kTileWords = kTileC / 32;
constexpr int kChunk = 16;          // coordinates staged per buffer
constexpr int kAhead = 8;           // sketch loads a thread issues ahead
constexpr int kRegKeys = 2;         // survivors a thread sorts in registers
static_assert(kRegKeys == 2, "the in-thread stage pairs keys r and r ^ 1");
static_assert(3 * kRegKeys * kThreads * 8 <= 2 * kChunk * kTileWords * 4,
              "the register sort's buffers fit in the staging area");

typedef unsigned long long u64;

// Order word of a score: ascending u is descending score.  Equal to the
// twin's order key's high word with its sign bit flipped.
__device__ __forceinline__ uint32_t order_word(float score) {
  const uint32_t b = __float_as_uint(score);
  const uint32_t asc = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ~asc;
}

__device__ __forceinline__ float order_score(uint32_t u) {
  const uint32_t asc = ~u;
  return __uint_as_float((asc & 0x80000000u) ? (asc & 0x7FFFFFFFu) : ~asc);
}

__host__ __device__ constexpr int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Shared-memory layout of one block; the wrapper mirrors it
// (`_topk_smem_fixed` in sinnamon_score.py).
struct Layout {
  size_t keys, scan, hist, misc, coords, total;
  __host__ __device__ Layout(int L, int h, int kp) {
    // u64[next_pow2(kp)] survivors (and, for the register sort, its two
    // exchange buffers after them), aliased by the int[2][kChunk][256]
    // staged membership words: scoring ends before selection starts
    const size_t sort = static_cast<size_t>(next_pow2(kp)) * sizeof(u64);
    const size_t stage = 2 * kChunk * kTileWords * sizeof(int);
    keys = 0;
    scan = keys + (sort > stage ? sort : stage);
    hist = scan + kPacks * kWarps * sizeof(u64);       // u64[4][16]
    misc = hist + 2 * kRadixBins * sizeof(int);        // int[2][256]
    coords = misc + 4 * sizeof(int);                   // int[4]
    total = coords + static_cast<size_t>(L) * (2 + h) * sizeof(int);
  }
};

// Block-wide exclusive scan of the kPacks u64 values a thread holds (each a
// pack of four 16-bit counters); `tot` gets the block totals.
__device__ __forceinline__ void block_exclusive_scan(u64 (&v)[kPacks],
                                                     u64 (&tot)[kPacks],
                                                     u64* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  u64 incl[kPacks];
#pragma unroll
  for (int n = 0; n < kPacks; ++n) {
    incl[n] = v[n];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const u64 y = __shfl_up_sync(0xFFFFFFFFu, incl[n], o);
      if (lane >= o) incl[n] += y;
    }
    if (lane == 31) s_warp[n * kWarps + warp] = incl[n];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int n = 0; n < kPacks; ++n) {
      u64 w = lane < kWarps ? s_warp[n * kWarps + lane] : 0ull;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const u64 y = __shfl_up_sync(0xFFFFFFFFu, w, o);
        if (lane >= o) w += y;
      }
      if (lane < kWarps) s_warp[n * kWarps + lane] = w;
    }
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < kPacks; ++n) {
    const u64 before = warp ? s_warp[n * kWarps + warp - 1] : 0ull;
    tot[n] = s_warp[n * kWarps + kWarps - 1];
    v[n] = before + incl[n] - v[n];
  }
}

__device__ __forceinline__ int field16(const u64 (&v)[kPacks], int j) {
  return static_cast<int>((v[j >> 2] >> (16 * (j & 3))) & 0xFFFFull);
}

// Outputs of the threshold form (unused by the top-k form).
struct Survivors {
  const long long* theta;   // [B] each query's bound: an int64 order key
  long long* keys;          // [B, row]: survivors from column `at` on
  int* counts;              // [B] survivors found (may pass cap)
  int* flag;                // set to 1 when a count passes cap or a
                            // query's bound is a gated key
  int row, at, cap;
};

// kThreshold false: the top-k form.  Block (b, y) keeps tile y * stride's
// kp best keys in row y of out_vals / out_slots [B, T, kp] (stride 1: every
// tile).  kThreshold true: the threshold form.  Block (b, y) scores the y-th
// tile that is not a multiple of stride and appends every key below
// theta[b] to query b's row of sv.keys.
template <typename Cell, bool kThreshold>
__global__ void __launch_bounds__(kThreads, 2)
sinnamon_topk_kernel(const float* __restrict__ qv,        // [B, L]
                     const int* __restrict__ rows,        // [B, L, h]
                     const int* __restrict__ brows,       // [B, L]
                     const int* __restrict__ bits,        // [nrows, W]
                     const uint8_t* __restrict__ ok,      // [C]
                     const Cell* __restrict__ sk,         // [R, C]
                     int L, int h, int C, int W, int kp, int one_sided,
                     int T, int stride,
                     float* __restrict__ out_vals,        // [B, T, kp]
                     int* __restrict__ out_slots,         // [B, T, kp]
                     Survivors sv) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(L, h, kp);
  u64* s_keys = reinterpret_cast<u64*>(smem + lay.keys);
  u64* s_scan = reinterpret_cast<u64*>(smem + lay.scan);
  int* s_hist = reinterpret_cast<int*>(smem + lay.hist);
  int* s_misc = reinterpret_cast<int*>(smem + lay.misc);
  float* s_qv = reinterpret_cast<float*>(smem + lay.coords);
  int* s_brow = reinterpret_cast<int*>(s_qv + L);
  int* s_rows = s_brow + L;

  const int b = blockIdx.x;
  const int tile = kThreshold
      ? blockIdx.y + blockIdx.y / (stride - 1) + 1
      : blockIdx.y * stride;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const float neg_inf = -__int_as_float(0x7f800000);

  // The threshold form's bound in the kernel's (u, slot) order.  A bound
  // whose score is -inf means the sample held fewer than k' live slots:
  // the query is flagged for the single pass and scores nothing here.
  u64 bound = 0;
  if constexpr (kThreshold) {
    bound = static_cast<u64>(sv.theta[b]) ^ (1ull << 63);
    if (static_cast<uint32_t>(bound >> 32) >= order_word(neg_inf)) {
      if (tid == 0) *sv.flag = 1;
      return;
    }
  }

  // The query's coordinates, padded ones (brows < 0) dropped and the order
  // kept: a padded coordinate adds nothing to any slot.
  if (tid < 32) {
    int n = 0;
    for (int t0 = 0; t0 < L; t0 += 32) {
      const int t = t0 + lane;
      const size_t bt = static_cast<size_t>(b) * L + t;
      const int br = t < L ? brows[bt] : -1;
      const uint32_t live = __ballot_sync(0xFFFFFFFFu, br >= 0);
      if (br >= 0) {
        const int at = n + __popc(live & ((1u << lane) - 1u));
        s_qv[at] = qv[bt];
        s_brow[at] = br;
        for (int o = 0; o < h; ++o) s_rows[at * h + o] = rows[bt * h + o];
      }
      n += __popc(live);
    }
    if (lane == 0) s_misc[2] = n;   // read below, before the radix select
  }
  for (int i = tid; i < 2 * kRadixBins; i += kThreads) s_hist[i] = 0;
  if (tid == 0) s_misc[3] = 0;                            // "less" count
  __syncthreads();
  const int n_coords = s_misc[2];

  // -- scoring: coordinates in order, their tile words staged in chunks -----
  // Chunk k's membership words (kChunk coordinates x 256 words of the tile)
  // are copied into stage[k & 1] with cp.async while chunk k-1 is summed; a
  // warp copies 32 consecutive words of one bitmap row.  Coordinates past
  // n_coords and words past C are stored as 0.
  const int base = tile * kTileC;              // C < 2^31: slots fit an int
  const int word0 = tile * kTileWords;
  int* stage = reinterpret_cast<int*>(smem + lay.keys);
  const int n_chunks = (n_coords + kChunk - 1) / kChunk;
  auto stage_chunk = [&](int ck) {
    int* dst = stage + (ck & 1) * kChunk * kTileWords;
#pragma unroll
    for (int k = 0; k < kChunk * kTileWords / kThreads; ++k) {
      const int i = tid + k * kThreads;
      const int t = ck * kChunk + i / kTileWords;
      const int w = word0 + i % kTileWords;
      if (t < n_coords && w < W) {
        __pipeline_memcpy_async(dst + i,
                                bits + static_cast<size_t>(s_brow[t]) * W + w,
                                sizeof(int));
      } else {
        dst[i] = 0;
      }
    }
    __pipeline_commit();
  };

  const int slot0 = base + tid;                // this thread's slot, j = 0
  const int lane_bit = 1 << lane;
  float acc[kSlotsPerThread];
#pragma unroll
  for (int j = 0; j < kSlotsPerThread; ++j) acc[j] = 0.0f;

  if (n_chunks > 0) stage_chunk(0);
  for (int ck = 0; ck < n_chunks; ++ck) {
    if (ck + 1 < n_chunks) {
      stage_chunk(ck + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    // this warp's word of slot j is word (tid / 32) + kWarps * j of the tile
    const int* words = stage + (ck & 1) * kChunk * kTileWords + (tid >> 5);
    const int t_end = min(n_coords - ck * kChunk, kChunk);
    for (int c = 0; c < t_end; ++c) {
      const int t = ck * kChunk + c;
      const float q = s_qv[t];
      const bool pos = q > 0.0f;
      uint32_t hit = 0;             // this thread's membership bits, by j
#pragma unroll
      for (int j = 0; j < kSlotsPerThread; ++j) {
        const int w = words[c * kTileWords + kWarps * j];
        hit |= ((w & lane_bit) ? 1u : 0u) << j;
      }
      if (!one_sided && !pos) {     // no lower sketch: q * 0 at its members
#pragma unroll
        for (int j = 0; j < kSlotsPerThread; ++j) {
          if (hit & (1u << j)) acc[j] = __fadd_rn(acc[j], __fmul_rn(q, 0.0f));
        }
        continue;
      }
      // Issue kAhead slots' loads of the row, then add them.  A zero word
      // predicates off all of its warp's loads.
      const int* r = s_rows + t * h;
#pragma unroll
      for (int j0 = 0; j0 < kSlotsPerThread; j0 += kAhead) {
        float x[kAhead];
        const Cell* p = sk + static_cast<size_t>(r[0]) * C + slot0 +
                        j0 * kThreads;
#pragma unroll
        for (int j = 0; j < kAhead; ++j) {
          x[j] = (hit & (1u << (j0 + j))) ? to_f32(p[j * kThreads]) : 0.0f;
        }
        for (int o = 1; o < h; ++o) {
          p = sk + static_cast<size_t>(r[o]) * C + slot0 + j0 * kThreads;
#pragma unroll
          for (int j = 0; j < kAhead; ++j) {
            if (hit & (1u << (j0 + j))) {
              const float y = to_f32(p[j * kThreads]);
              x[j] = pos ? fminf(x[j], y) : fmaxf(x[j], y);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kAhead; ++j) {
          if (hit & (1u << (j0 + j))) {
            acc[j0 + j] = __fadd_rn(acc[j0 + j], __fmul_rn(q, x[j]));
          }
        }
      }
    }
    __syncthreads();                // stage[ck & 1] is refilled next round
  }

  uint32_t u[kSlotsPerThread];
#pragma unroll
  for (int j = 0; j < kSlotsPerThread; ++j) {
    const int slot = slot0 + j * kThreads;
    const bool keep = slot < C && ok[slot] != 0;
    u[j] = order_word(keep ? acc[j] : neg_inf);
  }

  // -- threshold form: every key below the bound, appended ------------------
  // A warp whose slots hold a survivor takes its places with one atomic on
  // the query's count; keys go out as the twin's int64 order keys.  Places
  // past cap are counted, not written, and raise the flag.
  if constexpr (kThreshold) {
    long long* dst = sv.keys + static_cast<size_t>(b) * sv.row + sv.at;
    bool over = false;
#pragma unroll
    for (int j = 0; j < kSlotsPerThread; ++j) {
      const u64 key = (static_cast<u64>(u[j]) << 32) |
                      static_cast<uint32_t>(slot0 + j * kThreads);
      const bool in = key < bound;
      const uint32_t ballot = __ballot_sync(0xFFFFFFFFu, in);
      if (ballot == 0) continue;
      int at = 0;
      if (lane == 0) at = atomicAdd(sv.counts + b, __popc(ballot));
      at = __shfl_sync(0xFFFFFFFFu, at, 0);
      if (in) {
        const int pos = at + __popc(ballot & ((1u << lane) - 1u));
        if (pos < sv.cap) {
          dst[pos] = static_cast<long long>(key ^ (1ull << 63));
        } else {
          over = true;
        }
      }
    }
    if (over) *sv.flag = 1;
    return;
  }

  // -- selection: the kp smallest (u, slot) keys of the tile ---------------

  // MSB radix select of the kp-th smallest u: up to 4 passes of 8 bits.
  // Pass p counts into s_hist[p & 1]; warp 0 reads and re-zeroes it, so a
  // pass needs two barriers.  When the target's bin holds exactly the keys
  // still wanted, the whole bin is kept and the passes stop early: the
  // compaction then compares the resolved bits (u & mask) only.
  uint32_t prefix = 0, mask = 0;
  int rank = kp;                    // rank of the target among the candidates
#pragma unroll 1
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    int* hist = s_hist + (pass & 1) * kRadixBins;
#pragma unroll
    for (int j = 0; j < kSlotsPerThread; ++j) {
      const bool in = (u[j] & mask) == prefix;
      const uint32_t d = (u[j] >> shift) & 0xFFu;
      const uint32_t peers = __match_any_sync(0xFFFFFFFFu, in ? d : 0x100u);
      if (in && lane == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
    }
    __syncthreads();
    if (tid < 32) {                 // warp 0: the bin holding the target
      constexpr int kPerLane = kRadixBins / 32;
      int c[kPerLane];
      int sum = 0;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        c[i] = hist[lane * kPerLane + i];
        hist[lane * kPerLane + i] = 0;          // ready for pass + 2
        sum += c[i];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
        if (lane >= o) incl += y;
      }
      int below = incl - sum;
      if (below < rank && rank <= incl) {
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          if (below + c[i] >= rank) {
            s_misc[0] = lane * kPerLane + i;
            s_misc[1] = rank - below;
            s_misc[2] = rank - below == c[i];   // the whole bin is kept
            break;
          }
          below += c[i];
        }
      }
    }
    __syncthreads();
    prefix |= static_cast<uint32_t>(s_misc[0]) << shift;
    mask |= 0xFFu << shift;
    rank = s_misc[1];
    if (s_misc[2]) break;
  }
  // H* = prefix on the resolved bits: keys below it are all kept, and the
  // first `take` keys equal to it in slot order.
  const int take = rank;
  const int n_less = kp - take;

  // Ties in slot order: exclusive scan of the per-j tie flags (j-major).
  u64 ties[kPacks], tot[kPacks];
#pragma unroll
  for (int n = 0; n < kPacks; ++n) ties[n] = 0;
#pragma unroll
  for (int j = 0; j < kSlotsPerThread; ++j) {
    ties[j >> 2] |= static_cast<u64>((u[j] & mask) == prefix) << (16 * (j & 3));
  }
  block_exclusive_scan(ties, tot, s_scan);
  int before = 0;
#pragma unroll
  for (int j = 0; j < kSlotsPerThread; ++j) {
    const u64 key = (static_cast<u64>(u[j]) << 32) |
                    static_cast<uint32_t>(tid + j * kThreads);
    const uint32_t resolved = u[j] & mask;
    if (resolved == prefix) {
      const int pos = before + field16(ties, j);
      if (pos < take) s_keys[n_less + pos] = key;
    }
    before += field16(tot, j);
    const bool less = resolved < prefix;
    const uint32_t ballot = __ballot_sync(0xFFFFFFFFu, less);
    int at = 0;
    if (lane == 0 && ballot) at = atomicAdd(&s_misc[3], __popc(ballot));
    at = __shfl_sync(0xFFFFFFFFu, at, 0);
    if (less) s_keys[at + __popc(ballot & ((1u << lane) - 1u))] = key;
  }
  const int n2 = next_pow2(kp);
  for (int i = kp + tid; i < n2; i += kThreads) s_keys[i] = ~0ull;
  __syncthreads();

  // Bitonic sort of the n2 survivors, ascending (u, slot).
  const size_t out_base = (static_cast<size_t>(b) * T + blockIdx.y) * kp;
  if (n2 <= kRegKeys * kThreads) {
    // Keys e = tid + r * kThreads in registers: partners inside a warp are
    // reached by shuffles, partner r ^ 1 inside the thread, and only the
    // stages whose partner lies in another warp (15 at n2 = 1,024) go
    // through two alternating buffers past the survivors, one barrier each.
    u64 v[kRegKeys];
#pragma unroll
    for (int r = 0; r < kRegKeys; ++r) {
      const int e = tid + r * kThreads;
      v[r] = e < n2 ? s_keys[e] : ~0ull;
    }
    int round = 0;
    for (int k = 2; k <= n2; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        u64 other[kRegKeys];
        if (j >= kThreads) {        // j == kThreads: the thread's own pair
#pragma unroll
          for (int r = 0; r < kRegKeys; ++r) other[r] = v[r ^ 1];
        } else if (j >= 32) {
          u64* buf = s_keys + n2 * (1 + (round++ & 1));
#pragma unroll
          for (int r = 0; r < kRegKeys; ++r) {
            if (tid + r * kThreads < n2) buf[tid + r * kThreads] = v[r];
          }
          __syncthreads();
#pragma unroll
          for (int r = 0; r < kRegKeys; ++r) {
            const int e = tid + r * kThreads;
            other[r] = e < n2 ? buf[e ^ j] : ~0ull;
          }
        } else {
#pragma unroll
          for (int r = 0; r < kRegKeys; ++r) {
            other[r] = __shfl_xor_sync(0xFFFFFFFFu, v[r], j);
          }
        }
#pragma unroll
        for (int r = 0; r < kRegKeys; ++r) {
          const int e = tid + r * kThreads;
          const bool keep_min = ((e & j) == 0) == ((e & k) == 0);
          const u64 lo = v[r] < other[r] ? v[r] : other[r];
          const u64 hi = v[r] < other[r] ? other[r] : v[r];
          v[r] = keep_min ? lo : hi;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRegKeys; ++r) {
      const int e = tid + r * kThreads;
      if (e < kp) {
        out_vals[out_base + e] =
            order_score(static_cast<uint32_t>(v[r] >> 32));
        out_slots[out_base + e] =
            static_cast<int>(base + static_cast<uint32_t>(v[r]));
      }
    }
    return;
  }
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = tid; p < (n2 >> 1); p += kThreads) {
        const int i = 2 * p - (p & (j - 1));
        const u64 a = s_keys[i];
        const u64 c = s_keys[i + j];
        if ((a > c) == ((i & k) == 0)) {
          s_keys[i] = c;
          s_keys[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < kp; i += kThreads) {
    const u64 key = s_keys[i];
    out_vals[out_base + i] = order_score(static_cast<uint32_t>(key >> 32));
    out_slots[out_base + i] =
        static_cast<int>(base + static_cast<uint32_t>(key));
  }
}

template <typename Cell, bool kThreshold>
int launch(const void* qv, const void* rows, const void* brows,
           const void* bits, const void* ok, const void* sk, int B, int L,
           int h, int C, int W, int kp, int one_sided, int T, int stride,
           void* out_vals, void* out_slots, Survivors sv,
           cudaStream_t stream) {
  if (kp < 1 || kp > kTileC || stride < (kThreshold ? 2 : 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = Layout(L, h, kp).total;
  cudaError_t err = cudaFuncSetAttribute(
      sinnamon_topk_kernel<Cell, kThreshold>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B, T);
  sinnamon_topk_kernel<Cell, kThreshold><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(qv), static_cast<const int*>(rows),
      static_cast<const int*>(brows), static_cast<const int*>(bits),
      static_cast<const uint8_t*>(ok), static_cast<const Cell*>(sk), L, h, C,
      W, kp, one_sided, T, stride, static_cast<float*>(out_vals),
      static_cast<int*>(out_slots), sv);
  return static_cast<int>(cudaGetLastError());
}

template <bool kThreshold>
int launch_kind(int cell_kind, const void* qv, const void* rows,
                const void* brows, const void* bits, const void* ok,
                const void* sk, int B, int L, int h, int C, int W, int kp,
                int one_sided, int T, int stride, void* out_vals,
                void* out_slots, Survivors sv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cell_kind) {
    case 0:
      return launch<float, kThreshold>(qv, rows, brows, bits, ok, sk, B, L,
                                       h, C, W, kp, one_sided, T, stride,
                                       out_vals, out_slots, sv, s);
    case 1:
      return launch<Bf16, kThreshold>(qv, rows, brows, bits, ok, sk, B, L,
                                      h, C, W, kp, one_sided, T, stride,
                                      out_vals, out_slots, sv, s);
    case 2:
      return launch<F8E4M3, kThreshold>(qv, rows, brows, bits, ok, sk, B, L,
                                        h, C, W, kp, one_sided, T, stride,
                                        out_vals, out_slots, sv, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int sinnamon_tile_c() { return kTileC; }

// Shared memory one block takes for (L, h, kp), in bytes.
extern "C" long long sinnamon_topk_smem(int L, int h, int kp) {
  return static_cast<long long>(Layout(L, h, kp).total);
}

// The top-k form over tiles 0, stride, 2 * stride, ... (T of them).
// cell_kind: 0 = float32, 1 = bfloat16, 2 = float8_e4m3fn.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int sinnamon_topk_launch(int cell_kind, const void* qv,
                                    const void* rows, const void* brows,
                                    const void* bits, const void* ok,
                                    const void* sk, int B, int L, int h,
                                    int C, int W, int kp, int one_sided,
                                    int T, int stride, void* out_vals,
                                    void* out_slots, void* stream) {
  return launch_kind<false>(cell_kind, qv, rows, brows, bits, ok, sk, B, L,
                            h, C, W, kp, one_sided, T, stride, out_vals,
                            out_slots, Survivors{}, stream);
}

// The threshold form over the T tiles that are not multiples of stride:
// keys [B, row] get query b's survivors at columns at .. at + cap - 1,
// counts [B] and flag [1] start at 0.
extern "C" int sinnamon_threshold_launch(
    int cell_kind, const void* qv, const void* rows, const void* brows,
    const void* bits, const void* ok, const void* sk, int B, int L, int h,
    int C, int W, int one_sided, int T, int stride, const void* theta,
    void* keys, int row, int at, int cap, void* counts, void* flag,
    void* stream) {
  const Survivors sv{static_cast<const long long*>(theta),
                     static_cast<long long*>(keys), static_cast<int*>(counts),
                     static_cast<int*>(flag), row, at, cap};
  return launch_kind<true>(cell_kind, qv, rows, brows, bits, ok, sk, B, L,
                           h, C, W, 1, one_sided, T, stride, nullptr,
                           nullptr, sv, stream);
}
