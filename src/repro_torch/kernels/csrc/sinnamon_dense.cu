// Dense Algorithm 6 upper bounds for Hopper (sm_90a): kernel C.
//
// Replaces the Pallas TPU kernel `sinnamon_score` of
// src/repro/kernels/sinnamon_score.py:175 (body `_kernel` -> `_accumulate`):
// for each query b and slot c, starting from acc = +0.0, add for
// t = 0 .. L-1 in order
//     contrib = q[t] > 0 ? q[t] * min_o U[row_o, c] : q[t] * max_o L[row_o, c]
// where c is in coordinate t's posting list (membership bit set), and write
// f32[B, C].  Padded coordinates (brows = -1) add nothing; without a lower
// sketch a coordinate with q <= 0 adds q * 0.
//
// Operands are the port's, not the TPU kernel's: each coordinate's sketch
// rows pre-offset into the stacked [U; L] matrix by its sign (+m for
// q <= 0, so only the side the sign selects is read), and its bitmap row
// (`brows`) with the bitmap itself, instead of a pre-gathered
// qbits[B, L, C/32] (L*C/8 bytes per query: 2.3 GB at B=256, L=64 on a
// 1,114,112-slot shard).
//
// What bounds it on an H100.  Bytes at the MS MARCO shard (C = 1,114,112,
// bf16 cells, m = 64, h = 1, L = 64): the sketch rows the batch references
// (the 64 U rows for non-negative queries: 143 MB), its distinct bitmap rows
// (139 KB each) and the f32[B, C] output (71 MB at B=16, 1.14 GB at B=256)
// give 0.08 ms at B=16 and 0.48 ms at B=256 at 3.35 TB/s.  The kernel is
// bound well before that by what a warp issues per (query, live coordinate,
// 32-slot word), ~B * 43 * C / 32 of them (0.4 G at B=256): a membership
// test, a shared-memory cell load, a decode, a multiply and an add, all
// predicated (ptxas turns the zero-word skip below into predicates).
//
// Design:
// * One block owns a tile of T = 32 * kWords slots and walks the whole
//   batch.  It first copies the tile's cells of every sketch row that the
//   batch references (flags from `mark_rows`, a pass over the batch's
//   coordinates) into shared memory with coalesced 16-byte cp.async
//   copies, so the sketch crosses HBM once per batch, not once per query.
//   The host picks kWords from R and the cell width so that two blocks fit
//   on an SM (`sinnamon_dense_smem` gives the layout; the wrapper mirrors
//   it and raises when even 32-slot tiles do not fit).
// * Each of the 16 warps takes every 16th query and, for it, the whole
//   tile: lane l owns slot 32 w + l of each word w, so one 32-bit
//   membership word covers the warp and a zero word skips the warp.  A
//   query's coordinates come in chunks of 32: lane t loads coordinate t,
//   padded ones (and q <= 0 ones without a lower sketch) are dropped by a
//   ballot that keeps the order, and the live lanes copy their bitmap row's
//   kWords words of the tile into the warp's staging buffer with cp.async.
//   Two buffers alternate, so the next chunk (of this query or the warp's
//   next one) copies while this one sums.  The sum loop reads words, q,
//   rows and cells from shared memory only; nothing in it touches global
//   memory.
// * 512 threads a block at <= 64 registers a thread, so two blocks (32
//   warps) share an SM and hide the loop's load-to-add latency.  Blocks of
//   256 threads, and lanes that own two adjacent slots (one 32-bit load
//   for two bf16 cells), were both slower on the card.
// * The f32[B, C] output is written once, 128 coalesced bytes per warp and
//   word; slots past C are masked (C is a multiple of 32, so the test is
//   warp-uniform and words past C/32 are staged as 0).
//
// Bit-identical to the plain twin `sinnamon_score_plain` (and to the port's
// `reference` backend): coordinates are added one at a time, in order, with
// __fmul_rn / __fadd_rn, and the file is built with -fmad=false.  Skipping
// a non-member slot equals adding +0.0, and skipping q * 0 (no lower sketch)
// equals adding +-0.0, because a sum that starts at +0.0 never becomes -0.0.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sketch_cells.cuh"

namespace {

constexpr int kThreads = 512;       // two blocks per SM at <= 64 registers
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;          // coordinates per staged chunk (a warp)

// Shared-memory layout of one block; the wrapper mirrors it (`dense_tile`
// in sinnamon_score.py): the tile's cells [R][32 * words], then per warp
// two staging buffers of kChunk coordinates, each holding their membership
// words int32[kChunk][words], q f32[kChunk] and cell offsets
// int32[kChunk][h].
struct Layout {
  size_t cells, buf, total;
  __host__ __device__ Layout(int R, int cell_bytes, int words, int h) {
    cells = static_cast<size_t>(R) * 32 * words * cell_bytes;
    buf = static_cast<size_t>(kChunk) * (words + 1 + h) * sizeof(int);
    total = cells + 2 * kWarps * buf;
  }
};

// used[r] = 1 for every sketch row r a scored coordinate of the batch reads
// (used is zeroed before).  Rows outside [0, R) are not marked.
__global__ void mark_rows(const float* __restrict__ qv,     // [B, L]
                          const int* __restrict__ rows,     // [B, L, h]
                          const int* __restrict__ brows,    // [B, L]
                          int n, int h, int R, int one_sided,
                          uint8_t* __restrict__ used) {     // [R]
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || brows[i] < 0 || (!one_sided && !(qv[i] > 0.0f))) return;
  for (int o = 0; o < h; ++o) {
    const int r = rows[static_cast<size_t>(i) * h + o];
    if (r >= 0 && r < R) used[r] = 1;
  }
}

template <int kWords>
__device__ __forceinline__ void load_words(const int* p, int (&w)[kWords]) {
  if constexpr (kWords % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kWords / 4; ++i) {
      const int4 v = reinterpret_cast<const int4*>(p)[i];
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  } else if constexpr (kWords == 2) {
    const int2 v = *reinterpret_cast<const int2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else {
    w[0] = p[0];
  }
}

template <typename Cell, int kWords>
__global__ void __launch_bounds__(kThreads, 2)
sinnamon_dense_kernel(const float* __restrict__ qv,       // [B, L]
                      const int* __restrict__ rows,       // [B, L, h]
                      const int* __restrict__ brows,      // [B, L]
                      const int* __restrict__ bits,       // [nrows, W]
                      const Cell* __restrict__ sk,        // [R, C]
                      const uint8_t* __restrict__ used,   // [R]
                      int B, int L, int h, int C, int W, int R,
                      int one_sided,
                      float* __restrict__ out) {          // [B, C]
  constexpr int kTile = 32 * kWords;
  constexpr int kCellChunks = kTile * sizeof(Cell) / 16;   // per row
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(R, sizeof(Cell), kWords, h);
  const Cell* s_cells = reinterpret_cast<const Cell*>(smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int base = blockIdx.x * kTile;         // C < 2^31: slots fit an int
  const int word0 = blockIdx.x * kWords;

  // -- the tile's cells of the referenced rows, once for the whole batch ---
  {
    const int valid_chunks =
        min(kTile, C - base) * static_cast<int>(sizeof(Cell)) / 16;
    unsigned char* dst = smem;
    const unsigned char* src = reinterpret_cast<const unsigned char*>(sk);
    for (int i = tid; i < R * kCellChunks; i += kThreads) {
      const int r = i / kCellChunks;
      const int k = i % kCellChunks;
      if (k < valid_chunks && __ldg(used + r)) {
        __pipeline_memcpy_async(
            dst + (static_cast<size_t>(r) * kTile) * sizeof(Cell) + k * 16,
            src + (static_cast<size_t>(r) * C + base) * sizeof(Cell) + k * 16,
            16);
      }
    }
    __pipeline_commit();
  }

  // -- this warp's stream of chunks: queries warp, warp + kWarps, ... ------
  unsigned char* s_warp = smem + lay.cells + warp * 2 * lay.buf;
  const int nch = L > 0 ? (L + kChunk - 1) / kChunk : 1;
  const int nq = warp < B ? (B - warp + kWarps - 1) / kWarps : 0;
  const int total = nq * nch;
  const unsigned lt_mask = (1u << lane) - 1u;

  // Stage chunk k into buffer k & 1; returns its number of live coordinates.
  auto fill = [&](int k) -> int {
    unsigned char* buf = s_warp + (k & 1) * lay.buf;
    int* s_words = reinterpret_cast<int*>(buf);
    float* s_q = reinterpret_cast<float*>(s_words + kChunk * kWords);
    int* s_off = reinterpret_cast<int*>(s_q + kChunk);
    const int b = warp + (k / nch) * kWarps;
    const int t = (k % nch) * kChunk + lane;
    const size_t bt = static_cast<size_t>(b) * L + t;
    int br = -1;
    float q = 0.0f;
    if (t < L) {
      br = brows[bt];
      q = qv[bt];
    }
    const bool live = br >= 0 && (one_sided || q > 0.0f);
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, live);
    if (live) {
      const int at = __popc(ballot & lt_mask);
      s_q[at] = q;
      for (int o = 0; o < h; ++o) {
        s_off[at * h + o] = rows[bt * h + o] * kTile;
      }
      const int* src = bits + static_cast<size_t>(br) * W + word0;
      int* dst = s_words + at * kWords;
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        if (word0 + w < W) {
          __pipeline_memcpy_async(dst + w, src + w, sizeof(int));
        } else {
          dst[w] = 0;
        }
      }
    }
    __pipeline_commit();
    return __popc(ballot);
  };

  int n_next = total > 0 ? fill(0) : 0;
  __pipeline_wait_prior(0);
  __syncthreads();                  // every thread's cells have landed

  float acc[kWords];
  for (int k = 0; k < total; ++k) {
    const int n = n_next;
    if (k + 1 < total) {
      n_next = fill(k + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncwarp();
    const int ch = k % nch;
    if (ch == 0) {
#pragma unroll
      for (int w = 0; w < kWords; ++w) acc[w] = 0.0f;
    }
    const unsigned char* buf = s_warp + (k & 1) * lay.buf;
    const int* s_words = reinterpret_cast<const int*>(buf);
    const float* s_q = reinterpret_cast<const float*>(s_words +
                                                      kChunk * kWords);
    const int* s_off = reinterpret_cast<const int*>(s_q + kChunk);
    for (int c = 0; c < n; ++c) {
      const float q = s_q[c];
      const bool pos = q > 0.0f;
      int wv[kWords];
      load_words<kWords>(s_words + c * kWords, wv);
      const Cell* p0 = s_cells + s_off[c * h] + lane;
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        if (wv[w] == 0) continue;                         // warp-uniform
        float x = to_f32(p0[32 * w]);
        for (int o = 1; o < h; ++o) {
          const float y =
              to_f32(s_cells[s_off[c * h + o] + 32 * w + lane]);
          x = pos ? fminf(x, y) : fmaxf(x, y);
        }
        if ((wv[w] >> lane) & 1) acc[w] = __fadd_rn(acc[w], __fmul_rn(q, x));
      }
    }
    if (ch == nch - 1) {
      const int b = warp + (k / nch) * kWarps;
      float* ob = out + static_cast<size_t>(b) * C + base + lane;
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        if (base + 32 * w < C) ob[32 * w] = acc[w];       // warp-uniform
      }
    }
    __syncwarp();                   // buffer k & 1 is refilled next round
  }
}

template <typename Cell, int kWords>
int launch(const void* qv, const void* rows, const void* brows,
           const void* bits, const void* sk, void* used, int B, int L, int h,
           int C, int W, int R, int one_sided, void* out,
           cudaStream_t stream) {
  const size_t smem = Layout(R, sizeof(Cell), kWords, h).total;
  cudaError_t err = cudaFuncSetAttribute(
      sinnamon_dense_kernel<Cell, kWords>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(used, 0, R, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = B * L;
  if (n > 0) {
    mark_rows<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        static_cast<const float*>(qv), static_cast<const int*>(rows),
        static_cast<const int*>(brows), n, h, R, one_sided,
        static_cast<uint8_t*>(used));
  }
  constexpr int kTile = 32 * kWords;
  sinnamon_dense_kernel<Cell, kWords>
      <<<(C + kTile - 1) / kTile, kThreads, smem, stream>>>(
          static_cast<const float*>(qv), static_cast<const int*>(rows),
          static_cast<const int*>(brows), static_cast<const int*>(bits),
          static_cast<const Cell*>(sk), static_cast<const uint8_t*>(used), B,
          L, h, C, W, R, one_sided, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename Cell>
int launch_words(int words, const void* qv, const void* rows,
                 const void* brows, const void* bits, const void* sk,
                 void* used, int B, int L, int h, int C, int W, int R,
                 int one_sided, void* out, cudaStream_t s) {
  switch (words) {
    case 1:
      return launch<Cell, 1>(qv, rows, brows, bits, sk, used, B, L, h, C, W,
                             R, one_sided, out, s);
    case 2:
      return launch<Cell, 2>(qv, rows, brows, bits, sk, used, B, L, h, C, W,
                             R, one_sided, out, s);
    case 4:
      return launch<Cell, 4>(qv, rows, brows, bits, sk, used, B, L, h, C, W,
                             R, one_sided, out, s);
    case 8:
      return launch<Cell, 8>(qv, rows, brows, bits, sk, used, B, L, h, C, W,
                             R, one_sided, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Shared memory one block takes for R sketch rows of `cell_bytes`-byte
// cells, tiles of 32 * words slots and h rows per coordinate, in bytes.
extern "C" long long sinnamon_dense_smem(int R, int cell_bytes, int words,
                                         int h) {
  return static_cast<long long>(Layout(R, cell_bytes, words, h).total);
}

// cell_kind: 0 = float32, 1 = bfloat16, 2 = float8_e4m3fn; words: slots per
// tile / 32, one of 1, 2, 4, 8; used: uint8[R] scratch.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int sinnamon_dense_launch(int cell_kind, int words,
                                     const void* qv, const void* rows,
                                     const void* brows, const void* bits,
                                     const void* sk, void* used, int B, int L,
                                     int h, int C, int W, int R,
                                     int one_sided, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cell_kind) {
    case 0:
      return launch_words<float>(words, qv, rows, brows, bits, sk, used, B,
                                 L, h, C, W, R, one_sided, out, s);
    case 1:
      return launch_words<Bf16>(words, qv, rows, brows, bits, sk, used, B, L,
                                h, C, W, R, one_sided, out, s);
    case 2:
      return launch_words<F8E4M3>(words, qv, rows, brows, bits, sk, used, B,
                                  L, h, C, W, R, one_sided, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
