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
// What bounds it on an H100: bytes.  At the MS MARCO shard (C = 1,114,112,
// bf16 cells, m = 64, h = 1) and B = 16, L = 64, at most
//     unique sketch rows    128 x 2,228,224 B      = 285 MB
//     unique bitmap rows  1,024 x   139,264 B      = 143 MB
//     output               16 x C x 4 B            =  71 MB
//     total                                        ~ 0.50 GB -> ~0.15 ms
// at 3.35 TB/s (each query's own rows counted apiece: ~2.4 GB, ~0.73 ms).
// The arithmetic, one multiply-add per (coordinate, member slot), is far
// below the f32 rate.
//
// Design, simple first:
// * one block per (query, run of kRun slots); the grid puts the query index
//   fastest, so blocks in flight share a run and read its sketch cells from
//   L2 after the first query;
// * threads own consecutive slots, so a warp loads 32 neighbouring cells,
//   and a warp covers exactly one 32-bit bitmap word per coordinate: a zero
//   word skips the warp's sketch loads;
// * f32[B, C] is written directly; slots past C are masked (C is a multiple
//   of 32, so the test is warp-uniform).
//
// Bit-identical to the plain twin `sinnamon_score_plain` (and to the port's
// `reference` backend): coordinates are added one at a time, in order, with
// __fmul_rn / __fadd_rn, and the file is built with -fmad=false.  Skipping
// a non-member slot equals adding +0.0, and skipping q * 0 (no lower sketch)
// equals adding +-0.0, because a sum that starts at +0.0 never becomes -0.0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sketch_cells.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSlotsPerThread = 8;
constexpr int kRun = kThreads * kSlotsPerThread;

template <typename Cell>
__global__ void __launch_bounds__(kThreads)
sinnamon_dense_kernel(const float* __restrict__ qv,       // [B, L]
                      const int* __restrict__ rows,       // [B, L, h]
                      const int* __restrict__ brows,      // [B, L]
                      const int* __restrict__ bits,       // [nrows, W]
                      const Cell* __restrict__ sk,        // [R, C]
                      int L, int h, int C, int W, int one_sided,
                      float* __restrict__ out) {          // [B, C]
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_qv = reinterpret_cast<float*>(smem);
  int* s_brow = reinterpret_cast<int*>(s_qv + L);
  int* s_rows = s_brow + L;

  const int b = blockIdx.x;
  const long long base = static_cast<long long>(blockIdx.y) * kRun;
  const int tid = threadIdx.x;
  const int lane = tid & 31;                  // == slot & 31 below

  for (int t = tid; t < L; t += kThreads) {
    s_qv[t] = qv[static_cast<size_t>(b) * L + t];
    s_brow[t] = brows[static_cast<size_t>(b) * L + t];
  }
  for (int t = tid; t < L * h; t += kThreads) {
    s_rows[t] = rows[static_cast<size_t>(b) * L * h + t];
  }
  __syncthreads();

  float acc[kSlotsPerThread];
#pragma unroll
  for (int j = 0; j < kSlotsPerThread; ++j) acc[j] = 0.0f;

  for (int t = 0; t < L; ++t) {
    const int br = s_brow[t];
    if (br < 0) continue;                                 // padded coordinate
    const float q = s_qv[t];
    const bool pos = q > 0.0f;
    if (!one_sided && !pos) continue;                     // adds q * 0
    const int* r = s_rows + t * h;
    const int* wrow = bits + static_cast<size_t>(br) * W;
#pragma unroll
    for (int j = 0; j < kSlotsPerThread; ++j) {
      const long long slot = base + j * kThreads + tid;
      if (slot >= C) continue;                            // warp-uniform
      const int w = __ldg(wrow + (slot >> 5));            // one word per warp
      if (w == 0) continue;                               // warp-uniform
      if (((w >> lane) & 1) == 0) continue;
      float x = to_f32(sk[static_cast<size_t>(r[0]) * C + slot]);
      for (int o = 1; o < h; ++o) {
        const float y = to_f32(sk[static_cast<size_t>(r[o]) * C + slot]);
        x = pos ? fminf(x, y) : fmaxf(x, y);
      }
      acc[j] = __fadd_rn(acc[j], __fmul_rn(q, x));
    }
  }

  float* ob = out + static_cast<size_t>(b) * C;
#pragma unroll
  for (int j = 0; j < kSlotsPerThread; ++j) {
    const long long slot = base + j * kThreads + tid;
    if (slot < C) ob[slot] = acc[j];
  }
}

template <typename Cell>
int launch(const void* qv, const void* rows, const void* brows,
           const void* bits, const void* sk, int B, int L, int h, int C,
           int W, int one_sided, void* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(L) * (2 + h) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      sinnamon_dense_kernel<Cell>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B, (C + kRun - 1) / kRun);
  sinnamon_dense_kernel<Cell><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(qv), static_cast<const int*>(rows),
      static_cast<const int*>(brows), static_cast<const int*>(bits),
      static_cast<const Cell*>(sk), L, h, C, W, one_sided,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sinnamon_dense_run() { return kRun; }

// cell_kind: 0 = float32, 1 = bfloat16, 2 = float8_e4m3fn.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int sinnamon_dense_launch(int cell_kind, const void* qv,
                                     const void* rows, const void* brows,
                                     const void* bits, const void* sk, int B,
                                     int L, int h, int C, int W,
                                     int one_sided, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cell_kind) {
    case 0:
      return launch<float>(qv, rows, brows, bits, sk, B, L, h, C, W,
                           one_sided, out, s);
    case 1:
      return launch<Bf16>(qv, rows, brows, bits, sk, B, L, h, C, W,
                          one_sided, out, s);
    case 2:
      return launch<F8E4M3>(qv, rows, brows, bits, sk, B, L, h, C, W,
                            one_sided, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
