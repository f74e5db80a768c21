// Fused Algorithm 6 candidate generation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `sinnamon_score_topk` of
// src/repro/kernels/sinnamon_score.py (body `_topk_kernel` ->
// `_fused_tile_scores`).  One block scores one (query, slot tile) pair:
// one-sided decode of the stacked [U; L] sketch (min over the h U-rows of a
// positive coordinate, max over the h L-rows of a negative one), mask by the
// coordinate's membership bits, sum over the budgeted coordinates, gate
// inactive / filtered / pad slots to -inf, and keep the tile's kp best
// candidates in (score desc, slot asc) order.
//
// What bounds it on an H100: bytes.  Each query reads L*C/8 bitmap bytes;
// the sketch cells are shared by every query of a batch.  The grid puts the
// query index fastest, so the blocks in flight at one time work on the same
// slot tile and its sketch cells are read from L2, not from HBM, by all but
// the first query.  A warp covers 32 consecutive slots, i.e. exactly one
// bitmap word per coordinate: a zero word skips the whole warp's sketch
// loads, so the sketch traffic follows the posting lists, not C.
//
// Differences from the TPU kernel, and why:
// * The kernel reads membership words straight from the bitmap by each
//   coordinate's bitmap row (`brows`, -1 = padded coordinate) instead of a
//   pre-gathered qbits[B, L, C/32] operand, which would be L*C/8 bytes per
//   query materialised in HBM.
// * Coordinates are added one at a time, in order, with __fmul_rn /
//   __fadd_rn (and the file is built with -fmad=false), so every score is
//   bit-identical to the plain twin's sequential sum in
//   repro_torch/kernels/sinnamon_score.py.  Skipping a slot whose bit is 0
//   is the same as adding +0.0, because a sum that starts at +0.0 never
//   becomes -0.0.
// * The tile is 8192 slots (TPU: 2048, sized for VMEM) and the in-tile
//   selection is a bitonic sort of 64-bit keys in shared memory (64 KB).
//   The key is (order-preserving bits of -score) << 32 | slot, the same key
//   the merge sorts on, so ties come out slot-ascending.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sketch_cells.cuh"

namespace {

constexpr int kTileC = 8192;
constexpr int kThreads = 1024;
constexpr int kSlotsPerThread = kTileC / kThreads;

__device__ __forceinline__ long long make_key(float score, int slot) {
  const int i = __float_as_int(score);
  const int sortable = i >= 0 ? i : (i ^ 0x7FFFFFFF);     // ascending in score
  const uint32_t hi = static_cast<uint32_t>(~sortable);   // descending
  return static_cast<long long>((static_cast<unsigned long long>(hi) << 32) |
                                static_cast<uint32_t>(slot));
}

__device__ __forceinline__ void split_key(long long key, float* score,
                                          int* slot) {
  const int hi = static_cast<int>(static_cast<unsigned long long>(key) >> 32);
  const int sortable = ~hi;
  const int i = sortable >= 0 ? sortable : (sortable ^ 0x7FFFFFFF);
  *score = __int_as_float(i);
  *slot = static_cast<int>(static_cast<unsigned long long>(key) & 0xFFFFFFFFull);
}

template <typename Cell>
__global__ void __launch_bounds__(kThreads)
sinnamon_topk_kernel(const float* __restrict__ qv,        // [B, L]
                     const int* __restrict__ rows,        // [B, L, h]
                     const int* __restrict__ brows,       // [B, L]
                     const int* __restrict__ bits,        // [nrows, W]
                     const uint8_t* __restrict__ ok,      // [C]
                     const Cell* __restrict__ sk,         // [R, C]
                     int L, int h, int C, int W, int kp, int one_sided,
                     int T,
                     float* __restrict__ out_vals,        // [B, T, kp]
                     int* __restrict__ out_slots) {       // [B, T, kp]
  extern __shared__ __align__(16) unsigned char smem[];
  long long* keys = reinterpret_cast<long long*>(smem);
  float* s_qv = reinterpret_cast<float*>(keys + kTileC);
  int* s_brow = reinterpret_cast<int*>(s_qv + L);
  int* s_rows = s_brow + L;

  const int b = blockIdx.x;
  const int tile = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  for (int t = tid; t < L; t += kThreads) {
    s_qv[t] = qv[static_cast<size_t>(b) * L + t];
    s_brow[t] = brows[static_cast<size_t>(b) * L + t];
  }
  for (int t = tid; t < L * h; t += kThreads) {
    s_rows[t] = rows[static_cast<size_t>(b) * L * h + t];
  }
  __syncthreads();

  const long long base = static_cast<long long>(tile) * kTileC;
  float acc[kSlotsPerThread];
#pragma unroll
  for (int j = 0; j < kSlotsPerThread; ++j) acc[j] = 0.0f;

  for (int t = 0; t < L; ++t) {
    const int br = s_brow[t];
    if (br < 0) continue;                                 // padded coordinate
    const float q = s_qv[t];
    const bool pos = q > 0.0f;
    const int* r = s_rows + t * h;
    const int* wrow = bits + static_cast<size_t>(br) * W;
#pragma unroll
    for (int j = 0; j < kSlotsPerThread; ++j) {
      const long long slot = base + tid + j * kThreads;
      if (slot >= C) continue;                            // warp-uniform
      const int w = __ldg(wrow + (slot >> 5));            // one word per warp
      if (w == 0) continue;                               // warp-uniform
      if (((w >> lane) & 1) == 0) continue;
      float x = to_f32(sk[static_cast<size_t>(r[0]) * C + slot]);
      for (int o = 1; o < h; ++o) {
        const float y = to_f32(sk[static_cast<size_t>(r[o]) * C + slot]);
        x = (one_sided && !pos) ? fmaxf(x, y) : fminf(x, y);
      }
      if (!one_sided && !pos) x = 0.0f;
      acc[j] = __fadd_rn(acc[j], __fmul_rn(q, x));
    }
  }

#pragma unroll
  for (int j = 0; j < kSlotsPerThread; ++j) {
    const long long slot = base + tid + j * kThreads;
    const bool keep = slot < C && ok[slot] != 0;
    keys[tid + j * kThreads] =
        make_key(keep ? acc[j] : -__int_as_float(0x7f800000),
                 static_cast<int>(slot));
  }
  __syncthreads();

  // Bitonic sort, ascending key = (score desc, slot asc).
  for (int k = 2; k <= kTileC; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < kTileC; i += kThreads) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const long long a = keys[i];
          const long long c = keys[ixj];
          const bool ascending = (i & k) == 0;
          if ((a > c) == ascending) {
            keys[i] = c;
            keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  const size_t out_base = (static_cast<size_t>(b) * T + tile) * kp;
  for (int i = tid; i < kp; i += kThreads) {
    float s;
    int slot;
    split_key(keys[i], &s, &slot);
    out_vals[out_base + i] = s;
    out_slots[out_base + i] = slot;
  }
}

template <typename Cell>
int launch(const void* qv, const void* rows, const void* brows,
           const void* bits, const void* ok, const void* sk, int B, int L,
           int h, int C, int W, int kp, int one_sided, int T, void* out_vals,
           void* out_slots, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kTileC) * sizeof(long long) +
                      static_cast<size_t>(L) * (2 + h) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      sinnamon_topk_kernel<Cell>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B, T);
  sinnamon_topk_kernel<Cell><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(qv), static_cast<const int*>(rows),
      static_cast<const int*>(brows), static_cast<const int*>(bits),
      static_cast<const uint8_t*>(ok), static_cast<const Cell*>(sk), L, h, C,
      W, kp, one_sided, T, static_cast<float*>(out_vals),
      static_cast<int*>(out_slots));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sinnamon_tile_c() { return kTileC; }

// cell_kind: 0 = float32, 1 = bfloat16, 2 = float8_e4m3fn.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int sinnamon_topk_launch(int cell_kind, const void* qv,
                                    const void* rows, const void* brows,
                                    const void* bits, const void* ok,
                                    const void* sk, int B, int L, int h,
                                    int C, int W, int kp, int one_sided,
                                    int T, void* out_vals, void* out_slots,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cell_kind) {
    case 0:
      return launch<float>(qv, rows, brows, bits, ok, sk, B, L, h, C, W, kp,
                           one_sided, T, out_vals, out_slots, s);
    case 1:
      return launch<Bf16>(qv, rows, brows, bits, ok, sk, B, L, h, C, W, kp,
                          one_sided, T, out_vals, out_slots, s);
    case 2:
      return launch<F8E4M3>(qv, rows, brows, bits, ok, sk, B, L, h, C, W, kp,
                            one_sided, T, out_vals, out_slots, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
