// Weighted-sum embedding bags for Hopper (sm_90a): kernel D.
//
// Replaces the Pallas TPU kernel `embed_bag` of
// src/repro/kernels/embed_bag.py (body `_kernel`): for each bag b,
//   out[b] = sum over f = 0..F-1 of table[idx[b, f]] * w[b, f]   (in f32),
// a slot with index -1 (a pad) adding nothing.  The TPU grid walks the B*F
// (bag, slot) steps in order, DMAs one table row per step through scalar
// prefetch and carries the bag's output row across its F steps in VMEM.
// Blocks on Hopper run in no order and carry nothing over, so the loop over
// F runs inside the group of lanes that owns the bag.
//
// What bounds it on an H100: bytes.  It is a gather: each distinct row the
// batch references (D x element size) must be read once, the indices and
// weights are B*F*8 bytes, the output B*D*4 bytes; the least time is their
// sum over 3.35 TB/s.  The arithmetic, one multiply-add per element of a
// valid slot, is far below the f32 rate.  This kernel reads a row at every
// valid slot; a row that several slots share comes from L2 when it is
// still there, and from HBM again when it is not.
// How the design approaches that bound:
// * a group of G lanes (a power of two, at most a warp) owns a bag, and
//   each lane owns VEC consecutive columns.  Where D * element size is a
//   multiple of 16 bytes and the table is 16-byte aligned, VEC is 16 bytes'
//   worth (4 f32 or 8 bf16) and a row is one coalesced request of
//   consecutive 16-byte loads; otherwise one element per lane.  G covers
//   the row where it fits in a warp (D = 64 f32: 16 lanes, two bags a warp;
//   D = 64 bf16: 8 lanes, four bags a warp), else the group loops over D;
// * each row is read once, straight into registers; nothing is staged in
//   shared memory;
// * a group loads G of its bag's slot indices and weights at a time, one
//   per lane, and broadcasts them with __shfl_sync;
// * row offsets are 64-bit: DLRM's 26 x 1,000,000 x 64 f32 tables viewed as
//   one [26,000,000, 64] table are 6.66 GB, past a 32-bit byte offset from
//   row 8,388,608 on.
//
// Numerics: acc = acc + row * w with __fmul_rn / __fadd_rn, slots in order
// (and the file is built with -fmad=false), a pad skipped.  That is the
// plain twin's program, so the two agree bit for bit.  The TPU kernel adds
// row 0 * 0 at a pad instead; for a finite table that is the same sum,
// since the sum starts at +0.0 and adding +-0.0 leaves it unchanged.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sketch_cells.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// Load VEC consecutive table elements as f32, exactly.
template <typename T, int VEC>
struct Row;

template <typename T>
struct Row<T, 1> {
  __device__ __forceinline__ static void load(const T* p, float (&v)[1]) {
    v[0] = to_f32(*p);
  }
};

template <>
struct Row<float, 4> {
  __device__ __forceinline__ static void load(const float* p,
                                              float (&v)[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
};

template <>
struct Row<Bf16, 8> {
  __device__ __forceinline__ static void load(const Bf16* p, float (&v)[8]) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const uint32_t words[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {   // little-endian: element 2k in the low half
      v[2 * k] = __uint_as_float(words[k] << 16);
      v[2 * k + 1] = __uint_as_float(words[k] & 0xffff0000u);
    }
  }
};

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&acc)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4) {
      *reinterpret_cast<float4*>(p + k) =
          make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] = acc[k];
  }
}

// One group of `group` lanes per bag; a warp holds 32 / group bags.  Every
// loop bound below is the same for all lanes of a warp (the warp's first
// bag, D and F), so each __shfl_sync sees the full warp; a group past the
// last bag runs with its loads and stores masked.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
embed_bag_kernel(const T* __restrict__ table,      // [V, D]
                 int D,
                 const int* __restrict__ idx,       // [n_bags, F], pad -1
                 const float* __restrict__ w,       // [n_bags, F]
                 long long n_bags, int F, int group,
                 float* __restrict__ out) {         // [n_bags, D]
  const int lane = threadIdx.x & 31;
  const int g_lane = lane & (group - 1);
  const int bags_per_warp = 32 / group;
  const long long warps = static_cast<long long>(gridDim.x) *
                          (kThreads / 32);
  const long long warp = static_cast<long long>(blockIdx.x) *
                         (kThreads / 32) + (threadIdx.x >> 5);
  const int width = group * VEC;               // columns one pass covers
  for (long long first = warp * bags_per_warp; first < n_bags;
       first += warps * bags_per_warp) {
    const long long bag = first + lane / group;
    const bool bag_ok = bag < n_bags;
    const int* bag_idx = idx + bag * F;
    const float* bag_w = w + bag * F;
    for (int d0 = 0; d0 < D; d0 += width) {
      const int col = d0 + g_lane * VEC;
      const bool col_ok = bag_ok && col < D;   // VEC divides D
      float acc[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
      for (int f0 = 0; f0 < F; f0 += group) {
        const int s = f0 + g_lane;
        int my_i = -1;
        float my_w = 0.0f;
        if (bag_ok && s < F) {
          my_i = bag_idx[s];
          my_w = bag_w[s];
        }
        const int n = min(group, F - f0);
        for (int j = 0; j < n; ++j) {
          const int i = __shfl_sync(kFull, my_i, j, group);
          const float wj = __shfl_sync(kFull, my_w, j, group);
          if (i >= 0 && col_ok) {
            float v[VEC];
            Row<T, VEC>::load(table + static_cast<int64_t>(i) * D + col, v);
#pragma unroll
            for (int k = 0; k < VEC; ++k) {
              acc[k] = __fadd_rn(acc[k], __fmul_rn(v[k], wj));
            }
          }
        }
      }
      if (col_ok) store<VEC>(out + bag * D + col, acc);
    }
  }
}

template <typename T, int VEC>
int launch(const void* table, int D, const void* idx, const void* w,
           long long n_bags, int F, int group, int grid, void* out,
           cudaStream_t stream) {
  embed_bag_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(table), D, static_cast<const int*>(idx),
      static_cast<const float*>(w), n_bags, F, group,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table_kind: 0 = float32, 1 = bfloat16.  vec: 1, or 16 bytes' worth of the
// table's elements (4 for f32, 8 for bf16) when D * element size is a
// multiple of 16 and the table is 16-byte aligned.  group: lanes per bag, a
// power of two in [1, 32].  Returns the cudaError_t of the launch (0 =
// success).
extern "C" int embed_bag_launch(int table_kind, const void* table, int D,
                                int vec, const void* idx, const void* w,
                                long long n_bags, int F, int group, int grid,
                                void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group < 1 || group > 32 || (group & (group - 1)) != 0 || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (table_kind == 0 && vec == 4) {
    return launch<float, 4>(table, D, idx, w, n_bags, F, group, grid, out, s);
  }
  if (table_kind == 0 && vec == 1) {
    return launch<float, 1>(table, D, idx, w, n_bags, F, group, grid, out, s);
  }
  if (table_kind == 1 && vec == 8) {
    return launch<Bf16, 8>(table, D, idx, w, n_bags, F, group, grid, out, s);
  }
  if (table_kind == 1 && vec == 1) {
    return launch<Bf16, 1>(table, D, idx, w, n_bags, F, group, grid, out, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
