// Exact padded-CSR scoring for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `csr_score` of
// src/repro/kernels/csr_score.py (body `_kernel`): exact <q, x> of a dense
// query against padded-CSR rows, pad index -1 counted as 0.  Two modes:
// * exact LinScan: `slots` is null and every one of the K = C rows is
//   scored; out is f32[B, C] (the recall ground truth and the exact
//   baseline);
// * slots: `slots` [B, K] names K rows of each query; out is f32[B, K].
//   The engine's Algorithm 7 rerank no longer calls it: csr_rerank.cu
//   scores the candidates from the sparse query and selects the top-k in
//   one launch.  This form stays as that kernel's yardstick.
//
// What bounds it on an H100: bytes.  Each scored row is P*(4 + value bytes)
// read once; the arithmetic is one multiply-add per byte-heavy gather.  The
// design keeps the dense query in shared memory for the whole block (the
// counterpart of the TPU kernel's query resident in VMEM; n = 30,000 is
// 120 KB, under the 227 KB a block may use), so the random q[idx] gathers
// hit shared memory and HBM sees only the streamed CSR rows.  One warp
// reduces one row: 32 lanes read consecutive entries (coalesced), then a
// shuffle tree sums them.  The sum order differs from the plain twin's, so
// the two agree to f32 rounding, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sketch_cells.cuh"

namespace {

constexpr int kThreads = 1024;

template <typename Val>
__global__ void __launch_bounds__(kThreads)
csr_score_kernel(const float* __restrict__ q,        // [B, n]
                 int n, int q_in_smem,
                 const int* __restrict__ slots,      // [B, K] or null
                 long long K,
                 const int* __restrict__ idx,        // [C, P]
                 const Val* __restrict__ val,        // [C, P]
                 int P,
                 float* __restrict__ out) {          // [B, K]
  extern __shared__ __align__(16) float sq[];
  const int b = blockIdx.y;
  const float* qb = q + static_cast<size_t>(b) * n;
  if (q_in_smem) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) sq[i] = qb[i];
    __syncthreads();
  }
  const float* qs = q_in_smem ? sq : qb;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (long long r = static_cast<long long>(blockIdx.x) * nwarps + warp;
       r < K; r += static_cast<long long>(gridDim.x) * nwarps) {
    const long long row =
        slots ? static_cast<long long>(slots[static_cast<size_t>(b) * K + r])
              : r;
    const int* ri = idx + row * P;
    const Val* rv = val + row * P;
    float acc = 0.0f;
    for (int p = lane; p < P; p += 32) {
      const int j = ri[p];
      if (j >= 0) acc = __fadd_rn(acc, __fmul_rn(qs[j], to_f32(rv[p])));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    }
    if (lane == 0) out[static_cast<size_t>(b) * K + r] = acc;
  }
}

template <typename Val>
int launch(const void* q, int n, int q_in_smem, const void* slots,
           long long K, const void* idx, const void* val, int P, int B,
           int grid_x, void* out, cudaStream_t stream) {
  const size_t smem = q_in_smem ? static_cast<size_t>(n) * sizeof(float) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      csr_score_kernel<Val>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(grid_x, B);
  csr_score_kernel<Val><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), n, q_in_smem,
      static_cast<const int*>(slots), K, static_cast<const int*>(idx),
      static_cast<const Val*>(val), P, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// value_kind: 0 = float32, 1 = bfloat16.  `slots` may be null (LinScan).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int csr_score_launch(int value_kind, const void* q, int n,
                                int q_in_smem, const void* slots,
                                long long K, const void* idx,
                                const void* val, int P, int B, int grid_x,
                                void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (value_kind) {
    case 0:
      return launch<float>(q, n, q_in_smem, slots, K, idx, val, P, B, grid_x,
                           out, s);
    case 1:
      return launch<Bf16>(q, n, q_in_smem, slots, K, idx, val, P, B, grid_x,
                          out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
