// The backward of kernel D for Hopper (sm_90a): the gradient of the bag
// sums with respect to the tables, written as spans of output rows.
//
// What it replaces.  Kernel D (csrc/embed_bag.cu) replaces the Pallas TPU
// kernel `embed_bag` of src/repro/kernels/embed_bag.py:60, which has no
// backward: the reference trains its tables through a jnp gather
// (src/repro/models/recsys.py:105-113) that XLA differentiates into a
// scatter-add.  This file is that scatter-add for the port's bags:
//   out[r] = sum over slots s naming row r, in slot order, of
//            grad[bag(s)] * w[s]                     (w = 1 without weights)
// where slot s = (b * F + f) * hot + j, its row r = f * V + idx[s] (the
// stacked form; F = 1 is the flat form) and a pad (idx -1) names no row.
// Rows no slot names are +0.0: the output is the dense [F * V, D] gradient.
//
// What bounds it on an H100: bytes, nearly all of them the dense write.
// Each of the F * V * D f32 outputs is written once (6.656 GB for
// DLRM-rm2's 26 x 1,000,000 x 64 tables), each bag gradient with a valid
// slot read once (0.35 GB at B = 65,536) and the indices once, over 3.35
// TB/s; an add (and a multiply with weights) per element of a slot is far
// below the f32 rate.  So the card should write the gradient at memset
// speed, and the reads should hold the writes back as little as they can.
//
// The design: output-row ownership.  A block owns a span of R consecutive
// output rows (16 KB: R = 64 at D = 64) and writes all of it.
// * A pre-pass (`span_starts`, a thread a span) finds each span's first
//   sorted position by binary search over the keys; span s's runs are the
//   positions [starts[s], starts[s + 1]), since the spans partition the
//   rows and the pad key F * V lies past the last span.  The main grid is
//   persistent (SMs x resident blocks) and deals the spans round robin, so
//   neighbouring blocks write neighbouring spans.
// * A block reads its span's keys together (a position a thread) and lists
//   the heads of the runs with their keys.  Each run goes to a group of G
//   lanes (D / 4 lanes with 16-byte loads, at most 32; columns past 4 G
//   loop) and the runs are spread over the block's groups, so a span's row
//   reads are in flight together, not one dependent chain a warp.  A group
//   reads its run's keys and slots once (a lane a position), turns a slot
//   into (b, f) with 32-bit divisions (n < 2**31) and sums the gradient
//   rows in slot order in registers.
// * The block streams the span's zeros out at once, 16-byte streaming
//   stores where D % 4 == 0 and `out` is 16-byte aligned (else 4-byte),
//   before it reads anything; after the barrier that closes the heads'
//   list, each group stores its run's sum over its row.  The zeros, 95% of
//   the bytes at DLRM's batch, never wait for a read.  A shared-memory tile
//   of the span (streamed out, or bulk-copied with cp.async.bulk while a
//   second tile fills) was measured against it and is slower on the card:
//   a tile's bytes wait for the span's reads, and the tiles an SM holds
//   cap the bytes in flight (PERF.md, the kernel table).
//
// Determinism.  No float atomics: the operand prep (embed_bag.py,
// `backward_operands`) sorts the slots' row keys stably, one group sums a
// run of equal keys in slot order, and the block that owns a span is the
// only writer of its rows.  A named row is stored twice, zero then sum, by
// two threads of the block; the __syncthreads between them orders the two
// stores, so the sum is what stays.  Numerics: acc starts at +0.0 and
// acc = acc + grad * w with __fadd_rn / __fmul_rn (the file is built with
// -fmad=false), slots in order: `index_add_` into zeros on the CPU, so the
// kernel and its twin agree bit for bit and every launch gives the same
// bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* grad;       // [B, F, D] with strides g_bstride, g_fstride, 1
  long long g_bstride;
  long long g_fstride;
  const int* keys;         // [n] sorted row keys (F * V: a pad)
  const long long* slots;  // [n] the slot of each sorted key
  const float* w;          // [n] weights by slot, or nullptr (1.0f)
  float* out;              // [rows, D] contiguous
  int n, rows, D, F, hot;
  int span_rows;           // R
  int group;               // G: lanes a run
  int vec4;                // 16-byte gradient loads
  int wide;                // 16-byte stores to `out`
  long long n_spans;
};

// starts[s] = the first sorted position whose key is >= s * R (the pads'
// first position for s = n_spans), a thread a span.
__global__ void span_starts(const Args a, int* starts) {
  const long long s = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (s > a.n_spans) return;
  const long long target = min(s * a.span_rows,
                               static_cast<long long>(a.rows));
  int lo = 0, hi = a.n;
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (a.keys[mid] < target) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  starts[s] = lo;
}

// The run of equal keys from sorted position `first`, summed in slot order
// by the G lanes of a group into registers, then stored over its row.
__device__ __forceinline__ void sum_run(const Args& a, int first, int key,
                                        int end, int g_lane,
                                        unsigned g_mask) {
  const int G = a.group;
  float* row = a.out + static_cast<long long>(key) * a.D;
  const int per = a.vec4 ? 4 : 1;
  for (int c0 = 0; c0 < a.D; c0 += G * per) {
    const int col = c0 + g_lane * per;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (long long r0 = first;; r0 += G) {
      const long long r = r0 + g_lane;
      long long off = 0;
      float wt = 1.f;
      bool valid = false;
      if (r < end && a.keys[r] == key) {
        valid = true;
        const unsigned slot = static_cast<unsigned>(a.slots[r]);
        const unsigned bag = slot / static_cast<unsigned>(a.hot);
        const unsigned b = bag / static_cast<unsigned>(a.F);
        const unsigned f = bag - b * static_cast<unsigned>(a.F);
        off = b * a.g_bstride + f * a.g_fstride;
        if (a.w != nullptr) wt = a.w[slot];
      }
      // the run's positions in this chunk are a prefix of the group
      const int cnt = __popc(__ballot_sync(g_mask, valid) & g_mask);
      for (int j = 0; j < cnt; ++j) {
        const long long o = __shfl_sync(g_mask, off, j, G);
        const float wj = __shfl_sync(g_mask, wt, j, G);
        if (col >= a.D) continue;
        if (a.vec4) {
          float4 g = __ldg(reinterpret_cast<const float4*>(a.grad + o + col));
          if (a.w != nullptr) {
            g.x = __fmul_rn(g.x, wj);
            g.y = __fmul_rn(g.y, wj);
            g.z = __fmul_rn(g.z, wj);
            g.w = __fmul_rn(g.w, wj);
          }
          acc.x = __fadd_rn(acc.x, g.x);
          acc.y = __fadd_rn(acc.y, g.y);
          acc.z = __fadd_rn(acc.z, g.z);
          acc.w = __fadd_rn(acc.w, g.w);
        } else {
          float g = __ldg(a.grad + o + col);
          if (a.w != nullptr) g = __fmul_rn(g, wj);
          acc.x = __fadd_rn(acc.x, g);
        }
      }
      if (cnt < G) break;
    }
    if (col >= a.D) continue;
    if (a.vec4 && a.wide) {
      __stcs(reinterpret_cast<float4*>(row + col), acc);
    } else {
      __stcs(row + col, acc.x);
      if (a.vec4) {
        __stcs(row + col + 1, acc.y);
        __stcs(row + col + 2, acc.z);
        __stcs(row + col + 3, acc.w);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bag_backward(const Args a, const int* starts) {
  extern __shared__ int2 heads[];    // [R] (position, key) of each run head
  __shared__ int s_heads;
  const int tid = threadIdx.x;
  const int G = a.group;
  const int g_lane = tid & (G - 1);
  const unsigned g_mask =
      G == 32 ? kFull : ((1u << G) - 1) << ((tid & 31) & ~(G - 1));
  const int group_id = tid / G, n_groups = kThreads / G;
  for (long long s = blockIdx.x; s < a.n_spans; s += gridDim.x) {
    const long long lo_row = s * a.span_rows;
    float* dst = a.out + lo_row * a.D;
    const int count = static_cast<int>(
        (min(lo_row + a.span_rows, static_cast<long long>(a.rows)) - lo_row) *
        a.D);
    if (tid == 0) s_heads = 0;
    __syncthreads();
    // the span's zeros, which depend on no read
    if (a.wide) {
      float4* d4 = reinterpret_cast<float4*>(dst);
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = tid; k < count / 4; k += kThreads) __stcs(d4 + k, z);
    } else {
      for (int k = tid; k < count; k += kThreads) __stcs(dst + k, 0.f);
    }
    // the span's sorted positions [p, end); a head starts each run
    const int p = starts[s], end = starts[s + 1];
    for (int q = p + tid; q < end; q += kThreads) {
      const int key = a.keys[q];
      if (q == p || a.keys[q - 1] != key) {
        heads[atomicAdd(&s_heads, 1)] = make_int2(q, key);
      }
    }
    // orders the zeros before the sums stored over them, too
    __syncthreads();
    const int n_heads = s_heads;
    for (int k = group_id; k < n_heads; k += n_groups) {
      const int2 h = heads[k];
      sum_run(a, h.x, h.y, end, g_lane, g_mask);
    }
  }
}

}  // namespace

// The launch's scalars, field for field `_BackwardLaunch` of embed_bag.py
// (which computes them in `backward_plan`).
struct BackwardLaunch {
  long long g_bstride;    // elements between bags b and b + 1 of grad
  long long g_fstride;    // elements between fields f and f + 1 (0: flat)
  int n;                  // slots: B * F * hot
  int rows;               // F * V
  int D, F, hot;
  int span_rows;          // R: output rows a span
  int group;              // lanes a run: a power of two, at most 32
  int vec4;               // 16-byte gradient loads (D % 4 == 0, aligned)
  int wide;               // 16-byte stores (D % 4 == 0, out aligned)
  int sms;
};

extern "C" int embed_bag_backward_launch(const BackwardLaunch* L,
                                         const void* grad, const void* keys,
                                         const void* slots, const void* w,
                                         void* starts, void* out,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = L->group;
  if (L->D < 1 || L->F < 1 || L->hot < 1 || L->sms < 1 || L->n < 0 ||
      L->rows < 0 || L->span_rows < 1 || L->span_rows > 4096 || G < 1 ||
      G > 32 || (G & (G - 1)) != 0 ||
      ((L->wide || L->vec4) && L->D % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (L->rows == 0) return 0;
  const size_t smem = static_cast<size_t>(L->span_rows) * sizeof(int2);
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, bag_backward, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_spans =
      (static_cast<long long>(L->rows) + L->span_rows - 1) / L->span_rows;
  const Args a{static_cast<const float*>(grad), L->g_bstride, L->g_fstride,
               static_cast<const int*>(keys),
               static_cast<const long long*>(slots),
               static_cast<const float*>(w), static_cast<float*>(out),
               L->n, L->rows, L->D, L->F, L->hot, L->span_rows, G, L->vec4,
               L->wide, n_spans};
  int* s_starts = static_cast<int*>(starts);
  span_starts<<<static_cast<unsigned>(n_spans / kThreads + 1), kThreads, 0,
                st>>>(a, s_starts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  long long grid = static_cast<long long>(L->sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > n_spans) grid = n_spans;
  bag_backward<<<static_cast<unsigned>(grid), kThreads, smem, st>>>(a,
                                                                  s_starts);
  return static_cast<int>(cudaGetLastError());
}
