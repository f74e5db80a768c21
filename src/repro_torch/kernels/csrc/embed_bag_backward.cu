// The backward of kernel D for Hopper (sm_90a): the gradient of the bag
// sums with respect to the tables.
//
// Kernel D (csrc/embed_bag.cu) replaces the Pallas TPU kernel `embed_bag`
// of src/repro/kernels/embed_bag.py, which has no backward: the reference
// trains its tables through a jnp gather (src/repro/models/recsys.py,
// `embedding_bag`) that XLA differentiates into a scatter-add.  This file
// is that scatter-add for the port's bags:
//   out[r] = sum over slots s naming row r, in slot order, of
//            grad[bag(s)] * w[s]                     (w = 1 without weights)
// where slot s = (b * F + f) * hot + j, its row r = f * V + idx[s] (the
// stacked form; F = 1 is the flat form) and a pad (idx -1) names no row.
// Rows no slot names are 0: the output is the dense [F * V, D] gradient.
//
// Determinism.  Float atomics would add a row's terms in the order the
// warps happen to arrive, so two launches could differ in the last bit.
// Here the operand prep (embed_bag.py, `backward_operands`) sorts the
// slots' row keys stably (a pad gets the key F * V, which sorts last); the
// kernel gives each run of equal keys to one warp, which adds the run's
// terms in slot order and writes the row once, so every launch gives the
// same bits, and the plain twin (`index_add_` over the rows in slot order)
// gives them too.
//
// What bounds it on an H100: bytes.  Each of the F * V * D f32 output
// elements is written once (6.66 GB for DLRM-rm2's 26 x 1,000,000 x 64
// tables), each valid slot's gradient row read once (D * 4 B) with its key
// and slot (12 B), over 3.35 TB/s; one add (and a multiply with weights)
// per element of a slot is far below the f32 rate.  So the dense write
// sets the pace, and the design writes every row exactly once:
// * a warp walks 32 consecutive sorted positions at a time (a grid-stride
//   loop over an occupancy-sized grid), position n standing for the end;
//   a position whose key differs from its predecessor's is a head;
// * for each head, in order, the warp first zeroes the rows strictly
//   between the previous key and this one (the rows no slot names), with
//   16-byte streaming stores where D is a multiple of 4, so the gap rows
//   are written by the warp that knows them and by no one else;
// * then, unless the key is the pad sentinel or the end, it sums the run:
//   lane l holds columns l, l + 32, ... of the row, reads the run's slots
//   in order (one key, one slot, one coalesced row read a step) and writes
//   the row once with streaming stores.
// A run as long as the batch (a row named by every slot) is one warp's
// loop; at DLRM's batch runs are one or two slots long.
//
// Numerics: acc = acc + grad * w with __fadd_rn / __fmul_rn (and the file
// is built with -fmad=false), starting from +0.0, slots in order.  That is
// `index_add_` into zeros on the CPU, so kernel and twin agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                  // warps a block
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* grad;      // [B, F, D] with strides g_bstride, g_fstride, 1
  long long g_bstride;
  long long g_fstride;
  const int* keys;        // [n] sorted row keys (F * V: a pad)
  const long long* slots; // [n] the slot of each sorted key
  const float* w;         // [n_slots] weights or nullptr (1.0f)
  float* out;             // [rows, D] contiguous
  long long n;
  long long rows;         // F * V
  int D, F, hot, vec4;
};

// Rows [lo, hi) of out set to +0.0, by the warp's lanes.
__device__ __forceinline__ void zero_rows(const Args& a, long long lo,
                                          long long hi, int lane) {
  if (hi <= lo) return;
  const long long begin = lo * a.D, count = (hi - lo) * a.D;
  if (a.vec4) {
    float4* p = reinterpret_cast<float4*>(a.out + begin);
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (long long k = lane; k < (count >> 2); k += 32) __stcs(p + k, z);
  } else {
    float* p = a.out + begin;
    for (long long k = lane; k < count; k += 32) __stcs(p + k, 0.f);
  }
}

// The row `key`: the sum of the run of sorted positions from `first` on.
__device__ __forceinline__ void sum_run(const Args& a, long long first,
                                        int key, int lane) {
  for (int c0 = 0; c0 < a.D; c0 += 32) {
    const int col = c0 + lane;
    float acc = 0.f;
    for (long long r = first; r < a.n && a.keys[r] == key; ++r) {
      const long long slot = a.slots[r];
      const long long bag = slot / a.hot;
      const long long b = bag / a.F;
      const long long f = bag - b * a.F;
      if (col < a.D) {
        float g = a.grad[b * a.g_bstride + f * a.g_fstride + col];
        if (a.w != nullptr) g = __fmul_rn(g, a.w[slot]);
        acc = __fadd_rn(acc, g);
      }
    }
    if (col < a.D) __stcs(a.out + static_cast<long long>(key) * a.D + col,
                          acc);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
bag_backward(const Args a) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps =
      (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  const long long chunks = a.n / 32 + 1;    // positions 0 .. n inclusive
  for (long long c = warp; c < chunks; c += n_warps) {
    const long long i = c * 32 + lane;
    long long cur = 0, prev = 0;
    bool head = false;
    if (i <= a.n) {
      cur = i < a.n ? static_cast<long long>(a.keys[i]) : a.rows;
      prev = i > 0 ? static_cast<long long>(a.keys[i - 1]) : -1;
      head = cur != prev;
    }
    unsigned heads = __ballot_sync(kFull, head);
    while (heads != 0) {
      const int src = __ffs(heads) - 1;
      heads &= heads - 1;
      const long long h_cur = __shfl_sync(kFull, cur, src);
      const long long h_prev = __shfl_sync(kFull, prev, src);
      zero_rows(a, h_prev + 1, h_cur < a.rows ? h_cur : a.rows, lane);
      if (h_cur < a.rows) {
        sum_run(a, c * 32 + src, static_cast<int>(h_cur), lane);
      }
    }
  }
}

}  // namespace

// The launch's scalars, field for field `_BackwardLaunch` of embed_bag.py.
struct BackwardLaunch {
  long long n;            // slots: B * F * hot
  long long rows;         // F * V
  long long g_bstride;    // elements between bags b and b + 1 of grad
  long long g_fstride;    // elements between fields f and f + 1 (0: flat)
  int D, F, hot;
  int vec4;               // D % 4 == 0 and out 16-byte aligned
  int sms;
  int pad;
};

extern "C" int embed_bag_backward_launch(const BackwardLaunch* L,
                                         const void* grad, const void* keys,
                                         const void* slots, const void* w,
                                         void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L->D < 1 || L->F < 1 || L->hot < 1 || L->sms < 1 || L->n < 0 ||
      L->rows < 0 || L->rows >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (L->rows == 0) return 0;
  const Args a{static_cast<const float*>(grad), L->g_bstride, L->g_fstride,
               static_cast<const int*>(keys),
               static_cast<const long long*>(slots),
               static_cast<const float*>(w), static_cast<float*>(out),
               L->n, L->rows, L->D, L->F, L->hot, L->vec4};
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, bag_backward, kWarps * 32, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long chunks = L->n / 32 + 1;
  const long long want = (chunks + kWarps - 1) / kWarps;
  long long grid = static_cast<long long>(L->sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > want) grid = want;
  bag_backward<<<static_cast<unsigned>(grid), kWarps * 32, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
