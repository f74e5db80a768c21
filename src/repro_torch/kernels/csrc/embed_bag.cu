// Weighted-sum embedding bags for Hopper (sm_90a): kernel D.
//
// Replaces the Pallas TPU kernel `embed_bag` of
// src/repro/kernels/embed_bag.py (body `_kernel`): for each bag b,
//   out[b] = sum over s = 0..hot-1 of table[idx[b, s]] * w[b, s]   (in f32),
// a slot with index -1 (a pad) adding nothing.  The TPU grid walks the
// (bag, slot) steps in order, DMAs one table row per step through scalar
// prefetch and carries the bag's output row across its slots in VMEM.
// Blocks on Hopper run in no order and carry nothing over, so a bag's slot
// loop runs inside the group of lanes that owns it.
//
// One launch serves both forms:
// * flat: table [V, D], idx int32[n_bags, hot], out [n_bags, D];
// * stacked (DLRM's 26 field lookups): tables [F, V, D], idx
//   int32[B, F, hot] as the request holds them, bag = b * F + f; the row of
//   slot s is table + f * field_stride + idx * D (field_stride = V * D, 0
//   for the flat form), so no field-offset index array is built; the bag is
//   written to out + b * out_bstride + f * out_fstride, which lets the
//   caller hand over a view of its [B, F + 1, D] interaction buffer.
// A null weight pointer means a weight of 1.0f (row * 1.0f is exact).
//
// What bounds it on an H100: bytes.  It is a gather: each distinct row the
// batch references (D x element size) must be read once, the indices (4 B
// a slot; weights 4 B more where given) and the f32 output written once;
// the least time is their sum over 3.35 TB/s.  One multiply-add per element
// of a valid slot is far below the f32 rate.  A row that several slots
// share comes from L2 when it is still there, from HBM again when not.
// How the design approaches that bound:
// * a group of G lanes (a power of two, at most a warp) covers a row, each
//   lane VEC consecutive columns: 16 bytes' worth (4 f32 or 8 bf16) where
//   D * element size is a multiple of 16 and the table and the output are
//   16-byte aligned, else one element;
// * a warp takes 32 consecutive bags at a time: lane l loads bag l's slot
//   index with one coalesced load, and computes its row offset and output
//   offset (one 64-bit divide by F per 32 bags); group j owns bags
//   j*G .. j*G+G-1, whose values its own lanes hold, and reads them by
//   __shfl_sync;
// * where rows are 16-byte chunks, a group copies its rows with cp.async
//   into a four-stage shared-memory ring, three work items of U = 4 rows
//   ahead of the one being added, then adds them slot by slot in order; at
//   B=512 that puts all 16 rows of a lane group in flight at once, and no
//   registers hold rows in flight (each lane reads back only the 16 bytes
//   it copied, so a lane's own cp.async wait orders it).  The ring beat
//   register prefetch of U = 8 rows at both DLRM serving shapes on an H100
//   (PERF.md section 6), so it is the only 16-byte form;
// * rows of single elements (unaligned tables or outputs, D * element size
//   not a multiple of 16) issue U = 4 row loads into registers before the
//   first add instead;
// * the output is written with streaming stores (st.global.cs), so the
//   bags do not evict table rows from the 50 MB L2;
// * the grid comes from occupancy: as many blocks as the card holds at
//   once (a persistent grid that strides over the bags), and blocks of
//   fewer warps when the batch has fewer 32-bag chunks than 8 per SM, so a
//   small batch still spreads over every SM;
// * row offsets are 64-bit: DLRM's 26 x 1,000,000 x 64 f32 tables are
//   6.66 GB, past a 32-bit byte offset from row 8,388,608 on.
//
// Numerics: acc = acc + row * w with __fmul_rn / __fadd_rn, slots in order
// (and the file is built with -fmad=false), a pad skipped.  That is the
// plain twins' program, so kernel and twins agree bit for bit.  The TPU
// kernel adds row 0 * 0 at a pad instead; for a finite table that is the
// same sum, since the sum starts at +0.0 and adding +-0.0 leaves it
// unchanged.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "sketch_cells.cuh"

namespace {

constexpr int kMaxWarps = 8;               // warps a block, at most
constexpr unsigned kFull = 0xffffffffu;

// VEC consecutive table elements: loaded raw, decoded to f32 exactly.
template <typename T, int VEC>
struct Row;

template <typename T>
struct Row<T, 1> {
  using Raw = T;
  __device__ __forceinline__ static Raw load(const T* p) { return *p; }
  __device__ __forceinline__ static void decode(Raw r, float (&v)[1]) {
    v[0] = to_f32(r);
  }
};

template <>
struct Row<float, 4> {
  using Raw = uint4;
  __device__ __forceinline__ static Raw load(const float* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ static void decode(Raw r, float (&v)[4]) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
};

template <>
struct Row<Bf16, 8> {
  using Raw = uint4;
  __device__ __forceinline__ static Raw load(const Bf16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ static void decode(Raw r, float (&v)[8]) {
    const uint32_t words[4] = {r.x, r.y, r.z, r.w};
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
      __stcs(reinterpret_cast<float4*>(p + k),
             make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]));
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) __stcs(p + k, acc[k]);
  }
}

struct Args {
  const void* table;
  int D;
  long long field_stride;      // elements between two fields' tables
  int F;                       // fields (1: flat)
  const int* idx;              // [n_bags, hot], pad -1
  const float* w;              // [n_bags, hot] or null (weight 1)
  int hot;
  long long n_bags;
  int group;                   // lanes a row, a power of two <= 32
  float* out;
  long long out_bstride;       // elements between b and b + 1
  long long out_fstride;       // elements between f and f + 1
};

// One work item of a warp: bags first + j*G + r0 .. + r0 + U - 1 of each
// group j, columns d0.., slot s.  Items advance s fastest, then d0, then
// r0, then the 32-bag chunk.
struct Item {
  long long first;
  int r0, d0, s;
};

// What lane l knows of bag first + l: whether it exists, the offset of its
// field's table and its output offset (-1 past the end).
struct Lane {
  long long bag, f_off, out_off;
  bool ok;
};

__device__ __forceinline__ Lane lane_of(const Args& a, long long first,
                                        int lane) {
  Lane L;
  L.bag = first + lane;
  L.ok = L.bag < a.n_bags;
  long long b, f;
  if (L.bag < (1ll << 32)) {     // a 32-bit divide where it suffices
    const unsigned q = static_cast<unsigned>(L.bag) /
                       static_cast<unsigned>(a.F);
    b = q;
    f = static_cast<unsigned>(L.bag) - q * static_cast<unsigned>(a.F);
  } else {
    b = L.bag / a.F;
    f = L.bag - b * a.F;
  }
  L.f_off = f * a.field_stride;
  L.out_off = L.ok ? b * a.out_bstride + f * a.out_fstride : -1;
  return L;
}

__device__ __forceinline__ void slot_of(const Args& a, const Lane& L, int s,
                                        long long& row, float& w) {
  const int i = L.ok ? __ldg(a.idx + L.bag * a.hot + s) : -1;
  row = i >= 0 ? L.f_off + static_cast<long long>(i) * a.D : -1;
  w = a.w == nullptr ? 1.0f : (L.ok ? __ldg(a.w + L.bag * a.hot + s) : 0.f);
}

template <int U, int VEC>
__device__ __forceinline__ void add_rows(float (&acc)[U][VEC],
                                         const float (&v)[U][VEC],
                                         const float (&wj)[U],
                                         unsigned live) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (live & (1u << u)) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        acc[u][k] = __fadd_rn(acc[u][k], __fmul_rn(v[u][k], wj[u]));
      }
    }
  }
}

template <int U, int VEC>
__device__ __forceinline__ void store_rows(const Args& a, float (&acc)[U][VEC],
                                           long long out_off, int r0,
                                           int group, int col) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int src = r0 + u;
    const long long o = __shfl_sync(kFull, out_off, src & (group - 1), group);
    if (src < group && o >= 0 && col < a.D) store<VEC>(a.out + o + col, acc[u]);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[u][k] = 0.0f;
  }
}

// The register form (single-element rows): U loads issued, then added in
// slot order.
template <typename T, int VEC, int U>
__device__ void run_registers(const Args& a) {
  using R = Row<T, VEC>;
  const T* table = static_cast<const T*>(a.table);
  const int lane = threadIdx.x & 31;
  const int group = a.group;
  const int g_lane = lane & (group - 1);
  const int width = group * VEC;
  const long long stride = static_cast<long long>(gridDim.x) *
                           (blockDim.x >> 5) * 32;
  for (long long first = (static_cast<long long>(blockIdx.x) *
                          (blockDim.x >> 5) + (threadIdx.x >> 5)) * 32;
       first < a.n_bags; first += stride) {
    const Lane L = lane_of(a, first, lane);
    long long row0;
    float w0;
    slot_of(a, L, 0, row0, w0);
    for (int r0 = 0; r0 < group; r0 += U) {
      for (int d0 = 0; d0 < a.D; d0 += width) {
        const int col = d0 + g_lane * VEC;
        float acc[U][VEC];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[u][k] = 0.0f;
        for (int s = 0; s < a.hot; ++s) {
          long long my_row = row0;
          float my_w = w0;
          if (s > 0) slot_of(a, L, s, my_row, my_w);
          typename R::Raw raw[U];
          float wj[U];
          unsigned live = 0;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int src = r0 + u;
            const long long r = __shfl_sync(kFull, my_row,
                                            src & (group - 1), group);
            wj[u] = __shfl_sync(kFull, my_w, src & (group - 1), group);
            if (src < group && r >= 0 && col < a.D) {
              raw[u] = R::load(table + r + col);
              live |= 1u << u;
            }
          }
          float v[U][VEC];
#pragma unroll
          for (int u = 0; u < U; ++u) R::decode(raw[u], v[u]);
          add_rows<U, VEC>(acc, v, wj, live);
        }
        store_rows<U, VEC>(a, acc, L.out_off, r0, group, col);
      }
    }
  }
}

// The ring form: rows are copied with cp.async into an S-stage ring in
// shared memory, S - 1 work items ahead of the one being added, so the rows
// of S - 1 items (U a lane group each) are in flight while one is added.
// 16-byte rows only.  Every iteration commits one cp.async group (an empty
// one past the last item), so waiting until at most S - 1 groups are
// pending means the added item's rows have landed.
template <typename T, int VEC, int U, int S>
__device__ void run_ring(const Args& a) {
  using R = Row<T, VEC>;
  static_assert(sizeof(typename R::Raw) == 16, "ring: 16-byte loads only");
  extern __shared__ uint4 ring[];            // [warps][S][U][32]
  const T* table = static_cast<const T*>(a.table);
  const int lane = threadIdx.x & 31;
  const int group = a.group;
  const int g_lane = lane & (group - 1);
  const int width = group * VEC;
  uint4* mine = ring + (threadIdx.x >> 5) * (S * U * 32) + lane;
  const long long stride = static_cast<long long>(gridDim.x) *
                           (blockDim.x >> 5) * 32;
  // advance an item and, on a new chunk, its lane's values; false past the
  // last bag
  auto advance = [&](Item& it, Lane& L) {
    if (++it.s < a.hot) return true;
    it.s = 0;
    if ((it.d0 += width) < a.D) return true;
    it.d0 = 0;
    if ((it.r0 += U) < group) return true;
    it.r0 = 0;
    it.first += stride;
    if (it.first >= a.n_bags) return false;
    L = lane_of(a, it.first, lane);
    return true;
  };
  // copy the item's live rows into `stage`; weights and the live mask
  // stay in registers for the add
  auto gather = [&](const Item& it, const Lane& L, int stage, float (&wj)[U],
                    unsigned& live) {
    long long my_row;
    float my_w;
    slot_of(a, L, it.s, my_row, my_w);
    const int col = it.d0 + g_lane * VEC;
    live = 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int src = it.r0 + u;
      const long long r = __shfl_sync(kFull, my_row, src & (group - 1),
                                      group);
      wj[u] = __shfl_sync(kFull, my_w, src & (group - 1), group);
      if (src < group && r >= 0 && col < a.D) {
        __pipeline_memcpy_async(mine + (stage * U + u) * 32,
                                table + r + col, 16);
        live |= 1u << u;
      }
    }
  };
  Item it{(static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
           (threadIdx.x >> 5)) * 32, 0, 0, 0};
  if (it.first >= a.n_bags) return;
  Lane cl = lane_of(a, it.first, lane);      // the added item's chunk
  Item ah = it;                              // the next item to gather
  Lane gl = cl;
  bool ah_ok = true;
  float wj[S][U];
  unsigned live[S];
  float acc[U][VEC];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[u][k] = 0.0f;
#pragma unroll
  for (int p = 0; p < S - 1; ++p) {
    if (ah_ok) {
      gather(ah, gl, p, wj[p], live[p]);
      ah_ok = advance(ah, gl);
    }
    __pipeline_commit();
  }
  for (;;) {
#pragma unroll
    for (int p = 0; p < S; ++p) {
      const int q = (p + S - 1) % S;         // the stage added last time
      if (ah_ok) {
        gather(ah, gl, q, wj[q], live[q]);
        ah_ok = advance(ah, gl);
      }
      __pipeline_commit();
      __pipeline_wait_prior(S - 1);
      float v[U][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u) R::decode(mine[(p * U + u) * 32], v[u]);
      add_rows<U, VEC>(acc, v, wj[p], live[p]);
      if (it.s == a.hot - 1) {
        store_rows<U, VEC>(a, acc, cl.out_off, it.r0, group,
                           it.d0 + g_lane * VEC);
      }
      if (!advance(it, cl)) return;
    }
  }
}

template <typename T, int VEC, int U, int S>
__global__ void __launch_bounds__(kMaxWarps * 32)
embed_bag_kernel(const Args a) {
  if constexpr (S > 0) {
    run_ring<T, VEC, U, S>(a);
  } else {
    run_registers<T, VEC, U>(a);
  }
}

// The shared memory a block of `warps` warps needs: S ring stages (0:
// registers).
template <int U, int S>
constexpr size_t ring_bytes(int warps) {
  return S > 0 ? sizeof(uint4) * warps * S * U * 32 : 0;
}

constexpr int kMaxDevices = 64;           // devices whose occupancy is kept

template <typename T, int VEC, int U, int S>
int launch(const Args& a, int sms, cudaStream_t stream) {
  // blocks an SM for each block size, per device: found (with the
  // attribute the 64 KB ring at 8 warps needs) on a device's first launch
  static int occupancy[kMaxDevices][kMaxWarps + 1] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long chunks = (a.n_bags + 31) / 32;
  const int warps = static_cast<int>(
      std::min<long long>(kMaxWarps, std::max<long long>(1, (chunks + sms - 1)
                                                              / sms)));
  const size_t smem = ring_bytes<U, S>(warps);
  auto kernel = embed_bag_kernel<T, VEC, U, S>;
  int n = device < kMaxDevices ? occupancy[device][warps] : 0;
  if (n == 0) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(ring_bytes<U, S>(kMaxWarps)));
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel,
                                                        warps * 32, smem);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    n = std::max(n, 1);
    if (device < kMaxDevices) occupancy[device][warps] = n;
  }
  const long long blocks = (chunks + warps - 1) / warps;
  const int grid = static_cast<int>(
      std::min<long long>(blocks, static_cast<long long>(sms) * n));
  kernel<<<grid, warps * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// What a launch needs besides its pointers, built once per layout by the
// wrapper (its ctypes Structure `_Launch` has the same fields in the same
// order).  table_kind: 0 = float32, 1 = bfloat16.  vec: 1 (U = 4 loads
// into registers), or 16 bytes' worth of the table's elements (4 for f32,
// 8 for bf16; the cp.async ring) when D * element size is a multiple of 16
// and the table, the output and its strides are 16-byte aligned.  group:
// lanes a row, a power of two in [1, 32].  sms: the card's SMs.
struct Launch {
  long long field_stride, n_bags, out_bstride, out_fstride;
  int table_kind, vec, D, F, hot, group, sms, pad;
};

// Returns the cudaError_t of the launch (0 = success).
extern "C" int embed_bag_launch(const Launch* L, const void* table,
                                const void* idx, const void* w, void* out,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int group = L->group;
  if (group < 1 || group > 32 || (group & (group - 1)) != 0 || L->F < 1 ||
      L->hot < 1 || L->D < 1 || L->sms < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (L->n_bags <= 0) return 0;
  const Args a{table, L->D, L->field_stride, L->F,
               static_cast<const int*>(idx), static_cast<const float*>(w),
               L->hot, L->n_bags, group, static_cast<float*>(out),
               L->out_bstride, L->out_fstride};
  const int sms = L->sms;
  switch (L->table_kind * 100 + L->vec) {
    case 0 * 100 + 4:
      return launch<float, 4, 4, 4>(a, sms, st);
    case 0 * 100 + 1:
      return launch<float, 1, 4, 0>(a, sms, st);
    case 1 * 100 + 8:
      return launch<Bf16, 8, 4, 4>(a, sms, st);
    case 1 * 100 + 1:
      return launch<Bf16, 1, 4, 0>(a, sms, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
