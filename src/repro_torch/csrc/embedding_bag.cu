// embedding_bag — weighted bag sums over T stacked tables, for Hopper (sm_90a).
//
//   out[b, t, :] = sum_l w[b, t, l] * tables[t, ids[b, t, l], :]      l < L
//
// tables (T, V, D) float32 or bfloat16, ids (B, T, L) int32, weights (B, T, L)
// float32 or null (= all ones), out (B, T, D) in the tables' type.  An id
// outside [0, V) is padding: it adds exactly 0 and no row is read for it.
// Accumulation is fp32.
//
// Replaces: the Pallas TPU kernel `embedding_bag_pallas` (body `_bag_kernel`)
// in src/repro/kernels/embedding_bag/kernel.py.  That kernel prefetches the
// ids into scalar memory so that a BlockSpec index map can name the row each
// grid step copies, takes one step of a sequential (B, T, L) grid per
// gathered row, carries a (1, D) accumulator in scratch memory across the L
// axis, pads D to 128 lanes and materialises a ones tensor when there are no
// weights.  None of that carries over: here a thread loads its bag's ids
// itself, the L loop runs inside the thread with the accumulator in
// registers, D needs no padding, and a null weights pointer means 1.
//
// What bounds it on an H100: bytes.  The function reads the ids (and the
// weights) once, each distinct (t, id) row once — Zipf-distributed ids
// (dcn-v2's 26 tables of 1,000,000 rows) hit the same hot rows again and
// again, and those stay in the 50 MB L2 — and writes B*T*D outputs once; it
// does one multiply-add per (slot, feature), far below the card's rate for
// that many bytes.  At dcn-v2's D = 16 a row is 64 bytes, two 32-byte sectors.
//
// What the design does about it:
//   * Lanes run along D with 16-byte loads and stores (4 floats or 8
//     bfloat16 a thread) where D and the pointers allow: at D = 16 fp32 four
//     lanes make a bag and one warp covers 8 consecutive bags, so the ids of
//     a warp are one contiguous read and its output one contiguous write.  A
//     scalar path (one feature a thread) covers any other D.
//   * A bag's ids and weights are read once (the lanes of a bag read the same
//     address: one broadcast); its rows are gathered into registers four
//     slots at a time, so up to four independent loads are in flight before
//     the first is added, and the sum is stored once.
//   * Row offsets (t*V + id)*D are computed in 64 bits.
//   * No atomics: each output element has one owner and one fixed summation
//     order (l = 0, 1, ...), so two runs give the same bits.
//
// Plain C interface (no PyTorch headers): the caller passes device pointers
// and the stream; the function allocates nothing, does not synchronise and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4;  // bag slots gathered before they are added

template <typename T, int V> struct Vec;

template <> struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* f) { f[0] = __ldg(p); }
  static __device__ __forceinline__ void store(float* p, const float* f) { p[0] = f[0]; }
};
template <> struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* f) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <> struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* f) {
    f[0] = __bfloat162float(p[0]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* f) {
    p[0] = __float2bfloat16(f[0]);
  }
};
template <> struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* f) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 v = __bfloat1622float2(h[k]);
      f[2 * k] = v.x;
      f[2 * k + 1] = v.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* f) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

// One thread: V features of one bag.  bags = B*T; bag b*T + t uses table t.
template <typename T, int V>
__global__ void bag_lanes_d(const T* __restrict__ tables, const int* __restrict__ ids,
                            const float* __restrict__ weights, T* __restrict__ out,
                            long long bags, int nt, int vocab, int d, int l) {
  const int per_bag = d / V;  // V divides d
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long bag = tid / per_bag;
  if (bag >= bags) return;
  const int feat = static_cast<int>(tid % per_bag) * V;
  const long long table = bag % nt;
  const int* bag_ids = ids + bag * l;
  const float* bag_w = weights ? weights + bag * l : nullptr;
  const T* base = tables + table * vocab * static_cast<long long>(d) + feat;

  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;
  for (int j0 = 0; j0 < l; j0 += kChunk) {
    float row[kChunk][V];
    float w[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int j = j0 + c;
      const int id = j < l ? __ldg(bag_ids + j) : -1;
      const bool real = static_cast<unsigned>(id) < static_cast<unsigned>(vocab);
      w[c] = real ? (bag_w ? __ldg(bag_w + j) : 1.f) : 0.f;
      if (real) {
        Vec<T, V>::load(base + static_cast<long long>(id) * d, row[c]);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) row[c][k] = 0.f;
      }
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] += w[c] * row[c][k];
    }
  }
  Vec<T, V>::store(out + bag * d + feat, acc);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T, int VMAX>
int launch(const T* tables, const int* ids, const float* weights, T* out, long long bags, int nt,
           int vocab, int d, int l, cudaStream_t stream) {
  const bool vec = d % VMAX == 0 && aligned16(tables) && aligned16(out);
  const long long threads = bags * (vec ? d / VMAX : d);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks >= 2147483647LL) return -1;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (vec) {
    bag_lanes_d<T, VMAX><<<grid, kThreads, 0, stream>>>(tables, ids, weights, out, bags, nt, vocab,
                                                        d, l);
  } else {
    bag_lanes_d<T, 1><<<grid, kThreads, 0, stream>>>(tables, ids, weights, out, bags, nt, vocab, d,
                                                     l);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bags = B*T; dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError()
// (0 = launched), or -1 for an argument the kernel does not take.
extern "C" int embedding_bag_launch(const void* tables, const void* ids, const void* weights,
                                    void* out, long long bags, int nt, int vocab, int d, int l,
                                    int dtype, void* stream) {
  if (bags <= 0 || nt <= 0 || vocab <= 0 || d <= 0 || l < 0 || bags % nt != 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(ids);
  const float* w = static_cast<const float*>(weights);
  if (dtype == 0)
    return launch<float, 4>(static_cast<const float*>(tables), i, w, static_cast<float*>(out), bags,
                            nt, vocab, d, l, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, 8>(static_cast<const __nv_bfloat16*>(tables), i, w,
                                    static_cast<__nv_bfloat16*>(out), bags, nt, vocab, d, l, s);
  return -1;
}
