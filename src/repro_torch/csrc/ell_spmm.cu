// ell_spmm — one degree-binned ELL bucket of the SpMM hot loop, for Hopper (sm_90a).
//
//   out[i, :] = sum_j wts[i, j] * x[cols[i, j], :]        i < R, j < W
//
// x (N, D) float32 or bfloat16, cols (R, W) int32, wts (R, W) float32 or null
// (= all ones), out (R, D) in x's type.  An entry with cols outside [0, N) is
// padding: it adds exactly 0 and x is not read for it.  Accumulation is fp32.
//
// Replaces: the Pallas TPU kernel `ell_spmm_pallas` (body `_spmm_kernel`) in
// src/repro/kernels/segment_spmm/kernel.py.  That kernel prefetches `cols`
// into scalar memory, takes one grid step per gathered row and carries a
// (1, D) accumulator in scratch memory across the sequential W axis of the
// grid, with D padded to 128 lanes.  None of that carries over: here the W
// loop runs inside a thread (or a group of lanes), the accumulator lives in
// registers, and every output element is stored once by its one owner.
//
// What bounds it on an H100: bytes.  The function must read R*W*8 bytes of
// cols and wts (R*W*4 without wts), each gathered x row once (at most
// min(N, R*W)*D elements) and write R*D outputs; it does one multiply-add per
// (slot, feature), far below the card's arithmetic rate for that many bytes.
// At D = 1 — the PageRank call of the vertex engine — the whole of x is a
// megabyte that stays in L2, so the time is index traffic (cols and wts
// streamed once from device memory) plus the latency of dependent gathers,
// not bandwidth on x.
//
// What the design does about it:
//   * D < 16 (`ell_rows_group`, `ell_rows_block`): lanes run along the W slots
//     of a row, so the reads of cols and wts are contiguous across a warp (for
//     W = 8 a warp covers four rows, 32 consecutive entries).  A group of
//     g = min(32, next power of two of W) lanes owns one output element, each
//     lane sums its strided slots in order, and a shuffle tree of fixed shape
//     finishes the row.  Hub rows (W >= 1024) get a whole block: 256 threads
//     stride over the row, a shuffle tree per warp, then the eight warp sums
//     are added in order by one thread.
//   * D >= 16 (`ell_lanes_d`): lanes run along D with 16-byte loads where D
//     and the pointers allow (4 floats or 8 bfloat16 per thread), every thread
//     loops over the W slots of its row (the cols/wts reads are the same
//     address across a row's threads, one broadcast), and stores its slice.
//   * No atomics anywhere: each output element has one owner and one fixed
//     summation order, so two runs give the same bits.
//
// Plain C interface (no PyTorch headers): the caller passes device pointers
// and the stream; the function allocates nothing, does not synchronise and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmallD = 16;      // below: lanes along W; from here on: lanes along D
constexpr int kBlockRowW = 1024; // from here on a row of the small-D regime takes a whole block

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ bool is_real(int col, int n) {
  return static_cast<unsigned>(col) < static_cast<unsigned>(n);
}

// ---- D < 16: a group of g lanes (g a power of two, g <= 32) per output element ----
template <typename T>
__global__ void ell_rows_group(const T* __restrict__ x, const int* __restrict__ cols,
                               const float* __restrict__ wts, T* __restrict__ out, int n, int d,
                               long long r, int w, int g) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long task = t / g;
  const int lane = static_cast<int>(t % g);
  const bool live = task < r * d;
  float acc = 0.f;
  if (live) {
    const long long row = task / d;
    const int feat = static_cast<int>(task % d);
    const int* c = cols + row * w;
    const float* ww = wts ? wts + row * w : nullptr;
    for (int j = lane; j < w; j += g) {
      const int col = c[j];
      if (is_real(col, n)) {
        const float wv = ww ? ww[j] : 1.f;
        acc += wv * to_float(x[static_cast<long long>(col) * d + feat]);
      }
    }
  }
  // Every lane of the warp takes part (the block is a multiple of 32 threads
  // and g divides 32); the tree has the same shape for every row.
  for (int off = g >> 1; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off, g);
  if (live && lane == 0) out[task] = from_float<T>(acc);
}

// ---- D < 16, hub rows: one block per output element ----
template <typename T>
__global__ void ell_rows_block(const T* __restrict__ x, const int* __restrict__ cols,
                               const float* __restrict__ wts, T* __restrict__ out, int n, int d,
                               int w) {
  __shared__ float part[kThreads / 32];
  const long long task = blockIdx.x;
  const long long row = task / d;
  const int feat = static_cast<int>(task % d);
  const int* c = cols + row * w;
  const float* ww = wts ? wts + row * w : nullptr;
  float acc = 0.f;
  for (int j = threadIdx.x; j < w; j += kThreads) {
    const int col = c[j];
    if (is_real(col, n)) {
      const float wv = ww ? ww[j] : 1.f;
      acc += wv * to_float(x[static_cast<long long>(col) * d + feat]);
    }
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int k = 0; k < kThreads / 32; ++k) s += part[k];
    out[task] = from_float<T>(s);
  }
}

// ---- D >= 16: lanes along D, V features per thread ----
template <typename T, int V> struct Vec;

template <> struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* f) { f[0] = p[0]; }
  static __device__ __forceinline__ void store(float* p, const float* f) { p[0] = f[0]; }
};
template <> struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
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
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
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

template <typename T, int V>
__global__ void ell_lanes_d(const T* __restrict__ x, const int* __restrict__ cols,
                            const float* __restrict__ wts, T* __restrict__ out, int n, int d,
                            long long r, int w) {
  const int per_row = d / V;  // V divides d
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long row = t / per_row;
  if (row >= r) return;
  const int feat = static_cast<int>(t % per_row) * V;
  const int* c = cols + row * w;
  const float* ww = wts ? wts + row * w : nullptr;
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;
  for (int j = 0; j < w; ++j) {
    const int col = c[j];
    if (is_real(col, n)) {
      const float wv = ww ? ww[j] : 1.f;
      float v[V];
      Vec<T, V>::load(x + static_cast<long long>(col) * d + feat, v);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] += wv * v[k];
    }
  }
  Vec<T, V>::store(out + row * d + feat, acc);
}

inline unsigned blocks_for(long long threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T, int VMAX>
int launch(const T* x, const int* cols, const float* wts, T* out, int n, int d, long long r, int w,
           cudaStream_t stream) {
  if (d < kSmallD) {
    const long long tasks = r * d;
    if (w >= kBlockRowW) {
      ell_rows_block<T><<<static_cast<unsigned>(tasks), kThreads, 0, stream>>>(x, cols, wts, out, n,
                                                                              d, w);
    } else {
      int g = 1;
      while (g < w && g < 32) g <<= 1;
      ell_rows_group<T><<<blocks_for(tasks * g), kThreads, 0, stream>>>(x, cols, wts, out, n, d, r,
                                                                       w, g);
    }
  } else if (d % VMAX == 0 && aligned16(x) && aligned16(out)) {
    ell_lanes_d<T, VMAX><<<blocks_for(r * (d / VMAX)), kThreads, 0, stream>>>(x, cols, wts, out, n,
                                                                             d, r, w);
  } else {
    ell_lanes_d<T, 1><<<blocks_for(r * d), kThreads, 0, stream>>>(x, cols, wts, out, n, d, r, w);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() (0 = launched),
// or -1 for an argument the kernel does not take.
extern "C" int ell_spmm_launch(const void* x, const void* cols, const void* wts, void* out, int n,
                               int d, long long r, int w, int dtype, void* stream) {
  if (n <= 0 || d <= 0 || r <= 0 || w <= 0) return -1;
  // No regime launches more blocks than output elements (the hub-row regime
  // launches exactly that many); keep that within the grid's x limit.
  if (r * static_cast<long long>(d) >= 2147483647LL) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(cols);
  const float* ww = static_cast<const float*>(wts);
  if (dtype == 0)
    return launch<float, 4>(static_cast<const float*>(x), c, ww, static_cast<float*>(out), n, d, r,
                            w, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, 8>(static_cast<const __nv_bfloat16*>(x), c, ww,
                                    static_cast<__nv_bfloat16*>(out), n, d, r, w, s);
  return -1;
}
