// ell_spmm — the degree-binned ELL SpMM of the vertex engine's reduce, for Hopper (sm_90a).
//
// One bucket (`ell_spmm_launch`):
//   out[i, :] = sum_j wts[i, j] * x[cols[i, j], :]        i < R, j < W
// The whole reduce (`segment_spmm_launch`): every bucket of an `EllBlocks` at
// once, each row stored straight to its vertex, out[rows[i], :] = ..., padded
// rows (rows[i] outside [0, N)) skipped, vertices in no bucket set to 0.
//
// x (N, D) float32 or bfloat16, cols int32, wts float32 or null (= all ones),
// out in x's type.  An entry with cols outside [0, N) is padding: it adds
// exactly 0 and x is not read for it.  Accumulation is fp32.
//
// Replaces: the Pallas TPU kernel `ell_spmm_pallas` (body `_spmm_kernel`) in
// src/repro/kernels/segment_spmm/kernel.py, called once a bucket by
// `segment_spmm` there.  That kernel prefetches `cols` into scalar memory,
// takes one grid step per gathered row and carries a (1, D) accumulator in
// scratch memory across the sequential W axis of the grid, with D padded to
// 128 lanes.  None of that carries over: here the W loop runs inside a thread
// (or a group of lanes), the accumulator lives in registers, and every output
// element is stored once by its one owner.
//
// What bounds it on an H100: bytes.  A reduce must read the cols and wts of
// every bucket once (8 bytes a slot, 4 without wts), each gathered x row once
// and write N*D outputs; it does one multiply-add per (slot, feature), far
// below the card's arithmetic rate for that many bytes.  At D = 1 — the
// PageRank call of the vertex engine — the whole of x is a megabyte that stays
// in L2, so the time is index traffic plus the latency of dependent gathers.
// Run one bucket at a time, a reduce was 12 launches in sequence: the small
// buckets cannot fill 132 SMs, each launch drained before the next began, and
// a zero-fill, 12 scatters and a slice ran around them.
//
// What the design does about it:
//   * One launch a reduce (`segment_fused`).  The buckets sit in one flat
//     cols/wts buffer, and a work table built once with them (`EllWork`, in the
//     port's graph/structs.py) cuts them into items of about 2,048 slots:
//     (first row, row count, width, slot offset).  Each item is one block;
//     hub rows (W >= kBlockRowW) are items of one row and come first, so the
//     longest blocks start first.  Each row is stored to out[rows[i]], so no
//     scatter follows; blocks past the items zero the rows of vertices that
//     are in no bucket (listed once at build time), so the output needs no
//     zero-fill either.
//   * D < 16: lanes run along the W slots of a row, so the reads of cols and
//     wts are contiguous across a warp (for W = 8 a warp covers four rows, 32
//     consecutive entries).  A group of g = min(32, next power of two of W)
//     lanes owns one output element, each lane sums its strided slots in
//     order, and a shuffle tree of fixed shape finishes the row.  Hub rows get
//     a whole block: 256 threads stride over the row, a shuffle tree per warp,
//     then the eight warp sums are added in order by one thread.
//   * D >= 16: lanes run along D with 16-byte loads where D and the pointers
//     allow (4 floats or 8 bfloat16 per thread), every thread loops over the W
//     slots of its row (the cols/wts reads are the same address across a
//     row's threads, one broadcast), and stores its slice.  The loop fetches
//     four slots' rows before it adds them, in slot order, so four gathers
//     are in flight a thread.  A hub row (W >= kBlockRowW) would leave all
//     but d / V threads of its block idle, each walking all W slots in a
//     chain of dependent gathers (16 threads and 32,768 slots for amazon's
//     largest in-degree at D = 64): there the block's threads form
//     kThreads / (d / V) groups, group g sums slots g, g + groups, ..., and
//     the groups' partial sums meet in shared memory, added in group order
//     by group 0.
//   * The fused kernel runs each row with the same lanes and the same order of
//     summation as the one-bucket kernels (the same device code), so the two
//     routes give the same bits.  No atomics anywhere: each output element has
//     one owner and one fixed order, so two runs give the same bits.
//
// Plain C interface (no PyTorch headers): the caller passes device pointers
// and the stream; the functions allocate nothing, do not synchronise and
// return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmallD = 16;      // below: lanes along W; from here on: lanes along D
constexpr int kBlockRowW = 1024; // from here on a row (a hub) takes a whole block
constexpr int kUnroll = 4;       // D >= 16: slots fetched before they are added

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

// ---- 16-byte (or scalar) loads and stores of V features ----
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

// ---- shared by the one-bucket kernels and the fused one: one element / one row ----

// D < 16: lane `lane` of a group of g sums slots lane, lane + g, ... of row c/ww
template <typename T>
__device__ __forceinline__ float group_slots(const T* __restrict__ x, const int* c, const float* ww, int n,
                                             int d, int feat, int w, int lane, int g) {
  float acc = 0.f;
  for (int j = lane; j < w; j += g) {
    const int col = c[j];
    if (is_real(col, n)) {
      const float wv = ww ? ww[j] : 1.f;
      acc += wv * to_float(x[static_cast<long long>(col) * d + feat]);
    }
  }
  return acc;
}

// D < 16, a hub row: the block's sum of one element; thread 0 gets it
template <typename T>
__device__ __forceinline__ float block_row(const T* __restrict__ x, const int* c, const float* ww, int n,
                                           int d, int feat, int w, float* part) {
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
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int k = 0; k < kThreads / 32; ++k) s += part[k];
  __syncthreads();  // part is free again
  return s;
}

// D >= 16: adds slots j0, j0 + step, ... (< w) of one row to the sums of V
// features, in that order; kUnroll slots' rows are fetched before they are added
template <typename T, int V>
__device__ __forceinline__ void lanes_slots(const T* __restrict__ x, const int* c, const float* ww, int n, int d,
                                            int feat, int j0, int step, int w, float* acc) {
  int j = j0;
  for (; j + (kUnroll - 1) * step < w; j += kUnroll * step) {
    int col[kUnroll];
    float wv[kUnroll], v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      col[u] = c[j + u * step];
      wv[u] = ww ? ww[j + u * step] : 1.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (is_real(col[u], n)) Vec<T, V>::load(x + static_cast<long long>(col[u]) * d + feat, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (is_real(col[u], n)) {
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] += wv[u] * v[u][k];
      }
  }
  for (; j < w; j += step) {
    const int col = c[j];
    if (is_real(col, n)) {
      const float wv = ww ? ww[j] : 1.f;
      float v[V];
      Vec<T, V>::load(x + static_cast<long long>(col) * d + feat, v);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] += wv * v[k];
    }
  }
}

// D >= 16: V features of one row into `dst`
template <typename T, int V>
__device__ __forceinline__ void lanes_row(const T* __restrict__ x, const int* c, const float* ww, int n, int d,
                                          int feat, int w, T* dst) {
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;
  lanes_slots<T, V>(x, c, ww, n, d, feat, 0, 1, w, acc);
  Vec<T, V>::store(dst, acc);
}

// D >= 16, a hub row: the whole block computes the row into `dst`.  Groups of
// per_row = d / V threads stride the slots; part (kThreads * V floats, shared)
// holds the groups' partial sums, feature-major, and group 0 adds them in
// group order.  Where two groups do not fit, the threads loop over the
// features as lanes_row does.  Every thread of the block must call it.
template <typename T, int V>
__device__ __forceinline__ void lanes_hub_row(const T* __restrict__ x, const int* c, const float* ww, int n, int d,
                                              int w, T* dst, float* part) {
  const int per_row = d / V;
  const int groups = kThreads / per_row;
  if (groups < 2) {
    for (int f = threadIdx.x; f < per_row; f += kThreads) lanes_row<T, V>(x, c, ww, n, d, f * V, w, dst + f * V);
    return;
  }
  const int g = threadIdx.x / per_row, f = threadIdx.x % per_row;
  if (g < groups) {
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
    lanes_slots<T, V>(x, c, ww, n, d, f * V, g, groups, w, acc);
#pragma unroll
    for (int k = 0; k < V; ++k) part[k * kThreads + threadIdx.x] = acc[k];
  }
  __syncthreads();
  if (g == 0) {
    float s[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      s[k] = part[k * kThreads + f];
      for (int q = 1; q < groups; ++q) s[k] += part[k * kThreads + q * per_row + f];
    }
    Vec<T, V>::store(dst + f * V, s);
  }
  __syncthreads();  // part is free again
}

// ---- one bucket, D < 16: a group of g lanes (g a power of two, g <= 32) per output element ----
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
    acc = group_slots(x, cols + row * w, wts ? wts + row * w : nullptr, n, d, static_cast<int>(task % d), w,
                      lane, g);
  }
  // Every lane of the warp takes part (the block is a multiple of 32 threads
  // and g divides 32); the tree has the same shape for every row.
  for (int off = g >> 1; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off, g);
  if (live && lane == 0) out[task] = from_float<T>(acc);
}

// ---- one bucket, D < 16, hub rows: one block per output element ----
template <typename T>
__global__ void ell_rows_block(const T* __restrict__ x, const int* __restrict__ cols,
                               const float* __restrict__ wts, T* __restrict__ out, int n, int d,
                               int w) {
  __shared__ float part[kThreads / 32];
  const long long task = blockIdx.x;
  const long long row = task / d;
  const float s = block_row(x, cols + row * w, wts ? wts + row * w : nullptr, n, d, static_cast<int>(task % d),
                            w, part);
  if (threadIdx.x == 0) out[task] = from_float<T>(s);
}

// ---- one bucket, D >= 16: lanes along D, V features per thread ----
template <typename T, int V>
__global__ void ell_lanes_d(const T* __restrict__ x, const int* __restrict__ cols,
                            const float* __restrict__ wts, T* __restrict__ out, int n, int d,
                            long long r, int w) {
  const int per_row = d / V;  // V divides d
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long row = t / per_row;
  if (row >= r) return;
  const int feat = static_cast<int>(t % per_row) * V;
  lanes_row<T, V>(x, cols + row * w, wts ? wts + row * w : nullptr, n, d, feat, w, out + row * d + feat);
}

// ---- one bucket, D >= 16, hub rows: one block per row ----
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) ell_lanes_hub(const T* __restrict__ x, const int* __restrict__ cols,
                                                          const float* __restrict__ wts, T* __restrict__ out, int n,
                                                          int d, int w) {
  __shared__ float part[kThreads * V];
  const long long row = blockIdx.x;
  lanes_hub_row<T, V>(x, cols + row * w, wts ? wts + row * w : nullptr, n, d, w, out + row * d, part);
}

// ---- the whole reduce in one launch: block i < n_items runs work item i ----
// items: (n_items, 4) int64 = first row (into rows), row count, width, slot
// offset (into cols/wts); the blocks after them zero the rows in zero_rows.
// kLanesD picks the regime (D >= kSmallD) at compile time, so each instance
// holds one regime's code and is given registers for it alone.
template <typename T, int V, bool kLanesD>
__global__ void __launch_bounds__(kThreads) segment_fused(
    const T* __restrict__ x, const int* __restrict__ cols, const float* __restrict__ wts,
    const int* __restrict__ rows, const long long* __restrict__ items, const int* __restrict__ zero_rows,
    T* __restrict__ out, int n, int d, int n_items, long long n_zero) {
  if (static_cast<int>(blockIdx.x) >= n_items) {
    const long long e = static_cast<long long>(blockIdx.x - n_items) * kThreads + threadIdx.x;
    if (e < n_zero * d) out[static_cast<long long>(zero_rows[e / d]) * d + e % d] = from_float<T>(0.f);
    return;
  }
  const long long* item = items + 4LL * blockIdx.x;
  const long long row0 = item[0], slot0 = item[3];
  const int nrows = static_cast<int>(item[1]), w = static_cast<int>(item[2]);
  const int* c0 = cols + slot0;
  const float* w0 = wts ? wts + slot0 : nullptr;
  if constexpr (!kLanesD) {
    if (w >= kBlockRowW) {  // hub rows: the block sums each element
      __shared__ float part[kThreads / 32];
      for (int r = 0; r < nrows; ++r) {
        const int v = rows[row0 + r];
        for (int feat = 0; feat < d; ++feat) {
          const float s = block_row(x, c0 + static_cast<long long>(r) * w,
                                    w0 ? w0 + static_cast<long long>(r) * w : nullptr, n, d, feat, w, part);
          if (threadIdx.x == 0 && is_real(v, n)) out[static_cast<long long>(v) * d + feat] = from_float<T>(s);
        }
      }
    } else {  // groups of g lanes, kThreads / g elements a pass
      int g = 1;
      while (g < w && g < 32) g <<= 1;
      const long long tasks = static_cast<long long>(nrows) * d;
      const int lane = threadIdx.x % g;
      for (long long base = 0; base < tasks; base += kThreads / g) {
        const long long task = base + threadIdx.x / g;
        const bool live = task < tasks;
        float acc = 0.f;
        long long row = 0;
        int feat = 0;
        if (live) {
          row = task / d;
          feat = static_cast<int>(task % d);
          acc = group_slots(x, c0 + row * w, w0 ? w0 + row * w : nullptr, n, d, feat, w, lane, g);
        }
        for (int off = g >> 1; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off, g);
        if (live && lane == 0) {
          const int v = rows[row0 + row];
          if (is_real(v, n)) out[static_cast<long long>(v) * d + feat] = from_float<T>(acc);
        }
      }
    }
  } else {
    if (w >= kBlockRowW) {  // hub rows: the block splits each row's slots
      __shared__ float hub[kThreads * V];
      for (int r = 0; r < nrows; ++r) {
        const int v = rows[row0 + r];
        if (!is_real(v, n)) continue;  // the same for every thread of the block
        lanes_hub_row<T, V>(x, c0 + static_cast<long long>(r) * w, w0 ? w0 + static_cast<long long>(r) * w : nullptr,
                            n, d, w, out + static_cast<long long>(v) * d, hub);
      }
    } else {  // lanes along D
      const int per_row = d / V;
      const long long tasks = static_cast<long long>(nrows) * per_row;
      for (long long t = threadIdx.x; t < tasks; t += kThreads) {
        const long long row = t / per_row;
        const int v = rows[row0 + row];
        if (!is_real(v, n)) continue;
        const int feat = static_cast<int>(t % per_row) * V;
        lanes_row<T, V>(x, c0 + row * w, w0 ? w0 + row * w : nullptr, n, d, feat, w,
                        out + static_cast<long long>(v) * d + feat);
      }
    }
  }
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
    if (w >= kBlockRowW)
      ell_lanes_hub<T, VMAX><<<static_cast<unsigned>(r), kThreads, 0, stream>>>(x, cols, wts, out, n, d, w);
    else
      ell_lanes_d<T, VMAX><<<blocks_for(r * (d / VMAX)), kThreads, 0, stream>>>(x, cols, wts, out, n,
                                                                               d, r, w);
  } else if (w >= kBlockRowW) {
    ell_lanes_hub<T, 1><<<static_cast<unsigned>(r), kThreads, 0, stream>>>(x, cols, wts, out, n, d, w);
  } else {
    ell_lanes_d<T, 1><<<blocks_for(r * d), kThreads, 0, stream>>>(x, cols, wts, out, n, d, r, w);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VMAX>
int launch_fused(const T* x, const int* cols, const float* wts, const int* rows, const long long* items,
                 const int* zero_rows, T* out, int n, int d, int n_items, long long n_zero, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(n_items) + blocks_for(n_zero * d);
  if (d < kSmallD)
    segment_fused<T, 1, false><<<blocks, kThreads, 0, stream>>>(x, cols, wts, rows, items, zero_rows, out, n, d,
                                                                n_items, n_zero);
  else if (d % VMAX == 0 && aligned16(x) && aligned16(out))
    segment_fused<T, VMAX, true><<<blocks, kThreads, 0, stream>>>(x, cols, wts, rows, items, zero_rows, out, n,
                                                                  d, n_items, n_zero);
  else
    segment_fused<T, 1, true><<<blocks, kThreads, 0, stream>>>(x, cols, wts, rows, items, zero_rows, out, n, d,
                                                               n_items, n_zero);
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

// The whole reduce in one launch: x (n, d), out (n, d); cols/wts/rows the flat
// buffers of every bucket, items the (n_items, 4) int64 work table, zero_rows
// the n_zero vertices that are in no bucket (see EllWork in the
// port's graph/structs.py).  dtype: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() (0 = launched), or -1 for an argument the kernel does not
// take.
extern "C" int segment_spmm_launch(const void* x, const void* cols, const void* wts, const void* rows,
                                   const void* items, const void* zero_rows, void* out, int n, int d,
                                   int n_items, long long n_zero, int dtype, void* stream) {
  if (n <= 0 || d <= 0 || n_items < 0 || n_zero < 0 || n_zero > n) return -1;
  if (n_items + n_zero == 0) return -1;
  if (static_cast<long long>(n_items) + (n_zero * d + kThreads - 1) / kThreads >= 2147483647LL) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(cols);
  const float* ww = static_cast<const float*>(wts);
  const int* rw = static_cast<const int*>(rows);
  const long long* it = static_cast<const long long*>(items);
  const int* z = static_cast<const int*>(zero_rows);
  if (dtype == 0)
    return launch_fused<float, 4>(static_cast<const float*>(x), c, ww, rw, it, z, static_cast<float*>(out), n, d,
                                  n_items, n_zero, s);
  if (dtype == 1)
    return launch_fused<__nv_bfloat16, 8>(static_cast<const __nv_bfloat16*>(x), c, ww, rw, it, z,
                                          static_cast<__nv_bfloat16*>(out), n, d, n_items, n_zero, s);
  return -1;
}
