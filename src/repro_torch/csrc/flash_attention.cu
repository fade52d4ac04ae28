// GQA flash attention (forward) for sm_90a, with a plain C entry point.
//
// Replaces `flash_attention_pallas` (src/repro/kernels/flash_attention/
// flash_attention.py:89, body `_attn_kernel`).  Same function: q (B, Sq, Hq,
// dh), k/v (B, Skv, Hkv, dh), Hq = G·Hkv, kv head = h / G; scale 1/sqrt(dh);
// causal mask kpos <= qpos + q_offset; padding mask kpos < Skv; kv tiles
// wholly above the diagonal skipped; masked scores are NEG_INF = -1e30 (not
// -inf, so the correction on a fully masked tile stays finite); running max,
// denominator and accumulator in fp32; l clamped at 1e-30; output in q's type.
// kv_valid_len (decode masking) is not taken, as on the TPU: the wrapper
// raises before a launch.
//
// What bounds it.  On the serve path (llama3.2-3b prefill, q (1, S, 24, 128),
// k/v (1, S, 8, 128) bf16, causal, S = 512..3072) attention does
// 4·Hq·dh·S(S+1)/2 operations on 2·S·(Hq+2·Hkv)·dh bytes: about 1,000
// operations a byte at S = 2048, far above the H100's ~295 bf16 operations
// per byte of device memory.  It is bounded by operations, and only the
// tensor cores get near that bound.
//
// What the design does about it.
//   * bf16 inputs: QKᵀ and P·V on the tensor cores with `mma.sync`
//     m16n8k16 (bf16 in, fp32 accumulate).  One block of 4 warps per
//     (b, query head, 64-row q tile); each warp owns 16 q rows and keeps
//     their Q fragments, the S tile, the running max/denominator and the
//     O accumulator in registers.  P goes from the S accumulator straight
//     into the A fragment of P·V (same register layout), never through
//     shared memory.  K and V tiles of 64 rows are staged in shared memory
//     (16 KB each at dh = 128, rows padded by 8 elements so fragment reads
//     are free of bank conflicts).  The loop over kv tiles inside the block
//     replaces the TPU's sequential kv grid axis and its VMEM scratch.
//   * causal: the loop stops at the q tile's diagonal, and the q tiles with
//     most work are launched first (blockIdx.x counts down the sequence).
//   * The public (B, S, H, dh) layout is read through strides; ragged Sq/Skv
//     edges are masked in the kernel (zero-filled tiles, guarded stores), so
//     the wrapper makes no padded or transposed copies.
//   * float32 inputs: the same algorithm on the CUDA cores with fmaf (32 q
//     rows × 16 kv columns a tile), as the f32 tolerance of the tests needs
//     fp32 products.  It is off the serve path.
//   * No atomics: every output row has one owner and one order, so two runs
//     are bit-equal.
// Left for later work: cp.async/TMA double buffering, ldmatrix, wgmma and
// warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int THREADS = 128;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Skv, Hq, Hkv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal, q_offset;
  float scale;
};

// kv tiles a q tile starting at q0 needs: all of them, or up to the diagonal
__device__ __forceinline__ int kv_tiles(const Args& a, int q0, int bq, int bk) {
  const int nk = (a.Skv + bk - 1) / bk;
  if (!a.causal) return nk;
  const long long last = (long long)q0 + bq - 1 + a.q_offset;
  if (last < 0) return 0;
  const long long hi = last / bk + 1;
  return hi < nk ? (int)hi : nk;
}

// ------------------------------------------------------------- bf16, mma.sync

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(const __nv_bfloat16* lo, const __nv_bfloat16* hi) {
  const uint32_t l = *reinterpret_cast<const uint16_t*>(lo);
  const uint32_t h = *reinterpret_cast<const uint16_t*>(hi);
  return l | (h << 16);
}

__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row) · b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [row0, row0 + ROWS) of a (S, dh) slice with row stride `ss` into
// shared memory of row pitch LD; rows at or past `limit` are zero
template <int D, int ROWS, int LD>
__device__ __forceinline__ void load_rows_bf16(__nv_bfloat16* s, const __nv_bfloat16* g, long long ss,
                                               int row0, int limit) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < limit) val = *reinterpret_cast<const uint4*>(g + (long long)row * ss + c);
    *reinterpret_cast<uint4*>(s + r * LD + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) attn_bf16_mma(const Args a) {
  constexpr int BQ = 64, BK = 64;
  constexpr int LD = D + 8;    // row pitch in elements: conflict-free fragment reads
  constexpr int KS = D / 16;   // k-steps of QKᵀ
  constexpr int NT = BK / 8;   // 8-column tiles of S
  constexpr int DT = D / 8;    // 8-column tiles of O
  __shared__ __align__(16) __nv_bfloat16 sK[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 sV[BK * LD];

  const int nq = (a.Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group, column pair

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + hk * a.v_sh;

  // Q tile through sK into registers, once
  load_rows_bf16<D, BQ, LD>(sK, qg, a.q_ss, q0, a.Sq);
  __syncthreads();
  const int r0 = warp * 16 + g;  // this thread's rows in the tile: r0 and r0 + 8
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const __nv_bfloat16* p = sK + r0 * LD + ks * 16 + t4 * 2;
    qf[ks][0] = ld32(p);
    qf[ks][1] = ld32(p + 8 * LD);
    qf[ks][2] = ld32(p + 8);
    qf[ks][3] = ld32(p + 8 * LD + 8);
  }
  __syncthreads();

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float sl2 = a.scale * LOG2E;  // scores in log2 units: exp2 of the difference
  const int qpos[2] = {q0 + r0 + a.q_offset, q0 + r0 + 8 + a.q_offset};
  const int nk = kv_tiles(a, q0, BQ, BK);

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    load_rows_bf16<D, BK, LD>(sK, kg, a.k_ss, k0, a.Skv);
    load_rows_bf16<D, BK, LD>(sV, vg, a.v_ss, k0, a.Skv);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const __nv_bfloat16* p = sK + (n * 8 + g) * LD + ks * 16 + t4 * 2;
        mma_bf16(s[n], qf[ks], ld32(p), ld32(p + 8));
      }
    }

    // mask, scale, running max over the row (4 threads share a row)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + n * 8 + t4 * 2 + (e & 1);
        const bool ok = kpos < a.Skv && (!a.causal || kpos <= qpos[e >> 1]);
        s[n][e] = ok ? s[n][e] * sl2 : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m[e >> 1]);
        rs[e >> 1] += s[n][e];
      }
    }
    // l stays a per-thread partial sum (its columns); summed over the row at the end
    l[0] = l[0] * corr[0] + rs[0];
    l[1] = l[1] * corr[1] + rs[1];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= corr[0];
      o[dt][1] *= corr[0];
      o[dt][2] *= corr[1];
      o[dt][3] *= corr[1];
    }

    // O += P·V: the S accumulator of columns 16j..16j+15 is the A fragment
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t pa[4] = {pack_f2(s[2 * j][0], s[2 * j][1]), pack_f2(s[2 * j][2], s[2 * j][3]),
                              pack_f2(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_f2(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const __nv_bfloat16* vp = sV + (j * 16 + t4 * 2) * LD + dt * 8 + g;
        mma_bf16(o[dt], pa, pack2(vp, vp + LD), pack2(vp + 8 * LD, vp + 9 * LD));
      }
    }
    __syncthreads();  // before the next tile overwrites sK / sV
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + r * 8;
    if (row >= a.Sq) continue;
    __nv_bfloat16* orow = og + (((long long)b * a.Sq + row) * a.Hq + h) * D + t4 * 2;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8) =
          pack_f2(o[dt][2 * r] * inv[r], o[dt][2 * r + 1] * inv[r]);
  }
}

// ------------------------------------------------------------- float32, fmaf

template <int D>
__global__ void __launch_bounds__(THREADS) attn_f32_fma(const Args a) {
  constexpr int BQ = 32, BK = 16;
  constexpr int LD = D + 4;     // row pitch of sQ / sV (16-byte rows)
  constexpr int KP = BK + 1;    // pitch of the transposed K tile and of P
  constexpr int DJ = D / 16;    // output columns a thread owns
  __shared__ __align__(16) float sQ[BQ * LD];
  __shared__ __align__(16) float sV[BK * LD];
  __shared__ float sKt[D * KP];
  __shared__ float sP[BQ * KP];

  const int nq = (a.Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int rg = threadIdx.x >> 4;  // rows rg*4 .. rg*4+3 (16 threads share them)
  const int cg = threadIdx.x & 15;  // S column cg; O columns cg + 16·j

  const float* qg = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kg = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vg = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  constexpr int CH = D / 4;

  // q·scale first, as the TPU kernel does
  for (int i = threadIdx.x; i < BQ * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 4, row = q0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < a.Sq) x = *reinterpret_cast<const float4*>(qg + (long long)row * a.q_ss + c);
    x.x *= a.scale; x.y *= a.scale; x.z *= a.scale; x.w *= a.scale;
    *reinterpret_cast<float4*>(sQ + r * LD + c) = x;
  }

  float acc[4][DJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }
  const int nk = kv_tiles(a, q0, BQ, BK);

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's reads are done; sQ is visible
    for (int i = threadIdx.x; i < BK * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 4, row = k0 + r;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (row < a.Skv) {
        kx = *reinterpret_cast<const float4*>(kg + (long long)row * a.k_ss + c);
        vx = *reinterpret_cast<const float4*>(vg + (long long)row * a.v_ss + c);
      }
      sKt[(c + 0) * KP + r] = kx.x;
      sKt[(c + 1) * KP + r] = kx.y;
      sKt[(c + 2) * KP + r] = kx.z;
      sKt[(c + 3) * KP + r] = kx.w;
      *reinterpret_cast<float4*>(sV + r * LD + c) = vx;
    }
    __syncthreads();

    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = sKt[d * KP + cg];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] = fmaf(sQ[(rg * 4 + i) * LD + d], kd, s[i]);
    }
    const int kpos = k0 + cg;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + rg * 4 + i + a.q_offset;
      const bool ok = kpos < a.Skv && (!a.causal || kpos <= qpos);
      const float si = ok ? s[i] : NEG_INF;
      float mx = si;
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8, 16));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4, 16));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2, 16));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1, 16));
      const float mn = fmaxf(m[i], mx);
      const float corr = expf(m[i] - mn);
      const float p = expf(si - mn);
      m[i] = mn;
      l[i] = l[i] * corr + p;  // per-thread partial; summed over the row at the end
      sP[(rg * 4 + i) * KP + cg] = p;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sP[(rg * 4 + i) * KP + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, sV[c * LD + cg + 16 * j], acc[i][j]);
      }
    }
  }

  float* og = static_cast<float*>(a.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 8, 16);
    lt += __shfl_xor_sync(0xffffffffu, lt, 4, 16);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2, 16);
    lt += __shfl_xor_sync(0xffffffffu, lt, 1, 16);
    const int row = q0 + rg * 4 + i;
    if (row >= a.Sq) continue;
    const float denom = fmaxf(lt, 1e-30f);
    float* orow = og + (((long long)b * a.Sq + row) * a.Hq + h) * D + cg;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[16 * j] = acc[i][j] / denom;
  }
}

template <int D>
int launch(const Args& a, int dtype, cudaStream_t stream) {
  if (dtype == 1) {
    const dim3 grid((a.Sq + 63) / 64, a.Hq, a.B);
    attn_bf16_mma<D><<<grid, THREADS, 0, stream>>>(a);
  } else {
    const dim3 grid((a.Sq + 31) / 32, a.Hq, a.B);
    attn_f32_fma<D><<<grid, THREADS, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: (B, S, H, dh) with unit stride along dh, strides in elements (the
// wrapper checks 16-byte alignment); out: contiguous (B, Sq, Hq, dh).
// dtype: 0 float32, 1 bfloat16.  Returns 0, a CUDA error code, or -1 for
// arguments the kernel does not take.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int Sq, int Skv, int Hq, int Hkv, int dh,
                                      long long q_sb, long long q_ss, long long q_sh,
                                      long long k_sb, long long k_ss, long long k_sh,
                                      long long v_sb, long long v_ss, long long v_sh,
                                      int causal, int q_offset, float scale, int dtype,
                                      void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0) return -1;
  if (dtype != 0 && dtype != 1) return -1;
  if (B > 65535 || Hq > 65535) return -1;
  const Args a{q, k, v, out, B, Sq, Skv, Hq, Hkv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
               v_sb, v_ss, v_sh, causal, q_offset, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return launch<32>(a, dtype, st);
    case 64: return launch<64>(a, dtype, st);
    case 128: return launch<128>(a, dtype, st);
    default: return -1;
  }
}
