// GQA flash attention, backward, for sm_90a, with a plain C entry point.
//
// Replaces the gradient of the reference's attention.  The TPU kernel
// (`flash_attention_pallas`, src/repro/kernels/flash_attention/
// flash_attention.py:89) has no backward: the JAX package trains through
// autodiff of `gqa_attention` or of the blocked `flash_attention_ref`
// (src/repro/models/transformer.py:204-213).  This is that gradient for the
// forward of `flash_attention.cu`: q (B, Sq, Hq, dh), k/v (B, Skv, Hkv, dh),
// Hq = G·Hkv, kv head = h / G, scale 1/sqrt(dh), causal mask kpos <= qpos +
// q_offset, padding mask kpos < Skv.  From o, dO and the forward's
// log-sum-exp `lse` (B, Hq, Sq):
//     P  = exp(S·scale − lse)  on the kept pairs, 0 on the masked ones
//     D  = rowsum(dO ∘ O)
//     dV = Pᵀ·dO,  dS = P ∘ (dO·Vᵀ − D),  dQ = scale·dS·K,  dK = scale·dSᵀ·Q
// with dK and dV of a kv head summed over the G query heads of its group.  A
// row whose keys are all masked gets P = 0, so it adds no gradient anywhere
// (and never a NaN).  fp32 accumulation throughout; outputs in q's type.
//
// What bounds it.  Five products a kept (q, k) pair where the forward does
// two, so its operation bound is 2.5x the forward's.  At the serve shape
// (q (1, 2048, 24, 128), k/v (1, 2048, 8, 128), causal) that is about 2,500
// operations a byte of q, k, v, o, dO, lse and the gradients, far above the
// H100's ~295 bf16 operations a byte of device memory: bounded by operations,
// and only the tensor cores, fed by `wgmma`, get near that bound.  At the
// training shape (B 8, S 128) it is bounded by bytes, and a call is short
// enough that its three launches and the pipelines' fill set the pace.
//
// What the design does about it (bf16 inputs).  Three launches a call, on one
// stream, no atomics: every output row has one owner and one order, so two
// runs are bit-equal.
//   * `attn_bwd_delta`: D and lse·log2(e) of every query row into a float32
//     scratch whose rows are padded to a multiple of 64 (the padding rows get
//     D = 0 and a huge lse, so P = 0 there).  It stays a launch of its own:
//     every dK/dV block that sees a q tile reads that tile's D, so computing
//     it once a row is cheaper than in each of them.
//   * `attn_bwd_dkdv_wgmma`: one block owns 64 kv rows of one kv head.  A
//     producer warp brings K and V in once by TMA (`cp.async.bulk.tensor.4d`),
//     then streams the (Q, dO) tiles of the group's G query heads, each from
//     the causal diagonal on, with their lse and D (`cp.async.bulk`), through
//     a ring of three shared-memory stages with full/empty `mbarrier`s.  Two
//     consumer warpgroups own the same 64 kv rows and split the work by role.
//     Warpgroup 0 computes Sᵀ = K·Qᵀ with `wgmma` m64n64k16 (both operands in
//     shared memory, K-major: the forward's Q·Kᵀ with the roles swapped),
//     Pᵀ = 2^(Sᵀ·scale·log2e − lse·log2e) in the fp32 accumulator (lse
//     indexed by the accumulator's column, read from the stage), and dV +=
//     Pᵀ·dO with Pᵀ rounded to bf16 in place into the register-A layout and
//     dO read with the transpose bit (dh contiguous), as the forward reads V.
//     Warpgroup 1 computes dPᵀ = V·dOᵀ, takes Pᵀ from warpgroup 0 through
//     shared memory (two buffers under named barriers), forms dSᵀ = Pᵀ ∘
//     (dPᵀ − D), and accumulates dK += dSᵀ·Q the same way.  Each holds one
//     64 × dh accumulator across all heads and q tiles and one 64 × 64 tile.
//   * `attn_bwd_dq_wgmma`: one block owns a q tile (64 rows a consumer
//     warpgroup, one or two of them) of one query head, Q and dO brought in
//     once, and streams the kv tiles it sees (causal: up to the diagonal;
//     longest rows launched first).  S = Q·Kᵀ and dP = dO·Vᵀ from shared
//     memory, dS in registers, dQ += dS·K with K read with the transpose
//     bit; dQ·scale stored once.  S and dP are computed twice (seven products
//     a pair, not five): the price of no atomics.  Two warpgroups a block
//     when the launch still puts a block on every SM, as the forward picks
//     them; else one, and two blocks an SM.
//   * Inside each consumer warpgroup the product of tile i + 1 (Sᵀ, dPᵀ or S
//     and dP) is issued before the accumulation of tile i, and the wait lets
//     the latter run on while Pᵀ or dS of tile i + 1 is formed.
//   * Registers.  `ptxas` gives a kernel one register count, set by its
//     launch bounds and its warps on an SM's four sub-partitions; it does not
//     compile consumers for what `setmaxnreg` would hand them at run time.
//     So the producer is one warp, not a warpgroup, and the work is split so
//     that a consumer holds one 64 × dh accumulator: at 9 warps a block a
//     thread gets 168 registers (dK/dV: no spill; dQ at dh = 128: 32 bytes).
//   * Tensor maps and tiles as in the forward: 4-D maps over the (B, S, H,
//     dh) layout, dh in chunks of 64 (128-byte swizzle) or 32 at dh = 32
//     (64-byte swizzle), rows past S read as zeros and masked.
//   * A wait on an `mbarrier` that never completes traps after about 20 s
//     instead of spinning for ever.
// float32 inputs keep the first design on the CUDA cores with fmaf
// (`attn_bwd_dkdv`, `attn_bwd_dq`, 32 × 32 tiles), as the f32 tolerance of
// the tests needs fp32 products; off the training path.
//
// Build: cuTensorMapEncodeTiled is a driver-API symbol; it is fetched through
// the runtime's driver entry point, so the library links nothing beyond the
// CUDA runtime.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LSE2_PAD = 1e30f;  // lse·log2(e) of a padding row: P = 2^(s − 1e30) = 0
constexpr int THREADS = 128;
constexpr int ROWS = 64;  // rows of a streamed tile and of a warpgroup's share of a resident one;
                          // the scratch's rows are padded to a multiple of it

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, Hq, Sq)
  float* delta;      // (B, Hq, sq_pad): D, written by attn_bwd_delta
  float* lse2;       // (B, Hq, sq_pad): lse·log2(e), written by attn_bwd_delta
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Skv, Hq, Hkv;
  int sq_pad;
  int causal, q_offset;
  float scale;
};

__device__ __forceinline__ bool kept(const Args& a, int qrow, int kpos) {
  return qrow < a.Sq && kpos < a.Skv && (!a.causal || kpos <= qrow + a.q_offset);
}

// 16 bytes of o and of dO as floats, multiplied and summed into s
__device__ __forceinline__ float dot16(const float* o, const float* g, float s) {
  const float4 x = *reinterpret_cast<const float4*>(o), y = *reinterpret_cast<const float4*>(g);
  s = fmaf(x.x, y.x, s);
  s = fmaf(x.y, y.y, s);
  s = fmaf(x.z, y.z, s);
  return fmaf(x.w, y.w, s);
}

__device__ __forceinline__ float dot16(const __nv_bfloat16* o, const __nv_bfloat16* g, float s) {
  const uint4 x = *reinterpret_cast<const uint4*>(o), y = *reinterpret_cast<const uint4*>(g);
  const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(xs[i]), b = __bfloat1622float2(ys[i]);
    s = fmaf(a.x, b.x, s);
    s = fmaf(a.y, b.y, s);
  }
  return s;
}

// D = rowsum(dO ∘ O) and lse·log2(e) of every (b, h, row < sq_pad): L lanes a
// row, 16 bytes a lane; the padding rows get D = 0 and lse·log2(e) = LSE2_PAD
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) attn_bwd_delta(const Args a) {
  constexpr int V = 16 / sizeof(T);  // elements a lane reads
  constexpr int L = D / V;           // lanes a row: 4, 8, 16 or 32
  const long long rows = (long long)a.B * a.sq_pad * a.Hq;
  const long long r = ((long long)blockIdx.x * THREADS + threadIdx.x) / L;  // (b, s, h), h fastest
  const int lane = threadIdx.x % L;
  const bool live = r < rows;
  const int h = (int)(r % a.Hq), srow = (int)((r / a.Hq) % a.sq_pad), b = (int)(r / ((long long)a.Hq * a.sq_pad));
  float s = 0.f;
  if (live && srow < a.Sq) {
    const long long at = (((long long)b * a.Sq + srow) * a.Hq + h) * D + lane * V;
    s = dot16(static_cast<const T*>(a.o) + at, static_cast<const T*>(a.dout) + at, s);
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off, L);
  if (live && lane == 0) {
    const long long row = ((long long)b * a.Hq + h) * a.sq_pad + srow;
    a.delta[row] = s;
    a.lse2[row] = srow < a.Sq ? a.lse[((long long)b * a.Hq + h) * a.Sq + srow] * LOG2E : LSE2_PAD;
  }
}

// ------------------------------------------------------------- float32, fmaf

constexpr int BQ = 32, BK = 32;  // rows of a q tile and of a kv tile (float32 kernels)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// rows r0 .. r0 + NR - 1 of head h of a contiguous (B, S, H, D) tensor into
// shared memory as float, pitch D + 1; rows past S are zeros
template <typename T, int D, int NR>
__device__ __forceinline__ void load_tile(float* s, const T* g, int b, int h, int r0, int S, int H) {
  constexpr int P = D + 1;
  for (int i = threadIdx.x; i < NR * D; i += THREADS) {
    const int r = i / D, c = i % D, row = r0 + r;
    s[r * P + c] = row < S ? to_f(g[(((long long)b * S + row) * H + h) * D + c]) : 0.f;
  }
}

// the forward's lse and D of rows q0 .. q0 + BQ - 1 of head h
__device__ __forceinline__ void load_rows(float* sl, float* sd, const Args& a, int b, int h, int q0) {
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    const int row = q0 + i;
    const long long bh = (long long)b * a.Hq + h;
    sl[i] = row < a.Sq ? a.lse[bh * a.Sq + row] : 0.f;
    sd[i] = row < a.Sq ? a.delta[bh * a.sq_pad + row] : 0.f;
  }
}

template <int D>
constexpr int smem_floats() {  // four (32 x D) tiles, two 32 x 33 score tiles, lse and D
  return 4 * 32 * (D + 1) + 2 * 32 * (32 + 1) + 2 * 32;
}

// dK, dV of kv rows k0 .. k0 + BK - 1 of kv head hk.  Thread (rg, cg) owns
// kv rows rg·4 .. rg·4 + 3 and columns cg + 16·j of every product.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) attn_bwd_dkdv(const Args a) {
  constexpr int P = D + 1, PS = BQ + 1, DJ = D / 16;
  extern __shared__ float sm[];
  float* sK = sm;
  float* sV = sK + BK * P;
  float* sQ = sV + BK * P;
  float* sO = sQ + BQ * P;  // dO
  float* sP = sO + BQ * P;  // Pᵀ (BK x BQ)
  float* sS = sP + BK * PS;  // dSᵀ
  float* sL = sS + BK * PS;
  float* sD = sL + BQ;
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int G = a.Hq / a.Hkv;
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  const T* qg = static_cast<const T*>(a.q);
  const T* og = static_cast<const T*>(a.dout);
  load_tile<T, D, BK>(sK, static_cast<const T*>(a.k), b, hk, k0, a.Skv, a.Hkv);
  load_tile<T, D, BK>(sV, static_cast<const T*>(a.v), b, hk, k0, a.Skv, a.Hkv);

  float dk[4][DJ], dv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  // causal: q rows below k0 - q_offset see none of these keys
  int qt0 = 0;
  if (a.causal) {
    const long long first = (long long)k0 - a.q_offset;
    qt0 = first <= 0 ? 0 : (int)(first / BQ);
  }
  const int nq = (a.Sq + BQ - 1) / BQ;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int qt = qt0; qt < nq; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the last tile's reads are done (and K, V are in)
      load_tile<T, D, BQ>(sQ, qg, b, h, q0, a.Sq, a.Hq);
      load_tile<T, D, BQ>(sO, og, b, h, q0, a.Sq, a.Hq);
      load_rows(sL, sD, a, b, h, q0);
      __syncthreads();
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: kv rows rg·4 + i, q columns cg + 16·j
      float s[4][2], dp[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kd[4], vd[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kd[i] = sK[(rg * 4 + i) * P + d];
          vd[i] = sV[(rg * 4 + i) * P + d];
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float qd = sQ[(cg + 16 * j) * P + d], od = sO[(cg + 16 * j) * P + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[i][j] = fmaf(kd[i], qd, s[i][j]);
            dp[i][j] = fmaf(vd[i], od, dp[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kk = rg * 4 + i, qq = cg + 16 * j;
          const float p = kept(a, q0 + qq, k0 + kk) ? expf(s[i][j] * a.scale - sL[qq]) : 0.f;
          sP[kk * PS + qq] = p;
          sS[kk * PS + qq] = p * (dp[i][j] - sD[qq]);
        }
      }
      __syncthreads();
      // dV += Pᵀ·dO, dK += dSᵀ·Q
#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = sP[(rg * 4 + i) * PS + qq];
          ds[i] = sS[(rg * 4 + i) * PS + qq];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float od = sO[qq * P + cg + 16 * j], qd = sQ[qq * P + cg + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][j] = fmaf(p[i], od, dv[i][j]);
            dk[i][j] = fmaf(ds[i], qd, dk[i][j]);
          }
        }
      }
    }
  }
  T* dkg = static_cast<T*>(a.dk);
  T* dvg = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + rg * 4 + i;
    if (row >= a.Skv) continue;
    const long long at = (((long long)b * a.Skv + row) * a.Hkv + hk) * D + cg;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      store(dkg + at + 16 * j, dk[i][j] * a.scale);
      store(dvg + at + 16 * j, dv[i][j]);
    }
  }
}

// dQ of q rows q0 .. q0 + BQ - 1 of q head h.  Thread (rg, cg) owns q rows
// rg·4 .. rg·4 + 3 and columns cg + 16·j.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) attn_bwd_dq(const Args a) {
  constexpr int P = D + 1, PS = BK + 1, DJ = D / 16;
  extern __shared__ float sm[];
  float* sQ = sm;
  float* sO = sQ + BQ * P;
  float* sK = sO + BQ * P;
  float* sV = sK + BK * P;
  float* sS = sV + BK * P;  // dS (BQ x BK)
  float* sL = sS + BQ * PS;
  float* sD = sL + BQ;
  const int nq = (a.Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;  // causal: the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  const T* kg = static_cast<const T*>(a.k);
  const T* vg = static_cast<const T*>(a.v);
  load_tile<T, D, BQ>(sQ, static_cast<const T*>(a.q), b, h, q0, a.Sq, a.Hq);
  load_tile<T, D, BQ>(sO, static_cast<const T*>(a.dout), b, h, q0, a.Sq, a.Hq);
  load_rows(sL, sD, a, b, h, q0);

  int nk = (a.Skv + BK - 1) / BK;
  if (a.causal) {
    const long long last = (long long)q0 + BQ - 1 + a.q_offset;
    const long long hi = last < 0 ? 0 : last / BK + 1;
    nk = hi < nk ? (int)hi : nk;
  }
  float dq[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq[i][j] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the last tile's reads are done (and Q, dO are in)
    load_tile<T, D, BK>(sK, kg, b, hk, k0, a.Skv, a.Hkv);
    load_tile<T, D, BK>(sV, vg, b, hk, k0, a.Skv, a.Hkv);
    __syncthreads();
    // S = Q·Kᵀ and dP = dO·Vᵀ: q rows rg·4 + i, kv columns cg + 16·j
    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qd[4], od[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qd[i] = sQ[(rg * 4 + i) * P + d];
        od[i] = sO[(rg * 4 + i) * P + d];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float kd = sK[(cg + 16 * j) * P + d], vd = sV[(cg + 16 * j) * P + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(qd[i], kd, s[i][j]);
          dp[i][j] = fmaf(od[i], vd, dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qq = rg * 4 + i, kk = cg + 16 * j;
        const float p = kept(a, q0 + qq, k0 + kk) ? expf(s[i][j] * a.scale - sL[qq]) : 0.f;
        sS[qq * PS + kk] = p * (dp[i][j] - sD[qq]);
      }
    }
    __syncthreads();
    // dQ += dS·K
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = sS[(rg * 4 + i) * PS + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kd = sK[kk * P + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][j] = fmaf(ds[i], kd, dq[i][j]);
      }
    }
  }
  T* dqg = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= a.Sq) continue;
    const long long at = (((long long)b * a.Sq + row) * a.Hq + h) * D + cg;
#pragma unroll
    for (int j = 0; j < DJ; ++j) store(dqg + at + 16 * j, dq[i][j] * a.scale);
  }
}

// ------------------------------------------------------------- bf16, wgmma
// The helpers below up to `Tile` are copies of the forward's
// (`flash_attention.cu`), but for the bounded `mbar_wait`, the 1-D bulk copy
// and the m64n64k16 product from shared memory.

__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit (what exp2f becomes under fast math):
// relative error about 2^-22, far below the bf16 rounding of P
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// spin until the barrier's phase differs from `parity`; trap after about 20 s
// (2^35 clocks), so that a copy that never lands fails the launch instead of
// hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (uint32_t n = 0;; ++n) {
    uint32_t done = 0;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((n & 1023u) == 0) {
      const long long now = clock64();
      if (n == 0)
        start = now;
      else if (now - start > (1ll << 35))
        __trap();
    }
  }
}

// one TMA box of a 4-D tensor map into shared memory, completion on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) of device memory into
// shared memory, completion on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// wgmma matrix descriptor: start address, leading and stride byte offsets (all
// in 16-byte units), swizzle mode (1: 128-byte, 2: 64-byte)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint32_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)mode << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// wait until at most N committed groups of this warpgroup are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }

// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64, fp32) = (ACC ? d : 0) + A·Bᵀ, A and B from shared memory, both
// K-major.  The first step of a product writes d without reading it, so the
// compiler may reuse d's registers between two products.
template <bool ACC>
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss_n64<true>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),
        "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss_n64<false>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]),
        "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]),
        "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// o (64 x 32, fp32) += A·B, A (64 x 16 bf16) from registers, B from shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_n32(float* o, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(o[0]), "+f"(o[1]), "+f"(o[2]), "+f"(o[3]), "+f"(o[4]), "+f"(o[5]), "+f"(o[6]),
        "+f"(o[7]), "+f"(o[8]), "+f"(o[9]), "+f"(o[10]), "+f"(o[11]), "+f"(o[12]), "+f"(o[13]),
        "+f"(o[14]), "+f"(o[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// o (64 x 64, fp32) += A·B, A (64 x 16 bf16) from registers, B from shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_n64(float* o, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(o[0]), "+f"(o[1]), "+f"(o[2]), "+f"(o[3]), "+f"(o[4]), "+f"(o[5]), "+f"(o[6]),
        "+f"(o[7]), "+f"(o[8]), "+f"(o[9]), "+f"(o[10]), "+f"(o[11]), "+f"(o[12]), "+f"(o[13]),
        "+f"(o[14]), "+f"(o[15]), "+f"(o[16]), "+f"(o[17]), "+f"(o[18]), "+f"(o[19]), "+f"(o[20]),
        "+f"(o[21]), "+f"(o[22]), "+f"(o[23]), "+f"(o[24]), "+f"(o[25]), "+f"(o[26]), "+f"(o[27]),
        "+f"(o[28]), "+f"(o[29]), "+f"(o[30]), "+f"(o[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// o (64 x 128, fp32) += A·B, A (64 x 16 bf16) from registers, B from shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_n128(float* o, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(o[0]), "+f"(o[1]), "+f"(o[2]), "+f"(o[3]), "+f"(o[4]), "+f"(o[5]), "+f"(o[6]),
        "+f"(o[7]), "+f"(o[8]), "+f"(o[9]), "+f"(o[10]), "+f"(o[11]), "+f"(o[12]), "+f"(o[13]),
        "+f"(o[14]), "+f"(o[15]), "+f"(o[16]), "+f"(o[17]), "+f"(o[18]), "+f"(o[19]), "+f"(o[20]),
        "+f"(o[21]), "+f"(o[22]), "+f"(o[23]), "+f"(o[24]), "+f"(o[25]), "+f"(o[26]), "+f"(o[27]),
        "+f"(o[28]), "+f"(o[29]), "+f"(o[30]), "+f"(o[31]), "+f"(o[32]), "+f"(o[33]), "+f"(o[34]),
        "+f"(o[35]), "+f"(o[36]), "+f"(o[37]), "+f"(o[38]), "+f"(o[39]), "+f"(o[40]), "+f"(o[41]),
        "+f"(o[42]), "+f"(o[43]), "+f"(o[44]), "+f"(o[45]), "+f"(o[46]), "+f"(o[47]), "+f"(o[48]),
        "+f"(o[49]), "+f"(o[50]), "+f"(o[51]), "+f"(o[52]), "+f"(o[53]), "+f"(o[54]), "+f"(o[55]),
        "+f"(o[56]), "+f"(o[57]), "+f"(o[58]), "+f"(o[59]), "+f"(o[60]), "+f"(o[61]), "+f"(o[62]),
        "+f"(o[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N> __device__ __forceinline__ void wgmma_rs(float* o, const uint32_t* a, uint64_t db);
template <> __device__ __forceinline__ void wgmma_rs<32>(float* o, const uint32_t* a, uint64_t db) { wgmma_rs_n32(o, a, db); }
template <> __device__ __forceinline__ void wgmma_rs<64>(float* o, const uint32_t* a, uint64_t db) { wgmma_rs_n64(o, a, db); }
template <> __device__ __forceinline__ void wgmma_rs<128>(float* o, const uint32_t* a, uint64_t db) { wgmma_rs_n128(o, a, db); }

// Shared-memory layout of one (rows × dh) tile: dh in chunks of CW elements,
// chunk c a contiguous (rows × CW) block, each row ROWB bytes, swizzled by the
// TMA the way the descriptors read it.
template <int D> struct Tile {
  static constexpr int CW = D < 64 ? D : 64;       // elements a chunk row
  static constexpr int ROWB = CW * 2;              // bytes a chunk row: 64 or 128
  static constexpr int CHUNKS = D / CW;
  static constexpr uint32_t MODE = ROWB == 128 ? 1 : 2;  // descriptor swizzle: 128- or 64-byte
  static constexpr int KPC = CW / 16;              // k16 steps a chunk
};

// A block is NC consumer warpgroups and one producer warp (the header says
// why a warp).  The dQ kernel's ring has DQ_STAGES (K, V) stages; at one
// consumer warpgroup two of its blocks share an SM.
template <int NC> struct Block {
  static constexpr int THREADS_ALL = NC * THREADS + 32;
  static constexpr int DQ_STAGES = NC == 2 ? 3 : 2;
  static constexpr int DQ_MIN_BLOCKS = NC == 2 ? 1 : 2;
};
constexpr int DKDV_STAGES = 3;  // one block an SM: (Q, dO) stages of the dK/dV ring
constexpr int P_BYTES = ROWS * ROWS * 4;  // one fp32 Pᵀ tile, handed from the dV warpgroup to the dK one

template <int D>
constexpr int dkdv_smem() {  // K and V (64 rows), DKDV_STAGES × (Q, dO, lse2, D), two Pᵀ, barriers
  return 1024 + 2 * ROWS * D * 2 + DKDV_STAGES * (2 * ROWS * D * 2 + 2 * ROWS * 4) + 2 * P_BYTES +
         8 * (1 + 2 * DKDV_STAGES);
}

// named barriers (0 is __syncthreads): Pᵀ of buffer b written (P_FULL + b)
// and read (P_EMPTY + b), between the two consumer warpgroups
constexpr int P_FULL = 1, P_EMPTY = 3;

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(2 * THREADS) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(2 * THREADS) : "memory");
}

template <int D, int NC>
constexpr int dq_smem() {  // Q and dO (NC·64 rows), stages × (K, V), barriers
  return 1024 + 2 * NC * ROWS * D * 2 + Block<NC>::DQ_STAGES * 2 * ROWS * D * 2 + 8 * (1 + 2 * Block<NC>::DQ_STAGES);
}

// acc (64 × 64, fp32) = A·Bᵀ over dh, issued and committed: A the warpgroup's
// 64 rows (at `a`) of a tile of AR rows, B a 64-row tile; both K-major; dh/16
// steps, each 32 bytes further along a chunk row
template <int D, int AR>
__device__ __forceinline__ void issue_abt(float* acc, uint32_t a, uint32_t b) {
  using T = Tile<D>;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks / T::KPC, kin = ks % T::KPC;
    const uint64_t da = make_desc(a + c * AR * T::ROWB + kin * 32, 16, 8 * T::ROWB, T::MODE);
    const uint64_t db = make_desc(b + c * ROWS * T::ROWB + kin * 32, 16, 8 * T::ROWB, T::MODE);
    if (ks == 0)
      wgmma_ss_n64<false>(acc, da, db);
    else
      wgmma_ss_n64<true>(acc, da, db);
  }
  wgmma_commit();
}

// acc (64 × dh) += A·B, issued (not committed): A (64 × 64) from registers in
// four k16 steps, B a 64-row tile read MN-major (dh, which is N, contiguous)
template <int D>
__device__ __forceinline__ void issue_rs(float* acc, uint32_t (*a)[4], uint32_t b) {
  using T = Tile<D>;
#pragma unroll
  for (int j = 0; j < ROWS / 16; ++j)
    wgmma_rs<D>(acc, a[j], make_desc(b + j * 16 * T::ROWB, ROWS * T::ROWB, 8 * T::ROWB, T::MODE));
}

// a 64 × 64 fp32 accumulator in bf16: columns 16j..16j+15 (blocks 2j, 2j+1)
// are the register-A fragment of step j
__device__ __forceinline__ void pack_a(const float* x, uint32_t (*pa)[4]) {
#pragma unroll
  for (int n = 0; n < ROWS / 8; ++n) {
    pa[n >> 1][(n & 1) * 2 + 0] = pack_f2(x[4 * n + 0], x[4 * n + 1]);
    pa[n >> 1][(n & 1) * 2 + 1] = pack_f2(x[4 * n + 2], x[4 * n + 3]);
  }
}

// Pᵀ in place on the fp32 Sᵀ of a (kv rows × q columns) tile, lse·log2(e) by
// column from the stage in shared memory.  kv: the thread's first kv row (the
// second is kv + 8); qc: its first column's query row (q0 + 2·t4).  MASK: the
// tile crosses the diagonal or an end.
template <bool MASK>
__device__ __forceinline__ void probs_t(float* st, const float* lse2, int t4, float sl2, const Args& a, int kv,
                                        int qc) {
#pragma unroll
  for (int n = 0; n < ROWS / 8; ++n) {
    const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * n + 2 * t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = fast_exp2(fmaf(st[4 * n + e], sl2, -((e & 1) ? l.y : l.x)));
      st[4 * n + e] = MASK && !kept(a, qc + 8 * n + (e & 1), kv + 8 * (e >> 1)) ? 0.f : p;
    }
  }
}

// A thread's 32 accumulator values in a shared-memory buffer of a warpgroup's
// (128 threads × 32): four at a time, 16 bytes a thread, so a warp's stores
// and loads hit every bank once.  The two warpgroups of a dK/dV block own the
// same rows and columns, so thread t of one hands its values to thread t of the other.
__device__ __forceinline__ void put_frag(float* buf, int tid, const float* x) {
#pragma unroll
  for (int n = 0; n < ROWS / 8; ++n)
    *reinterpret_cast<float4*>(buf + n * 4 * THREADS + tid * 4) =
        make_float4(x[4 * n], x[4 * n + 1], x[4 * n + 2], x[4 * n + 3]);
}

// dSᵀ = Pᵀ ∘ (dPᵀ − D) in place on the fp32 dPᵀ, Pᵀ from the buffer
// `put_frag` filled, D by column from the stage
__device__ __forceinline__ void dscores_t(float* dpt, const float* pbuf, int tid, const float* dd, int t4) {
#pragma unroll
  for (int n = 0; n < ROWS / 8; ++n) {
    const float4 p = *reinterpret_cast<const float4*>(pbuf + n * 4 * THREADS + tid * 4);
    const float2 d = *reinterpret_cast<const float2*>(dd + 8 * n + 2 * t4);
    dpt[4 * n + 0] = p.x * (dpt[4 * n + 0] - d.x);
    dpt[4 * n + 1] = p.y * (dpt[4 * n + 1] - d.y);
    dpt[4 * n + 2] = p.z * (dpt[4 * n + 2] - d.x);
    dpt[4 * n + 3] = p.w * (dpt[4 * n + 3] - d.y);
  }
}

// dS = P ∘ (dP − D) in place on the fp32 dP of a (q rows × kv columns) tile;
// lse·log2(e) and D of the thread's two rows in registers.  q: the thread's
// first query row (the second is q + 8); kc: its first column's kv row.
template <bool MASK>
__device__ __forceinline__ void dscores(const float* sc, float* dp, const float l2[2], const float dd[2],
                                        float sl2, const Args& a, int q, int kc) {
#pragma unroll
  for (int n = 0; n < ROWS / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = fast_exp2(fmaf(sc[4 * n + e], sl2, -l2[e >> 1]));
      if constexpr (MASK) p = kept(a, q + 8 * (e >> 1), kc + 8 * n + (e & 1)) ? p : 0.f;
      dp[4 * n + e] = p * (dp[4 * n + e] - dd[e >> 1]);
    }
  }
}

// the next stage of a ring and the parity its barriers wait for
template <int STAGES>
__device__ __forceinline__ void advance(int& s, uint32_t& phase) {
  if (++s == STAGES) {
    s = 0;
    phase ^= 1;
  }
}

// dK, dV of kv rows k0 .. k0 + 63 of kv head hk.  Two consumer warpgroups
// own the same 64 kv rows and split the work by role: warpgroup 0 computes Sᵀ
// = K·Qᵀ, Pᵀ and dV += Pᵀ·dO; warpgroup 1 computes dPᵀ = V·dOᵀ, dSᵀ = Pᵀ ∘
// (dPᵀ − D) with Pᵀ handed over through shared memory (two buffers, named
// barriers), and dK += dSᵀ·Q.  Each holds one accumulator of 64 × dh and one
// of 64 × 64, so each fits the 168 registers a thread that a block of 9 warps
// gets, and the two share the SM's tensor cores.  Within each, the product of
// q tile i + 1 is issued before dV (or dK) of tile i, and the wait lets the
// latter run on while Pᵀ (or dSᵀ) of tile i + 1 is formed.
template <int D>
__global__ void __launch_bounds__(Block<2>::THREADS_ALL, 1)
    attn_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                        const Args a) {
  using T = Tile<D>;
  constexpr int STAGES = DKDV_STAGES;
  constexpr uint32_t T_BYTES = ROWS * D * 2, R_BYTES = ROWS * 4;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sk = (raw + 1023u) & ~1023u;  // swizzled tiles start on 1024 bytes
  const uint32_t sv = sk + T_BYTES;
  const uint32_t sq = sv + T_BYTES;                 // stage s: Q at sq + 2·s·T_BYTES, dO after it
  const uint32_t srow = sq + 2 * STAGES * T_BYTES;  // stage s: lse2 at srow + 2·s·R_BYTES, D after it
  const uint32_t sp = srow + 2 * STAGES * R_BYTES;  // Pᵀ buffers 0 and 1
  const uint32_t bars = sp + 2 * P_BYTES;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto q_stage = [&](int s) { return sq + 2 * s * T_BYTES; };

  const int hk = blockIdx.x, b = blockIdx.z;
  const int k0 = blockIdx.y * ROWS;  // causal: the first kv tiles see the most q tiles, and launch first
  const int G = a.Hq / a.Hkv;
  const int nq = (a.Sq + ROWS - 1) / ROWS;
  int qt0 = 0;  // causal: q rows below k0 - q_offset see none of these keys
  if (a.causal) {
    const long long first = (long long)k0 - a.q_offset;
    qt0 = first <= 0 ? 0 : (first / ROWS < nq ? (int)(first / ROWS) : nq);
  }
  const int n_tiles = G * (nq - qt0);  // the group's heads, each from qt0 on

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 2 * THREADS) {
    // ---- producer warp: one thread issues every copy
    if (threadIdx.x == 2 * THREADS) {
      mbar_arrive_expect_tx(kv_full, 2 * T_BYTES);
      for (int c = 0; c < T::CHUNKS; ++c) {
        tma_load_4d(sk + c * ROWS * T::ROWB, &tk, kv_full, c * T::CW, hk, k0, b);
        tma_load_4d(sv + c * ROWS * T::ROWB, &tv, kv_full, c * T::CW, hk, k0, b);
      }
      int s = 0;
      uint32_t phase = 0;
      for (int g = 0; g < G; ++g) {
        const int h = hk * G + g;
        for (int qt = qt0; qt < nq; ++qt) {
          mbar_wait(empty(s), phase ^ 1);  // the first round passes at once
          const uint32_t qs = q_stage(s), rs = srow + 2 * s * R_BYTES;
          mbar_arrive_expect_tx(full(s), 2 * T_BYTES + 2 * R_BYTES);
          for (int c = 0; c < T::CHUNKS; ++c) {
            tma_load_4d(qs + c * ROWS * T::ROWB, &tq, full(s), c * T::CW, h, qt * ROWS, b);
            tma_load_4d(qs + T_BYTES + c * ROWS * T::ROWB, &tdo, full(s), c * T::CW, h, qt * ROWS, b);
          }
          const long long at = ((long long)b * a.Hq + h) * a.sq_pad + qt * ROWS;
          bulk_load(rs, a.lse2 + at, R_BYTES, full(s));
          bulk_load(rs + R_BYTES, a.delta + at, R_BYTES, full(s));
          advance<STAGES>(s, phase);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup `wg` (0: Pᵀ and dV, 1: dSᵀ and dK): kv rows k0 .. k0 + 63
  const int wg = threadIdx.x / THREADS, tid = threadIdx.x % THREADS;
  const int warp = tid >> 5, lane = tid & 31, t4 = lane & 3;
  const int kv = k0 + warp * 16 + (lane >> 2);  // this thread's kv rows: kv and kv + 8
  const float* rows_smem = reinterpret_cast<const float*>(smem_raw + (srow - raw));
  float* pbuf = reinterpret_cast<float*>(smem_raw + (sp - raw));
  const uint32_t ka = wg == 0 ? sk : sv;            // A of this warpgroup's 64 × 64 product: K or V
  const uint32_t b_sc = wg == 0 ? 0u : T_BYTES;     // its B in a stage: Q or dO
  const uint32_t b_acc = wg == 0 ? T_BYTES : 0u;    // B of its 64 × dh product: dO (dV) or Q (dK)
  const float sl2 = a.scale * LOG2E;  // scores in log2 units

  float acc[D / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float x[ROWS / 2];  // Sᵀ → Pᵀ, or dPᵀ → dSᵀ
  uint32_t xa[ROWS / 16][4];
  mbar_wait(kv_full, 0);

  int s = 0, prev = 0, qt = qt0;
  uint32_t phase = 0;
  if (n_tiles > 0) {
    mbar_wait(full(0), 0);
    issue_abt<D, ROWS>(x, ka, q_stage(0) + b_sc);
    wgmma_wait<0>();
    fence_regs<ROWS / 2>(x);
  }
  for (int i = 0; i < n_tiles; ++i) {
    const int q0 = qt * ROWS;
    float* pb = pbuf + (i & 1) * ROWS * ROWS;
    const float* lse2 = rows_smem + 2 * s * ROWS;
    if (wg == 0) {
      if (q0 + ROWS > a.Sq || k0 + ROWS > a.Skv || (a.causal && k0 + ROWS - 1 > q0 + a.q_offset))
        probs_t<true>(x, lse2, t4, sl2, a, kv, q0 + 2 * t4);
      else
        probs_t<false>(x, lse2, t4, sl2, a, kv, q0 + 2 * t4);
      if (i >= 2) named_sync(P_EMPTY + (i & 1));  // warpgroup 1 has read Pᵀ of tile i - 2
      put_frag(pb, tid, x);
      named_arrive(P_FULL + (i & 1));
    } else {
      named_sync(P_FULL + (i & 1));
      dscores_t(x, pb, tid, lse2 + ROWS, t4);
      if (i + 2 < n_tiles) named_arrive(P_EMPTY + (i & 1));
    }
    wgmma_wait<0>();  // dV (or dK) of tile i - 1 is done, and this warpgroup is done with its stage
    fence_regs<D / 2>(acc);
    if (i > 0) mbar_arrive(empty(prev));
    pack_a(x, xa);
    int s1 = s;
    uint32_t phase1 = phase;
    advance<STAGES>(s1, phase1);
    if (i + 1 < n_tiles) {  // Sᵀ (or dPᵀ) of tile i + 1 into the registers just packed
      mbar_wait(full(s1), phase1);
      issue_abt<D, ROWS>(x, ka, q_stage(s1) + b_sc);
    }
    wgmma_fence();
    issue_rs<D>(acc, xa, q_stage(s) + b_acc);  // dV += Pᵀ·dO, or dK += dSᵀ·Q
    wgmma_commit();
    wgmma_wait<1>();  // the product of tile i + 1 is in; dV (or dK) of tile i may still run
    fence_regs<ROWS / 2>(x);
    prev = s;
    s = s1;
    phase = phase1;
    if (++qt == nq) qt = qt0;
  }
  wgmma_wait<0>();
  fence_regs<D / 2>(acc);

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(wg == 0 ? a.dv : a.dk);
  const float f = wg == 0 ? 1.f : a.scale;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kv + 8 * r;
    if (row >= a.Skv) continue;
    const long long at = (((long long)b * a.Skv + row) * a.Hkv + hk) * D + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(out + at + dt * 8) = pack_f2(acc[4 * dt + 2 * r] * f, acc[4 * dt + 2 * r + 1] * f);
  }
}

// dQ of q rows q0 .. q0 + NC·64 - 1 of q head h (NC consumer warpgroups),
// pipelined as the dK/dV kernel: dS of kv tile i + 1 is formed while dQ +=
// dS·K of tile i runs.  With 9 or 10 warps an SM (three on one sub-partition)
// a thread has 168 registers: at dh = 128 that spills 32 bytes a thread.
template <int D, int NC>
__global__ void __launch_bounds__(Block<NC>::THREADS_ALL, Block<NC>::DQ_MIN_BLOCKS)
    attn_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                      const Args a) {
  using T = Tile<D>;
  constexpr int STAGES = Block<NC>::DQ_STAGES;
  constexpr int BQR = NC * ROWS;  // q rows a block
  constexpr uint32_t Q_BYTES = BQR * D * 2, T_BYTES = ROWS * D * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;
  const uint32_t sdo = sq + Q_BYTES;
  const uint32_t skv = sdo + Q_BYTES;  // stage s: K at skv + 2·s·T_BYTES, V after it
  const uint32_t bars = skv + 2 * STAGES * T_BYTES;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto k_stage = [&](int s) { return skv + 2 * s * T_BYTES; };

  const int nq = (a.Sq + BQR - 1) / BQR;
  // heads run fastest in launch order, so every head's longest q tile is
  // launched before any head's shorter ones: longest causal rows first
  const int q0 = (nq - 1 - (int)blockIdx.y) * BQR;
  const int h = blockIdx.x, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  int nk = (a.Skv + ROWS - 1) / ROWS;  // kv tiles the q tile sees: all, or up to the diagonal
  if (a.causal) {
    const long long last = (long long)q0 + BQR - 1 + a.q_offset;
    const long long hi = last < 0 ? 0 : last / ROWS + 1;
    nk = hi < nk ? (int)hi : nk;
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), NC * THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= NC * THREADS) {
    // ---- producer warp: one thread issues every copy
    if (threadIdx.x == NC * THREADS) {
      mbar_arrive_expect_tx(q_full, 2 * Q_BYTES);
      for (int c = 0; c < T::CHUNKS; ++c) {
        tma_load_4d(sq + c * BQR * T::ROWB, &tq, q_full, c * T::CW, h, q0, b);
        tma_load_4d(sdo + c * BQR * T::ROWB, &tdo, q_full, c * T::CW, h, q0, b);
      }
      int s = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(empty(s), phase ^ 1);  // the first round passes at once
        mbar_arrive_expect_tx(full(s), 2 * T_BYTES);
        for (int c = 0; c < T::CHUNKS; ++c) {
          tma_load_4d(k_stage(s) + c * ROWS * T::ROWB, &tk, full(s), c * T::CW, hk, kt * ROWS, b);
          tma_load_4d(k_stage(s) + T_BYTES + c * ROWS * T::ROWB, &tv, full(s), c * T::CW, hk, kt * ROWS, b);
        }
        advance<STAGES>(s, phase);
      }
    }
    return;
  }

  // ---- consumer warpgroup `wg`: q rows q0 + 64·wg .. + 63
  const int wg = threadIdx.x / THREADS, tid = threadIdx.x % THREADS;
  const int warp = tid >> 5, lane = tid & 31, t4 = lane & 3;
  const int qw = q0 + wg * ROWS;                // the warpgroup's first q row
  const int qr = qw + warp * 16 + (lane >> 2);  // this thread's q rows: qr and qr + 8
  const uint32_t qa = sq + wg * ROWS * T::ROWB, oa = sdo + wg * ROWS * T::ROWB;
  const float sl2 = a.scale * LOG2E;
  float l2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qr + 8 * r;
    const long long at = ((long long)b * a.Hq + h) * a.sq_pad + row;
    l2[r] = row < a.Sq ? a.lse2[at] : LSE2_PAD;
    dd[r] = row < a.Sq ? a.delta[at] : 0.f;
  }

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  float sc[ROWS / 2], dp[ROWS / 2];
  uint32_t da[ROWS / 16][4];
  mbar_wait(q_full, 0);

  int s = 0, prev = 0;
  uint32_t phase = 0;
  if (nk > 0) {  // S = Q·Kᵀ and dP = dO·Vᵀ of the first kv tile
    mbar_wait(full(0), 0);
    issue_abt<D, BQR>(sc, qa, k_stage(0));
    issue_abt<D, BQR>(dp, oa, k_stage(0) + T_BYTES);
    wgmma_wait<0>();
    fence_regs<ROWS / 2>(sc);
    fence_regs<ROWS / 2>(dp);
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * ROWS;
    if (k0 + ROWS > a.Skv || qw + ROWS > a.Sq || (a.causal && k0 + ROWS - 1 > qw + a.q_offset))
      dscores<true>(sc, dp, l2, dd, sl2, a, qr, k0 + 2 * t4);
    else
      dscores<false>(sc, dp, l2, dd, sl2, a, qr, k0 + 2 * t4);
    wgmma_wait<0>();  // dQ += dS·K of tile kt - 1 is done, and its stage is free
    fence_regs<D / 2>(dq);
    if (kt > 0) mbar_arrive(empty(prev));
    pack_a(dp, da);
    int s1 = s;
    uint32_t phase1 = phase;
    advance<STAGES>(s1, phase1);
    if (kt + 1 < nk) {  // S and dP of tile kt + 1 into the registers just packed
      mbar_wait(full(s1), phase1);
      issue_abt<D, BQR>(sc, qa, k_stage(s1));
      issue_abt<D, BQR>(dp, oa, k_stage(s1) + T_BYTES);
    }
    wgmma_fence();
    issue_rs<D>(dq, da, k_stage(s));  // dQ += dS·K
    wgmma_commit();
    wgmma_wait<1>();  // S, dP of tile kt + 1 are in; dQ of tile kt may still run
    fence_regs<ROWS / 2>(sc);
    fence_regs<ROWS / 2>(dp);
    prev = s;
    s = s1;
    phase = phase1;
  }
  wgmma_wait<0>();
  fence_regs<D / 2>(dq);

  __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(a.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qr + 8 * r;
    if (row >= a.Sq) continue;
    __nv_bfloat16* out = dqg + (((long long)b * a.Sq + row) * a.Hq + h) * D + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(out + dt * 8) =
          pack_f2(dq[4 * dt + 2 * r] * a.scale, dq[4 * dt + 2 * r + 1] * a.scale);
  }
}

// ------------------------------------------------------------- host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 4-D map over a contiguous (B, S, H, D) bf16 tensor, boxes of (cw, 1,
// rows, 1); false if the driver refuses it
bool make_map(CUtensorMap* map, const void* base, int B, int S, int H, int D, int cw, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2, (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cw, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = cw * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

// launches since the library was loaded, by kernel (the `LAUNCHED_*` order)
enum { LAUNCHED_DELTA, LAUNCHED_DKDV_WGMMA, LAUNCHED_DQ_WGMMA, LAUNCHED_DKDV_FMA, LAUNCHED_DQ_FMA, LAUNCHED_KINDS };
std::atomic<long long> launched[LAUNCHED_KINDS];

// cudaGetLastError after a launch of kernel `kind`, counted when it is 0
int launched_ok(int kind) {
  const int err = (int)cudaGetLastError();
  if (err == 0) launched[kind].fetch_add(1, std::memory_order_relaxed);
  return err;
}

// two consumer warpgroups (128-row q tiles) for dQ when they still give every SM a block
int dq_groups(const Args& a) { return (long long)((a.Sq + 127) / 128) * a.Hq * a.B >= sm_count() ? 2 : 1; }

template <int D>
int launch_dkdv(const Args& a, cudaStream_t stream) {
  using T = Tile<D>;
  CUtensorMap tq, tdo, tk, tv;
  if (!make_map(&tq, a.q, a.B, a.Sq, a.Hq, D, T::CW, ROWS) || !make_map(&tdo, a.dout, a.B, a.Sq, a.Hq, D, T::CW, ROWS) ||
      !make_map(&tk, a.k, a.B, a.Skv, a.Hkv, D, T::CW, ROWS) || !make_map(&tv, a.v, a.B, a.Skv, a.Hkv, D, T::CW, ROWS))
    return -2;
  constexpr int smem = dkdv_smem<D>();
  static const cudaError_t sized =
      cudaFuncSetAttribute(attn_bwd_dkdv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (sized != cudaSuccess) return (int)sized;
  const dim3 grid(a.Hkv, (a.Skv + ROWS - 1) / ROWS, a.B);
  attn_bwd_dkdv_wgmma<D><<<grid, Block<2>::THREADS_ALL, smem, stream>>>(tq, tdo, tk, tv, a);
  return launched_ok(LAUNCHED_DKDV_WGMMA);
}

template <int D, int NC>
int launch_dq(const Args& a, cudaStream_t stream) {
  using T = Tile<D>;
  CUtensorMap tq, tdo, tk, tv;
  if (!make_map(&tq, a.q, a.B, a.Sq, a.Hq, D, T::CW, NC * ROWS) ||
      !make_map(&tdo, a.dout, a.B, a.Sq, a.Hq, D, T::CW, NC * ROWS) ||
      !make_map(&tk, a.k, a.B, a.Skv, a.Hkv, D, T::CW, ROWS) || !make_map(&tv, a.v, a.B, a.Skv, a.Hkv, D, T::CW, ROWS))
    return -2;
  constexpr int smem = dq_smem<D, NC>();
  static const cudaError_t sized =
      cudaFuncSetAttribute(attn_bwd_dq_wgmma<D, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (sized != cudaSuccess) return (int)sized;
  const dim3 grid(a.Hq, (a.Sq + NC * ROWS - 1) / (NC * ROWS), a.B);
  attn_bwd_dq_wgmma<D, NC><<<grid, Block<NC>::THREADS_ALL, smem, stream>>>(tq, tdo, tk, tv, a);
  return launched_ok(LAUNCHED_DQ_WGMMA);
}

template <typename T, int D>
int launch_delta(const Args& a, cudaStream_t stream) {
  constexpr int L = D * (int)sizeof(T) / 16;
  const long long threads = (long long)a.B * a.sq_pad * a.Hq * L;
  attn_bwd_delta<T, D><<<(unsigned)((threads + THREADS - 1) / THREADS), THREADS, 0, stream>>>(a);
  return launched_ok(LAUNCHED_DELTA);
}

template <int D>
int launch_f32(const Args& a, cudaStream_t stream) {
  constexpr int smem = smem_floats<D>() * 4;
  static bool sized = false;
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(attn_bwd_dkdv<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attn_bwd_dq<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  int err = launch_delta<float, D>(a, stream);
  if (err != 0) return err;
  attn_bwd_dkdv<float, D><<<dim3((a.Skv + BK - 1) / BK, a.Hkv, a.B), THREADS, smem, stream>>>(a);
  err = launched_ok(LAUNCHED_DKDV_FMA);
  if (err != 0) return err;
  attn_bwd_dq<float, D><<<dim3((a.Sq + BQ - 1) / BQ, a.Hq, a.B), THREADS, smem, stream>>>(a);
  return launched_ok(LAUNCHED_DQ_FMA);
}

template <int D>
int launch_bf16(const Args& a, cudaStream_t stream) {
  int err = launch_delta<__nv_bfloat16, D>(a, stream);
  if (err != 0) return err;
  err = launch_dkdv<D>(a, stream);
  if (err != 0) return err;
  return dq_groups(a) == 2 ? launch_dq<D, 2>(a, stream) : launch_dq<D, 1>(a, stream);
}

template <int D>
int launch(const Args& a, int dtype, cudaStream_t stream) {
  return dtype == 1 ? launch_bf16<D>(a, stream) : launch_f32<D>(a, stream);
}

template <int D>
int info(int nc, int kernel, int* regs, int* local_bytes, int* smem, int* threads) {
  if (kernel == 0 && nc != 2) return -1;
  const void* fn = kernel == 0 ? (const void*)attn_bwd_dkdv_wgmma<D>
                               : (nc == 2 ? (const void*)attn_bwd_dq_wgmma<D, 2> : (const void*)attn_bwd_dq_wgmma<D, 1>);
  cudaFuncAttributes at;
  const cudaError_t err = cudaFuncGetAttributes(&at, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = at.numRegs;
  *local_bytes = (int)at.localSizeBytes;
  *smem = kernel == 0 ? dkdv_smem<D>() : (nc == 2 ? dq_smem<D, 2>() : dq_smem<D, 1>());
  *threads = nc * THREADS + 32;
  return 0;
}

}  // namespace

// q, o, dout, dq: contiguous (B, Sq, Hq, dh); k, v, dk, dv: contiguous (B,
// Skv, Hkv, dh); all of one type (dtype 0 float32, 1 bfloat16), 16-byte
// aligned.  lse: the forward's (B, Hq, Sq) float32.  scratch: float32, 2·B·Hq·
// sq_pad values with sq_pad = Sq rounded up to a multiple of 64, 256-byte
// aligned (D and lse·log2(e) of every row).  Three launches on `stream`, no
// synchronisation.  Returns 0, a CUDA error code, -1 for arguments the
// kernels do not take, or -2 when the driver refuses a tensor map.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                                          const void* dout, const void* lse, void* scratch, void* dq, void* dk,
                                          void* dv, int B, int Sq, int Skv, int Hq, int Hkv, int dh, int causal,
                                          int q_offset, float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0) return -1;
  if (dtype != 0 && dtype != 1) return -1;
  const int sq_pad = (Sq + ROWS - 1) / ROWS * ROWS;
  if (B > 65535 || Hq > 65535 || sq_pad / ROWS > 65535 || (Skv + BK - 1) / BK > 65535 ||
      (long long)B * sq_pad * Hq * 32 / THREADS >= 0x7fffffffLL)
    return -1;
  float* rows = static_cast<float*>(scratch);
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse), rows, rows + (long long)B * Hq * sq_pad, dq, dk,
               dv, B, Sq, Skv, Hq, Hkv, sq_pad, causal, q_offset, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return launch<32>(a, dtype, st);
    case 64: return launch<64>(a, dtype, st);
    case 128: return launch<128>(a, dtype, st);
    default: return -1;
  }
}

// Consumer warpgroups a block that a bf16 call of this shape gives the dK/dV
// kernel (always 2, split by role) and the dQ kernel (1 or 2).
extern "C" int flash_attention_bwd_groups(int B, int Sq, int Skv, int Hq, int Hkv, int* dkdv, int* dq) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hq <= 0 || Hkv <= 0) return -1;
  Args a{};
  a.B = B, a.Sq = Sq, a.Skv = Skv, a.Hq = Hq, a.Hkv = Hkv;
  *dkdv = 2;
  *dq = dq_groups(a);
  return 0;
}

// A bf16 kernel's resources at head dim `dh` with `nc` consumer warpgroups;
// kernel 0 is attn_bwd_dkdv_wgmma (nc 2 only), 1 attn_bwd_dq_wgmma (nc 1 or
// 2): registers a thread, local memory a thread (spills), dynamic shared
// memory and threads a block.  Returns 0 or a CUDA error code, -1 for other
// arguments.
extern "C" int flash_attention_bwd_kernel_info(int dh, int nc, int kernel, int* regs, int* local_bytes, int* smem,
                                               int* threads) {
  if ((nc != 1 && nc != 2) || (kernel != 0 && kernel != 1)) return -1;
  switch (dh) {
    case 32: return info<32>(nc, kernel, regs, local_bytes, smem, threads);
    case 64: return info<64>(nc, kernel, regs, local_bytes, smem, threads);
    case 128: return info<128>(nc, kernel, regs, local_bytes, smem, threads);
    default: return -1;
  }
}

// Launches since the library was loaded: out[0] attn_bwd_delta, [1]
// attn_bwd_dkdv_wgmma, [2] attn_bwd_dq_wgmma, [3] attn_bwd_dkdv (float32),
// [4] attn_bwd_dq (float32).  Shows which route a call took without a profiler.
extern "C" void flash_attention_bwd_kernel_launches(long long* out) {
  for (int i = 0; i < LAUNCHED_KINDS; ++i) out[i] = launched[i].load(std::memory_order_relaxed);
}
