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
// (and never a NaN).  fp32 arithmetic throughout; outputs in q's type.
//
// What bounds it.  Five products a kept (q, k) pair where the forward does
// two, so its operation bound is 2.5x the forward's; at the training shape
// (B 8, S 128, 24/8 heads, dh 128) and the serve shape (S 2048) it is, like
// the forward, far above the card's bf16 operations a byte: bounded by
// operations, reachable only on the tensor cores.
//
// What the design does about it: little yet.  This is the first, simple and
// right version, on the CUDA cores with fmaf (the recomputed S and dP make
// seven products a pair here); `mma.sync`/`wgmma` and a TMA ring are later
// work.  Three launches a call, on one stream:
//   * `attn_bwd_delta`: D, one warp a row;
//   * `attn_bwd_dkdv`: one block a (kv tile of 32 rows, kv head, batch); K
//     and V stay in shared memory while the block walks the G query heads of
//     the group and, for each, the q tiles that can see its keys (causal: from
//     the diagonal on), recomputing S and dP and accumulating dK and dV in
//     registers: every output row has one owner, no atomics, so two runs are
//     bit-equal;
//   * `attn_bwd_dq`: one block a (q tile of 32 rows, q head, batch), walking
//     the kv tiles it sees (causal: up to the diagonal), dQ in registers.
// Tiles are stored in shared memory as float with a row pitch of dh + 1, so
// that the 16 threads reading 16 different rows hit 16 banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int BQ = 32, BK = 32;  // rows of a q tile and of a kv tile

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, Hq, Sq)
  float* delta;      // (B, Hq, Sq), written by attn_bwd_delta
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Skv, Hq, Hkv;
  int causal, q_offset;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// rows r0 .. r0 + ROWS - 1 of head h of a contiguous (B, S, H, D) tensor into
// shared memory as float, pitch D + 1; rows past S are zeros
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* s, const T* g, int b, int h, int r0, int S, int H) {
  constexpr int P = D + 1;
  for (int i = threadIdx.x; i < ROWS * D; i += THREADS) {
    const int r = i / D, c = i % D, row = r0 + r;
    s[r * P + c] = row < S ? to_f(g[(((long long)b * S + row) * H + h) * D + c]) : 0.f;
  }
}

// the forward's lse and D of rows q0 .. q0 + BQ - 1 of head h
__device__ __forceinline__ void load_rows(float* sl, float* sd, const Args& a, int b, int h, int q0) {
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    const int row = q0 + i;
    const long long at = ((long long)b * a.Hq + h) * a.Sq + row;
    sl[i] = row < a.Sq ? a.lse[at] : 0.f;
    sd[i] = row < a.Sq ? a.delta[at] : 0.f;
  }
}

__device__ __forceinline__ bool kept(const Args& a, int qrow, int kpos) {
  return qrow < a.Sq && kpos < a.Skv && (!a.causal || kpos <= qrow + a.q_offset);
}

// D = rowsum(dO ∘ O): one warp a (b, s, h) row
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) attn_bwd_delta(const Args a) {
  const long long rows = (long long)a.B * a.Sq * a.Hq;
  const long long r = (long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* o = static_cast<const T*>(a.o) + r * D;
  const T* g = static_cast<const T*>(a.dout) + r * D;
  float s = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) s = fmaf(to_f(o[d]), to_f(g[d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = (int)(r % a.Hq), srow = (int)((r / a.Hq) % a.Sq), b = (int)(r / ((long long)a.Hq * a.Sq));
    a.delta[((long long)b * a.Hq + h) * a.Sq + srow] = s;
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

template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int smem = smem_floats<D>() * 4;
  static bool sized = false;
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(attn_bwd_dkdv<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attn_bwd_dq<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const long long rows = (long long)a.B * a.Sq * a.Hq;
  attn_bwd_delta<T, D><<<(unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32)), THREADS, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkdv<T, D><<<dim3((a.Skv + BK - 1) / BK, a.Hkv, a.B), THREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dq<T, D><<<dim3((a.Sq + BQ - 1) / BQ, a.Hq, a.B), THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const Args& a, int dh, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return -1;
  }
}

}  // namespace

// q, o, dout, dq: contiguous (B, Sq, Hq, dh); k, v, dk, dv: contiguous (B,
// Skv, Hkv, dh); all of one type (dtype 0 float32, 1 bfloat16).  lse: the
// forward's (B, Hq, Sq) float32; delta: (B, Hq, Sq) float32 scratch.  Three
// launches on `stream`, no synchronisation.  Returns 0, a CUDA error code, or
// -1 for arguments the kernels do not take.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                                          const void* dout, const void* lse, void* delta, void* dq, void* dk,
                                          void* dv, int B, int Sq, int Skv, int Hq, int Hkv, int dh, int causal,
                                          int q_offset, float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0) return -1;
  if (B > 65535 || Hq > 65535 || (long long)B * Sq * Hq / (THREADS / 32) >= 0x7fffffffLL) return -1;
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(delta), dq, dk, dv,
               B, Sq, Skv, Hq, Hkv, causal, q_offset, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dh<float>(a, dh, st);
  if (dtype == 1) return launch_dh<__nv_bfloat16>(a, dh, st);
  return -1;
}
