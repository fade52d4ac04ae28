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
// raises before a launch.  Optionally (a non-null `lse`) both paths also store
// each row's log-sum-exp of the scaled scores, lse = m + log l in natural
// units, float32 (B, Hq, Sq): the backward (`flash_attention_bwd.cu`)
// recomputes the probabilities from it.
//
// What bounds it.  On the serve path (llama3.2-3b prefill, q (1, S, 24, 128),
// k/v (1, S, 8, 128) bf16, causal, S = 512..3072) attention does
// 4·Hq·dh·S(S+1)/2 operations on 2·S·(Hq+2·Hkv)·dh bytes: about 1,000
// operations a byte at S = 2048, far above the H100's ~295 bf16 operations
// per byte of device memory.  It is bounded by operations, and only the
// tensor cores, fed by `wgmma`, get near that bound.  The time the tensor
// cores wait goes to copies that are not overlapped and to the softmax
// (exp2 on the special-function units) between the two products.
//
// What the design does about it (bf16 inputs, `attn_bf16_wgmma`):
//   * Both products through `wgmma.mma_async` m64nNk16 (bf16 in, fp32
//     accumulate).  S = Q·Kᵀ reads Q and K from shared memory through matrix
//     descriptors; both are K-major (dh contiguous).  O += P·V takes P from
//     registers: the fp32 S accumulator is rounded to bf16 in place, and its
//     fragment layout is the register-A layout.  V is the B operand with the
//     transpose bit set (dh, which is N there, is contiguous).
//   * One consumer warpgroup owns 64 q rows; a block holds one or two of them
//     (a 64- or 128-row q tile), the larger one only when the launch still
//     puts a block on every SM.  Kv tiles are 128 rows.
//   * One producer thread (in a warpgroup of its own, which gives most of its
//     registers to the consumers with `setmaxnreg`) moves Q once and K/V tiles
//     through a ring of FA_STAGES shared-memory stages with TMA
//     (`cp.async.bulk.tensor.4d`), signalling `mbarrier`s: K and V of a stage
//     have a "full" barrier each (Q·Kᵀ starts before V has landed), and the
//     stage an "empty" barrier the consumers arrive at when both products
//     have read it.  Copies of tile j+1.. overlap the arithmetic on tile j.
//   * Tensor maps are 4-D over the public (B, S, H, dh) layout, boxes of
//     (dh chunk, 1, rows, 1): strided views are read as they are, and rows
//     past S come in as zeros (so the kpos < Skv mask is still applied).  A
//     chunk is 64 elements (128 bytes, the 128-byte swizzle) at dh = 64 and
//     128, and 32 (64 bytes, the 64-byte swizzle) at dh = 32; the swizzle of
//     every descriptor is that of its tensor map.  The maps are encoded on the
//     host for each call and passed by value as `__grid_constant__`
//     parameters, so a CUDA-graph capture keeps them.
//   * The two consumer warpgroups of a block share the tensor cores: while
//     one runs its softmax, the other's products run.
//   * causal: the kv loop stops at the q tile's diagonal, masks only the
//     tiles that need it, and the q tiles with most work are launched first,
//     across all heads (heads are the fastest grid dimension).
//   * No atomics: every output row has one owner and one order, so two runs
//     are bit-equal.
// float32 inputs (`attn_f32_fma`): the same algorithm on the CUDA cores with
// fmaf (32 q rows × 16 kv columns a tile), as the f32 tolerance of the tests
// needs fp32 products.  It is off the serve path.
//
// Build: cuTensorMapEncodeTiled is a driver-API symbol; it is fetched through
// the runtime's driver entry point, so the library links nothing beyond the
// CUDA runtime.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef FA_STAGES
#define FA_STAGES 3  // K/V stages of the shared-memory ring (at dh = 128: 229 KB a block)
#endif

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int THREADS = 128;
constexpr int STAGES = FA_STAGES;
constexpr int BK = 128;  // kv rows a tile
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 128·40 + 256·232 = 384·168

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, Hq, Sq) or null
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

// ------------------------------------------------------------- bf16, wgmma

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

// spin until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
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

// s (64 x 128, fp32) = (scale_d ? s : 0) + A·Bᵀ, A and B from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n128(float* s, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(s[0]), "+f"(s[1]), "+f"(s[2]), "+f"(s[3]), "+f"(s[4]), "+f"(s[5]), "+f"(s[6]),
        "+f"(s[7]), "+f"(s[8]), "+f"(s[9]), "+f"(s[10]), "+f"(s[11]), "+f"(s[12]), "+f"(s[13]),
        "+f"(s[14]), "+f"(s[15]), "+f"(s[16]), "+f"(s[17]), "+f"(s[18]), "+f"(s[19]), "+f"(s[20]),
        "+f"(s[21]), "+f"(s[22]), "+f"(s[23]), "+f"(s[24]), "+f"(s[25]), "+f"(s[26]), "+f"(s[27]),
        "+f"(s[28]), "+f"(s[29]), "+f"(s[30]), "+f"(s[31]), "+f"(s[32]), "+f"(s[33]), "+f"(s[34]),
        "+f"(s[35]), "+f"(s[36]), "+f"(s[37]), "+f"(s[38]), "+f"(s[39]), "+f"(s[40]), "+f"(s[41]),
        "+f"(s[42]), "+f"(s[43]), "+f"(s[44]), "+f"(s[45]), "+f"(s[46]), "+f"(s[47]), "+f"(s[48]),
        "+f"(s[49]), "+f"(s[50]), "+f"(s[51]), "+f"(s[52]), "+f"(s[53]), "+f"(s[54]), "+f"(s[55]),
        "+f"(s[56]), "+f"(s[57]), "+f"(s[58]), "+f"(s[59]), "+f"(s[60]), "+f"(s[61]), "+f"(s[62]),
        "+f"(s[63])
      : "l"(da), "l"(db), "r"(scale_d));
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

template <int D, int NC>
constexpr int smem_bytes() {
  return 1024 /* alignment slack */ + NC * 64 * D * 2 + 2 * STAGES * BK * D * 2 + 8 * (1 + 3 * STAGES);
}

// What a consumer thread keeps: its two rows' running max and (partial)
// denominator, and where they sit in the tile.
struct RowState {
  float m[2], l[2];
  int qpos[2];  // query positions of rows r0 and r0 + 8
  int qmin;     // the warpgroup's first query position
  int t4;       // the thread's column pair in a fragment
};

// S (64 × BK of the warpgroup) = Q·Kᵀ, issued and committed: dh/16 steps,
// each 32 bytes further along a chunk row
template <int D, int BQ>
__device__ __forceinline__ void issue_qk(float* sc, uint32_t qa, uint32_t ka) {
  using T = Tile<D>;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks / T::KPC, kin = ks % T::KPC;
    const uint64_t da = make_desc(qa + c * BQ * T::ROWB + kin * 32, 16, 8 * T::ROWB, T::MODE);
    const uint64_t db = make_desc(ka + c * BK * T::ROWB + kin * 32, 16, 8 * T::ROWB, T::MODE);
    wgmma_ss_n128(sc, da, db, ks > 0);
  }
  wgmma_commit();
}

// O += P·V, issued and committed: BK/16 steps of 16 kv rows; V is N-major
template <int D>
__device__ __forceinline__ void issue_pv(float* o, uint32_t (*pa)[4], uint32_t va) {
  using T = Tile<D>;
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < BK / 16; ++j)
    wgmma_rs<D>(o, pa[j], make_desc(va + j * 16 * T::ROWB, BK * T::ROWB, 8 * T::ROWB, T::MODE));
  wgmma_commit();
}

// the online softmax of the tile at kv position k0, in place on the fp32
// scores: mask (MASK: the tile crosses the diagonal or the end of the keys),
// scale to log2 units, new running max (4 threads share a row), exp2, row
// sums into l; returns the correction of what was summed before in `corr`.
// The mask is a template argument so that the tiles that need none carry no
// per-element index arithmetic.
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float* sc, RowState& st, const Args& a, int k0, float sl2,
                                             float corr[2]) {
  constexpr int NT = BK / 8;  // 8-column blocks of S
  float mx[2] = {st.m[0], st.m[1]};
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = sc[4 * n + e] * sl2;
      if constexpr (MASK) {
        const int kpos = k0 + n * 8 + st.t4 * 2 + (e & 1);
        const bool ok = kpos < a.Skv && (!a.causal || kpos <= st.qpos[e >> 1]);
        v = ok ? v : NEG_INF;
      }
      sc[4 * n + e] = v;
      mx[e >> 1] = fmaxf(mx[e >> 1], v);
    }
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = fast_exp2(st.m[r] - mx[r]);
    st.m[r] = mx[r];
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * n + e] = fast_exp2(sc[4 * n + e] - st.m[e >> 1]);
      rs[e >> 1] += sc[4 * n + e];
    }
  }
  // l stays a per-thread partial sum (its columns); summed over the row at the end
  st.l[0] = st.l[0] * corr[0] + rs[0];
  st.l[1] = st.l[1] * corr[1] + rs[1];
}

// P in bf16: S columns 16j..16j+15 (blocks 2j, 2j+1) are the A fragment of step j
__device__ __forceinline__ void pack_p(const float* sc, uint32_t (*pa)[4]) {
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    pa[n >> 1][(n & 1) * 2 + 0] = pack_f2(sc[4 * n + 0], sc[4 * n + 1]);
    pa[n >> 1][(n & 1) * 2 + 1] = pack_f2(sc[4 * n + 2], sc[4 * n + 3]);
  }
}

template <int D>
__device__ __forceinline__ void rescale(float* o, const float corr[2]) {
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    o[4 * dt + 0] *= corr[0];
    o[4 * dt + 1] *= corr[0];
    o[4 * dt + 2] *= corr[1];
    o[4 * dt + 3] *= corr[1];
  }
}

template <int D, int NC>
__global__ void __launch_bounds__((NC + 1) * THREADS, 1)
    attn_bf16_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Args a) {
  using T = Tile<D>;
  constexpr int BQ = NC * 64;
  constexpr uint32_t Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;  // swizzled tiles start on 1024 bytes
  const uint32_t sk = sq + Q_BYTES, sv = sk + STAGES * KV_BYTES;
  const uint32_t bars = sv + STAGES * KV_BYTES;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * STAGES + s); };

  const int nq = (a.Sq + BQ - 1) / BQ;
  // heads run fastest in launch order, so every head's longest q tile is
  // launched before any head's shorter ones: longest causal rows first
  const int q0 = (nq - 1 - (int)blockIdx.y) * BQ;
  const int h = blockIdx.x, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int nk = kv_tiles(a, q0, BQ, BK);
  const int wg = threadIdx.x / THREADS;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), NC * THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {
    // ---- producer: one thread issues every copy
    if constexpr (NC > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x % THREADS == 0) {
      mbar_arrive_expect_tx(q_full, Q_BYTES);
      for (int c = 0; c < T::CHUNKS; ++c) tma_load_4d(sq + c * BQ * T::ROWB, &tq, q_full, c * T::CW, h, q0, b);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(empty(s), ((kt / STAGES) & 1) ^ 1);  // the first round passes at once
        mbar_arrive_expect_tx(k_full(s), KV_BYTES);
        for (int c = 0; c < T::CHUNKS; ++c)
          tma_load_4d(sk + s * KV_BYTES + c * BK * T::ROWB, &tk, k_full(s), c * T::CW, hk, kt * BK, b);
        mbar_arrive_expect_tx(v_full(s), KV_BYTES);
        for (int c = 0; c < T::CHUNKS; ++c)
          tma_load_4d(sv + s * KV_BYTES + c * BK * T::ROWB, &tv, v_full(s), c * T::CW, hk, kt * BK, b);
      }
    }
  } else {
    // ---- consumer warpgroup `wg`: q rows q0 + 64·wg .. + 63
    if constexpr (NC > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int tid = threadIdx.x % THREADS;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2;                 // fragment row group
    const int r0 = wg * 64 + warp * 16 + g;  // this thread's rows in the tile: r0 and r0 + 8
    RowState st{{NEG_INF, NEG_INF}, {0.f, 0.f}, {q0 + r0 + a.q_offset, q0 + r0 + 8 + a.q_offset},
                q0 + wg * 64 + a.q_offset, lane & 3};
    const float sl2 = a.scale * LOG2E;  // scores in log2 units: exp2 of the difference
    const uint32_t qa = sq + wg * 64 * T::ROWB;
    auto stage = [&](int kt) { return kt % STAGES; };
    auto parity = [&](int kt) { return (uint32_t)((kt / STAGES) & 1); };

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float sc[BK / 2];
    uint32_t pa[BK / 16][4];
    float corr[2];
    mbar_wait(q_full, 0);

    for (int kt = 0; kt < nk; ++kt) {
      const int s = stage(kt);
      mbar_wait(k_full(s), parity(kt));
      issue_qk<D, BQ>(sc, qa, sk + s * KV_BYTES);
      wgmma_wait<0>();
      fence_regs<BK / 2>(sc);
      const int k0 = kt * BK;
      if (k0 + BK > a.Skv || (a.causal && k0 + BK - 1 > st.qmin))
        softmax_tile<true>(sc, st, a, k0, sl2, corr);
      else
        softmax_tile<false>(sc, st, a, k0, sl2, corr);
      rescale<D>(o, corr);
      pack_p(sc, pa);
      mbar_wait(v_full(s), parity(kt));
      issue_pv<D>(o, pa, sv + s * KV_BYTES);
      wgmma_wait<0>();
      fence_regs<D / 2>(o);
      mbar_arrive(empty(s));
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 1);
      st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 2);
      inv[r] = 1.f / fmaxf(st.l[r], 1e-30f);
    }
    if (a.lse != nullptr && st.t4 == 0) {  // the running max is in log2 units
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + r0 + r * 8;
        if (row < a.Sq) a.lse[((long long)b * a.Hq + h) * a.Sq + row] = st.m[r] * LN2 + logf(fmaxf(st.l[r], 1e-30f));
      }
    }
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + r0 + r * 8;
      if (row >= a.Sq) continue;
      __nv_bfloat16* orow = og + (((long long)b * a.Sq + row) * a.Hq + h) * D + st.t4 * 2;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<uint32_t*>(orow + dt * 8) =
            pack_f2(o[4 * dt + 2 * r] * inv[r], o[4 * dt + 2 * r + 1] * inv[r]);
    }
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
    if (a.lse != nullptr && cg == 0) a.lse[((long long)b * a.Hq + h) * a.Sq + row] = m[i] + logf(denom);
    float* orow = og + (((long long)b * a.Sq + row) * a.Hq + h) * D + cg;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[16 * j] = acc[i][j] / denom;
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

// a 4-D map over (B, S, H, dh) bf16 with strides in elements, boxes of
// (cw, 1, rows, 1); false if the driver refuses it
bool make_map(CUtensorMap* map, const void* base, int B, int S, int H, int D, long long sb, long long ss,
              long long sh, int cw, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
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

// 128-row q tiles (two consumer warpgroups) when they still give every SM a block
int consumer_groups(const Args& a) { return (long long)((a.Sq + 127) / 128) * a.Hq * a.B >= sm_count() ? 2 : 1; }

template <int D, int NC>
int launch_wgmma(const Args& a, cudaStream_t stream) {
  using T = Tile<D>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, a.q, a.B, a.Sq, a.Hq, D, a.q_sb, a.q_ss, a.q_sh, T::CW, NC * 64) ||
      !make_map(&tk, a.k, a.B, a.Skv, a.Hkv, D, a.k_sb, a.k_ss, a.k_sh, T::CW, BK) ||
      !make_map(&tv, a.v, a.B, a.Skv, a.Hkv, D, a.v_sb, a.v_ss, a.v_sh, T::CW, BK))
    return -2;
  constexpr int smem = smem_bytes<D, NC>();
  static bool sized = false;
  if (!sized) {
    const cudaError_t err =
        cudaFuncSetAttribute(attn_bf16_wgmma<D, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const dim3 grid(a.Hq, (a.Sq + NC * 64 - 1) / (NC * 64), a.B);
  attn_bf16_wgmma<D, NC><<<grid, (NC + 1) * THREADS, smem, stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const Args& a, int dtype, cudaStream_t stream) {
  if (dtype == 1) return consumer_groups(a) == 2 ? launch_wgmma<D, 2>(a, stream) : launch_wgmma<D, 1>(a, stream);
  const dim3 grid((a.Sq + 31) / 32, a.Hq, a.B);
  attn_f32_fma<D><<<grid, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int info(int nc, int* regs, int* local_bytes, int* smem, int* threads) {
  cudaFuncAttributes at;
  const cudaError_t err = cudaFuncGetAttributes(&at, nc == 2 ? (const void*)attn_bf16_wgmma<D, 2>
                                                             : (const void*)attn_bf16_wgmma<D, 1>);
  if (err != cudaSuccess) return (int)err;
  *regs = at.numRegs;
  *local_bytes = (int)at.localSizeBytes;
  *smem = nc == 2 ? smem_bytes<D, 2>() : smem_bytes<D, 1>();
  *threads = (nc + 1) * THREADS;
  return 0;
}

}  // namespace

// q, k, v: (B, S, H, dh) with unit stride along dh, strides in elements (the
// wrapper checks 16-byte alignment); out: contiguous (B, Sq, Hq, dh); lse:
// contiguous float32 (B, Hq, Sq), or null when the caller needs none.
// dtype: 0 float32, 1 bfloat16.  Returns 0, a CUDA error code, -1 for
// arguments the kernel does not take, or -2 when the driver refuses a tensor
// map of q, k or v.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out, void* lse,
                                      int B, int Sq, int Skv, int Hq, int Hkv, int dh,
                                      long long q_sb, long long q_ss, long long q_sh,
                                      long long k_sb, long long k_ss, long long k_sh,
                                      long long v_sb, long long v_ss, long long v_sh,
                                      int causal, int q_offset, float scale, int dtype,
                                      void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0) return -1;
  if (dtype != 0 && dtype != 1) return -1;
  if (B > 65535 || Hq > 65535 || (Sq + 63) / 64 > 65535) return -1;
  const Args a{q, k, v, out, static_cast<float*>(lse), B, Sq, Skv, Hq, Hkv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
               v_sb, v_ss, v_sh, causal, q_offset, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return launch<32>(a, dtype, st);
    case 64: return launch<64>(a, dtype, st);
    case 128: return launch<128>(a, dtype, st);
    default: return -1;
  }
}

// The bf16 kernel's resources at head dim `dh` with `nc` consumer warpgroups
// (1 or 2): registers a thread at launch (consumers raise theirs with
// setmaxnreg), local memory a thread (spills), dynamic shared memory and
// threads a block.  Returns 0 or a CUDA error code, -1 for other arguments.
extern "C" int flash_attention_kernel_info(int dh, int nc, int* regs, int* local_bytes, int* smem,
                                           int* threads) {
  if (nc != 1 && nc != 2) return -1;
  switch (dh) {
    case 32: return info<32>(nc, regs, local_bytes, smem, threads);
    case 64: return info<64>(nc, regs, local_bytes, smem, threads);
    case 128: return info<128>(nc, regs, local_bytes, smem, threads);
    default: return -1;
  }
}
