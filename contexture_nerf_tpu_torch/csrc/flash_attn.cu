// K3/K4: flash attention forward with an optional second KV source,
// hand-written for Hopper (sm_90a): TMA, wgmma, warp specialisation.
//
// Replaces: contexture_nerf_tpu/ops/attention.py `_flash_kernel_single`
// (K3) and `_flash_kernel_two_source` (K4), the pallas_calls in
// `flash_attention_pallas`, reached through `attention()`.
//
// What it computes: out = softmax(q k'^T / sqrt(d)) v' per (batch, head),
// where k', v' are k, v followed by the optional extra_k, extra_v (the
// Zero123++ reference-attention tokens). The second source streams into the
// same online-softmax state after the first; the two are never
// concatenated in memory. Softmax state (m, l, O) is f32; P is rounded to
// bf16 before P V, and O is divided by l at the end.
//
// What bounds it on an H100: three roofs of about the same height. At head
// dim 64 each score costs 256 tensor-core FLOPs (0.26 ps at 989 TFLOP/s
// dense bf16), one ex2 on the special-function units (16 a clock per SM:
// ~0.25 ps at ~1.9 GHz on 132 SMs), and the max, scale, sum and bf16
// packing add several FP32 operations on top. Memory is far below them: a
// CTA reads every KV row once per 128 queries. A kernel that runs the
// softmax between its two GEMMs in the same warps cannot pass about half of
// the tensor-core bound. At head dim 128 a score costs twice the
// tensor-core work for the same softmax, so the GEMMs' roof binds.
//
// What the design does about it (FlashAttention-3's, cut to this forward,
// non-causal case, at head dim d = 64 or 128, a template parameter): a CTA owns BM = 64 * NC query rows, NC consumer
// warpgroups of 64 rows each, plus a producer warpgroup whose first warp
// alone works; setmaxnreg moves the producer's registers to the consumers
// (24 and 240 a thread at NC = 2). The producer's one thread loads Q
// once and streams K and V tiles of BN rows by TMA into a two-stage ring of
// 128-byte-swizzled shared memory, each stage guarded by full and empty
// mbarriers; the first source's tiles come first, then the second's. A
// swizzle atom holds 64 bf16 columns, so a tile of R rows at d = 128 is two
// TMA boxes of R x 64, its two column halves R * 128 bytes apart.
// Consumers run S = Q K^T as wgmma (M 64, N BN, K d in k16 steps, each
// within one column half; Q and K read from shared memory, K-major) and
// O += P V as wgmma (N d) with P in registers (re-packed from the S
// accumulator) and V read from shared memory through the transpose flag
// (MN-major; at d = 128 the descriptor's leading offset steps from one
// column half to the other), so nothing is transposed in memory and no
// warp re-reads K or V through registers. The consumer warpgroups take
// turns on named barriers to issue their GEMMs, and each one issues S(j)
// together with P(j-1) V(j-1): while one warpgroup runs the softmax of tile
// j (exp2 in the log2 domain, 1/sqrt(d) folded in), its own P V and the
// other warpgroup's GEMMs keep the tensor cores busy. Each source masks its
// own ragged tail by its true length (TMA zero-fills past it, but a zero key
// scores 0, not -inf). Query rows past Sq are never stored. The tensor maps
// take any (B, H, S, d) view whose last stride is 1 and whose other
// strides are multiples of 8 elements; the output is written through its
// own strides (the wrapper passes (B, S, H, d) memory). One launch a call,
// no split-KV, no atomics: two runs are bit-identical.
//
// Tiles: BN = 128 keys; at d = 64, BM = 128 query rows, or 192 (three
// consumer warpgroups) where that takes fewer rounds of CTAs over the SMs.
// At d = 128, BM = 128 alone: a consumer thread holds S (64), O (64) and P
// (32 registers), under its 240; Q (32 KB) and the K/V ring (128 KB) fit
// the 227 KB of shared memory. Three consumer warpgroups would have 160
// registers a thread, too few for S, O and P. The second KV source (K4)
// is built at d = 64 only.
//
// C interface: int flash_attn_fwd(q, k, v, ek, ev, o, B, H, sq, skv, se, d,
// strides, bm, stream); strides holds (batch, head, row) strides in
// elements for q, k, v, ek, ev, o; ek/ev may be null when se == 0; bm 0
// picks the query tile. Returns cudaGetLastError(), or 1000 + the CUresult
// of a failed tensor-map encode, or 2000 for a tile, head dim or second
// source the library lacks.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;
using namespace hopper;

namespace {

constexpr int ATOM = 128;        // bytes a swizzle row: 64 bf16 columns
constexpr int STAGES = 2;        // K and V ring depth
constexpr int KV_TILE = 128;     // keys a tile, BN (ops/attention.py KV_TILE)
constexpr float NEG = -1e30f;

template <int BM, int BN, int D>
struct Cfg {
  static constexpr int NC = BM / 64;  // consumer warpgroups
  static constexpr int THREADS = NC * 128 + 128;  // + the producer WG
  static constexpr int HALVES = D / 64;  // swizzle atoms a row
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + STAGES * KV_BYTES;
  // barriers: q_full, then k_full, k_empty, v_full, v_empty per stage;
  // 1024 bytes of slack align the tiles for the 128-byte swizzle
  static constexpr int SMEM = OFF_BAR + 8 * (1 + 4 * STAGES) + 1024;
  // Registers: each of an SM's four sub-partitions holds 16,384, warp w
  // lives in sub-partition w % 4, and setmaxnreg.inc takes what the CTA's
  // setmaxnreg.dec gave back there. So the producer is a whole warpgroup
  // (one warp in each sub-partition; its first thread issues the loads)
  // and each sub-partition must fit NC consumer warps and a producer warp
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = NC == 2 ? 240 : 160;
  static_assert(NC * 32 * CONSUMER_REGS + 32 * PRODUCER_REGS <= 16384,
                "registers of one sub-partition");
  static_assert(BM % 64 == 0 && (NC == 2 || NC == 3), "two or three WGs");
  static_assert(BN % 16 == 0 && BN <= 256, "wgmma N");
  static_assert(KV_BYTES % 1024 == 0, "tiles stay 1024-byte aligned");
  static_assert(D == 64 || (D == 128 && NC == 2), "head dim 64, or 128 at "
                "two consumer warpgroups");
};

struct Params {
  bf16* o;
  long long o_sb, o_sh, o_ss;  // output strides (elements)
  int sq, skv, se;
  int n0, n;  // tiles of the first source, of both
  float scale_log2;
};

// 2^x on the special-function unit; results below 2^-126 flush to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// The S accumulator of a warpgroup (m64nBNk16): thread (warp w, lane l)
// holds s[4j + e] at row 16w + l/4 + 8(e >= 2), key 8j + 2(l % 4) + (e & 1).

// S = Q K^T for one warpgroup: d / 16 k16 steps along the head dim, four
// in each column half; Q_HALF: bytes from Q's first column half to its
// second (K's are BN * 128 apart)
template <int BN, int D, int Q_HALF>
__device__ __forceinline__ void gemm_s(float (&s)[BN / 2], uint32_t q,
                                       uint32_t k) {
  constexpr int K_HALF = BN * ATOM;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<BN>(s, desc_sw128(q + (kk / 4) * Q_HALF + 32 * (kk % 4)),
                 desc_sw128(k + (kk / 4) * K_HALF + 32 * (kk % 4)), kk);
}

// O += P V: BN / 16 k16 steps along the keys, 16 V rows (2048 bytes) each;
// at d = 128 the two column halves of V lie BN * 128 bytes apart (LBO)
template <int BN, int D>
__device__ __forceinline__ void gemm_pv(float (&o)[D / 2],
                                        const uint32_t (&p)[BN / 16][4],
                                        uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    if constexpr (D == 64)
      wgmma_rs_tb<64>(o, p[kk], desc_sw128(v + 2048 * kk), 1);
    else
      wgmma_rs_tb<D>(o, p[kk], desc_sw128_mn(v + 2048 * kk, BN * ATOM), 1);
  }
}

// Online softmax of one tile of S in place (raw scores in, unnormalised
// probabilities out), keys t0.. of a source of length len. m: running max
// in score units; l: this thread's share of the running row sum (the quad's
// shares are summed at the end); a: the factor that rescales O.
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], float (&m)[2],
                                             float (&l)[2], float (&a)[2],
                                             int t0, int len, float c,
                                             int lane) {
  if (t0 + BN > len) {  // the source's ragged tail: keys >= len score -inf
    const int lim = len - t0 - 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (8 * j >= lim) s[4 * j] = s[4 * j + 2] = NEG;
      if (8 * j + 1 >= lim) s[4 * j + 1] = s[4 * j + 3] = NEG;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    a[r] = ex2((m[r] - mx[r]) * c);
    m[r] = mx[r];
  }
  const float b0 = mx[0] * c, b1 = mx[1] * c;
  float r0 = 0.f, r1 = 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    s[4 * j] = ex2(fmaf(s[4 * j], c, -b0));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], c, -b0));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], c, -b1));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], c, -b1));
    r0 += s[4 * j] + s[4 * j + 1];
    r1 += s[4 * j + 2] + s[4 * j + 3];
  }
  l[0] = l[0] * a[0] + r0;
  l[1] = l[1] * a[1] + r1;
}

// P (bf16) as wgmma A fragments: k16 step kk takes key chunks 2kk, 2kk + 1
template <int BN>
__device__ __forceinline__ void pack_p(const float (&s)[BN / 2],
                                       uint32_t (&p)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int BM, int BN, int D>
__global__ void __launch_bounds__(Cfg<BM, BN, D>::THREADS, 1)
    flash_fwd_kernel(__grid_constant__ const CUtensorMap tq,
                     __grid_constant__ const CUtensorMap tk,
                     __grid_constant__ const CUtensorMap tv,
                     __grid_constant__ const CUtensorMap tek,
                     __grid_constant__ const CUtensorMap tev,
                     const Params p) {
  using C = Cfg<BM, BN, D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq_tile = base, sk = base + C::OFF_K, sv = base + C::OFF_V;
  const uint32_t q_full = base + C::OFF_BAR;
  const uint32_t k_full = q_full + 8, k_empty = k_full + 8 * STAGES;
  const uint32_t v_full = k_empty + 8 * STAGES;
  const uint32_t v_empty = v_full + 8 * STAGES;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 4 * C::NC);  // one arrive per consumer warp
      mbar_init(v_empty + 8 * s, 4 * C::NC);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= C::NC * 128) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == C::NC * 128) {
      mbar_arrive_expect_tx(q_full, C::Q_BYTES);
      for (int i = 0; i < C::NC; ++i)
        for (int c = 0; c < C::HALVES; ++c)
          tma_load_4d(sq_tile + c * BM * ATOM + i * 64 * ATOM, &tq, q_full,
                      64 * c, q0 + 64 * i, h, b);
      for (int j = 0; j < p.n; ++j) {
        const int s = j % STAGES;
        const uint32_t ph = ((j / STAGES) & 1) ^ 1;  // first round passes
        const bool first = j < p.n0;
        const int row = (first ? j : j - p.n0) * BN;
        mbar_wait(k_empty + 8 * s, ph);
        mbar_arrive_expect_tx(k_full + 8 * s, C::KV_BYTES);
        for (int c = 0; c < C::HALVES; ++c)
          tma_load_4d(sk + s * C::KV_BYTES + c * BN * ATOM, first ? &tk : &tek,
                      k_full + 8 * s, 64 * c, row, h, b);
        mbar_wait(v_empty + 8 * s, ph);
        mbar_arrive_expect_tx(v_full + 8 * s, C::KV_BYTES);
        for (int c = 0; c < C::HALVES; ++c)
          tma_load_4d(sv + s * C::KV_BYTES + c * BN * ATOM, first ? &tv : &tev,
                      v_full + 8 * s, 64 * c, row, h, b);
      }
    }
  } else {
    // ---- consumer warpgroups ----
    setmaxnreg_inc<C::CONSUMER_REGS>();
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const uint32_t qa = sq_tile + wg * 64 * ATOM;
    // turns to issue GEMMs pass around the warpgroups on named barriers
    // 1..NC (barrier 0 is __syncthreads'): a turn starts with bar.sync on
    // the warpgroup's own barrier and ends with bar.arrive on the next's.
    // The last warpgroup opens the first turn and skips its last arrive,
    // so every barrier gets as many arrives as syncs.
    const int next = (wg + 1) % C::NC;
    auto turn_end = [&](bool last) {
      if (!(last && wg == C::NC - 1)) named_arrive(1 + next, 256);
    };
    if (wg == C::NC - 1) named_arrive(1, 256);

    float s[BN / 2];
    uint32_t pf[BN / 16][4];
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, a[2];
    const int n = p.n;
    auto tile_start = [&](int j) { return (j < p.n0 ? j : j - p.n0) * BN; };
    auto tile_len = [&](int j) { return j < p.n0 ? p.skv : p.se; };

    // tile 0: S only
    mbar_wait(q_full, 0);
    mbar_wait(k_full, 0);
    named_sync(1 + wg, 256);
    wgmma_fence();
    gemm_s<BN, D, BM * ATOM>(s, qa, sk);
    wgmma_commit();
    turn_end(n == 1);
    wgmma_wait<0>();
    fence_operand(s);
    if (lane == 0) mbar_arrive(k_empty);
    softmax_tile<BN>(s, m, l, a, 0, tile_len(0), p.scale_log2, lane);
    pack_p<BN>(s, pf);

    // tile j: S(j) and P(j-1) V(j-1) in one turn, then the softmax of j
    for (int j = 1; j < n; ++j) {
      const int st = j % STAGES, pst = (j - 1) % STAGES;
      mbar_wait(k_full + 8 * st, (j / STAGES) & 1);
      mbar_wait(v_full + 8 * pst, ((j - 1) / STAGES) & 1);
      named_sync(1 + wg, 256);
      fence_operand(o);
      wgmma_fence();
      gemm_s<BN, D, BM * ATOM>(s, qa, sk + st * C::KV_BYTES);
      wgmma_commit();
      gemm_pv<BN, D>(o, pf, sv + pst * C::KV_BYTES);
      wgmma_commit();
      turn_end(j == n - 1);
      wgmma_wait<1>();
      fence_operand(s);
      if (lane == 0) mbar_arrive(k_empty + 8 * st);
      softmax_tile<BN>(s, m, l, a, tile_start(j), tile_len(j), p.scale_log2,
                       lane);
      wgmma_wait<0>();
      fence_operand(o);
      if (lane == 0) mbar_arrive(v_empty + 8 * pst);
      pack_p<BN>(s, pf);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[4 * i] *= a[0];
        o[4 * i + 1] *= a[0];
        o[4 * i + 2] *= a[1];
        o[4 * i + 3] *= a[1];
      }
    }

    // the last P V
    const int lst = (n - 1) % STAGES;
    mbar_wait(v_full + 8 * lst, ((n - 1) / STAGES) & 1);
    fence_operand(o);
    wgmma_fence();
    gemm_pv<BN, D>(o, pf, sv + lst * C::KV_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(o);

    // O / l, rows past Sq dropped; O is (64 x d): o[4i + e] at row
    // 16 warp + lane/4 + 8(e >= 2), column 8i + 2(lane % 4) + (e & 1)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
    bf16* ob = p.o + b * p.o_sb + h * p.o_sh + 2 * (lane & 3);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + wg * 64 + warp * 16 + lane / 4 + 8 * r;
      if (row >= p.sq) continue;
      bf16* orow = ob + row * p.o_ss;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(orow + 8 * i) = pack_bf16(
            o[4 * i + 2 * r] * inv[r], o[4 * i + 2 * r + 1] * inv[r]);
    }
  }
}

// A 4-D map (d, row, head, batch) of a (B, H, S, D) bf16 view with
// strides st = (batch, head, row) in elements; boxes of `rows` x 64 (one
// column half: a tile takes D / 64 of them), 128-byte swizzle, rows past S
// read as zeros.
template <int D>
int make_map(CUtensorMap* map, const void* ptr, int B, int H, int S,
             const long long* st, int rows) {
  EncodeTiled fn = tensor_map_encoder();
  if (fn == nullptr) return 1000 + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

template <int BM, int BN, int D>
int launch(const void* const* t, void* o, int B, int H, int sq, int skv,
           int se, const long long* st, cudaStream_t stream) {
  using C = Cfg<BM, BN, D>;
  CUtensorMap maps[5];
  const int lens[5] = {sq, skv, skv, se, se};
  for (int i = 0; i < (se > 0 ? 5 : 3); ++i) {
    const int err =
        make_map<D>(&maps[i], t[i], B, H, lens[i], st + 3 * i,
                    i == 0 ? 64 : BN);
    if (err) return err;
  }
  if (se == 0) {  // stand-ins for the second source, never read
    maps[3] = maps[1];
    maps[4] = maps[2];
  }
  Params p;
  p.o = reinterpret_cast<bf16*>(o);
  p.o_sb = st[15];
  p.o_sh = st[16];
  p.o_ss = st[17];
  p.sq = sq;
  p.skv = skv;
  p.se = se;
  p.n0 = (skv + BN - 1) / BN;
  p.n = p.n0 + (se + BN - 1) / BN;
  // 1/sqrt(d) log2(e)
  p.scale_log2 = (D == 64 ? 0.125f : 0.08838834764831845f) *
                 1.4426950408889634f;
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(flash_fwd_kernel<BM, BN, D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    attr = true;
  }
  dim3 grid((sq + BM - 1) / BM, H, B);
  flash_fwd_kernel<BM, BN, D><<<grid, C::THREADS, C::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], p);
  return (int)cudaGetLastError();
}

// The query tile that wastes the least of the card: fewer rounds of CTAs
// over the SMs, times the rows a CTA takes (128 on a tie).
int pick_bm(int B, int H, int sq) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  auto cost = [&](long long bm) {
    const long long ctas = (sq + bm - 1) / bm * B * H;
    return (ctas + sms - 1) / sms * bm;
  };
  return cost(192) < cost(128) ? 192 : 128;
}

}  // namespace

extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              const void* ek, const void* ev, void* o, int B,
                              int H, int sq, int skv, int se, int d,
                              const long long* strides, int bm,
                              void* stream) {
  if (B <= 0 || H <= 0 || sq <= 0) return 0;
  const void* t[5] = {q, k, v, ek, ev};
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128) {
    if (se > 0 || (bm != 0 && bm != 128)) return 2000;
    return launch<128, KV_TILE, 128>(t, o, B, H, sq, skv, se, strides, s);
  }
  if (d != 64) return 2000;
  if (bm == 0) bm = pick_bm(B, H, sq);
  if (bm == 128)
    return launch<128, KV_TILE, 64>(t, o, B, H, sq, skv, se, strides, s);
  if (bm == 192)
    return launch<192, KV_TILE, 64>(t, o, B, H, sq, skv, se, strides, s);
  return 2000;
}
