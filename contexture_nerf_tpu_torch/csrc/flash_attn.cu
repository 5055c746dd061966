// K3/K4: flash attention forward with an optional second KV source,
// hand-written for Hopper.
//
// Replaces: contexture_nerf_tpu/ops/attention.py `_flash_kernel_single`
// (K3) and `_flash_kernel_two_source` (K4), the pallas_calls in
// `flash_attention_pallas`, reached through `attention()`.
//
// What it computes: out = softmax(q k'^T / sqrt(64)) v' per (batch, head),
// where k', v' are k, v followed by the optional extra_k, extra_v (the
// Zero123++ reference-attention tokens). The second source streams into the
// same online-softmax state after the first; the two are never
// concatenated in memory.
//
// What bounds it on an H100: operations. At the teacher's shapes (9,600
// queries against 9,600 + 1,600 keys, head dim 64) a CTA reads 64 query rows
// once and every KV row once per 64 queries: 4 x 64 x Skv FLOPs per query
// row against 256 bytes of K/V per KV row, far above the ~295 FLOP/byte
// ridge. The tensor cores (989 TFLOP/s dense bf16) and the exponentials of
// the softmax (one per score, on the 16-per-clock-per-SM special function
// units) are limits of the same order.
//
// What the design does about it: a CTA of 4 warps owns 64 query rows (16 per
// warp). Q stays in registers as mma.sync A fragments; K and V tiles of 64
// rows are double-buffered in shared memory with cp.async (the next tile
// loads while the current one is used). Scores S = Q K^T and O += P V run on
// mma.sync.m16n8k16 bf16 with f32 accumulators; the softmax state (m, l, O)
// stays f32 in registers, and P is re-packed from the S accumulators into A
// fragments without a trip through shared memory. The ragged tail of each
// source is masked by its true length (loads past it are zero-filled). The
// head dim is 64 as it is: the TPU kernel's zero pad to 128 lanes is not
// carried over. wgmma and a warp-specialised TMA pipeline are later work.
//
// C interface: int flash_attn_fwd(q, k, v, ek, ev, o, bh, sq, skv, se,
// stream); ek/ev may be null when se == 0. Returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 64;          // head dim
constexpr int BQ = 64;         // query rows per CTA
constexpr int BK = 64;         // KV rows per tile
constexpr int NTHREADS = 128;  // 4 warps x 16 query rows
constexpr int LDS = D + 8;     // shared row stride (144 B): ldmatrix rows
                               // land in different banks
constexpr float NEG = -1e30f;

struct __align__(16) Smem {
  bf16 q[BQ * LDS];
  bf16 k[2][BK * LDS];
  bf16 v[2][BK * LDS];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [r0, r0 + 64) of a (len, 64) bf16 matrix into shared memory; rows
// at or past len are zero
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int len) {
  for (int v = threadIdx.x; v < 64 * (D / 8); v += NTHREADS) {
    const int r = v / (D / 8), c = (v % (D / 8)) * 8;
    const int row = r0 + r;
    const bool ok = row < len;
    const bf16* g = src + (long)(ok ? row : 0) * D + c;
    cp_async16(dst + r * LDS + c, g, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ ek,
                     const bf16* __restrict__ ev, bf16* __restrict__ o, int sq,
                     int skv, int se, float scale_log2) {
  __shared__ __align__(16) unsigned char smem_raw[sizeof(Smem)];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;  // mma fragment row / column pair
  const bf16* qb = q + (long)bh * sq * D;
  const bf16* kb = k + (long)bh * skv * D;
  const bf16* vb = v + (long)bh * skv * D;
  const bf16* ekb = se > 0 ? ek + (long)bh * se * D : nullptr;
  const bf16* evb = se > 0 ? ev + (long)bh * se * D : nullptr;
  const int n0 = (skv + BK - 1) / BK;
  const int ntiles = n0 + (se + BK - 1) / BK;

  load_tile(s.q, qb, q0, sq);
  load_tile(s.k[0], kb, 0, skv);
  load_tile(s.v[0], vb, 0, skv);
  cp_commit();

  uint32_t qf[4][4];  // Q A-fragments, 4 chunks of 16 along the head dim
  float o_acc[8][4];  // O: 8 n-tiles of 8 head-dim columns
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // rows g and g + 8
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[i][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < ntiles) {
      const int jn = j + 1;
      if (jn < n0) {
        load_tile(s.k[buf ^ 1], kb, jn * BK, skv);
        load_tile(s.v[buf ^ 1], vb, jn * BK, skv);
      } else {
        load_tile(s.k[buf ^ 1], ekb, (jn - n0) * BK, se);
        load_tile(s.v[buf ^ 1], evb, (jn - n0) * BK, se);
      }
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldsm_x4(qf[kk], s.q + (warp * 16 + lane % 16) * LDS + kk * 16 +
                            (lane / 16) * 8);
    }
    const int len = j < n0 ? skv : se;
    const int t0 = (j < n0 ? j : j - n0) * BK;
    const bf16* ks = s.k[buf];
    const bf16* vs = s.v[buf];

    // S = Q K^T: 8 n-tiles of 8 keys
    float sc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] = 0.f;
#pragma unroll
    for (int np = 0; np < 4; ++np) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b[4];
        ldsm_x4(b, ks + (np * 16 + lane % 8 + (lane / 16) * 8) * LDS +
                       kk * 16 + ((lane / 8) % 2) * 8);
        mma16816(sc[2 * np], qf[kk], b[0], b[1]);
        mma16816(sc[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    // online softmax in the log2 domain (1/sqrt(d) and log2(e) folded)
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = t0 + i * 8 + 2 * tq + (e & 1);
        const float val = col < len ? sc[i][e] * scale_log2 : NEG;
        sc[i][e] = val;
        mx[e / 2] = fmaxf(mx[e / 2], val);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - mn);
      m[r] = mn;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[i][e] - m[e / 2]);
        sc[i][e] = p;
        rs[e / 2] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      o_acc[i][0] *= alpha[0];
      o_acc[i][1] *= alpha[0];
      o_acc[i][2] *= alpha[1];
      o_acc[i][3] *= alpha[1];
    }

    // O += P V: P (bf16) straight from the S accumulators
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t a[4];
      a[0] = pack_bf16(sc[2 * kc][0], sc[2 * kc][1]);
      a[1] = pack_bf16(sc[2 * kc][2], sc[2 * kc][3]);
      a[2] = pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]);
      a[3] = pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3]);
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t b[4];
        ldsm_x4_t(b, vs + (kc * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LDS +
                         dp * 16 + (lane / 16) * 8);
        mma16816(o_acc[2 * dp], a, b[0], b[1]);
        mma16816(o_acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this buffer is refilled by the load two tiles on
  }

  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= sq) continue;
    bf16* orow = o + ((long)bh * sq + row) * D;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const __nv_bfloat162 val = __floats2bfloat162_rn(
          o_acc[i][2 * r] * inv[r], o_acc[i][2 * r + 1] * inv[r]);
      *reinterpret_cast<__nv_bfloat162*>(orow + i * 8 + 2 * tq) = val;
    }
  }
}

}  // namespace

extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              const void* ek, const void* ev, void* o, int bh,
                              int sq, int skv, int se, void* stream) {
  const float scale_log2 = 0.125f * 1.4426950408889634f;  // 1/sqrt(64) log2 e
  dim3 grid((sq + BQ - 1) / BQ, bh);
  if (bh > 0 && sq > 0)
    flash_fwd_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const bf16*>(q), reinterpret_cast<const bf16*>(k),
        reinterpret_cast<const bf16*>(v), reinterpret_cast<const bf16*>(ek),
        reinterpret_cast<const bf16*>(ev), reinterpret_cast<bf16*>(o), sq,
        skv, se, scale_log2);
  return (int)cudaGetLastError();
}
