// Shared pieces of the NeRF2D MLP kernels (mlp_fwd.cu, mlp_bwd.cu).
//
// Packed layout (ops/mlp_kernel.py): layer i weight (K_i, N_i) row-major in
// bf16, K = 48, 256 x4, 48 + 256, 256 x2, then the output layer (256, 16);
// biases f32, 256 per hidden layer then 16. The 42-dim Fourier embedding is
// zero-padded to 48, a multiple of the 16-deep bf16 tensor-core step.
//
// A CTA owns BM = 64 points and 8 warps. The activations of its points stay
// in shared memory (bf16, 64 x 256) for all layers; the weights stream
// through shared memory at most 256 rows (128 KB) at a time, since the whole
// stack (about 1 MB in bf16) does not fit in a CTA's 227 KB. Matmuls are
// WMMA 16x16x16 bf16 with f32 accumulators; warp w owns output columns
// [32w, 32w + 32) of every layer across all 64 rows (4 x 2 fragments).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace mlp {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int EMB_PAD = 48;
constexpr int W = 256;
constexpr int SKIP = 4;
constexpr int DEPTH = 8;
constexpr int OUT_PAD = 16;
constexpr int BM = 64;
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int WROWS = 256;  // weight rows resident in shared memory at once

__host__ __device__ constexpr int layer_k(int i) {
  return i == 0 ? EMB_PAD : (i == SKIP + 1 ? EMB_PAD + W : W);
}
__host__ __device__ constexpr int layer_n(int i) {
  return i == DEPTH ? OUT_PAD : W;
}
__host__ __device__ constexpr long w_offset(int i) {
  long o = 0;
  for (int j = 0; j < i; ++j) o += (long)layer_k(j) * layer_n(j);
  return o;
}
__host__ __device__ constexpr int b_offset(int i) { return i * W; }
constexpr long W_NUMEL = w_offset(DEPTH + 1);
constexpr int B_NUMEL = DEPTH * W + OUT_PAD;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>
    FragAT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
    FragBT;

// Shared memory of one CTA; every region is a multiple of 32 bytes, as
// WMMA loads need.
struct Smem {
  bf16* w;       // [WROWS][W] weight rows (or the (256, 16) output layer)
  bf16* h;       // [BM][W] activations (forward) / delta (backward)
  bf16* emb;     // [BM][EMB_PAD]
  float* stage;  // [NWARPS][16 * 16] per-warp fragment staging
};

// Copy `nvec` 16-byte vectors from global to shared memory, all threads.
__device__ __forceinline__ void copy_vec(void* dst, const void* src,
                                         int nvec) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int v = threadIdx.x; v < nvec; v += NTHREADS) d[v] = s[v];
}

// Weight rows [r0, r0 + nrows) of layer `layer` into s.w.
__device__ __forceinline__ void load_weights(const Smem& s, const bf16* wg,
                                             int layer, int r0, int nrows) {
  const int n = layer_n(layer);
  copy_vec(s.w, wg + w_offset(layer) + (long)r0 * n, nrows * n / 8);
}

// The block's embedding into s.emb: from uv (sin/cos in f32, the
// reference's [uv, sin 1uv, cos 1uv, sin 2uv, ...] order) or copied from a
// precomputed (N, 48) bf16 embedding. Rows past n are zero.
__device__ void load_embedding(const Smem& s, const void* x, int x_is_uv,
                               int multires, int row0, int n) {
  if (x_is_uv) {
    const float* uv = reinterpret_cast<const float*>(x);
    for (int r = threadIdx.x; r < BM; r += NTHREADS) {
      bf16* e = s.emb + r * EMB_PAD;
      const int row = row0 + r;
      float f[EMB_PAD];
#pragma unroll
      for (int c = 0; c < EMB_PAD; ++c) f[c] = 0.f;
      if (row < n) {
        const float u = uv[2 * (long)row], v = uv[2 * (long)row + 1];
        f[0] = u;
        f[1] = v;
        for (int i = 0; i < multires; ++i) {
          const float fr = ldexpf(1.f, i);
          f[2 + 4 * i] = sinf(u * fr);
          f[3 + 4 * i] = sinf(v * fr);
          f[4 + 4 * i] = cosf(u * fr);
          f[5 + 4 * i] = cosf(v * fr);
        }
      }
#pragma unroll
      for (int c = 0; c < EMB_PAD; ++c) e[c] = __float2bfloat16(f[c]);
    }
  } else {
    const bf16* emb = reinterpret_cast<const bf16*>(x);
    constexpr int VPR = EMB_PAD / 8;  // 16-byte vectors per row
    uint4* d = reinterpret_cast<uint4*>(s.emb);
    for (int v = threadIdx.x; v < BM * VPR; v += NTHREADS) {
      const int row = row0 + v / VPR;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (row < n)
        val = reinterpret_cast<const uint4*>(emb + (long)row * EMB_PAD)[v % VPR];
      d[v] = val;
    }
  }
}

// acc[i][j] += A[16i.., 0:nrows] @ s.w[0:nrows, 32*warp + 16j ..]
// A row-major with leading dimension lda.
__device__ __forceinline__ void mma_rows(FragC (&acc)[4][2], const bf16* A,
                                         int lda, const bf16* wsm,
                                         int nrows, int warp) {
  for (int k = 0; k < nrows; k += 16) {
    FragB b[2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::load_matrix_sync(b[j], wsm + k * W + (2 * warp + j) * 16, W);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      FragA a;
      wmma::load_matrix_sync(a, A + i * 16 * lda + k, lda);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
    }
  }
}

// Hidden layer `layer` for the block: s.h = relu(in @ W + b) in bf16, where
// `in` is s.emb (layer 0), [s.emb, s.h] (layer SKIP + 1) or s.h. With
// `act_out`, the result is also written there ([BM][W] bf16, global).
__device__ void hidden_layer(const Smem& s, const bf16* wg, const float* bg,
                             int layer, bf16* act_out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  FragC acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  if (layer == 0 || layer == SKIP + 1) {
    __syncthreads();
    load_weights(s, wg, layer, 0, EMB_PAD);
    __syncthreads();
    mma_rows(acc, s.emb, EMB_PAD, s.w, EMB_PAD, warp);
  }
  if (layer != 0) {
    __syncthreads();
    load_weights(s, wg, layer, layer == SKIP + 1 ? EMB_PAD : 0, W);
    __syncthreads();
    mma_rows(acc, s.h, W, s.w, W, warp);
  }
  __syncthreads();  // every warp is done reading s.h
  float* st = s.stage + warp * 256;
  const float* bias = bg + b_offset(layer);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int e = lane * 8 + t;
        const int row = i * 16 + e / 16, col = (2 * warp + j) * 16 + e % 16;
        const float v = fmaxf(st[e] + __ldg(bias + col), 0.f);
        const bf16 hv = __float2bfloat16(v);
        s.h[row * W + col] = hv;
        if (act_out) act_out[row * W + col] = hv;
      }
      __syncwarp();
    }
  }
}

}  // namespace mlp
