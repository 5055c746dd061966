// K2: NeRF2D MLP backward (parameter gradients), hand-written for Hopper.
//
// Replaces: contexture_nerf_tpu/ops/mlp_kernel.py `_bwd_kernel` (the
// pallas_call in `_run_backward`), the custom VJP of `fused_nerf2d` and
// `fused_nerf2d_emb`. The gradient w.r.t. uv / the embedding is zero there
// and is not computed here.
//
// What bounds it on an H100: operations in principle, about 3x the forward
// per point (recompute, delta propagation, dW), ~2.9 MFLOP a point. In this
// first version the bytes of the f32 partial sums bound it instead (below).
//
// Design. The TPU kernel sums dW and db with `+=` into one output across a
// grid that runs in order; on a GPU the CTAs run at once. So the grid is
// persistent (one CTA per SM): CTA c takes point blocks c, c + G, c + 2G, ...
// and adds each block's dW and db into its own f32 partial in device memory
// (no other CTA touches it); `mlp_bwd_reduce` then adds the G partials in
// CTA order. No float atomics: two runs on the same inputs give
// bit-identical gradients.
//
// Per 64-point block a CTA (8 warps) recomputes the forward with the
// activations in shared memory, also parking each layer's bf16 activation
// in a per-CTA scratch slot (mostly L2-resident) for the backward. Then for
// layer i = 8..0 it forms delta (masked by the ReLU of the next layer, f32
// from the accumulators, stored bf16 for the matmuls, summed in f32 for db),
// dW_i += act_i^T @ delta (read-modify-write of the CTA's partial through
// WMMA accumulator fragments) and delta @ W_i^T. The partial RMW moves about
// 4 MB per block, which is what bounds this version; keeping dW partials on
// chip across blocks (split by layer, or a two-phase act/delta + GEMM) is
// the next step.
//
// C interface:
//   int mlp_bwd(x, x_is_uv, multires, g, w, b, scratch, partial, n, grid,
//               stream)
//   int mlp_bwd_reduce(partial, total, numel, grid, stream)
// each returns cudaGetLastError() after its launch.
#include "mlp_common.cuh"

using namespace mlp;

constexpr long P_NUMEL = W_NUMEL + B_NUMEL;  // one CTA's partial (floats)

// acc (4 feature tiles x 2 column tiles) of dW rows [f0, f0 + 16 nt) +=
// src[:, c0 : c0 + 16 nt]^T @ delta, for the warp's 32 columns; src is
// [BM][lds] bf16 in shared memory, delta is s.h.
__device__ void dw_pass(const Smem& s, float* dw, int ldw, int f0,
                        const bf16* src, int lds, int c0, int nt) {
  const int warp = threadIdx.x / 32;
  FragC acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (i < nt)
        wmma::load_matrix_sync(acc[i][j],
                               dw + (long)(f0 + 16 * i) * ldw +
                                   (2 * warp + j) * 16,
                               ldw, wmma::mem_row_major);
  for (int k = 0; k < BM; k += 16) {
    FragB b[2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::load_matrix_sync(b[j], s.h + k * W + (2 * warp + j) * 16, W);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < nt) {
        FragAT a;  // (features x points) = src^T, col-major view of src
        wmma::load_matrix_sync(a, src + k * lds + c0 + 16 * i, lds);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (i < nt)
        wmma::store_matrix_sync(
            dw + (long)(f0 + 16 * i) * ldw + (2 * warp + j) * 16, acc[i][j],
            ldw, wmma::mem_row_major);
}

// All of dW_i for the block: act_i = s.emb (i = 0), [s.emb, act] (i = SKIP
// + 1) or act.
__device__ void dw_layer(const Smem& s, const bf16* act, float* part,
                         int layer) {
  float* dw = part + w_offset(layer);
  if (layer == 0 || layer == SKIP + 1)
    dw_pass(s, dw, W, 0, s.emb, EMB_PAD, 0, EMB_PAD / 16);
  if (layer != 0) {
    const int f0 = layer == SKIP + 1 ? EMB_PAD : 0;
    for (int t = 0; t < W / 16; t += 4) dw_pass(s, dw, W, f0 + 16 * t, act, W, 16 * t, 4);
  }
}

// Epilogue of a delta product held in acc: delta = acc * (mask > 0), stored
// bf16 into s.h (which may hold the mask itself), column sums added in f32
// to the CTA's db partial of the layer.
__device__ void delta_epilogue(const Smem& s, FragC (&acc)[4][2],
                               const bf16* mask, float* db) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* st = s.stage + warp * 256;
  float colsum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int e = lane * 8 + t;
        const int idx = (i * 16 + e / 16) * W + (2 * warp + j) * 16 + e % 16;
        const float d =
            __bfloat162float(mask[idx]) > 0.f ? st[e] : 0.f;
        st[e] = d;
        s.h[idx] = __float2bfloat16(d);
      }
      __syncwarp();
      if (lane < 16) {
        float cs = 0.f;
        for (int r = 0; r < 16; ++r) cs += st[r * 16 + lane];
        colsum[j] += cs;
      }
      __syncwarp();
    }
  }
  if (lane < 16) {
#pragma unroll
    for (int j = 0; j < 2; ++j) db[(2 * warp + j) * 16 + lane] += colsum[j];
  }
}

__global__ void __launch_bounds__(NTHREADS)
    mlp_bwd_kernel(const void* __restrict__ x, int x_is_uv, int multires,
                   const float* __restrict__ g, const bf16* __restrict__ wg,
                   const float* __restrict__ bg, bf16* __restrict__ scratch,
                   float* __restrict__ partial, int n) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem s;
  s.w = reinterpret_cast<bf16*>(smem_raw);
  s.h = s.w + WROWS * W;
  s.emb = s.h + BM * W;
  bf16* act = s.emb + BM * EMB_PAD;  // [BM][W] act_i (hidden part)
  bf16* gs = act + BM * W;           // [BM][OUT_PAD]
  s.stage = reinterpret_cast<float*>(gs + BM * OUT_PAD);

  const int warp = threadIdx.x / 32;
  float* part = partial + (long)blockIdx.x * P_NUMEL;
  bf16* slot = scratch + (long)blockIdx.x * DEPTH * BM * W;
  for (long p = threadIdx.x; p < P_NUMEL; p += NTHREADS) part[p] = 0.f;

  const int nblocks = (n + BM - 1) / BM;
  for (int blk = blockIdx.x; blk < nblocks; blk += gridDim.x) {
    const int row0 = blk * BM;
    __syncthreads();
    load_embedding(s, x, x_is_uv, multires, row0, n);
    // forward recompute; act_{l+1} = output of layer l parks in slot[l]
    for (int layer = 0; layer < DEPTH; ++layer)
      hidden_layer(s, wg, bg, layer, slot + (long)layer * BM * W);

    // output layer: g (padded to 16 columns) and db_out
    for (int e = threadIdx.x; e < BM * OUT_PAD; e += NTHREADS) {
      const int r = e / OUT_PAD, c = e % OUT_PAD, row = row0 + r;
      gs[e] = __float2bfloat16(c < 3 && row < n ? g[3 * (long)row + c] : 0.f);
    }
    if (threadIdx.x < 3) {
      float cs = 0.f;
      for (int r = 0; r < BM && row0 + r < n; ++r)
        cs += g[3 * (long)(row0 + r) + threadIdx.x];
      part[W_NUMEL + b_offset(DEPTH) + threadIdx.x] += cs;
    }
    load_weights(s, wg, DEPTH, 0, W);  // (256, 16); s.w is free after layer 7
    __syncthreads();
    {  // dW_out (256 x 16) += act_8^T (s.h) @ g; warp w: feature tiles 2w, 2w+1
      float* dw = part + w_offset(DEPTH);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int f = (2 * warp + q) * 16;
        FragC acc;
        wmma::load_matrix_sync(acc, dw + f * OUT_PAD, OUT_PAD,
                               wmma::mem_row_major);
        for (int k = 0; k < BM; k += 16) {
          FragAT a;
          FragB b;
          wmma::load_matrix_sync(a, s.h + k * W + f, W);
          wmma::load_matrix_sync(b, gs + k * OUT_PAD, OUT_PAD);
          wmma::mma_sync(acc, a, b, acc);
        }
        wmma::store_matrix_sync(dw + f * OUT_PAD, acc, OUT_PAD,
                                wmma::mem_row_major);
      }
    }
    {  // delta_7 = (g @ W_out^T) * (act_8 > 0)
      FragC acc[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        FragA a;
        wmma::load_matrix_sync(a, gs + i * 16 * OUT_PAD, OUT_PAD);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          FragBT b;  // W_out^T: element (k, n) = W_out[n][k]
          wmma::load_matrix_sync(b, s.w + (2 * warp + j) * 16 * OUT_PAD,
                                 OUT_PAD);
          wmma::fill_fragment(acc[i][j], 0.f);
          wmma::mma_sync(acc[i][j], a, b, acc[i][j]);
        }
      }
      __syncthreads();  // dW_out is done reading act_8 in s.h
      delta_epilogue(s, acc, s.h, part + W_NUMEL + b_offset(DEPTH - 1));
    }

    for (int layer = DEPTH - 1; layer >= 0; --layer) {
      __syncthreads();  // delta in s.h is complete
      if (layer > 0) {
        copy_vec(act, slot + (long)(layer - 1) * BM * W, BM * W / 8);
        load_weights(s, wg, layer, layer == SKIP + 1 ? EMB_PAD : 0, W);
      }
      __syncthreads();
      dw_layer(s, act, part, layer);
      if (layer == 0) break;
      // delta_{layer-1} = (delta @ W_layer^T) * (act_layer > 0)
      FragC acc[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
      for (int k = 0; k < W; k += 16) {
        FragBT b[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], s.w + (2 * warp + j) * 16 * W + k, W);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          FragA a;
          wmma::load_matrix_sync(a, s.h + i * 16 * W + k, W);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
        }
      }
      __syncthreads();  // every warp is done reading delta in s.h
      delta_epilogue(s, acc, act, part + W_NUMEL + b_offset(layer - 1));
    }
  }
}

__global__ void mlp_bwd_reduce_kernel(const float* __restrict__ partial,
                                      float* __restrict__ total, long numel,
                                      int grid) {
  const long p = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= numel) return;
  float acc = 0.f;
  for (int c = 0; c < grid; ++c) acc += partial[(long)c * numel + p];
  total[p] = acc;
}

static size_t smem_bytes() {
  return sizeof(bf16) * (WROWS * W + BM * W + BM * EMB_PAD + BM * W +
                         BM * OUT_PAD) +
         sizeof(float) * NWARPS * 256;
}

extern "C" int mlp_bwd(const void* x, int x_is_uv, int multires,
                       const void* g, const void* w, const void* b,
                       void* scratch, void* partial, int n, int grid,
                       void* stream) {
  const size_t smem = smem_bytes();
  cudaFuncSetAttribute(mlp_bwd_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  mlp_bwd_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      x, x_is_uv, multires, reinterpret_cast<const float*>(g),
      reinterpret_cast<const bf16*>(w), reinterpret_cast<const float*>(b),
      reinterpret_cast<bf16*>(scratch), reinterpret_cast<float*>(partial), n);
  return (int)cudaGetLastError();
}

extern "C" int mlp_bwd_reduce(const void* partial, void* total, int numel,
                              int grid, void* stream) {
  if (numel != (int)P_NUMEL) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int blocks = (int)((numel + threads - 1) / threads);
  mlp_bwd_reduce_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float*>(partial),
      reinterpret_cast<float*>(total), numel, grid);
  return (int)cudaGetLastError();
}
