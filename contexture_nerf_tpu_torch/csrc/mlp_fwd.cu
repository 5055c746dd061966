// K1: fused Fourier embedding + NeRF2D MLP forward, hand-written for Hopper.
//
// Replaces: contexture_nerf_tpu/ops/mlp_kernel.py `_fwd_kernel` (the
// pallas_call in `_run_forward`), reached by `fused_nerf2d` and
// `fused_nerf2d_emb`.
//
// What bounds it on an H100: operations. A point costs about 0.96 MFLOP
// (2 x (48x256 + 4x256x256 + 304x256 + 2x256x256 + 256x16)) against 96 bytes
// of embedding in and 12 bytes out, far above the card's ~295 FLOP/byte
// ridge, so the bf16 tensor cores (989 TFLOP/s dense) set the floor.
//
// What the design does about it: the activations never leave the SM. A CTA
// of 8 warps owns 64 points; their activations live in shared memory (bf16,
// f32 accumulators in registers) for all 9 layers, so only the embedding (or
// uv) is read and the (N, 3) output written. The ~1 MB of bf16 weights do
// not fit in shared memory, so each layer's weights stream through it, at
// most 256 rows (128 KB) at a time, served mostly from L2. Matmuls are WMMA
// bf16 16x16x16 with f32 accumulation. This first version loads a layer's
// weights and then computes, without overlapping the two; overlapping them
// (cp.async or TMA double buffering) and wgmma are the next steps.
//
// C interface: int mlp_fwd(x, x_is_uv, multires, w, b, out, n, stream)
// returns cudaGetLastError() after the launch.
#include "mlp_common.cuh"

using namespace mlp;

__global__ void __launch_bounds__(NTHREADS)
    mlp_fwd_kernel(const void* __restrict__ x, int x_is_uv, int multires,
                   const bf16* __restrict__ wg, const float* __restrict__ bg,
                   float* __restrict__ out, int n) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem s;
  s.w = reinterpret_cast<bf16*>(smem_raw);
  s.h = s.w + WROWS * W;
  s.emb = s.h + BM * W;
  s.stage = reinterpret_cast<float*>(s.emb + BM * EMB_PAD);

  const int row0 = blockIdx.x * BM;
  load_embedding(s, x, x_is_uv, multires, row0, n);
  for (int layer = 0; layer < DEPTH; ++layer)
    hidden_layer(s, wg, bg, layer, nullptr);

  // output layer: (64, 256) @ (256, 16); warps 0-3 take one row tile each
  __syncthreads();
  load_weights(s, wg, DEPTH, 0, W);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp < BM / 16) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int k = 0; k < W; k += 16) {
      FragA a;
      FragB b;
      wmma::load_matrix_sync(a, s.h + warp * 16 * W + k, W);
      wmma::load_matrix_sync(b, s.w + k * OUT_PAD, OUT_PAD);
      wmma::mma_sync(acc, a, b, acc);
    }
    float* st = s.stage + warp * 256;
    wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
    __syncwarp();
    const float* bias = bg + b_offset(DEPTH);
    for (int e = lane; e < 16 * 3; e += 32) {
      const int r = e / 3, c = e % 3;
      const int row = row0 + warp * 16 + r;
      if (row < n) out[3 * (long)row + c] = st[r * 16 + c] + bias[c];
    }
  }
}

static size_t smem_bytes() {
  return sizeof(bf16) * (WROWS * W + BM * W + BM * EMB_PAD) +
         sizeof(float) * NWARPS * 256;
}

extern "C" int mlp_fwd(const void* x, int x_is_uv, int multires,
                       const void* w, const void* b, void* out, int n,
                       void* stream) {
  const size_t smem = smem_bytes();
  cudaFuncSetAttribute(mlp_fwd_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const int grid = (n + BM - 1) / BM;
  if (grid > 0)
    mlp_fwd_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
        x, x_is_uv, multires, reinterpret_cast<const bf16*>(w),
        reinterpret_cast<const float*>(b), reinterpret_cast<float*>(out), n);
  return (int)cudaGetLastError();
}
