// Shared pieces of the NeRF2D MLP kernels (mlp_fwd.cu, mlp_bwd.cu).
//
// Packed layout (ops/mlp_kernel.py): layer i weight (K_i, N_i) row-major in
// bf16, K = 48, 256 x4, 48 + 256, 256 x2, then the output layer (256, 16);
// biases f32, 256 per hidden layer then 16. The 42-dim Fourier embedding is
// zero-padded to 48, a multiple of the 16-deep bf16 tensor-core step.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mlp {

typedef __nv_bfloat16 bf16;

constexpr int EMB_PAD = 48;
constexpr int W = 256;
constexpr int SKIP = 4;
constexpr int DEPTH = 8;
constexpr int OUT_PAD = 16;

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

}  // namespace mlp
