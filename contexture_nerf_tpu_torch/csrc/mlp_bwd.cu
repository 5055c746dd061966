// K2: NeRF2D MLP backward (parameter gradients), hand-written for Hopper.
//
// Replaces: contexture_nerf_tpu/ops/mlp_kernel.py `_bwd_kernel` (the
// pallas_call in `_run_backward`), the custom VJP of `fused_nerf2d` and
// `fused_nerf2d_emb`. The gradient w.r.t. uv / the embedding is zero there
// and is not computed here.
//
// What it computes (the reference's math): the forward recomputed with bf16
// operands and f32 sums; dW_8 = act_8^T bf16(g), db_8 = sum g; delta_7 =
// bf16(g) W_8^T masked by act_8 > 0; then for i = 7..0 dW_i = act_i^T
// bf16(delta_i) (f32 sums), db_i = the column sums of the f32 delta_i, and
// delta_{i-1} = bf16(delta_i) W_i^T masked by act_i > 0 (at the skip only
// W_5's h4 rows carry delta back).
//
// What bounds it on an H100: operations, for the function: about 3x the
// forward's products a point (~2.9 MFLOP), 0.58 ms at the 448^2 slice. This
// two-phase design also moves bytes the function need not: each point's
// activations and deltas (2 x 8 x 256 bf16) are written once and read once
// or twice, ~3.3-4.9 GB at the slice, a floor of ~1.0-1.5 ms at 3.35 TB/s.
//
// Design: two phases; no CTA keeps a partial of the whole dW, and no WMMA.
//  - Phase A is two instantiations of K1's pipeline (mlp_fwd.cu: clusters
//    of 4 CTAs on a persistent grid, weight slabs multicast by TMA, wgmma
//    m64n256k16 with A in registers). `mlp_fwd_acts` (STORE_ACTS)
//    recomputes the forward and writes each point's bf16 activations
//    act_1..act_8 into an (N, 8 x 256) buffer (and, for the uv input, its
//    (N, 48) embedding). `mlp_delta` (DELTA) streams the transposed weight
//    stack instead, starts from bf16(g), masks each layer's accumulator by
//    the stored activations and writes the bf16 delta_7..delta_0 into a
//    second (N, 8 x 256) buffer; db is summed from the f32 deltas in a
//    fixed order into one partial per consumer warpgroup.
//  - Phase B (`mlp_bwd_dw`, this file) computes dW_i = A_i^T Delta_i for
//    layers 0-7 as a split-K GEMM over the points. A work unit is (128-row
//    block of one layer's dW, chunk of points): 16 row blocks (1 for layer
//    0's 48 embedding rows, 2 each for layers 1-4, 6, 7, 1 + 2 for layer
//    5) times `chunks` chunks, so the grid is whole waves of the card's
//    SMs. Shaped like flash_attn.cu: a producer warpgroup (setmaxnreg 24)
//    TMA-loads per 64-point k-step the act tile (64 points x 128 features)
//    and the delta tile (64 x 256) into a ring of 128-byte-swizzled
//    stages; two consumer warpgroups each own 64 feature rows and run wgmma
//    m64n256k16 with both operands MN-major from shared memory (the feature
//    dimension contiguous). The embedding rows read a 48-wide tensor map
//    whose out-of-bounds columns TMA fills with zeros; points past N read
//    zeros. Each unit writes its f32 tile into its chunk's partial of
//    dW_0..dW_7.
//  - `mlp_bwd_dw_out` sums dW_8 (256 x 3) on the CUDA cores per 256-point
//    chunk, in point order.
//  - `mlp_bwd_reduce` adds partials in chunk (or warpgroup) order.
// No float atomics and fixed summation orders: two runs are bit-identical.
//
// C interface (each returns cudaGetLastError() after its launch, or 1000 +
// the CUresult of a failed tensor-map encode):
//   int mlp_bwd_dw(acts, deltas, emb, partial, blocks, n, chunks, steps,
//                  stream)   (blocks: the 16 row blocks, 4 ints each)
//   int mlp_bwd_dw_out(acts, g, partial, n, stream)
//   int mlp_bwd_reduce(partial, total, numel, count, stream)
#include <cuda.h>

#include "hopper.cuh"
#include "mlp_common.cuh"

using namespace mlp;

namespace {

constexpr int ACTS_LD = DEPTH * W;  // columns of the act and delta buffers
constexpr long HIDDEN_NUMEL = w_offset(DEPTH);  // dW_0..dW_7: 483,328 floats
constexpr int OUT_CHUNK = 256;                  // points a dW_8 partial

// ---- phase B: dW_0..dW_7 -------------------------------------------------

constexpr int KSTEP = 64;                  // points a k-step (a stage)
constexpr int BOX = 64 * 64 * 2;           // one 64-point x 64-feature box
constexpr int STAGE_A = 2 * BOX;           // act tile: 128 features
constexpr int STAGE = STAGE_A + 4 * BOX;   // + delta tile: 256 features
constexpr int STAGES = 4;
constexpr int DW_THREADS = 384;            // 2 consumer warpgroups + producer
constexpr int DW_SMEM = STAGES * STAGE + 16 * STAGES + 1024;
constexpr int ROW_BLOCKS = 16;
static_assert(DW_SMEM <= 232448, "shared memory of a CTA");
static_assert(2 * 32 * 240 + 32 * 24 <= 16384, "registers of a sub-partition");

// row block rb of dW_0..dW_7 (ops/mlp_kernel.dw_row_blocks): its layer,
// the act-buffer column of its first feature (-1: the embedding), its
// first dW row and its row count (at most 128; an embedding block's at most
// 64, one warpgroup's rows)
struct RowBlock {
  int layer, acol, row0, rows;
};

struct DwParams {
  float* partial;  // [chunks][HIDDEN_NUMEL]
  int steps;       // k-steps a chunk
  int ksteps;      // k-steps in all
  RowBlock blocks[ROW_BLOCKS];
};

__global__ void __launch_bounds__(DW_THREADS, 1)
    mlp_bwd_dw_kernel(__grid_constant__ const CUtensorMap tm_act,
                      __grid_constant__ const CUtensorMap tm_delta,
                      __grid_constant__ const CUtensorMap tm_emb,
                      __grid_constant__ const DwParams p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + STAGES * STAGE, empty = full + 8 * STAGES;
  const int rb = blockIdx.x % ROW_BLOCKS, chunk = blockIdx.x / ROW_BLOCKS;
  const RowBlock b = p.blocks[rb];
  const bool emb = b.acol < 0;
  const int s0 = chunk * p.steps;
  const int nsteps = max(0, min(s0 + p.steps, p.ksteps) - s0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, 8);  // one arrive per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer warpgroup: one thread issues the loads ----
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      for (int i = 0; i < nsteps; ++i) {
        const uint32_t st = i % STAGES, ph = (i / STAGES) & 1;
        const uint32_t dst = base + st * STAGE, bar = full + 8 * st;
        const int pt = (s0 + i) * KSTEP;
        hopper::mbar_wait(empty + 8 * st, ph ^ 1);  // the first round passes
        hopper::mbar_arrive_expect_tx(bar, (emb ? BOX : STAGE_A) + 4 * BOX);
        if (emb) {
          hopper::tma_load_2d(dst, &tm_emb, bar, 0, pt);
        } else {
          hopper::tma_load_2d(dst, &tm_act, bar, b.acol, pt);
          hopper::tma_load_2d(dst + BOX, &tm_act, bar, b.acol + 64, pt);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          hopper::tma_load_2d(dst + STAGE_A + q * BOX, &tm_delta, bar,
                              b.layer * W + 64 * q, pt);
      }
    }
  } else {
    // ---- consumer warpgroups: rows 64 wg .. 64 wg + 63 of the block ----
    hopper::setmaxnreg_inc<240>();
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const bool active = !(emb && wg == 1);  // 48 rows: one warpgroup
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    auto release = [&](int i) {
      if (lane == 0) hopper::mbar_arrive(empty + 8 * (i % STAGES));
    };
    for (int i = 0; i < nsteps; ++i) {
      const uint32_t st = i % STAGES;
      hopper::mbar_wait(full + 8 * st, (i / STAGES) & 1);
      if (!active) {
        release(i);
        continue;
      }
      const uint32_t a = base + st * STAGE + wg * BOX, d = base + st * STAGE + STAGE_A;
      hopper::fence_operand(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEP / 16; ++kk)
        hopper::wgmma_ss_tt<256>(acc, hopper::desc_sw128(a + kk * 2048),
                                 hopper::desc_sw128_mn(d + kk * 2048, BOX), 1);
      hopper::wgmma_commit();
      if (i > 0) {
        hopper::wgmma_wait<1>();
        release(i - 1);
      }
    }
    if (active) {
      hopper::wgmma_wait<0>();
      hopper::fence_operand(acc);
      if (nsteps > 0) release(nsteps - 1);
      // acc[4j + e]: row 16 warp + lane/4 + 8 (e >= 2), column 8j + 2 (lane
      // % 4) + (e & 1)
      const int r = 64 * wg + 16 * warp + lane / 4;
      float* out = p.partial + (long)chunk * HIDDEN_NUMEL + w_offset(b.layer) +
                   (long)(b.row0 + r) * W + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
        if (r < b.rows)
          *reinterpret_cast<float2*>(out + 8 * j) =
              make_float2(acc[4 * j], acc[4 * j + 1]);
        if (r + 8 < b.rows)
          *reinterpret_cast<float2*>(out + 8 * W + 8 * j) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

// a (rows, cols) bf16 matrix, rows `ld` elements apart, in boxes of 64 rows
// x 64 columns with 128-byte swizzle
int make_map(CUtensorMap* map, const void* ptr, int cols, int rows, int ld) {
  hopper::EncodeTiled fn = hopper::tensor_map_encoder();
  if (fn == nullptr) return 1000 + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(ptr), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

// ---- dW_8 and the reductions ---------------------------------------------

// dW_8 (256 x 16, columns 3.. zero) of the points [c OUT_CHUNK, (c + 1)
// OUT_CHUNK) for block c: thread f sums act_8[p][f] bf16(g[p][:3]) in point
// order
__global__ void __launch_bounds__(W)
    mlp_bwd_dw_out_kernel(const bf16* __restrict__ acts,
                          const float* __restrict__ g,
                          float* __restrict__ partial, int n) {
  const int f = threadIdx.x, p0 = blockIdx.x * OUT_CHUNK;
  const int p1 = min(p0 + OUT_CHUNK, n);
  float s[3] = {0.f, 0.f, 0.f};
#pragma unroll 8
  for (int q = p0; q < p1; ++q) {
    const float h = __bfloat162float(acts[(long)q * ACTS_LD + (DEPTH - 1) * W + f]);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      s[c] = __fadd_rn(s[c], __fmul_rn(h, __bfloat162float(__float2bfloat16(
                                              g[3 * (long)q + c]))));
  }
  float* o = partial + (long)blockIdx.x * W * OUT_PAD + f * OUT_PAD;
#pragma unroll
  for (int c = 0; c < OUT_PAD; ++c) o[c] = c < 3 ? s[c] : 0.f;
}

// total[p] = sum over c < count, in order, of partial[c numel + p]
__global__ void mlp_bwd_reduce_kernel(const float* __restrict__ partial,
                                      float* __restrict__ total, long numel,
                                      int count) {
  const long p = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= numel) return;
  float acc = 0.f;
  for (int c = 0; c < count; ++c) acc += partial[(long)c * numel + p];
  total[p] = acc;
}

}  // namespace

extern "C" int mlp_bwd_dw(const void* acts, const void* deltas,
                          const void* emb, void* partial, const int* blocks,
                          int n, int chunks, int steps, void* stream) {
  CUtensorMap ma, md, me;
  int err = make_map(&ma, acts, ACTS_LD, n, ACTS_LD);
  if (!err) err = make_map(&md, deltas, ACTS_LD, n, ACTS_LD);
  if (!err) err = make_map(&me, emb, EMB_PAD, n, EMB_PAD);
  if (err) return err;
  cudaFuncSetAttribute(mlp_bwd_dw_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, DW_SMEM);
  DwParams p;
  p.partial = reinterpret_cast<float*>(partial);
  p.steps = steps;
  p.ksteps = (n + KSTEP - 1) / KSTEP;
  for (int rb = 0; rb < ROW_BLOCKS; ++rb)
    p.blocks[rb] = {blocks[4 * rb], blocks[4 * rb + 1], blocks[4 * rb + 2],
                    blocks[4 * rb + 3]};
  mlp_bwd_dw_kernel<<<ROW_BLOCKS * chunks, DW_THREADS, DW_SMEM,
                      (cudaStream_t)stream>>>(ma, md, me, p);
  return (int)cudaGetLastError();
}

extern "C" int mlp_bwd_dw_out(const void* acts, const void* g, void* partial,
                              int n, void* stream) {
  mlp_bwd_dw_out_kernel<<<(n + OUT_CHUNK - 1) / OUT_CHUNK, W, 0,
                          (cudaStream_t)stream>>>(
      reinterpret_cast<const bf16*>(acts), reinterpret_cast<const float*>(g),
      reinterpret_cast<float*>(partial), n);
  return (int)cudaGetLastError();
}

extern "C" int mlp_bwd_reduce(const void* partial, void* total, int numel,
                              int count, void* stream) {
  const int threads = 256;
  mlp_bwd_reduce_kernel<<<(numel + threads - 1) / threads, threads, 0,
                          (cudaStream_t)stream>>>(
      reinterpret_cast<const float*>(partial),
      reinterpret_cast<float*>(total), numel, count);
  return (int)cudaGetLastError();
}
