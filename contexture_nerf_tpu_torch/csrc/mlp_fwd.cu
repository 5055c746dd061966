// K1: fused Fourier embedding + NeRF2D MLP forward, hand-written for Hopper
// (sm_90a): TMA multicast, wgmma, warp specialisation, a persistent grid.
//
// Replaces: contexture_nerf_tpu/ops/mlp_kernel.py `_fwd_kernel` (the
// pallas_call in `_run_forward`), reached by `fused_nerf2d` and
// `fused_nerf2d_emb`.
//
// What it computes (layout of mlp_common.cuh): the embedding from uv
// (sin/cos in f32) or the precomputed (N, 48) bf16 embedding; 8 hidden
// layers relu(h W + b) with bf16 operands and f32 accumulation, the
// activations rounded to bf16 for each product, [emb, h4] as layer 5's
// input; then the output layer's 3 real columns, (N, 3) f32.
//
// What bounds it on an H100: operations. A point costs about 0.96 MFLOP
// (2 x (48x256 + 4x256x256 + 304x256 + 2x256x256 + 256x16)) against 96 bytes
// of embedding in and 12 bytes out, far above the card's ~295 FLOP/byte
// ridge, so the bf16 tensor cores (989 TFLOP/s dense) set the floor. The
// second limit is L2: a CTA of 128 points needs all ~0.95 MB of weights once
// per tile, about 32 bytes a clock per SM at the tensor cores' rate.
//
// What the design does about it (the shape of flash_attn.cu): a CTA has a
// producer warpgroup (one thread issues TMA loads; setmaxnreg 24) and two
// consumer warpgroups (240 registers) of 64 points each. The 8 hidden
// layers' weights are one (1888, 256) row-major bf16 matrix (the packed
// layout lays them out layer after layer); the producer streams it in
// slabs of 16 rows (one k16 step) into a ring of STAGES 128-byte-swizzled
// slabs, each guarded by full and empty mbarriers, and runs ahead across
// layer and tile boundaries. CTAs work in clusters of CS = 4 on a
// persistent grid: each slab is loaded once per cluster, each CTA's
// producer fetching a quarter of its columns (one 64-column box) by TMA
// multicast into all four CTAs, so L2 serves each weight byte once per
// 512 points; a slab is refilled only
// after the consumers of every CTA of the cluster released it (each
// consumer warp arrives on one CTA's empty barrier, spread over the
// cluster, with CTA-scope release: a cluster-scope release on every k16
// step was the first version's bottleneck). Each
// consumer warpgroup runs a hidden layer as wgmma m64n256k16 per slab: A
// from registers, B (the (K, N) weights, N-major) from shared memory
// through the transpose flag. After a layer the f32 accumulator gets its
// bias and ReLU, is rounded to bf16 and re-packed in registers as the next
// layer's A fragments, as flash_attn.cu re-packs P; the embedding's
// fragments are kept in shared memory for layer 5. The output layer (3
// columns) runs on the CUDA cores: each thread's 32 bf16 activations of a
// row times the weights, summed in a fixed order and across its quad by
// shuffles. Only the input and the (N, 3) output touch device memory.
// Every point's arithmetic is the same wherever its tile runs, so two runs
// are bit-identical.
//
// C interface: int mlp_fwd(x, x_is_uv, multires, w, b, out, n, stream)
// returns cudaGetLastError() after the launch, or 1000 + the CUresult of a
// failed tensor-map encode, or 2000 if no cluster fits on the card.
#include <cuda.h>

#include "hopper.cuh"
#include "mlp_common.cuh"

using namespace hopper;
using mlp::bf16;

namespace {

constexpr int NC = 2;             // consumer warpgroups
constexpr int BM = 64 * NC;       // points a CTA tile
constexpr int THREADS = 128 * NC + 128;
constexpr int CS = 4;             // CTAs a cluster, sharing every slab
constexpr int N = mlp::W;         // hidden width: 256 columns
constexpr int HIDDEN_ROWS = (int)(mlp::w_offset(mlp::DEPTH) / N);  // 1888
constexpr int STEPS = HIDDEN_ROWS / 16;   // k16 steps (slabs) a tile: 118
constexpr int SLAB = 16 * N * 2;          // bytes a slab: 8 KB
constexpr int BOX = 16 * 64 * 2;          // one 16 x 64 TMA box: 2 KB
constexpr int STAGES = 24;
constexpr int IN_FLIGHT = 2;  // wgmma groups a warpgroup leaves in flight
constexpr int EMB_STEPS = mlp::EMB_PAD / 16;  // 3
constexpr int OFF_BIAS = STAGES * SLAB;
constexpr int OFF_WOUT = OFF_BIAS + mlp::DEPTH * N * 4;
constexpr int OFF_EMB = OFF_WOUT + N * 16;  // float4 per weight row
constexpr int OFF_BAR = OFF_EMB + NC * 4 * EMB_STEPS * 128 * 4;
constexpr int SMEM = OFF_BAR + 16 * STAGES + 1024;  // + alignment slack
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
static_assert(NC * 32 * CONSUMER_REGS + 32 * PRODUCER_REGS <= 16384,
              "registers of one sub-partition");
static_assert(SMEM <= 232448, "shared memory of a CTA");
static_assert(HIDDEN_ROWS == 1888 && STEPS * 16 == HIDDEN_ROWS, "layout");
static_assert(4 % CS == 0, "each CTA multicasts whole 64-column boxes");

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// embedding column c of the point (u, v): [u, v, sin 1u, sin 1v, cos 1u,
// cos 1v, sin 2u, ...], zero past 2 + 4 multires
__device__ __forceinline__ float emb_col(float u, float v, int c,
                                         int multires) {
  if (c == 0) return u;
  if (c == 1) return v;
  const int i = (c - 2) >> 2, m = (c - 2) & 3;
  if (i >= multires) return 0.f;
  const float a = (m & 1 ? v : u) * ldexpf(1.f, i);
  return m < 2 ? sinf(a) : cosf(a);
}

struct Params {
  const void* x;
  const float* bias;
  const bf16* wout;  // the output layer (256, 16)
  float* out;
  int n, x_is_uv, multires, tiles;  // tiles of CS * BM points
};

__global__ void __launch_bounds__(THREADS, 1)
    mlp_fwd_kernel(__grid_constant__ const CUtensorMap tw, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - smem_u32(smem_raw));
  float* bias_s = reinterpret_cast<float*>(sbase + OFF_BIAS);
  float4* wout_s = reinterpret_cast<float4*>(sbase + OFF_WOUT);
  uint32_t* emb_s = reinterpret_cast<uint32_t*>(sbase + OFF_EMB);
  const uint32_t full = base + OFF_BAR, empty = full + 8 * STAGES;
  const int rank = (int)cluster_rank();
  const int cluster = blockIdx.x / CS, clusters = gridDim.x / CS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * NC);  // one arrive per consumer warp
    }
    fence_barrier_init();
  }
  for (int i = threadIdx.x; i < mlp::DEPTH * N; i += THREADS)
    bias_s[i] = p.bias[i];
  for (int k = threadIdx.x; k < N; k += THREADS) {
    const bf16* r = p.wout + k * mlp::OUT_PAD;
    wout_s[k] = make_float4(__bfloat162float(r[0]), __bfloat162float(r[1]),
                            __bfloat162float(r[2]), 0.f);
  }
  __syncthreads();
  cluster_sync();  // every CTA's barriers exist before any multicast

  if (threadIdx.x >= NC * 128) {
    // ---- producer warpgroup: one thread streams the slabs ----
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == NC * 128) {
      uint32_t it = 0;
      for (int t = cluster; t < p.tiles; t += clusters) {
        for (int s = 0; s < STEPS; ++s, ++it) {
          const uint32_t st = it % STAGES, ph = (it / STAGES) & 1;
          mbar_wait(empty + 8 * st, ph ^ 1);  // the first round passes
          mbar_arrive_expect_tx(full + 8 * st, SLAB);
#pragma unroll
          for (int b = rank * (4 / CS); b < (rank + 1) * (4 / CS); ++b)
            tma_load_2d_multicast(base + st * SLAB + b * BOX, &tw,
                                  full + 8 * st, 64 * b, 16 * s,
                                  (uint16_t)((1 << CS) - 1));
        }
      }
    }
  } else {
    // ---- consumer warpgroups ----
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, quad = lane & 3;
    uint32_t* emb_slot = emb_s + wg * 4 * EMB_STEPS * 128 + tid;
    float acc[2 * N / 4];  // 64 x 256 f32: 128 a thread
    uint32_t a[N / 16][4];  // the next layer's A: 16 k16 steps
#pragma unroll
    for (int i = 0; i < 2 * N / 4; ++i) acc[i] = 0.f;
    uint32_t it = 0;  // slabs consumed
    int issued = 0;   // k16 steps issued in this layer

    // a slab is done with once its product has completed: warp w tells
    // CTA w % CS of the cluster (a warpgroup's wgmma completes as a whole,
    // so each CTA hears from every warpgroup of every CTA)
    auto release = [&](uint32_t st) {
      if (lane == 0) mbar_arrive_cluster(mapa(empty + 8 * st, warp % CS));
    };
    // one k16 step: acc (+)= af * slab; the slab IN_FLIGHT steps back is
    // released once its product is done
    auto step = [&](const uint32_t (&af)[4]) {
      const uint32_t st = it % STAGES;
      mbar_wait(full + 8 * st, (it / STAGES) & 1);
      wgmma_rs_tb<256>(acc, af, desc_sw128_mn(base + st * SLAB, BOX),
                       issued > 0);
      wgmma_commit();
      if (issued >= IN_FLIGHT) {
        wgmma_wait<IN_FLIGHT>();
        release((it - IN_FLIGHT) % STAGES);
      }
      ++issued;
      ++it;
    };
    // bias, ReLU and bf16 of hidden layer l's accumulator, as A fragments:
    // acc[4j + e] is row 16 warp + lane/4 + 8(e >= 2), column
    // 8j + 2(lane % 4) + (e & 1); k16 step kk takes columns 16kk..16kk+15
    auto epilogue = [&](int l) {
      wgmma_wait<0>();
      fence_operand(acc);
      for (int d = min(issued, IN_FLIGHT); d > 0; --d)
        release((it - d) % STAGES);
      issued = 0;
      const float* bl = bias_s + l * N + 2 * quad;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const float2 b = *reinterpret_cast<const float2*>(bl + 8 * j);
        const uint32_t r0 = pack_bf16(fmaxf(acc[4 * j] + b.x, 0.f),
                                      fmaxf(acc[4 * j + 1] + b.y, 0.f));
        const uint32_t r1 = pack_bf16(fmaxf(acc[4 * j + 2] + b.x, 0.f),
                                      fmaxf(acc[4 * j + 3] + b.y, 0.f));
        a[j / 2][(j & 1) * 2] = r0;
        a[j / 2][(j & 1) * 2 + 1] = r1;
      }
    };

    for (int t = cluster; t < p.tiles; t += clusters) {
      const int row0 = (t * CS + rank) * BM + wg * 64 + warp * 16 + lane / 4;
      // the embedding's A fragments (rows row0, row0 + 8), kept in shared
      // memory for layer 5
      {
        uint32_t e[EMB_STEPS][4];
#pragma unroll
        for (int kk = 0; kk < EMB_STEPS; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int row = row0 + 8 * (q & 1);
            const int c = 16 * kk + 2 * quad + 8 * (q >> 1);
            uint32_t val = 0;
            if (row < p.n) {
              if (p.x_is_uv) {
                const float2 uv =
                    reinterpret_cast<const float2*>(p.x)[row];
                val = pack_bf16(emb_col(uv.x, uv.y, c, p.multires),
                                emb_col(uv.x, uv.y, c + 1, p.multires));
              } else {
                val = *reinterpret_cast<const uint32_t*>(
                    reinterpret_cast<const bf16*>(p.x) +
                    (long)row * mlp::EMB_PAD + c);
              }
            }
            e[kk][q] = val;
            emb_slot[(4 * kk + q) * 128] = val;
          }
        // layer 0
        fence_operand(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < EMB_STEPS; ++kk) step(e[kk]);
      }
      epilogue(0);
      for (int l = 1; l < mlp::DEPTH; ++l) {
        if (l == mlp::SKIP + 1) {  // [emb, h4]: the embedding's rows first
          uint32_t e[EMB_STEPS][4];
#pragma unroll
          for (int kk = 0; kk < EMB_STEPS; ++kk)
#pragma unroll
            for (int q = 0; q < 4; ++q) e[kk][q] = emb_slot[(4 * kk + q) * 128];
          fence_operand(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < EMB_STEPS; ++kk) step(e[kk]);
#pragma unroll
          for (int kk = 0; kk < N / 16; ++kk) step(a[kk]);
        } else {
          fence_operand(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < N / 16; ++kk) step(a[kk]);
        }
        epilogue(l);
      }
      // the output layer's 3 columns on the CUDA cores: fragment register
      // q holds row 8(q & 1) + lane/4, columns 16kk + 2(lane % 4) +
      // 8(q >= 2) and the one after
      float o[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = 16 * kk + 2 * quad + 8 * (q >> 1);
          const __nv_bfloat162 h =
              *reinterpret_cast<const __nv_bfloat162*>(&a[kk][q]);
          const float h0 = __low2float(h), h1 = __high2float(h);
          const float4 w0 = wout_s[k], w1 = wout_s[k + 1];
          float* r = o[q & 1];
          r[0] = __fadd_rn(__fadd_rn(r[0], __fmul_rn(h0, w0.x)),
                           __fmul_rn(h1, w1.x));
          r[1] = __fadd_rn(__fadd_rn(r[1], __fmul_rn(h0, w0.y)),
                           __fmul_rn(h1, w1.y));
          r[2] = __fadd_rn(__fadd_rn(r[2], __fmul_rn(h0, w0.z)),
                           __fmul_rn(h1, w1.z));
        }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          o[r][c] += __shfl_xor_sync(0xffffffffu, o[r][c], 1);
          o[r][c] += __shfl_xor_sync(0xffffffffu, o[r][c], 2);
        }
      if (quad < 2) {  // lane 4g writes row g, lane 4g + 1 row g + 8
        const int row = row0 + 8 * quad;
        if (row < p.n)
#pragma unroll
          for (int c = 0; c < 3; ++c)
            p.out[3 * (long)row + c] =
                (quad ? o[1][c] : o[0][c]) +
                p.bias[mlp::b_offset(mlp::DEPTH) + c];
      }
    }
  }
  // no CTA leaves while the other may still multicast into it or arrive on
  // its barriers
  cluster_sync();
}

// the hidden layers' weights as a (1888, 256) bf16 matrix, boxes of 16 rows
// x 64 columns with 128-byte swizzle
int make_map(CUtensorMap* map, const void* w) {
  EncodeTiled fn = tensor_map_encoder();
  if (fn == nullptr) return 1000 + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)HIDDEN_ROWS};
  const cuuint64_t strides[1] = {(cuuint64_t)N * 2};
  const cuuint32_t box[2] = {64, 16};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(w), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

}  // namespace

extern "C" int mlp_fwd(const void* x, int x_is_uv, int multires,
                       const void* w, const void* b, void* out, int n,
                       void* stream) {
  if (n <= 0) return 0;
  static int max_clusters = -1;
  if (max_clusters < 0) {
    cudaFuncSetAttribute(mlp_fwd_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CS);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = SMEM;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = CS;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    if (cudaOccupancyMaxActiveClusters(&max_clusters, mlp_fwd_kernel, &cfg) !=
        cudaSuccess)
      max_clusters = 0;
  }
  if (max_clusters <= 0) return 2000;
  CUtensorMap map;
  const int err = make_map(&map, w);
  if (err) return err;
  Params p;
  p.x = x;
  p.bias = reinterpret_cast<const float*>(b);
  p.wout = reinterpret_cast<const bf16*>(w) + mlp::w_offset(mlp::DEPTH);
  p.out = reinterpret_cast<float*>(out);
  p.n = n;
  p.x_is_uv = x_is_uv;
  p.multires = multires;
  p.tiles = (n + CS * BM - 1) / (CS * BM);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS * min(p.tiles, max_clusters));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CS;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, mlp_fwd_kernel, map, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
