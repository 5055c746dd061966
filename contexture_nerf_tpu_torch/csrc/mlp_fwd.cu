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
// STORE_ACTS (the recompute of K2, mlp_bwd.cu): the same kernel, one
// template flag on. Once a hidden layer's accumulator has its bias, ReLU and
// bf16 rounding and is packed as the next layer's A fragments, the
// consumers also store it, with 32-bit stores (each quad writes 16
// contiguous bytes of a row), into column block l of K2's (N, 8 x 256)
// activation buffer; with the uv input the embedding's fragments go to an
// (N, 48) buffer too; the output layer is skipped. With the flag off (K1
// itself) the stores compile away.
//
// DELTA (K2's delta loop, mlp_bwd.cu's phase A): the same pipeline over
// the transposed weight stack [W_8^T (16 x 256); W_7^T; W_6^T; W_5[48:]^T;
// W_4^T; ...; W_1^T] (1808, 256), packed once by ops/mlp_kernel.py, so its
// B operand is read exactly as K1 reads the weights. The input is g padded
// to 16 columns (one k16 step); the epilogue multiplies the accumulator by
// (act_l > 0), read from the act buffer at the fragment positions
// STORE_ACTS wrote, stores bf16(delta) to K2's delta buffer and re-packs it
// as the next A; db sums the f32 delta's columns over the warpgroup's rows
// in a fixed order into a per-warpgroup partial over its statically
// assigned tiles.
//
// C interface: int mlp_fwd(x, x_is_uv, multires, w, b, out, n, stream),
// int mlp_fwd_acts(x, x_is_uv, multires, w, b, acts, emb_out, n, stream)
// and int mlp_delta(g, wt, acts, deltas, dbpart, n, ctas, stream) (ctas:
// out, the CTA count; dbpart holds B_NUMEL floats for each of the CTAs' 2
// consumer warpgroups) return cudaGetLastError() after the launch, or 1000
// + the CUresult of a failed tensor-map encode, or 2000 if no cluster fits
// on the card.
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

// The kernel's three instantiations: K1 itself; K1 storing its
// activations for K2 (STORE_ACTS); K2's delta loop over the transposed
// stack (DELTA).
enum Mode { FWD = 0, FWD_ACTS = 1, DELTA = 2 };
// DELTA: the transposed stack [W_8^T (16 rows); W_7^T; W_6^T; W_5[48:]^T;
// W_4^T; ...; W_1^T] (1808, 256): one k16 step, then 7 layers of 16
constexpr int DELTA_ROWS = mlp::OUT_PAD + (mlp::DEPTH - 1) * N;
constexpr int DELTA_STEPS = DELTA_ROWS / 16;  // 113
constexpr int ACTS_LD = mlp::DEPTH * N;       // K2's act and delta buffers
// DELTA's shared memory after the ring: each warp's column sums of a
// layer's delta (two buffers a warpgroup, by layer parity), then each
// warpgroup's db partial (B_NUMEL floats)
constexpr int OFF_DBS = STAGES * SLAB;
constexpr int OFF_DBACC = OFF_DBS + NC * 2 * 4 * N * 4;
constexpr int OFF_BAR_DELTA = OFF_DBACC + NC * mlp::B_NUMEL * 4;
constexpr int SMEM_DELTA = OFF_BAR_DELTA + 16 * STAGES + 1024;
static_assert(SMEM_DELTA <= 232448, "shared memory of a CTA");
static_assert(DELTA_STEPS * 16 == DELTA_ROWS, "layout");

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// 4 x 4 transpose of 32-bit words across the lanes of a quad (q = lane %
// 4): afterwards word t of lane q is what word q of lane t was. Fragment
// words of a column-step pair (j, j + 1), {row r: j, j + 1; row r + 8: j,
// j + 1}, become this lane's 16 contiguous bytes of row r + 8 (q >> 1),
// columns 8 (j + (q & 1)) .. + 7, and back. The whole warp calls it.
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4], int q) {
  {  // lanes q and q ^ 1 swap the words whose index differs from q in bit 0
    const bool o = q & 1;
    const uint32_t x = __shfl_xor_sync(0xffffffffu, o ? w[0] : w[1], 1);
    const uint32_t y = __shfl_xor_sync(0xffffffffu, o ? w[2] : w[3], 1);
    if (o) {
      w[0] = x;
      w[2] = y;
    } else {
      w[1] = x;
      w[3] = y;
    }
  }
  {  // lanes q and q ^ 2 swap the words whose index differs from q in bit 1
    const bool o = q & 2;
    const uint32_t x = __shfl_xor_sync(0xffffffffu, o ? w[0] : w[2], 2);
    const uint32_t y = __shfl_xor_sync(0xffffffffu, o ? w[1] : w[3], 2);
    if (o) {
      w[0] = x;
      w[1] = y;
    } else {
      w[2] = x;
      w[3] = y;
    }
  }
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
  const void* x;     // uv or the embedding; DELTA: g (N, 3) f32
  const float* bias;
  const bf16* wout;  // the output layer (256, 16)
  float* out;
  bf16* acts;     // FWD_ACTS: (N, DEPTH * 256) hidden layers' outputs
                  // (written); DELTA: the same (read: the ReLU masks)
  bf16* emb_out;  // FWD_ACTS with uv: (N, 48) embedding
  bf16* deltas;   // DELTA: (N, DEPTH * 256) bf16 delta_0..delta_7
  float* dbpart;  // DELTA: B_NUMEL floats a consumer warpgroup
  int n, x_is_uv, multires, tiles;  // tiles of CS * BM points
};

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    mlp_fwd_kernel(__grid_constant__ const CUtensorMap tw, const Params p) {
  constexpr bool STORE_ACTS = MODE == FWD_ACTS;
  constexpr int TILE_STEPS = MODE == DELTA ? DELTA_STEPS : STEPS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - smem_u32(smem_raw));
  float* bias_s = reinterpret_cast<float*>(sbase + OFF_BIAS);
  float4* wout_s = reinterpret_cast<float4*>(sbase + OFF_WOUT);
  uint32_t* emb_s = reinterpret_cast<uint32_t*>(sbase + OFF_EMB);
  const uint32_t full = base + (MODE == DELTA ? OFF_BAR_DELTA : OFF_BAR),
                 empty = full + 8 * STAGES;
  const int rank = (int)cluster_rank();
  const int cluster = blockIdx.x / CS, clusters = gridDim.x / CS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * NC);  // one arrive per consumer warp
    }
    fence_barrier_init();
  }
  if constexpr (MODE == DELTA) {
    float* dbacc = reinterpret_cast<float*>(sbase + OFF_DBACC);
    for (int i = threadIdx.x; i < NC * mlp::B_NUMEL; i += THREADS)
      dbacc[i] = 0.f;
  } else {
    for (int i = threadIdx.x; i < mlp::DEPTH * N; i += THREADS)
      bias_s[i] = p.bias[i];
    for (int k = threadIdx.x; k < N; k += THREADS) {
      const bf16* r = p.wout + k * mlp::OUT_PAD;
      wout_s[k] = make_float4(__bfloat162float(r[0]), __bfloat162float(r[1]),
                              __bfloat162float(r[2]), 0.f);
    }
  }
  __syncthreads();
  cluster_sync();  // every CTA's barriers exist before any multicast

  if (threadIdx.x >= NC * 128) {
    // ---- producer warpgroup: one thread streams the slabs ----
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == NC * 128) {
      uint32_t it = 0;
      for (int t = cluster; t < p.tiles; t += clusters) {
        for (int s = 0; s < TILE_STEPS; ++s, ++it) {
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
    int row0 = 0;     // this thread's first row of the tile

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
        if constexpr (STORE_ACTS) {
          if (j & 1) {  // the pair (j - 1, j) as 16 contiguous bytes a lane
            uint32_t w[4] = {a[j / 2][0], a[j / 2][2], a[j / 2][1], a[j / 2][3]};
            quad_transpose(w, quad);
            const int row = row0 + 8 * (quad >> 1);
            if (row < p.n)
              *reinterpret_cast<uint4*>(p.acts + (long)row * ACTS_LD + l * N +
                                        8 * (j - 1 + (quad & 1))) =
                  make_uint4(w[0], w[1], w[2], w[3]);
          }
        }
      }
    };

    if constexpr (MODE == DELTA) {
      float* dbs = reinterpret_cast<float*>(sbase + OFF_DBS) + wg * 2 * 4 * N;
      float* dbacc = reinterpret_cast<float*>(sbase + OFF_DBACC) +
                     wg * mlp::B_NUMEL;
      const float* g = reinterpret_cast<const float*>(p.x);
      float gsum[2] = {0.f, 0.f};  // db_8 of columns 2 quad, 2 quad + 1
      // delta_blk = acc * (act_blk > 0), the mask read at the fragment
      // positions FWD_ACTS stored; bf16(delta) stored to the delta buffer
      // and packed as the next A; the f32 column sums of the warpgroup's 64
      // rows (lanes xor 4, 8, 16, then the 4 warps in order) added to its
      // db partial; slab index l of the stack picks the sums' buffer
      auto epilogue_delta = [&](int l, int blk) {
        wgmma_wait<0>();
        fence_operand(acc);
        for (int d = min(issued, IN_FLIGHT); d > 0; --d)
          release((it - d) % STAGES);
        issued = 0;
        // this lane's 16 contiguous bytes of a column-step pair (j, j + 1):
        // row r + 8 (quad >> 1), columns 8 (j + (quad & 1)) .. + 7
        const int qrow = row0 + 8 * (quad >> 1);
        const bool qin = qrow < p.n;
        const long qoff = (long)qrow * ACTS_LD + blk * N + 8 * (quad & 1);
        float* sums = dbs + (l & 1) * 4 * N + warp * N + 2 * quad;
        // the masks in groups of MG column steps (MG / 2 16-byte loads a
        // lane), the next group loaded while this one is used: no more in
        // registers at once (acc and a hold 192 of the 240)
        constexpr int MG = 4;
        uint32_t mw[2][2 * MG];
        auto load_masks = [&](int grp, uint32_t(&w)[2 * MG]) {
#pragma unroll
          for (int i = 0; i < MG / 2; ++i) {
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (qin)
              v = *reinterpret_cast<const uint4*>(p.acts + qoff +
                                                  8 * (grp * MG + 2 * i));
            w[4 * i] = v.x;
            w[4 * i + 1] = v.y;
            w[4 * i + 2] = v.z;
            w[4 * i + 3] = v.w;
          }
        };
        load_masks(0, mw[0]);
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          uint32_t(&cur)[2 * MG] = mw[(j / MG) & 1];
          if (j % MG == 0) {
            // back to fragment words: per pair {r: j, j + 1; r + 8: j, j + 1}
#pragma unroll
            for (int i = 0; i < MG / 2; ++i) {
              uint32_t w[4] = {cur[4 * i], cur[4 * i + 1], cur[4 * i + 2],
                               cur[4 * i + 3]};
              quad_transpose(w, quad);
#pragma unroll
              for (int k = 0; k < 4; ++k) cur[4 * i + k] = w[k];
            }
            asm volatile("" ::: "memory");  // keep later groups' loads here
            if (j + MG < N / 8) load_masks(j / MG + 1, mw[(j / MG + 1) & 1]);
          }
          const int pw = 4 * ((j % MG) / 2) + (j & 1);
          uint32_t m0 = cur[pw], m1 = cur[pw + 2];
          const __nv_bfloat162 k0 = *reinterpret_cast<__nv_bfloat162*>(&m0);
          const __nv_bfloat162 k1 = *reinterpret_cast<__nv_bfloat162*>(&m1);
          const float d00 = __low2float(k0) > 0.f ? acc[4 * j] : 0.f;
          const float d01 = __high2float(k0) > 0.f ? acc[4 * j + 1] : 0.f;
          const float d10 = __low2float(k1) > 0.f ? acc[4 * j + 2] : 0.f;
          const float d11 = __high2float(k1) > 0.f ? acc[4 * j + 3] : 0.f;
          const uint32_t r0 = pack_bf16(d00, d01), r1 = pack_bf16(d10, d11);
          a[j / 2][(j & 1) * 2] = r0;
          a[j / 2][(j & 1) * 2 + 1] = r1;
          if (j & 1) {  // the pair (j - 1, j) as 16 contiguous bytes a lane
            uint32_t w[4] = {a[j / 2][0], a[j / 2][2], a[j / 2][1], a[j / 2][3]};
            quad_transpose(w, quad);
            if (qin)
              *reinterpret_cast<uint4*>(p.deltas + qoff + 8 * (j - 1)) =
                  make_uint4(w[0], w[1], w[2], w[3]);
          }
          float v0 = d00 + d10, v1 = d01 + d11;
#pragma unroll
          for (int x = 4; x < 32; x <<= 1) {
            v0 += __shfl_xor_sync(0xffffffffu, v0, x);
            v1 += __shfl_xor_sync(0xffffffffu, v1, x);
          }
          if (lane < 4) *reinterpret_cast<float2*>(sums + 8 * j) = make_float2(v0, v1);
        }
        named_sync(1 + wg, 128);
        const float* s = dbs + (l & 1) * 4 * N;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = tid + 128 * h;
          dbacc[blk * N + c] += ((s[c] + s[N + c]) + s[2 * N + c]) + s[3 * N + c];
        }
      };

      for (int t = cluster; t < p.tiles; t += clusters) {
        row0 = (t * CS + rank) * BM + wg * 64 + warp * 16 + lane / 4;
        // stack layer 0: A = bf16(g) padded to 16 columns, one k16 step
        uint32_t e[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = row0 + 8 * (q & 1), c = 2 * quad + 8 * (q >> 1);
          float v0 = 0.f, v1 = 0.f;
          if (row < p.n && c < 3) {
            v0 = g[3 * (long)row + c];
            if (c + 1 < 3) v1 = g[3 * (long)row + c + 1];
          }
          e[q] = pack_bf16(v0, v1);
          gsum[0] += v0;
          gsum[1] += v1;
        }
        // the mask rows of the coming epilogue into L2 while the layer's
        // products run: this thread's quad shares its two rows, 4 lines each
        auto prefetch_masks = [&](int blk) {
          const bf16* m = p.acts + (long)row0 * ACTS_LD + blk * N + 64 * quad;
          if (row0 < p.n) prefetch_l2(m);
          if (row0 + 8 < p.n) prefetch_l2(m + 8 * ACTS_LD);
        };
        prefetch_masks(mlp::DEPTH - 1);
        fence_operand(acc);
        wgmma_fence();
        step(e);
        epilogue_delta(0, mlp::DEPTH - 1);
        for (int l = 1; l < mlp::DEPTH; ++l) {
          prefetch_masks(mlp::DEPTH - 1 - l);
          fence_operand(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < N / 16; ++kk) step(a[kk]);
          epilogue_delta(l, mlp::DEPTH - 1 - l);
        }
      }
      // db_8 (columns 0..2) through the parity-0 sums buffer, whose last
      // readers passed the final layer's barrier
#pragma unroll
      for (int x = 4; x < 32; x <<= 1) {
        gsum[0] += __shfl_xor_sync(0xffffffffu, gsum[0], x);
        gsum[1] += __shfl_xor_sync(0xffffffffu, gsum[1], x);
      }
      if (lane < 4)
        *reinterpret_cast<float2*>(dbs + warp * N + 2 * quad) =
            make_float2(gsum[0], gsum[1]);
      named_sync(1 + wg, 128);
      float* part = p.dbpart + (long)(blockIdx.x * NC + wg) * mlp::B_NUMEL;
      for (int c = tid; c < mlp::DEPTH * N; c += 128) part[c] = dbacc[c];
      if (tid < mlp::OUT_PAD)
        part[mlp::DEPTH * N + tid] =
            tid < 3 ? ((dbs[tid] + dbs[N + tid]) + dbs[2 * N + tid]) +
                          dbs[3 * N + tid]
                    : 0.f;
    } else {
    for (int t = cluster; t < p.tiles; t += clusters) {
      row0 = (t * CS + rank) * BM + wg * 64 + warp * 16 + lane / 4;
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
            if constexpr (STORE_ACTS) {
              if (p.x_is_uv && row < p.n)
                *reinterpret_cast<uint32_t*>(
                    p.emb_out + (long)row * mlp::EMB_PAD + c) = val;
            }
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
      if constexpr (STORE_ACTS) continue;
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
  }
  // no CTA leaves while the other may still multicast into it or arrive on
  // its barriers
  cluster_sync();
}

// a (rows, 256) bf16 weight matrix (the hidden layers' (1888, 256), or
// DELTA's transposed stack (1808, 256)), boxes of 16 rows x 64 columns with
// 128-byte swizzle
int make_map(CUtensorMap* map, const void* w, int rows) {
  EncodeTiled fn = tensor_map_encoder();
  if (fn == nullptr) return 1000 + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)rows};
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

// launches MODE's instantiation on a persistent grid of clusters, as many
// as fit on the card at once (and no more than the tiles); *ctas gets the
// CTA count
template <int MODE>
int launch(Params p, const void* w, int* ctas, void* stream) {
  constexpr int smem = MODE == DELTA ? SMEM_DELTA : SMEM;
  if (ctas) *ctas = 0;
  if (p.n <= 0) return 0;
  static int max_clusters = -1;
  if (max_clusters < 0) {
    cudaFuncSetAttribute(mlp_fwd_kernel<MODE>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CS);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = CS;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    if (cudaOccupancyMaxActiveClusters(&max_clusters, mlp_fwd_kernel<MODE>,
                                       &cfg) != cudaSuccess)
      max_clusters = 0;
  }
  if (max_clusters <= 0) return 2000;
  CUtensorMap map;
  const int err = make_map(&map, w, MODE == DELTA ? DELTA_ROWS : HIDDEN_ROWS);
  if (err) return err;
  p.tiles = (p.n + CS * BM - 1) / (CS * BM);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS * min(p.tiles, max_clusters));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CS;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (ctas) *ctas = (int)cfg.gridDim.x;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, mlp_fwd_kernel<MODE>, map, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

Params params(const void* x, int x_is_uv, int multires, const void* w,
              const void* b, int n) {
  Params p = {};
  p.x = x;
  p.bias = reinterpret_cast<const float*>(b);
  p.wout = reinterpret_cast<const bf16*>(w) + mlp::w_offset(mlp::DEPTH);
  p.n = n;
  p.x_is_uv = x_is_uv;
  p.multires = multires;
  return p;
}

}  // namespace

extern "C" int mlp_fwd(const void* x, int x_is_uv, int multires,
                       const void* w, const void* b, void* out, int n,
                       void* stream) {
  Params p = params(x, x_is_uv, multires, w, b, n);
  p.out = reinterpret_cast<float*>(out);
  return launch<FWD>(p, w, nullptr, stream);
}

extern "C" int mlp_fwd_acts(const void* x, int x_is_uv, int multires,
                            const void* w, const void* b, void* acts,
                            void* emb_out, int n, void* stream) {
  Params p = params(x, x_is_uv, multires, w, b, n);
  p.acts = reinterpret_cast<bf16*>(acts);
  p.emb_out = reinterpret_cast<bf16*>(emb_out);
  return launch<FWD_ACTS>(p, w, nullptr, stream);
}

extern "C" int mlp_delta(const void* g, const void* wt, const void* acts,
                         void* deltas, void* dbpart, int n, int* ctas,
                         void* stream) {
  Params p = {};
  p.x = g;
  p.acts = const_cast<bf16*>(reinterpret_cast<const bf16*>(acts));
  p.deltas = reinterpret_cast<bf16*>(deltas);
  p.dbpart = reinterpret_cast<float*>(dbpart);
  p.n = n;
  return launch<DELTA>(p, wt, ctas, stream);
}
