// K6: GroupNorm (+SiLU) with f32 statistics, hand-written for Hopper.
//
// Replaces: contexture_nerf_tpu/ops/groupnorm.py `_kernel`, the pallas_call in
// `group_norm_silu_pallas`, reached through every GroupNormSiLU of the UNets,
// the ControlNet and the VAE (diffusion/layers.py GroupNormSiLU).
//
// What it computes: x (B, C, *spatial) contiguous NCHW, G groups of C/G
// channels. Each (b, g) group is one contiguous slab of n = (C/G) * HW
// elements, and the element at offset o of the slab is channel
// g * (C/G) + o / HW. Per group, in f32: mean = sum(x) / n and
// var = sum(x^2) / n - mean^2 (biased, no clamp, no Welford); then per element
// y = ((x - mean) * rsqrt(var + eps)) * scale[c] + bias[c], then
// y * (1 / (1 + exp(-y))) when act, and the cast to the output type
// (round to nearest even). scale and bias are read in their own type (bf16 or
// f32) and widened in registers. The elementwise part is rounded operation
// by operation in the plain version's order (no FMA contraction, expf and a
// correctly rounded reciprocal in the sigmoid, 1 / (1 + e) exactly), so
// kernel and plain version differ only in the order in which the
// statistics are summed.
//
// What bounds it on an H100: bytes. The function must read x once and write
// y once at 3.35 TB/s; the ~12 FP32 operations an element need far less
// than the 67 TFLOP/s non-tensor rate. The TPU kernel streams each group
// twice on a sequential grid, carrying the sums in VMEM scratch.
//
// What the design does about it: one launch, one pass over x from device
// memory. A group belongs to a thread-block cluster of `cs` CTAs (one CTA
// where that suffices; the wrapper's plan picks cs from the group's bytes
// and from covering the 132 SMs, up to 16 CTAs, a non-portable size). Rank
// r of the cluster owns elements [r * chunk, (r + 1) * chunk) of the group.
// Its first `keep` elements (at most 112 KB, so two CTAs share an SM and one's
// loads overlap the other's writes) arrive in shared memory by bulk copies
// (TMA), 32 KB pieces each on its own mbarrier, and are summed piece by
// piece as they land; the rest of the chunk (the overflow: only where a
// group exceeds what the cluster's shared memory holds, the VAE's largest
// groups) is summed from device memory. Each thread sums its 16-byte
// vectors in increasing order, warps reduce by shuffles, the warps' sums
// are added in warp order, and each CTA's (sum, sum of squares) goes into
// its shared memory. After a cluster barrier every rank reads all the
// ranks' pairs over distributed shared memory and adds them in rank order,
// so the ranks agree on mean and rstd and two runs are bit-identical (no
// atomics). Then y is written from shared memory; only the overflow is read
// again, and since clusters are scheduled group by group that re-read comes
// from L2. A group that is not a whole number of 16-byte vectors (or x not
// 16-byte aligned) keeps nothing on chip and is read twice, element by
// element (ragged shapes only; the main path has none).
//
// C interface: int groupnorm_fwd(x, scale, bias, out, x_bf16, out_bf16,
// scale_bf16, bias_bf16, BG, G, cpg, n, hw, cs, chunk, keep, eps, act, vec,
// stream): x and out (BG * n elements, bf16 or f32), scale and bias (G * cpg,)
// bf16 or f32; chunk and keep in elements (with vec, multiples of the
// 16-byte pack). Returns cudaGetLastError(). int groupnorm_max_cluster()
// returns the largest cluster (16 or 8, else 4) of which at least one can be
// resident at full shared memory, or 0 if the query fails.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int PIECE_VECS = THREADS * 4;  // 16-byte vectors a bulk copy: 32 KB
constexpr int SMEM_CAP = 112 * 1024;     // bytes of x a CTA keeps
constexpr int PIECE_BYTES = PIECE_VECS * 16;
constexpr int MAX_PIECES = (SMEM_CAP + PIECE_BYTES - 1) / PIECE_BYTES;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// element i of a (C,) parameter stored as bf16 or f32
__device__ __forceinline__ float param(const void* p, int bf, int i) {
  return bf ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
            : reinterpret_cast<const float*>(p)[i];
}

template <typename T>
struct Pack {
  static constexpr int N = 16 / sizeof(T);  // elements in a 16-byte vector
};

// (sum, sum of squares) of the block, valid in thread 0: warp shuffles, then
// the warps' sums added in warp order
__device__ __forceinline__ float2 block_sum(float s, float q, float2* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    q += __shfl_xor_sync(0xffffffffu, q, o);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = make_float2(s, q);
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
  if (threadIdx.x == 0) {
    for (int w = 0; w < NWARPS; ++w) {
      t.x += red[w].x;
      t.y += red[w].y;
    }
  }
  return t;
}

// y of one element, in the plain version's order of operations
__device__ __forceinline__ float affine_act(float v, float mean, float rstd,
                                            float sc, float bi, int act) {
  float y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mean), rstd), sc), bi);
  if (act) y = __fmul_rn(y, __frcp_rn(__fadd_rn(1.f, expf(-y))));
  return y;
}

struct Args {
  const void* x;
  const void* scale;
  const void* bias;
  void* out;
  int sc_bf16, bi_bf16;
  int G, cpg, n, hw, cs, chunk, keep;
  float eps;
  int act;
};

// Units: with VEC a unit is one 16-byte vector of Pack<TI>::N elements,
// otherwise one element. Rank r owns units [lo, hi) of its group, the first
// `kept` of them in shared memory.
template <typename TI, typename TO, bool VEC>
__global__ void __launch_bounds__(THREADS) gn_fused(const Args a) {
  extern __shared__ __align__(128) unsigned char smem_x[];
  __shared__ __align__(8) uint64_t bars[MAX_PIECES];
  __shared__ float2 red[NWARPS];
  __shared__ float2 part;
  __shared__ float stat[2];
  constexpr int P = VEC ? Pack<TI>::N : 1;
  const int rank = blockIdx.x % a.cs;
  const size_t bg = blockIdx.x / a.cs;
  const TI* g = reinterpret_cast<const TI*>(a.x) + bg * (size_t)a.n;
  TO* o = reinterpret_cast<TO*>(a.out) + bg * (size_t)a.n;
  const int nu = a.n / P, cu = a.chunk / P;
  const int lo = min(rank * cu, nu), hi = min(lo + cu, nu);
  const int kept = VEC ? min(a.keep / P, hi - lo) : 0;
  const int pieces = (kept + PIECE_VECS - 1) / PIECE_VECS;
  const uint32_t bar0 = smem_u32(bars), xs = smem_u32(smem_x);

  if (VEC && threadIdx.x == 0 && pieces > 0) {
    for (int p = 0; p < pieces; ++p) mbar_init(bar0 + 8 * p, 1);
    fence_barrier_init();
    for (int p = 0; p < pieces; ++p) {
      const int u0 = p * PIECE_VECS;
      const uint32_t bytes = 16u * min(PIECE_VECS, kept - u0);
      mbar_arrive_expect_tx(bar0 + 8 * p, bytes);
      bulk_load(xs + 16u * u0, g + (size_t)(lo + u0) * P, bytes, bar0 + 8 * p);
    }
  }
  __syncthreads();  // the barriers are initialised before anyone waits

  // phase 1: this thread's units in increasing order, kept then overflow
  float s = 0.f, q = 0.f;
  auto add = [&](const TI* e) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const float v = to_f(e[k]);
      s += v;
      q += v * v;
    }
  };
  if (VEC) {
    const uint4* sx = reinterpret_cast<const uint4*>(smem_x);
    for (int p = 0; p < pieces; ++p) {
      mbar_wait(bar0 + 8 * p, 0);
      const int end = min(kept, (p + 1) * PIECE_VECS);
      for (int u = p * PIECE_VECS + threadIdx.x; u < end; u += THREADS) {
        const uint4 raw = sx[u];
        add(reinterpret_cast<const TI*>(&raw));
      }
    }
    for (int u = lo + kept + threadIdx.x; u < hi; u += THREADS) {
      const uint4 raw = reinterpret_cast<const uint4*>(g)[u];
      add(reinterpret_cast<const TI*>(&raw));
    }
  } else {
    for (int u = lo + threadIdx.x; u < hi; u += THREADS) add(g + u);
  }
  const float2 t = block_sum(s, q, red);

  // the group's statistics: the ranks' pairs added in rank order
  if (threadIdx.x == 0) part = t;
  if (a.cs > 1) cluster_sync();
  if (threadIdx.x == 0) {
    float S = 0.f, Q = 0.f;
    if (a.cs > 1) {
      const uint32_t pa = smem_u32(&part);
      for (int r = 0; r < a.cs; ++r) {
        const float2 v = ld_cluster_f2(mapa(pa, r));
        S += v.x;
        Q += v.y;
      }
    } else {
      S += t.x;
      Q += t.y;
    }
    const float mean = __fdiv_rn(S, (float)a.n);
    const float var = __fsub_rn(__fdiv_rn(Q, (float)a.n), __fmul_rn(mean, mean));
    stat[0] = mean;
    stat[1] = rsqrtf(__fadd_rn(var, a.eps));
  }
  __syncthreads();
  if (a.cs > 1) cluster_arrive();  // done reading the other ranks' pairs
  const float mean = stat[0], rstd = stat[1];
  const int c0 = (int)(bg % a.G) * a.cpg;

  // phase 2: y for every unit of this rank
  auto apply = [&](const TI* e, int u) {
    const int i = u * P;
    int c = i / a.hw, r = i - c * a.hw;
    float sc = param(a.scale, a.sc_bf16, c0 + c);
    float bi = param(a.bias, a.bi_bf16, c0 + c);
    alignas(16) TO y[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (r == a.hw) {
        ++c;
        r = 0;
        sc = param(a.scale, a.sc_bf16, c0 + c);
        bi = param(a.bias, a.bi_bf16, c0 + c);
      }
      put(&y[k], affine_act(to_f(e[k]), mean, rstd, sc, bi, a.act));
      ++r;
    }
    constexpr int OB = P * (int)sizeof(TO);  // bytes of a unit's y
    if constexpr (!VEC) {
      o[u] = y[0];
    } else if constexpr (OB >= 16) {
#pragma unroll
      for (int j = 0; j < OB / 16; ++j)
        reinterpret_cast<uint4*>(o + i)[j] = reinterpret_cast<const uint4*>(y)[j];
    } else {
      *reinterpret_cast<uint2*>(o + i) = *reinterpret_cast<const uint2*>(y);
    }
  };
  if (VEC) {
    const uint4* sx = reinterpret_cast<const uint4*>(smem_x);
    for (int u = threadIdx.x; u < kept; u += THREADS) {
      const uint4 raw = sx[u];
      apply(reinterpret_cast<const TI*>(&raw), lo + u);
    }
    for (int u = lo + kept + threadIdx.x; u < hi; u += THREADS) {
      const uint4 raw = reinterpret_cast<const uint4*>(g)[u];
      apply(reinterpret_cast<const TI*>(&raw), u);
    }
  } else {
    for (int u = lo + threadIdx.x; u < hi; u += THREADS) apply(g + u, u);
  }
  if (a.cs > 1) cluster_wait();  // no rank leaves while another reads it
}

template <typename TI, typename TO, bool VEC>
int launch(const Args& a, int BG, cudaStream_t stream) {
  auto* k = gn_fused<TI, TO, VEC>;
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM_CAP);
    cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed,
                         1);
    attr = true;
  }
  const size_t smem = VEC ? (size_t)a.keep * sizeof(TI) : 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)BG * a.cs);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = a.cs;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = a.cs > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, k, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename TI, typename TO>
int launch(const Args& a, int BG, int vec, cudaStream_t stream) {
  return vec ? launch<TI, TO, true>(a, BG, stream)
             : launch<TI, TO, false>(a, BG, stream);
}

}  // namespace

extern "C" int groupnorm_fwd(const void* x, const void* scale,
                             const void* bias, void* out, int x_bf16,
                             int out_bf16, int scale_bf16, int bias_bf16,
                             int BG, int G, int cpg, int n, int hw, int cs,
                             int chunk, int keep, float eps, int act, int vec,
                             void* stream) {
  if (BG <= 0 || n <= 0 || cs <= 0) return 0;
  const Args a{x,  scale, bias, out,   scale_bf16, bias_bf16, G,   cpg,
               n,  hw,    cs,   chunk, keep,       eps,       act};
  cudaStream_t st = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (x_bf16 && out_bf16) return launch<bf16, bf16>(a, BG, vec, st);
  if (x_bf16) return launch<bf16, float>(a, BG, vec, st);
  if (out_bf16) return launch<float, bf16>(a, BG, vec, st);
  return launch<float, float>(a, BG, vec, st);
}

extern "C" int groupnorm_max_cluster() {
  auto* k = gn_fused<__nv_bfloat16, __nv_bfloat16, true>;
  if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_CAP) != cudaSuccess ||
      cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess)
    return 0;
  for (int cs = 16; cs >= 4; cs /= 2) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cs);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = SMEM_CAP;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cs;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, k, &cfg) == cudaSuccess &&
        clusters > 0)
      return cs;
  }
  cudaGetLastError();  // clear a failed query
  return 0;
}
