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
// (round to nearest even). The elementwise part is rounded operation by
// operation in the plain version's order (no FMA contraction, expf and an
// IEEE division in the sigmoid), so kernel and plain version differ only in
// the order in which the statistics are summed.
//
// What bounds it on an H100: bytes. The function must read x once and write
// y once at 3.35 TB/s; this two-pass design reads x twice, 1.5x that for bf16
// in and out. The ~12 FP32 operations an element need far less than the
// 67 TFLOP/s non-tensor rate. The TPU kernel streams each group twice on a
// sequential grid, carrying the sums in VMEM scratch; Hopper's blocks run in
// no order, so the two phases are two launches here.
//
// What the design does about it: one CTA per group is too few (the VAE
// decoder at 512^2 has 32 groups of 1 M elements on 132 SMs), so each group
// is split into S chunks (the wrapper picks S to put about a thousand CTAs
// in flight). Pass 1: each CTA sums its chunk with 16-byte loads, reduces
// (sum, sum of squares) by warp shuffles and then across warps in warp
// order, and writes the f32 pair to a scratch array. Pass 2: each CTA sums
// its group's S pairs in index order (every CTA of the group gets the same
// mean and rstd), then re-streams its chunk and writes y. No float atomics:
// two runs are bit-identical. A single pass that keeps x on chip (clusters
// and distributed shared memory) is later work.
//
// C interface: int groupnorm_fwd(x, scale, bias, partial, out, x_bf16,
// out_bf16, BG, G, cpg, n, hw, S, chunk, eps, act, vec, stream). x and out
// (BG * n elements, bf16 or f32), scale and bias (G * cpg,) f32, partial
// (BG * S) float2 scratch; vec: 16-byte loads (n and chunk multiples of the
// 16-byte pack, x 16-byte aligned). Returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
struct Pack {
  static constexpr int N = 16 / sizeof(T);  // elements in a 16-byte load
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

// pass 1: partial[bg * S + s] = (sum, sum of squares) of chunk s of group bg
template <typename TI, bool VEC>
__global__ void __launch_bounds__(THREADS)
    gn_stats(const TI* __restrict__ x, int n, int chunk,
             float2* __restrict__ partial) {
  __shared__ float2 red[NWARPS];
  const int si = blockIdx.x, S = gridDim.x;
  const size_t bg = blockIdx.y;
  const TI* g = x + bg * (size_t)n;
  const int lo = si * chunk, hi = min(lo + chunk, n);
  float s = 0.f, q = 0.f;
  if (VEC) {
    constexpr int V = Pack<TI>::N;
    for (int i = lo + threadIdx.x * V; i < hi; i += THREADS * V) {
      const uint4 raw = *reinterpret_cast<const uint4*>(g + i);
      const TI* e = reinterpret_cast<const TI*>(&raw);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float v = to_f(e[k]);
        s += v;
        q += v * v;
      }
    }
  } else {
    for (int i = lo + threadIdx.x; i < hi; i += THREADS) {
      const float v = to_f(g[i]);
      s += v;
      q += v * v;
    }
  }
  const float2 t = block_sum(s, q, red);
  if (threadIdx.x == 0) partial[bg * S + si] = t;
}

// y of one element, in the plain version's order of operations
__device__ __forceinline__ float affine_act(float v, float mean, float rstd,
                                            float sc, float bi, int act) {
  float y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mean), rstd), sc), bi);
  if (act) y = __fmul_rn(y, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-y))));
  return y;
}

// pass 2: the group's statistics from its S partials, then y over chunk s
template <typename TI, typename TO, bool VEC>
__global__ void __launch_bounds__(THREADS)
    gn_apply(const TI* __restrict__ x, const float* __restrict__ scale,
             const float* __restrict__ bias,
             const float2* __restrict__ partial, TO* __restrict__ out, int G,
             int cpg, int n, int hw, int chunk, float eps, int act) {
  __shared__ float stat[2];
  const int si = blockIdx.x, S = gridDim.x;
  const size_t bg = blockIdx.y;
  if (threadIdx.x == 0) {
    float s = 0.f, q = 0.f;
    for (int j = 0; j < S; ++j) {
      const float2 p = partial[bg * S + j];
      s += p.x;
      q += p.y;
    }
    const float mean = __fdiv_rn(s, (float)n);
    const float var = __fsub_rn(__fdiv_rn(q, (float)n), __fmul_rn(mean, mean));
    stat[0] = mean;
    stat[1] = rsqrtf(__fadd_rn(var, eps));
  }
  __syncthreads();
  const float mean = stat[0], rstd = stat[1];
  const float* sc = scale + (int)(bg % G) * cpg;
  const float* bi = bias + (int)(bg % G) * cpg;
  const TI* g = x + bg * (size_t)n;
  TO* o = out + bg * (size_t)n;
  const int lo = si * chunk, hi = min(lo + chunk, n);
  if (VEC) {
    constexpr int V = Pack<TI>::N;
    constexpr int OB = V * (int)sizeof(TO);  // bytes of V outputs: 8, 16, 32
    for (int i = lo + threadIdx.x * V; i < hi; i += THREADS * V) {
      const uint4 raw = *reinterpret_cast<const uint4*>(g + i);
      const TI* e = reinterpret_cast<const TI*>(&raw);
      int c = i / hw, r = i - c * hw;
      alignas(16) TO y[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (r == hw) {
          ++c;
          r = 0;
        }
        put(&y[k], affine_act(to_f(e[k]), mean, rstd, sc[c], bi[c], act));
        ++r;
      }
      if constexpr (OB >= 16) {
#pragma unroll
        for (int j = 0; j < OB / 16; ++j)
          reinterpret_cast<uint4*>(o + i)[j] =
              reinterpret_cast<const uint4*>(y)[j];
      } else {
        *reinterpret_cast<uint2*>(o + i) = *reinterpret_cast<const uint2*>(y);
      }
    }
  } else {
    for (int i = lo + threadIdx.x; i < hi; i += THREADS) {
      const int c = i / hw;
      put(o + i, affine_act(to_f(g[i]), mean, rstd, sc[c], bi[c], act));
    }
  }
}

template <typename TI, typename TO>
int launch(const void* x, const float* scale, const float* bias,
           float2* partial, void* out, int BG, int G, int cpg, int n, int hw,
           int S, int chunk, float eps, int act, int vec,
           cudaStream_t stream) {
  const dim3 grid(S, BG);
  const TI* xi = reinterpret_cast<const TI*>(x);
  TO* yo = reinterpret_cast<TO*>(out);
  if (vec)
    gn_stats<TI, true><<<grid, THREADS, 0, stream>>>(xi, n, chunk, partial);
  else
    gn_stats<TI, false><<<grid, THREADS, 0, stream>>>(xi, n, chunk, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (vec)
    gn_apply<TI, TO, true><<<grid, THREADS, 0, stream>>>(
        xi, scale, bias, partial, yo, G, cpg, n, hw, chunk, eps, act);
  else
    gn_apply<TI, TO, false><<<grid, THREADS, 0, stream>>>(
        xi, scale, bias, partial, yo, G, cpg, n, hw, chunk, eps, act);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int groupnorm_fwd(const void* x, const void* scale,
                             const void* bias, void* partial, void* out,
                             int x_bf16, int out_bf16, int BG, int G, int cpg,
                             int n, int hw, int S, int chunk, float eps,
                             int act, int vec, void* stream) {
  if (BG <= 0 || n <= 0 || S <= 0) return 0;
  const float* sc = reinterpret_cast<const float*>(scale);
  const float* bi = reinterpret_cast<const float*>(bias);
  float2* part = reinterpret_cast<float2*>(partial);
  cudaStream_t st = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (x_bf16 && out_bf16)
    return launch<bf16, bf16>(x, sc, bi, part, out, BG, G, cpg, n, hw, S,
                              chunk, eps, act, vec, st);
  if (x_bf16)
    return launch<bf16, float>(x, sc, bi, part, out, BG, G, cpg, n, hw, S,
                               chunk, eps, act, vec, st);
  if (out_bf16)
    return launch<float, bf16>(x, sc, bi, part, out, BG, G, cpg, n, hw, S,
                               chunk, eps, act, vec, st);
  return launch<float, float>(x, sc, bi, part, out, BG, G, cpg, n, hw, S,
                              chunk, eps, act, vec, st);
}
