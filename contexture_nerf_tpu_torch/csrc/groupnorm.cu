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
// The backward (`gn_bwd`, one launch a call) replaces no TPU kernel: the
// reference's custom VJP recomputes through its plain version. It computes
// the gradient of the same function for the output's gradient g, per group
// in f32: mean and rstd again from x as above; xhat = (x - mean) * rstd,
// y = xhat * scale[c] + bias[c]; g' = g * s * (1 + y * (1 - s)) with
// s = 1 / (1 + exp(-y)) when act, else g' = g; dxhat = g' * scale[c];
// dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)), rounded
// once to x's type; and where asked, each rank's per-channel sums of
// g' * xhat and g' (dscale, dbias), which the wrapper adds over the batch
// and the ranks in order. Bound on an H100 by bytes: x and g read once, dx
// written once. Design: the forward's, with x and g both bulk-copied into
// shared memory (112 KB for the two together) and three passes over them:
// (sum x, sum x^2), then (sum dxhat, sum dxhat * xhat), then dx; each pair
// reduced over the cluster in rank order over DSMEM, so two runs are
// bit-identical. Only the overflow is read from device memory again, two
// units in flight a thread: x three times and g twice, 12 bytes an element
// against 6 (the canvas encoder's first level keeps 19% of each rank's
// share on chip, the 448x448 slice's 57%).
//
// C interface: int groupnorm_fwd(x, scale, bias, out, x_bf16, out_bf16,
// scale_bf16, bias_bf16, BG, G, cpg, n, hw, cs, chunk, keep, eps, act, vec,
// stream): x and out (BG * n elements, bf16 or f32), scale and bias (G * cpg,)
// bf16 or f32; chunk and keep in elements (with vec, multiples of the
// 16-byte pack). int groupnorm_bwd(x, g, scale, bias, dx, part, x_bf16,
// g_bf16, scale_bf16, bias_bf16, BG, G, cpg, n, hw, cs, chunk, keep, eps,
// act, vec, stream): g shaped like x, dx (x's type) or null, part
// (BG * cs, cpg, 2) f32 or null; keep elements of x and as many of g are
// kept; with vec, chunk and keep are multiples of 16 / min(x, g element
// size). Both return cudaGetLastError() (cudaErrorInvalidValue for a plan
// the kernel cannot hold). int groupnorm_max_cluster() and
// groupnorm_bwd_max_cluster() return the largest cluster (16 or 8, else 4)
// of which at least one can be resident at full shared memory, or 0 if the
// query fails.
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

// --- the backward -------------------------------------------------------------

constexpr int BWD_PIECE_UNITS = THREADS * 2;  // units a bulk-copy piece
// a unit's x and g take at least 32 bytes, so SMEM_CAP holds at most 3,584
// units: four pieces
constexpr int BWD_MAX_PIECES = 4;

struct BwdArgs {
  const void* x;
  const void* g;
  const void* scale;
  const void* bias;
  void* dx;     // null: dx not asked for
  float* part;  // (BG * cs, cpg, 2): sum g' * xhat, sum g'; null: not asked
  int sc_bf16, bi_bf16;
  int G, cpg, n, hw, cs, chunk, keep;
  float eps;
  int act;
};

// the P elements of a unit from p: 16-byte vectors where they fill them
template <typename T, int P>
__device__ __forceinline__ void load_unit(T (&e)[P], const T* p) {
  if constexpr (P * sizeof(T) >= 16) {
#pragma unroll
    for (int j = 0; j < (int)(P * sizeof(T) / 16); ++j)
      reinterpret_cast<uint4*>(e)[j] = reinterpret_cast<const uint4*>(p)[j];
  } else {
#pragma unroll
    for (int k = 0; k < P; ++k) e[k] = p[k];
  }
}

// the P elements of a unit to p, as load_unit reads them
template <typename T, int P>
__device__ __forceinline__ void store_unit(T* p, const T (&e)[P]) {
  if constexpr (P * sizeof(T) >= 16) {
#pragma unroll
    for (int j = 0; j < (int)(P * sizeof(T) / 16); ++j)
      reinterpret_cast<uint4*>(p)[j] = reinterpret_cast<const uint4*>(e)[j];
  } else {
#pragma unroll
    for (int k = 0; k < P; ++k) p[k] = e[k];
  }
}

// g' of one element, and its xhat in *xh, in the plain version's order
__device__ __forceinline__ float grad_y(float v, float gv, float mean,
                                        float rstd, float sc, float bi,
                                        int act, float* xh) {
  *xh = __fmul_rn(__fsub_rn(v, mean), rstd);
  if (!act) return gv;
  const float y = __fadd_rn(__fmul_rn(*xh, sc), bi);
  const float s = __frcp_rn(__fadd_rn(1.f, expf(-y)));
  return __fmul_rn(__fmul_rn(gv, s),
                   __fadd_rn(1.f, __fmul_rn(y, __fsub_rn(1.f, s))));
}

// the cluster's total of each rank's pair t, added in rank order, in thread
// 0 (every thread calls it; with cs > 1 it ends a cluster barrier phase)
__device__ __forceinline__ float2 cluster_total(float2 t, float2* slot,
                                                int cs) {
  if (cs == 1) return t;
  if (threadIdx.x == 0) *slot = t;
  cluster_sync();
  float2 tot = make_float2(0.f, 0.f);
  if (threadIdx.x == 0) {
    const uint32_t pa = smem_u32(slot);
    for (int r = 0; r < cs; ++r) {
      const float2 v = ld_cluster_f2(mapa(pa, r));
      tot.x += v.x;
      tot.y += v.y;
    }
  }
  return tot;
}

// body(u, x, g) for each unit u of [lo, hi): the first `kept` from shared
// memory (xs, gs), then the overflow from device memory (xg, gg), two
// units in flight
template <typename TX, typename TG, int P, typename F>
__device__ __forceinline__ void sweep(int lo, int hi, int kept, const TX* xs,
                                      const TG* gs, const TX* xg,
                                      const TG* gg, F&& body) {
  for (int l = threadIdx.x; l < kept; l += THREADS) {
    alignas(16) TX ex[P];
    alignas(16) TG eg[P];
    load_unit<TX, P>(ex, xs + (size_t)l * P);
    load_unit<TG, P>(eg, gs + (size_t)l * P);
    body(lo + l, ex, eg);
  }
  int u = lo + kept + threadIdx.x;
  for (; u + THREADS < hi; u += 2 * THREADS) {
    alignas(16) TX ex[2][P];
    alignas(16) TG eg[2][P];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      load_unit<TX, P>(ex[j], xg + (size_t)(u + j * THREADS) * P);
      load_unit<TG, P>(eg[j], gg + (size_t)(u + j * THREADS) * P);
    }
    body(u, ex[0], eg[0]);
    body(u + THREADS, ex[1], eg[1]);
  }
  if (u < hi) {
    alignas(16) TX ex[P];
    alignas(16) TG eg[P];
    load_unit<TX, P>(ex, xg + (size_t)u * P);
    load_unit<TG, P>(eg, gg + (size_t)u * P);
    body(u, ex, eg);
  }
}

// Units: with VEC a unit is P = 16 / min(sizeof(TX), sizeof(TG)) elements
// (one or two 16-byte vectors of each), otherwise one element. Rank r owns
// units [lo, hi) of its group, the first `kept` of x and of g in shared
// memory (x's, then g's at keep elements in).
template <typename TX, typename TG, bool VEC>
__global__ void __launch_bounds__(THREADS, 2) gn_bwd(const BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[BWD_MAX_PIECES];
  __shared__ float2 red[NWARPS];
  __shared__ float2 part[2];
  __shared__ float stat[4];
  constexpr int MIN_SIZE = sizeof(TX) < sizeof(TG) ? sizeof(TX) : sizeof(TG);
  constexpr int P = VEC ? 16 / MIN_SIZE : 1;
  const int rank = blockIdx.x % a.cs;
  const size_t bg = blockIdx.x / a.cs;
  const TX* xg = reinterpret_cast<const TX*>(a.x) + bg * (size_t)a.n;
  const TG* gg = reinterpret_cast<const TG*>(a.g) + bg * (size_t)a.n;
  const TX* xs = reinterpret_cast<const TX*>(smem);
  const TG* gs = reinterpret_cast<const TG*>(smem + (size_t)a.keep * sizeof(TX));
  const int nu = a.n / P, cu = a.chunk / P;
  const int lo = min(rank * cu, nu), hi = min(lo + cu, nu);
  const int kept = VEC ? min(a.keep / P, hi - lo) : 0;
  const int pieces = (kept + BWD_PIECE_UNITS - 1) / BWD_PIECE_UNITS;
  const uint32_t bar0 = smem_u32(bars);

  if (VEC && threadIdx.x == 0 && pieces > 0) {
    for (int p = 0; p < pieces; ++p) mbar_init(bar0 + 8 * p, 1);
    fence_barrier_init();
    for (int p = 0; p < pieces; ++p) {
      const int u0 = p * BWD_PIECE_UNITS;
      const uint32_t units = min(BWD_PIECE_UNITS, kept - u0);
      const uint32_t bx = units * P * sizeof(TX), bgr = units * P * sizeof(TG);
      mbar_arrive_expect_tx(bar0 + 8 * p, bx + bgr);
      bulk_load(smem_u32(xs + (size_t)u0 * P), xg + (size_t)(lo + u0) * P, bx,
                bar0 + 8 * p);
      bulk_load(smem_u32(gs + (size_t)u0 * P), gg + (size_t)(lo + u0) * P, bgr,
                bar0 + 8 * p);
    }
  }
  __syncthreads();  // the barriers are initialised before anyone waits

  // pass 1: (sum x, sum x^2), kept units piece by piece, then the overflow
  // two units in flight
  float s = 0.f, q = 0.f;
  auto add = [&](const TX* e) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const float v = to_f(e[k]);
      s += v;
      q += v * v;
    }
  };
  for (int p = 0; p < pieces; ++p) {
    mbar_wait(bar0 + 8 * p, 0);
    const int end = min(kept, (p + 1) * BWD_PIECE_UNITS);
    for (int l = p * BWD_PIECE_UNITS + threadIdx.x; l < end; l += THREADS) {
      alignas(16) TX e[P];
      load_unit<TX, P>(e, xs + (size_t)l * P);
      add(e);
    }
  }
  int u1 = lo + kept + threadIdx.x;
  for (; u1 + THREADS < hi; u1 += 2 * THREADS) {
    alignas(16) TX e[2][P];
    load_unit<TX, P>(e[0], xg + (size_t)u1 * P);
    load_unit<TX, P>(e[1], xg + (size_t)(u1 + THREADS) * P);
    add(e[0]);
    add(e[1]);
  }
  if (u1 < hi) {
    alignas(16) TX e[P];
    load_unit<TX, P>(e, xg + (size_t)u1 * P);
    add(e);
  }
  const float2 t1 = cluster_total(block_sum(s, q, red), &part[0], a.cs);
  if (threadIdx.x == 0) {
    const float mean = __fdiv_rn(t1.x, (float)a.n);
    const float var =
        __fsub_rn(__fdiv_rn(t1.y, (float)a.n), __fmul_rn(mean, mean));
    stat[0] = mean;
    stat[1] = rsqrtf(__fadd_rn(var, a.eps));
  }
  __syncthreads();
  const float mean = stat[0], rstd = stat[1];
  const int c0 = (int)(bg % a.G) * a.cpg;

  // f(k, xhat, dxhat) for each element k of unit u from its x and g
  auto elems = [&](int u, const TX* ex, const TG* eg, auto&& f) {
    const int i = u * P;
    int c = i / a.hw, r = i - c * a.hw;
    float sc = param(a.scale, a.sc_bf16, c0 + c);
    float bi = param(a.bias, a.bi_bf16, c0 + c);
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (r == a.hw) {
        ++c;
        r = 0;
        sc = param(a.scale, a.sc_bf16, c0 + c);
        bi = param(a.bias, a.bi_bf16, c0 + c);
      }
      float xh;
      const float gp =
          grad_y(to_f(ex[k]), to_f(eg[k]), mean, rstd, sc, bi, a.act, &xh);
      f(k, xh, __fmul_rn(gp, sc));
      ++r;
    }
  };

  // pass 2: (sum dxhat, sum dxhat * xhat) over the group
  if (a.dx != nullptr) {
    float s1 = 0.f, s2 = 0.f;
    sweep<TX, TG, P>(lo, hi, kept, xs, gs, xg, gg,
                     [&](int u, const TX* ex, const TG* eg) {
                       elems(u, ex, eg, [&](int, float xh, float d) {
                         s1 += d;
                         s2 += d * xh;
                       });
                     });
    const float2 t2 = cluster_total(block_sum(s1, s2, red), &part[1], a.cs);
    if (threadIdx.x == 0) {
      stat[2] = __fdiv_rn(t2.x, (float)a.n);
      stat[3] = __fdiv_rn(t2.y, (float)a.n);
    }
    __syncthreads();
  }
  if (a.cs > 1) cluster_arrive();  // done reading the other ranks' pairs

  // pass 3: dx
  if (a.dx != nullptr) {
    const float m1 = stat[2], m2 = stat[3];
    TX* dxg = reinterpret_cast<TX*>(a.dx) + bg * (size_t)a.n;
    sweep<TX, TG, P>(lo, hi, kept, xs, gs, xg, gg, [&](int u, const TX* ex,
                                                      const TG* eg) {
      alignas(16) TX o[P];
      elems(u, ex, eg, [&](int k, float xh, float d) {
        put(&o[k], __fmul_rn(rstd, __fsub_rn(__fsub_rn(d, m1),
                                             __fmul_rn(xh, m2))));
      });
      store_unit<TX, P>(dxg + (size_t)u * P, o);
    });
  }

  // the parameters' gradients: this rank's sums of g' * xhat and g' for each
  // channel of its group (zero for a channel outside its elements)
  if (a.part != nullptr) {
    const int e0 = lo * P, e1 = hi * P, ke = kept * P;
    float* out = a.part + (size_t)blockIdx.x * a.cpg * 2;
    for (int c = 0; c < a.cpg; ++c) {
      const float sc = param(a.scale, a.sc_bf16, c0 + c);
      const float bi = param(a.bias, a.bi_bf16, c0 + c);
      const int b1 = min(e1, (c + 1) * a.hw);
      float ds = 0.f, db = 0.f;
      for (int e = max(e0, c * a.hw) + threadIdx.x; e < b1; e += THREADS) {
        const bool on_chip = VEC && e - e0 < ke;
        const float v = to_f(on_chip ? xs[e - e0] : xg[e]);
        const float gv = to_f(on_chip ? gs[e - e0] : gg[e]);
        float xh;
        const float gp = grad_y(v, gv, mean, rstd, sc, bi, a.act, &xh);
        ds += gp * xh;
        db += gp;
      }
      __syncthreads();  // thread 0 has read `red` for the last sum
      const float2 t = block_sum(ds, db, red);
      if (threadIdx.x == 0) {
        out[2 * c] = t.x;
        out[2 * c + 1] = t.y;
      }
    }
  }
  if (a.cs > 1) cluster_wait();  // no rank leaves while another reads it
}

template <typename TX, typename TG, bool VEC>
int launch_bwd(const BwdArgs& a, int BG, cudaStream_t stream) {
  auto* k = gn_bwd<TX, TG, VEC>;
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM_CAP);
    cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed,
                         1);
    attr = true;
  }
  constexpr int MIN_SIZE = sizeof(TX) < sizeof(TG) ? sizeof(TX) : sizeof(TG);
  constexpr int P = VEC ? 16 / MIN_SIZE : 1;
  const size_t smem = VEC ? (size_t)a.keep * (sizeof(TX) + sizeof(TG)) : 0;
  if (VEC && (a.chunk % P != 0 || a.keep % P != 0 || smem > SMEM_CAP ||
              a.keep / P > BWD_MAX_PIECES * BWD_PIECE_UNITS))
    return (int)cudaErrorInvalidValue;
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

template <typename TX, typename TG>
int launch_bwd(const BwdArgs& a, int BG, int vec, cudaStream_t stream) {
  return vec ? launch_bwd<TX, TG, true>(a, BG, stream)
             : launch_bwd<TX, TG, false>(a, BG, stream);
}

// the largest cluster (16, 8, else 4) of kernel k at full shared memory of
// which at least one can be resident; 0 if none or the query fails
template <typename K>
int max_cluster_of(K* k) {
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

extern "C" int groupnorm_bwd(const void* x, const void* g, const void* scale,
                             const void* bias, void* dx, float* part,
                             int x_bf16, int g_bf16, int scale_bf16,
                             int bias_bf16, int BG, int G, int cpg, int n,
                             int hw, int cs, int chunk, int keep, float eps,
                             int act, int vec, void* stream) {
  if (BG <= 0 || n <= 0 || cs <= 0) return 0;
  const BwdArgs a{x,  g,   scale, bias, dx,    part, scale_bf16, bias_bf16,
                  G,  cpg, n,     hw,   cs,    chunk, keep,      eps,
                  act};
  cudaStream_t st = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (x_bf16 && g_bf16) return launch_bwd<bf16, bf16>(a, BG, vec, st);
  if (x_bf16) return launch_bwd<bf16, float>(a, BG, vec, st);
  if (g_bf16) return launch_bwd<float, bf16>(a, BG, vec, st);
  return launch_bwd<float, float>(a, BG, vec, st);
}

extern "C" int groupnorm_max_cluster() {
  auto* k = gn_fused<__nv_bfloat16, __nv_bfloat16, true>;
  return max_cluster_of(k);
}

extern "C" int groupnorm_bwd_max_cluster() {
  auto* k = gn_bwd<__nv_bfloat16, __nv_bfloat16, true>;
  return max_cluster_of(k);
}
