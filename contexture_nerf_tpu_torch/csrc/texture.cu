// K7: the masked texture sample (the renderer's texture pass) and its
// gradient, hand-written for Hopper.
//
// Replaces: no TPU kernel. The JAX package left `sample_texture`
// (contexture_nerf_tpu/ops/texture.py) to XLA. The port added K7 because
// autograd through the plain gathers (ops/texture.py `sample_texture`)
// scatter-adds the gradient with float atomics, and every background pixel
// has uv (0, 0), so all four of its taps clamp onto one texel (row TH - 1,
// column 0). On the exact path's 6 views of 1200^2 some 77 M of the 104 M
// atomic adds a step landed on those 18 addresses and serialised, each
// adding exactly 0 (the mask and the out-of-bounds taps zero them): ~60 ms
// a step for work worth ~0.04 ms.
//
// What it computes, with the texture (Bt, 3, TH, TW) in any strides, Bt 1
// or B, uv (B, H, W, 2) and mask (B, 1, H, W) contiguous float32:
// 1. texture_fwd, one thread a pixel: image[b, c, y, x] = sample * mask,
//    the sample as the plain version takes it (grid_sample, align_corners
//    false, zero padding, v flipped): px = u TW - 0.5, py = (1 - v) TH -
//    0.5; bilinear: the four taps at floor(px), floor(py) and +1, an
//    out-of-bounds tap 0, (v00 (1 - wx) + v01 wx) (1 - wy) + (v10 (1 - wx)
//    + v11 wx) wy; nearest: the tap at floor(px + 0.5), floor(py + 0.5).
//    Every operation is rounded on its own (__fmul_rn / __fadd_rn: no FMA
//    contraction) in the plain version's order, so the two agree bit for
//    bit. A pixel whose mask is 0 reads no texel and writes 0 (the plain
//    version's sample times 0, for a finite texture). Output (B, 3, H, W)
//    contiguous.
// 2. texture_bwd, one thread a texel: dtexture = S^T g over the plan
//    (ops/texture.py `TexturePlan`), the texel-major list of the in-bounds
//    taps of masked pixels with their weights (the tap's bilinear weight
//    times the mask), sorted by (texel, view, pixel). The thread sums g[b,
//    c, y, x] * w over its entries in that order from 0, all views in the
//    one pass, and writes its three channels once, in the texture's own
//    layout. No atomics and no zero-fill: every texel is written by its own
//    thread, and the sum order is fixed, so the gradient is the same from
//    run to run and equal, bit for bit, to the plain segment sum on the CPU
//    (`texture_bwd_plain`).
//
// What bounds it on an H100: bytes. Forward: the mask, the masked pixels'
// uv, the image and the texture, ~190 MB on the exact path (6 x 1200^2, a
// 1024^2 texture), ~0.06 ms at 3.35 TB/s. Backward: the plan's entries (8
// B each, 9.0 M), its offsets, the masked pixels' gradient once and
// dtexture, ~116 MB, ~0.035 ms. The operations (a few FP32 products a tap)
// are far below the 67 TFLOP/s non-tensor rate.
//
// What the design does about it: the background is skipped in both passes
// (74% of the exact path's pixels): the forward reads its mask and writes
// zeros, the plan holds none of its taps. The forward's reads of uv and
// mask and its writes are coalesced (consecutive threads, consecutive
// pixels); the texture is 12 MB and stays in the 50 MB L2. The backward's
// entries are read as contiguous runs a thread; its gradient reads follow
// the texels' footprints in the views, which neighbouring texels share.

#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 256;

// the tap (iy, ix) of a texture at (c, ., .), 0 outside it
__device__ __forceinline__ float tap(const float* __restrict__ t,
                                     long long sy, long long sx, int TH,
                                     int TW, int iy, int ix) {
  if (iy < 0 || iy >= TH || ix < 0 || ix >= TW) return 0.f;
  return __ldg(t + iy * sy + ix * sx);
}

template <bool NEAREST>
__global__ void __launch_bounds__(NTHREADS)
    texture_fwd_kernel(const float2* __restrict__ uv,
                       const float* __restrict__ mask,
                       const float* __restrict__ tex, long long sb,
                       long long sc, long long sy, long long sx, int batched,
                       int P, int HW, int TH, int TW,
                       float* __restrict__ out) {
  const int p = blockIdx.x * NTHREADS + threadIdx.x;
  if (p >= P) return;
  const int b = p / HW;
  float* o = out + (long long)b * 3 * HW + (p - b * HW);
  const float m = mask[p];
  if (m == 0.f) {
    o[0] = 0.f;
    o[HW] = 0.f;
    o[2 * HW] = 0.f;
    return;
  }
  const float2 t = uv[p];
  const float px = __fsub_rn(__fmul_rn(t.x, (float)TW), 0.5f);
  const float py = __fsub_rn(__fmul_rn(__fsub_rn(1.f, t.y), (float)TH), 0.5f);
  const float* tb = tex + (batched ? b * sb : 0);
  if (NEAREST) {
    const int ix = (int)floorf(__fadd_rn(px, 0.5f));
    const int iy = (int)floorf(__fadd_rn(py, 0.5f));
#pragma unroll
    for (int c = 0; c < 3; ++c)
      o[c * HW] = __fmul_rn(tap(tb + c * sc, sy, sx, TH, TW, iy, ix), m);
    return;
  }
  const float fx = floorf(px), fy = floorf(py);
  const float wx = __fsub_rn(px, fx), wy = __fsub_rn(py, fy);
  const float ax = __fsub_rn(1.f, wx), ay = __fsub_rn(1.f, wy);
  const int x0 = (int)fx, y0 = (int)fy;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float* tc = tb + c * sc;
    const float top =
        __fadd_rn(__fmul_rn(tap(tc, sy, sx, TH, TW, y0, x0), ax),
                  __fmul_rn(tap(tc, sy, sx, TH, TW, y0, x0 + 1), wx));
    const float bot =
        __fadd_rn(__fmul_rn(tap(tc, sy, sx, TH, TW, y0 + 1, x0), ax),
                  __fmul_rn(tap(tc, sy, sx, TH, TW, y0 + 1, x0 + 1), wx));
    o[c * HW] =
        __fmul_rn(__fadd_rn(__fmul_rn(top, ay), __fmul_rn(bot, wy)), m);
  }
}

__global__ void __launch_bounds__(NTHREADS)
    texture_bwd_kernel(const int* __restrict__ off,
                       const int* __restrict__ pix,
                       const float* __restrict__ w,
                       const float* __restrict__ g, long long gb,
                       long long gc, long long gy, long long gx, int HW,
                       int W, int T, float* __restrict__ dt, long long db,
                       long long dc, long long dy, long long dx, int TH,
                       int TW) {
  const int t = blockIdx.x * NTHREADS + threadIdx.x;
  if (t >= T) return;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  const int end = off[t + 1];
  for (int k = off[t]; k < end; ++k) {
    const int p = __ldg(pix + k);
    const float wk = __ldg(w + k);
    const int b = p / HW, r = p - b * HW;
    const int y = r / W, x = r - y * W;
    const float* gp = g + b * gb + y * gy + x * gx;
    a0 = __fadd_rn(a0, __fmul_rn(__ldg(gp), wk));
    a1 = __fadd_rn(a1, __fmul_rn(__ldg(gp + gc), wk));
    a2 = __fadd_rn(a2, __fmul_rn(__ldg(gp + 2 * gc), wk));
  }
  const int per = TH * TW, tb = t / per, r = t - tb * per;
  const int ty = r / TW, tx = r - ty * TW;
  float* d = dt + tb * db + ty * dy + tx * dx;
  d[0] = a0;
  d[dc] = a1;
  d[2 * dc] = a2;
}

}  // namespace

extern "C" int texture_fwd(const void* uv, const void* mask, const void* tex,
                           long long sb, long long sc, long long sy,
                           long long sx, int batched, int B, int H, int W,
                           int TH, int TW, int nearest, void* out,
                           void* stream) {
  const int P = B * H * W;
  if (P <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int grid = (P + NTHREADS - 1) / NTHREADS;
  auto* k = nearest ? texture_fwd_kernel<true> : texture_fwd_kernel<false>;
  k<<<grid, NTHREADS, 0, st>>>(
      reinterpret_cast<const float2*>(uv),
      reinterpret_cast<const float*>(mask),
      reinterpret_cast<const float*>(tex), sb, sc, sy, sx, batched, P, H * W,
      TH, TW, reinterpret_cast<float*>(out));
  return (int)cudaGetLastError();
}

extern "C" int texture_bwd(const void* off, const void* pix, const void* w,
                           const void* g, long long gb, long long gc,
                           long long gy, long long gx, int HW, int W, int T,
                           void* dt, long long db, long long dc, long long dy,
                           long long dx, int TH, int TW, void* stream) {
  if (T <= 0) return 0;
  texture_bwd_kernel<<<(T + NTHREADS - 1) / NTHREADS, NTHREADS, 0,
                       (cudaStream_t)stream>>>(
      reinterpret_cast<const int*>(off), reinterpret_cast<const int*>(pix),
      reinterpret_cast<const float*>(w), reinterpret_cast<const float*>(g),
      gb, gc, gy, gx, HW, W, T, reinterpret_cast<float*>(dt), db, dc, dy, dx,
      TH, TW);
  return (int)cudaGetLastError();
}
