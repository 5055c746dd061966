// K5: z-buffered triangle visibility (face index + barycentrics per pixel),
// hand-written for Hopper.
//
// Replaces: contexture_nerf_tpu/raster/pallas_raster.py `_raster_kernel`,
// the pallas_call in `rasterize_geometry_pallas`, reached through the
// renderer's geometry pass (`Renderer.render_geometry`).
//
// What it computes: for each pixel of each view, among the faces whose three
// image-space edge functions w_k = ((x a_k + y b_k) + c_k) / den are all >= 0
// at the pixel centre, the one that maximizes the interpolated camera-space
// z = (w0 z0 + w1 z1) + w2 z2 (z < 0 in front, larger is closer); among
// equal z the lowest face index. Outputs face_idx (B,H,W) int32 (-1 for
// background) and bary (B,H,W,3) f32 (0 on background). Every operation is
// rounded on its own (__fmul_rn/__fadd_rn/__fdiv_rn: no FMA contraction), in
// the order of the plain version (raster/rasterize.py), so the two agree bit
// for bit.
//
// What bounds it on an H100: the bytes it must move, 16 B a pixel out
// (about 0.05 ms for 7 x 1200^2 at 3.35 TB/s) and 36 B a face a view in.
// The work is (pixel, face) pairs whose face box covers the pixel, ~20 FP32
// operations each, far below the 67 TFLOP/s non-tensor rate at these sizes.
//
// What the design does about it: every tile reads only the faces that can
// reach it, so the work follows the (pixel, face) pairs and the output, not
// tiles x faces. Six kernels a call:
// 1. raster_setup, one thread per (view, face): reads the face's 36 bytes
//    once and writes its record (a0 a1 a2 b0 b1 b2 c0 c1 c2 den z0 z1 z2,
//    the arithmetic of `face_edge_setup`, bit-identical to the wrapper's
//    `face_records`) and its conservative range of pixels: the box padded
//    by BOX_PAD mapped to pixel indices (floor at the low edge, ceil at the
//    high one) and clamped to the frame, as `pixel_ranges` in
//    raster/raster_kernel.py computes it. A degenerate face (|den| <=
//    1e-12) or one with a non-finite vertex or box gets the empty range;
//    the float coordinates are clamped before any conversion to int. Its
//    16x16 tiles are the pixel range divided by 16.
// 2. raster_count: per (view, face), one integer atomicAdd on each tile of
//    its range (exact whatever the order).
// 3. raster_scan_sums, raster_scan: an exclusive 64-bit scan of the
//    counts over (view, tile row, tile column) in two passes of CTAs of
//    4096 counts (four a thread, read as one int4): each CTA's sum, then
//    each CTA's offsets (written as longlong2) after the earlier CTAs'
//    sums, with the list of busy tiles (those with a face). offsets[T] is
//    the list total and offsets[T + 1] the busy tiles; the wrapper reads
//    both in one copy a call, to size the list and the tile pass's grid
//    (the only host read; both depend on the data). Before it, the outputs
//    are filled with background (cudaMemsetAsync: -1 is all ones, 0.0f
//    all zeros), so the card writes them while the host waits.
// 4. raster_scatter: per (view, face), each tile of its range takes a slot
//    with an atomicSub on its count (so the counts end at 0) and gets the
//    face index there.
// 5. raster_tiles: a CTA owns one busy (view, tile), one pixel a thread,
//    each warp an 8x4 block. It stages its list's records and pixel ranges
//    in shared memory 256 faces at a time; each warp tests 32 of them at a
//    time against its block (a ballot: exact, since a pixel inside a face
//    is inside its pixel range) and runs its pixels' edge tests only on
//    the faces that meet the block. Only covered pixels are written; the
//    rest keep the background.
// Two variants were measured slower and are not used: 128-thread CTAs of
// two pixels a thread in 8x8 warp blocks (twice the tiles in flight, but
// coarser culling), and a sign test on the numerators that skips the
// divisions (exact where |n| >= 2^-100 and |den| <= 2^40) once the warps
// cull by range.
// The order inside a list does not matter: the scatter's atomics give a
// different order on every run, but the winner is the maximum of
// (z, -face index) under a total order (z > best_z, or z == best_z and a
// lower index; starting from (-inf, -1); a NaN z never compares true), and
// each face's barycentrics do not depend on the order, so two runs are
// bit-identical. The per-face edge tests are scalar FP32 work with a
// data-dependent gather of faces: no matrix product for the tensor cores,
// and no fixed tile of memory for TMA to copy, so neither is used.
//
// C interface, each returning cudaGetLastError():
//   raster_setup(fvz, fvi, BF, H, W, rec, range, ntiles, stream): fvz
//     (B,F,3) f32, fvi (B,F,3,2) f32, contiguous; rec (B,F,16) f32, range
//     (B,F,4) int32 pixel range [ix0 ix1 iy0 iy1] inclusive ((0,-1,0,-1)
//     when empty), ntiles (B,F) int32 the tiles the range covers.
//   raster_bin(range, B, F, H, W, cnt, part, off, busy, face_idx, bary,
//     stream): the binning up to the scan. cnt (B*TY*TX rounded up to 4)
//     int32, part (2 x the scan's CTAs) int64, busy (B*TY*TX) int32
//     scratch; off (B*TY*TX + 2) int64; face_idx (B,H,W) int32 and bary
//     (B,H,W,3) f32 the outputs, filled with background here.
//   raster_draw(range, rec, off, cnt, list, busy, n_busy, xs, ys, B, F, H,
//     W, face_idx, bary, stream): list (off[T]) int32 scratch, n_busy =
//     off[T + 1]; xs (W,) and ys (H,) the pixel centres in NDC; cnt as
//     raster_bin left it.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TILE = 16;
constexpr int NTHREADS = TILE * TILE;  // a tile-pass CTA: a pixel a thread
constexpr float BOX_PAD = 1e-4f;  // raster/raster_kernel.py BOX_PAD
constexpr float EPS = 1e-12f;     // raster/rasterize.py EPS

__device__ __forceinline__ float edge(float px, float py, float a, float b,
                                      float c, float den) {
  return __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(px, a), __fmul_rn(py, b)), c),
                   den);
}

// x1 * y2 - x2 * y1: two products, then the subtraction
__device__ __forceinline__ float cross(float x1, float y2, float x2,
                                       float y1) {
  return __fsub_rn(__fmul_rn(x1, y2), __fmul_rn(x2, y1));
}

// the first pixel index whose centre can lie at or above NDC `lo`, as a
// float: (lo + 1) * (n / 2) - 0.5, clamped to [-1, n] (finite input)
__device__ __forceinline__ float pixel_coord(float lo, float half_n,
                                             float n) {
  const float t = __fsub_rn(__fmul_rn(__fadd_rn(lo, 1.f), half_n), 0.5f);
  return fminf(fmaxf(t, -1.f), n);
}

__global__ void __launch_bounds__(NTHREADS)
    raster_setup_kernel(const float* __restrict__ fvz,
                        const float* __restrict__ fvi, int BF, int H, int W,
                        float4* __restrict__ rec, int4* __restrict__ range,
                        int* __restrict__ ntiles) {
  const int i = blockIdx.x * NTHREADS + threadIdx.x;
  if (i >= BF) return;
  const float* v = fvi + (size_t)6 * i;
  const float x0 = v[0], y0 = v[1], x1 = v[2], y1 = v[3], x2 = v[4],
              y2 = v[5];
  const float* zz = fvz + (size_t)3 * i;
  const float den = __fsub_rn(
      __fmul_rn(__fsub_rn(x1, x0), __fsub_rn(y2, y0)),
      __fmul_rn(__fsub_rn(x2, x0), __fsub_rn(y1, y0)));
  float4* r = rec + (size_t)4 * i;
  r[0] = make_float4(__fsub_rn(y1, y2), __fsub_rn(y2, y0), __fsub_rn(y0, y1),
                     __fsub_rn(x2, x1));
  r[1] = make_float4(__fsub_rn(x0, x2), __fsub_rn(x1, x0),
                     cross(x1, y2, x2, y1), cross(x2, y0, x0, y2));
  r[2] = make_float4(cross(x0, y1, x1, y0), den, zz[0], zz[1]);
  r[3] = make_float4(zz[2], 0.f, 0.f, 0.f);

  // the padded box, as face_records computes it
  const float amax = fmaxf(fmaxf(fmaxf(fabsf(x0), fabsf(y0)),
                                 fmaxf(fabsf(x1), fabsf(y1))),
                           fmaxf(fabsf(x2), fabsf(y2)));
  const float m = __fmul_rn(BOX_PAD, __fadd_rn(1.f, amax));
  const float xmin = __fsub_rn(fminf(fminf(x0, x1), x2), m);
  const float xmax = __fadd_rn(fmaxf(fmaxf(x0, x1), x2), m);
  const float ymin = __fsub_rn(fminf(fminf(y0, y1), y2), m);
  const float ymax = __fadd_rn(fmaxf(fmaxf(y0, y1), y2), m);
  // fminf/fmaxf drop a NaN operand, so the vertices are tested themselves
  bool ok = fabsf(den) > EPS && isfinite(x0) && isfinite(y0) &&
            isfinite(x1) && isfinite(y1) && isfinite(x2) && isfinite(y2) &&
            isfinite(xmin) && isfinite(xmax) && isfinite(ymin) &&
            isfinite(ymax);
  int4 tr = make_int4(0, -1, 0, -1);  // pixel range, empty
  if (ok) {
    const float hw = 0.5f * (float)W, hh = 0.5f * (float)H;
    // rows run down the frame: y = 1 - (iy + 0.5) / H * 2
    const int ix0 = max((int)floorf(pixel_coord(xmin, hw, (float)W)), 0);
    const int ix1 = min((int)ceilf(pixel_coord(xmax, hw, (float)W)), W - 1);
    const int iy0 = max((int)floorf(pixel_coord(-ymax, hh, (float)H)), 0);
    const int iy1 = min((int)ceilf(pixel_coord(-ymin, hh, (float)H)), H - 1);
    if (ix0 <= ix1 && iy0 <= iy1) tr = make_int4(ix0, ix1, iy0, iy1);
  }
  range[i] = tr;
  ntiles[i] = tr.x <= tr.y ? (tr.y / TILE - tr.x / TILE + 1) *
                                 (tr.w / TILE - tr.z / TILE + 1)
                           : 0;
}

__global__ void __launch_bounds__(NTHREADS)
    raster_count_kernel(const int4* __restrict__ range, int BF, int F,
                        int tiles, int TX, int* __restrict__ cnt) {
  const int i = blockIdx.x * NTHREADS + threadIdx.x;
  if (i >= BF) return;
  const int4 r = range[i];
  if (r.x > r.y) return;  // empty
  int* c = cnt + (size_t)(i / F) * tiles;
  for (int ty = r.z / TILE; ty <= r.w / TILE; ++ty)
    for (int tx = r.x / TILE; tx <= r.y / TILE; ++tx)
      atomicAdd(c + ty * TX + tx, 1);
}

constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_STEP = SCAN_THREADS * 4;  // counts a CTA of the scan

// Exclusive scan over a CTA of SCAN_THREADS of (sum, busy count) pairs:
// returns each thread's exclusive prefixes and the CTA's totals.
__device__ __forceinline__ void block_scan(long long own, int own_busy,
                                           long long& excl, int& excl_busy,
                                           long long& total,
                                           int& total_busy) {
  __shared__ long long warp_sum[SCAN_THREADS / 32];
  __shared__ int warp_busy[SCAN_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long x = own;  // inclusive scans within the warp
  int y = own_busy;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long xu = __shfl_up_sync(0xffffffffu, x, d);
    const int yu = __shfl_up_sync(0xffffffffu, y, d);
    if (lane >= d) {
      x += xu;
      y += yu;
    }
  }
  if (lane == 31) {
    warp_sum[warp] = x;
    warp_busy[warp] = y;
  }
  __syncthreads();
  if (warp == 0) {
    long long w = warp_sum[lane];
    int u = warp_busy[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long wu = __shfl_up_sync(0xffffffffu, w, d);
      const int uu = __shfl_up_sync(0xffffffffu, u, d);
      if (lane >= d) {
        w += wu;
        u += uu;
      }
    }
    warp_sum[lane] = w;
    warp_busy[lane] = u;
  }
  __syncthreads();
  excl = x - own + (warp > 0 ? warp_sum[warp - 1] : 0);
  excl_busy = y - own_busy + (warp > 0 ? warp_busy[warp - 1] : 0);
  total = warp_sum[SCAN_THREADS / 32 - 1];
  total_busy = warp_busy[SCAN_THREADS / 32 - 1];
}

// four counts from i on, as one int4: cnt is zero-padded to a multiple of
// 4, so an int4 at i < T stays inside it
__device__ __forceinline__ int4 counts4(const int* cnt, int i, int T) {
  return i < T ? *reinterpret_cast<const int4*>(cnt + i)
               : make_int4(0, 0, 0, 0);
}

__device__ __forceinline__ int busy4(int4 v) {
  return (v.x > 0) + (v.y > 0) + (v.z > 0) + (v.w > 0);
}

// pass 1: each CTA's sum and busy count into part[2 * CTA], part[2 * CTA + 1]
__global__ void __launch_bounds__(SCAN_THREADS)
    raster_scan_sums_kernel(const int* __restrict__ cnt, int T,
                            long long* __restrict__ part) {
  const int4 v = counts4(cnt, blockIdx.x * SCAN_STEP + 4 * threadIdx.x, T);
  long long excl, total;
  int excl_busy, total_busy;
  block_scan((long long)v.x + v.y + v.z + v.w, busy4(v), excl, excl_busy,
             total, total_busy);
  if (threadIdx.x == 0) {
    part[2 * blockIdx.x] = total;
    part[2 * blockIdx.x + 1] = total_busy;
  }
}

// pass 2: each CTA adds the earlier CTAs' sums (in order) and scans its own
// counts into off, listing its busy tiles; the last CTA writes off[T] (the
// list total) and off[T + 1] (the busy tiles)
__global__ void __launch_bounds__(SCAN_THREADS)
    raster_scan_kernel(const int* __restrict__ cnt, int T,
                       const long long* __restrict__ part,
                       long long* __restrict__ off, int* __restrict__ busy) {
  const int i0 = blockIdx.x * SCAN_STEP + 4 * threadIdx.x;
  const int4 c = counts4(cnt, i0, T);  // in flight during the first scan
  long long ps = 0;
  int pb = 0;
  for (int k = threadIdx.x; k < (int)blockIdx.x; k += SCAN_THREADS) {
    ps += part[2 * k];
    pb += (int)part[2 * k + 1];
  }
  long long excl, total, base_sum;
  int excl_busy, total_busy, base_busy;
  block_scan(ps, pb, excl, excl_busy, base_sum, base_busy);
  __syncthreads();  // block_scan's shared sums are written again below
  const int v[4] = {c.x, c.y, c.z, c.w};
  block_scan((long long)c.x + c.y + c.z + c.w, busy4(c), excl, excl_busy,
             total, total_busy);
  long long r[4];
  r[0] = base_sum + excl;
  int b = base_busy + excl_busy;
#pragma unroll
  for (int k = 1; k < 4; ++k) r[k] = r[k - 1] + v[k - 1];
  if (i0 + 3 < T) {
    longlong2* o = reinterpret_cast<longlong2*>(off + i0);
    o[0] = make_longlong2(r[0], r[1]);
    o[1] = make_longlong2(r[2], r[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i0 + k < T) off[i0 + k] = r[k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (v[k] > 0) busy[b++] = i0 + k;
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    off[T] = base_sum + total;
    off[T + 1] = base_busy + total_busy;
  }
}

__global__ void __launch_bounds__(NTHREADS)
    raster_scatter_kernel(const int4* __restrict__ range,
                          const long long* __restrict__ off, int BF, int F,
                          int tiles, int TX, int* __restrict__ cnt,
                          int* __restrict__ list) {
  const int i = blockIdx.x * NTHREADS + threadIdx.x;
  if (i >= BF) return;
  const int4 r = range[i];
  if (r.x > r.y) return;  // empty
  const int b = i / F, f = i - b * F;
  const size_t t0 = (size_t)b * tiles;
  for (int ty = r.z / TILE; ty <= r.w / TILE; ++ty)
    for (int tx = r.x / TILE; tx <= r.y / TILE; ++tx) {
      const size_t t = t0 + ty * TX + tx;
      list[off[t] + atomicSub(cnt + t, 1) - 1] = f;
    }
}

__global__ void __launch_bounds__(NTHREADS)
    raster_tiles_kernel(const float4* __restrict__ rec,
                        const int4* __restrict__ range,
                        const long long* __restrict__ off,
                        const int* __restrict__ list,
                        const int* __restrict__ busy,
                        const float* __restrict__ xs,
                        const float* __restrict__ ys, int F, int H, int W,
                        int TX, int TY, int* __restrict__ face_idx,
                        float* __restrict__ bary) {
  __shared__ int ids[NTHREADS];
  __shared__ int4 prs[NTHREADS];
  __shared__ float4 recs[NTHREADS * 4];

  const int t = busy[blockIdx.x];
  const int b = t / (TX * TY), tx = t % TX, ty = t / TX % TY;
  // warp w owns the 8x4 block (w % 2, w / 2) of the tile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wx = tx * TILE + (warp & 1) * 8;
  const int wy = ty * TILE + (warp >> 1) * 4;
  const int ix = wx + (lane & 7), iy = wy + (lane >> 3);
  const float px = xs[min(ix, W - 1)], py = ys[min(iy, H - 1)];
  const float4* fr = rec + (size_t)b * F * 4;
  const int4* fp = range + (size_t)b * F;
  const long long s = off[t], e = off[t + 1];
  float best_z = -CUDART_INF_F, b0 = 0.f, b1 = 0.f, b2 = 0.f;
  int best_i = -1;

  for (long long c = s; c < e; c += NTHREADS) {
    const int n = (int)min((long long)NTHREADS, e - c);
    if (threadIdx.x < n) {
      const int f = list[c + threadIdx.x];
      ids[threadIdx.x] = f;
      prs[threadIdx.x] = fp[f];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n * 4; i += NTHREADS)
      recs[i] = fr[(size_t)ids[i >> 2] * 4 + (i & 3)];
    __syncthreads();
    for (int j = 0; j < n; j += 32) {
      bool meets = false;
      if (j + lane < n) {
        const int4 q = prs[j + lane];  // ix0 ix1 iy0 iy1
        meets = q.x <= wx + 7 && q.y >= wx && q.z <= wy + 3 && q.w >= wy;
      }
      for (unsigned m = __ballot_sync(0xffffffffu, meets); m; m &= m - 1) {
        const int i = j + __ffs(m) - 1;
        const float4 r0 = recs[4 * i], r1 = recs[4 * i + 1];
        const float4 r2 = recs[4 * i + 2], r3 = recs[4 * i + 3];
        // r0 = a0 a1 a2 b0, r1 = b1 b2 c0 c1, r2 = c2 den z0 z1, r3 = z2
        const float w0 = edge(px, py, r0.x, r0.w, r1.z, r2.y);
        const float w1 = edge(px, py, r0.y, r1.x, r1.w, r2.y);
        const float w2 = edge(px, py, r0.z, r1.y, r2.x, r2.y);
        if (w0 >= 0.f && w1 >= 0.f && w2 >= 0.f) {
          const float z = __fadd_rn(__fadd_rn(__fmul_rn(w0, r2.z),
                                              __fmul_rn(w1, r2.w)),
                                    __fmul_rn(w2, r3.x));
          const int fi = ids[i];
          if (z > best_z || (z == best_z && fi < best_i)) {
            best_z = z;
            best_i = fi;
            b0 = w0;
            b1 = w1;
            b2 = w2;
          }
        }
      }
    }
    __syncthreads();  // the next chunk overwrites ids, prs and recs
  }
  if (best_i >= 0 && ix < W && iy < H) {  // the rest stays background
    const size_t p = ((size_t)b * H + iy) * W + ix;
    face_idx[p] = best_i;
    bary[3 * p] = b0;
    bary[3 * p + 1] = b1;
    bary[3 * p + 2] = b2;
  }
}

}  // namespace

extern "C" int raster_setup(const void* fvz, const void* fvi, int BF, int H,
                            int W, void* rec, void* range, void* ntiles,
                            void* stream) {
  if (BF > 0)
    raster_setup_kernel<<<(BF + NTHREADS - 1) / NTHREADS, NTHREADS, 0,
                          (cudaStream_t)stream>>>(
        reinterpret_cast<const float*>(fvz),
        reinterpret_cast<const float*>(fvi), BF, H, W,
        reinterpret_cast<float4*>(rec), reinterpret_cast<int4*>(range),
        reinterpret_cast<int*>(ntiles));
  return (int)cudaGetLastError();
}

extern "C" int raster_bin(const void* range, int B, int F, int H, int W,
                          void* cnt, void* part, void* off, void* busy,
                          void* face_idx, void* bary, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int TX = (W + TILE - 1) / TILE, TY = (H + TILE - 1) / TILE;
  const int tiles = TX * TY, T = B * tiles, BF = B * F;
  const int scan_ctas = (T + SCAN_STEP - 1) / SCAN_STEP;
  const size_t P = (size_t)B * H * W;
  cudaMemsetAsync(face_idx, 0xff, sizeof(int) * P, st);  // -1
  cudaMemsetAsync(bary, 0, sizeof(float) * 3 * P, st);
  int* c = reinterpret_cast<int*>(cnt);
  cudaMemsetAsync(c, 0, sizeof(int) * (size_t)((T + 3) / 4 * 4), st);
  if (BF > 0)
    raster_count_kernel<<<(BF + NTHREADS - 1) / NTHREADS, NTHREADS, 0, st>>>(
        reinterpret_cast<const int4*>(range), BF, F, tiles, TX, c);
  long long* pt = reinterpret_cast<long long*>(part);
  raster_scan_sums_kernel<<<scan_ctas, SCAN_THREADS, 0, st>>>(c, T, pt);
  raster_scan_kernel<<<scan_ctas, SCAN_THREADS, 0, st>>>(
      c, T, pt, reinterpret_cast<long long*>(off),
      reinterpret_cast<int*>(busy));
  return (int)cudaGetLastError();
}

extern "C" int raster_draw(const void* range, const void* rec,
                           const void* off, void* cnt, void* list,
                           const void* busy, int n_busy, const void* xs,
                           const void* ys, int B, int F, int H, int W,
                           void* face_idx, void* bary, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int TX = (W + TILE - 1) / TILE, TY = (H + TILE - 1) / TILE;
  const int BF = B * F;
  if (BF > 0)
    raster_scatter_kernel<<<(BF + NTHREADS - 1) / NTHREADS, NTHREADS, 0,
                            st>>>(
        reinterpret_cast<const int4*>(range),
        reinterpret_cast<const long long*>(off), BF, F, TX * TY, TX,
        reinterpret_cast<int*>(cnt), reinterpret_cast<int*>(list));
  if (n_busy > 0)
    raster_tiles_kernel<<<n_busy, NTHREADS, 0, st>>>(
        reinterpret_cast<const float4*>(rec),
        reinterpret_cast<const int4*>(range),
        reinterpret_cast<const long long*>(off),
        reinterpret_cast<const int*>(list), reinterpret_cast<const int*>(busy),
        reinterpret_cast<const float*>(xs), reinterpret_cast<const float*>(ys),
        F, H, W, TX, TY, reinterpret_cast<int*>(face_idx),
        reinterpret_cast<float*>(bary));
  return (int)cudaGetLastError();
}
