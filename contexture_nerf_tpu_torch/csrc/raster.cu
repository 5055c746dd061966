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
// What bounds it on an H100: the bytes it must write, 16 B a pixel (about
// 0.05 ms for 7 x 1200^2 at 3.35 TB/s); the face input is under 1 MB. The
// work is (pixel, face) pairs whose face box covers the pixel, ~20 FP32
// operations each, far below the 67 TFLOP/s non-tensor rate at these sizes.
//
// What the design does about it: a CTA owns a 16x16 pixel tile, one pixel
// a thread. It streams the faces' boxes (16 B each) in chunks of 256, culls
// each chunk against the tile's box of pixel centres, compacts the faces
// that meet the tile in face order (warp ballots), loads only their setup
// records (64 B each) into shared memory and tests its pixel against each,
// keeping the best (z, face, barycentrics) in registers. The boxes come
// widened from the wrapper, so culling never drops a face a pixel would
// test inside; degenerate faces come with empty boxes. Every tile still
// reads every face's box: binning faces to tiles (or sorting them, as the
// TPU kernel's Morton order does) is later work.
//
// C interface: int raster_fwd(box, rec, xs, ys, B, F, H, W, face_idx, bary,
// stream); box (B,F,4) f32 [xmin xmax ymin ymax], rec (B,F,16) f32 [a0 a1 a2
// b0 b1 b2 c0 c1 c2 den z0 z1 z2 - - -], xs (W,) and ys (H,) the pixel
// centres in NDC. Returns cudaGetLastError().
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TILE = 16;
constexpr int NTHREADS = TILE * TILE;  // one pixel a thread; also the chunk
constexpr int NWARPS = NTHREADS / 32;

__device__ __forceinline__ float edge(float px, float py, float a, float b,
                                      float c, float den) {
  return __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(px, a), __fmul_rn(py, b)), c),
                   den);
}

__global__ void __launch_bounds__(NTHREADS)
    raster_kernel(const float4* __restrict__ box, const float4* __restrict__ rec,
                  const float* __restrict__ xs, const float* __restrict__ ys,
                  int F, int H, int W, int* __restrict__ face_idx,
                  float* __restrict__ bary) {
  __shared__ int list[NTHREADS];
  __shared__ float4 recs[NTHREADS * 4];
  __shared__ int warp_cnt[NWARPS];

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TILE, y0 = blockIdx.y * TILE;
  const int ix = x0 + threadIdx.x % TILE, iy = y0 + threadIdx.x / TILE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float px = xs[min(ix, W - 1)], py = ys[min(iy, H - 1)];
  // the tile's box of pixel centres (y decreases with the row)
  const float tx0 = xs[x0], tx1 = xs[min(x0 + TILE, W) - 1];
  const float ty_top = ys[y0], ty_bot = ys[min(y0 + TILE, H) - 1];

  const float4* fb = box + (size_t)b * F;
  const float4* fr = rec + (size_t)b * F * 4;
  float best_z = -CUDART_INF_F, b0 = 0.f, b1 = 0.f, b2 = 0.f;
  int best_i = -1;

  for (int s = 0; s < F; s += NTHREADS) {
    const int f = s + threadIdx.x;
    bool meets = false;
    if (f < F) {
      const float4 q = fb[f];  // xmin xmax ymin ymax
      meets = q.x <= tx1 && q.y >= tx0 && q.z <= ty_top && q.w >= ty_bot;
    }
    const unsigned m = __ballot_sync(0xffffffffu, meets);
    if (lane == 0) warp_cnt[warp] = __popc(m);
    __syncthreads();
    int base = 0, total = 0;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const int c = warp_cnt[w];
      base += w < warp ? c : 0;
      total += c;
    }
    if (meets) list[base + __popc(m & ((1u << lane) - 1u))] = f;
    __syncthreads();
    for (int i = threadIdx.x; i < total * 4; i += NTHREADS)
      recs[i] = fr[(size_t)list[i >> 2] * 4 + (i & 3)];
    __syncthreads();
    for (int i = 0; i < total; ++i) {
      const float4 r0 = recs[4 * i], r1 = recs[4 * i + 1];
      const float4 r2 = recs[4 * i + 2], r3 = recs[4 * i + 3];
      // r0 = a0 a1 a2 b0, r1 = b1 b2 c0 c1, r2 = c2 den z0 z1, r3 = z2 - - -
      const float w0 = edge(px, py, r0.x, r0.w, r1.z, r2.y);
      const float w1 = edge(px, py, r0.y, r1.x, r1.w, r2.y);
      const float w2 = edge(px, py, r0.z, r1.y, r2.x, r2.y);
      if (w0 >= 0.f && w1 >= 0.f && w2 >= 0.f) {
        const float z = __fadd_rn(__fadd_rn(__fmul_rn(w0, r2.z),
                                            __fmul_rn(w1, r2.w)),
                                  __fmul_rn(w2, r3.x));
        const int fi = list[i];
        if (z > best_z || (z == best_z && fi < best_i)) {
          best_z = z;
          best_i = fi;
          b0 = w0;
          b1 = w1;
          b2 = w2;
        }
      }
    }
    __syncthreads();  // the next chunk overwrites list and recs
  }
  if (ix < W && iy < H) {
    const size_t p = ((size_t)b * H + iy) * W + ix;
    face_idx[p] = best_i;
    bary[3 * p] = b0;
    bary[3 * p + 1] = b1;
    bary[3 * p + 2] = b2;
  }
}

}  // namespace

extern "C" int raster_fwd(const void* box, const void* rec, const void* xs,
                          const void* ys, int B, int F, int H, int W,
                          void* face_idx, void* bary, void* stream) {
  dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  if (B > 0 && F > 0 && H > 0 && W > 0)
    raster_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(box),
        reinterpret_cast<const float4*>(rec),
        reinterpret_cast<const float*>(xs), reinterpret_cast<const float*>(ys),
        F, H, W, reinterpret_cast<int*>(face_idx),
        reinterpret_cast<float*>(bary));
  return (int)cudaGetLastError();
}
