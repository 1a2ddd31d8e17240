// Tile rasterizer for Hopper (sm_90a): triangle constants -> visibility buffer.
//
// Replaces the TPU kernel stable_renderer_tpu/ops/raster_pallas.py
// (_raster_tile_kernel, launched by rasterize_pallas). One block per 16 x 16
// pixel tile, one thread per pixel. The block stages the (T, 20) per-triangle
// constants from ops/raster_kernel.py:triangle_setup through shared memory in
// chunks of 256 rows, then walks the triangles in index order: a block-uniform
// bbox-versus-tile reject, and for survivors each thread runs the edge test,
// the window z clipped to [0, 1], a strict z < zbuf test and the
// perspective-correct barycentrics of its own pixel. Each pixel keeps its
// z / tri_id / bary in registers, so there is no depth-buffer traffic inside
// the loop, and because every pixel visits triangles in order with a strict
// "<", the lowest index wins a depth tie without atomics.
//
// What bounds it on the H100: instruction issue. Every block walks every
// triangle row (the 80-byte rows come from L2 into shared memory), and for
// the many (tile, triangle) pairs that do not overlap, the block-uniform
// bbox reject is the whole inner loop. Binning triangles to tiles first is
// the next step.
//
// Frame edges that are not a multiple of 16 are masked at the write, so any
// H and W work (the TPU kernel needed multiples of its tile).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kChunk = 256;  // triangle rows staged per pass
constexpr int kCols = 20;    // columns of triangle_setup

// column layout (ops/raster_kernel.py): 0-8 normalized edge equations
// b_i = A_i x + B_i y + C_i, 9-11 window z, 12-14 1/w, 15-18 bbox
// (minx, maxx, miny, maxy), 19 valid
__global__ void __launch_bounds__(kThreads)
raster_tile(const float* __restrict__ tri, int t_count, float* __restrict__ z_out,
            int* __restrict__ id_out, float* __restrict__ bary_out, int height, int width) {
  __shared__ float rows[kChunk * kCols];

  const int lx = threadIdx.x % kTile, ly = threadIdx.x / kTile;
  const int x = blockIdx.x * kTile + lx, y = blockIdx.y * kTile + ly;
  const float x0f = (float)(blockIdx.x * kTile), y0f = (float)(blockIdx.y * kTile);
  const float px = (float)x + 0.5f, py = (float)y + 0.5f;

  float zbuf = 1.f;
  int best = -1;
  float bb0 = 0.f, bb1 = 0.f, bb2 = 0.f;

  for (int base = 0; base < t_count; base += kChunk) {
    const int n = min(kChunk, t_count - base);
    __syncthreads();
    for (int i = threadIdx.x; i < n * kCols; i += kThreads)
      rows[i] = tri[(size_t)base * kCols + i];
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float* r = rows + t * kCols;
      // uniform across the block: every thread reads the same row
      const bool valid = r[19] > 0.5f;
      const bool overlap = (r[16] >= x0f) && (r[15] <= x0f + kTile) && (r[18] >= y0f) &&
                           (r[17] <= y0f + kTile);
      if (!(valid && overlap)) continue;
      const float b0 = r[0] * px + r[1] * py + r[2];
      const float b1 = r[3] * px + r[4] * py + r[5];
      const float b2 = r[6] * px + r[7] * py + r[8];
      if (!((b0 >= 0.f) && (b1 >= 0.f) && (b2 >= 0.f))) continue;
      // Renormalized barycentrics for z: in exact arithmetic b0 + b1 + b2 = 1,
      // but at 512 px the pre-normalized edge terms reach |C| ~ W*H/area and
      // cancel to O(1) in f32, so each b_i carries ~1e-4 absolute error.
      // Dividing by the sum leaves sum_i e_i (z_i - z): the z_i of one
      // triangle are close, so z keeps ~1e-7 instead of ~1e-3.
      const float bsum = b0 + b1 + b2;
      float z = (b0 * r[9] + b1 * r[10] + b2 * r[11]) / (bsum > 0.f ? bsum : 1.f);
      z = z < 0.f ? 0.f : (z > 1.f ? 1.f : z);  // keeps NaN, which fails z < zbuf
      if (z < zbuf) {
        const float pb0 = b0 * r[12], pb1 = b1 * r[13], pb2 = b2 * r[14];
        float denom = pb0 + pb1 + pb2;
        if (fabsf(denom) < 1e-12f) denom = 1.f;
        zbuf = z;
        best = base + t;
        bb0 = pb0 / denom;
        bb1 = pb1 / denom;
        bb2 = pb2 / denom;
      }
    }
  }

  if (x < width && y < height) {
    const size_t pix = (size_t)y * width + x;
    z_out[pix] = zbuf;
    id_out[pix] = best;
    bary_out[pix * 3 + 0] = bb0;
    bary_out[pix * 3 + 1] = bb1;
    bary_out[pix * 3 + 2] = bb2;
  }
}

}  // namespace

// tri: contiguous (t_count, 20) f32; z (H, W) f32, tri_id (H, W) i32 and
// bary (H, W, 3) f32 are written in full. Returns a cudaError_t.
extern "C" int sr_raster_tile(const void* tri, int t_count, void* z, void* tri_id, void* bary,
                              int height, int width, void* stream) {
  const dim3 grid((width + kTile - 1) / kTile, (height + kTile - 1) / kTile);
  raster_tile<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tri), t_count, static_cast<float*>(z),
      static_cast<int*>(tri_id), static_cast<float*>(bary), height, width);
  return (int)cudaGetLastError();
}
