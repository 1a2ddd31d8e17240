// Tile rasterizer for Hopper (sm_90a): clip-space vertices -> visibility buffer.
//
// Replaces the TPU kernel stable_renderer_tpu/ops/raster_pallas.py
// (_raster_tile_kernel, launched by rasterize_pallas, with its per-triangle
// setup triangle_setup). Two kernels a call:
//
//   1. raster_setup: one thread a triangle computes the (T, 20) constants of
//      ops/raster_kernel.py:triangle_setup from clip_pos and tris, with the
//      same operations in the same order as that function and as
//      ops/raster.py:window_coords (each PyTorch op rounds once, so every
//      product, sum and quotient here is an _rn intrinsic: nothing is
//      contracted into an FMA). On the card the constants equal
//      triangle_setup's bit for bit. In the same pass it writes the triangle's
//      tile range, int16 x 4 (first and last tile column, first and last tile
//      row; empty as lo > hi), so that culling reads 8 bytes a triangle
//      instead of an 80-byte row. The range holds exactly the tiles that pass
//      the TPU kernel's inclusive bbox test (maxx >= x0, minx <= x0 + 16, the
//      same in y; a triangle that is not valid, or has a NaN bound, passes
//      no tile): see tile_range below and ops/raster_kernel.py:tile_ranges.
//   2. raster_binned: one block a 16 x 16 tile, one thread a pixel. The block
//      culls the triangles in chunks of 2048 (eight a thread, 8-byte range
//      loads), marks the ones whose range holds the tile with __ballot_sync,
//      compacts their indices into shared memory in index order (warp counts
//      and one warp's prefix sum), then rasterizes that list: edge test, window
//      z renormalized by the barycentric sum and clipped to [0, 1], a strict
//      z < zbuf, perspective-correct barycentrics. Each pixel keeps z / tri_id
//      / bary in registers; visiting triangles in index order with a strict
//      "<" gives the lowest index on a depth tie without atomics. No list has a
//      fixed capacity beyond the chunk, so any T and any number of triangles a
//      tile work; frame edges that are not a multiple of 16 are masked at the
//      write. The per-pixel arithmetic is _rn too, so the output equals the
//      plain ops/raster_kernel.py:rasterize_tiles_reference bit for bit.
//
// What bounds it on the H100: the culling. Each tile reads every triangle's
// 8-byte range from L2 (4512 triangles x 1024 tiles ~ 37 MB at 512x512), a few
// instructions each; the survivors (a few dozen a tile on the bench sphere) are
// ~30 operations a pixel. The HBM bytes (clip, tris in; 5 MB of z, tri_id,
// bary out) are the roofline bound, ~1.6 us at 512x512.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                     // triangles a thread tests per chunk
constexpr int kChunk = kThreads * kPer;     // triangles culled per pass
constexpr int kCols = 20;                   // columns of triangle_setup
constexpr int kSetupThreads = 256;
static_assert(kPer * kWarps == 64, "the prefix sum takes two warp counts a lane");

// torch.minimum / torch.maximum: NaN propagates, else min.f32 / max.f32
__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

struct Window {
  float sx, sy, sz, iw, w;
};

// ops/raster.py:window_coords for one vertex. PyTorch's 1.0 / t is
// reciprocal(t) * 1.0, and its reciprocal is an IEEE division.
__device__ __forceinline__ Window window_coords(float4 c, float width, float height) {
  const float safe = fabsf(c.w) < 1e-8f ? 1e-8f : c.w;
  Window v;
  v.sx = __fmul_rn(__fmul_rn(__fadd_rn(__fdiv_rn(c.x, safe), 1.f), 0.5f), width);
  v.sy = __fmul_rn(__fmul_rn(__fsub_rn(1.f, __fdiv_rn(c.y, safe)), 0.5f), height);
  v.sz = __fmul_rn(__fadd_rn(__fdiv_rn(c.z, safe), 1.f), 0.5f);
  v.iw = __fdiv_rn(1.f, safe);
  v.w = c.w;
  return v;
}

// edge(ax, ay, bx, by) of triangle_setup: -(by - ay), bx - ax,
// (by - ay) * ax - (bx - ax) * ay, each scaled by inv_area
__device__ __forceinline__ void edge(float ax, float ay, float bx, float by, float inv_area,
                                     float* out) {
  const float dy = __fsub_rn(by, ay), dx = __fsub_rn(bx, ax);
  out[0] = __fmul_rn(-dy, inv_area);
  out[1] = __fmul_rn(dx, inv_area);
  out[2] = __fmul_rn(__fsub_rn(__fmul_rn(dy, ax), __fmul_rn(dx, ay)), inv_area);
}

// The tiles t (0 <= t < n) that the tile kernel's inclusive test admits:
// 16 t <= hi and lo <= 16 t + 16, i.e. ceil(lo / 16) - 1 <= t <= floor(hi / 16).
// Dividing by 16 is exact, so the range is exactly the tiles that pass the
// float test. NaN bounds fail every comparison of that test: empty.
__device__ __forceinline__ short2 tile_range(float lo, float hi, int n) {
  const float a = fmaxf(ceilf(lo * 0.0625f) - 1.f, 0.f);
  const float b = fminf(floorf(hi * 0.0625f), (float)(n - 1));
  if (lo != lo || hi != hi || a > b) return make_short2(1, 0);
  return make_short2((short)a, (short)b);
}

template <typename I>
__global__ void __launch_bounds__(kSetupThreads)
raster_setup(const float4* __restrict__ clip, const I* __restrict__ tris, int v_count,
             int t_count, int height, int width, int cull, float* __restrict__ tri_out,
             short4* __restrict__ range_out) {
  const int t = blockIdx.x * kSetupThreads + threadIdx.x;
  if (t >= t_count) return;
  const long long i0 = tris[3 * (size_t)t], i1 = tris[3 * (size_t)t + 1],
                  i2 = tris[3 * (size_t)t + 2];
  // an index outside the vertex buffer makes the triangle invalid (the plain
  // version's gather would raise); it reads vertex 0 instead
  const bool in_range = i0 >= 0 && i0 < v_count && i1 >= 0 && i1 < v_count && i2 >= 0 &&
                        i2 < v_count;
  const float fw = (float)width, fh = (float)height;
  const Window v0 = window_coords(clip[in_range ? i0 : 0], fw, fh);
  const Window v1 = window_coords(clip[in_range ? i1 : 0], fw, fh);
  const Window v2 = window_coords(clip[in_range ? i2 : 0], fw, fh);
  const bool w_ok = v0.w > 1e-6f && v1.w > 1e-6f && v2.w > 1e-6f;
  const float area = __fsub_rn(__fmul_rn(__fsub_rn(v1.sx, v0.sx), __fsub_rn(v2.sy, v0.sy)),
                               __fmul_rn(__fsub_rn(v2.sx, v0.sx), __fsub_rn(v1.sy, v0.sy)));
  // GL front face = CCW in GL window coords -> negative area in y-down space
  const bool face_ok = cull ? area < -1e-12f : fabsf(area) > 1e-12f;
  const float inv_area = __fdiv_rn(1.f, fabsf(area) < 1e-12f ? 1.f : area);
  float r[kCols];
  edge(v1.sx, v1.sy, v2.sx, v2.sy, inv_area, r + 0);
  edge(v2.sx, v2.sy, v0.sx, v0.sy, inv_area, r + 3);
  edge(v0.sx, v0.sy, v1.sx, v1.sy, inv_area, r + 6);
  r[9] = v0.sz;
  r[10] = v1.sz;
  r[11] = v2.sz;
  r[12] = v0.iw;
  r[13] = v1.iw;
  r[14] = v2.iw;
  r[15] = min_nan(min_nan(v0.sx, v1.sx), v2.sx);
  r[16] = max_nan(max_nan(v0.sx, v1.sx), v2.sx);
  r[17] = min_nan(min_nan(v0.sy, v1.sy), v2.sy);
  r[18] = max_nan(max_nan(v0.sy, v1.sy), v2.sy);
  const bool valid = in_range && w_ok && face_ok;
  r[19] = valid ? 1.f : 0.f;
  float4* row = reinterpret_cast<float4*>(tri_out + (size_t)t * kCols);
#pragma unroll
  for (int k = 0; k < kCols / 4; ++k)
    row[k] = make_float4(r[4 * k], r[4 * k + 1], r[4 * k + 2], r[4 * k + 3]);
  const int tiles_x = (width + kTile - 1) / kTile, tiles_y = (height + kTile - 1) / kTile;
  const short2 rx = tile_range(r[15], r[16], tiles_x);
  const short2 ry = tile_range(r[17], r[18], tiles_y);
  const bool any = valid && rx.x <= rx.y && ry.x <= ry.y;  // one empty axis: no tile
  range_out[t] = any ? make_short4(rx.x, rx.y, ry.x, ry.y) : make_short4(1, 0, 1, 0);
}

__global__ void __launch_bounds__(kThreads)
raster_binned(const float* __restrict__ tri, const short4* __restrict__ ranges, int t_count,
              float* __restrict__ z_out, int* __restrict__ id_out, float* __restrict__ bary_out,
              int height, int width) {
  __shared__ int list[kChunk];
  __shared__ int offsets[kPer * kWarps + 1];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx = blockIdx.x, ty = blockIdx.y;
  const int x = tx * kTile + (threadIdx.x % kTile), y = ty * kTile + (threadIdx.x / kTile);
  const float px = (float)x + 0.5f, py = (float)y + 0.5f;
  const unsigned lanes_below = (1u << lane) - 1u;

  float zbuf = 1.f;
  int best = -1;
  float bb0 = 0.f, bb1 = 0.f, bb2 = 0.f;

  for (int base = 0; base < t_count; base += kChunk) {
    // cull: triangle base + j * kThreads + threadIdx.x, so (j, warp, lane)
    // order is index order
    bool hit[kPer];
    unsigned ballot[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int t = base + j * kThreads + threadIdx.x;
      bool h = false;
      if (t < t_count) {
        const short4 r = ranges[t];
        h = tx >= r.x && tx <= r.y && ty >= r.z && ty <= r.w;
      }
      hit[j] = h;
      ballot[j] = __ballot_sync(0xffffffffu, h);
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) offsets[j * kWarps + warp] = __popc(ballot[j]);
    }
    __syncthreads();
    if (warp == 0) {  // exclusive prefix sum of the 64 counts, two a lane
      const int a = offsets[2 * lane], b = offsets[2 * lane + 1];
      int incl = a + b;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += up;
      }
      const int excl = incl - a - b;
      offsets[2 * lane] = excl;
      offsets[2 * lane + 1] = excl + a;
      if (lane == 31) offsets[kPer * kWarps] = incl;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (hit[j])
        list[offsets[j * kWarps + warp] + __popc(ballot[j] & lanes_below)] =
            base + j * kThreads + threadIdx.x;
    const int n = offsets[kPer * kWarps];
    __syncthreads();

    for (int k = 0; k < n; ++k) {
      const int t = list[k];
      // columns 0-15 of the 80-byte row: edges, window z, 1/w (16-byte aligned)
      const float4* row = reinterpret_cast<const float4*>(tri + (size_t)t * kCols);
      const float4 c0 = __ldg(row), c1 = __ldg(row + 1), c2 = __ldg(row + 2),
                   c3 = __ldg(row + 3);
      const float b0 = __fadd_rn(__fadd_rn(__fmul_rn(c0.x, px), __fmul_rn(c0.y, py)), c0.z);
      const float b1 = __fadd_rn(__fadd_rn(__fmul_rn(c0.w, px), __fmul_rn(c1.x, py)), c1.y);
      const float b2 = __fadd_rn(__fadd_rn(__fmul_rn(c1.z, px), __fmul_rn(c1.w, py)), c2.x);
      if (!((b0 >= 0.f) && (b1 >= 0.f) && (b2 >= 0.f))) continue;
      // Renormalized barycentrics for z: in exact arithmetic b0 + b1 + b2 = 1,
      // but at 512 px the pre-normalized edge terms reach |C| ~ W*H/area and
      // cancel to O(1) in f32, so each b_i carries ~1e-4 absolute error.
      // Dividing by the sum leaves sum_i e_i (z_i - z): the z_i of one
      // triangle are close, so z keeps ~1e-7 instead of ~1e-3.
      const float bsum = __fadd_rn(__fadd_rn(b0, b1), b2);
      const float num = __fadd_rn(__fadd_rn(__fmul_rn(b0, c2.y), __fmul_rn(b1, c2.z)),
                                  __fmul_rn(b2, c2.w));
      float z = __fdiv_rn(num, bsum > 0.f ? bsum : 1.f);
      z = z < 0.f ? 0.f : (z > 1.f ? 1.f : z);  // keeps NaN, which fails z < zbuf
      if (z < zbuf) {
        const float pb0 = __fmul_rn(b0, c3.x), pb1 = __fmul_rn(b1, c3.y),
                    pb2 = __fmul_rn(b2, c3.z);
        float denom = __fadd_rn(__fadd_rn(pb0, pb1), pb2);
        if (fabsf(denom) < 1e-12f) denom = 1.f;
        zbuf = z;
        best = t;
        bb0 = __fdiv_rn(pb0, denom);
        bb1 = __fdiv_rn(pb1, denom);
        bb2 = __fdiv_rn(pb2, denom);
      }
    }
    __syncthreads();  // the list and the offsets are rewritten next chunk
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

// clip: contiguous (v_count, 4) f32, 16-byte aligned; tris: contiguous
// (t_count, 3) int32 (tris_i64 = 0) or int64; tri_out: (t_count, 20) f32 and
// range_out: (t_count, 4) int16, both 16-byte aligned. Returns a cudaError_t.
extern "C" int sr_raster_setup(const void* clip, int v_count, const void* tris, int tris_i64,
                               int t_count, int height, int width, int cull, void* tri_out,
                               void* range_out, void* stream) {
  if (t_count < 0 || v_count < 0 || height <= 0 || width <= 0 ||
      (width + kTile - 1) / kTile > 32767 || (height + kTile - 1) / kTile > 32767)
    return (int)cudaErrorInvalidValue;
  if (t_count == 0) return (int)cudaSuccess;
  const int blocks = (t_count + kSetupThreads - 1) / kSetupThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* c = static_cast<const float4*>(clip);
  float* out = static_cast<float*>(tri_out);
  short4* ranges = static_cast<short4*>(range_out);
  if (tris_i64)
    raster_setup<long long><<<blocks, kSetupThreads, 0, st>>>(
        c, static_cast<const long long*>(tris), v_count, t_count, height, width, cull, out,
        ranges);
  else
    raster_setup<int><<<blocks, kSetupThreads, 0, st>>>(c, static_cast<const int*>(tris),
                                                        v_count, t_count, height, width, cull,
                                                        out, ranges);
  return (int)cudaGetLastError();
}

// tri: (t_count, 20) f32 and ranges (t_count, 4) int16 from sr_raster_setup;
// z (H, W) f32, tri_id (H, W) i32 and bary (H, W, 3) f32 are written in full.
extern "C" int sr_raster_tiles(const void* tri, const void* ranges, int t_count, void* z,
                               void* tri_id, void* bary, int height, int width, void* stream) {
  if (t_count < 0 || height <= 0 || width <= 0 || (width + kTile - 1) / kTile > 32767 ||
      (height + kTile - 1) / kTile > 32767)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((width + kTile - 1) / kTile, (height + kTile - 1) / kTile);
  raster_binned<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tri), static_cast<const short4*>(ranges), t_count,
      static_cast<float*>(z), static_cast<int*>(tri_id), static_cast<float*>(bary), height,
      width);
  return (int)cudaGetLastError();
}
