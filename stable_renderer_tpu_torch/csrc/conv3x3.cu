// Fused 3x3 convolution for Hopper (sm_90a): implicit GEMM on wgmma.
//
// Replaces the TPU kernel stable_renderer_tpu/ops/conv_pallas.py
// (_conv3x3_kernel, launched by conv3x3_pallas). 3x3, stride 1, pad 1 over
// NHWC activations with HWIO weights:
//   out[m, o] = act( sum_{tap, c} A[m, (tap, c)] * W[tap, c, o] + bias[o] )
// with M = N*H*W output pixels, N = Cout, K = 9*Cin ordered (tap, c).
//
// What A is: the input pixel under the tap (zero outside the image), after
//   * the optional prologue x * pre_scale[n, c] + pre_shift[n, c] (+ SiLU) in
//     f32, applied to in-image pixels only, so the halo stays zero after it;
//   * float mode: rounded to bf16; int8 mode: round_half_even(v * (1/a_scale))
//     clipped to +-127, from the f32 value (the reciprocal once, in f32).
// The epilogue adds the bias in f32 (after acc * (a_scale * w_scale[o]) in
// int8 mode, int32 sums being exact) and the optional SiLU. Products and sums
// of the prologue and epilogue use the _rn intrinsics, so no multiply-add is
// contracted: the plain version rounds after each operation.
//
// What bounds it on the H100: at the frame's shapes, operations. A 3x3 conv
// does 18*Cin multiply-adds per output for each input byte it must read, far
// above the ~295 operations a byte where the tensor cores, not the memory, set
// the pace; only wgmma reaches their rate. The design:
//   1. prep_act (int8 mode, or the prologue): one elementwise pass writes A's
//      values, prologue and quantize applied, to scratch in the activation
//      layout (int8 channels padded to a multiple of 16 with zeros). Doing it
//      inside the GEMM would redo each input's SiLU and quantize 9 taps x
//      Cout/BN times (1.9-4x slower at the frame's shapes, PERF.md). In bf16
//      without the prologue the input is read as it is.
//   2. conv3x3_wgmma: a block owns TH x 16 output pixels of one image x BN
//      output channels. Each warp of the two consumer warpgroups owns 16
//      pixels, one tile row, in each of the warpgroup's MB 64-pixel blocks
//      (4 rows each): TH = 8 or 16. K runs in chunks of 128 bytes (64 bf16
//      or 128 int8 channels). Per chunk the (TH + 2) x 18 input patch, halo
//      included, lands in one of two patch slots, and then, tap by tap, B's
//      BN rows of that chunk land in a ring of 3-8 slots. One producer
//      thread loads both by TMA, on mbarriers: the patch through a 4-d map
//      over (C, W, H, N) whose box starts at (c, x0 - 1, y0 - 1, n), so the
//      zero halo is TMA's out-of-bounds fill; B through a 2-d map over the
//      K-major (Cout, 9 * cs) copy. Both boxes have 128-byte rows, written
//      with TMA's 128-byte swizzle: full L2 sectors and few requests a tile
//      (16-byte rows ran 2-3x slower at the frame's shapes, PERF.md), and
//      B's tile is wgmma's K-major SW128 layout as it lands. Each consumer
//      warp loads a tap's A fragments with ldmatrix at per-lane addresses
//      shifted by the tap (and unswizzled: chunk ^ pixel % 8, which also
//      keeps ldmatrix free of bank conflicts); that is the mma.sync m16n8k16
//      (bf16) or m16n8k32 (s8) A fragment and wgmma's A-in-registers layout.
//      The 9 taps reuse the one patch, so each input byte crosses from L2
//      once per block and N tile, not 9 times. Each warpgroup issues
//      wgmma.mma_async m64nBNk16 (bf16 -> f32) or m64nBNk32 (s8 -> s32), A
//      from registers and B from shared memory, 4 K steps x MB a tap, and
//      frees the tap's slot by one mbarrier arrival per warp: no block-wide
//      barrier in the K loop, and one warpgroup's products run while the
//      other loads its fragments. The producer warpgroup hands its registers
//      to the consumers (setmaxnreg), so a block takes a whole SM; the grid
//      is persistent (one block an SM walks the output tiles), and the
//      rings run on across tiles, so that the next tile's patch and weights
//      load during this tile's epilogue.
//      The tile shape (BN in {128, 160, 256}, MB), one of kConfigs, is
//      chosen per call by the wrapper's tile picker (ops/conv_kernel.py
//      conv_tiles) from the conv's shape: BN = 160 covers Cout = 320 and 640
//      without waste, TH = 16 halves B's traffic from L2 per output pixel,
//      and small grids take smaller blocks to fill the 132 SMs. The B ring
//      is as deep as a block's shared memory allows (ring_stages), which
//      the tile shape alone sets.
//      The epilogue (the dequantization, bias and SiLU per value, with each
//      channel's bias and scale loaded at the tile's start and parked in
//      shared memory) packs bf16 pairs by stmatrix into a 64-byte-swizzled
//      stage, and one thread stores the tile by TMA, which runs on while the
//      next tile computes; f32 output (the tests') is stored by each thread.
//      A first epilogue that transposed pairs by shuffles and stored from
//      every thread took ~16k clocks a 256 x 128 tile, more than the tile's
//      products (PERF.md). Images of any size: TMA zero-fills past the image
//      and the channels on the way in and clips the tile's store at the
//      edges on the way out.
// The weights must run K-contiguous (s8 wgmma takes K-major B only), so they
// come as (Cout, 3, 3, cs) rows: the wrapper makes that copy of the HWIO
// tensor once per weight tensor and keeps it with its tensor map
// (sr_conv3x3_weight_map).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

using namespace sr;

constexpr int kTW = 16;              // output tile width: one warp's 16 pixels of a row
constexpr int kPW = kTW + 2;         // the patch's width, halo included
constexpr int kSmemLimit = 232448;   // a block's shared memory on the H100

__device__ __forceinline__ float silu_f(float v) { return v / (1.0f + expf(-v)); }

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(a));
  const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(b));
  return lo | (hi << 16);
}

__device__ __forceinline__ uint32_t quant4(const float* v, float inv) {
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int q = __float2int_rn(__fmul_rn(v[i], inv));
    q = q > 127 ? 127 : (q < -127 ? -127 : q);
    r |= (uint32_t)(q & 0xff) << (8 * i);
  }
  return r;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// ---- 1. A's values: prologue, then quantize (int8) or round (bf16) ----------
// One thread per 8 channels of a pixel; act has channel stride cs >= cin and
// channels [cin, cs) written as zeros.
template <typename TIn, bool INT8>
__global__ void __launch_bounds__(256)
prep_act(const TIn* __restrict__ x, void* __restrict__ act, const float* __restrict__ pre_scale,
         const float* __restrict__ pre_shift, const float* __restrict__ a_scale, int pixels,
         int hw, int cin, int cs, int pre, int pre_silu) {
  const int groups = cs / 8;
  const int total = pixels * groups;  // < 2^31: the entry point checks
  float inv = 0.f;
  if constexpr (INT8) inv = 1.0f / *a_scale;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const int pix = i / groups;
    const int c = (i - pix * groups) * 8;
    float v[8];
    if (c < cin) {
      load8(x + (size_t)pix * cin + c, v);
      if (pre) {
        const int o = (pix / hw) * cin + c;
        float sc[8], sh[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        load8(pre_scale + o, sc);
        if (pre_shift) load8(pre_shift + o, sh);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float t = __fmul_rn(v[k], sc[k]);
          if (pre_shift) t = __fadd_rn(t, sh[k]);
          v[k] = t;
        }
        if (pre_silu) {
#pragma unroll
          for (int k = 0; k < 8; ++k) v[k] = silu_f(v[k]);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = 0.f;
    }
    if constexpr (INT8) {
      *reinterpret_cast<uint2*>(static_cast<int8_t*>(act) + (size_t)pix * cs + c) =
          make_uint2(quant4(v, inv), quant4(v + 4, inv));
    } else {
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(act) + (size_t)pix * cs + c) =
          make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                     pack_bf16(v[6], v[7]));
    }
  }
}

// ---- 2. the implicit GEMM on wgmma -------------------------------------------

constexpr int kKB = 128;  // bytes of K a chunk: one TMA box row, 128-byte swizzled

__host__ __device__ constexpr int patch_bytes(int th) {  // one K chunk of the patch
  return ((th + 2) * kPW * kKB + 1023) / 1024 * 1024;
}
// the bf16 output tile, staged for its TMA store: BN / 32 boxes of 32
// channels (64 bytes, swizzled) x 16 x TH pixels
__host__ __device__ constexpr int out_stage_bytes(int th, int bn) { return 32 * th * bn; }
constexpr int kPatchSlots = 2;  // the patch ring: one chunk in use, the next landing
// a block's dynamic shared memory: the 1024-byte alignment, the patch ring,
// the output stage, the B ring, the epilogue's per-channel bias and scale
// (2 x 256 f32) and the rings' mbarriers
__host__ __device__ constexpr int smem_bytes(int th, int bn, int stages) {
  return 1024 + kPatchSlots * patch_bytes(th) + out_stage_bytes(th, bn) + stages * bn * kKB +
         2048 + (2 * kPatchSlots + 2 * stages) * 8;
}
// the B ring's slots for a tile shape: as many as fit, up to 8
__host__ __device__ constexpr int ring_stages(int th, int bn) {
  int stages = 8;
  while (stages > 2 && smem_bytes(th, bn, stages) > kSmemLimit) --stages;
  return stages;
}

struct GemmArgs {
  const void* bias;  // (cout,) or null
  int bias_kind;     // 0 none, 1 f32, 2 bf16
  const float* a_scale;
  const float* w_scale;
  void* out;         // (N, H, W, cout)
  int out_f32;
  int n, h, w_img, cs, cout, act_silu;
};

template <bool INT8, int BN>
struct Mma;
template <int BN>
struct Mma<false, BN> {
  using Acc = float;
  __device__ static __forceinline__ void run(float* d, const uint32_t* a, uint64_t desc) {
    WgmmaRS<BN>::template run<0>(d, a, desc, 1);
  }
};
template <int BN>
struct Mma<true, BN> {
  using Acc = int;
  __device__ static __forceinline__ void run(int* d, const uint32_t* a, uint64_t desc) {
    WgmmaRS8<BN>::run(d, a, desc, 1);
  }
};

// NWG consumer warpgroups of MB 64-pixel blocks each, and one producer
// warpgroup (the last); TH = 4 NWG MB tile rows. Shared memory: the patch
// slots, the output stage, ring_stages(TH, BN) B slots of BN rows x 128 bytes,
// the epilogue's channel parameters, then the mbarriers.
template <bool INT8, int BN, int NWG, int MB>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
conv3x3_wgmma(const __grid_constant__ GemmArgs p, const __grid_constant__ CUtensorMap tma_act,
              const __grid_constant__ CUtensorMap tma_wt,
              const __grid_constant__ CUtensorMap tma_out) {
  using Acc = typename Mma<INT8, BN>::Acc;
  constexpr int TH = 4 * NWG * MB;
  constexpr int PATCH = patch_bytes(TH);
  constexpr int BTILE = BN * kKB;                          // one tap's B for one K chunk
  constexpr uint32_t PATCH_TX = (TH + 2) * kPW * kKB;      // bytes TMA writes a patch
  constexpr int KC = INT8 ? kKB : kKB / 2;                 // channels a chunk
  constexpr int NACC = BN / 2;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the slots to it
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  constexpr int R = ring_stages(TH, BN);
  constexpr int AS = kPatchSlots;
  uint8_t* ostage = smem + AS * PATCH;
  uint8_t* bring = ostage + out_stage_bytes(TH, BN);
  float* ebias = reinterpret_cast<float*>(bring + R * BTILE);  // 256 biases, then 256 scales
  uint64_t* a_full = reinterpret_cast<uint64_t*>(ebias + 512);
  uint64_t* a_empty = a_full + AS;
  uint64_t* b_full = a_empty + AS;
  uint64_t* b_empty = b_full + R;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles_x = (p.w_img + kTW - 1) / kTW, tiles_y = (p.h + TH - 1) / TH;
  const int n_tiles = (p.cout + BN - 1) / BN;
  const int total = tiles_x * tiles_y * p.n * n_tiles;
  const int nk = (p.cs + KC - 1) / KC;  // K chunks
  // output tile t: N tile t % n_tiles of pixel tile t / n_tiles (x fastest)
  auto tile_at = [&](int t, int& img, int& y0, int& x0, int& n0) {
    const int m = t / n_tiles;
    n0 = (t - m * n_tiles) * BN;
    x0 = (m % tiles_x) * kTW;
    y0 = ((m / tiles_x) % tiles_y) * TH;
    img = m / (tiles_x * tiles_y);
  };

  if (tid == 0) {
    for (int i = 0; i < AS; ++i) {
      mbar_init(a_full + i, 1);
      mbar_init(a_empty + i, 4 * NWG);  // one arrival per consumer warp
    }
    for (int i = 0; i < R; ++i) {
      mbar_init(b_full + i, 1);
      mbar_init(b_empty + i, 4 * NWG);
    }
  }
  __syncthreads();

  // Persistent: block b takes tiles b, b + gridDim.x, ...; the rings' counts
  // run on across tiles, so the next tile's loads overlap this one's epilogue.
  if (warp >= 4 * NWG) {  // the producer warpgroup: one thread issues every load
    if constexpr (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 128 * NWG) {
      int i = 0, j = 0;  // patches and B tiles issued
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        int img, y0, x0, n0;
        tile_at(t, img, y0, x0, n0);
        for (int k = 0; k < nk; ++k, ++i) {
          const int as = i % AS, c = k * KC;
          if (i >= AS) mbar_wait(a_empty + as, (i / AS - 1) & 1);  // patch i - AS is done with
          mbar_expect_tx(a_full + as, PATCH_TX);
          tma_load(smem + as * PATCH, &tma_act, c, x0 - 1, y0 - 1, img, a_full + as);
          for (int tap = 0; tap < 9; ++tap, ++j) {
            const int slot = j % R;
            if (j >= R) mbar_wait(b_empty + slot, (j / R - 1) & 1);  // tile j - R is done with
            mbar_expect_tx(b_full + slot, BTILE);
            tma_load(bring + slot * BTILE, &tma_wt, tap * p.cs + c, n0, b_full + slot);
          }
        }
      }
    }
    return;
  }

  if constexpr (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp >> 2, w = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  float a_s = 0.f;
  if constexpr (INT8) a_s = *p.a_scale;
  Acc acc[MB][NACC];
  uint32_t a[MB][4][4];  // A fragments of one tap: 64-pixel block, K step of 32 bytes
  int i = 0, j = 0;      // patches and B tiles consumed
#pragma unroll 1
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    int img, y0, x0, n0;
    tile_at(t, img, y0, x0, n0);
    // this thread's channel n0 + tid of the epilogue's bias and scale: loaded
    // now, parked in shared memory at the epilogue, so the loads' latency
    // passes under the products
    float my_bias = 0.f, my_scale = 0.f;
    if (tid < BN && n0 + tid < p.cout) {
      if (p.bias_kind == 1)
        my_bias = static_cast<const float*>(p.bias)[n0 + tid];
      else if (p.bias_kind == 2)
        my_bias = __bfloat162float(static_cast<const __nv_bfloat16*>(p.bias)[n0 + tid]);
      if constexpr (INT8) my_scale = __fmul_rn(a_s, p.w_scale[n0 + tid]);
    }
#pragma unroll
    for (int b = 0; b < MB; ++b)
#pragma unroll
      for (int e = 0; e < NACC; ++e) acc[b][e] = 0;
#pragma unroll 1
    for (int k = 0; k < nk; ++k, ++i) {
      const int as = i % AS;
      mbar_wait(a_full + as, (i / AS) & 1);
      const uint8_t* patch = smem + as * PATCH;
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap, ++j) {
        const int slot = j % R;
        const int dy = tap / 3, dx = tap - 3 * dy;
        mbar_wait(b_full + slot, (j / R) & 1);
#pragma unroll
        for (int b = 0; b < MB; ++b) {
          // this lane's A row: pixel lane % 16 of its warp's tile row, shifted
          // by the tap; 16-byte chunk 2 kk + lane / 16 of its 128-byte row,
          // where TMA's swizzle put it (chunk ^ pixel % 8)
          const int px = (4 * (wg * MB + b) + w + dy) * kPW + (lane & 15) + dx;
          const uint8_t* row = patch + px * kKB;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            ldmatrix_x4(a[b][kk], row + (((2 * kk + (lane >> 4)) ^ (px & 7)) << 4));
        }
        const uint8_t* bt = bring + slot * BTILE;
#pragma unroll
        for (int b = 0; b < MB; ++b) fence_regs<NACC>(acc[b]);
        wgmma_fence();
#pragma unroll
        for (int b = 0; b < MB; ++b)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            Mma<INT8, BN>::run(acc[b], a[b][kk], smem_desc_sw128(bt + 32 * kk));
        wgmma_commit();
#pragma unroll
        for (int b = 0; b < MB; ++b) fence_regs<NACC>(acc[b]);
        wgmma_wait<0>();
#pragma unroll
        for (int b = 0; b < MB; ++b) {
          fence_regs<NACC>(acc[b]);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) fence_regs<4>(a[b][kk]);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(b_empty + slot);
      }
      if (lane == 0) mbar_arrive(a_empty + as);
    }

    // epilogue: thread (g, t4) of warp w holds columns 8c + 2 t4, +1 of pixel
    // columns g and g + 8 of its tile row, in each 64-row block: the mma C
    // layout. bf16: packed pairs go by stmatrix into the output stage (box
    // c / 4, 16-byte chunk c % 4 of the pixel's 64-byte row, 64-byte
    // swizzled), and one thread stores the tile by TMA, which clips the
    // ragged edges and runs on while the next tile computes. f32 (the tests'
    // wider output): each thread stores its pairs.
    const int H = p.h, W = p.w_img, Cout = p.cout;
    auto epi = [&](Acc r, float bias, float scale) {
      float u;
      if constexpr (INT8)
        u = __fmul_rn(__int2float_rn(r), scale);
      else
        u = r;
      return p.bias_kind ? __fadd_rn(u, bias) : u;
    };
    // the previous tile's epilogue has read its values (it ended at a
    // barrier of the consumers), and the barrier below publishes these
    if (tid < BN) {
      ebias[tid] = my_bias;
      ebias[256 + tid] = my_scale;
    }
    auto col_params = [&](int col, float* bias, float* scale) {  // columns col, col + 1
      const float2 bb = *reinterpret_cast<const float2*>(ebias + col - n0);
      const float2 ss = *reinterpret_cast<const float2*>(ebias + 256 + col - n0);
      bias[0] = bb.x;
      bias[1] = bb.y;
      scale[0] = ss.x;
      scale[1] = ss.y;
    };
    if (!p.out_f32) {
      if (tid == 0) bulk_wait_read();  // the last tile's store has read the stage
      named_sync(1, 128 * NWG);
#pragma unroll
      for (int c = 0; c < BN / 8; c += 2) {
        float bias[2][2], scale[2][2];
        col_params(n0 + c * 8 + 2 * t4, bias[0], scale[0]);
        col_params(n0 + (c + 1) * 8 + 2 * t4, bias[1], scale[1]);
#pragma unroll
        for (int b = 0; b < MB; ++b) {
          uint32_t r[4];  // matrices (c, pixels 0-7), (c, 8-15), (c + 1, 0-7), (c + 1, 8-15)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int e = 4 * (c + cc) + 2 * hh;
              float v0 = epi(acc[b][e], bias[cc][0], scale[cc][0]);
              float v1 = epi(acc[b][e + 1], bias[cc][1], scale[cc][1]);
              if (p.act_silu) {
                v0 = silu_f(v0);
                v1 = silu_f(v1);
              }
              r[2 * cc + hh] = pack_bf16(v0, v1);
            }
          const int mi = lane >> 3, cb = c + (mi >> 1);
          const int px = (4 * (wg * MB + b) + w) * kTW + (lane & 7) + 8 * (mi & 1);
          stmatrix_x4(ostage + (cb >> 2) * (TH * kTW * 64) + px * 64 +
                          (((cb & 3) ^ ((px >> 1) & 3)) << 4),
                      r);
        }
      }
      fence_proxy_async();  // the stage's generic-proxy writes, visible to TMA
      named_sync(1, 128 * NWG);
      if (tid == 0) {
        for (int box = 0; box < BN / 32 && n0 + 32 * box < Cout; ++box)
          tma_store(&tma_out, ostage + box * (TH * kTW * 64), n0 + 32 * box, x0, y0, img);
        bulk_commit();
      }
    } else {
      named_sync(1, 128 * NWG);
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) {
        const int col = n0 + c * 8 + 2 * t4;
        float bias[2], scale[2];
        col_params(col, bias, scale);
#pragma unroll
        for (int b = 0; b < MB; ++b)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int y = y0 + 4 * (wg * MB + b) + w, x = x0 + g + hh * 8;
            if (y >= H || x >= W || col >= Cout) continue;
            float v0 = epi(acc[b][4 * c + 2 * hh], bias[0], scale[0]);
            float v1 = epi(acc[b][4 * c + 2 * hh + 1], bias[1], scale[1]);
            if (p.act_silu) {
              v0 = silu_f(v0);
              v1 = silu_f(v1);
            }
            *reinterpret_cast<float2*>(static_cast<float*>(p.out) +
                                       (((size_t)img * H + y) * W + x) * Cout + col) =
                make_float2(v0, v1);
          }
      }
      named_sync(1, 128 * NWG);  // every thread has read this tile's bias and scale
    }
  }
  if (tid == 0) bulk_wait();  // the stores are done before the block's memory goes
}

int grid_1d(size_t work) {
  const size_t blocks = (work + 255) / 256;
  return (int)(blocks < 8192 ? blocks : 8192);
}

// The compiled tile shapes: output channels a block, consumer warpgroups,
// 64-pixel blocks a warpgroup, and the block's dynamic shared memory in bytes
// (launch_gemm asserts it). ops/conv_kernel.py TILE_CONFIGS is this table.
struct TileConfig {
  int bn, nwg, mb, smem;
};
constexpr TileConfig kConfigs[] = {
    {128, 2, 1, 214176}, {160, 2, 1, 214144}, {256, 2, 1, 214096},
    {128, 2, 2, 218208}, {160, 2, 2, 230480},
};
constexpr int kNumConfigs = sizeof(kConfigs) / sizeof(kConfigs[0]);

template <bool INT8, int CFG>
int launch_gemm(const GemmArgs& a, const CUtensorMap& ta, const CUtensorMap& tw,
                const CUtensorMap& to, cudaStream_t stream) {
  constexpr TileConfig c = kConfigs[CFG];
  constexpr int TH = 4 * c.nwg * c.mb;
  static_assert(c.smem == smem_bytes(TH, c.bn, ring_stages(TH, c.bn)) && c.smem <= kSmemLimit,
                "kConfigs: smem must be the block's layout, within the card's limit");
  auto kernel = conv3x3_wgmma<INT8, c.bn, c.nwg, c.mb>;
  const int bytes = c.smem;
  // above 48 KB a block's shared memory must be asked for: once per kernel
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (attr != cudaSuccess) return (int)attr;
  const long long tiles = (long long)((a.w_img + kTW - 1) / kTW) * ((a.h + TH - 1) / TH) * a.n *
                          ((a.cout + c.bn - 1) / c.bn);
  if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  // persistent: one block an SM (their registers allow no more), or fewer
  const int blocks = tiles < sm_count() ? (int)tiles : sm_count();
  kernel<<<blocks, 128 * (c.nwg + 1), bytes, stream>>>(a, ta, tw, to);
  return (int)cudaGetLastError();
}

template <bool INT8>
int run_gemm(int config, const GemmArgs& a, const CUtensorMap& ta, const CUtensorMap& tw,
             const CUtensorMap& to, cudaStream_t s) {
  switch (config) {
    case 0: return launch_gemm<INT8, 0>(a, ta, tw, to, s);
    case 1: return launch_gemm<INT8, 1>(a, ta, tw, to, s);
    case 2: return launch_gemm<INT8, 2>(a, ta, tw, to, s);
    case 3: return launch_gemm<INT8, 3>(a, ta, tw, to, s);
    case 4: return launch_gemm<INT8, 4>(a, ta, tw, to, s);
  }
  return (int)cudaErrorInvalidValue;
}

int find_config(int bn, int nwg, int mb) {
  for (int i = 0; i < kNumConfigs; ++i)
    if (kConfigs[i].bn == bn && kConfigs[i].nwg == nwg && kConfigs[i].mb == mb) return i;
  return -1;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// The tensor map of a K-major weight copy wt (cout, 3, 3, cs), bf16 or int8,
// for blocks of bn output channels: 128 bytes written to map_out (host
// memory), which sr_conv3x3 takes. The wrapper encodes it once per weight
// copy and tile width.
extern "C" int sr_conv3x3_weight_map(void* map_out, const void* wt, int cout, int cs, int int8_mode,
                                     int bn) {
  const sr::TmapEncode enc = sr::tmap_encode();
  const int eb = int8_mode ? 1 : 2;
  if (!enc) return (int)cudaErrorNotSupported;
  if (!map_out || !wt || !aligned16(wt) || cout <= 0 || cs <= 0 || (9 * cs * eb) % 16 ||
      bn <= 0 || bn > 256)
    return (int)cudaErrorInvalidValue;
  CUtensorMap m;
  const cuuint64_t dims[2] = {(cuuint64_t)9 * cs, (cuuint64_t)cout};
  const cuuint64_t strides[1] = {(cuuint64_t)9 * cs * eb};
  const cuuint32_t box[2] = {(cuuint32_t)(kKB / eb), (cuuint32_t)bn}, elem[2] = {1, 1};
  if (enc(&m, int8_mode ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
          const_cast<void*>(wt), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  memcpy(map_out, &m, sizeof m);
  return 0;
}

// x (n, h, w, cin) bf16 (f32 too in int8 mode); wt_map: sr_conv3x3_weight_map
// of the (cout, 3, 3, cs) bf16 or int8 weights, with channels [cin, cs) zero,
// for bn output channels a block. cs is cin in float mode and cin rounded up
// to a multiple of 16 in int8 mode. Scratch from the caller: act_buf
// (n*h*w*cs elements of the operand type) when int8_mode or pre, else unused.
// bn, nwg, mb: a tile shape of kConfigs (the wrapper's tile picker chooses
// it).
extern "C" int sr_conv3x3(const void* x, const void* wt_map, const void* bias, int bias_kind,
                          const void* pre_scale, const void* pre_shift, const void* a_scale,
                          const void* w_scale, void* out, void* act_buf, int n, int h,
                          int w_img, int cin, int cout, int cs, int int8_mode, int x_f32,
                          int out_f32, int act_silu, int pre, int pre_silu, int bn, int nwg,
                          int mb, void* stream) {
  const int config = find_config(bn, nwg, mb);
  if (n <= 0 || h <= 0 || w_img <= 0 || cin <= 0 || cout <= 0 || cin % 8 || cout % 8 ||
      (!int8_mode && (x_f32 || cs != cin)) || (int8_mode && (cs % 16 || cs < cin)) ||
      (int8_mode && (!a_scale || !w_scale)) || (pre && !pre_scale) ||
      ((int8_mode || pre) && !act_buf) || !wt_map || config < 0)
    return (int)cudaErrorInvalidValue;
  const sr::TmapEncode enc = sr::tmap_encode();
  if (!enc) return (int)cudaErrorNotSupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pixels = n * h * w_img;
  const float* ps = static_cast<const float*>(pre_scale);
  const float* pb = static_cast<const float*>(pre_shift);
  const float* as = static_cast<const float*>(a_scale);
  const void* act = x;
  if (int8_mode || pre) {
    if ((long long)n * h * w_img * (cs / 8) > INT32_MAX || (long long)n * cin > INT32_MAX)
      return (int)cudaErrorInvalidValue;
    const int blocks = grid_1d((size_t)pixels * (cs / 8));
    if (int8_mode && x_f32)
      prep_act<float, true><<<blocks, 256, 0, s>>>(static_cast<const float*>(x), act_buf, ps, pb,
                                                   as, pixels, h * w_img, cin, cs, pre, pre_silu);
    else if (int8_mode)
      prep_act<__nv_bfloat16, true><<<blocks, 256, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), act_buf, ps, pb, as, pixels, h * w_img, cin, cs,
          pre, pre_silu);
    else
      prep_act<__nv_bfloat16, false><<<blocks, 256, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), act_buf, ps, pb, as, pixels, h * w_img, cin, cs,
          pre, pre_silu);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    act = act_buf;
  }
  if (!aligned16(act)) return (int)cudaErrorInvalidValue;
  // the activation (or the prep pass's scratch) as (C, W, H, N); a box is one
  // 16-byte chunk of channels x the (TH + 2) x 18 patch of one image
  const int eb = int8_mode ? 1 : 2, th = 4 * nwg * mb;
  CUtensorMap ta, tw;
  const cuuint64_t dims[4] = {(cuuint64_t)cs, (cuuint64_t)w_img, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)cs * eb, (cuuint64_t)w_img * cs * eb,
                                 (cuuint64_t)h * w_img * cs * eb};
  const cuuint32_t box[4] = {(cuuint32_t)(kKB / eb), (cuuint32_t)kPW, (cuuint32_t)(th + 2), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  if (enc(&ta, int8_mode ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
          const_cast<void*>(act), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  memcpy(&tw, wt_map, sizeof tw);
  // the bf16 output as (Cout, W, H, N); a box is 32 channels x 16 x th pixels,
  // 64-byte swizzled as the kernel's output stage holds it (f32 output does
  // not use it: the map is left empty)
  CUtensorMap to{};
  if (!out_f32) {
    const cuuint64_t odims[4] = {(cuuint64_t)cout, (cuuint64_t)w_img, (cuuint64_t)h,
                                 (cuuint64_t)n};
    const cuuint64_t ostrides[3] = {(cuuint64_t)cout * 2, (cuuint64_t)w_img * cout * 2,
                                    (cuuint64_t)h * w_img * cout * 2};
    const cuuint32_t obox[4] = {32, (cuuint32_t)kTW, (cuuint32_t)th, 1};
    if (!aligned16(out) ||
        enc(&to, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, out, odims, ostrides, obox, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  const GemmArgs a{bias, bias_kind, as, static_cast<const float*>(w_scale), out, out_f32,
                   n, h, w_img, cs, cout, act_silu};
  return int8_mode ? run_gemm<true>(config, a, ta, tw, to, s)
                   : run_gemm<false>(config, a, ta, tw, to, s);
}
