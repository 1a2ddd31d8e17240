// Fused 3x3 convolution for Hopper (sm_90a): implicit GEMM on the tensor cores.
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
// the pace. The design spends device memory to keep the GEMM loop pure:
//   1. prep_act (int8 mode, or the prologue): one elementwise pass writes A's
//      values, prologue and quantize applied, to scratch in the activation
//      layout (int8 channels padded to a multiple of 16 with zeros). The TPU
//      kernel applies them inside its GEMM; here that redoes each input's
//      SiLU and quantize 9 taps x Cout/64 times: a first version that did so,
//      staging through registers, ran 1.9-4x slower at the frame's shapes on
//      an H100 80GB HBM3 at 700 W (PERF.md). In bf16 without the prologue the
//      input is read as it is.
//   2. conv3x3_igemm: a block owns an 8 x 16 tile of output pixels of one
//      image (M = 128) x 64 output channels, 4 warps of 2 tile rows x 64
//      channels. A stage is 32 bytes of K (16 bf16 or 32 int8 channels): the
//      tile's 10 x 18 input patch, halo included, and B's rows for all 9
//      taps. The 9 taps read the one patch through per-lane ldmatrix row
//      addresses shifted by (dy, dx), so each input byte crosses from L2 once
//      per 64 output channels instead of 9 times. Tiles move by cp.async
//      (16 bytes, zero-filled outside the image and past the channels) into a
//      double buffer; ldmatrix feeds mma.sync m16n8k16 bf16 -> f32 or
//      m16n8k32 s8 -> s32. Both modes put the same bytes in the same fragment
//      slots (4-byte words at byte 4*(lane%4) and 16 + 4*(lane%4) of a
//      32-byte K step), so one layout serves both: rows of 32 bytes padded to
//      48, which keeps ldmatrix conflict-free. Shared memory 2 x (180 + 576)
//      rows x 48 B = 71 KB, three blocks an SM. Images of any size: tiles at
//      the right and bottom edges are masked.
// B's K must run contiguous (the card has no transposing ldmatrix for 8-bit
// data), so the weights come as (Cout, 3, 3, cs) rows: the wrapper makes that
// copy of the HWIO tensor once per weight tensor and keeps it.
// wgmma and TMA are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTH = 8, kTW = 16;             // output tile: 8 rows x 16 columns of one image
constexpr int kPH = kTH + 2, kPW = kTW + 2;  // its input patch, with the 1-pixel halo
constexpr int kPatch = kPH * kPW;            // 180 pixels
constexpr int kBN = 64;                      // output channels per block
constexpr int kSB = 32;                      // bytes of K per stage (per tap)
constexpr int kRow = kSB + 16;               // padded shared-memory row, bytes
constexpr int kThreads = 128;                // 4 warps, each 2 tile rows x 64 channels
constexpr int kStages = 2;                   // cp.async double buffer
constexpr int kAStage = kPatch * kRow;       // the patch
constexpr int kBStage = 9 * kBN * kRow;      // B rows of all 9 taps
constexpr int kStageBytes = kAStage + kBStage;
constexpr int kSmem = kStages * kStageBytes;  // 72,576 bytes: 3 blocks an SM

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
  const size_t total = (size_t)pixels * groups;
  float inv = 0.f;
  if constexpr (INT8) inv = 1.0f / *a_scale;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int pix = (int)(i / groups);
    const int c = (int)(i - (size_t)pix * groups) * 8;
    float v[8];
    if (c < cin) {
      load8(x + (size_t)pix * cin + c, v);
      if (pre) {
        const size_t o = (size_t)(pix / hw) * cin + c;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float t = __fmul_rn(v[k], pre_scale[o + k]);
          if (pre_shift) t = __fadd_rn(t, pre_shift[o + k]);
          v[k] = pre_silu ? silu_f(t) : t;
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

// ---- 2. the implicit GEMM ---------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(int* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

struct GemmArgs {
  const void* act;   // (N, H, W, cs) bf16 or int8
  const void* wt;    // (cout, 9, cs), same type
  const void* bias;  // (cout,) or null
  int bias_kind;     // 0 none, 1 f32, 2 bf16
  const float* a_scale;
  const float* w_scale;
  void* out;         // (N, H, W, cout)
  int n, h, w_img, cs, cout, act_silu;
};

template <bool INT8, typename TOut>
__global__ void __launch_bounds__(kThreads, 3)
conv3x3_igemm(const GemmArgs p) {
  using Acc = typename std::conditional<INT8, int, float>::type;
  constexpr int EB = INT8 ? 1 : 2;  // bytes per operand element
  constexpr int CC = 16 / EB;       // channels per 16-byte chunk

  extern __shared__ __align__(128) uint8_t smem[];
  const uint8_t* __restrict__ act = static_cast<const uint8_t*>(p.act);
  const uint8_t* __restrict__ wt = static_cast<const uint8_t*>(p.wt);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = p.h, W = p.w_img, cs = p.cs, Cout = p.cout;
  const int tiles_x = (W + kTW - 1) / kTW, tiles_y = (H + kTH - 1) / kTH;
  const int tx = blockIdx.x % tiles_x;
  const int ty = (blockIdx.x / tiles_x) % tiles_y;
  const int img = blockIdx.x / (tiles_x * tiles_y);
  const int y0 = ty * kTH, x0 = tx * kTW;
  const size_t img_base = (size_t)img * H * W;  // first pixel of this image
  const int n0 = blockIdx.y * kBN;
  const size_t krow = (size_t)9 * cs;  // elements in one output channel's K row

  Acc acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][k][e] = 0;

  const int nstages = (cs * EB + kSB - 1) / kSB;

  // stage s: channels [s * kSB / EB, ...) of the patch, and of all 9 taps of B
  auto issue = [&](int s, int buf) {
    uint8_t* As = smem + buf * kStageBytes;
    uint8_t* Bs = As + kAStage;
    const int c0 = s * (kSB / EB);
    for (int i = tid; i < kPatch * 2; i += kThreads) {
      const int pr = i >> 1, ch = i & 1;
      const int iy = y0 - 1 + pr / kPW, ix = x0 - 1 + pr % kPW;
      const int c = c0 + ch * CC;
      const bool ok = (unsigned)iy < (unsigned)H && (unsigned)ix < (unsigned)W && c < cs;
      const uint8_t* src = ok ? act + ((img_base + (size_t)iy * W + ix) * cs + c) * EB : act;
      cp_async16(As + pr * kRow + ch * 16, src, ok);
    }
#pragma unroll
    for (int i = tid; i < 9 * kBN * 2; i += kThreads) {
      const int ch = i & 1, row = i >> 1;  // row = tap * kBN + output channel
      const int tap = row / kBN;
      const int n = n0 + row - tap * kBN, c = c0 + ch * CC;
      const bool ok = n < Cout && c < cs;
      const uint8_t* src = ok ? wt + ((size_t)n * krow + (size_t)tap * cs + c) * EB : wt;
      cp_async16(Bs + row * kRow + ch * 16, src, ok);
    }
  };

  auto compute = [&](int buf) {
    const uint8_t* As = smem + buf * kStageBytes;
    const uint8_t* Bs = As + kAStage;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - 3 * (tap / 3);  // offsets into the haloed patch
      uint32_t a[2][4], b[8][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        // this lane's A row: output pixel (2 * warp + mt, lane % 16) of the tile
        const int pr = (2 * warp + mt + dy) * kPW + (lane & 15) + dx;
        ldmatrix_x4(a[mt], As + pr * kRow + (lane >> 4) * 16);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int mat = lane >> 3;
        const int row = tap * kBN + (2 * np + (mat >> 1)) * 8 + (lane & 7);
        uint32_t r[4];
        ldmatrix_x4(r, Bs + row * kRow + (mat & 1) * 16);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mma(acc[mt][nt], a[mt], b[nt]);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nstages) issue(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < nstages; ++s) {
    cp_async_wait<kStages - 2>();  // stage s has landed (for this thread) ...
    __syncthreads();               // ... for every thread; stage s - 1 is consumed
    const int next = s + kStages - 1;
    if (next < nstages) issue(next, next % kStages);
    cp_async_commit();
    compute(s % kStages);
  }

  // epilogue
  float a_s = 0.f;
  if constexpr (INT8) a_s = *p.a_scale;
  const int g = lane >> 2, t = lane & 3;
  TOut* __restrict__ out = static_cast<TOut*>(p.out);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = n0 + nt * 8 + t * 2;
    if (col >= Cout) continue;
    float bias0 = 0.f, bias1 = 0.f;
    if (p.bias_kind == 1) {
      bias0 = static_cast<const float*>(p.bias)[col];
      bias1 = static_cast<const float*>(p.bias)[col + 1];
    } else if (p.bias_kind == 2) {
      bias0 = __bfloat162float(static_cast<const __nv_bfloat16*>(p.bias)[col]);
      bias1 = __bfloat162float(static_cast<const __nv_bfloat16*>(p.bias)[col + 1]);
    }
    float s0 = 0.f, s1 = 0.f;
    if constexpr (INT8) {
      s0 = __fmul_rn(a_s, p.w_scale[col]);
      s1 = __fmul_rn(a_s, p.w_scale[col + 1]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int y = y0 + 2 * warp + mt, x = x0 + g + hh * 8;
        if (y >= H || x >= W) continue;
        float v0, v1;
        if constexpr (INT8) {
          v0 = __fmul_rn(__int2float_rn(acc[mt][nt][2 * hh]), s0);
          v1 = __fmul_rn(__int2float_rn(acc[mt][nt][2 * hh + 1]), s1);
        } else {
          v0 = acc[mt][nt][2 * hh];
          v1 = acc[mt][nt][2 * hh + 1];
        }
        if (p.bias_kind) {
          v0 = __fadd_rn(v0, bias0);
          v1 = __fadd_rn(v1, bias1);
        }
        if (p.act_silu) {
          v0 = silu_f(v0);
          v1 = silu_f(v1);
        }
        store2(out + (img_base + (size_t)y * W + x) * Cout + col, v0, v1);
      }
  }
}

int grid_1d(size_t work) {
  const size_t blocks = (work + 255) / 256;
  return (int)(blocks < 8192 ? blocks : 8192);
}

template <bool INT8, typename TOut>
int launch_gemm(const GemmArgs& a, cudaStream_t stream) {
  // above 48 KB a block's shared memory must be asked for (idempotent)
  const cudaError_t e = cudaFuncSetAttribute(
      conv3x3_igemm<INT8, TOut>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((a.w_img + kTW - 1) / kTW) * ((a.h + kTH - 1) / kTH) * a.n;
  const dim3 grid(tiles, (a.cout + kBN - 1) / kBN);
  conv3x3_igemm<INT8, TOut><<<grid, kThreads, kSmem, stream>>>(a);
  return 0;
}

}  // namespace

// x (n, h, w, cin) bf16 (f32 too in int8 mode); wt (cout, 3, 3, cs) bf16 or
// int8, the HWIO weights with K contiguous and channels [cin, cs) zero. cs is
// cin in float mode and cin rounded up to a multiple of 16 in int8 mode.
// Scratch from the caller: act_buf (n*h*w*cs elements of the operand type)
// when int8_mode or pre, else unused.
extern "C" int sr_conv3x3(const void* x, const void* wt, const void* bias, int bias_kind,
                          const void* pre_scale, const void* pre_shift, const void* a_scale,
                          const void* w_scale, void* out, void* act_buf, int n, int h,
                          int w_img, int cin, int cout, int cs, int int8_mode, int x_f32,
                          int out_f32, int act_silu, int pre, int pre_silu, void* stream) {
  if (n <= 0 || h <= 0 || w_img <= 0 || cin <= 0 || cout <= 0 || cin % 8 || cout % 8 ||
      (!int8_mode && (x_f32 || cs != cin)) || (int8_mode && (cs % 16 || cs < cin)) ||
      (int8_mode && (!a_scale || !w_scale)) || (pre && !pre_scale) ||
      ((int8_mode || pre) && !act_buf) || !wt)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pixels = n * h * w_img;
  const float* ps = static_cast<const float*>(pre_scale);
  const float* pb = static_cast<const float*>(pre_shift);
  const float* as = static_cast<const float*>(a_scale);
  const void* act = x;
  if (int8_mode || pre) {
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
    act = act_buf;
  }
  const GemmArgs a{act, wt, bias, bias_kind, as, static_cast<const float*>(w_scale),
                   out, n, h, w_img, cs, cout, act_silu};
  int rc;
  if (int8_mode)
    rc = out_f32 ? launch_gemm<true, float>(a, s) : launch_gemm<true, __nv_bfloat16>(a, s);
  else
    rc = out_f32 ? launch_gemm<false, float>(a, s) : launch_gemm<false, __nv_bfloat16>(a, s);
  return rc ? rc : (int)cudaGetLastError();
}
