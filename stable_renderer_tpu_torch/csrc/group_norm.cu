// Fused GroupNorm (+ SiLU) for Hopper (sm_90a).
//
// Replaces the TPU kernel stable_renderer_tpu/ops/group_norm_pallas.py
// (_gn_kernel, launched by group_norm_pallas). Over x (N, S, C), groups of
// C/G adjacent channels:
//   mean_g, var_g = f32 statistics of the group over S x C/G values
//   scale = rsqrt(max(E[x^2] - mean^2, 0) + eps) * w,  shift = b - mean * scale
//   y = x * scale + shift (f32), then SiLU when asked, cast to x's type.
//
// The TPU kernel holds one (S, C) slab per program; a Hopper grid of N = 2
// programs would fill two of 132 SMs. The work is split instead, with no
// atomics, so the result does not depend on the order blocks run in:
//   1. gn_partial: one block per (S-chunk, n) writes per-channel f32 sums of
//      x and x^2 over its chunk of rows;
//   2. gn_finalize: one block per (group, n) reduces the chunks' partials of
//      its channels in a fixed order (a strided loop, then a shared-memory
//      tree) and writes the per-(n, c) scale and shift;
//   3. gn_apply: normalizes 8 channels a thread (16-byte loads and stores),
//      applies the SiLU and writes in x's type.
// What bounds it on the H100: bytes. The statistics read x once and the
// normalize reads it again and writes y (6 bytes an element for bf16); there
// are a few operations an element. The partials (N x chunks x C x 8 bytes)
// are small beside x. The f32 products and sums of the normalize use the _rn
// intrinsics, so no multiply-add is contracted, as in the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_partial(const T* __restrict__ x, float* __restrict__ part, int s, int c, int rows) {
  const int n = blockIdx.y, chunk = blockIdx.x;
  const int s0 = chunk * rows;
  const int s1 = min(s, s0 + rows);
  const T* xn = x + (size_t)n * s * c;
  float* out = part + ((size_t)n * gridDim.x + chunk) * 2 * c;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float a = 0.f, b = 0.f;
#pragma unroll 4
    for (int r = s0; r < s1; ++r) {
      const float v = to_f32(xn[(size_t)r * c + ch]);
      a = __fadd_rn(a, v);
      b = __fadd_rn(b, __fmul_rn(v, v));
    }
    out[ch] = a;
    out[c + ch] = b;
  }
}

__global__ void __launch_bounds__(kThreads)
gn_finalize(const float* __restrict__ part, int chunks, int s, int c, int groups,
            const void* __restrict__ weight, const void* __restrict__ bias, int wb_bf16, float eps,
            float* __restrict__ scale, float* __restrict__ shift) {
  __shared__ float r1[kThreads], r2[kThreads];
  __shared__ float stats[2];
  const int g = blockIdx.x, n = blockIdx.y;
  const int cpg = c / groups;
  const int elems = chunks * cpg;
  float a = 0.f, b = 0.f;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int chunk = e / cpg;
    const int ch = g * cpg + (e - chunk * cpg);
    const float* p = part + ((size_t)n * chunks + chunk) * 2 * c;
    a += p[ch];
    b += p[c + ch];
  }
  r1[threadIdx.x] = a;
  r2[threadIdx.x] = b;
  __syncthreads();
  for (int k = kThreads / 2; k > 0; k >>= 1) {
    if (threadIdx.x < k) {
      r1[threadIdx.x] += r1[threadIdx.x + k];
      r2[threadIdx.x] += r2[threadIdx.x + k];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float cnt = (float)s * (float)cpg;
    const float mean = r1[0] / cnt;
    const float var = fmaxf(__fsub_rn(r2[0] / cnt, __fmul_rn(mean, mean)), 0.f);
    stats[0] = mean;
    stats[1] = 1.0f / sqrtf(var + eps);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cpg; i += blockDim.x) {
    const int ch = g * cpg + i;
    float w, bb;
    if (wb_bf16) {
      w = __bfloat162float(static_cast<const __nv_bfloat16*>(weight)[ch]);
      bb = __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[ch]);
    } else {
      w = static_cast<const float*>(weight)[ch];
      bb = static_cast<const float*>(bias)[ch];
    }
    const float sc = __fmul_rn(stats[1], w);
    scale[(size_t)n * c + ch] = sc;
    shift[(size_t)n * c + ch] = __fsub_rn(bb, __fmul_rn(stats[0], sc));
  }
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
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1])) << 16);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_apply(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ scale,
         const float* __restrict__ shift, size_t vecs, int s, int c, int silu) {
  const size_t sc_elems = (size_t)s * c;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < vecs;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t e = i * 8;
    const int n = (int)(e / sc_elems);
    const int ch = (int)(e % (size_t)c);
    float v[8];
    load8(x + e, v);
    const float* sc = scale + (size_t)n * c + ch;
    const float* sh = shift + (size_t)n * c + ch;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float t = __fadd_rn(__fmul_rn(v[k], sc[k]), sh[k]);
      if (silu) t = __fmul_rn(t, 1.0f / (1.0f + expf(-t)));
      v[k] = t;
    }
    store8(y + e, v);
  }
}

template <typename T>
int run(const void* x, const void* w, const void* b, int wb_bf16, void* y, float* part,
        float* scale, float* shift, int n, int s, int c, int groups, int chunks, int rows,
        float eps, int silu, cudaStream_t stream) {
  gn_partial<T><<<dim3(chunks, n), kThreads, 0, stream>>>(static_cast<const T*>(x), part, s, c,
                                                          rows);
  gn_finalize<<<dim3(groups, n), kThreads, 0, stream>>>(part, chunks, s, c, groups, w, b, wb_bf16,
                                                        eps, scale, shift);
  const size_t vecs = (size_t)n * s * c / 8;
  const int blocks = (int)((vecs + kThreads - 1) / kThreads < 4096 ? (vecs + kThreads - 1) / kThreads
                                                                   : 4096);
  gn_apply<T><<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(x), static_cast<T*>(y),
                                               scale, shift, vecs, s, c, silu);
  return (int)cudaGetLastError();
}

}  // namespace

// part: n * chunks * 2 * c floats; scale, shift: n * c floats each (scratch
// from the caller). rows = ceil(s / chunks) rows a chunk.
extern "C" int sr_group_norm(const void* x, const void* weight, const void* bias, int wb_bf16,
                             void* y, void* part, void* scale, void* shift, int n, int s, int c,
                             int groups, int chunks, int rows, float eps, int silu, int x_f32,
                             void* stream) {
  if (n <= 0 || s <= 0 || c <= 0 || c % 8 || groups <= 0 || c % groups || chunks <= 0 ||
      rows <= 0 || (long long)chunks * rows < s)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* sc = static_cast<float*>(scale);
  float* sh = static_cast<float*>(shift);
  if (x_f32)
    return run<float>(x, weight, bias, wb_bf16, y, p, sc, sh, n, s, c, groups, chunks, rows, eps,
                      silu, st);
  return run<__nv_bfloat16>(x, weight, bias, wb_bf16, y, p, sc, sh, n, s, c, groups, chunks, rows,
                            eps, silu, st);
}
