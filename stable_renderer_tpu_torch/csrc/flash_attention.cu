// Flash attention forward for Hopper (sm_90a), SIMT version.
//
// Replaces the TPU kernel stable_renderer_tpu/ops/flash_attention.py
// (_flash_kernel, launched by flash_attention). Non-causal softmax attention
// over (BH, L, D): every block owns one (bh, BQ-row) query tile, streams the
// K/V sequence through shared memory in BK-row tiles, and keeps the online
// softmax (running max m, running sum l, output accumulator) in f32 registers.
// The (Lq, Lk) logits never reach device memory: at (16, 4096, 40) they would
// be 1 GiB in f32.
//
// What bounds it on the H100: the two tile products run on the f32 FMA pipes
// (no tensor cores yet), fed from shared memory. At d = 40 a tile does
// 64 x 64 x 40 multiply-adds per 64 x 40 K/V tile it loads, so it is bound by
// instruction issue and shared-memory bandwidth, not by device-memory bytes.
// The design answers that with register blocking: each thread holds a TR x TC
// block of scores and a TR x (D/16) block of outputs, so one vector load from
// shared memory feeds several multiply-adds. mma.sync / wgmma and TMA are the
// next step.
//
// Two tile shapes, picked by head dim:
//   d <= 64  : BQ = 64, BK = 64  (UNet level-0 self-attention, d = 40)
//   d <= 512 : BQ = 32, BK = 64  (VAE mid-block attention, d = 512). The
//              staged Q^T and K^T tiles are d x BQ and d x BK in f32; 32-row
//              query tiles keep them, with the score tile, inside the 227 KB a
//              block may use, and give 128 blocks at L = 4096 for 132 SMs.
// The scale is applied in f32 to Q as it is staged. Rows of the ragged last
// K tile are zero-filled and their scores set to -inf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

// Shared-memory floats a block needs at head dim d.
template <int BQ, int BK>
__host__ __device__ constexpr int smem_floats(int d) {
  return d * (BQ + 4) + (d * (BK + 4) > BK * d ? d * (BK + 4) : BK * d) + BQ * (BK + 4);
}

template <typename T, int BQ, int BK, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int lq, int lk, int d, float scale) {
  constexpr int TR = BQ / 16;    // query rows per thread
  constexpr int TC = BK / 16;    // score columns per thread
  constexpr int DG = DMAX / 16;  // output columns per thread: d = cg + 16 * j
  constexpr int QS = BQ + 4;     // padded row strides (16-byte aligned)
  constexpr int KS = BK + 4;
  constexpr int PS = BK + 4;

  extern __shared__ float smem[];
  float* qt = smem;             // Q^T * scale   [d][QS]
  float* kv = qt + d * QS;      // K^T [d][KS], then V [BK][d]
  float* p = kv + (d * KS > BK * d ? d * KS : BK * d);  // probabilities [BQ][PS]

  const int tid = threadIdx.x;
  const int rg = tid / 16;  // row group: the 16 lanes of a half-warp share it
  const int cg = tid % 16;  // column group
  const int q0 = blockIdx.x * BQ;
  const size_t bh = blockIdx.y;
  const T* qb = q + bh * lq * d;
  const T* kb = k + bh * lk * d;
  const T* vb = v + bh * lk * d;

  for (int i = tid; i < BQ * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    const float x = (q0 + r < lq) ? to_f32(qb[(size_t)(q0 + r) * d + c]) : 0.f;
    qt[c * QS + r] = x * scale;
  }

  float m[TR], l[TR], acc[TR][DG];
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DG; ++j) acc[r][j] = 0.f;
  }

  for (int k0 = 0; k0 < lk; k0 += BK) {
    const int kn = min(BK, lk - k0);
    __syncthreads();  // the previous tile's P.V is done with kv and p
    for (int i = tid; i < BK * d; i += kThreads) {
      const int r = i / d, c = i - r * d;
      kv[c * KS + r] = (r < kn) ? to_f32(kb[(size_t)(k0 + r) * d + c]) : 0.f;
    }
    __syncthreads();

    float s[TR][TC];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[r][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qa[TR], ka[TC];
      load_vec<TR>(qt + c * QS + rg * TR, qa);
      load_vec<TC>(kv + c * KS + cg * TC, ka);
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int j = 0; j < TC; ++j) s[r][j] = fmaf(qa[r], ka[j], s[r][j]);
    }

    // online softmax; a row's TC * 16 scores live in one half-warp
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        if (cg * TC + j >= kn) s[r][j] = -INFINITY;
        mx = fmaxf(mx, s[r][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float corr = __expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        s[r][j] = __expf(s[r][j] - m_new);
        sum += s[r][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < DG; ++j) acc[r][j] *= corr;
#pragma unroll
      for (int j = 0; j < TC; ++j) p[(rg * TR + r) * PS + cg * TC + j] = s[r][j];
    }
    __syncthreads();  // every thread is done reading K^T

    for (int i = tid; i < BK * d; i += kThreads) {
      const int r = i / d, c = i - r * d;
      kv[r * d + c] = (r < kn) ? to_f32(vb[(size_t)(k0 + r) * d + c]) : 0.f;
    }
    __syncthreads();

    for (int c = 0; c < BK; c += 4) {
      float pa[TR][4];
#pragma unroll
      for (int r = 0; r < TR; ++r) load_vec<4>(p + (rg * TR + r) * PS + c, pa[r]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = kv + (c + cc) * d;
#pragma unroll
        for (int j = 0; j < DG; ++j) {
          const int dd = cg + 16 * j;
          if (dd < d) {
            const float vv = vrow[dd];
#pragma unroll
            for (int r = 0; r < TR; ++r) acc[r][j] = fmaf(pa[r][cc], vv, acc[r][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int row = q0 + rg * TR + r;
    if (row >= lq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* orow = o + (bh * lq + row) * d;
#pragma unroll
    for (int j = 0; j < DG; ++j) {
      const int dd = cg + 16 * j;
      if (dd < d) orow[dd] = from_f32<T>(acc[r][j] * inv);
    }
  }
}

template <typename T, int BQ, int BK, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int lq,
                   int lk, int d, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd<T, BQ, BK, DMAX>;
  const int bytes = smem_floats<BQ, BK>(d) * (int)sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + BQ - 1) / BQ, bh);
  kernel<<<grid, kThreads, bytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                             static_cast<const T*>(v), static_cast<T*>(o), lq,
                                             lk, d, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int bh, int lq, int lk,
             int d, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return (int)launch<T, 64, 64, 64>(q, k, v, o, bh, lq, lk, d, scale, s);
  if (d <= 512) return (int)launch<T, 32, 64, 512>(q, k, v, o, bh, lq, lk, d, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o: contiguous (bh, l, d) tensors on the current device. Returns a
// cudaError_t; 0 means the launch was accepted.
extern "C" int sr_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                       int bh, int lq, int lk, int d, float scale,
                                       void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, bh, lq, lk, d, scale, stream);
}

extern "C" int sr_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                      int bh, int lq, int lk, int d, float scale,
                                      void* stream) {
  return dispatch<float>(q, k, v, o, bh, lq, lk, d, scale, stream);
}

extern "C" const char* sr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
