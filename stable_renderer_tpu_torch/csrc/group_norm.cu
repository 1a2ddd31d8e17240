// Fused GroupNorm (+ SiLU) for Hopper (sm_90a), in one launch.
//
// Replaces the TPU kernel stable_renderer_tpu/ops/group_norm_pallas.py
// (_gn_kernel, launched by group_norm_pallas). Over x (N, S, C), groups of
// C/G adjacent channels:
//   mean_g, var_g = f32 statistics of the group over S x C/G values
//   scale = rsqrt(max(E[x^2] - mean^2, 0) + eps) * w,  shift = b - mean * scale
//   y = x * scale + shift (f32), then SiLU when asked, cast to x's type.
//
// The TPU kernel holds one (S, C) slab per program; a Hopper grid of N = 2
// programs would fill two of 132 SMs, and a reduction across blocks needs a
// second pass or blocks that talk. Here a thread-block cluster takes one
// (n, channel slice): the slice is a whole number of groups (and of 8-channel
// vectors), and the cluster's CTAs split S. In one launch:
//   1. each thread loads its rows of one 8-channel vector (16-byte loads for
//      bf16) and keeps them in registers (up to kMaxPasses vectors; larger
//      slices re-read x from L2 in step 4), summing x and x^2 per channel in
//      f32, row by row;
//   2. the CTA sums each group over its threads' rows and the group's
//      channels, one warp a (statistic, group), in a fixed order (lanes over
//      rows, a fixed shuffle tree);
//   3. after a cluster barrier every CTA reads all CTAs' group partials from
//      distributed shared memory (all loads in flight together) and sums
//      them in rank order, so each computes the same mean and rstd, bit for
//      bit, without atomics;
//   4. it normalizes its rows from registers with its channels' weight and
//      bias (loaded with x), applies the SiLU and writes y.
// x is read from HBM once and y written once; no scratch, no second launch.
// Two calls on the same input give the same bits: every sum has a fixed order.
// What bounds it on the H100: bytes (4 bytes an element for bf16 in and out,
// a few operations an element), but at the frame's 1-5 MB a call the chain of
// latencies (HBM, the CTA's reduction, the cluster barrier, DSMEM) weighs as
// much, so ~256 small CTAs (two an SM) overlap one another's waits. The f32
// products and sums of the normalize use the _rn intrinsics, so no
// multiply-add is contracted, as in the plain version; the SiLU uses the fast
// exponential and division (a few f32 ulp, far below the output's bf16 step). The geometry (slice, cluster size, rows a pass) is chosen by
// ops/group_norm_kernel.py:gn_geometry and checked here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;            // channels a vector
constexpr int kMaxThreads = 512;
constexpr int kMaxPasses = 8;      // vectors a thread keeps in registers
constexpr int kMaxCluster = 16;
constexpr int kMaxSlice = 1024;    // channels a slice
constexpr int kRow = 2 * kVec + 1;  // floats of red a thread (padded: no bank conflicts)
constexpr int kRed = kMaxThreads * kRow;

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
// the address that p has in the shared memory of CTA `rank` of this cluster
// (a generic address: plain loads read it, after the cluster barrier)
__device__ __forceinline__ const float* at_rank(const float* p, uint32_t rank) {
  uint64_t out;
  asm volatile("mapa.u64 %0, %1, %2;" : "=l"(out) : "l"(p), "r"(rank));
  return reinterpret_cast<const float*>(out);
}

// eight channels of x as loaded: raw bf16 pairs or f32
template <typename T>
struct Vec8;
template <>
struct Vec8<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void get(float* v) const {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i])) |
             ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1])) << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <>
struct Vec8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = reinterpret_cast<const float4*>(p)[0];
    b = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ void get(float* v) const {
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  __device__ static __forceinline__ void store(float* p, const float* v) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

__device__ __forceinline__ float param(const void* p, int i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// Grid (cluster * slices, n), clusters of `cluster` CTAs along x. A CTA has
// (cs / 8) * rpp threads: thread i takes vector i % (cs / 8) of the slice's
// channels in rows i / (cs / 8) + k * rpp (k < passes) of its rpc rows.
template <typename T, bool kResident>
__global__ void __launch_bounds__(kMaxThreads)
gn_cluster(const T* __restrict__ x, T* __restrict__ y, const void* __restrict__ weight,
           const void* __restrict__ bias, int wb_bf16, int s, int c, int cpg, int cs, int cluster,
           int rpc, int rpp, int passes, float eps, int silu) {
  __shared__ float red[kRed];             // per-thread sums; then the cluster's partials
  __shared__ float part[2 * kMaxSlice];    // this CTA's group partials, read by the cluster

  const int vpr = cs / kVec;
  const int oct = threadIdx.x % vpr, rsub = threadIdx.x / vpr;
  const bool active = rsub < rpp;  // the block is rounded up to whole warps
  const int rank = (int)cluster_rank();
  const int slice0 = (blockIdx.x / cluster) * cs;
  const int n = blockIdx.y, c0 = slice0 + oct * kVec;
  const int row0 = rank * rpc, row1 = min(s, row0 + rpc);
  const T* xn = x + (size_t)n * s * c + c0;
  T* yn = y + (size_t)n * s * c + c0;
  const int gps = cs / cpg;  // groups in the slice

  // 1. this thread's rows (loaded together with its channels' weight and
  // bias): per-channel f32 sums of x and x^2, in row order
  float wv[kVec], bv[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    wv[k] = param(weight, c0 + k, wb_bf16);
    bv[k] = param(bias, c0 + k, wb_bf16);
  }
  float sum[kVec], sq[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) sum[k] = sq[k] = 0.f;
  Vec8<T> held[kResident ? kMaxPasses : 1];
  auto accumulate = [&](const Vec8<T>& raw) {
    float v[kVec];
    raw.get(v);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      sum[k] = __fadd_rn(sum[k], v[k]);
      sq[k] = __fadd_rn(sq[k], __fmul_rn(v[k], v[k]));
    }
  };
  if (kResident) {
#pragma unroll
    for (int p = 0; p < kMaxPasses; ++p) {
      const int r = row0 + rsub + p * rpp;
      if (active && p < passes && r < row1) held[p].load(xn + (size_t)r * c);
    }
#pragma unroll
    for (int p = 0; p < kMaxPasses; ++p)
      if (active && p < passes && row0 + rsub + p * rpp < row1) accumulate(held[p]);
  } else if (active) {
    for (int r = row0 + rsub; r < row1; r += rpp) {
      held[0].load(xn + (size_t)r * c);
      accumulate(held[0]);
    }
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    red[threadIdx.x * kRow + k] = sum[k];
    red[threadIdx.x * kRow + kVec + k] = sq[k];
  }
  __syncthreads();

  // 2. per group over the CTA's rows and the group's channels: one warp a
  // (statistic, group), its lanes over rows rsub = lane, lane + 32, ... in
  // channel order, then a fixed shuffle tree: part[stat * gps + g]
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int u = threadIdx.x >> 5; u < 2 * gps; u += warps) {
    const int stat = u / gps, g = u - stat * gps;
    float a = 0.f;
    for (int j = lane; j < rpp; j += 32) {
      const float* row = red + j * vpr * kRow + stat * kVec;
      for (int ch = g * cpg; ch < (g + 1) * cpg; ++ch)
        a = __fadd_rn(a, row[(ch / kVec) * kRow + ch % kVec]);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, d));
    if (lane == 0) part[u] = a;
  }

  // 3. the cluster's partials: every value read by its own thread (all in
  // flight together), then summed in rank order, so every CTA has the same
  // sums, bit for bit
  cluster_arrive();
  cluster_wait();
  for (int u = threadIdx.x; u < 2 * gps * cluster; u += blockDim.x) {
    const int q = u / (2 * gps);
    red[u] = *at_rank(part + (u - q * 2 * gps), q);
  }
  __syncthreads();
  cluster_arrive();  // this CTA has read the others' partials
  float* stats = red + 2 * gps * cluster;
  const float cnt = (float)s * (float)cpg;
  for (int g = threadIdx.x; g < gps; g += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int q = 0; q < cluster; ++q) {
      a = __fadd_rn(a, red[q * 2 * gps + g]);
      b = __fadd_rn(b, red[q * 2 * gps + gps + g]);
    }
    const float mean = a / cnt;
    const float var = fmaxf(__fsub_rn(b / cnt, __fmul_rn(mean, mean)), 0.f);
    stats[2 * g] = mean;
    stats[2 * g + 1] = 1.0f / sqrtf(var + eps);
  }
  __syncthreads();

  // 4. this thread's scale and shift, then normalize, SiLU, cast, store
  float sc[kVec], sh[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int g = (oct * kVec + k) / cpg;
    sc[k] = __fmul_rn(stats[2 * g + 1], wv[k]);
    sh[k] = __fsub_rn(bv[k], __fmul_rn(stats[2 * g], sc[k]));
  }
  auto emit = [&](const Vec8<T>& raw, int r) {
    float v[kVec];
    raw.get(v);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      float t = __fadd_rn(__fmul_rn(v[k], sc[k]), sh[k]);
      if (silu) t = __fdividef(t, 1.0f + __expf(-t));  // x sigmoid(x), to a few f32 ulp
      v[k] = t;
    }
    Vec8<T>::store(yn + (size_t)r * c, v);
  };
  if (kResident) {
#pragma unroll
    for (int p = 0; p < kMaxPasses; ++p) {
      const int r = row0 + rsub + p * rpp;
      if (active && p < passes && r < row1) emit(held[p], r);
    }
  } else if (active) {
    for (int r = row0 + rsub; r < row1; r += rpp) {
      held[0].load(xn + (size_t)r * c);
      emit(held[0], r);
    }
  }
  cluster_wait();  // no CTA leaves while another may still read its partials
}

// threads a CTA: (cs / 8) x rpp, rounded up to whole warps
int threads_for(int cs, int rpp) { return ((cs / kVec) * rpp + 31) / 32 * 32; }

cudaLaunchConfig_t config(cudaLaunchAttribute* attr, int n, int c, int cs, int cluster,
                          int threads, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * (c / cs), n, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, bool kResident>
int allow_cluster(int cluster) {
  // clusters above 8 CTAs are not portable: allowed once, per kernel
  static bool done = false;
  if (cluster > 8 && !done) {
    const cudaError_t e = cudaFuncSetAttribute(
        gn_cluster<T, kResident>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    done = true;
  }
  return 0;
}

template <typename T, bool kResident>
int launch(const void* x, const void* w, const void* b, int wb_bf16, void* y, int n, int s, int c,
           int cpg, int cs, int cluster, int rpc, int rpp, int passes, float eps, int silu,
           cudaStream_t stream) {
  if (const int e = allow_cluster<T, kResident>(cluster)) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config(attr, n, c, cs, cluster, threads_for(cs, rpp), stream);
  return (int)cudaLaunchKernelEx(&cfg, gn_cluster<T, kResident>, static_cast<const T*>(x),
                                 static_cast<T*>(y), w, b, wb_bf16, s, c, cpg, cs, cluster, rpc,
                                 rpp, passes, eps, silu);
}

template <typename T, bool kResident>
int max_clusters(int n, int c, int cs, int cluster, int rpp) {
  if (const int e = allow_cluster<T, kResident>(cluster)) return -e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config(attr, n, c, cs, cluster, threads_for(cs, rpp), nullptr);
  int count = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&count, gn_cluster<T, kResident>, &cfg);
  return e == cudaSuccess ? count : -(int)e;
}

bool valid(int n, int s, int c, int groups, int cs, int cluster, int rpc, int rpp, int passes,
           int resident) {
  if (n <= 0 || n > 65535 || s <= 0 || c <= 0 || groups <= 0 || c % groups) return false;
  const int cpg = c / groups;
  return cs > 0 && cs % kVec == 0 && cs % cpg == 0 && c % cs == 0 && cs <= kMaxSlice &&
         cluster >= 1 && cluster <= kMaxCluster && 2 * (cs / cpg) * (cluster + 1) <= kRed &&
         rpc >= 1 && (long long)rpc * cluster >= s && rpp >= 1 &&
         threads_for(cs, rpp) <= kMaxThreads &&
         passes >= 1 && (long long)passes * rpp >= rpc && (!resident || passes <= kMaxPasses) &&
         (long long)cluster * (c / cs) <= 2147483647LL;
}

}  // namespace

// One launch: x (n, s, c) bf16 (x_f32 = 0) or f32, contiguous, 16-byte
// aligned; weight and bias (c,) bf16 (wb_bf16 = 1) or f32; y like x. The
// geometry is ops/group_norm_kernel.py:gn_geometry's: slice channels cs,
// cluster CTAs, rows a CTA rpc, rows a pass rpp, passes, resident (x kept in
// registers). Returns a cudaError_t.
extern "C" int sr_group_norm(const void* x, const void* weight, const void* bias, int wb_bf16,
                             void* y, int n, int s, int c, int groups, int cs, int cluster,
                             int rpc, int rpp, int passes, int resident, float eps, int silu,
                             int x_f32, void* stream) {
  if (!valid(n, s, c, groups, cs, cluster, rpc, rpp, passes, resident))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cpg = c / groups;
#define SR_GN_LAUNCH(T, R)                                                                   \
  launch<T, R>(x, weight, bias, wb_bf16, y, n, s, c, cpg, cs, cluster, rpc, rpp, passes, eps, \
               silu, st)
  if (x_f32) return resident ? SR_GN_LAUNCH(float, true) : SR_GN_LAUNCH(float, false);
  return resident ? SR_GN_LAUNCH(__nv_bfloat16, true) : SR_GN_LAUNCH(__nv_bfloat16, false);
#undef SR_GN_LAUNCH
}

// cudaOccupancyMaxActiveClusters for that launch: how many of its clusters
// the card can hold at once (>= 1 if it can run at all), or -cudaError_t.
extern "C" int sr_group_norm_max_clusters(int n, int s, int c, int groups, int cs, int cluster,
                                          int rpc, int rpp, int passes, int resident,
                                          int x_f32) {
  if (!valid(n, s, c, groups, cs, cluster, rpc, rpp, passes, resident))
    return -(int)cudaErrorInvalidValue;
  if (x_f32)
    return resident ? max_clusters<float, true>(n, c, cs, cluster, rpp)
                    : max_clusters<float, false>(n, c, cs, cluster, rpp);
  return resident ? max_clusters<__nv_bfloat16, true>(n, c, cs, cluster, rpp)
                  : max_clusters<__nv_bfloat16, false>(n, c, cs, cluster, rpp);
}
