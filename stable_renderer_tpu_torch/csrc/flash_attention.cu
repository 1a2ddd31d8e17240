// Flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel stable_renderer_tpu/ops/flash_attention.py
// (_flash_kernel, launched by flash_attention). Non-causal softmax attention:
// logits and the online softmax (running max m, running sum l, output
// accumulator) in f32; the probabilities P rounded to bf16 before the P.V
// product, as the TPU kernel's p.astype(v.dtype) does, while l sums the
// unrounded f32 P; the output rounded to bf16 once, at the end. Rows of a
// ragged last K/V tile are zero-filled and their scores set to -inf; rows of
// a ragged last query tile are computed on zeros and never written. The
// (Lq, Lk) logits never reach device memory.
//
// Two routes, by dtype:
//   * bf16: the tensor-core kernels below (wgmma, TMA and mbarriers at
//     d <= 256; mma.sync and cp.async above). Operands come as strided
//     (B, L, H, D) views (unit d stride; element strides of batch, sequence
//     and head), so the UNet's q, k and v are read straight out of its fused
//     QKV product and the output is written as (B, L, H*D). Any head dim from
//     1 to 512: d is zero-padded inside shared memory, never in device
//     memory. Tiles move by TMA or 16-byte cp.async (zero-filled past d and
//     past the sequence) when d and every stride are multiples of 8 elements
//     and the bases 16-byte aligned, else element by element.
//   * f32: contiguous (BH, L, D) on the f32 FMA pipes (TF32 tensor cores
//     would change its numbers): flash_simt_f32 at d <= 64 (the tiny f32
//     frame), flash_f32 above (the loaded pipeline's f32 VAE, d = 512).
//
// What bounds the bf16 route on the H100, and what the design does about it:
//   d <= 64 (flash_wg; the UNet's level-0 self-attention, d = 40): the
//     exponentials. 16 x 4096^2 = 268 M of them at 16 MUFU ops a clock on each
//     of 132 SMs (~3.9 T/s) take ~0.07 ms, more than the MMAs at d padded to
//     48 (~0.05 ms at 989 TFLOP/s), so the exponentials and the MMAs must not
//     wait for each other. A block of four warpgroups owns a 256-row query
//     tile (256 blocks at (16, 4096), one an SM, 16 warps). Q sits in shared
//     memory; thread 0 streams 64-row K and V tiles by TMA (one box a tile
//     from a 5-d map whose chunks of 8 columns land as wgmma's no-swizzle
//     core matrices: K K-major, V MN-major, and P.V needs no transpose) into
//     a ring of 4 buffers run on mbarriers, with no block-wide barrier in the
//     loop. Each warpgroup issues S(j + 1) = Q.K(j + 1)^T and O += P(j).V(j)
//     as asynchronous wgmmas back to back, as FlashAttention-3 does, the
//     warpgroups in turns (ping-pong), and runs the softmax of S(j + 1)
//     while P.V(j) computes: one FFMA (scale * log2 e folded in) and
//     one ex2 a score, row max by quad shuffles, l kept per thread and
//     reduced once at the end. P goes from the S accumulators into A
//     fragments in registers (the wgmma C layout is the A layout), so it
//     never touches shared memory; P.V is 64 x 40 at d = 40.
//   64 < d <= 256 (flash_wg again; the all-frames levels 1 and 2, d = 80 and
//     160): the MMAs and the exponentials together (at (8, 8192^2, 80) 0.17
//     and 0.14 ms). The same kernel with d padded only to 16: Q.K^T is DK / 16
//     wgmmas deep (5 at d = 80, 10 at 160) and P.V is one m64nDK wgmma a
//     16-key step, 80 or 160 wide. The block is sized to the register file
//     and shared memory: a warpgroup holds S (BK / 2 registers a thread) and
//     O (DK / 2), so four warpgroups (256 query rows, 128 registers a thread)
//     up to DK = 80, three up to 128, two above; K/V tiles of 64 rows up to
//     DK = 176 and 32 above, so that Q and a ring of 4 stages fit in 227 KB.
//     With two warpgroups (d > 128) a block streams a head's whole K/V for
//     only 128 query rows, so the K/V loads from L2 bound it: they come in
//     the 32-byte swizzle, whole sectors (see flash_wg).
//   256 < d <= 512 (flash_wide; the VAE mid-block attention, d = 512): the
//     MMAs, 4 x 4096^2 x 512 operations. A 64 x 512 f32 output block is 256
//     registers a thread for one warpgroup, so 8 warps split it by columns
//     (64 each, 128 registers). S (64 x 64) is computed once per K tile, 16 x
//     32 a warp, on mma.sync m16n8k16 (ldmatrix; ldmatrix.trans for V), and
//     handed to the output warps as bf16 P through shared memory (9 KB).
//     Q (64 x 512) stays resident; K and V each have one buffer, loaded by
//     cp.async as FlashAttention-2 does: V(j) while S(j) runs, K(j + 1) while
//     the softmax and P.V(j) run (209 KB of shared memory). At L = 4096
//     64-row query tiles give 64 blocks for 132 SMs, so the K/V sequence is
//     split across blocks (2 at that shape: as many as fill the SMs, at most
//     4) and a small second kernel merges their (O / l, m + log l) partials.
//     A cluster merge through distributed shared memory would save that pass
//     (~20 MB of traffic); it is left for later.
// What bounds the f32 route at d = 512, and what flash_f32 does about it: the
//   f32 FMAs, 2 x 4096^2 x 512 of them at (1, 4096^2, 512) (0.51 ms at 67
//   TFLOP/s), provided shared memory feeds them: an SM does 128 FMAs a clock
//   but reads only 32 floats, so every float read must feed 4 FMAs or more.
//   A block of 8 warps owns 64 query rows, warp w rows 8w..8w+7 in both
//   products, so the softmax never leaves the warp. Q^T (scaled) stays in
//   shared memory; K comes in 128-key x 32-deep chunks and V in 8-key x
//   512-wide chunks through a ring of 3 buffers by cp.async (one block-wide
//   barrier a chunk). In Q.K^T a lane holds 8 rows x 4 keys of S: for each
//   depth it reads 8 floats of Q (one broadcast for the warp) and 4 of K for
//   32 FMAs. In P.V it holds 8 rows x 16 columns of O (128 registers): for each
//   key, 8 probabilities (a broadcast from its warp's P in shared memory) and
//   16 values of V for 128 FMAs. One block an SM (O takes half the register
//   file), so the K/V sequence is split across blocks as for flash_wide (2
//   at that shape) and flash_merge_f32 merges the partials.
// Tile variants (query rows, K/V rows, ring buffers, warpgroup ping-pong,
// K/V split) are compiled as a table; sr_flash_attention_bf16 takes an index
// into it (-1: the default for the head dim), which
// scripts/sweep_torch_attention.py times on the card.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace sr;

using bf16 = __nv_bfloat16;

struct Strides {
  long long b, l, h;  // elements; 0 for a dimension of size 1
};

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* part_o;    // (splits, B*H, lq, DK) f32 partial outputs O / l, or null
  float* part_lse;  // (splits, B*H, lq) f32 partial m * sl2 + log2 l, or null
  Strides sq, sk, sv, so;
  int heads, lq, lk, d;
  int vec;              // 16-byte rows: cp.async and TMA copies
  int box5;             // swizzled flash_wg: one 5-d box a tile (d % 16 == 0), else one a plane
  int splits, tiles_per_split;
  float sl2;            // softmax scale * log2(e)
};

// ---- device helpers ------------------------------------------------------------

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

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a * b on the tensor cores: m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 2^x on the MUFU pipe, one instruction; ex2(-inf) = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows [r0, r0 + ROWS) of a (L, d) slab with row stride ls into shared rows
// of DK + 8 elements (the 16-byte pad keeps ldmatrix free of bank
// conflicts), zero past `valid` rows and past column d.
template <int ROWS, int DK, int NT>
__device__ __forceinline__ void load_rows(bf16* s, const bf16* base, long long ls, int r0,
                                          int valid, int d, bool vec, int tid) {
  constexpr int SR = DK + 8, CH = DK / 8;
  if (vec) {
#pragma unroll 4
    for (int i = tid; i < ROWS * CH; i += NT) {
      const int r = i / CH, c = i - r * CH;
      const bool ok = r < valid && c * 8 < d;
      cp_async16(s + r * SR + c * 8, ok ? base + (long long)(r0 + r) * ls + c * 8 : base, ok);
    }
  } else {
    for (int i = tid; i < ROWS * DK; i += NT) {
      const int r = i / DK, c = i - r * DK;
      s[r * SR + c] = (r < valid && c < d) ? base[(long long)(r0 + r) * ls + c]
                                           : __float2bfloat16(0.f);
    }
  }
}

// Two output values of one row at columns col, col + 1 (col even).
__device__ __forceinline__ void store_pair(bf16* row, int col, int d, float a, float b) {
  if (!(d & 1)) {
    if (col < d) *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(a, b);
  } else {
    if (col < d) row[col] = __float2bfloat16(a);
    if (col + 1 < d) row[col + 1] = __float2bfloat16(b);
  }
}

// wgmma with A in shared memory too (desc_a, K-major): S = Q.K^T. (WgmmaRS,
// A from registers, is in hopper.cuh.)
template <int N>
struct WgmmaSS;

template <>
struct WgmmaSS<32> {
  __device__ static __forceinline__ void run(float* d, uint64_t desc_a, uint64_t desc_b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(acc));
  }
};

template <>
struct WgmmaSS<64> {
  __device__ static __forceinline__ void run(float* d, uint64_t desc_a, uint64_t desc_b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31 "
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(acc));
  }
};

template <>
struct WgmmaSS<128> {
  __device__ static __forceinline__ void run(float* d, uint64_t desc_a, uint64_t desc_b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63 "
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(acc));
  }
};

// Rows [r0, r0 + ROWS) of a (L, d) slab in wgmma's no-swizzle layout, zero
// past `valid` rows and past column d: the 8 columns 8c..8c+7 of all rows are
// one [ROWS][16 bytes] block, so the 16-byte chunk (row r, chunk c) is at byte
// c * ROWS * 16 + r * 16, and an 8 x 16-byte core matrix is 128 contiguous
// bytes. The layout TMA writes with make_tmap's box.
template <int ROWS, int CH, int NT>
__device__ __forceinline__ void load_chunks(uint8_t* s, const bf16* base, long long ls, int r0,
                                            int valid, int d, bool vec, int tid) {
  if (vec) {
#pragma unroll 4
    for (int i = tid; i < ROWS * CH; i += NT) {
      const int r = i / CH, c = i - r * CH;
      const bool ok = r < valid && c * 8 < d;
      cp_async16(s + c * ROWS * 16 + r * 16, ok ? base + (long long)(r0 + r) * ls + c * 8 : base,
                 ok);
    }
  } else {
    for (int i = tid; i < ROWS * CH * 8; i += NT) {
      const int r = i / (CH * 8), col = i - r * (CH * 8);
      *reinterpret_cast<bf16*>(s + (col >> 3) * ROWS * 16 + r * 16 + (col & 7) * 2) =
          (r < valid && col < d) ? base[(long long)(r0 + r) * ls + col] : __float2bfloat16(0.f);
    }
  }
}

// Rows [r0, r0 + ROWS) of a (L, d) slab, element by element, in the layout
// TMA writes with the 32-byte swizzle: 16 columns a plane of ROWS rows x 32
// bytes, the two 16-byte halves of rows 4..7 of every 8 swapped (address bit 4
// ^= bit 7); zero past `valid` rows and past column d.
template <int ROWS, int PLANES, int NT>
__device__ __forceinline__ void load_planes_sw32(uint8_t* s, const bf16* base, long long ls,
                                                 int r0, int valid, int d, int tid) {
  for (int i = tid; i < ROWS * PLANES * 16; i += NT) {
    const int r = i / (PLANES * 16), col = i - r * (PLANES * 16);
    int off = r * 32 + (col & 15) * 2;
    off ^= ((off >> 7) & 1) << 4;
    *reinterpret_cast<bf16*>(s + (col >> 4) * ROWS * 32 + off) =
        (r < valid && col < d) ? base[(long long)(r0 + r) * ls + col] : __float2bfloat16(0.f);
  }
}

// ---- d <= 256 on wgmma: P in registers, the softmax of S(j + 1) during P.V(j) ----
// DK: d padded to 16 (the Q.K^T depth); DV: d padded to 8, 40 or a multiple of
// 16 (the P.V width); BK: K/V rows a tile (32, 64 or 128); R: ring buffers; NWG consumer
// warpgroups of 64 query rows each (BQ = 64 NWG). Thread 0 loads each K/V
// tile by TMA (tmk, tmv; make_tmap), as one box where it can (one box a chunk
// cost the mid route 16% at d = 80): without SW32 in 8-column chunks that
// land as the no-swizzle core matrices, with SW32 in 16-column planes in the
// 32-byte swizzle, which reads whole 32-byte sectors (it took the mid route
// from 0.084 to 0.058 ms at (8, 2048^2, 160), and cost d = 40, whose P.V it
// widens to 48, 12%). Where rows are not 16-byte aligned (a.vec = 0) every
// thread loads part of the tile, in the same layout; every thread consumes
// the whole tile. The ring runs on mbarriers (full: the tile has
// landed; empty: every thread is done with it), so the warpgroups are not
// held in step by a block-wide barrier.
template <int DK, int DV, int BK, int R, int NWG>
__host__ __device__ constexpr int wg_smem_bytes() {
  return 64 * NWG * DK * 2 + R * BK * (DK + DV) * 2 + 2 * R * 8;
}

// two blocks an SM (128 registers a thread) only where S and O leave room
template <int DV, int BK, int NWG>
constexpr int wg_min_blocks() {
  return (NWG == 2 && BK == 64 && DV <= 64) || NWG == 1 ? 2 : 1;
}

template <int DK, int DV, int BK, int R, int NWG, bool PP, bool SW32>
__global__ void __launch_bounds__(128 * NWG, wg_min_blocks<DV, BK, NWG>())
flash_wg(const __grid_constant__ Args a, const __grid_constant__ CUtensorMap tmk,
         const __grid_constant__ CUtensorMap tmv) {
  static_assert(R >= 4, "tile j + R - 2 is loaded while tiles j - 1 .. j + 1 are in use");
  constexpr int NT = 128 * NWG, BQ = 64 * NWG, KT = DK / 16, KCH = DK / 8, VCH = DV / 8;
  constexpr int KBYTES = BK * DK * 2, STAGE = BK * (DK + DV) * 2;
  constexpr int NS = BK / 2, NO = DV / 2;  // accumulators a thread: S (64 x BK), O (64 x DV)
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* qs = smem_raw;                   // Q, 8-column chunks
  uint8_t* ring = smem_raw + BQ * DK * 2;   // R stages of (K tile, V tile)
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + R * STAGE);
  uint64_t* empty = full + R;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh - b * a.heads;
  const bf16* qb = a.q + b * a.sq.b + h * a.sq.h;
  const bf16* kb = a.k + b * a.sk.b + h * a.sk.h;
  const bf16* vb = a.v + b * a.sv.b + h * a.sv.h;
  const int ntiles = (a.lk + BK - 1) / BK;

  const int dch = (a.d + 7) / 8;  // chunks that hold data; TMA leaves K's others zero
  if (tid == 0) {
    for (int i = 0; i < R; ++i) {
      mbar_init(full + i, a.vec ? 1 : NT);
      mbar_init(empty + i, NT / 32);  // one arrival per warp
    }
  }
  if (a.vec && !SW32) {
    for (int i = tid; i < R * (KCH - dch) * BK; i += NT) {
      const int slot = i / ((KCH - dch) * BK), rest = i - slot * (KCH - dch) * BK;
      *reinterpret_cast<uint4*>(ring + slot * STAGE + dch * BK * 16 + rest * 16) =
          make_uint4(0, 0, 0, 0);
    }
  }
  load_chunks<BQ, KCH, NT>(qs, qb, a.sq.l, q0, min(BQ, a.lq - q0), a.d, a.vec, tid);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();  // Q, and the barriers' initialisation

  auto produce = [&](int j) {  // load tile j into its ring slot
    if (j >= ntiles) return;
    const int slot = j % R;
    uint8_t* st = ring + slot * STAGE;
    const int k0 = j * BK;
    if (a.vec) {
      if (tid != 0) return;
      if (j >= R) mbar_wait(empty + slot, (j / R - 1) & 1);  // tile j - R is done with
      if (SW32) {
        const int pairs = (a.d + 15) / 16;
        mbar_expect_tx(full + slot, 2 * pairs * BK * 32);
        if (a.box5) {
          tma_load(st, &tmk, 0, k0, 0, h, b, full + slot);
          tma_load(st + KBYTES, &tmv, 0, k0, 0, h, b, full + slot);
        } else {
          for (int p = 0; p < pairs; ++p) {
            tma_load(st + p * BK * 32, &tmk, p * 16, k0, h, b, full + slot);
            tma_load(st + KBYTES + p * BK * 32, &tmv, p * 16, k0, h, b, full + slot);
          }
        }
        return;
      }
      mbar_expect_tx(full + slot, 2 * dch * BK * 16);
      tma_load(st, &tmk, 0, k0, 0, h, b, full + slot);
      tma_load(st + KBYTES, &tmv, 0, k0, 0, h, b, full + slot);
      return;
    }
    if (j >= R) mbar_wait(empty + slot, (j / R - 1) & 1);  // tile j - R is done with
    const int valid = min(BK, a.lk - k0);
    if (SW32) {
      load_planes_sw32<BK, DK / 16, NT>(st, kb, a.sk.l, k0, valid, a.d, tid);
      load_planes_sw32<BK, DV / 16, NT>(st + KBYTES, vb, a.sv.l, k0, valid, a.d, tid);
    } else {
      load_chunks<BK, KCH, NT>(st, kb, a.sk.l, k0, valid, a.d, false, tid);
      load_chunks<BK, VCH, NT>(st + KBYTES, vb, a.sv.l, k0, valid, a.d, false, tid);
    }
    mbar_arrive(full + slot);
  };
  auto landed = [&](int j) {  // wait for tile j, and make it visible to wgmma
    mbar_wait(full + j % R, (j / R) & 1);
    if (!a.vec) fence_proxy_async();  // TMA writes through the async proxy itself
  };

  const int wg = warp >> 2;
  const uint8_t* qw = qs + wg * 64 * 16;  // this warpgroup's 64 query rows
  auto s_product = [&](float* s, int j) {  // S = Q.K(j)^T, committed, not waited for
    const uint8_t* kt = ring + (j % R) * STAGE;
    fence_regs<NS>(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
      WgmmaSS<BK>::run(s, smem_desc(qw + kk * 2 * BQ * 16, BQ * 16, 128),
                       SW32 ? smem_desc_sw32(kt + kk * BK * 32, 16)
                            : smem_desc(kt + kk * 2 * BK * 16, BK * 16, 128),
                       kk > 0);
    wgmma_commit();
    fence_regs<NS>(s);
  };

  // the online softmax of S(j) in place: mask, P = 2^(S sl2 - m sl2), l;
  // returns each row's correction of O
  float sc[NS], o[NO], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
  auto softmax = [&](int j) {
    const int k0 = j * BK;
    if (k0 + BK > a.lk) {
#pragma unroll
      for (int i = 0; i < NS; ++i)
        if (k0 + (i >> 2) * 8 + 2 * t + (i & 1) >= a.lk) sc[i] = -INFINITY;
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {  // row g: sc[4c + 0..1], row g + 8: sc[4c + 2..3]
      float mx = m[hh];
#pragma unroll
      for (int c = 0; c < BK / 8; ++c)
        mx = fmaxf(mx, fmaxf(sc[4 * c + 2 * hh], sc[4 * c + 2 * hh + 1]));
      mx = quad_max(mx);  // finite: column 0 of the first tile is a real key
      const float ms = mx * a.sl2;
      corr[hh] = ex2(m[hh] * a.sl2 - ms);
      m[hh] = mx;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < BK / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2(fmaf(sc[4 * c + 2 * hh + e], a.sl2, -ms));
          sc[4 * c + 2 * hh + e] = p;
          sum += p;
        }
      l[hh] = l[hh] * corr[hh] + sum;
    }
  };
  uint32_t pa[BK / 16][4];  // P's A fragments: the C blocks of columns 16kk.. and 16kk + 8..
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  };

#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  for (int j = 0; j < R - 2; ++j) produce(j);
  landed(0);
  s_product(sc, 0);
  wgmma_wait<0>();
  fence_regs<NS>(sc);
  softmax(0);
  pack_p();

  // Tile j, as FlashAttention-3 orders it: S(j + 1) and P.V(j) are issued
  // back to back; the softmax of S(j + 1) runs while P.V(j) computes. O is
  // rescaled before either is issued (no non-wgmma instruction may touch an
  // accumulator between a wgmma's issue and its wait, or ptxas serializes
  // them), and P(j + 1) is packed only once P.V(j) is done with P(j)'s
  // registers.
  // more: S(j + 1) exists. The last tile is peeled off, so that no branch
  // separates a wgmma from its wait.
  auto tile = [&](int j, bool more) {
    // once the row maxima settle, corr is exactly 1 and the rescale is skipped
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int c = 0; c < VCH; ++c) {
          o[4 * c + 2 * hh] *= corr[hh];
          o[4 * c + 2 * hh + 1] *= corr[hh];
        }
    }
    if (more) landed(j + 1);
    if (PP) named_sync(1 + wg, 256);  // this warpgroup's turn to issue
    if (more) s_product(sc, j + 1);
    const uint8_t* vt = ring + (j % R) * STAGE + KBYTES;
    fence_regs<NO>(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      WgmmaRS<DV>::template run<1>(o, pa[kk],
                                   SW32 ? smem_desc_sw32(vt + kk * 512, BK * 32)
                                        : smem_desc(vt + kk * 256, 128, BK * 16),
                                   1);
    wgmma_commit();
    fence_regs<NO>(o);
    if (PP && (more || wg != NWG - 1))  // the next warpgroup's turn
      named_arrive(1 + (wg + 1) % NWG, 256);
    produce(j + R - 2);  // into the slot of tile j - 2, which every thread is done with
    if (more) {
      wgmma_wait<1>();  // S(j + 1); P.V(j) runs on
      fence_regs<NS>(sc);
      softmax(j + 1);
    }
    wgmma_wait<0>();
    fence_regs<NO>(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + j % R);
    if (more) pack_p();
  };
  // PP (ping-pong, as FlashAttention-3): the warpgroups issue their products
  // in turn, so that one's softmax runs while another's products do; the
  // last warpgroup opens the first turn.
  if (PP && wg == NWG - 1) named_arrive(1, 256);
  for (int j = 0; j + 1 < ntiles; ++j) tile(j, true);
  tile(ntiles - 1, false);

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float inv = 1.f / quad_sum(l[hh]);
    const int row = q0 + warp * 16 + g + 8 * hh;
    if (row >= a.lq) continue;
    bf16* orow = a.o + b * a.so.b + row * a.so.l + h * a.so.h;
#pragma unroll
    for (int c = 0; c < VCH; ++c)
      store_pair(orow, c * 8 + 2 * t, a.d, o[4 * c + 2 * hh] * inv, o[4 * c + 2 * hh + 1] * inv);
  }
}

// ---- 256 < d <= 512: output columns split across warps, P through shared memory ----
// DK: d padded to 512; BK: K/V rows per tile. 8 warps, 64 query
// rows. blockIdx.z is the K/V split: tiles [z * tiles_per_split, ...).
constexpr int kWideQ = 64;
constexpr int kWideThreads = 256;

template <int DK, int BK>
__host__ __device__ constexpr int wide_smem_bytes() {
  return (kWideQ + 2 * BK) * (DK + 8) * 2 + kWideQ * (BK + 8) * 2 + 3 * kWideQ * 4;
}

template <int DK, int BK>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_wide(const Args a) {
  constexpr int BQ = kWideQ, SR = DK + 8, PR = BK + 8;
  constexpr int NC = BK / 2, NT = NC / 8;  // S: 16 rows x NC columns a warp
  constexpr int WC = DK / 8, NO = WC / 8;  // P.V: 64 rows x WC output columns a warp
  extern __shared__ __align__(128) uint8_t smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + BQ * SR;
  bf16* vs = ks + BK * SR;
  bf16* ps = vs + BK * SR;
  float* red = reinterpret_cast<float*>(ps + BQ * PR);  // [2][BQ]: per-half row max, then l
  float* rowv = red + 2 * BQ;                          // [BQ]: correction, then m

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3;
  const int mw = warp & 3, nw = warp >> 2;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh - b * a.heads;
  const bf16* qb = a.q + b * a.sq.b + h * a.sq.h;
  const bf16* kb = a.k + b * a.sk.b + h * a.sk.h;
  const bf16* vb = a.v + b * a.sv.b + h * a.sv.h;
  const int ntiles = (a.lk + BK - 1) / BK;
  const int j0 = blockIdx.z * a.tiles_per_split;
  const int j1 = min(j0 + a.tiles_per_split, ntiles);
  const int ksteps = (a.d + 15) / 16;

  auto load_kv = [&](bf16* dst, const bf16* src, long long ls, int j) {
    const int k0 = j * BK;
    load_rows<BK, DK, kWideThreads>(dst, src, ls, k0, min(BK, a.lk - k0), a.d, a.vec, tid);
  };
  load_rows<BQ, DK, kWideThreads>(qs, qb, a.sq.l, q0, min(BQ, a.lq - q0), a.d, a.vec, tid);
  cp_async_commit();
  load_kv(ks, kb, a.sk.l, j0);
  cp_async_commit();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[4][NO][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;

  for (int j = j0; j < j1; ++j) {
    cp_async_wait<0>();  // K(j) has landed (for this thread) ...
    __syncthreads();     // ... for all; P.V(j - 1) is done with V and P
    load_kv(vs, vb, a.sv.l, j);
    cp_async_commit();

    // S = Q.K^T: rows 16 mw.., columns NC nw..
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < ksteps; ++kk) {
      uint32_t qa[4];
      ldmatrix_x4(qa, qs + (mw * 16 + (lane & 15)) * SR + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, ks + (nw * NC + np * 16 + (mi >> 1) * 8 + (lane & 7)) * SR + kk * 16 +
                           (mi & 1) * 8);
        mma(s[2 * np], qa, r);
        mma(s[2 * np + 1], qa, r + 2);
      }
    }
    const int k0 = j * BK;
    if (k0 + BK > a.lk) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + nw * NC + n * 8 + 2 * t + (e & 1) >= a.lk) s[n][e] = -INFINITY;
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * hh], s[n][2 * hh + 1]));
      mx = quad_max(mx);
      if (t == 0) red[nw * BQ + mw * 16 + g + 8 * hh] = mx;
    }
    __syncthreads();  // every warp is done with K(j)
    if (j + 1 < j1) load_kv(ks, kb, a.sk.l, j + 1);
    cp_async_commit();

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = mw * 16 + g + 8 * hh;
      const float mx = fmaxf(m[hh], fmaxf(red[row], red[BQ + row]));  // finite: a split's
      const float ms = mx * a.sl2;                                     // first key is real
      const float corr = ex2(m[hh] * a.sl2 - ms);
      m[hh] = mx;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float p0 = ex2(fmaf(s[n][2 * hh], a.sl2, -ms));
        const float p1 = ex2(fmaf(s[n][2 * hh + 1], a.sl2, -ms));
        sum += p0 + p1;
        *reinterpret_cast<uint32_t*>(ps + row * PR + nw * NC + n * 8 + 2 * t) = pack_bf16(p0, p1);
      }
      l[hh] = l[hh] * corr + sum;
      if (nw == 0 && t == 0) rowv[row] = corr;
    }
    cp_async_wait<1>();  // V(j) has landed; K(j + 1) may be in flight
    __syncthreads();

    // O = O * corr + P.V: all 64 rows, columns WC warp..
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float c = rowv[mt * 16 + g + 8 * hh];
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          acc[mt][n][2 * hh] *= c;
          acc[mt][n][2 * hh + 1] *= c;
        }
      }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(pa[mt], ps + (mt * 16 + (lane & 15)) * PR + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vs + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * SR + warp * WC +
                                 dp * 16 + (mi >> 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma(acc[mt][2 * dp], pa[mt], r);
          mma(acc[mt][2 * dp + 1], pa[mt], r + 2);
        }
      }
    }
  }
  cp_async_wait<0>();

  // l and m of each row to shared memory for the output warps
  __syncthreads();  // every warp has read rowv and P
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = mw * 16 + g + 8 * hh;
    const float lt = quad_sum(l[hh]);
    if (t == 0) {
      red[nw * BQ + row] = lt;
      if (nw == 0) rowv[row] = m[hh];
    }
  }
  __syncthreads();

  const long long bh_rows = (long long)bh * a.lq;
  const long long split_rows = (long long)blockIdx.z * gridDim.y * a.lq;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = mt * 16 + g + 8 * hh, row = q0 + r;
      if (row >= a.lq) continue;
      const float lt = red[r] + red[BQ + r];
      const float inv = 1.f / lt;
      if (a.splits == 1) {
        bf16* orow = a.o + b * a.so.b + row * a.so.l + h * a.so.h;
#pragma unroll
        for (int n = 0; n < NO; ++n)
          store_pair(orow, warp * WC + n * 8 + 2 * t, a.d, acc[mt][n][2 * hh] * inv,
                     acc[mt][n][2 * hh + 1] * inv);
      } else {
        const long long prow = split_rows + bh_rows + row;
        float* orow = a.part_o + prow * DK;
#pragma unroll
        for (int n = 0; n < NO; ++n)
          *reinterpret_cast<float2*>(orow + warp * WC + n * 8 + 2 * t) =
              make_float2(acc[mt][n][2 * hh] * inv, acc[mt][n][2 * hh + 1] * inv);
        if (warp == 0 && t == 0) a.part_lse[prow] = rowv[r] * a.sl2 + __log2f(lt);
      }
    }
}

constexpr int kMaxSplits = 4;

// Merge the K/V splits of flash_wide: one block per (bh, query row).
__global__ void __launch_bounds__(128)
flash_merge(const Args a, int bh_total, int dk) {
  const int prow = blockIdx.x;
  const int bh = prow / a.lq, row = prow - bh * a.lq;
  const int b = bh / a.heads, h = bh - b * a.heads;
  const long long split_rows = (long long)bh_total * a.lq;
  float mx = -INFINITY;
  for (int s = 0; s < a.splits; ++s) mx = fmaxf(mx, a.part_lse[s * split_rows + prow]);
  float w[kMaxSplits], den = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    w[s] = s < a.splits ? ex2(a.part_lse[s * split_rows + prow] - mx) : 0.f;
    den += w[s];
  }
  bf16* orow = a.o + b * a.so.b + row * a.so.l + h * a.so.h;
  for (int c = threadIdx.x; c < a.d; c += blockDim.x) {
    float num = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < a.splits) num += w[s] * a.part_o[(s * split_rows + prow) * dk + c];
    orow[c] = __float2bfloat16(num / den);
  }
}

// ---- f32 route, d <= 64: the SIMT kernel -----------------------------------------
// Contiguous (BH, L, D) f32. Every block owns one (bh, BQ-row) query tile,
// streams K and V through shared memory in BK-row tiles and keeps the
// online softmax in f32 registers; both products on the f32 FMA pipes, with
// each thread holding a TR x TC block of scores and a TR x (D/16) block of
// outputs (64 x 64 tiles).

constexpr int kSimtThreads = 256;

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

template <int BQ, int BK>
__host__ __device__ constexpr int simt_smem_floats(int d) {
  return d * (BQ + 4) + (d * (BK + 4) > BK * d ? d * (BK + 4) : BK * d) + BQ * (BK + 4);
}

template <int BQ, int BK, int DMAX>
__global__ void __launch_bounds__(kSimtThreads)
flash_simt_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int lq, int lk, int d,
               float scale) {
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
  const float* qb = q + bh * lq * d;
  const float* kb = k + bh * lk * d;
  const float* vb = v + bh * lk * d;

  for (int i = tid; i < BQ * d; i += kSimtThreads) {
    const int r = i / d, c = i - r * d;
    const float x = (q0 + r < lq) ? qb[(size_t)(q0 + r) * d + c] : 0.f;
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
    for (int i = tid; i < BK * d; i += kSimtThreads) {
      const int r = i / d, c = i - r * d;
      kv[c * KS + r] = (r < kn) ? kb[(size_t)(k0 + r) * d + c] : 0.f;
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

    for (int i = tid; i < BK * d; i += kSimtThreads) {
      const int r = i / d, c = i - r * d;
      kv[r * d + c] = (r < kn) ? vb[(size_t)(k0 + r) * d + c] : 0.f;
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
    float* orow = o + (bh * lq + row) * d;
#pragma unroll
    for (int j = 0; j < DG; ++j) {
      const int dd = cg + 16 * j;
      if (dd < d) orow[dd] = acc[r][j] * inv;
    }
  }
}

// ---- f32 route, 64 < d <= 512: register tiles on the FMA pipes (see the top) ----
// Contiguous (BH, L, D) f32, d <= kF32D. blockIdx.z is the K/V split, as in
// flash_wide. The scores are kept in the log2 domain (Q is scaled by
// scale * log2 e as it is staged), so the partials' lse is m + log2 l.
constexpr int kF32Q = 64;         // query rows a block: 8 a warp
constexpr int kF32K = 128;        // keys a tile: 4 a lane
constexpr int kF32D = 512;        // the widest head dim; O is 8 x 16 a lane at any d
constexpr int kF32DC = 32;        // depth of a K chunk
constexpr int kF32VC = 8;         // keys of a V chunk
constexpr int kF32Threads = 256;
constexpr int kF32QS = kF32Q + 4;   // Q^T row stride: 16-byte rows, 4-way at most on the store
constexpr int kF32KS = kF32DC + 4;  // K chunk row stride: lanes 8 apart land on other banks
constexpr int kF32Buf = kF32K * kF32KS > kF32VC * kF32D ? kF32K * kF32KS : kF32VC * kF32D;
constexpr int kF32Ring = 3;         // chunk t + 2 loads while chunk t is read
constexpr int kF32SmemBytes =
    (kF32D * kF32QS + (kF32Threads / 32) * kF32K * 8 + kF32Ring * kF32Buf) * 4;
static_assert(kF32SmemBytes <= 232448, "flash_f32's shared memory exceeds what a block may use");

struct F32Args {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* part_o;    // (splits, BH, lq, kF32D) partial outputs O / l, or null
  float* part_lse;  // (splits, BH, lq) partial m + log2 l, or null
  int lq, lk, d;
  int vec;          // d a multiple of 4 and 16-byte bases: cp.async rows
  int splits, tiles_per_split;
  float sl2;        // softmax scale * log2(e)
};

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float f4(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

__global__ void __launch_bounds__(kF32Threads, 1)
flash_f32(const F32Args a) {
  extern __shared__ __align__(16) float fsm[];
  float* qt = fsm;                       // [kF32D][kF32QS]: Q^T * sl2
  float* pt = qt + kF32D * kF32QS;       // [warp][kF32K][8]: P^T of each warp's rows
  float* ring = pt + (kF32Threads / 32) * kF32K * 8;  // kF32Ring chunks

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kF32Q;
  const long long bh = blockIdx.y;
  const float* qb = a.q + bh * a.lq * a.d;
  const float* kb = a.k + bh * a.lk * a.d;
  const float* vb = a.v + bh * a.lk * a.d;
  const int nkc = (a.d + kF32DC - 1) / kF32DC;    // K chunks a tile
  const int per_tile = nkc + kF32K / kF32VC;      // chunks a tile: K's, then V's
  const int ntiles = (a.lk + kF32K - 1) / kF32K;
  const int j0 = blockIdx.z * a.tiles_per_split;
  const int j1 = min(j0 + a.tiles_per_split, ntiles);
  const int nchunks = (j1 - j0) * per_tile;

  // chunk t into its ring slot: cp.async where rows are 16-byte aligned, else
  // plain loads (visible after the barrier that precedes its use); zero past
  // the sequence and past d
  auto load_chunk = [&](int t) {
    float* dst = ring + (t % kF32Ring) * kF32Buf;
    const int k0 = (j0 + t / per_tile) * kF32K, u = t % per_tile;
    if (u < nkc) {  // K rows k0.., depth u kF32DC..
      const int c0 = u * kF32DC;
      for (int i = tid; i < kF32K * kF32DC / 4; i += kF32Threads) {
        const int r = i / (kF32DC / 4), c = c0 + 4 * (i % (kF32DC / 4));
        float* sp = dst + r * kF32KS + (c - c0);
        const float* gp = kb + (long long)(k0 + r) * a.d + c;
        if (a.vec) {
          const bool ok = k0 + r < a.lk && c < a.d;
          cp_async16(sp, ok ? gp : kb, ok);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) sp[e] = k0 + r < a.lk && c + e < a.d ? gp[e] : 0.f;
        }
      }
    } else {  // V rows r0.., every column
      const int r0 = k0 + (u - nkc) * kF32VC;
      for (int i = tid; i < kF32VC * kF32D / 4; i += kF32Threads) {
        const int r = i / (kF32D / 4), c = 4 * (i % (kF32D / 4));
        float* sp = dst + r * kF32D + c;
        const float* gp = vb + (long long)(r0 + r) * a.d + c;
        if (a.vec) {
          const bool ok = r0 + r < a.lk && c < a.d;
          cp_async16(sp, ok ? gp : vb, ok);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) sp[e] = r0 + r < a.lk && c + e < a.d ? gp[e] : 0.f;
        }
      }
    }
  };

  load_chunk(0);
  cp_async_commit();
  if (nchunks > 1) load_chunk(1);
  cp_async_commit();
  // Q^T, scaled, zero past lq and past d (depth rows up to nkc kF32DC)
  for (int i = tid; i < kF32Q * nkc * kF32DC; i += kF32Threads) {
    const int r = i / (nkc * kF32DC), c = i - r * (nkc * kF32DC);
    qt[c * kF32QS + r] = q0 + r < a.lq && c < a.d ? qb[(long long)(q0 + r) * a.d + c] * a.sl2
                                                  : 0.f;
  }

  // chunk t has landed for every thread, chunk t - 1's slot is free: load t + 2
  auto begin_chunk = [&](int t) -> const float* {
    cp_async_wait<1>();
    __syncthreads();
    if (t + 2 < nchunks) load_chunk(t + 2);
    cp_async_commit();
    return ring + (t % kF32Ring) * kF32Buf;
  };

  float o[8][16], m[8], l[8];  // l: this lane's share of each row's sum
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 16; ++c) o[r][c] = 0.f;
  }
  const float* qw = qt + warp * 8;            // this warp's 8 query rows
  float* pw = pt + warp * kF32K * 8;          // and their P^T
  int t = 0;
  for (int j = j0; j < j1; ++j) {
    // S = Q.K^T: rows 8 warp.., keys lane + 32 i
    float s[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[r][i] = 0.f;
    for (int u = 0; u < nkc; ++u, ++t) {
      const float* kc = begin_chunk(t);
      const float* qc = qw + u * kF32DC * kF32QS;
#pragma unroll 2
      for (int cc = 0; cc < kF32DC; cc += 4) {
        float4 kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) kv[i] = lds4(kc + (lane + 32 * i) * kF32KS + cc);
#pragma unroll
        for (int dd = 0; dd < 4; ++dd) {
          const float4 qa = lds4(qc + (cc + dd) * kF32QS), qz = lds4(qc + (cc + dd) * kF32QS + 4);
          const float qr[8] = {qa.x, qa.y, qa.z, qa.w, qz.x, qz.y, qz.z, qz.w};
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int i = 0; i < 4; ++i) s[r][i] = fmaf(qr[r], f4(kv[i], dd), s[r][i]);
        }
      }
    }
    // the online softmax of this tile; a row's 128 scores are this warp's
    const int k0 = j * kF32K;
    if (k0 + kF32K > a.lk) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (k0 + lane + 32 * i >= a.lk)
#pragma unroll
          for (int r = 0; r < 8; ++r) s[r][i] = -INFINITY;
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float mx = fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3]));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[r], mx);  // finite: a split's first key is real
      const float corr = exp2f(m[r] - mn);
      m[r] = mn;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[r][i] = exp2f(s[r][i] - mn);
        sum += s[r][i];
      }
      l[r] = l[r] * corr + sum;
#pragma unroll
      for (int c = 0; c < 16; ++c) o[r][c] *= corr;
    }
    // P^T to this warp's slice (the barrier of the next chunk orders it
    // after the last tile's reads and before this tile's)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* p = pw + (lane + 32 * i) * 8;
      *reinterpret_cast<float4*>(p) = make_float4(s[0][i], s[1][i], s[2][i], s[3][i]);
      *reinterpret_cast<float4*>(p + 4) = make_float4(s[4][i], s[5][i], s[6][i], s[7][i]);
    }
    // O += P.V: rows 8 warp.., columns 128 i + 4 lane + e
    for (int u = 0; u < kF32K / kF32VC; ++u, ++t) {
      const float* vc = begin_chunk(t);
      const float* pc = pw + u * kF32VC * 8;
#pragma unroll 2
      for (int kk = 0; kk < kF32VC; ++kk) {
        const float4 pa = lds4(pc + kk * 8), pz = lds4(pc + kk * 8 + 4);
        const float pr[8] = {pa.x, pa.y, pa.z, pa.w, pz.x, pz.y, pz.z, pz.w};
        float4 vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) vv[i] = lds4(vc + kk * kF32D + 128 * i + 4 * lane);
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              o[r][4 * i + e] = fmaf(pr[r], f4(vv[i], e), o[r][4 * i + e]);
      }
    }
  }
  cp_async_wait<0>();

  const long long rows = (long long)gridDim.y * a.lq;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float lt = l[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int row = q0 + warp * 8 + r;
    if (row >= a.lq) continue;
    const float inv = 1.f / lt;
    const long long prow = bh * a.lq + row;
    if (a.splits == 1) {
      float* orow = a.o + prow * a.d;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 128 * i + 4 * lane + e;
          if (c < a.d) orow[c] = o[r][4 * i + e] * inv;
        }
    } else {
      const long long srow = blockIdx.z * rows + prow;
      float* orow = a.part_o + srow * kF32D;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(orow + 128 * i + 4 * lane) =
            make_float4(o[r][4 * i] * inv, o[r][4 * i + 1] * inv, o[r][4 * i + 2] * inv,
                        o[r][4 * i + 3] * inv);
      if (lane == 0) a.part_lse[srow] = m[r] + __log2f(lt);
    }
  }
}

// Merge the K/V splits of flash_f32: one block per (bh, query row).
__global__ void __launch_bounds__(128)
flash_merge_f32(const F32Args a, int rows) {
  const long long prow = blockIdx.x;
  float mx = -INFINITY;
  for (int s = 0; s < a.splits; ++s) mx = fmaxf(mx, a.part_lse[s * (long long)rows + prow]);
  float w[kMaxSplits], den = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    w[s] = s < a.splits ? exp2f(a.part_lse[s * (long long)rows + prow] - mx) : 0.f;
    den += w[s];
  }
  float* orow = a.o + prow * a.d;
  for (int c = threadIdx.x; c < a.d; c += blockDim.x) {
    float num = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < a.splits) num += w[s] * a.part_o[(s * (long long)rows + prow) * kF32D + c];
    orow[c] = num / den;
  }
}

// ---- host side ---------------------------------------------------------------

// Above 48 KB a block's shared memory must be asked for: once per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// K/V splits of flash_wide and flash_f32 (bq query rows a block): as many as
// fill the SMs, at most kMaxSplits, none empty. force > 0 asks for that many
// (capped the same way).
void split_plan(int bh, int lq, int lk, int bq, int bk, int force, int* splits, int* per) {
  const int blocks = bh * ((lq + bq - 1) / bq);
  const int ntiles = (lk + bk - 1) / bk;
  int want = force > 0 ? force : sm_count() / blocks;
  want = want < 1 ? 1 : (want > kMaxSplits ? kMaxSplits : want);
  *per = (ntiles + want - 1) / want;
  *splits = (ntiles + *per - 1) / *per;
}

template <int DK, int BK>
int launch_wide(Args a, int bh, int force_splits, void* scratch, cudaStream_t s) {
  constexpr int bytes = wide_smem_bytes<DK, BK>();
  static const cudaError_t attr = allow_smem(flash_wide<DK, BK>, bytes);
  if (attr != cudaSuccess) return (int)attr;
  split_plan(bh, a.lq, a.lk, kWideQ, BK, force_splits, &a.splits, &a.tiles_per_split);
  if (a.splits > 1) {
    if (!scratch) return (int)cudaErrorInvalidValue;
    a.part_o = static_cast<float*>(scratch);
    a.part_lse = a.part_o + (long long)a.splits * bh * a.lq * DK;
  }
  const dim3 grid((a.lq + kWideQ - 1) / kWideQ, bh, a.splits);
  flash_wide<DK, BK><<<grid, kWideThreads, bytes, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return (int)e;
  flash_merge<<<bh * a.lq, 128, 0, s>>>(a, bh, DK);
  return (int)cudaGetLastError();
}

// K or V, a (batch, len, heads, d) view with 16-byte rows, as a TMA map for
// flash_wg. sw32 = 0: 5-d, each row viewed as d / 8 chunks of 8 columns 16
// bytes apart, with a box of `rows` rows x every chunk: it lands chunk-major,
// [chunk][row][8 columns], no swizzle. sw32 = 1 (d a multiple of 16): the same
// with planes of 16 columns, 32 bytes apart, and the 32-byte swizzle. sw32 = 2:
// 4-d, a box of 16 columns x `rows` rows (a plane), the 32-byte swizzle; a box
// reaching past d is zero-filled. Each 32-byte row of a plane is one whole
// sector; an 8-column box reads half of each sector it touches, twice. The
// strides of dimensions of size 1 are made up. False if the encoding fails.
bool make_tmap(CUtensorMap* m, const void* base, const Strides& st, int batch, int len,
               int heads, int d, int rows, int sw32) {
  const TmapEncode enc = tmap_encode();
  if (!enc) return false;
  const cuuint64_t sl = len > 1 ? st.l * 2 : ((cuuint64_t)d * 2 + 15) / 16 * 16;
  const cuuint64_t sh = heads > 1 ? st.h * 2 : sl * len;
  const cuuint64_t sb = batch > 1 ? st.b * 2 : sh * heads;
  if (sw32 == 1) {  // 5-d, pairs of chunks, one box a tile
    const cuuint32_t pairs = d / 16;
    const cuuint64_t dims[5] = {16, (cuuint64_t)len, pairs, (cuuint64_t)heads, (cuuint64_t)batch};
    const cuuint64_t strides[4] = {sl, 32, sh, sb};
    const cuuint32_t box[5] = {16, (cuuint32_t)rows, pairs, 1, 1}, elem[5] = {1, 1, 1, 1, 1};
    return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base), dims, strides,
               box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
           CUDA_SUCCESS;
  }
  if (sw32 == 2) {  // 4-d, one box a pair of chunks
    const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)len, (cuuint64_t)heads,
                                (cuuint64_t)batch};
    const cuuint64_t strides[3] = {sl, sh, sb};
    const cuuint32_t box[4] = {16, (cuuint32_t)rows, 1, 1}, elem[4] = {1, 1, 1, 1};
    return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
               box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
           CUDA_SUCCESS;
  }
  const cuuint32_t chunks = (d + 7) / 8;
  const cuuint64_t dims[5] = {8, (cuuint64_t)len, chunks, (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[4] = {sl, 16, sh, sb};
  const cuuint32_t box[5] = {8, (cuuint32_t)rows, chunks, 1, 1}, elem[5] = {1, 1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// SW32: K and V tiles in the 32-byte swizzle, one box a tile where d is a
// multiple of 16, else one a 16-column plane (TMA zero-fills past d)
template <int DK, int DV, int BK, int R, int NWG, bool PP = false, bool SW32 = false>
int launch_wg(Args a, int bh, cudaStream_t s) {
  static_assert(!SW32 || (DK % 16 == 0 && DV % 16 == 0), "the swizzle takes 16-column planes");
  constexpr int bytes = wg_smem_bytes<DK, DV, BK, R, NWG>();
  static const cudaError_t attr = allow_smem(flash_wg<DK, DV, BK, R, NWG, PP, SW32>, bytes);
  if (attr != cudaSuccess) return (int)attr;
  a.splits = 1;
  a.box5 = SW32 && a.d % 16 == 0;
  const int mode = !SW32 ? 0 : (a.box5 ? 1 : 2);
  CUtensorMap tmk{}, tmv{};
  const int batch = bh / a.heads;
  if (a.vec && !(make_tmap(&tmk, a.k, a.sk, batch, a.lk, a.heads, a.d, BK, mode) &&
                 make_tmap(&tmv, a.v, a.sv, batch, a.lk, a.heads, a.d, BK, mode)))
    return (int)cudaErrorNotSupported;
  const dim3 grid((a.lq + 64 * NWG - 1) / (64 * NWG), bh);
  flash_wg<DK, DV, BK, R, NWG, PP, SW32><<<grid, 128 * NWG, bytes, s>>>(a, tmk, tmv);
  return (int)cudaGetLastError();
}

// flash_wg for 64 < d <= 256 at the default tiles of its padded head dim:
// four warpgroups up to DK = 80, three up to 128, two above (O takes DK / 2
// registers a thread beside S's 32), issuing in turns (ping-pong); 64-row
// K/V tiles up to DK = 176, 32-row above (Q and 4 ring stages within 227 KB)
template <int DK>
int launch_mid(Args a, int bh, cudaStream_t s) {
  constexpr int NWG = DK <= 80 ? 4 : (DK <= 128 ? 3 : 2), BK = DK <= 176 ? 64 : 32;
  static_assert(wg_smem_bytes<DK, DK, BK, 4, NWG>() <= 232448, "flash_wg tiles exceed 227 KB");
  return launch_wg<DK, DK, BK, 4, NWG, true, true>(a, bh, s);
}

int padded_dim(int d) {
  if (d <= 256) return (d + 15) / 16 * 16;
  return 512;
}

// The three bf16 kernels by head dim: 0 flash_wg (d <= 64), 1 flash_wg
// (64 < d <= 256), 2 flash_wide (d <= 512)
int kind_of(int d) { return d <= 64 ? 0 : (d <= 256 ? 1 : 2); }

// The tile variants. -1 picks by head dim (kDefault[kind]); a variant with
// dk = 0 takes any head dim of its kind, the others exist at one padded head
// dim each, for the sweep.
struct Variant {
  const char* name;
  int kind;    // kind_of(d) it takes
  int dk;      // the padded head dim it is compiled for (0: any)
  int bk;      // K/V rows a tile
  int splits;  // flash_wide: 0 = fill the SMs
};
constexpr Variant kVariants[] = {
    {"small wgmma bq256 bk64 ring4 pingpong", 0, 0, 64, 0},   // 0: the default for d <= 64
    {"small wgmma bq256 bk64 ring5", 0, 48, 64, 0},           // 1
    {"small wgmma bq128 bk64 ring4", 0, 48, 64, 0},           // 2
    {"small wgmma bq128 bk128 ring4", 0, 48, 128, 0},         // 3
    {"small wgmma bq192 bk128 ring4", 0, 48, 128, 0},         // 4
    {"small wgmma bq256 bk64 ring4", 0, 48, 64, 0},           // 5
    {"mid wgmma by head dim", 1, 0, 0, 0},                    // 6: the default for d <= 256
    {"mid wgmma d80 bq256 bk64 ring4", 1, 80, 64, 0},         // 7: no ping-pong
    {"mid wgmma d80 bq256 bk64 ring5 pingpong", 1, 80, 64, 0},  // 8
    {"mid wgmma d160 bq64 bk64 ring4 2 blocks an SM", 1, 160, 64, 0},  // 9
    {"mid wgmma d160 bq128 bk32 ring6 pingpong", 1, 160, 32, 0},  // 10
    {"wide bq64 bk64 split auto", 2, 0, 64, 0},               // 11: the default for d > 256
    {"wide bq64 bk64 split 1", 2, 512, 64, 1},                // 12
    {"wide bq64 bk32 split auto", 2, 512, 32, 0},             // 13
    {"wide bq64 bk32 split 1", 2, 512, 32, 1},                // 14
    {"mid wgmma d80 no swizzle", 1, 80, 64, 0},               // 15: 8-column boxes
    {"mid wgmma d160 no swizzle", 1, 160, 64, 0},             // 16
};
constexpr int kNumVariants = sizeof(kVariants) / sizeof(kVariants[0]);
constexpr int kDefault[3] = {0, 6, 11};

// Resolve `variant` for head dim d; -1 when it does not apply.
int resolve(int variant, int d) {
  if (d < 1 || d > 512) return -1;
  if (variant < 0) return kDefault[kind_of(d)];
  if (variant >= kNumVariants) return -1;
  const Variant& v = kVariants[variant];
  if (v.kind != kind_of(d)) return -1;
  if (v.dk != 0 && v.dk != padded_dim(d)) return -1;
  return variant;
}

// flash_wg at d padded to 48: P.V 40 wide up to d = 40
template <int BK, int R, int NWG, bool PP = false>
int launch_wg48(Args a, int bh, cudaStream_t s) {
  return a.d <= 40 ? launch_wg<48, 40, BK, R, NWG, PP>(a, bh, s)
                   : launch_wg<48, 48, BK, R, NWG, PP>(a, bh, s);
}

int run(int variant, Args a, int bh, void* scratch, cudaStream_t s) {
  const int dk = padded_dim(a.d);
  switch (variant) {
    case 0:
      switch (dk) {
        case 16: return launch_wg<16, 16, 64, 4, 4, true>(a, bh, s);
        case 32: return launch_wg<32, 32, 64, 4, 4, true>(a, bh, s);
        case 48: return launch_wg48<64, 4, 4, true>(a, bh, s);
        default: return launch_wg<64, 64, 64, 4, 4, true>(a, bh, s);
      }
    case 1: return launch_wg48<64, 5, 4>(a, bh, s);
    case 2: return launch_wg48<64, 4, 2>(a, bh, s);
    case 3: return launch_wg48<128, 4, 2>(a, bh, s);
    case 4: return launch_wg48<128, 4, 3>(a, bh, s);
    case 5: return launch_wg48<64, 4, 4>(a, bh, s);
    case 6:
      switch (dk) {
        case 80: return launch_mid<80>(a, bh, s);
        case 96: return launch_mid<96>(a, bh, s);
        case 112: return launch_mid<112>(a, bh, s);
        case 128: return launch_mid<128>(a, bh, s);
        case 144: return launch_mid<144>(a, bh, s);
        case 160: return launch_mid<160>(a, bh, s);
        case 176: return launch_mid<176>(a, bh, s);
        case 192: return launch_mid<192>(a, bh, s);
        case 208: return launch_mid<208>(a, bh, s);
        case 224: return launch_mid<224>(a, bh, s);
        case 240: return launch_mid<240>(a, bh, s);
        default: return launch_mid<256>(a, bh, s);
      }
    case 7: return launch_wg<80, 80, 64, 4, 4, false, true>(a, bh, s);
    case 8: return launch_wg<80, 80, 64, 5, 4, true, true>(a, bh, s);
    case 9: return launch_wg<160, 160, 64, 4, 1, false, true>(a, bh, s);
    case 10: return launch_wg<160, 160, 32, 6, 2, true, true>(a, bh, s);
    case 11: return launch_wide<512, 64>(a, bh, 0, scratch, s);
    case 12: return launch_wide<512, 64>(a, bh, 1, scratch, s);
    case 13: return launch_wide<512, 32>(a, bh, 0, scratch, s);
    case 14: return launch_wide<512, 32>(a, bh, 1, scratch, s);
    case 15: return launch_wg<80, 80, 64, 4, 4, true>(a, bh, s);
    case 16: return launch_wg<160, 160, 64, 4, 2, true>(a, bh, s);
  }
  return (int)cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int BQ, int BK, int DMAX>
int launch_simt(const float* q, const float* k, const float* v, float* o, int bh, int lq,
                int lk, int d, float scale, cudaStream_t stream) {
  auto kernel = flash_simt_f32<BQ, BK, DMAX>;
  static const cudaError_t attr =
      allow_smem(kernel, simt_smem_floats<BQ, BK>(DMAX) * (int)sizeof(float));
  if (attr != cudaSuccess) return (int)attr;
  const int bytes = simt_smem_floats<BQ, BK>(d) * (int)sizeof(float);
  const dim3 grid((lq + BQ - 1) / BQ, bh);
  kernel<<<grid, kSimtThreads, bytes, stream>>>(q, k, v, o, lq, lk, d, scale);
  return (int)cudaGetLastError();
}

int launch_f32(F32Args a, int bh, void* scratch, cudaStream_t s) {
  static const cudaError_t attr = allow_smem(flash_f32, kF32SmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  split_plan(bh, a.lq, a.lk, kF32Q, kF32K, 0, &a.splits, &a.tiles_per_split);
  if (a.splits > 1) {
    if (!scratch) return (int)cudaErrorInvalidValue;
    a.part_o = static_cast<float*>(scratch);
    a.part_lse = a.part_o + (long long)a.splits * bh * a.lq * kF32D;
  }
  const dim3 grid((a.lq + kF32Q - 1) / kF32Q, bh, a.splits);
  flash_f32<<<grid, kF32Threads, kF32SmemBytes, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return (int)e;
  flash_merge_f32<<<bh * a.lq, 128, 0, s>>>(a, bh * a.lq);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 attention over strided views. q (batch, lq, heads, d), k and v
// (batch, lk, heads, d), o (batch, lq, heads, d), each with unit d stride;
// strides[12]: the element strides of batch, sequence and head of q, k, v, o
// (0 for a dimension of size 1). scratch: sr_flash_attention_bf16_scratch
// bytes, or null when that is 0. variant: -1, or an index into the tile table
// (sr_flash_attention_bf16_variant). Returns a cudaError_t; 0 means accepted.
extern "C" int sr_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                       void* scratch, const long long* strides, int batch,
                                       int heads, int lq, int lk, int d, float scale,
                                       int variant, void* stream) {
  const int which = resolve(variant, d);
  if (which < 0 || batch < 1 || heads < 1 || lq < 1 || lk < 1) return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<bf16*>(o);
  Strides* st[4] = {&a.sq, &a.sk, &a.sv, &a.so};
  bool vec = d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  for (int i = 0; i < 4; ++i) {
    *st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
    if (i < 3) vec = vec && strides[3 * i] % 8 == 0 && strides[3 * i + 1] % 8 == 0 &&
                     strides[3 * i + 2] % 8 == 0;
  }
  a.heads = heads;
  a.lq = lq;
  a.lk = lk;
  a.d = d;
  a.vec = vec;
  a.sl2 = scale * 1.4426950408889634f;
  return run(which, a, batch * heads, scratch, static_cast<cudaStream_t>(stream));
}

// Scratch bytes sr_flash_attention_bf16 needs for these sizes (the K/V-split
// partials of flash_wide), or -1 if the variant does not apply.
extern "C" long long sr_flash_attention_bf16_scratch(int bh, int lq, int lk, int d,
                                                      int variant) {
  const int which = resolve(variant, d);
  if (which < 0 || bh < 1 || lq < 1 || lk < 1) return -1;
  if (kVariants[which].kind != 2) return 0;
  int splits, per;
  split_plan(bh, lq, lk, kWideQ, kVariants[which].bk, kVariants[which].splits, &splits, &per);
  if (splits == 1) return 0;
  return (long long)splits * bh * lq * (padded_dim(d) + 1) * (long long)sizeof(float);
}

// The tile variant that -1 picks for head dim d, or -1 outside 1..512.
extern "C" int sr_flash_attention_bf16_default(int d) { return resolve(-1, d); }

// The name of tile variant i, or null past the end of the table.
extern "C" const char* sr_flash_attention_bf16_variant(int i) {
  return i >= 0 && i < kNumVariants ? kVariants[i].name : nullptr;
}

// f32: contiguous (bh, l, d) tensors on the current device; scratch:
// sr_flash_attention_f32_scratch bytes, or null when that is 0.
extern "C" int sr_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                      void* scratch, int bh, int lq, int lk, int d, float scale,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  if (bh < 1 || lq < 1 || lk < 1 || d < 1 || d > kF32D) return (int)cudaErrorInvalidValue;
  if (d <= 64) return launch_simt<64, 64, 64>(qf, kf, vf, of, bh, lq, lk, d, scale, s);
  F32Args a{};
  a.q = qf;
  a.k = kf;
  a.v = vf;
  a.o = of;
  a.lq = lq;
  a.lk = lk;
  a.d = d;
  a.vec = d % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  a.sl2 = scale * 1.4426950408889634f;
  return launch_f32(a, bh, scratch, s);
}

// Scratch bytes sr_flash_attention_f32 needs for these sizes (flash_f32's
// K/V-split partials), or -1 outside its sizes.
extern "C" long long sr_flash_attention_f32_scratch(int bh, int lq, int lk, int d) {
  if (bh < 1 || lq < 1 || lk < 1 || d < 1 || d > kF32D) return -1;
  if (d <= 64) return 0;
  int splits, per;
  split_plan(bh, lq, lk, kF32Q, kF32K, 0, &splits, &per);
  if (splits == 1) return 0;
  return (long long)splits * bh * lq * (kF32D + 1) * (long long)sizeof(float);
}

// The kernel that sr_flash_attention_bf16 (variant -1) or, with f32,
// sr_flash_attention_f32 launches for head dim d; null outside 1..512.
extern "C" const char* sr_flash_attention_route(int d, int f32) {
  if (d < 1 || d > 512) return nullptr;
  if (f32) return d <= 64 ? "flash_simt_f32" : "flash_f32";
  const char* names[3] = {"flash_wg d<=64", "flash_wg 64<d<=256", "flash_wide"};
  return names[kind_of(d)];
}

extern "C" const char* sr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
