// Fused QuartzNet repeat-block sub-layer for Hopper (sm_90a): length-masked
// K-tap depthwise conv (fp32) -> mask -> bf16 1x1 GEMM with fp32
// accumulation -> + folded-BN bias [-> ReLU] [-> + masked residual 1x1
// GEMM (bf16, fp32 acc) + bias] -> ReLU, in one launch per repeat.
//
// Replaces: vietasr_tpu/ops/pallas_repeat.py::_kernel (the Pallas TPU
// kernel behind fused_repeat_block). It follows that kernel's numerics:
// fp32 depthwise over fp32 weights, masks before and after it, bf16
// operands into fp32-accumulated products, fp32 biases. A block with
// R > 1 repeats is R launches whose intermediates stay fp32 in device
// memory (the TPU kernel kept them fp32 in VMEM); the residual rides the
// last launch. QuartzNet12x1 has R = 1: one launch per block.
//
// What bounds it on the H100: at T = 840, B = 8 and 512 channels the two
// GEMMs are ~7 GFLOP of bf16 (7 us at 989 TFLOP/s), the depthwise 0.43
// GFLOP of fp32 on the CUDA cores (6.5 us at 67 TFLOP/s) and the bytes
// ~15 MB (4.5 us): operations bound it, split between the tensor cores
// and the CUDA cores. Every block multiplies its rows by the whole weight
// matrix, so the weights are read from L2 once per block: the number of
// rows a block owns sets the L2 traffic (1 MiB of bf16 weights per block
// for a 512 -> 512 block with its residual).
//
// Design. One block of 8 warps owns TT time rows of one batch row:
//   - TT = 64 by default (112 blocks at B = 8, T = 840: one wave on the
//     132 SMs, one block per SM). TT = 32 when the grid of 32-row blocks
//     fits in one wave, or when 64 rows do not fit in shared memory
//     (`tile_rows`). A 32-row grid that fits twice over splits an output
//     of two 256-column passes over two blocks per tile, each doing the
//     depthwise and one pass (`col_groups`).
//   - A block whose first row is at or past `len` loads and multiplies
//     nothing: it writes relu(b_pw [ReLU] + b_res) with the epilogue's
//     arithmetic. Partial tiles run in full.
//   - Depthwise, in channel chunks of CH = 64: the halo'd input rows
//     [t0 - K/2, t0 + TT + round8(K) - K/2) are staged in shared memory in
//     the input's own type (bf16 on the main path; widened in registers,
//     which is exact) with the chunk's K fp32 taps; each thread owns one
//     channel and TT/4 consecutive output rows and slides a register
//     window over the taps, 8 taps at a time, in ascending tap order
//     through fmaf. The masked result goes as bf16 into the GEMM's A tile.
//   - The GEMM streams [pw; res] through a ring of NSTAGE = 2 tiles of
//     KB = 64 weight rows x NC = 256 columns, filled with 16-byte cp.async
//     copies, one barrier per tile, as one sequence over the block's column
//     passes (the ring does not drain between passes). The depthwise
//     staging uses the ring's memory, so the ring's first tile is issued
//     when the depthwise is done; the residual rows' copies are issued
//     before it and land while it runs.
//   - Warps are 2 (rows) x 4 (columns), each with a (TT/2) x 64 tile of
//     m16n8k16 mma.sync products (bf16 in, fp32 sums in registers: 64 a
//     thread at TT = 64), operands read by ldmatrix (x4; .trans for the
//     row-major weights), every fragment of a 16-deep step before its
//     MMAs: TT/32 + 4 shared loads for TT/2 MMAs. When a ReLU sits between
//     the two products, it is applied to the sums where the residual's
//     tiles begin. The bias / ReLU epilogue works on the registers and
//     stores column pairs.
// Measured on an H100 80GB HBM3 at 700 W (one forward's 13 launches at
// B = 8, T = 840, ragged lengths, CUDA events; 32-row blocks, 128-column
// passes and fp32 staging took 0.87 ms): this design 0.72 ms, then 0.69
// with the ring's memory shared (medians of 6 interleaved runs: a ring of
// its own where it fit, K <= 51 at 512 channels, whose first tile landed
// during the depthwise, read 0.7217 vs 0.6856 ms, and 0.44 vs 0.42 ms on
// the grids of 2-4 rows x 304-552 frames); a 3-deep
// ring of 32-row weight tiles 0.81 (the ring's depth did not matter, the
// barriers per weight row did: with no weight loads at all the 32-row
// tiles' GEMM still took 50 of its 70 us at 512 channels); 16 warps of
// 16 rows 0.95; 32-row blocks small enough for two per SM 0.95;
// double-buffered fragments 0.75; a channel-major staging read 8 rows a
// load 0.77 (its stores cost more than its loads saved); fetching the
// next chunk's staging into registers during the depthwise changed
// nothing. Rows per block: 64 rows 0.72 vs 32 rows 0.96 at B = 8, T = 840;
// 32 rows 0.45 vs 0.71 at B = 2, T = 200, 0.57 vs 0.73 at B = 8, T = 420
// and 0.58 vs 0.73 at B = 4, T = 840 (both grids fit in one wave). The
// column split: 0.45 vs 0.59 ms at B = 2, T = 200.
// Rows t >= len come out as relu(b_pw + b_res), exactly as in the JAX
// package; later blocks mask them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CH = 64;          // depthwise channel chunk
constexpr int NC = 256;         // output channels per GEMM pass (4 warps x 64)
constexpr int NJ = 8;           // m16n8 fragments a warp holds per row tile
constexpr int KB = 64;          // weight rows per staged tile
constexpr int NSTAGE = 2;       // weight tiles in the ring
constexpr int THREADS = 256;
constexpr int PADH = 8;         // bf16 row padding of the A tiles
constexpr int LDB = NC + 8;     // bf16 row pitch of a staged weight tile
constexpr int TILE = KB * LDB;  // bf16 elements of one staged weight tile
constexpr int BATCH = 8;        // 16-byte loads a thread issues before use
constexpr size_t SMEM_MAX = 232448;   // shared memory one H100 block may use
constexpr int MAX_DEVICES = 64;

__host__ __device__ constexpr int round8(int v) { return (v + 7) & ~7; }

// Byte offsets of the shared-memory regions: the A tiles [a_dw | a_res],
// then the weight ring, whose memory the depthwise staging (input rows in
// their own type, then K x CH fp32 taps) uses before the GEMM starts.
struct Layout {
  size_t a_res, ring, taps, total;
};

__host__ __device__ inline Layout layout(int tt, int in_bytes, int cx, int cr,
                                         bool has_res, int k) {
  Layout l;
  const size_t ring = (size_t)NSTAGE * TILE * 2;
  const size_t stage = (size_t)(tt + round8(k)) * CH * in_bytes;
  const size_t taps = (size_t)k * CH * sizeof(float);
  l.a_res = (size_t)tt * (cx + PADH) * 2;
  l.ring = l.a_res + (has_res ? (size_t)tt * (cr + PADH) * 2 : 0);
  l.taps = l.ring + stage;
  l.total = l.ring + (stage + taps > ring ? stage + taps : ring);
  return l;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// two adjacent output columns
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// d (16 x 8, fp32) += a (16 x 16, bf16, row) x b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Start copying rows [kb, kb + KB) x cols [n0, n0 + NC) of W (K, co) into
// dst (zeros outside W) as one cp.async group.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* __restrict__ w,
                                          int kb, int K, int co, int n0) {
  static_assert(KB * (NC / 8) % THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int u = 0; u < KB * (NC / 8) / THREADS; ++u) {
    const int i = u * THREADS + threadIdx.x;
    const int r = i / (NC / 8);
    const int cc = (i - r * (NC / 8)) * 8;
    __nv_bfloat16* d = dst + r * LDB + cc;
    if (kb + r < K && n0 + cc < co)
      cp_async16(d, w + (size_t)(kb + r) * co + n0 + cc);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();
}

template <int TT, typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS, 64 / TT)
repeat_kernel(const Tin* __restrict__ x, const __nv_bfloat16* __restrict__ xres,
              const int* __restrict__ lens, const float* __restrict__ dw,
              const __nv_bfloat16* __restrict__ pw, const float* __restrict__ bias,
              const __nv_bfloat16* __restrict__ resw, const float* __restrict__ resb,
              Tout* __restrict__ out, int T, int cx, int co, int cr, int k,
              int act_z) {
  constexpr int MT = TT / 32;              // m16 row tiles per warp
  constexpr int RPT = TT * CH / THREADS;   // depthwise rows per thread
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Layout lay = layout(TT, sizeof(Tin), cx, cr, xres != nullptr, k);
  __nv_bfloat16* a_dw = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* a_res = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.a_res);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.ring);
  Tin* stage = reinterpret_cast<Tin*>(smem_raw + lay.ring);
  float* taps = reinterpret_cast<float*>(smem_raw + lay.taps);

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int len = min(lens[b], T);
  const int tid = threadIdx.x;

  // this block's column passes: p = grp, grp + ngrp, ... of NC columns
  const int grp = blockIdx.z, ngrp = gridDim.z;
  const int npass = ((co + NC - 1) / NC - grp + ngrp - 1) / ngrp;

  // 0. a tile of padding only: the epilogue's arithmetic on zero sums
  if (t0 >= len) {
    const int rows = min(TT, T - t0);
    const int half = co / 2;
    for (int i = tid; i < rows * half; i += THREADS) {
      const int r = i / half;
      const int col = (i - r * half) * 2;
      if ((col / NC) % ngrp != grp) continue;
      float z[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        z[e] = 0.f + bias[col + e];
        if (act_z) z[e] = fmaxf(z[e], 0.f);
        z[e] = fmaxf(z[e] + (xres ? resb[col + e] : 0.f), 0.f);
      }
      store2(out + ((size_t)b * T + t0 + r) * co + col, z[0], z[1]);
    }
    return;
  }

  // the weight tiles, one sequence over this block's passes: pass p is
  // [pw rows | res rows] x cols [p * NC, (p + 1) * NC)
  const int nt1 = (cx + KB - 1) / KB;
  const int ntp = nt1 + (xres ? (cr + KB - 1) / KB : 0);
  const int nt = ntp * npass;
  auto issue = [&](int g) {             // one cp.async group, empty past nt
    if (g >= nt) {
      cp_async_commit();
      return;
    }
    const int q = g / ntp, t = g - q * ntp;
    const int p = grp + q * ngrp;
    __nv_bfloat16* dst = ring + (g % NSTAGE) * TILE;
    if (t < nt1)
      load_tile(dst, pw, t * KB, cx, co, p * NC);
    else
      load_tile(dst, resw, (t - nt1) * KB, cr, co, p * NC);
  };
  // the masked residual input rows, a group older than any weight tile;
  // they land while the depthwise runs
  if (xres) {
    const int cpr = cr / 8;
    for (int i = tid; i < TT * cpr; i += THREADS) {
      const int r = i / cpr;
      const int cc = (i - r * cpr) * 8;
      const int t = t0 + r;
      __nv_bfloat16* d = a_res + r * (cr + PADH) + cc;
      if (t < len)
        cp_async16(d, xres + ((size_t)b * T + t) * cr + cc);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_commit();
  }

  // 1. depthwise, channel chunk by channel chunk
  const int k2 = k / 2;
  const int rows_st = TT + round8(k);
  const int lda = cx + PADH;
  constexpr int VEC = 16 / sizeof(Tin);
  constexpr int VPR = CH / VEC;         // 16-byte vectors per staged row
  const int c = tid % CH;
  const int r0 = (tid / CH) * RPT;
  for (int c0 = 0; c0 < cx; c0 += CH) {
    const int chn = min(CH, cx - c0);   // a multiple of 16
    const int nx = rows_st * VPR;
    for (int base = 0; base < nx; base += BATCH * THREADS) {
      uint4 v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = base + u * THREADS + tid;
        const int r = i / VPR;
        const int cc = (i - r * VPR) * VEC;
        const int g = t0 - k2 + r;
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < nx && cc < chn && g >= 0 && g < len)
          v[u] = __ldg(reinterpret_cast<const uint4*>(
              x + ((size_t)b * T + g) * cx + c0 + cc));
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {  // stage[r * CH + cc] = stage[i * VEC]
        const int i = base + u * THREADS + tid;
        if (i < nx) reinterpret_cast<uint4*>(stage)[i] = v[u];
      }
    }
    const int nw = k * (CH / 4);
    for (int base = 0; base < nw; base += BATCH * THREADS) {
      float4 w[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = base + u * THREADS + tid;
        const int j = i / (CH / 4);
        const int cc = (i - j * (CH / 4)) * 4;
        w[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < nw && cc < chn)
          w[u] = __ldg(reinterpret_cast<const float4*>(
              dw + (size_t)j * cx + c0 + cc));
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = base + u * THREADS + tid;
        if (i < nw) reinterpret_cast<float4*>(taps)[i] = w[u];
      }
    }
    __syncthreads();
    if (c < chn) {
      float acc[RPT], win[RPT + 8];
      const Tin* s = stage + r0 * CH + c;
      const float* wc = taps + c;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        acc[i] = 0.f;
        win[i] = to_float(s[i * CH]);
      }
      for (int j0 = 0; j0 < k; j0 += 8) {
        float wt[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          win[RPT + i] = to_float(s[(j0 + RPT + i) * CH]);
          wt[i] = (j0 + i < k) ? wc[(j0 + i) * CH] : 0.f;
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int i = 0; i < RPT; ++i)
            acc[i] = fmaf(win[i + jj], wt[jj], acc[i]);
#pragma unroll
        for (int i = 0; i < RPT; ++i) win[i] = win[i + 8];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int t = t0 + r0 + i;
        a_dw[(r0 + i) * lda + c0 + c] = __float2bfloat16(t < len ? acc[i] : 0.f);
      }
    }
    __syncthreads();
  }
  for (int g = 0; g < NSTAGE - 1; ++g) issue(g);   // the staging is done

  // 2. GEMMs + epilogue: the ring runs NSTAGE - 1 tiles ahead of the one
  //    in use, one barrier per tile
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / 4;              // rows wm * TT / 2
  const int wn = warp % 4;              // cols wn * 64 of the pass
  const int lrow = lane % 16, lcol = (lane / 16) * 8;   // ldmatrix address
  const bool relu_between = xres && act_z;
  float acc[MT][NJ][4];
  for (int g = 0; g < nt; ++g) {
    cp_async_wait<NSTAGE - 2>();        // tile g (and the residual rows)
    __syncthreads();                    // for all; tile g - 1 is consumed
    issue(g + NSTAGE - 1);              // into tile g - 1's buffer
    const int q = g / ntp, t = g - q * ntp;
    const int p = grp + q * ngrp;
    // this lane's outputs: columns cl + 8j + {0, 1}, rows rl + 16m + {0, 8}
    const int cl = p * NC + wn * 64 + 2 * (lane % 4);
    if (t == 0) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
    }
    if (relu_between && t == nt1) {     // ReLU(z + b) under the residual
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = cl + 8 * j;     // co is even: col + 1 < co too
        const float b0 = col < co ? bias[col] : 0.f;
        const float b1 = col < co ? bias[col + 1] : 0.f;
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[m][j][e] = fmaxf(acc[m][j][e] + ((e & 1) ? b1 : b0), 0.f);
      }
    }
    const bool first = t < nt1;
    const int k0 = (first ? t : t - nt1) * KB;
    const int ld = first ? lda : cr + PADH;
    const __nv_bfloat16* a =
        (first ? a_dw : a_res) + (wm * (TT / 2) + lrow) * ld + k0 + lcol;
    const __nv_bfloat16* bt =
        ring + (g % NSTAGE) * TILE + lrow * LDB + wn * 64 + lcol;
    const int kend = min(KB, (first ? cx : cr) - k0);   // a multiple of 16
#pragma unroll
    for (int kk = 0; kk < KB; kk += 16) {
      if (kk >= kend) break;
      // every fragment of the step first, then its MMAs
      unsigned fa[MT][4], fb[NJ / 2][4];   // fb[q]: columns 16q..16q+15
#pragma unroll
      for (int m = 0; m < MT; ++m) ldsm_x4(fa[m], a + m * 16 * ld + kk);
#pragma unroll
      for (int q = 0; q < NJ / 2; ++q)
        ldsm_x4_t(fb[q], bt + kk * LDB + q * 16);
#pragma unroll
      for (int q = 0; q < NJ / 2; ++q)
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16(acc[m][2 * q], fa[m], fb[q][0], fb[q][1]);
          mma_bf16(acc[m][2 * q + 1], fa[m], fb[q][2], fb[q][3]);
        }
    }
    if (t != ntp - 1) continue;
    // epilogue of pass p
    const int rl = t0 + wm * (TT / 2) + lane / 4;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = cl + 8 * j;
      if (col >= co) continue;
      float bz[2], br[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        bz[e] = bias[col + e];
        br[e] = xres ? resb[col + e] : 0.f;
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int tr = rl + 16 * m + 8 * h;
          if (tr >= T) continue;
          float z[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            z[e] = acc[m][j][2 * h + e];
            if (!relu_between) {
              z[e] += bz[e];
              if (act_z) z[e] = fmaxf(z[e], 0.f);
            }
            z[e] = fmaxf(z[e] + br[e], 0.f);
          }
          store2(out + ((size_t)b * T + tr) * co + col, z[0], z[1]);
        }
    }
  }
}

int device_index() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev < MAX_DEVICES ? dev : MAX_DEVICES - 1;
}

int num_sms() {
  static int sms[MAX_DEVICES];
  const int dev = device_index();
  if (sms[dev] == 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

// Column groups: a 32-row grid small enough splits an output of two or
// more NC-wide passes over two blocks per tile (each does the depthwise
// and its own passes), so that each block's chain of weight tiles halves.
int col_groups(int batch, int T, int co, int tt) {
  if (tt == 32 && co >= 2 * NC &&
      (long long)(T + 31) / 32 * batch * 2 <= num_sms())
    return 2;
  return 1;
}

// Time rows per block: 64, unless the grid of 32-row blocks fits in one
// wave of one block per SM (a small bucket: twice the blocks at half the
// rows each finish sooner) or 64 rows do not fit in shared memory.
int tile_rows(int x_bf16, int batch, int T, int cx, int cr, int has_res,
              int k) {
  if ((long long)(T + 31) / 32 * batch <= num_sms()) return 32;
  if (layout(64, x_bf16 ? 2 : 4, cx, cr, has_res != 0, k).total > SMEM_MAX)
    return 32;
  return 64;
}

template <int TT, typename Tin, typename Tout>
int launch(const void* x, const void* xres, const void* lens, const void* dw,
           const void* pw, const void* bias, const void* resw,
           const void* resb, void* out, int batch, int T, int cx, int co,
           int cr, int k, int act_z, cudaStream_t stream) {
  // the attribute is a ceiling, set once per instantiation and device
  static bool ready[MAX_DEVICES];
  const int dev = device_index();
  if (!ready[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        repeat_kernel<TT, Tin, Tout>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  const size_t smem =
      layout(TT, sizeof(Tin), cx, cr, xres != nullptr, k).total;
  dim3 grid((T + TT - 1) / TT, batch, col_groups(batch, T, co, TT));
  repeat_kernel<TT, Tin, Tout><<<grid, THREADS, smem, stream>>>(
      (const Tin*)x, (const __nv_bfloat16*)xres, (const int*)lens,
      (const float*)dw, (const __nv_bfloat16*)pw, (const float*)bias,
      (const __nv_bfloat16*)resw, (const float*)resb, (Tout*)out, T, cx, co,
      cr, k, act_z);
  return (int)cudaGetLastError();
}

template <int TT>
int launch_tt(const void* x, int x_bf16, const void* xres, const void* lens,
              const void* dw, const void* pw, const void* bias,
              const void* resw, const void* resb, void* out, int out_bf16,
              int batch, int T, int cx, int co, int cr, int k, int act_z,
              cudaStream_t s) {
  if (x_bf16 && out_bf16)
    return launch<TT, __nv_bfloat16, __nv_bfloat16>(
        x, xres, lens, dw, pw, bias, resw, resb, out, batch, T, cx, co, cr, k,
        act_z, s);
  if (x_bf16)
    return launch<TT, __nv_bfloat16, float>(x, xres, lens, dw, pw, bias, resw,
                                            resb, out, batch, T, cx, co, cr, k,
                                            act_z, s);
  if (out_bf16)
    return launch<TT, float, __nv_bfloat16>(x, xres, lens, dw, pw, bias, resw,
                                            resb, out, batch, T, cx, co, cr, k,
                                            act_z, s);
  return launch<TT, float, float>(x, xres, lens, dw, pw, bias, resw, resb, out,
                                  batch, T, cx, co, cr, k, act_z, s);
}

}  // namespace

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Time rows per block that vt_repeat_forward picks for this launch on the
// current device (32 or 64).
extern "C" int vt_repeat_tile_rows(int x_bf16, int batch, int T, int cx,
                                   int cr, int has_res, int k) {
  return tile_rows(x_bf16, batch, T, cx, cr, has_res, k);
}

// Blocks that split each tile's output columns (1 or 2; see col_groups).
extern "C" int vt_repeat_col_groups(int x_bf16, int batch, int T, int cx,
                                    int co, int cr, int has_res, int k) {
  return col_groups(batch, T, co,
                    tile_rows(x_bf16, batch, T, cx, cr, has_res, k));
}

// Shared-memory bytes this launch asks for (the wrapper refuses shapes
// that exceed the card's 227 KB per block).
extern "C" long long vt_repeat_smem_bytes(int x_bf16, int batch, int T,
                                          int cx, int cr, int has_res, int k) {
  const int tt = tile_rows(x_bf16, batch, T, cx, cr, has_res, k);
  return (long long)layout(tt, x_bf16 ? 2 : 4, cx, cr, has_res != 0, k).total;
}

// One repeat. x is bf16 (x_bf16 = 1) or fp32; out is bf16 (out_bf16 = 1) or
// fp32; xres (bf16, (B, T, cr)) is null for no residual. act_z applies a
// ReLU to the pointwise sums before the residual add. Every channel count
// is a multiple of 16 and every pointer 16-byte aligned (the wrapper checks
// both). Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int vt_repeat_forward(const void* x, int x_bf16, const void* xres,
                                 const void* lens, const void* dw,
                                 const void* pw, const void* bias,
                                 const void* resw, const void* resb,
                                 void* out, int out_bf16, int batch, int T,
                                 int cx, int co, int cr, int k, int act_z,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (tile_rows(x_bf16, batch, T, cx, cr, xres != nullptr, k) == 64)
    return launch_tt<64>(x, x_bf16, xres, lens, dw, pw, bias, resw, resb, out,
                         out_bf16, batch, T, cx, co, cr, k, act_z, s);
  return launch_tt<32>(x, x_bf16, xres, lens, dw, pw, bias, resw, resb, out,
                       out_bf16, batch, T, cx, co, cr, k, act_z, s);
}
