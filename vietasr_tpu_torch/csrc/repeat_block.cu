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
// and the CUDA cores, so the kernel keeps every intermediate on chip and
// keeps both kinds of unit fed from shared memory. One block owns TT = 32
// time rows of one batch row; its time goes mostly to waiting on memory,
// so every load phase issues all its copies before it uses any:
//   1. The residual input rows (masked, bf16) are copied with cp.async
//      into their A tile first, to land while the depthwise runs.
//   2. Depthwise, in channel chunks of CH = 64: the halo'd input rows
//      [t0 - K/2, t0 + TT + K/2 + 8) (16-byte loads, masked, widened to
//      fp32) and the chunk's K taps are staged in shared memory; each
//      thread owns one channel and 8 consecutive output rows (8 fp32
//      accumulators) and slides a 16-row register window over the taps,
//      8 taps at a time: 64 FMAs per 16 shared loads. The masked result is
//      written as bf16 into the GEMM's A tile (TT x C_in).
//   3. For each 128-wide chunk of output channels, one pass over the
//      concatenated reduction [pointwise rows | residual rows] streams the
//      weights through two shared-memory buffers of 64-row tiles, filled
//      with 16-byte cp.async copies by the whole block while the previous
//      tile is multiplied (one barrier per tile; on the H100 deeper rings
//      of smaller tiles measured slower); 8 warps (2 x 4) each compute a 16 x 32 tile
//      with mma.sync m16n8k16 (bf16 in, fp32 sums in registers), their
//      operands read by ldmatrix (x4; .trans for the row-major weights):
//      per 16-deep step, 3 shared loads for 4 MMAs. (When a ReLU sits
//      between the two products, the residual pass runs second, onto the
//      ReLU'd pointwise sums.) The bias / ReLU epilogue works on the
//      registers and stores column pairs.
// Rows t >= len come out as relu(b_pw + b_res), exactly as in the JAX
// package; later blocks mask them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TT = 32;          // time rows per block
constexpr int CH = 64;          // depthwise channel chunk
constexpr int NC = 128;         // output channels per GEMM pass (4 warps x 32)
constexpr int KB = 64;          // weight rows per staged tile
constexpr int NSTAGE = 2;       // staged weight tile buffers
constexpr int THREADS = 256;
constexpr int PADH = 8;         // bf16 row padding of the A tiles
constexpr int LDB = NC + 8;     // bf16 row pitch of the staged weight tile
constexpr int TILE = KB * LDB;  // bf16 elements of one staged weight tile
constexpr int BATCH = 4;        // 16-byte loads a thread issues before use

// 16 bytes of the block input, widened to fp32
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& v, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
};

// two adjacent output columns
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__host__ __device__ constexpr int round8(int v) { return (v + 7) & ~7; }

// The depthwise staging (input rows, then K taps, fp32) and the GEMM's two
// weight tiles share one region after the A tiles.
__host__ __device__ inline size_t smem_bytes(int cx, int cr, bool has_res,
                                             int k) {
  const size_t a = (size_t)TT * (cx + PADH) * 2 +
                   (has_res ? (size_t)TT * (cr + PADH) * 2 : 0);
  const size_t stage = (size_t)(TT + round8(k) + k) * CH * sizeof(float);
  const size_t gemm = (size_t)NSTAGE * TILE * 2;
  return a + (stage > gemm ? stage : gemm);
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
  for (int i = threadIdx.x; i < KB * (NC / 8); i += THREADS) {
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

// One operand pair of a product: this warp's 16 rows of A (lda pitch) and
// the weights W (K, co).
struct Seg {
  const __nv_bfloat16* a;
  int lda;
  const __nv_bfloat16* w;
  int K;
};

// acc[j] += [A1 | A2] x [W1; W2][:, c + 8j : c + 8j + 8) for j < 4, with
// c = n0 + wn * 32 in the block's 128-column chunk at n0 (s2.K may be 0;
// every K is a multiple of 16); acc[j] is the m16n8 fragment (rows lane/4
// and lane/4 + 8, columns 2 * (lane % 4) + {0, 1}). The weights stream
// through the NSTAGE tile buffers at bsm, NSTAGE - 1 tiles ahead of the
// one in use (a group per tile, empty past the end, so the count of
// groups in flight stays fixed). Every thread of the block calls it (it
// holds __syncthreads); it begins with one, so the caller's use of the
// buffers is over, and leaves no copy in flight.
__device__ __forceinline__ void gemm_pass(float (&acc)[4][4], Seg s1, Seg s2,
                                          int co, int n0, __nv_bfloat16* bsm,
                                          int wn) {
  const int lane = threadIdx.x & 31;
  const int lrow = lane % 16, lcol = (lane / 16) * 8;   // ldmatrix address
  const int nt1 = (s1.K + KB - 1) / KB;
  const int nt = nt1 + (s2.K + KB - 1) / KB;
  auto load = [&](int t, __nv_bfloat16* dst) {
    if (t < nt1)
      load_tile(dst, s1.w, t * KB, s1.K, co, n0);
    else
      load_tile(dst, s2.w, (t - nt1) * KB, s2.K, co, n0);
  };
  __syncthreads();                         // the buffers are free
  for (int t = 0; t < NSTAGE - 1; ++t) {
    if (t < nt)
      load(t, bsm + t * TILE);
    else
      cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<NSTAGE - 2>();           // tile t has landed
    __syncthreads();                       // for all; tile t - 1 is consumed
    const int tn = t + NSTAGE - 1;         // into tile t - 1's buffer
    if (tn < nt)
      load(tn, bsm + (tn % NSTAGE) * TILE);
    else
      cp_async_commit();
    const __nv_bfloat16* tile = bsm + (t % NSTAGE) * TILE;
    const bool first = t < nt1;
    const int k0 = (first ? t : t - nt1) * KB;
    const __nv_bfloat16* a = (first ? s1.a : s2.a) + k0;
    const int lda = first ? s1.lda : s2.lda;
    const int kend = min(KB, (first ? s1.K : s2.K) - k0);
    for (int kk = 0; kk < kend; kk += 16) {
      unsigned fa[4], fb0[4], fb1[4];
      ldsm_x4(fa, a + lrow * lda + kk + lcol);
      const __nv_bfloat16* bt = tile + (kk + lrow) * LDB + wn * 32 + lcol;
      ldsm_x4_t(fb0, bt);             // columns +0..15: b0, b1 of j = 0, 1
      ldsm_x4_t(fb1, bt + 16);        // columns +16..31: j = 2, 3
      mma_bf16(acc[0], fa, fb0[0], fb0[1]);
      mma_bf16(acc[1], fa, fb0[2], fb0[3]);
      mma_bf16(acc[2], fa, fb1[0], fb1[1]);
      mma_bf16(acc[3], fa, fb1[2], fb1[3]);
    }
  }
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS, 2)
repeat_kernel(const Tin* __restrict__ x, const __nv_bfloat16* __restrict__ xres,
              const int* __restrict__ lens, const float* __restrict__ dw,
              const __nv_bfloat16* __restrict__ pw, const float* __restrict__ bias,
              const __nv_bfloat16* __restrict__ resw, const float* __restrict__ resb,
              Tout* __restrict__ out, int T, int cx, int co, int cr, int k,
              int act_z) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int k2 = k / 2;
  const int rows_st = TT + round8(k);
  const int lda = cx + PADH;
  const int ldr = cr + PADH;
  __nv_bfloat16* a_dw = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* a_res = a_dw + TT * lda;
  unsigned char* scratch_raw =
      reinterpret_cast<unsigned char*>(a_res + (xres ? TT * ldr : 0));
  float* stage = reinterpret_cast<float*>(scratch_raw);   // rows_st x CH
  float* taps = stage + rows_st * CH;                       // k x CH
  __nv_bfloat16* bsm = reinterpret_cast<__nv_bfloat16*>(scratch_raw);

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int len = min(lens[b], T);
  const int tid = threadIdx.x;

  // 1. masked residual input rows, in flight during the depthwise (the
  //    first gemm_pass waits for this cp.async group with its first tile)
  if (xres) {
    const int cpr = cr / 8;
    for (int i = tid; i < TT * cpr; i += THREADS) {
      const int r = i / cpr;
      const int cc = (i - r * cpr) * 8;
      const int t = t0 + r;
      __nv_bfloat16* d = a_res + r * ldr + cc;
      if (t < len)
        cp_async16(d, xres + ((size_t)b * T + t) * cr + cc);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_commit();
  }

  // 2. depthwise, channel chunk by channel chunk
  constexpr int VEC = Vec16<Tin>::N;
  constexpr int VPR = CH / VEC;       // 16-byte vectors per staged row
  const int c = tid % CH;
  const int r0 = (tid / CH) * 8;      // THREADS / CH = 4 groups of 8 rows = TT
  for (int c0 = 0; c0 < cx; c0 += CH) {
    const int chn = min(CH, cx - c0);  // a multiple of 16
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
      for (int u = 0; u < BATCH; ++u) {
        const int i = base + u * THREADS + tid;
        if (i < nx) {                  // stage[r * CH + cc] = stage[i * VEC]
          float f[VEC];
          Vec16<Tin>::unpack(v[u], f);
          float4* d = reinterpret_cast<float4*>(stage + i * VEC);
#pragma unroll
          for (int q = 0; q < VEC / 4; ++q)
            d[q] = make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2],
                               f[4 * q + 3]);
        }
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
      float acc[8], win[16];
      const float* s = stage + r0 * CH + c;
      const float* wc = taps + c;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i] = 0.f;
        win[i] = s[i * CH];
      }
      for (int j0 = 0; j0 < k; j0 += 8) {
        float wt[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          win[8 + i] = s[(j0 + 8 + i) * CH];
          wt[i] = (j0 + i < k) ? wc[(j0 + i) * CH] : 0.f;
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i] = fmaf(win[i + jj], wt[jj], acc[i]);
#pragma unroll
        for (int i = 0; i < 8; ++i) win[i] = win[8 + i];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = t0 + r0 + i;
        a_dw[(r0 + i) * lda + c0 + c] = __float2bfloat16(t < len ? acc[i] : 0.f);
      }
    }
    __syncthreads();
  }

  // 3. GEMMs + epilogue
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / 4;            // rows wm * 16
  const int wn = warp % 4;            // cols wn * 32 of the chunk
  const bool relu_between = xres && act_z;
  const Seg seg_pw = {a_dw + wm * 16 * lda, lda, pw, cx};
  const Seg seg_res = {a_res + wm * 16 * ldr, ldr, resw, xres ? cr : 0};
  const Seg none = {nullptr, 0, nullptr, 0};
  for (int n0 = 0; n0 < co; n0 += NC) {
    // this lane's outputs: columns cl + 8j + {0, 1}, rows rl + {0, 8}
    const int cl = n0 + wn * 32 + 2 * (lane % 4);
    const int rl = t0 + wm * 16 + lane / 4;
    float bz[4][2], br[4][2], acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = cl + 8 * j;
      const bool ok = col < co;       // co is even: col + 1 < co too
      bz[j][0] = ok ? bias[col] : 0.f;
      bz[j][1] = ok ? bias[col + 1] : 0.f;
      br[j][0] = (ok && xres) ? resb[col] : 0.f;
      br[j][1] = (ok && xres) ? resb[col + 1] : 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
    gemm_pass(acc, seg_pw, relu_between ? none : seg_res, co, n0, bsm, wn);
    if (relu_between) {
      // ReLU(z + b) first, then the residual product on top of it
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][e] = fmaxf(acc[j][e] + bz[j][e & 1], 0.f);
      gemm_pass(acc, seg_res, none, co, n0, bsm, wn);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = cl + 8 * j;
      if (col >= co) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = rl + 8 * h;
        if (t >= T) continue;
        float z[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          z[e] = acc[j][2 * h + e];
          if (!relu_between) {
            z[e] += bz[j][e];
            if (act_z) z[e] = fmaxf(z[e], 0.f);
          }
          z[e] = fmaxf(z[e] + br[j][e], 0.f);
        }
        store2(out + ((size_t)b * T + t) * co + col, z[0], z[1]);
      }
    }
  }
}

template <typename Tin, typename Tout>
int launch(const void* x, const void* xres, const void* lens, const void* dw,
           const void* pw, const void* bias, const void* resw,
           const void* resb, void* out, int batch, int T, int cx, int co,
           int cr, int k, int act_z, cudaStream_t stream) {
  const size_t smem = smem_bytes(cx, cr, xres != nullptr, k);
  cudaError_t err = cudaFuncSetAttribute(
      repeat_kernel<Tin, Tout>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TT - 1) / TT, batch);
  repeat_kernel<Tin, Tout><<<grid, THREADS, smem, stream>>>(
      (const Tin*)x, (const __nv_bfloat16*)xres, (const int*)lens,
      (const float*)dw, (const __nv_bfloat16*)pw, (const float*)bias,
      (const __nv_bfloat16*)resw, (const float*)resb, (Tout*)out, T, cx, co,
      cr, k, act_z);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared-memory bytes one launch asks for (the wrapper refuses shapes
// that exceed the card's 227 KB per block).
extern "C" long long vt_repeat_smem_bytes(int cx, int cr, int has_res, int k) {
  return (long long)smem_bytes(cx, cr, has_res != 0, k);
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
  if (x_bf16 && out_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, xres, lens, dw, pw, bias, resw, resb, out,
                                                batch, T, cx, co, cr, k, act_z, s);
  if (x_bf16)
    return launch<__nv_bfloat16, float>(x, xres, lens, dw, pw, bias, resw, resb, out,
                                        batch, T, cx, co, cr, k, act_z, s);
  if (out_bf16)
    return launch<float, __nv_bfloat16>(x, xres, lens, dw, pw, bias, resw, resb, out,
                                        batch, T, cx, co, cr, k, act_z, s);
  return launch<float, float>(x, xres, lens, dw, pw, bias, resw, resb, out,
                              batch, T, cx, co, cr, k, act_z, s);
}
