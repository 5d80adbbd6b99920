// Whole QuartzNet repeat block for Hopper (sm_90a), R >= 2 repeats in one
// launch: R x (length-masked K-tap depthwise conv (fp32) -> mask -> bf16
// 1x1 GEMM with fp32 accumulation -> + folded-BN bias -> ReLU between
// repeats), + the masked residual 1x1 (bf16, fp32 acc) + its bias, final
// ReLU, stored in x's dtype. The intermediates between repeats stay fp32 in
// shared memory and never reach device memory.
//
// Replaces: vietasr_tpu/ops/pallas_repeat.py::_kernel for R >= 2 (the Pallas
// TPU kernel behind fused_repeat_block, written for QuartzNet15x5's R = 5
// blocks). Numerics as there and as csrc/repeat_block.cu (which serves
// R = 1): fp32 depthwise over fp32 taps in ascending tap order, masks before
// and after it, bf16 operands into fp32-accumulated products, fp32 biases.
// Rows t >= len come out as relu(b_pw + b_res), as in the JAX package.
//
// Where the trouble is. Like the Pallas kernel, a tile of TT output rows
// recomputes a halo of R * (K/2) rows a side, shrinking by K/2 a repeat.
// At K = 75, R = 5 and 512 channels one tile's halo'd fp32 activations
// alone are (TT + 370) x 512 x 4 B: 0.89 MB at TT = 64, 3.8x what one block
// may hold (227 KB). So a tile is spread over a thread-block cluster of N
// <= 8 blocks joined by distributed shared memory (DSMEM):
//   - block `rank` owns output columns [rank * CW, (rank + 1) * CW) of every
//     1x1 product (CW = C_out / N <= 64) and, as the depthwise is per
//     channel, the same channels of every repeat's input after the first
//     (CW_in = C_in / N channels of x for the first). It stages x's E0 =
//     TT + 2 * R * (K/2) halo'd rows of its channels in x's own type; the
//     repeats' fp32 outputs then take the same memory (E0 - 2 * K/2 rows);
//     its masked depthwise output goes as bf16 into a second array (ybuf).
//   - A 1x1 product needs every input channel: after a cluster barrier each
//     block loads 128-row x 64-channel chunks of the cluster's ybufs over
//     DSMEM (16-byte loads through generic pointers from map_shared_rank)
//     into registers and then a local A buffer, and the matching 64 x CW
//     weight tile into a ring of 3 by cp.async: chunk q + 2's loads fly
//     during chunk q's MMAs. The result (bias, ReLU, masked) goes back over
//     the block's own activation rows, which the depthwise has finished
//     reading; a second cluster barrier keeps every ybuf until its readers
//     are done.
//   - The last repeat's chunks add the residual: chunks of x's centre rows
//     (masked, rounded to bf16) against res_w's rows, in the same
//     accumulators (a ReLU on the sums between the two with last_act).
// At ~6 B a row a channel (4 fp32 + 2 bf16) plus 63 KB of GEMM buffers, a
// 64-channel slice holds ~420 rows past the first repeat: TT <= 112 at
// K = 75, <= 288 at K = 33 (`whole_block_plan` in ops/repeat_block.py picks
// TT as this file's layout() counts the bytes; vt_whole_smem_bytes returns
// that count).
//
// What bounds it on the H100. The tile's halo is computed again each repeat:
// a TT-row tile does R * TT + R(R-1) * (K/2) repeat-rows where R * TT are
// needed, 2.3x at K = 75 and TT = 112. Its depthwise (fp32, CUDA cores) and
// GEMMs (bf16 mma.sync) scale with that; the chain of R one-repeat launches
// (csrc/repeat_block.cu) pays 2(R-1) fp32 intermediates through device
// memory instead (~0.26 GB for a 512-wide block at B = 8, T = 840: ~0.08 ms
// at 3.35 TB/s, less while L2 holds them). So this kernel loses to the
// chain, by about 2-3x on an H100 80GB HBM3 at 700 W (PERF.md). With the
// depthwise and the MMAs taken out of a copy (tools/whole_block_cuts.py)
// 45 % of its time is left: the chunk loop's loads and barriers with one
// block of 8 warps an SM. It is the simple, right form first; wgmma, TMA
// multicast of the weight tiles across the cluster and warp roles that
// overlap loads, depthwise and GEMM are later work.
// Measured on that card (B = 8, T = 840, ragged; tools/whole_block_cuts.py)
// against the first form (64-row chunks, a 2-deep weight ring, x staged in
// fp32): 128-row chunks, a 3-deep ring and x in its own type took 0.81 ->
// 0.56 ms at 256 -> 512, K = 51, 1.28 -> 0.86 at 512, K = 63, 1.23 -> 1.00
// at K = 75 (TT 112), 0.25 -> 0.20 at 256, K = 33 (TT 224).
//
// Design per block (256 threads, 8 warps):
//   0. a tile that starts at or past len writes relu(b_last [ReLU] + b_res)
//      and exits (the whole cluster does, together).
//   1. stage x's rows [t0 - R*K/2, t0 + TT + R*K/2) of the block's CW_in
//      channels in x's type, zero outside [0, len).
//   2. per repeat: depthwise over the block's channels for the repeat's
//      output rows (each thread one channel and RPT = 16 rows a pass, a
//      register window slid over the taps, 8 at a time, taps read through
//      L1), masked, bf16 into ybuf; cluster barrier; the 1x1 over 128-row
//      chunks, warps 4 (32 rows) x 2 (CW / 2 columns), m16n8k16 mma.sync
//      with ldmatrix operands; epilogue into the activation rows or, last,
//      to the output; cluster barrier.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int MAX_R = 16;           // repeats a launch takes
constexpr int MAX_CLUSTER = 8;      // the portable cluster size
constexpr int MR = 128;             // GEMM rows a chunk (4 warps x 32)
constexpr int KC = 64;              // GEMM depth a chunk
constexpr int LDA = KC + 8;         // bf16 pitch of an A chunk's rows
constexpr int CW_MAX = 64;          // output columns a block owns, at most
constexpr int LDW = CW_MAX + 8;     // bf16 pitch of a weight chunk's rows
constexpr int WSTAGES = 3;          // weight chunks in the ring
constexpr int RPT = 16;             // depthwise rows a thread takes a pass
constexpr int AV = MR * (KC / 8) / THREADS;  // A vectors a thread stages
constexpr size_t SMEM_MAX = 232448; // shared memory one H100 block may use
constexpr int MAX_DEVICES = 64;

struct Weights {                    // per repeat, by value in the launch
  const float* dw[MAX_R];           // (K, C_r) fp32
  const __nv_bfloat16* pw[MAX_R];   // (C_r, C_out) bf16
  const float* b[MAX_R];            // (C_out,) fp32
};

// Byte offsets of the shared-memory regions: the A ring, the weight ring,
// the activations, the bf16 depthwise output (E1 = E0 - 2 * K/2 rows,
// pitch yp). The activation region first holds x's E0 halo'd rows in x's
// own type (pitch CW_in), the first repeat's input; from the first 1x1's
// epilogue on, the fp32 outputs of the repeats (E1 rows, pitch ap floats).
struct Layout {
  size_t wring, act, ybuf, total;
  int ap, yp;
};

__host__ __device__ inline Layout layout(int tt, int k, int r, int cw,
                                         int cw_in, int x_bytes) {
  const int k2 = k / 2;
  const int e0 = tt + 2 * r * k2;
  const int e1 = e0 - 2 * k2;
  const int wmax = cw > cw_in ? cw : cw_in;
  Layout l;
  l.ap = wmax + 4;                  // +4: the epilogue's rows 4 banks apart
  l.yp = wmax;
  l.wring = (size_t)2 * MR * LDA * 2;
  l.act = l.wring + (size_t)WSTAGES * KC * LDW * 2;
  const size_t acts = (size_t)e1 * l.ap * 4;
  const size_t xs = (size_t)e0 * cw_in * x_bytes;
  l.ybuf = l.act + (acts > xs ? acts : xs);
  l.total = l.ybuf + (size_t)e1 * l.yp * 2;
  return l;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 8 consecutive values of x as bf16, packed (the residual's A operand)
__device__ __forceinline__ uint4 load8_bf16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ uint4 load8_bf16(const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
  h[0] = __floats2bfloat162_rn(a.x, a.y);
  h[1] = __floats2bfloat162_rn(a.z, a.w);
  h[2] = __floats2bfloat162_rn(b.x, b.y);
  h[3] = __floats2bfloat162_rn(b.z, b.w);
  return u;
}

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
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// two 8x8 bf16 matrices, transposed; lanes 0-15 give the row addresses
__device__ __forceinline__ void ldsm_x2_t(unsigned (&r)[2], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1]) : "r"(s));
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

template <typename Tx>
__global__ void __launch_bounds__(THREADS, 1)
whole_block_kernel(const Tx* __restrict__ x, const int* __restrict__ lens,
                   const Weights wts, const __nv_bfloat16* __restrict__ resw,
                   const float* __restrict__ resb, Tx* __restrict__ out,
                   int T, int c_in, int c_out, int k, int r, int tt,
                   int last_act) {
  cg::cluster_group cluster = cg::this_cluster();
  const int ncl = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  extern __shared__ __align__(128) unsigned char smem[];
  const int cw = c_out / ncl, cw_in = c_in / ncl;
  const Layout lay = layout(tt, k, r, cw, cw_in, sizeof(Tx));
  __nv_bfloat16* aring = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wring = reinterpret_cast<__nv_bfloat16*>(smem + lay.wring);
  float* act = reinterpret_cast<float*>(smem + lay.act);
  Tx* xs = reinterpret_cast<Tx*>(smem + lay.act);
  __nv_bfloat16* ybuf = reinterpret_cast<__nv_bfloat16*>(smem + lay.ybuf);
  const int ap = lay.ap, yp = lay.yp;

  const int b = blockIdx.z;
  const int t0 = blockIdx.y * tt;
  const int len = min(lens[b], T);
  const int tid = threadIdx.x;
  const int k2 = k / 2, halo = r * k2, e0 = tt + 2 * halo;
  const int n0 = rank * cw;             // this block's output columns
  const bool has_res = resw != nullptr;
  const float* b_last = wts.b[r - 1];

  // 0. a tile of padding only (every block of the cluster takes this branch)
  if (t0 >= len) {
    const int rows = min(tt, T - t0);
    const int half = cw / 2;
    for (int i = tid; i < rows * half; i += THREADS) {
      const int row = i / half;
      const int col = n0 + (i - row * half) * 2;
      float z[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        z[e] = 0.f + b_last[col + e];
        if (last_act) z[e] = fmaxf(z[e], 0.f);
        z[e] = fmaxf(z[e] + (has_res ? resb[col + e] : 0.f), 0.f);
      }
      store2(out + ((size_t)b * T + t0 + row) * c_out + col, z[0], z[1]);
    }
    return;
  }

  // 1. the block's channels of x over the halo'd rows, in x's type (the
  //    depthwise widens them in registers, which is exact), zero outside
  //    [0, len)
  {
    constexpr int VEC = 16 / sizeof(Tx);
    const int vpr = cw_in / VEC;
    const int c0 = rank * cw_in;
    for (int i = tid; i < e0 * vpr; i += THREADS) {
      const int row = i / vpr;
      const int cc = (i - row * vpr) * VEC;
      const int g = t0 - halo + row;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (g >= 0 && g < len)
        v = __ldg(reinterpret_cast<const uint4*>(
            x + ((size_t)b * T + g) * c_in + c0 + cc));
      *reinterpret_cast<uint4*>(xs + row * cw_in + cc) = v;
    }
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp % 4;              // rows wm * 32 of a chunk
  const int wn = warp / 4;              // columns wn * wcols of the block's
  const int wcols = cw / 2;             // a multiple of 8, at most 32
  const int nres = has_res ? (c_in + KC - 1) / KC : 0;

  for (int rr = 0; rr < r; ++rr) {
    const bool last = rr == r - 1;
    const int cx = rr == 0 ? c_in : c_out;    // the repeat's input channels
    const int cwx = rr == 0 ? cw_in : cw;     // of which this block holds
    const int lo = (rr + 1) * k2;             // its output rows (halo frame)
    const int hi = e0 - (rr + 1) * k2;

    // 2a. depthwise of the block's channels over rows [lo, hi): thread
    //     (grp, c) takes channel c and passes of RPT rows. The first
    //     repeat reads x (halo-frame row i at src[i * pitch]), the others
    //     the fp32 activations (row i at src[(i - k2) * pitch])
    auto depthwise = [&](const auto* src, int pitch, int base) {
      const int cp = cwx > 32 ? 64 : cwx > 16 ? 32 : cwx > 8 ? 16 : 8;
      const int groups = THREADS / cp;
      const int c = tid % cp, grp = tid / cp;
      const int npass = (hi - lo + RPT - 1) / RPT;
      const float* taps = wts.dw[rr] + rank * cwx + c;   // tap j at j * cx
      if (c >= cwx) return;
      for (int q = grp; q < npass; q += groups) {
        const int i0 = lo + q * RPT;          // first output row of the pass
        const int s0 = i0 - k2;               // its first input row
        // rows past the repeat's input rows [lo - k2, hi + k2) feed only
        // outputs past hi or taps past k, which weigh 0: clamp them to its
        // last row, so that they are finite
        auto at = [&](int i) {
          return to_float(src[(min(s0 + i, hi + k2 - 1) - base) * pitch + c]);
        };
        float acc[RPT], win[RPT + 8];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          acc[i] = 0.f;
          win[i] = at(i);
        }
        for (int j0 = 0; j0 < k; j0 += 8) {
          float wt[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            win[RPT + i] = at(j0 + RPT + i);
            wt[i] = (j0 + i < k) ? __ldg(taps + (size_t)(j0 + i) * cx) : 0.f;
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
          const int row = i0 + i;
          if (row < hi) {
            const int g = t0 - halo + row;
            ybuf[(row - k2) * yp + c] =
                __float2bfloat16(g >= 0 && g < len ? acc[i] : 0.f);
          }
        }
      }
    };
    if (rr == 0)
      depthwise(xs, cw_in, 0);
    else
      depthwise(act, ap, k2);
    // every block's ybuf is written (and, the first time, every block of
    // the cluster has started, as DSMEM access requires)
    cluster.sync();

    // 2b. the 1x1 over all cx channels for this block's columns [n0, n0 +
    //     cw), MR rows at a time; chunk q < nk1 is input channels [q * KC,
    //     q * KC + KC) (from the blocks that own them), then the residual's
    const __nv_bfloat16* pw = wts.pw[rr];
    const float* bias = wts.b[rr];
    const int nk1 = (cx + KC - 1) / KC;
    const int nk = nk1 + (last ? nres : 0);
    for (int m0 = lo; m0 < hi; m0 += MR) {
      // the A chunk: 8-value vectors v = tid + u * THREADS of MR x KC
      auto load_a = [&](int q, uint4 (&ra)[AV]) {
        const bool res = q >= nk1;
        const int kc = (res ? q - nk1 : q) * KC;
        const int kw = min(KC, (res ? c_in : cx) - kc);
#pragma unroll
        for (int u = 0; u < AV; ++u) {
          const int v = u * THREADS + tid;
          const int row = v / (KC / 8);
          const int cc = (v - row * (KC / 8)) * 8;
          const int i = m0 + row;             // halo-frame row
          ra[u] = make_uint4(0u, 0u, 0u, 0u);
          if (cc >= kw || i >= hi) continue;
          const int col = kc + cc;
          if (res) {
            const int g = t0 - halo + i;
            if (g >= 0 && g < len)
              ra[u] = load8_bf16(x + ((size_t)b * T + g) * c_in + col);
          } else {
            const int p = col / cwx;          // the block holding channel col
            const __nv_bfloat16* src = cluster.map_shared_rank(ybuf, p);
            ra[u] = *reinterpret_cast<const uint4*>(
                src + (i - k2) * yp + (col - p * cwx));
          }
        }
      };
      auto store_a = [&](__nv_bfloat16* dst, const uint4 (&ra)[AV]) {
#pragma unroll
        for (int u = 0; u < AV; ++u) {
          const int v = u * THREADS + tid;
          const int row = v / (KC / 8);
          const int cc = (v - row * (KC / 8)) * 8;
          *reinterpret_cast<uint4*>(dst + row * LDA + cc) = ra[u];
        }
      };
      // the weight chunk: rows [kc, kc + kw) x columns [n0, n0 + cw)
      auto load_w = [&](int q, __nv_bfloat16* dst) {
        const bool res = q >= nk1;
        const int kc = (res ? q - nk1 : q) * KC;
        const int kw = min(KC, (res ? c_in : cx) - kc);
        const __nv_bfloat16* w = res ? resw : pw;
        const int cpr = cw / 8;
        for (int v = tid; v < kw * cpr; v += THREADS) {
          const int row = v / cpr;
          const int cc = (v - row * cpr) * 8;
          cp_async16(dst + row * LDW + cc,
                     w + (size_t)(kc + row) * c_out + n0 + cc);
        }
        cp_async_commit();
      };
      auto kwidth = [&](int q) {
        const bool res = q >= nk1;
        const int kc = (res ? q - nk1 : q) * KC;
        return min(KC, (res ? c_in : cx) - kc);
      };

      float acc[2][4][4];                     // [row tile][n8 tile][.]
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
      // chunk q's A sits in A buffer q & 1, its weights in stage q % WSTAGES;
      // chunk q + 2's weights are copied and its A is loaded into registers
      // during chunk q's MMAs (two register stagings, in turns), so a copy
      // has two chunks' time to land
      uint4 ra[2][AV];
      load_a(0, ra[0]);
      load_w(0, wring);
      store_a(aring, ra[0]);
      if (nk > 1) {
        load_a(1, ra[1]);
        load_w(1, wring + KC * LDW);
      } else {
        cp_async_commit();
      }
      cp_async_wait<1>();                     // chunk 0's weights
      __syncthreads();
      auto step = [&](int q, uint4 (&ra_store)[AV], uint4 (&ra_load)[AV]) {
        if (q + 2 < nk) {
          load_a(q + 2, ra_load);
          load_w(q + 2, wring + ((q + 2) % WSTAGES) * KC * LDW);
        } else {
          cp_async_commit();                  // an empty group: counts agree
        }
        if (q == nk1 && last_act) {           // ReLU(z + b) under the residual
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j * 8 >= wcols) break;
            const int col = n0 + wn * wcols + j * 8 + 2 * (lane % 4);
            const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[m][j][e] =
                    fmaxf(acc[m][j][e] + ((e & 1) ? b1 : b0), 0.f);
          }
        }
        const __nv_bfloat16* a = aring + (q & 1) * MR * LDA +
                                 (wm * 32 + lane % 16) * LDA + (lane / 16) * 8;
        const __nv_bfloat16* w = wring + (q % WSTAGES) * KC * LDW +
                                 (lane % 16) * LDW + wn * wcols;
        const int kw = kwidth(q);             // a multiple of 16
        for (int kk = 0; kk < kw; kk += 16) {
          unsigned fa[2][4];
          ldsm_x4(fa[0], a + kk);
          ldsm_x4(fa[1], a + 16 * LDA + kk);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j * 8 >= wcols) break;
            unsigned fb[2];
            ldsm_x2_t(fb, w + kk * LDW + j * 8);
            mma_bf16(acc[0][j], fa[0], fb[0], fb[1]);
            mma_bf16(acc[1][j], fa[1], fb[0], fb[1]);
          }
        }
        // chunk q + 1's A into the buffer chunk q - 1 used (every warp is
        // past it: the barrier that ended step q - 1)
        if (q + 1 < nk) store_a(aring + ((q + 1) & 1) * MR * LDA, ra_store);
        cp_async_wait<1>();                   // chunk q + 1's weights
        __syncthreads();
      };
      for (int q = 0; q < nk; q += 2) {
        step(q, ra[1], ra[0]);
        if (q + 1 < nk) step(q + 1, ra[0], ra[1]);
      }

      // epilogue: this lane's rows m0 + wm * 32 + 16m + lane / 4 + {0, 8},
      // columns wn * wcols + 8j + 2 (lane % 4) + {0, 1} of the block's
      const bool bias_here = !(last && last_act && has_res);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j * 8 >= wcols) break;
        const int col = wn * wcols + j * 8 + 2 * (lane % 4);
        float bz[2], br[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          bz[e] = bias_here ? bias[n0 + col + e] : 0.f;
          br[e] = (last && has_res) ? resb[n0 + col + e] : 0.f;
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = m0 + wm * 32 + 16 * m + lane / 4 + 8 * h;
            if (i >= hi) continue;
            const int g = t0 - halo + i;
            float z[2];
            if (!last) {                      // the next repeat's input
              const bool valid = g >= 0 && g < len;
#pragma unroll
              for (int e = 0; e < 2; ++e)
                z[e] = valid ? fmaxf(acc[m][j][2 * h + e] + bz[e], 0.f)
                             : 0.f;
              store2(act + (i - k2) * ap + col, z[0], z[1]);
            } else if (g < T) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                z[e] = acc[m][j][2 * h + e] + bz[e];
                if (last_act && !has_res) z[e] = fmaxf(z[e], 0.f);
                z[e] = fmaxf(z[e] + br[e], 0.f);
              }
              store2(out + ((size_t)b * T + g) * c_out + n0 + col, z[0],
                     z[1]);
            }
          }
      }
    }
    // every block is done reading the cluster's ybufs: the next repeat may
    // write them, or the blocks may exit
    cluster.sync();
  }
}

int device_index() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev < MAX_DEVICES ? dev : MAX_DEVICES - 1;
}

bool plan_ok(int c_in, int c_out, int k, int r, int tt, int ncl,
             int x_bytes) {
  if (r < 1 || r > MAX_R || ncl < 1 || ncl > MAX_CLUSTER || tt < 16 ||
      tt % 16 || k < 1 || k % 2 == 0 || c_in % ncl || c_out % ncl)
    return false;
  const int cw = c_out / ncl, cw_in = c_in / ncl;
  if (cw % 16 || cw > CW_MAX || cw_in % 8 || cw_in < 8 || cw_in > CW_MAX ||
      c_in % 16)
    return false;
  return layout(tt, k, r, cw, cw_in, x_bytes).total <= SMEM_MAX;
}

template <typename Tx>
cudaError_t set_smem_ceiling() {
  // the attribute is a ceiling, set once per instantiation and device
  static bool ready[MAX_DEVICES];
  const int dev = device_index();
  if (ready[dev]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      whole_block_kernel<Tx>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_MAX);
  if (err == cudaSuccess) ready[dev] = true;
  return err;
}

template <typename Tx>
void launch_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                   int batch, int T, int c_in, int c_out, int k, int r,
                   int tt, int ncl, cudaStream_t stream) {
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(ncl, (T + tt - 1) / tt, batch);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes =
      layout(tt, k, r, c_out / ncl, c_in / ncl, sizeof(Tx)).total;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ncl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

template <typename Tx>
int launch(const void* x, const void* lens, const Weights& wts,
           const void* resw, const void* resb, void* out, int batch, int T,
           int c_in, int c_out, int k, int r, int last_act, int tt, int ncl,
           cudaStream_t stream) {
  cudaError_t err = set_smem_ceiling<Tx>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  launch_config<Tx>(cfg, attr, batch, T, c_in, c_out, k, r, tt, ncl, stream);
  err = cudaLaunchKernelEx(&cfg, whole_block_kernel<Tx>, (const Tx*)x,
                           (const int*)lens, wts,
                           (const __nv_bfloat16*)resw, (const float*)resb,
                           (Tx*)out, T, c_in, c_out, k, r, tt, last_act);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared-memory bytes of one block of a launch with tile rows tt, kernel k,
// r repeats, cw output columns and cw_in input channels a block, x of
// x_bytes a value (the count ops/repeat_block.py::whole_block_smem
// mirrors).
extern "C" long long vt_whole_smem_bytes(int tt, int k, int r, int cw,
                                         int cw_in, int x_bytes) {
  return (long long)layout(tt, k, r, cw, cw_in, x_bytes).total;
}

// Clusters of `ncl` blocks with `smem` bytes of shared memory each that the
// current device holds at once (cudaOccupancyMaxActiveClusters), or a
// negative CUDA error.
extern "C" int vt_whole_clusters_at_once(int x_bf16, int ncl, int smem) {
  if (ncl < 1 || ncl > MAX_CLUSTER || smem < 0 || (size_t)smem > SMEM_MAX)
    return -(int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(ncl, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ncl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  cudaError_t err;
  if (x_bf16) {
    err = set_smem_ceiling<__nv_bfloat16>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(
          &n, whole_block_kernel<__nv_bfloat16>, &cfg);
  } else {
    err = set_smem_ceiling<float>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&n, whole_block_kernel<float>,
                                           &cfg);
  }
  return err == cudaSuccess ? n : -(int)err;
}

// The whole block in one launch. x (B, T, c_in) and out (B, T, c_out) are
// bf16 (x_bf16 = 1) or fp32; dw / pw / bias are r pointers each ((K, C_r)
// fp32, (C_r, c_out) bf16, (c_out,) fp32; C_0 = c_in, else c_out); resw
// (c_in, c_out) bf16 and resb (c_out,) fp32 are null for no residual.
// tt (tile rows) and ncl (cluster size) are the plan's
// (ops/repeat_block.py::whole_block_plan). Every pointer 16-byte aligned
// (the wrapper checks). Returns a CUDA error code (0 = launched);
// cudaErrorInvalidValue for a plan this kernel cannot take.
extern "C" int vt_whole_forward(const void* x, int x_bf16, const void* lens,
                                const void* const* dw, const void* const* pw,
                                const void* const* bias, int r,
                                const void* resw, const void* resb, void* out,
                                int batch, int T, int c_in, int c_out, int k,
                                int last_act, int tt, int ncl, void* stream) {
  if (!plan_ok(c_in, c_out, k, r, tt, ncl, x_bf16 ? 2 : 4) || batch < 1 ||
      T < 1)
    return (int)cudaErrorInvalidValue;
  Weights wts{};
  for (int i = 0; i < r; ++i) {
    wts.dw[i] = (const float*)dw[i];
    wts.pw[i] = (const __nv_bfloat16*)pw[i];
    wts.b[i] = (const float*)bias[i];
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16)
    return launch<__nv_bfloat16>(x, lens, wts, resw, resb, out, batch, T,
                                 c_in, c_out, k, r, last_act, tt, ncl, s);
  return launch<float>(x, lens, wts, resw, resb, out, batch, T, c_in, c_out,
                       k, r, last_act, tt, ncl, s);
}
