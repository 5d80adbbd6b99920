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
// The tile and the cluster. Like the Pallas kernel, a tile of TT output rows
// recomputes a halo of R * (K/2) rows a side, shrinking by K/2 a repeat. At
// 512 channels the halo'd fp32 activations do not fit one block, so a tile
// is spread over a thread-block cluster of N <= 8 blocks: block `rank` owns
// output columns [rank * CW, (rank + 1) * CW) of every 1x1 (CW = C_out / N
// <= 64) and the same channels of every repeat's input after the first
// (C_in / N channels of x for the first). Only the 1x1's bf16 input crosses
// blocks, over distributed shared memory (DSMEM).
//
// What bounds it on the H100. The design targets the fp32 depthwise on the
// CUDA cores, which grows with the recomputed halo (R * TT + R(R-1) * K/2
// repeat-rows for R * TT needed: 1.66x at K = 75, TT = 224), and runs
// everything else beside it. Warp roles, one block of 512 threads an SM:
//   - the producer warp: lane 0 streams the 1x1 (and residual) weights, 64
//     input channels x CW columns a tile, through a ring of WSTAGES stages
//     by one bulk copy each, on full / empty mbarriers; lane 1 copies each
//     repeat's taps (K x the block's channels, fp32) once the depthwise
//     warps have released the last repeat's. The weights are packed once per
//     weight tensor (ops/repeat_block.py::pack_whole_weights, a cache) into
//     per-(rank, 64-deep chunk) tiles in the core-matrix order the wgmma
//     descriptor reads, so a copy is one contiguous run;
//   - 7 depthwise warps: stage x's halo'd rows of the block's channels
//     (x's own type), then, chunk by chunk (MR = 128 rows of a repeat), the
//     depthwise of the block's channels (each thread one channel and 16 rows
//     at a time, a register window slid over the taps, 8 at a time, taps from
//     shared memory), masked, as bf16 into a ring of YSTAGES chunk stages
//     laid out in wgmma's register-fragment order, and arrive on every
//     cluster block's "chunk ready" mbarrier;
//   - 2 consumer warpgroups (64 rows each): once every block's slice of the
//     chunk is ready, each warp loads its A fragments straight from the
//     blocks that own the channels (ld.shared::cluster, 16 bytes a lane a
//     k16 step, two 64-deep chunks ahead into a 3-deep register ring) and
//     issues m64nCWk16 wgmmas against the weight stage's descriptor; then
//     releases the chunk stage on every block (remote mbarrier arrivals)
//     and writes the epilogue (bias, ReLU, mask) over its activation rows
//     or, in the last repeat, to the output. The residual's chunks follow
//     the last repeat's, A from x's rows in device memory. No access to the
//     wgmma registers sits behind a branch the compiler sees as divergent
//     (a wait it inserts there serializes every wgmma of the kernel).
//   The hazard: an epilogue writes a repeat's output over its input rows in
//   place, and chunk j's rows [m0, m0 + MR) overlap the input chunk j + 1's
//   depthwise reads ([m0 + MR - K/2, ...)). So chunk j's epilogue waits for
//   chunk j + 1's "ready"; a depthwise chunk of the next repeat waits for the
//   epilogue of the last earlier-repeat chunk its windows read (a ring of
//   epilogue mbarriers). Chunk j + 2's depthwise waits only for its stage,
//   so it may run beside chunk j's epilogue: its windows start at row m0 +
//   2 MR - K/2, clear of [m0, m0 + MR) only while K/2 <= MR, so the plan
//   refuses K/2 > MR (K > 257). x is staged E1 x (the pitches' difference)
//   bytes into the activation region, so that the first repeat's epilogues
//   never reach an x row still to be read. No block-wide barrier runs
//   inside a tile; a cluster barrier starts and ends it.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md; B = 8, T = 840,
// ragged): a 15x5 forward's 15 launches take 5.15 ms (8.69 before this
// design), 1.48x the chain of one-repeat launches (K = 33 1.07x to K = 63
// 1.67x), 21x the bound. It is not bound where it was meant to be: the
// consumers wait on their 16-byte DSMEM loads of A (tools/whole_block_cuts.py:
// cutting the A loads leaves 68 % of the time, loading from the block's own
// stage 83 %, cutting the wgmmas 99 %, cutting the depthwise 66 %). A local
// A operand for shared-memory wgmma does not fit beside 512 channels'
// activations (ROADMAP).
//
// Design per tile: 0. a tile that starts at or past len writes relu(b_last
// [ReLU] + b_res) and exits (the whole cluster does, together).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int CWARPS = 8;                 // consumer warps: 2 warpgroups
constexpr int DWARPS = 7;                 // depthwise warps
constexpr int CTHREADS = 32 * CWARPS;
constexpr int DTHREADS = 32 * DWARPS;
constexpr int THREADS = CTHREADS + DTHREADS + 32;  // + the producer warp
constexpr int MAX_R = 16;                 // repeats a launch takes
constexpr int MAX_CLUSTER = 8;            // the portable cluster size
constexpr int MR = 128;                   // rows a chunk: 2 x wgmma m64
constexpr int KC = 64;                    // input channels a weight tile
constexpr int CW_MAX = 64;                // output columns a block owns
constexpr int WSTAGES = 4;                // weight tiles in the ring
constexpr int YSTAGES = 2;                // depthwise chunks in the ring
constexpr int EPI_RING = 16;              // epilogue mbarriers
constexpr int MAX_CHUNKS = EPI_RING - 2;  // chunks of a repeat, at most
constexpr int RPT = 16;                   // depthwise rows a thread a pass
constexpr int BAR_BYTES = 256;
constexpr size_t SMEM_MAX = 232448;       // shared memory of one H100 block
constexpr int MAX_DEVICES = 64;

// mbarrier indices (8 bytes each, from the start of shared memory)
constexpr int B_FULL_W = 0;                      // a weight stage landed
constexpr int B_EMPTY_W = B_FULL_W + WSTAGES;    // ... was read
constexpr int B_FULL_Y = B_EMPTY_W + WSTAGES;    // a chunk is ready in
                                                 // every block
constexpr int B_EMPTY_Y = B_FULL_Y + YSTAGES;    // ... was read by all
constexpr int B_EPI = B_EMPTY_Y + YSTAGES;       // a chunk's epilogue is done
constexpr int B_TAPS_FULL = B_EPI + EPI_RING;    // a repeat's taps landed
constexpr int B_TAPS_EMPTY = B_TAPS_FULL + 1;    // ... were read
static_assert(8 * (B_TAPS_EMPTY + 1) <= BAR_BYTES, "barriers");

struct Weights {                  // per repeat, by value in the launch
  const float* dw[MAX_R];         // taps, packed (N, K, C_r / N) fp32
  const __nv_bfloat16* pw[MAX_R]; // 1x1, packed (N, ceil(C_r / 64), 64, CW)
  const float* b[MAX_R];          // (C_out,) fp32
};

__host__ __device__ inline int pairs_of(int c) { return (c + 15) / 16; }

__host__ __device__ inline int chunks_of(int rows) {
  return (rows + MR - 1) / MR;
}

// Byte offsets of the shared-memory regions: the mbarriers, the weight ring
// (64 x cw bf16 a stage), the depthwise chunk ring (MR rows x the block's
// channels, bf16, `ystage` bytes a stage), the taps (K x the block's
// channels, fp32), then the activations: the repeats' fp32 outputs over E1
// = E0 - 2 * K/2 rows (pitch cw floats, row i of the halo frame at i - K/2),
// and x's E0 halo'd rows in x's own type (pitch cw_in) at `xs`, placed so
// that the first repeat's output row i ends before x's row i + 1 - K/2.
struct Layout {
  size_t wring, ybuf, taps, act, xs, total;
  int ystage;
};

__host__ __device__ inline Layout layout(int tt, int k, int r, int cw,
                                         int cw_in, int x_bytes) {
  const int k2 = k / 2;
  const int e0 = tt + 2 * r * k2;
  const int e1 = e0 - 2 * k2;
  const int cwm = cw > cw_in ? cw : cw_in;
  Layout l;
  l.wring = BAR_BYTES;
  l.ybuf = l.wring + (size_t)WSTAGES * KC * cw * 2;
  l.ystage = (MR / 16) * pairs_of(cwm) * 512;
  l.taps = l.ybuf + (size_t)YSTAGES * l.ystage;
  l.act = l.taps + ((size_t)k * cwm * 4 + 127) / 128 * 128;
  const size_t p = (size_t)cw * 4, q = (size_t)cw_in * x_bytes;
  l.xs = l.act + (p > q ? (size_t)e1 * (p - q) : 0);
  const size_t a_end = l.act + (size_t)e1 * p;
  const size_t x_end = l.xs + (size_t)e0 * q;
  l.total = a_end > x_end ? a_end : x_end;
  return l;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// two consecutive values of x as a bf16 pair (the residual's A operand)
__device__ __forceinline__ unsigned ldx2(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned*>(p));
}

__device__ __forceinline__ unsigned ldx2(const float* p) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int N>
__device__ __forceinline__ void fence_f(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_u(unsigned (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d += a (one k16 step of the warpgroup's 64 rows) * b (16 x CW)
template <int CW>
__device__ __forceinline__ void mma_k16(float (&d)[CW / 2], const unsigned* a,
                                        unsigned long long b) {
  if constexpr (CW == 64)
    wgmma_n64(d, a, b);
  else if constexpr (CW == 48)
    wgmma_n48(d, a, b);
  else if constexpr (CW == 32)
    wgmma_n32<1>(d, a, b);
  else
    wgmma_n16(d, a, b);
}

// predicated forms: no branch around them, so that no path the compiler
// sees as divergent touches the wgmma registers (a wait it inserts in one
// serializes every wgmma of the kernel)
__device__ __forceinline__ void mbar_arrive_if(unsigned bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"((int)pred)
      : "memory");
}

// lane l < n arrives on the mbarrier at `bar` in the block of rank l
__device__ __forceinline__ void mbar_arrive_ranks(unsigned bar, int lane,
                                                  int n) {
  const unsigned remote = map_rank(bar, (unsigned)(lane < n ? lane : 0));
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n}"
      "\n" ::"r"(remote),
      "r"((int)(lane < n))
      : "memory");
}

__device__ __forceinline__ void st_shared2_if(bool ok, unsigned addr, float a,
                                              float b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n"
      "@p st.shared.v2.f32 [%1], {%2, %3};\n}\n" ::"r"((int)ok),
      "r"(addr), "f"(a), "f"(b)
      : "memory");
}

__device__ __forceinline__ void store2_if(bool ok, float* p, float a,
                                          float b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n"
      "@p st.global.v2.f32 [%1], {%2, %3};\n}\n" ::"r"((int)ok),
      "l"(p), "f"(a), "f"(b)
      : "memory");
}

__device__ __forceinline__ void store2_if(bool ok, __nv_bfloat16* p, float a,
                                          float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n"
      "@p st.global.b32 [%1], %2;\n}\n" ::"r"((int)ok),
      "l"(p), "r"(*reinterpret_cast<const unsigned*>(&h))
      : "memory");
}

// the consumer warps' waits: the spin loop inside one asm statement, with
// no timeout (mbar_wait's trap path, taken while a wgmma is in flight,
// would make the compiler serialize every wgmma)
__device__ __forceinline__ void wait_spin(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void wait_spin_cluster(unsigned bar,
                                                  unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], "
      "%1;\n@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void dw_sync() {      // the depthwise warps only
  asm volatile("bar.sync 1, %0;\n" ::"r"(DTHREADS) : "memory");
}

template <typename Tx, int CW>
__global__ void __launch_bounds__(THREADS, 1)
whole_block_kernel(const Tx* __restrict__ x, const int* __restrict__ lens,
                   const Weights wts, const __nv_bfloat16* __restrict__ resw,
                   const float* __restrict__ resb, Tx* __restrict__ out,
                   int T, int c_in, int c_out, int k, int r, int tt,
                   int last_act) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ncl = (int)cluster_size();
  const int rank = (int)cluster_rank();
  const int cw_in = c_in / ncl;
  const Layout lay = layout(tt, k, r, CW, cw_in, sizeof(Tx));
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * tt;
  const int len = min(lens[b], T);
  const int tid = threadIdx.x;
  const int k2 = k / 2, halo = r * k2, e0 = tt + 2 * halo;
  const int n0 = rank * CW;             // this block's output columns
  const bool has_res = resw != nullptr;
  const int nres = has_res ? (c_in + KC - 1) / KC : 0;

  // 0. a tile of padding only (every block of the cluster takes this branch)
  if (t0 >= len) {
    const float* b_last = wts.b[r - 1];
    const int rows = min(tt, T - t0);
    constexpr int half = CW / 2;
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

  const unsigned bars = smem_u32(smem);
  auto bar = [&](int i) { return bars + 8u * (unsigned)i; };
  if (tid == 0) {
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(bar(B_FULL_W + s), 1);
      mbar_init(bar(B_EMPTY_W + s), CWARPS);
    }
    for (int s = 0; s < YSTAGES; ++s) {
      mbar_init(bar(B_FULL_Y + s), ncl * DWARPS);
      mbar_init(bar(B_EMPTY_Y + s), ncl * CWARPS);
    }
    for (int e = 0; e < EPI_RING; ++e) mbar_init(bar(B_EPI + e), CWARPS);
    mbar_init(bar(B_TAPS_FULL), 1);
    mbar_init(bar(B_TAPS_EMPTY), DWARPS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every block's barriers are set up (and every block of the cluster has
  // started, as DSMEM access requires)
  cluster_sync();

  // the warp's index, shown warp-uniform to the compiler (so that it keeps
  // each role's wgmmas asynchronous)
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;
  float* act = reinterpret_cast<float*>(smem + lay.act);

  if (warp >= CWARPS + DWARPS) {
    // the producer warp
    if (lane == 0) {
      // the 1x1 weights of every chunk of every repeat, then the residual's
      // in the last repeat's chunks, one tile a ring stage
      const unsigned wring = smem_u32(smem + lay.wring);
      int ws = 0;
      unsigned ph = 0;
      for (int rr = 0; rr < r; ++rr) {
        const int cx = rr == 0 ? c_in : c_out;
        const int nk1 = (cx + KC - 1) / KC;
        const int nk = nk1 + (rr == r - 1 ? nres : 0);
        const int nc = chunks_of(e0 - 2 * (rr + 1) * k2);
        for (int j = 0; j < nc; ++j)
          for (int kc = 0; kc < nk; ++kc) {
            const bool res = kc >= nk1;
            const int kk = res ? kc - nk1 : kc;
            const int kw = min(KC, (res ? c_in : cx) - kk * KC);
            const __nv_bfloat16* src =
                res ? resw + ((size_t)rank * nres + kk) * KC * CW
                    : wts.pw[rr] + ((size_t)rank * nk1 + kk) * KC * CW;
            mbar_wait(bar(B_EMPTY_W + ws), ph ^ 1);
            mbar_expect_tx(bar(B_FULL_W + ws), kw * CW * 2);
            bulk_copy(wring + ws * (KC * CW * 2), src, kw * CW * 2,
                      bar(B_FULL_W + ws));
            if (++ws == WSTAGES) {
              ws = 0;
              ph ^= 1;
            }
          }
      }
    } else if (lane == 1) {
      // each repeat's taps of the block's channels
      for (int rr = 0; rr < r; ++rr) {
        const int cwx = rr == 0 ? cw_in : CW;
        if (rr > 0) mbar_wait(bar(B_TAPS_EMPTY), (rr - 1) & 1);
        const unsigned bytes = (unsigned)(k * cwx * 4);
        mbar_expect_tx(bar(B_TAPS_FULL), bytes);
        bulk_copy(smem_u32(smem + lay.taps),
                  wts.dw[rr] + (size_t)rank * k * cwx, bytes,
                  bar(B_TAPS_FULL));
      }
    }
  } else if (warp >= CWARPS) {
    // the depthwise warps
    const int dt = tid - CTHREADS;
    Tx* xs = reinterpret_cast<Tx*>(smem + lay.xs);
    const float* taps = reinterpret_cast<const float*>(smem + lay.taps);
    // 1. the block's channels of x over the halo'd rows, in x's type (the
    //    depthwise widens them in registers, which is exact), zero outside
    //    [0, len)
    {
      constexpr int VEC = 16 / sizeof(Tx);
      const int vpr = cw_in / VEC;
      const int c0 = rank * cw_in;
      for (int i = dt; i < e0 * vpr; i += DTHREADS) {
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
    dw_sync();
    const int k8 = (k + 7) & ~7;
    int q = 0, nc_prev = 0;
    for (int rr = 0; rr < r; ++rr) {
      const int cwx = rr == 0 ? cw_in : CW;
      const int lo = (rr + 1) * k2, hi = e0 - (rr + 1) * k2;
      const int nc = chunks_of(hi - lo);
      const int npairs = pairs_of(cwx);
      mbar_wait(bar(B_TAPS_FULL), rr & 1);
      // the chunk's depthwise, rows [m0, min(m0 + MR, hi)). The first
      // repeat reads x (halo-frame row i at src[i * pitch]), the others
      // the fp32 activations (row i at src[(i - k2) * pitch])
      auto chunk = [&](const auto* src, int pitch, int base, int m0, int npass,
                       unsigned char* stage) {
        // item it: channel it % cwx, pass it / cwx (consecutive threads on
        // consecutive channels)
        for (int it = dt; it < cwx * npass; it += DTHREADS) {
          const int c = it % cwx, p = it / cwx;
          const float* tp = taps + c;            // tap j at tp[j * cwx]
          const int i0 = m0 + p * RPT;           // first output row
          const int s0 = i0 - k2;                // its first input row
          // rows past the repeat's input rows [lo - k2, hi + k2) feed only
          // outputs past hi or taps past k, which weigh 0: clamp them to
          // its last row, so that they are finite
          auto at = [&](int i) {
            return to_float(
                src[(min(s0 + i, hi + k2 - 1) - base) * pitch + c]);
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
              wt[i] = (j0 + i < k) ? tp[(j0 + i) * cwx] : 0.f;
            }
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
#pragma unroll
              for (int i = 0; i < RPT; ++i)
                acc[i] = fmaf(win[i + jj], wt[jj], acc[i]);
#pragma unroll
            for (int i = 0; i < RPT; ++i) win[i] = win[i + 8];
          }
          // channel c's place in the pass's 16-row tile: 8-channel group lg
          // is half (lg & 1) of 16-channel pair lg / 2, whose 16 bytes a
          // lane are the m16k16 fragment (rows l / 4 and l / 4 + 8)
          const int lg = c >> 3, cc = c & 7;
          __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(
              stage + (p * npairs + (lg >> 1)) * 512 + (cc >> 1) * 16 +
              (lg & 1) * 8 + (cc & 1) * 2);
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const int row = i0 + i;
            const int g = t0 - halo + row;
            st[(i & 7) * 32 + (i >> 3) * 2] = __float2bfloat16(
                row < hi && g >= 0 && g < len ? acc[i] : 0.f);
          }
        }
      };
      for (int j = 0; j < nc; ++j, ++q) {
        const int m0 = lo + j * MR;
        const int npass = (min(m0 + MR, hi) - m0 + RPT - 1) / RPT;
        if (rr > 0) {
          // the epilogue of the last earlier-repeat chunk whose rows this
          // chunk's windows read (those rows, clamped, are the previous
          // repeat's output rows [rr * k2, hi + k2))
          const int top = min(m0 + (npass - 1) * RPT - k2 + RPT + k8 - 1,
                              hi + k2 - 1);
          const int need = q - j - nc_prev + (top - rr * k2) / MR;
          mbar_wait(bar(B_EPI + need % EPI_RING), (need / EPI_RING) & 1);
        }
        const int s = q % YSTAGES;
        // every block has read what this stage held
        mbar_wait_cluster(bar(B_EMPTY_Y + s), ((q / YSTAGES) & 1) ^ 1);
        unsigned char* stage = smem + lay.ybuf + s * lay.ystage;
        if (rr == 0)
          chunk(xs, cw_in, 0, m0, npass, stage);
        else
          chunk(static_cast<const float*>(act), CW, k2, m0, npass, stage);
        __syncwarp();
        mbar_arrive_ranks(bar(B_FULL_Y + s), lane, ncl);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar(B_TAPS_EMPTY));   // the taps are read
      nc_prev = nc;
    }
  } else {
    // the consumer warpgroups: warp w takes rows [16 w, 16 w + 16) of a
    // chunk, warpgroup w / 4 rows [64 (w / 4), 64 (w / 4) + 64)
    const int w = warp;
    const int gq = lane >> 2, tq = lane & 3;
    const unsigned wring = smem_u32(smem + lay.wring);
    const unsigned ybuf = smem_u32(smem + lay.ybuf);
    constexpr unsigned LBO = CW * 16;    // next 8 rows of k
    constexpr unsigned SBO = 128;        // next 8 columns
    // weight stage 0's descriptor; a stage or k16 step further adds its
    // offset / 16 to the address field (shared memory < 256 KB: no carry)
    const unsigned long long desc0 = gmma_desc_k(wring, LBO, SBO);
    int ws = 0, q = 0;
    unsigned wph = 0;
    float acc[CW / 2];
    unsigned a0[16], a1[16], a2[16];
    for (int rr = 0; rr < r; ++rr) {
      const bool last = rr == r - 1;
      const int cx = rr == 0 ? c_in : c_out;
      const int cwx = rr == 0 ? cw_in : CW;
      const int lo = (rr + 1) * k2, hi = e0 - (rr + 1) * k2;
      const int nc = chunks_of(hi - lo);
      const int npairs = pairs_of(cwx);
      const int nk1 = (cx + KC - 1) / KC;
      const int nk = nk1 + (last ? nres : 0);
      const float* bias = wts.b[rr];
      // the widths of the last main and residual k-chunks (the others: KC)
      const int kw_main = cx - (nk1 - 1) * KC;
      const int kw_res = c_in - (nres - 1) * KC;
      // one block holds every 16-channel pair whole (else the 8-byte path)
      const bool whole_pairs = cwx % 16 == 0;
      for (int j = 0; j < nc; ++j, ++q) {
        const int m0 = lo + j * MR;
        const int s = q % YSTAGES;
        // this lane's 16 bytes of its warp's 16-row tile, pair 0
        const unsigned stage =
            ybuf + s * lay.ystage + (w * npairs * 32 + lane) * 16;
        const int i_lo = m0 + w * 16 + gq;       // its rows i_lo, i_lo + 8
        // the residual's rows of x: rows outside [0, len) read row 0 and
        // are masked to 0 (no branch)
        const int g0 = t0 - halo + i_lo, g1 = g0 + 8;
        const bool v0 = g0 >= 0 && g0 < len, v1 = g1 >= 0 && g1 < len;
        const unsigned xm0 = v0 ? 0xffffffffu : 0u;
        const unsigned xm1 = v1 ? 0xffffffffu : 0u;
        const Tx* x0 = x + ((size_t)b * T + (v0 ? g0 : 0)) * c_in + 2 * tq;
        const Tx* x1 = x + ((size_t)b * T + (v1 ? g1 : 0)) * c_in + 2 * tq;
        // the next 16-channel pair to load: pair lu of block lp, at
        // cluster address lbase + lu * 512 (k-chunks load in order)
        int lp = 0, lu = 0;
        unsigned lbase = map_rank(stage, 0);
        // k-chunk kc's A fragments (4 k16 steps) into a
        auto load_a = [&](int kc, unsigned(&a)[16]) {
          if (kc < nk1 && whole_pairs) {
#pragma unroll
            for (int ks = 0; ks < 4; ++ks) {
              if (kc * KC + ks * 16 >= cx) break;
              const uint4 v = ld_cluster16(lbase + lu * 512);
              a[4 * ks] = v.x;
              a[4 * ks + 1] = v.y;
              a[4 * ks + 2] = v.z;
              a[4 * ks + 3] = v.w;
              if (++lu == npairs) {
                lu = 0;
                lbase = map_rank(stage, ++lp);
              }
            }
          } else if (kc < nk1) {
            // 8-channel halves from the blocks that hold them
#pragma unroll
            for (int ks = 0; ks < 4; ++ks) {
              const int c0 = kc * KC + ks * 16;
              if (c0 >= cx) break;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int ch = c0 + 8 * h;
                const int ph = ch / cwx, lh = ch - ph * cwx;
                const uint2 v = ld_cluster8(map_rank(
                    stage + (lh >> 4) * 512 + ((lh >> 3) & 1) * 8, ph));
                a[4 * ks + 2 * h] = v.x;
                a[4 * ks + 2 * h + 1] = v.y;
              }
            }
          } else {
            // the residual: x's rows, masked, rounded to bf16
            const int c0 = (kc - nk1) * KC;
#pragma unroll
            for (int ks = 0; ks < 4; ++ks) {
              if (c0 + ks * 16 >= c_in) break;
              a[4 * ks] = ldx2(x0 + c0 + ks * 16) & xm0;
              a[4 * ks + 1] = ldx2(x1 + c0 + ks * 16) & xm1;
              a[4 * ks + 2] = ldx2(x0 + c0 + ks * 16 + 8) & xm0;
              a[4 * ks + 3] = ldx2(x1 + c0 + ks * 16 + 8) & xm1;
            }
          }
        };
        int prev = -1;
        // k-chunk kc from cur; then kc + 2's A into nxt (kc - 1's, done)
        auto step = [&](int kc, unsigned(&cur)[16], unsigned(&nxt)[16]) {
          if (kc == nk1 && last_act) {             // ReLU(z + b) under the
            wgmma_wait<0>();                       // residual
            fence_f(acc);
#pragma unroll
            for (int jj = 0; jj < CW / 8; ++jj) {
              const int col = n0 + jj * 8 + 2 * tq;
              const float b0 = bias[col], b1 = bias[col + 1];
              acc[4 * jj] = fmaxf(acc[4 * jj] + b0, 0.f);
              acc[4 * jj + 1] = fmaxf(acc[4 * jj + 1] + b1, 0.f);
              acc[4 * jj + 2] = fmaxf(acc[4 * jj + 2] + b0, 0.f);
              acc[4 * jj + 3] = fmaxf(acc[4 * jj + 3] + b1, 0.f);
            }
          }
          wait_spin(bar(B_FULL_W + ws), wph);     // the weight tile landed
          const int kw = kc == nk1 - 1 ? kw_main
                                       : kc == nk - 1 && kc >= nk1 ? kw_res
                                                                   : KC;
          const unsigned long long desc =
              desc0 + (unsigned long long)(ws * (KC * CW * 2 / 16));
          fence_u(cur);
          fence_f(acc);
          wgmma_fence();
          if (kw == KC) {
#pragma unroll
            for (int ks = 0; ks < 4; ++ks)
              mma_k16<CW>(acc, &cur[4 * ks], desc + ks * (2 * LBO / 16));
          } else {
#pragma unroll
            for (int ks = 0; ks < 4; ++ks)
              if (ks * 16 < kw)
                mma_k16<CW>(acc, &cur[4 * ks], desc + ks * (2 * LBO / 16));
          }
          wgmma_commit();
          wgmma_wait<1>();                        // k-chunk kc - 1 is done
          mbar_arrive_if(bar(B_EMPTY_W + (prev < 0 ? 0 : prev)),
                         prev >= 0 && lane == 0);
          prev = ws;
          if (++ws == WSTAGES) {
            ws = 0;
            wph ^= 1;
          }
          if (kc + 2 < nk) load_a(kc + 2, nxt);
        };
#pragma unroll
        for (int i = 0; i < CW / 2; ++i) acc[i] = 0.f;
        wait_spin_cluster(bar(B_FULL_Y + s), (q / YSTAGES) & 1);
        load_a(0, a0);
        if (nk > 1) load_a(1, a1);
#pragma unroll 1
        for (int kc = 0; kc < nk; kc += 3) {
          step(kc, a0, a2);
          if (kc + 1 < nk) step(kc + 1, a1, a0);
          if (kc + 2 < nk) step(kc + 2, a2, a1);
        }
        wgmma_wait<0>();
        fence_f(acc);
        mbar_arrive_if(bar(B_EMPTY_W + prev), lane == 0);
        // every A load of the chunk has returned: free its stage everywhere
        __syncwarp();
        mbar_arrive_ranks(bar(B_EMPTY_Y + s), lane, ncl);
        // the epilogue writes over input rows chunk j + 1's depthwise reads
        if (j + 1 < nc)
          wait_spin_cluster(bar(B_FULL_Y + (q + 1) % YSTAGES),
                            ((q + 1) / YSTAGES) & 1);
        // the epilogue, branch-free: every value is computed, the stores
        // that fall outside the repeat's rows (or T) are predicated off
        {
          const bool bias_here = !(last && last_act && has_res);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = i_lo + 8 * h;
            const int g = t0 - halo + i;
            const bool valid = g >= 0 && g < len;
            if (!last) {                          // the next repeat's input
              const unsigned dst =
                  smem_u32(act + (min(i, hi - 1) - k2) * CW + 2 * tq);
#pragma unroll
              for (int jj = 0; jj < CW / 8; ++jj) {
                const int col = n0 + jj * 8 + 2 * tq;
                const float z0 = fmaxf(acc[4 * jj + 2 * h] + bias[col], 0.f);
                const float z1 =
                    fmaxf(acc[4 * jj + 2 * h + 1] + bias[col + 1], 0.f);
                st_shared2_if(i < hi, dst + jj * 32, valid ? z0 : 0.f,
                              valid ? z1 : 0.f);
              }
            } else {
              Tx* dst = out + ((size_t)b * T + min(g, T - 1)) * c_out + n0 +
                        2 * tq;
#pragma unroll
              for (int jj = 0; jj < CW / 8; ++jj) {
                const int col = n0 + jj * 8 + 2 * tq;
                float z[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  z[e] = acc[4 * jj + 2 * h + e] +
                         (bias_here ? bias[col + e] : 0.f);
                  if (last_act && !has_res) z[e] = fmaxf(z[e], 0.f);
                  z[e] = fmaxf(z[e] + (has_res ? resb[col + e] : 0.f), 0.f);
                }
                store2_if(i < hi && g < T, dst + jj * 8, z[0], z[1]);
              }
            }
          }
        }
        __syncwarp();
        mbar_arrive_if(bar(B_EPI + q % EPI_RING), lane == 0);
      }
    }
  }
  // no block of the cluster reads this block's chunk stages or arrives on
  // its barriers any more
  __syncwarp();
  cluster_sync();
}

int device_index() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev < MAX_DEVICES ? dev : MAX_DEVICES - 1;
}

bool plan_ok(int c_in, int c_out, int k, int r, int tt, int ncl,
             int x_bytes) {
  if (r < 1 || r > MAX_R || ncl < 1 || ncl > MAX_CLUSTER || tt < 16 ||
      tt % 16 || k < 1 || k % 2 == 0 || c_in % ncl || c_out % ncl ||
      c_in % 16)
    return false;
  const int cw = c_out / ncl, cw_in = c_in / ncl;
  if (cw % 16 || cw > CW_MAX || cw_in % 8 || cw_in < 8 || cw_in > CW_MAX)
    return false;
  // chunk j + 2's depthwise may run beside chunk j's in-place epilogue
  // (the header note's hazard)
  if (k / 2 > MR) return false;
  if (chunks_of(tt + 2 * (r - 1) * (k / 2)) > MAX_CHUNKS) return false;
  return layout(tt, k, r, cw, cw_in, x_bytes).total <= SMEM_MAX;
}

template <typename Tx, int CW>
cudaError_t set_smem_ceiling() {
  // the attribute is a ceiling, set once per instantiation and device
  static bool ready[MAX_DEVICES];
  const int dev = device_index();
  if (ready[dev]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      whole_block_kernel<Tx, CW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_MAX);
  if (err == cudaSuccess) ready[dev] = true;
  return err;
}

void launch_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                   dim3 grid, size_t smem, int ncl, cudaStream_t stream) {
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ncl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

template <typename Tx, int CW>
int launch(const void* x, const void* lens, const Weights& wts,
           const void* resw, const void* resb, void* out, int batch, int T,
           int c_in, int c_out, int k, int r, int last_act, int tt, int ncl,
           cudaStream_t stream) {
  cudaError_t err = set_smem_ceiling<Tx, CW>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  launch_config(cfg, attr, dim3(ncl, (T + tt - 1) / tt, batch),
                layout(tt, k, r, CW, c_in / ncl, sizeof(Tx)).total, ncl,
                stream);
  err = cudaLaunchKernelEx(&cfg, whole_block_kernel<Tx, CW>, (const Tx*)x,
                           (const int*)lens, wts,
                           (const __nv_bfloat16*)resw, (const float*)resb,
                           (Tx*)out, T, c_in, c_out, k, r, tt, last_act);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename Tx>
int launch_cw(int cw, const void* x, const void* lens, const Weights& wts,
              const void* resw, const void* resb, void* out, int batch, int T,
              int c_in, int c_out, int k, int r, int last_act, int tt,
              int ncl, cudaStream_t s) {
  switch (cw) {
    case 16:
      return launch<Tx, 16>(x, lens, wts, resw, resb, out, batch, T, c_in,
                            c_out, k, r, last_act, tt, ncl, s);
    case 32:
      return launch<Tx, 32>(x, lens, wts, resw, resb, out, batch, T, c_in,
                            c_out, k, r, last_act, tt, ncl, s);
    case 48:
      return launch<Tx, 48>(x, lens, wts, resw, resb, out, batch, T, c_in,
                            c_out, k, r, last_act, tt, ncl, s);
    case 64:
      return launch<Tx, 64>(x, lens, wts, resw, resb, out, batch, T, c_in,
                            c_out, k, r, last_act, tt, ncl, s);
  }
  return (int)cudaErrorInvalidValue;
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
// negative CUDA error. Every instantiation has the same block (THREADS
// threads, one block an SM), so the 64-column one stands for all.
extern "C" int vt_whole_clusters_at_once(int x_bf16, int ncl, int smem) {
  if (ncl < 1 || ncl > MAX_CLUSTER || smem < 0 || (size_t)smem > SMEM_MAX)
    return -(int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  launch_config(cfg, attr, dim3(ncl, 1, 1), smem, ncl, 0);
  int n = 0;
  cudaError_t err;
  if (x_bf16) {
    err = set_smem_ceiling<__nv_bfloat16, 64>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(
          &n, whole_block_kernel<__nv_bfloat16, 64>, &cfg);
  } else {
    err = set_smem_ceiling<float, 64>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&n, whole_block_kernel<float, 64>,
                                           &cfg);
  }
  return err == cudaSuccess ? n : -(int)err;
}

// The whole block in one launch. x (B, T, c_in) and out (B, T, c_out) are
// bf16 (x_bf16 = 1) or fp32; dw / pw / bias are r pointers each: the taps
// and 1x1 weights packed for a cluster of ncl blocks
// (ops/repeat_block.py::pack_whole_taps / pack_whole_weights), the (c_out,)
// fp32 biases; resw (packed like pw) and resb (c_out,) fp32 are null for no
// residual. tt (tile rows) and ncl (cluster size) are the plan's
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
  const int cw = c_out / ncl;
  if (x_bf16)
    return launch_cw<__nv_bfloat16>(cw, x, lens, wts, resw, resb, out, batch,
                                    T, c_in, c_out, k, r, last_act, tt, ncl,
                                    s);
  return launch_cw<float>(cw, x, lens, wts, resw, resb, out, batch, T, c_in,
                          c_out, k, r, last_act, tt, ncl, s);
}
