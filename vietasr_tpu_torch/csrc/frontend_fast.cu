// Fused log-mel frontend for Hopper (sm_90a), the bf16 tensor-core route
// (fused_frontend="fast"): framing + windowed real DFT + power + mel + log,
// with per-16-frame (sum, M2) partials for the per-feature normalization,
// M2 the sum of squares about the tile's own mean (merged across tiles by
// Chan et al.'s parallel formula in frontend/cuda_frontend.py::
// merge_tile_stats).
//
// Replaces: vietasr_tpu/frontend/pallas_frontend.py::_kernel at
// precision="default", the Pallas TPU kernel behind
// fused_log_mel_features(precision="default"). That kernel runs frames @
// windowed-DFT matrix and power @ mel as single bf16 passes on the TPU's
// matrix unit with fp32 accumulation. This kernel computes the same
// function with the same rounding points and no others:
//   - the pre-emphasized, reflect-padded fp32 signal rounded to bf16;
//   - the windowed DFT matrix (fp32, window folded in) rounded to bf16;
//   - frames @ DFT with fp32 accumulation (wgmma m64n32k16);
//   - re^2 + im^2 in fp32 (no fused multiply-add), rounded to bf16;
//   - the mel filterbank rounded to bf16, power @ mel in fp32 (mma.sync);
//   - the log guard (add or clamp) in fp32;
//   - per-16-frame partials over the valid frames, in frame order: the
//     sum and M2 about the tile's mean, from one fp32 pass over the
//     deviations from the tile's first frame, as csrc/frontend.cu takes
//     them.
// A product of two bf16 values is exact in fp32, so this kernel and its
// plain version (frontend/cuda_frontend.py::log_mel_tiles_fast_plain)
// differ only in the order of the fp32 sums.
//
// What bounds it on the H100: operations. At B = 8 x 16.7 s the DFT is
// 2 * 318 * 514 bf16 operations a frame over the window's nonzero rows,
// 4.4 GFLOP for 13,368 frames: 0.0044 ms at 989 TFLOP/s, against 12.4 MB
// of input and output at 3.35 TB/s (0.0037 ms). The DFT operand (bf16,
// 544 columns x 320 rows, 348 KB) does not fit a block's shared memory,
// so every block streams all of it from L2 for every tile it computes,
// and a tile's DFT on one SM takes ~11,000 cycles of tensor-core time:
// the design keeps the tensor cores on that stream and hides the rest.
//
// Design:
//   - persistent blocks, one per SM, each walking tiles of `frames`
//     consecutive frames of one row (128, or 64 at hops above 376: see
//     frontend/cuda_frontend.py::fast_plan), with one consumer warpgroup
//     per 64 frames and one producer warpgroup;
//   - the producer's first thread streams the DFT operand through a ring
//     of `stages` shared-memory stages, one 32-column chunk (16 bins,
//     20 KB) a stage, 17 chunks a tile and then the tile's mel blocks,
//     the ring running on across tiles: one cp.async.bulk per stage that
//     completes on the stage's full mbarrier (expect_tx), after waiting
//     for the stage's empty mbarrier. The table in global memory is laid
//     out exactly as a stage holds it (fast_tables), so the copy is 1-D
//     and needs no tensor map;
//   - a stage is the wgmma B operand, K-major without swizzle: 8 columns x
//     8 rows (16 bytes) core matrices, 128 bytes apart along the columns
//     (SBO) and 512 bytes apart along k (LBO). Both consumer warpgroups
//     read each stage, so each DFT byte crosses from L2 once per 128
//     frames and the tensor cores read it from shared memory once per 64;
//   - the frames are the wgmma A operand, from registers: a tile's samples
//     are staged in shared memory as bf16 from sample k_lo of its first
//     frame on, and each warp reads its 16 frames by ldmatrix from the
//     strided view (frame f's row starts f * hop samples in) into 20
//     m16k16 fragments (320 DFT rows, zero rows past the window's). A
//     16-byte pad after every hop samples when hop / 8 is even puts 8
//     consecutive frames on 8 bank groups. The consumers stage a block's
//     first tile; the producer's other three warps stage each later tile
//     as soon as every consumer has read the tile before into registers,
//     while that tile's products run (a full and an empty mbarrier);
//   - a consumer warpgroup issues a chunk's 20 wgmmas into one of two
//     accumulator sets, commits them, and while they run turns the
//     previous chunk's accumulators into power (in the m64n32 layout a
//     bin's (re, im) lie in adjacent registers of one thread) and releases
//     its stage. The chunk loop has no block-wide barrier;
//   - power @ mel on mma.sync, each warp its own 16 rows of the bf16 power
//     tile against every 8-mel tile, over the 16-bin steps of the tile's
//     band only: the filterbank is banded (24 of 136 blocks at 64 mels;
//     the rest add exact zeros), and its bands' blocks arrive in the ring
//     stage after the DFT chunks, in fragment order, 256 contiguous bytes
//     a warp load;
//   - each warp's mel accumulators go, as floats, over its own rows of the
//     power tile; then a lane per mel takes the log with the guard, writes
//     the rows inside t_out (coalesced) and sums the valid frames'
//     deviations from the tile's first frame and their squares in frame
//     order, which give the (sum, M2) partials: a warp's 16 frames are
//     one partials tile.
//     Short loops and no inlined copies of logf keep a tile's code in the
//     instruction cache (on the H100 a fully unrolled epilogue cost
//     ~10,000 cycles a tile in instruction fetch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int NFFT = 512;           // real samples per frame
constexpr int WG_FRAMES = 64;       // frames per consumer warpgroup (m64)
constexpr int MAX_WGS = 2;          // consumer warpgroups: 128 frames
constexpr int MAX_THREADS = 128 * MAX_WGS + 128;  // + the producers
constexpr int STAGERS = 96;         // producer threads that stage samples
constexpr int PART = 16;            // frames per partials tile
constexpr int KSTEPS = 20;          // k16 steps: 320 DFT rows, always
constexpr int KROWS = 16 * KSTEPS;
constexpr int BINS = 272;           // 257 bins padded to 17 k16 steps
constexpr int CHUNK_COLS = 32;      // DFT columns a chunk: wgmma n32
constexpr int CHUNK_BINS = CHUNK_COLS / 2;
constexpr int CHUNKS = 2 * BINS / CHUNK_COLS;
constexpr int CORE_BYTES = 128;     // a core matrix: 8 x 16 bytes
constexpr int SBO = CORE_BYTES;     // next 8 columns
constexpr int LBO = CHUNK_COLS / 8 * CORE_BYTES;   // next 8 rows of k
constexpr int PP = BINS + 8;        // power tile pitch (bf16): conflict-free
constexpr int MAX_MELS = 128;
constexpr int MEL_TILES = MAX_MELS / 8;
constexpr int MEL_KSTEPS = BINS / 16;
constexpr int MAX_STAGES = 8;
// full + empty per ring stage, then for the sample buffer
constexpr int BAR_BYTES = 256;
static_assert(BAR_BYTES >= 8 * (2 * MAX_STAGES + 2), "barriers");
static_assert(CHUNKS * CHUNK_BINS == BINS && BINS >= NFFT / 2 + 1, "bins");
static_assert(BAR_BYTES % 128 == 0, "the ring starts 128-byte aligned");
// the mel blocks ride the ring after a tile's DFT chunks: at most a stage
constexpr int MAX_MEL_BLOCKS = CHUNK_COLS * KROWS * 2 / 256;

// the filterbank's band in each 8-mel tile: the k16 steps lo .. lo + n - 1
// of power @ mel hold all of the tile's taps, in its n blocks of the table
// from block `first` on (fast_tables' mel_bands)
struct MelBands {
  unsigned char lo[MEL_TILES], n[MEL_TILES], first[MEL_TILES];
};

// bf16 appended after every hop samples of the staged signal, so that 8
// consecutive frames start on 8 different 16-byte bank groups
__host__ __device__ inline int sig_pad(int hop) {
  return (hop / 8) % 2 == 0 ? 8 : 0;
}

// byte offsets of the shared-memory pieces (the barriers first)
struct Layout {
  int ring, stage, sig, sig_elems, pw, total;
};

__host__ __device__ inline Layout layout(int hop, int frames, int stages) {
  Layout s;
  const int span = (frames - 1) * hop + KROWS;     // a tile's samples
  s.stage = CHUNK_COLS * KROWS * 2;
  s.ring = BAR_BYTES;
  s.sig = s.ring + stages * s.stage;
  s.sig_elems = span + (span - 1) / hop * sig_pad(hop);
  s.pw = s.sig + 2 * s.sig_elems;
  s.total = s.pw + frames * PP * 2;
  return s;
}

// the consumer threads' own barrier (the producer warpgroup never joins)
__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16 x 16 bf16, row) * b (16 x 8 bf16, col), fp32 accumulation
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the wgmma B descriptor of a ring stage's k16 step at `addr`
__device__ __forceinline__ unsigned long long desc_b(unsigned addr) {
  return gmma_desc_k(addr, LBO, SBO);
}

// re^2 + im^2 in fp32 with each step rounded (no contraction), then bf16
__device__ __forceinline__ __nv_bfloat16 power_bf16(float re, float im) {
  return __float2bfloat16_rn(
      __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
}

// a chunk's accumulators -> the power tile: n8 slice i holds (re, im) of
// bin 4 i + lane % 4 for rows lane / 4 and lane / 4 + 8 of the warp
__device__ __forceinline__ void store_power(__nv_bfloat16* pw, int row,
                                            int bin0, const float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    pw[row * PP + bin0 + 4 * i] = power_bf16(d[4 * i], d[4 * i + 1]);
    pw[(row + 8) * PP + bin0 + 4 * i] = power_bf16(d[4 * i + 2],
                                                   d[4 * i + 3]);
  }
}

// a tile's `span` samples from xp[s0] on, rounded to bf16, into `sig` (a
// pad after every hop of them), by `n` threads from thread `t`: aligned
// float4 loads, 8 in flight a thread; past the end of xp they are zeros
// (only frames past t_out read there)
__device__ __forceinline__ void stage_samples(
    __nv_bfloat16* sig, const float* __restrict__ xp, long long n_total,
    long long s0, int span, int pad, unsigned hop_magic, int t, int n) {
  const long long e0 = s0 & ~3LL;
  const int sh = (int)(s0 - e0);
  const int quads = (span + sh + 3) >> 2;
  for (int j0 = t; j0 < quads; j0 += 8 * n) {
    float v[8][4];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = j0 + u * n;
      const long long e = e0 + 4LL * j;
      if (j < quads && e + 3 < n_total) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(xp + e));
        v[u][0] = q.x;
        v[u][1] = q.y;
        v[u][2] = q.z;
        v[u][3] = q.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[u][k] = (j < quads && e + k < n_total) ? __ldg(xp + e + k) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = j0 + u * n;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 4 * j + k - sh;
        if (j < quads && i >= 0 && i < span)
          sig[i + pad * (int)__umulhi((unsigned)i, hop_magic)] =
              __float2bfloat16_rn(v[u][k]);
      }
    }
  }
}

__global__ void __launch_bounds__(MAX_THREADS, 1)
logmel_fast_kernel(const float* __restrict__ xp, long long n_total, int sp,
                   const int* __restrict__ seq_len,
                   const __nv_bfloat16* __restrict__ dft,  // 17 stages
                   const __nv_bfloat16* __restrict__ mel,  // blocks
                   const MelBands bands, int mel_bytes,
                   float* __restrict__ out,       // (B, t_out, n_mels)
                   float* __restrict__ parts,     // (B, n_part, 2, n_mels)
                   int t_out, int n_tiles, int n_part, int total_tiles,
                   int hop, int n_mels, int k_lo, int frames, int stages,
                   float guard, int guard_clamp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(hop, frames, stages);
  const int cwarps = frames / 16;             // consumer warps
  const int cthreads = 32 * cwarps;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // full[s] at bars + 8 s, empty[s] at bars + 8 (MAX_STAGES + s); the
  // sample buffer's full at sig_bars, its empty at sig_bars + 8
  const unsigned bars = smem_u32(smem);
  const unsigned sig_bars = bars + 8 * 2 * MAX_STAGES;
  const unsigned ring = smem_u32(smem + L.ring);
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (MAX_STAGES + s), cwarps);
    }
    mbar_init(sig_bars, STAGERS);
    mbar_init(sig_bars + 8, cthreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  __nv_bfloat16* sig = reinterpret_cast<__nv_bfloat16*>(smem + L.sig);
  const int span = (frames - 1) * hop + KROWS;
  const int pad = sig_pad(hop);
  // i / hop for i < 2^16 as __umulhi(i, hop_magic)
  const unsigned hop_magic = 0xffffffffu / (unsigned)hop + 1u;
  if (warp > cwarps) {
    // the stagers: the samples of the block's tiles after its first, each
    // as soon as the consumers have read the tile before into registers,
    // while that tile's products run
    int t = 1;
    for (int id = blockIdx.x + gridDim.x; id < total_tiles;
         id += gridDim.x, ++t) {
      const int b = id / n_tiles;
      mbar_wait(sig_bars + 8, (t - 1) & 1);
      stage_samples(sig, xp, n_total,
                    (long long)b * sp +
                        (long long)(id - b * n_tiles) * frames * hop + k_lo,
                    span, pad, hop_magic, tid - cthreads - 32, STAGERS);
      mbar_arrive(sig_bars);
    }
    return;
  }
  if (warp == cwarps) {
    // the producer: the same 17 chunks for every tile of this block
    if (lane == 0) {
      int stage = 0;
      unsigned phase = 0;
      for (int id = blockIdx.x; id < total_tiles; id += gridDim.x) {
        for (int c = 0; c < CHUNKS; ++c) {
          mbar_wait(bars + 8 * (MAX_STAGES + stage), phase ^ 1);
          const unsigned full = bars + 8 * stage;
          mbar_expect_tx(full, L.stage);
          bulk_copy(ring + stage * L.stage,
                    dft + (size_t)c * CHUNK_COLS * KROWS, L.stage, full);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
        // then the mel blocks, for the tile's power @ mel
        mbar_wait(bars + 8 * (MAX_STAGES + stage), phase ^ 1);
        const unsigned full = bars + 8 * stage;
        mbar_expect_tx(full, mel_bytes);
        bulk_copy(ring + stage * L.stage, mel, mel_bytes, full);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  __nv_bfloat16* pw = reinterpret_cast<__nv_bfloat16*>(smem + L.pw);
  const int m0 = 16 * warp;                   // this warp's 16 frames
  // ldmatrix x4 row address of this lane: matrix j = lane / 8, row lane % 8
  const int lj = lane >> 3, lr = lane & 7;
  const int mel_tiles = (n_mels + 7) / 8;
  int stage = 0;
  unsigned phase = 0;

  int t = 0;                                  // the block's tile count
  for (int id = blockIdx.x; id < total_tiles; id += gridDim.x, ++t) {
    const int b = id / n_tiles;
    const int tile = id - b * n_tiles;
    const int f0 = tile * frames;

    // the tile's samples, from k_lo of frame f0 on: the block's first
    // tile's staged by the consumers themselves, the others' by the
    // stagers while the tile before ran
    if (t == 0) {
      stage_samples(sig, xp, n_total,
                    (long long)b * sp + (long long)f0 * hop + k_lo, span,
                    pad, hop_magic, tid, cthreads);
      consumer_sync(cthreads);
    } else {
      mbar_wait(sig_bars, (t - 1) & 1);
    }

    // this warp's 16 frames, every k16 step, into registers
    unsigned a[KSTEPS][4];
    {
      const int i0 = (m0 + (lj & 1) * 8 + lr) * hop + (lj >> 1) * 8;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const unsigned i = (unsigned)(i0 + 16 * ks);
        ldmatrix_x4(a[ks], sig + i + pad * __umulhi(i, hop_magic));
      }
    }
    mbar_arrive(sig_bars + 8);                // the samples are read

    // frames @ DFT, chunk by chunk, on wgmma; chunk c - 1's power while
    // chunk c's products run, the accumulators alternating
    float acc[2][16];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[c][i] = 0.f;
    const int prow = m0 + (lane >> 2);
    int prev = 0;
    // chunk c into d; then chunk c - 1's power from o
    auto chunk = [&](int c, float(&d)[16], float(&o)[16]) {
      mbar_wait(bars + 8 * stage, phase);     // chunk c has landed
      const unsigned st = ring + stage * L.stage;
      fence_acc(d);
      wgmma_fence();
      wgmma_n32<0>(d, a[0], desc_b(st));
#pragma unroll
      for (int ks = 1; ks < KSTEPS; ++ks)
        wgmma_n32<1>(d, a[ks], desc_b(st + 2 * LBO * ks));
      wgmma_commit();
      if (c > 0) {
        wgmma_wait<1>();                       // chunk c - 1 is done
        fence_acc(o);
        if (lane == 0) mbar_arrive(bars + 8 * (MAX_STAGES + prev));
        store_power(pw, prow, (c - 1) * CHUNK_BINS + (lane & 3), o);
      }
      prev = stage;
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    };
#pragma unroll 1
    for (int c = 0; c + 1 < CHUNKS; c += 2) {
      chunk(c, acc[0], acc[1]);
      chunk(c + 1, acc[1], acc[0]);
    }
    static_assert(CHUNKS % 2 == 1, "the last chunk goes to acc[0]");
    chunk(CHUNKS - 1, acc[0], acc[1]);
    wgmma_wait<0>();
    fence_acc(acc[0]);
    if (lane == 0) mbar_arrive(bars + 8 * (MAX_STAGES + prev));
    store_power(pw, prow, (CHUNKS - 1) * CHUNK_BINS + (lane & 3), acc[0]);
    __syncwarp();      // each warp reads back only the rows it wrote

    // power @ mel: this warp's 16 frames against every 8-mel tile, over
    // the 16-bin steps of the tile's band (the blocks outside it are
    // zeros: skipping them leaves every sum as it is), the blocks from the
    // ring stage after the DFT chunks
    float macc[MEL_TILES][4];
#pragma unroll
    for (int nt = 0; nt < MEL_TILES; ++nt)
      macc[nt][0] = macc[nt][1] = macc[nt][2] = macc[nt][3] = 0.f;
    mbar_wait(bars + 8 * stage, phase);       // the mel blocks have landed
    {
      const __nv_bfloat16* abase =
          pw + (m0 + (lj & 1) * 8 + lr) * PP + (lj >> 1) * 8;
      const uint2* blocks =
          reinterpret_cast<const uint2*>(smem + L.ring + stage * L.stage) +
          lane;
#pragma unroll
      for (int nt = 0; nt < MEL_TILES; ++nt) {
        if (nt < mel_tiles) {
          const __nv_bfloat16* ab = abase + 16 * bands.lo[nt];
          const uint2* bt = blocks + 32 * bands.first[nt];
#pragma unroll 1
          for (int j = 0; j < bands.n[nt]; ++j) {
            unsigned af[4];
            ldmatrix_x4(af, ab + 16 * j);
            const uint2 bv = bt[32 * j];
            mma_bf16(macc[nt], af, bv.x, bv.y);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (MAX_STAGES + stage));
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }

    // the accumulators, as floats, to this warp's own rows of the power
    // tile (it has read them); then per mel, one lane: the log with the
    // guard, the rows inside t_out to global memory, and the (sum, M2
    // about the tile's mean) of the frames inside seq_len over the warp's
    // 16 frames (one partials tile), in frame order, from their
    // deviations from the first frame
    {
      float* lm = reinterpret_cast<float*>(pw + m0 * PP);
      const int lp = 8 * mel_tiles + 8;        // row pitch (floats)
      __syncwarp();
#pragma unroll
      for (int nt = 0; nt < MEL_TILES; ++nt) {
        if (nt < mel_tiles) {
          float* d = lm + (lane >> 2) * lp + 8 * nt + 2 * (lane & 3);
          *reinterpret_cast<float2*>(d) = make_float2(macc[nt][0],
                                                      macc[nt][1]);
          *reinterpret_cast<float2*>(d + 8 * lp) = make_float2(macc[nt][2],
                                                               macc[nt][3]);
        }
      }
      __syncwarp();
      const int f = f0 + m0;
      const int pt = f / PART;
      const int valid = seq_len[b];
      float* orow = out + ((size_t)b * t_out + f) * n_mels;
      const int rows = min(max(valid - f, 0), PART);   // inside seq_len
      const float inv = 1.f / (float)max(rows, 1);
      for (int m = lane; m < n_mels; m += 32) {
        // the deviations from the tile's first frame, in fp32
        float v0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll 4
        for (int r = 0; r < PART; ++r) {
          const float x = lm[r * lp + m];
          const float v = guard_clamp ? logf(fmaxf(x, guard)) : logf(x + guard);
          if (f + r < t_out) orow[r * n_mels + m] = v;
          if (r == 0) v0 = v;
          if (r < rows) {
            const float d = v - v0;
            s1 += d;
            s2 = fmaf(d, d, s2);
          }
        }
        if (pt < n_part) {
          float* part = parts + ((size_t)b * n_part + pt) * 2 * n_mels;
          part[m] = rows > 0 ? fmaf((float)rows, v0, s1) : 0.f;
          part[n_mels + m] = rows > 0 ? fmaxf(s2 - s1 * s1 * inv, 0.f) : 0.f;
        }
      }
    }
    __syncwarp();      // before the next tile's power over these rows
  }
}

}  // namespace

extern "C" int vt_logmel_fast_frames_per_tile() { return PART; }

extern "C" int vt_logmel_fast_bins() { return BINS; }

extern "C" int vt_logmel_fast_max_rows() { return KROWS; }

extern "C" int vt_logmel_fast_chunk_cols() { return CHUNK_COLS; }

extern "C" int vt_logmel_fast_max_stages() { return MAX_STAGES; }

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Dynamic shared-memory bytes of the launch plan (frames a block, ring
// stages); 0 when the shape or the plan is outside the kernel's reach (the
// wrapper refuses it): n_fft 512, a hop from 8 to 512 that is a multiple
// of 8 (16-byte aligned frame rows), 1 to 128 mels, the window inside
// KROWS = 320 DFT rows (k_rows: the DFT rows held, zero-padded to KROWS;
// fast_rows); 64 or 128 frames, 2 to MAX_STAGES stages.
extern "C" long long vt_logmel_fast_plan_smem(int n_fft, int hop, int n_mels,
                                              int k_rows, int frames,
                                              int stages) {
  if (n_fft != NFFT || hop < 8 || hop > NFFT || hop % 8 || n_mels < 1 ||
      n_mels > MAX_MELS || k_rows != KROWS ||
      (frames != WG_FRAMES && frames != MAX_WGS * WG_FRAMES) ||
      stages < 2 || stages > MAX_STAGES)
    return 0;
  return layout(hop, frames, stages).total;
}

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a plan that is not the kernel's own or does
// not fit the device; writes the blocks launched to *blocks. dft is the
// bf16 DFT operand in the ring's stage layout (fast_tables: 17 chunks of
// 32 columns in core-matrix order, rows k_lo .. k_lo + KROWS - 1,
// zero-padded), mel the bf16 filterbank's 16-bin x 8-mel blocks in each
// 8-mel tile's band, in mma.sync B-fragment order, 256 bytes each, by tile
// and then 16-bin step, mel_bands the (first k16 step, steps) of each
// tile's band and mel_blocks their count; k_lo a
// multiple of 8 with k_lo + KROWS <= n_fft; (frames, chunk_cols, stages,
// smem) the plan (frontend/cuda_frontend.py::fast_plan).
extern "C" int vt_logmel_fast_forward(const void* xp, const void* seq_len,
                                      const void* dft, const void* mel,
                                      const int* mel_bands, int mel_blocks,
                                      void* out, void* parts, int batch,
                                      int sp, int t_out, int n_fft, int hop,
                                      int n_mels, int k_lo, int k_rows,
                                      int frames, int chunk_cols, int stages,
                                      long long smem, float guard,
                                      int guard_clamp, int* blocks,
                                      void* stream) {
  *blocks = 0;
  MelBands bands;
  int held = 0;
  for (int nt = 0; nt < MEL_TILES; ++nt) {
    const int lo = nt < (n_mels + 7) / 8 ? mel_bands[2 * nt] : 0;
    const int n = nt < (n_mels + 7) / 8 ? mel_bands[2 * nt + 1] : 0;
    if (lo < 0 || n < 0 || lo + n > MEL_KSTEPS)
      return (int)cudaErrorInvalidValue;
    bands.lo[nt] = (unsigned char)lo;
    bands.n[nt] = (unsigned char)n;
    bands.first[nt] = (unsigned char)held;
    held += n;
  }
  if (held != mel_blocks || held < 1 || held > MAX_MEL_BLOCKS || smem <= 0 ||
      chunk_cols != CHUNK_COLS ||
      smem != vt_logmel_fast_plan_smem(n_fft, hop, n_mels, k_rows, frames,
                                       stages) ||
      k_lo < 0 || k_lo % 8 || k_lo + KROWS > n_fft || t_out < 1 ||
      batch < 1 || sp < n_fft || ((uintptr_t)xp & 15) != 0 ||
      ((uintptr_t)dft & 15) != 0 || ((uintptr_t)mel & 7) != 0)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (t_out + frames - 1) / frames;
  const int n_part = (t_out + PART - 1) / PART;
  const long long total = (long long)n_tiles * batch;
  if (total > 0x7fffffff) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, limit = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess)
    return (int)err;
  if (smem > limit) return (int)cudaErrorInvalidValue;
  const int threads = 2 * frames + 128;
  if ((err = cudaFuncSetAttribute(logmel_fast_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, logmel_fast_kernel, threads, (size_t)smem)) !=
          cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = (int)(total < (long long)sms * per_sm
                             ? total : (long long)sms * per_sm);
  logmel_fast_kernel<<<grid, threads, (size_t)smem, (cudaStream_t)stream>>>(
      (const float*)xp, (long long)batch * sp, sp, (const int*)seq_len,
      (const __nv_bfloat16*)dft, (const __nv_bfloat16*)mel, bands,
      256 * mel_blocks, (float*)out,
      (float*)parts, t_out, n_tiles, n_part, (int)total, hop, n_mels, k_lo,
      frames, stages, guard, guard_clamp);
  err = cudaGetLastError();
  if (err == cudaSuccess) *blocks = grid;
  return (int)err;
}
