// Fused log-mel frontend for Hopper (sm_90a), the bf16 tensor-core route
// (fused_frontend="fast"): framing + windowed real DFT + power + mel + log,
// with per-16-frame (sum, sum of squares) partials for the per-feature
// normalization.
//
// Replaces: vietasr_tpu/frontend/pallas_frontend.py::_kernel at
// precision="default", the Pallas TPU kernel behind
// fused_log_mel_features(precision="default"). That kernel runs frames @
// windowed-DFT matrix and power @ mel as single bf16 passes on the TPU's
// matrix unit with fp32 accumulation. This kernel computes the same
// function with the same rounding points and no others:
//   - the pre-emphasized, reflect-padded fp32 signal rounded to bf16;
//   - the windowed DFT matrix (fp32, window folded in) rounded to bf16;
//   - frames @ DFT with fp32 accumulation (mma.sync m16n8k16);
//   - re^2 + im^2 in fp32 (no fused multiply-add), rounded to bf16;
//   - the mel filterbank rounded to bf16, power @ mel in fp32;
//   - the log guard (add or clamp) in fp32;
//   - per-16-frame partials over the valid frames, in frame order.
// A product of two bf16 values is exact in fp32, so this kernel and its
// plain version (frontend/cuda_frontend.py::log_mel_tiles_fast_plain)
// differ only in the order of the fp32 sums.
//
// What bounds it on the H100: operations. At B = 8 x 16.7 s the DFT is
// 2 * 318 * 514 bf16 operations a frame over the window's nonzero rows,
// 4.4 GFLOP for 13,368 frames: 0.0044 ms at 989 TFLOP/s, against 12.4 MB
// of input and output at 3.35 TB/s (0.0037 ms). This design is far from
// it: a tile is latency-bound, ~2,000 cycles for each of its 17 DFT
// chunks, whatever the chunk's mma and copies cost (phases cut out one at
// a time by tools/fast_phases.py); a redesign (wgmma, TMA, more frames a
// block) is later work.
//
// Design:
//   - the work is tiles of FRAMES = 64 consecutive frames of one row; as
//     many 8-warp blocks as fit on the card at once each walk their tiles;
//   - a tile's (FRAMES - 1) * hop + k_rows samples are staged in shared
//     memory once, as bf16, from sample k_lo of its first frame on (k_lo:
//     the window's first nonzero sample rounded down to 8). The frame
//     matrix is a strided view of them: frame f's row starts f * hop
//     samples in, a pitch of 320 bytes at hop 160, 16-byte aligned, so
//     ldmatrix reads it in place (this is the TPU kernel's hop-rows view).
//     At an 80-word pitch rows 0, 2, 4 and 6 of an 8-row matrix share
//     banks; each warp reads its 16 frames only once a tile, into
//     registers (k_rows / 16 fragments of 4 registers), so the conflict
//     costs little;
//   - the DFT operand is the matrix's k_rows nonzero-window rows (318,
//     padded to 320), transposed, with the re and im columns of each bin
//     side by side: bf16 (544, k_rows), 348 KB, more than a block's shared
//     memory. It streams through a 2-deep cp.async ring in chunks of 16
//     bins (32 columns), the same chunks for every tile; the ring's rows
//     are padded by 8 bf16, which makes ldmatrix conflict-free;
//   - warp w takes frames 16 (w & 3) .. + 15 and 8 of each chunk's 16
//     bins. An m16n8k16 accumulator holds (re, im) of one bin in adjacent
//     registers, so each thread forms its bins' power in registers and
//     writes it to a (64, 272) bf16 power tile in shared memory;
//   - the mel product power @ mel runs on the tensor cores too, 4 frame
//     tiles x ceil(n_mels / 8) mel tiles spread over the warps, the
//     power tile read by ldmatrix and the (n_mels, 272) bf16 mel matrix
//     from global memory (it stays in L1 / L2);
//   - the log with the guard goes to a float tile over the power tile's
//     memory; the rows inside t_out go out coalesced, and one thread per
//     (16-frame tile, mel) sums the valid frames' (value, value^2) in
//     frame order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NFFT = 512;           // real samples per frame
constexpr int FRAMES = 64;          // frames per tile (4 m16 tiles)
constexpr int PART = 16;            // frames per partials tile
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_KSTEPS = 20;      // DFT rows: at most 320 (k16 steps)
constexpr int BINS = 272;           // 257 bins padded to 17 k16 steps
constexpr int CHUNK_BINS = 16;      // bins per DFT chunk
constexpr int CHUNK_COLS = 2 * CHUNK_BINS;
constexpr int CHUNKS = BINS / CHUNK_BINS;
constexpr int PP = BINS + 8;        // power tile pitch (bf16): conflict-free
constexpr int MAX_MELS = 128;
constexpr int MAX_UNITS = (FRAMES / 16) * (MAX_MELS / 8) / WARPS;
static_assert(WARPS == 2 * (FRAMES / 16), "a warp takes half of a chunk's "
              "bins for one 16-frame slice");
static_assert(BINS % CHUNK_BINS == 0 && BINS >= NFFT / 2 + 1, "bins");

__host__ __device__ inline int sig_elems(int hop, int k_rows) {
  return ((FRAMES - 1) * hop + k_rows + 7) & ~7;
}

// bf16 offsets of the shared-memory pieces
struct Layout {
  int ring, stage, sig, pw, total;
};

__host__ __device__ inline Layout layout(int hop, int k_rows) {
  Layout s;
  s.stage = CHUNK_COLS * (k_rows + 8);
  s.ring = 0;
  s.sig = s.ring + 2 * s.stage;
  s.pw = s.sig + sig_elems(hop, k_rows);
  s.total = s.pw + FRAMES * PP;
  return s;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem));
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

// re^2 + im^2 in fp32 with each step rounded (no contraction), then bf16
__device__ __forceinline__ __nv_bfloat16 power_bf16(float re, float im) {
  return __float2bfloat16_rn(
      __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
}

__global__ void __launch_bounds__(THREADS, 2)
logmel_fast_kernel(const float* __restrict__ xp, long long n_total, int sp,
                   const int* __restrict__ seq_len,
                   const __nv_bfloat16* __restrict__ dft,  // (544, k_rows)
                   const __nv_bfloat16* __restrict__ mel,  // (mel8, BINS)
                   float* __restrict__ out,       // (B, t_out, n_mels)
                   float* __restrict__ parts,     // (B, n_part, 2, n_mels)
                   int t_out, int n_tiles, int n_part, int total_tiles,
                   int hop, int n_mels, int k_lo, int k_rows, float guard,
                   int guard_clamp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const Layout L = layout(hop, k_rows);
  __nv_bfloat16* ring = sm + L.ring;
  __nv_bfloat16* sig = sm + L.sig;
  __nv_bfloat16* pw = sm + L.pw;
  float* lm = reinterpret_cast<float*>(pw);   // the log tile, after the mel
  const int kp = k_rows + 8;                  // ring row pitch (bf16)
  const int ksteps = k_rows / 16;
  const int seg = k_rows / 8;                 // 16-byte pieces of a row

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = 16 * (warp & 3);             // this warp's frames
  const int half = warp >> 2;                 // its half of a chunk
  // ldmatrix x4 row address of this lane: matrix j = lane / 8, row lane % 8
  const int lj = lane >> 3, lr = lane & 7;
  const int mel_tiles = (n_mels + 7) / 8;
  const int units = 4 * mel_tiles;

  // chunk g of the block's stream (the same 17 chunks for every tile)
  auto fetch_chunk = [&](int g) {
    const __nv_bfloat16* src = dft + (size_t)(g % CHUNKS) * CHUNK_COLS *
                                         k_rows;
    __nv_bfloat16* dst = ring + (g & 1) * L.stage;
    for (int c = tid; c < CHUNK_COLS * seg; c += THREADS) {
      const int row = c / seg, s = c - row * seg;
      cp_async16(dst + row * kp + 8 * s, src + (size_t)row * k_rows + 8 * s);
    }
  };
  int g = 0;
  fetch_chunk(0);
  asm volatile("cp.async.commit_group;\n" ::);

  for (int id = blockIdx.x; id < total_tiles; id += gridDim.x) {
    const int b = id / n_tiles;
    const int tile = id - b * n_tiles;
    const int f0 = tile * FRAMES;

    // the tile's samples, from k_lo of frame f0 on, rounded to bf16; past
    // the end of xp they are zeros (only frames past t_out read there)
    const long long s0 = (long long)b * sp + (long long)f0 * hop + k_lo;
    const int span = sig_elems(hop, k_rows);
    for (int i = tid; i < span; i += THREADS) {
      const long long e = s0 + i;
      sig[i] = __float2bfloat16_rn(e < n_total ? xp[e] : 0.f);
    }
    __syncthreads();

    // this warp's 16 frames, every k16 step, into registers
    unsigned a[MAX_KSTEPS][4];
    {
      const __nv_bfloat16* base =
          sig + (m0 + (lj & 1) * 8 + lr) * hop + (lj >> 1) * 8;
#pragma unroll
      for (int ks = 0; ks < MAX_KSTEPS; ++ks)
        if (ks < ksteps) ldmatrix_x4(a[ks], base + 16 * ks);
    }

    // frames @ DFT, chunk by chunk; the power of each bin in registers
    for (int c = 0; c < CHUNKS; ++c, ++g) {
      if (c + 1 < CHUNKS || id + gridDim.x < total_tiles) fetch_chunk(g + 1);
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::);
      __syncthreads();
      const __nv_bfloat16* st = ring + (g & 1) * L.stage;
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      // matrices: (cols +0..7, k lo), (+0..7, k hi), (+8..15, lo), (hi)
      const __nv_bfloat16* bbase =
          st + (16 * half + (lj >> 1) * 8 + lr) * kp + (lj & 1) * 8;
#pragma unroll
      for (int ks = 0; ks < MAX_KSTEPS; ++ks) {
        if (ks < ksteps) {
          unsigned bf[4];
          ldmatrix_x4(bf, bbase + 16 * ks);
          mma_bf16(acc[0], a[ks], bf[0], bf[1]);
          mma_bf16(acc[1], a[ks], bf[2], bf[3]);
        }
      }
      // accumulator (re, im) pairs: bin 4 t + lane % 4 of the n8 tile t,
      // frames lane / 4 and lane / 4 + 8
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int bin = c * CHUNK_BINS + 8 * half + 4 * t + (lane & 3);
        const int row = m0 + (lane >> 2);
        pw[row * PP + bin] = power_bf16(acc[t][0], acc[t][1]);
        pw[(row + 8) * PP + bin] = power_bf16(acc[t][2], acc[t][3]);
      }
      __syncthreads();                 // this ring stage is free again
    }

    // power @ mel: unit u = (frame slice u % 4, mel tile u / 4)
    float macc[MAX_UNITS][4];
#pragma unroll
    for (int j = 0; j < MAX_UNITS; ++j) {
      macc[j][0] = macc[j][1] = macc[j][2] = macc[j][3] = 0.f;
      const int u = warp + j * WARPS;
      if (u < units) {
        const int mt = u & 3, nt = u >> 2;
        const __nv_bfloat16* abase =
            pw + (16 * mt + (lj & 1) * 8 + lr) * PP + (lj >> 1) * 8;
        const unsigned* bcol = reinterpret_cast<const unsigned*>(
            mel + (size_t)(8 * nt + (lane >> 2)) * BINS + 2 * (lane & 3));
#pragma unroll
        for (int ks = 0; ks < BINS / 16; ++ks) {
          unsigned af[4];
          ldmatrix_x4(af, abase + 16 * ks);
          mma_bf16(macc[j], af, __ldg(bcol + 8 * ks),
                   __ldg(bcol + 8 * ks + 4));
        }
      }
    }
    __syncthreads();                   // every read of the power tile

    // log with the guard into the float tile (pitch n_mels + 1)
#pragma unroll
    for (int j = 0; j < MAX_UNITS; ++j) {
      const int u = warp + j * WARPS;
      if (u < units) {
        const int row = 16 * (u & 3) + (lane >> 2);
        const int col = 8 * (u >> 2) + 2 * (lane & 3);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row + 8 * (e >> 1), m = col + (e & 1);
          if (m < n_mels) {
            const float v = macc[j][e];
            lm[r * (n_mels + 1) + m] =
                guard_clamp ? logf(fmaxf(v, guard)) : logf(v + guard);
          }
        }
      }
    }
    __syncthreads();

    // the rows inside t_out, coalesced
    const int rows = min(FRAMES, t_out - f0);
    float* dst = out + ((size_t)b * t_out + f0) * n_mels;
    for (int i = tid; i < rows * n_mels; i += THREADS)
      dst[i] = lm[i + i / n_mels];
    // partials over the valid frames of each 16-frame tile, in frame order
    for (int q = tid; q < (FRAMES / PART) * n_mels; q += THREADS) {
      const int sub = q / n_mels, m = q - sub * n_mels;
      const int pt = tile * (FRAMES / PART) + sub;
      if (pt >= n_part) continue;
      const int valid = max(0, min(seq_len[b] - pt * PART, PART));
      float s1 = 0.f, s2 = 0.f;
      for (int i = 0; i < valid; ++i) {
        const float v = lm[(sub * PART + i) * (n_mels + 1) + m];
        s1 += v;
        s2 += v * v;
      }
      float* part = parts + ((size_t)b * n_part + pt) * 2 * n_mels;
      part[m] = s1;
      part[n_mels + m] = s2;
    }
    __syncthreads();                   // the float tile is read
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

}  // namespace

extern "C" int vt_logmel_fast_frames_per_tile() { return PART; }

extern "C" int vt_logmel_fast_bins() { return BINS; }

extern "C" int vt_logmel_fast_max_rows() { return 16 * MAX_KSTEPS; }

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Dynamic shared-memory bytes one launch asks for; 0 when the shape is
// outside the kernel's plan (the wrapper refuses it): n_fft 512, a hop
// that is a multiple of 8 (16-byte aligned frame rows), at most 128 mels,
// k_rows a multiple of 16 of at most 320 DFT rows.
extern "C" long long vt_logmel_fast_smem_bytes(int n_fft, int hop,
                                               int n_mels, int k_rows) {
  if (n_fft != NFFT || hop < 8 || hop > NFFT || hop % 8 || n_mels < 1 ||
      n_mels > MAX_MELS || k_rows < 16 || k_rows % 16 ||
      k_rows > 16 * MAX_KSTEPS)
    return 0;
  return 2LL * layout(hop, k_rows).total;
}

// Returns cudaGetLastError() after the launch (0 = launched). dft is the
// bf16 (2 * BINS, k_rows) transposed windowed-DFT rows k_lo .. k_lo +
// k_rows - 1 with re and im of each bin side by side, mel the bf16
// (ceil(n_mels / 8) * 8, BINS) transposed filterbank, both zero-padded
// (frontend/cuda_frontend.py::fast_tables); k_lo a multiple of 8 with
// k_lo + k_rows <= n_fft.
extern "C" int vt_logmel_fast_forward(const void* xp, const void* seq_len,
                                      const void* dft, const void* mel,
                                      void* out, void* parts, int batch,
                                      int sp, int t_out, int n_fft, int hop,
                                      int n_mels, int k_lo, int k_rows,
                                      float guard, int guard_clamp,
                                      void* stream) {
  const long long smem = vt_logmel_fast_smem_bytes(n_fft, hop, n_mels,
                                                   k_rows);
  if (smem == 0 || k_lo < 0 || k_lo % 8 || k_lo + k_rows > n_fft ||
      t_out < 1 || batch < 1 || sp < n_fft || ((uintptr_t)dft & 15) != 0 ||
      ((uintptr_t)mel & 3) != 0)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (t_out + FRAMES - 1) / FRAMES;
  const int n_part = (t_out + PART - 1) / PART;
  const long long total = (long long)n_tiles * batch;
  if (total > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      logmel_fast_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, logmel_fast_kernel, THREADS, (size_t)smem)) !=
          cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int blocks = (int)(total < (long long)sms * per_sm
                               ? total : (long long)sms * per_sm);
  logmel_fast_kernel<<<blocks, THREADS, (size_t)smem,
                       (cudaStream_t)stream>>>(
      (const float*)xp, (long long)batch * sp, sp, (const int*)seq_len,
      (const __nv_bfloat16*)dft, (const __nv_bfloat16*)mel, (float*)out,
      (float*)parts, t_out, n_tiles, n_part, (int)total, hop, n_mels, k_lo,
      k_rows, guard, guard_clamp);
  return (int)cudaGetLastError();
}
