// Fused log-mel frontend for Hopper (sm_90a): framing + windowed real DFT
// + power + mel + log, with per-tile (sum, sum of squares) partials for the
// per-feature normalization.
//
// Replaces: vietasr_tpu/frontend/pallas_frontend.py::_kernel (the Pallas
// TPU kernel behind fused_log_mel_features).
//
// Input is the pre-emphasized, reflect-padded signal xp (B, S + n_fft); the
// wrapper (frontend/cuda_frontend.py) makes it with two plain PyTorch ops,
// as the JAX package made it with two XLA ops. One block handles FRAMES =
// 32 consecutive frames of one row: their samples sit in shared memory once
// ((FRAMES-1)*hop + n_fft floats, 21.9 KB at hop 160 / n_fft 512), so
// frames read overlapping windows without the overlapping tile copies the
// TPU kernel needed.
//
// What bounds it on the H100: the DFT is 2 * rows * (2 * n_bins) fp32
// operations per frame, where rows are the window's nonzero samples (318
// of n_fft = 512 at win_length 320: 0.33 MFLOP per frame, 4.4 GFLOP for
// 8 x 16.7 s with the band-limited mel), against ~13 MB of bytes moved, so
// it is bound by operations. It must be IEEE
// fp32 (the DFT has heavy cancellation and log() turns TF32/bf16 error
// into O(1) feature error), so it runs on the CUDA cores' FFMA
// (67 TFLOP/s), not the tensor cores. The DFT is a (frames x n_fft) x
// (n_fft x [re | im]) product with the frames read from the shared signal,
// so the design is a register-tiled SGEMM whose operand loads stay below
// the FFMA rate:
//   - the first nb_main = 256 bins: each thread accumulates 4 frames x 8
//     bins x (re, im) = 64 sums in registers; per sample it loads 4 frame
//     values (one 16-byte load, shared by 8 lanes) and 16 coefficients
//     (four 16-byte loads, one 128-byte wavefront each) for 64 FFMAs;
//   - the wrapper packs those bins' coefficients as (n_fft, 512) = [re |
//     im] with 2 KB rows, and they stream through two shared-memory buffers
//     of CHUNK rows with 16-byte cp.async copies while the previous chunk is
//     used (8 copies per thread per chunk); each chunk's frame values are
//     transposed into a small (CHUNK x FRAMES) tile; the sample loop over a
//     chunk unrolls fully;
//   - only the rows [row_lo, row_hi) run: the wrapper finds the window's
//     nonzero rows once and rounds them out to CHUNK (rows 96..415 of 512
//     at win_length 320); every row skipped is exactly zero;
//   - the last n_bins - nb_main bins (the Nyquist bin) are one warp dot
//     product per (frame, bin), over coefficient rows the wrapper packs
//     contiguous ((n_bins - 256, 2, n_fft));
//   - the power spectrum is staged in shared memory (reusing the
//     coefficient buffers); the mel product runs over each filter's nonzero
//     band only (found once per block), then log, store, and the partials
//     over valid frames.
// Sums over samples run in order n = row_lo..row_hi-1 in fp32 for the main
// bins; the skipped rows would add exact zeros.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FRAMES = 32;         // frames per block
constexpr int NB_MAIN = 256;       // bins in the register-tiled product
constexpr int THREADS = 256;
constexpr int CHUNK = 16;          // DFT rows per shared-memory chunk
constexpr int BPITCH = 2 * NB_MAIN;         // floats per coefficient row
constexpr int APITCH = FRAMES + 4;          // floats per transposed row
constexpr int MAX_MELS = 128;

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

__host__ __device__ inline int span_pad(int n_fft, int hop) {
  return (((FRAMES - 1) * hop + n_fft) + 3) & ~3;
}

__host__ __device__ inline size_t smem_floats(int n_fft, int hop, int nb) {
  const int coef = 2 * CHUNK * BPITCH;
  const int pw = FRAMES * nb;
  return (size_t)span_pad(n_fft, hop) + CHUNK * APITCH +
         (coef > pw ? coef : pw);
}

// rows [n0, n0 + CHUNK) of the packed coefficients, as one cp.async group
__device__ __forceinline__ void load_coef(float* dst, const float* coef,
                                          int n0) {
  const float* src = coef + (size_t)n0 * BPITCH;
#pragma unroll
  for (int j = 0; j < CHUNK * BPITCH / 4 / THREADS; ++j) {
    const int i = (threadIdx.x + j * THREADS) * 4;
    cp_async16(dst + i, src + i);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(THREADS, 2)
logmel_kernel(const float* __restrict__ xp, int sp,
              const int* __restrict__ seq_len,
              const float* __restrict__ coef,   // (n_fft, 512) packed
              const float* __restrict__ extra,  // (nb - 256, 2, n_fft)
              const float* __restrict__ mel,    // (nb, n_mels)
              float* __restrict__ out,          // (B, t_out, n_mels)
              float* __restrict__ parts,        // (B, n_tiles, 2, n_mels)
              int t_out, int n_tiles, int n_fft, int hop, int nb,
              int n_mels, int row_lo, int row_hi, float guard,
              int guard_clamp) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int band_lo[MAX_MELS], band_hi[MAX_MELS];
  const int spad = span_pad(n_fft, hop);
  float* sig = smem;                   // spad floats, later the log-mel tile
  float* at = sig + spad;              // CHUNK x APITCH transposed frames
  float* cbuf = at + CHUNK * APITCH;   // 2 x CHUNK x BPITCH, then
  float* pw = cbuf;                    // FRAMES x nb power spectrum

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int f0 = tile * FRAMES;
  const int nt = (row_hi - row_lo) / CHUNK;

  load_coef(cbuf, coef, row_lo);
  const float* row = xp + (size_t)b * sp;
  const int span = (FRAMES - 1) * hop + n_fft;
  for (int i = tid; i < spad; i += THREADS) {
    const int s = f0 * hop + i;
    sig[i] = (i < span && s < sp) ? row[s] : 0.f;
  }
  // each mel filter's nonzero band [lo, hi)
  for (int m = tid; m < n_mels; m += THREADS) {
    band_lo[m] = nb;
    band_hi[m] = 0;
  }
  __syncthreads();
  for (int i = tid; i < nb * n_mels; i += THREADS) {
    if (__ldg(mel + i) != 0.f) {
      const int q = i / n_mels;
      const int m = i - q * n_mels;
      atomicMin(&band_lo[m], q);
      atomicMax(&band_hi[m], q + 1);
    }
  }

  // register tile of this thread: frames fa..fa+3, bins kb + {0..3, 32..35}
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int fa = (warp >> 2) * 16 + (lane >> 3) * 4;
  const int kb = (warp & 3) * 64 + (lane & 7) * 4;
  float re[4][8], im[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      re[i][j] = 0.f;
      im[i][j] = 0.f;
    }

  for (int t = 0; t < nt; ++t) {
    const int n0 = row_lo + t * CHUNK;
    __syncthreads();                   // sig loaded / chunk t-1 consumed
    if (t + 1 < nt)                    // into the buffer chunk t-1 used
      load_coef(cbuf + ((t + 1) & 1) * CHUNK * BPITCH, coef, n0 + CHUNK);
    // transpose this chunk's frame values: at[nn][f] = sig[f * hop + n0 + nn]
    for (int i = tid; i < CHUNK * FRAMES; i += THREADS) {
      const int f = i / CHUNK;
      const int nn = i - f * CHUNK;
      at[nn * APITCH + f] = sig[f * hop + n0 + nn];
    }
    if (t + 1 < nt)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();                   // chunk t's coefficients and at
    const float* cb = cbuf + (t & 1) * CHUNK * BPITCH;
#pragma unroll
    for (int nn = 0; nn < CHUNK; ++nn) {
      const float4 a = *reinterpret_cast<const float4*>(at + nn * APITCH + fa);
      const float* crow = cb + nn * BPITCH + kb;
      const float4 c0 = *reinterpret_cast<const float4*>(crow);
      const float4 c1 = *reinterpret_cast<const float4*>(crow + 32);
      const float4 s0 = *reinterpret_cast<const float4*>(crow + NB_MAIN);
      const float4 s1 = *reinterpret_cast<const float4*>(crow + NB_MAIN + 32);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          re[i][j] = fmaf(av[i], cv[j], re[i][j]);
          im[i][j] = fmaf(av[i], sv[j], im[i][j]);
        }
    }
  }
  __syncthreads();                     // every thread is done with cbuf
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = kb + (j < 4 ? j : 28 + j);
      pw[(fa + i) * nb + k] = re[i][j] * re[i][j] + im[i][j] * im[i][j];
    }

  // bins NB_MAIN..nb-1: one warp per (frame, bin), lanes split the samples
  const int n_extra = nb - NB_MAIN;
  for (int p = warp; p < FRAMES * n_extra; p += THREADS / 32) {
    const int f = p / n_extra;
    const int e = p - f * n_extra;
    const float* er = extra + (size_t)e * 2 * n_fft;
    float r = 0.f, m = 0.f;
    for (int n = row_lo + lane; n < row_hi; n += 32) {
      const float v = sig[f * hop + n];
      r = fmaf(v, __ldg(er + n), r);
      m = fmaf(v, __ldg(er + n_fft + n), m);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      r += __shfl_xor_sync(0xffffffffu, r, o);
      m += __shfl_xor_sync(0xffffffffu, m, o);
    }
    if (lane == 0) pw[f * nb + NB_MAIN + e] = r * r + m * m;
  }
  __syncthreads();

  // mel over each filter's nonzero band (skipped terms are exact zeros)
  float* lm = sig;   // FRAMES * n_mels <= spad (checked by the wrapper)
  for (int idx = tid; idx < FRAMES * n_mels; idx += THREADS) {
    const int f = idx / n_mels;
    const int m = idx - f * n_mels;
    const float* p = pw + f * nb;
    float acc = 0.f;
    for (int q = band_lo[m]; q < band_hi[m]; ++q)
      acc = fmaf(p[q], __ldg(mel + (size_t)q * n_mels + m), acc);
    const float v = guard_clamp ? logf(fmaxf(acc, guard)) : logf(acc + guard);
    lm[idx] = v;
    const int t = f0 + f;
    if (t < t_out) out[((size_t)b * t_out + t) * n_mels + m] = v;
  }
  __syncthreads();

  const int valid = min(seq_len[b] - f0, FRAMES);
  float* part = parts + ((size_t)b * n_tiles + tile) * 2 * n_mels;
  for (int m = tid; m < n_mels; m += THREADS) {
    float s1 = 0.f, s2 = 0.f;
    for (int f = 0; f < valid; ++f) {
      const float v = lm[f * n_mels + m];
      s1 += v;
      s2 += v * v;
    }
    part[m] = s1;
    part[n_mels + m] = s2;
  }
}

}  // namespace

extern "C" int vt_logmel_frames_per_tile() { return FRAMES; }

extern "C" int vt_logmel_row_chunk() { return CHUNK; }

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Dynamic shared-memory bytes one launch asks for; 0 when the shape is
// outside the kernel's plan (the wrapper refuses it).
extern "C" long long vt_logmel_smem_bytes(int n_fft, int hop, int nb,
                                          int n_mels) {
  if (nb < NB_MAIN || nb - NB_MAIN >= 32 || hop % 4 || n_fft % CHUNK ||
      n_mels > MAX_MELS || FRAMES * n_mels > span_pad(n_fft, hop))
    return 0;
  return (long long)(smem_floats(n_fft, hop, nb) * sizeof(float));
}

// Returns cudaGetLastError() after the launch (0 = launched).
// [row_lo, row_hi) is a nonempty range of whole CHUNKs inside [0, n_fft).
extern "C" int vt_logmel_forward(const void* xp, const void* seq_len,
                                 const void* coef, const void* extra,
                                 const void* mel, void* out, void* parts,
                                 int batch, int sp, int t_out, int n_fft,
                                 int hop, int nb, int n_mels, int row_lo,
                                 int row_hi, float guard, int guard_clamp,
                                 void* stream) {
  if (row_lo < 0 || row_hi > n_fft || row_lo >= row_hi || row_lo % CHUNK ||
      row_hi % CHUNK)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (t_out + FRAMES - 1) / FRAMES;
  const size_t smem = smem_floats(n_fft, hop, nb) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_tiles, batch);
  logmel_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)xp, sp, (const int*)seq_len, (const float*)coef,
      (const float*)extra, (const float*)mel, (float*)out, (float*)parts,
      t_out, n_tiles, n_fft, hop, nb, n_mels, row_lo, row_hi, guard,
      guard_clamp);
  return (int)cudaGetLastError();
}
