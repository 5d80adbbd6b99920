// Fused log-mel frontend for Hopper (sm_90a): framing + window + real FFT
// + power + mel + log, with per-tile (sum, M2) partials for the per-feature
// normalization: M2 is the sum of squares about the tile's own mean, which
// the epilogue merges across tiles by Chan et al.'s parallel formula
// (frontend/cuda_frontend.py::merge_tile_stats), so a nearly constant mel
// bin keeps its variance where (sum x^2 - n mean^2) would cancel.
//
// Replaces: vietasr_tpu/frontend/pallas_frontend.py::_kernel (the Pallas
// TPU kernel behind fused_log_mel_features, precision="highest"). That
// kernel forms the spectrum as frames @ windowed-DFT matrix on the TPU's
// matrix unit: 2 * 318 * 514 operations per frame over the window's nonzero
// samples. Here the same one-sided spectrum comes from a fast Fourier
// transform: a 512-point real FFT is a 256-point complex FFT of the packed
// even/odd samples plus a real-split pass, ~12 kFLOP a frame, 28x less.
//
// What bounds it on the H100: bytes first. At B = 8 x 16.7 s it reads the
// padded signal once (8.57 MB) and writes the log-mel frames and the
// (sum, M2) partials (3.5 MB): ~3.7 us at 3.35 TB/s. The FFT's operations come second (0.15
// GFLOP). In practice the work inside each SM sets the pace, spread over
// several phases that each cost about as much: the mel pass's and the
// sample loads' shared-memory traffic, the fp64 butterflies and real split
// (fp64 runs at half the fp32 rate), the exchange between the stages.
//
// Precision. Nothing here goes below fp32, and the FFT itself runs in
// fp64. Pre-emphasis puts the low bins ~30 dB under the high ones; an FFT's
// rounding error is spread over all bins at ~eps * (frame energy), while a
// DFT summed sample by sample keeps small partial sums on a low-energy bin.
// So an fp32 FFT lands about twice as far from an fp64 reference in
// log-mel as the plain fp32 matmul chain does, and the accuracy contract
// (no further from fp64 than the plain chain) needs the FFT in fp64. The
// fp32 sample times the fp32 window tap is exact in fp64; the power is
// rounded once to fp32, and the mel sum and log run in fp32 as in the plain
// version. Twiddles are a host table (frontend/cuda_frontend.py::
// fft_tables, fp64) and five fp64 constants of the 16-point DFT below; the
// kernel calls no sin or cos.
//
// Design:
//   - the work is tiles of FRAMES = 16 consecutive frames of one row (the
//     partials' tile); as many 8-warp blocks as fit on the card at once
//     each walk their tiles, so the twiddle tables, the window and the
//     packed mel taps are copied into shared memory once per block, and
//     the next tile's (FRAMES-1)*hop + n_fft samples are in flight (16-byte
//     cp.async copies into a second buffer; the first and last copies reach
//     into neighbouring samples to stay aligned) while this tile computes;
//   - each warp takes two frames, one per half-warp; lane l of a half holds
//     the packed complex samples z[l + 16 j] = v[2n] + i v[2n + 1], j =
//     0..15, v the windowed frame (pairs outside the window's support are
//     zeros and are not loaded);
//   - the 256-point FFT is radix 16 x 16 (n = l + 16 j, k = k1 + 16 k2):
//     a 16-point DFT over j in registers, times W256^(l k1) from the table;
//     one exchange through shared memory (row pitch 17 doubles: conflict-
//     free both ways); a 16-point DFT over l, so that lane k1 holds
//     Z[k1 + 16 k2] for every k2;
//   - the real split X[k] = (Z[k] + conj Z[256-k]) / 2
//     - i W512^k (Z[k] - conj Z[256-k]) / 2 pairs lane k1 with lane 16 - k1:
//     one shuffle of 8 values gives each lane the mirrors of its k2 = 0..7,
//     and from each pair (Z[k], Z[256 - k]) it forms both |X[k]|^2 and
//     |X[256 - k]|^2; lane 0 also forms X[128] = conj Z[128];
//   - the power row goes to the half-warp's part of the exchange memory;
//     after a block barrier, half-warp r sums the filters of tap run r for
//     all 16 frames, one frame a lane (the host cuts the filters into 16
//     contiguous runs of about equal tap count, padded to 4 taps; every
//     skipped product is an exact zero). A run's taps are the same across
//     its half-warp, so their loads are broadcasts and no lane waits on
//     another's filter boundaries; four taps' loads are in flight at a
//     time;
//   - the whole block then takes the log with the config's guard, stores
//     the tile in coalesced rows, and one thread per mel sums the valid
//     frames' (value, value^2) in frame order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NFFT = 512;          // real samples per frame
constexpr int FRAMES = 16;         // frames per block (the partials' tile)
constexpr int WARPS = FRAMES / 2;  // two frames per warp
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_MELS = 128;
constexpr int LANES = 16;          // lanes per frame
constexpr int RUNS = 2 * WARPS;    // mel tap runs, one per half-warp
constexpr int XP = 17;             // exchange row pitch (doubles)
constexpr int HALF_DOUBLES = 2 * 16 * XP;    // re and im of one half-warp
constexpr int WARP_DOUBLES = 2 * HALF_DOUBLES;
constexpr int TW1 = 16 * 16;       // W256^(l k1), [k1][l]
constexpr int TWS = 8 * 16;        // W512^(l + 16 k2), [k2][l]
constexpr int TW_ROWS = TW1 + TWS;
// packed mel taps: bits 0-9 the bin, bit 10 "last tap of its filter",
// bits 11+ the filter
constexpr int TAP_BIN = 0x3ff, TAP_LAST = 0x400, TAP_MEL_SHIFT = 11;
// mel_index: RUNS + 1 run starts, zero-padded to TAP_BASE, then the taps
constexpr int TAP_BASE = (RUNS + 1 + 3) & ~3;
static_assert(RUNS == FRAMES && LANES == FRAMES,
              "the mel pass puts one frame in each lane of a half-warp");

// the 16-point DFT's twiddles W16^e = cos(2 pi e / 16) - i sin(2 pi e / 16):
// cos(pi / 8), sin(pi / 8), sqrt(1/2), each rounded once to fp64
constexpr double C8 = 0.92387953251128675613;
constexpr double S8 = 0.38268343236508977173;
constexpr double H2 = 0.70710678118654752440;

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

__host__ __device__ inline int span_floats(int hop) {
  return (FRAMES - 1) * hop + NFFT;
}

// float offsets of the shared-memory pieces after the fp64 ones
struct Layout {
  int sig, sig_floats, win, lm, wt, idx, total_floats;
};

__host__ __device__ inline Layout layout(int hop, int n_mels, int taps) {
  Layout s;
  s.sig = 0;                 // two tiles' samples + alignment slack each
  s.sig_floats = round4(span_floats(hop) + 3);
  s.win = s.sig + 2 * s.sig_floats;
  s.lm = s.win + NFFT;
  s.wt = s.lm + round4(FRAMES * (n_mels + 1));
  s.idx = s.wt + taps;
  s.total_floats = s.idx + TAP_BASE + taps;
  return s;
}

__host__ __device__ inline size_t smem_bytes(int hop, int n_mels, int taps) {
  return sizeof(double2) * TW_ROWS + sizeof(double) * WARPS * WARP_DOUBLES +
         sizeof(float) * (size_t)layout(hop, n_mels, taps).total_floats;
}

// z * W with W = (c, s) meaning c - i s
__device__ __forceinline__ void mul_w(double& r, double& i, double c,
                                      double s) {
  const double nr = fma(r, c, i * s);
  const double ni = fma(i, c, -(r * s));
  r = nr;
  i = ni;
}

// in-place 4-point DFT, natural order in and out
__device__ __forceinline__ void dft4(double& r0, double& i0, double& r1,
                                     double& i1, double& r2, double& i2,
                                     double& r3, double& i3) {
  const double sr0 = r0 + r2, si0 = i0 + i2, dr0 = r0 - r2, di0 = i0 - i2;
  const double sr1 = r1 + r3, si1 = i1 + i3, dr1 = r1 - r3, di1 = i1 - i3;
  r0 = sr0 + sr1;
  i0 = si0 + si1;
  r2 = sr0 - sr1;
  i2 = si0 - si1;
  r1 = dr0 + di1;        // d0 - i d1
  i1 = di0 - dr1;
  r3 = dr0 - di1;        // d0 + i d1
  i3 = di0 + dr1;
}

// where dft16 leaves output k: 4-point DFTs over p of a[4p + q] put y_q[r]
// at 4r + q; after the twiddles the 4-point DFTs over q put A[r + 4s] at
// 4r + s
__host__ __device__ constexpr int pos16(int k) { return 4 * (k & 3) + (k >> 2); }

// 16-point DFT A[k] = sum_j a[j] W16^(j k) in registers; A[k] ends at
// pos16(k). j = 4p + q, k = r + 4s: W16^(jk) = W4^(pr) W16^(qr) W4^(qs).
__device__ __forceinline__ void dft16(double* re, double* im) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    dft4(re[q], im[q], re[4 + q], im[4 + q], re[8 + q], im[8 + q],
         re[12 + q], im[12 + q]);
  // y_q[r] (at 4r + q) times W16^(qr), qr in {1, 2, 3, 2, 4, 6, 3, 6, 9}
  mul_w(re[5], im[5], C8, S8);        // q 1, r 1: W16^1
  mul_w(re[6], im[6], H2, H2);        // q 2, r 1: W16^2
  mul_w(re[7], im[7], S8, C8);        // q 3, r 1: W16^3
  mul_w(re[9], im[9], H2, H2);        // q 1, r 2: W16^2
  {                                   // q 2, r 2: W16^4 = -i
    const double t = re[10];
    re[10] = im[10];
    im[10] = -t;
  }
  mul_w(re[11], im[11], -H2, H2);     // q 3, r 2: W16^6
  mul_w(re[13], im[13], S8, C8);      // q 1, r 3: W16^3
  mul_w(re[14], im[14], -H2, H2);     // q 2, r 3: W16^6
  mul_w(re[15], im[15], -C8, -S8);    // q 3, r 3: W16^9
#pragma unroll
  for (int r = 0; r < 4; ++r)
    dft4(re[4 * r], im[4 * r], re[4 * r + 1], im[4 * r + 1], re[4 * r + 2],
         im[4 * r + 2], re[4 * r + 3], im[4 * r + 3]);
}

// 16-byte copy into shared memory; the bytes past src_bytes are zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(gmem), "r"(src_bytes));
}

// The tile's samples start at s0; the copies start at s0 rounded down to 16
// bytes (xp is 16-byte aligned), and bytes past the end of xp come in as
// zeros. Returns the first sample's offset in dst.
__device__ __forceinline__ int load_tile(float* dst, const float* xp,
                                         long long n_total, long long s0,
                                         int hop) {
  const long long a0 = s0 & ~3LL;
  const int off = (int)(s0 - a0);
  const int chunks = (off + span_floats(hop) + 3) >> 2;
  for (int c = threadIdx.x; c < chunks; c += THREADS) {
    const long long e = a0 + 4LL * c;
    const long long left = n_total - e;
    const int valid = left >= 4 ? 4 : (left > 0 ? (int)left : 0);
    cp_async16(dst + 4 * c, valid ? xp + e : xp, 4 * valid);
  }
  return off;
}

__global__ void __launch_bounds__(THREADS, 2)
logmel_kernel(const float* __restrict__ xp, long long n_total, int sp,
              const int* __restrict__ seq_len,
              const float* __restrict__ window,     // (NFFT,)
              const double2* __restrict__ twiddle,  // (TW_ROWS,)
              const int* __restrict__ mel_index,    // (TAP_BASE + taps,)
              const float* __restrict__ mel_weight, // (taps,)
              float* __restrict__ out,              // (B, t_out, n_mels)
              float* __restrict__ parts,            // (B, n_tiles, 2, n_mels)
              int t_out, int n_tiles, int total_tiles, int hop, int n_mels,
              int taps, int win_lo, int win_hi, float guard,
              int guard_clamp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double2* tw = reinterpret_cast<double2*>(smem_raw);
  double* xch = reinterpret_cast<double*>(tw + TW_ROWS);
  float* fl = reinterpret_cast<float*>(xch + WARPS * WARP_DOUBLES);
  const Layout L = layout(hop, n_mels, taps);
  const float2* win = reinterpret_cast<const float2*>(fl + L.win);
  float* lm = fl + L.lm;
  float* wt = fl + L.wt;
  int* idx = reinterpret_cast<int*>(fl + L.idx);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int h = lane >> 4;            // which of the warp's two frames
  const int l = lane & 15;
  const int f = 2 * warp + h;         // frame within the tile
  double* xre = xch + warp * WARP_DOUBLES + h * HALF_DOUBLES;
  double* xim = xre + 16 * XP;
  // frame f's power row (257 floats) reuses its half-warp's exchange
  // memory after stage 2, (f >> 1) + 16 (f & 1) floats in: the 16 rows
  // then sit in 16 distinct banks at any one bin (the mel pass reads a bin
  // of every frame at once), and the two halves of a warp write theirs to
  // disjoint banks
  auto pw_row = [&](int fr_) {
    return reinterpret_cast<float*>(xch + (fr_ >> 1) * WARP_DOUBLES +
                                    (fr_ & 1) * HALF_DOUBLES) +
           (fr_ >> 1) + 16 * (fr_ & 1);
  };
  float* pw = pw_row(f);
  const int partner = (lane & 16) | ((16 - l) & 15);

  // the constants and the first tile's samples, one cp.async group
  for (int c = tid; c < TW_ROWS; c += THREADS)
    cp_async16(tw + c, twiddle + c, 16);
  for (int c = tid; c < NFFT / 4; c += THREADS)
    cp_async16(fl + L.win + 4 * c, window + 4 * c, 16);
  for (int c = tid; c < taps / 4; c += THREADS)
    cp_async16(wt + 4 * c, mel_weight + 4 * c, 16);
  for (int c = tid; c < (TAP_BASE + taps) / 4; c += THREADS)
    cp_async16(idx + 4 * c, mel_index + 4 * c, 16);
  auto tile_start = [&](int id) {
    return (long long)(id / n_tiles) * sp +
           (long long)(id % n_tiles) * FRAMES * hop;
  };
  int off = load_tile(fl + L.sig, xp, n_total, tile_start(blockIdx.x), hop);
  asm volatile("cp.async.commit_group;\n" ::);

  // tiles blockIdx.x, + gridDim.x, ...: the next tile's samples are in
  // flight while this one is computed
  int buf = 0;
  for (int id = blockIdx.x; id < total_tiles; id += gridDim.x, buf ^= 1) {
    const int next = id + gridDim.x;
    int next_off = 0;
    if (next < total_tiles)
      next_off = load_tile(fl + L.sig + (buf ^ 1) * L.sig_floats, xp,
                           n_total, tile_start(next), hop);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const int b = id / n_tiles;
    const int tile = id - b * n_tiles;
    const int f0 = tile * FRAMES;
    const float* fr = fl + L.sig + buf * L.sig_floats + off + f * hop;

    // stage 1: z[l + 16 j] windowed (exact in fp64), a 16-point DFT over
    // j, times W256^(l k1)
    double re[16], im[16];
    const bool pairs = ((off + f * hop) & 1) == 0;   // fr 8-byte aligned
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = l + 16 * j;
      if (2 * n + 1 >= win_lo && 2 * n < win_hi) {
        const float2 w = win[n];
        const float2 x = pairs ? *reinterpret_cast<const float2*>(fr + 2 * n)
                               : make_float2(fr[2 * n], fr[2 * n + 1]);
        re[j] = (double)x.x * (double)w.x;
        im[j] = (double)x.y * (double)w.y;
      } else {
        re[j] = 0.0;
        im[j] = 0.0;
      }
    }
    dft16(re, im);
#pragma unroll
    for (int k1 = 1; k1 < 16; ++k1) {
      const double2 w = tw[k1 * 16 + l];
      mul_w(re[pos16(k1)], im[pos16(k1)], w.x, w.y);
    }
#pragma unroll
    for (int k1 = 0; k1 < 16; ++k1) {
      xre[k1 * XP + l] = re[pos16(k1)];
      xim[k1 * XP + l] = im[pos16(k1)];
    }
    __syncwarp();
    // stage 2 in lane k1 = l: a 16-point DFT over the 16 lanes' values
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      re[i] = xre[l * XP + i];
      im[i] = xim[l * XP + i];
    }
    __syncwarp();                     // the exchange memory is free now
    dft16(re, im);                    // Z[l + 16 k2] at pos16(k2)

    // real split and power. Z[256 - k] for k = l + 16 k2 is lane
    // (16 - l)'s Z[.. + 16 (15 - k2)] (lane 0: its own Z[16 (16 - k2)]);
    // each pair gives |X[k]|^2 and |X[256 - k]|^2
#pragma unroll
    for (int k2 = 0; k2 < 8; ++k2) {
      double mr = __shfl_sync(0xffffffffu, re[pos16(15 - k2)], partner);
      double mi = __shfl_sync(0xffffffffu, im[pos16(15 - k2)], partner);
      if (l == 0) {
        mr = re[pos16((16 - k2) & 15)];
        mi = im[pos16((16 - k2) & 15)];
      }
      const double zr = re[pos16(k2)], zi = im[pos16(k2)];
      const double er = zr + mr, ei = zi - mi;   // Z[k] + conj Z[256-k]
      const double orr = zr - mr, oi = zi + mi;  // Z[k] - conj Z[256-k]
      const double2 w = tw[TW1 + k2 * 16 + l];   // W512^k
      const double pr = fma(orr, w.x, oi * w.y); // W O
      const double pi = fma(oi, w.x, -(orr * w.y));
      const double ar = er + pi, ai = ei - pr;   // 2 X[k] = E - i W O
      const double br = er - pi, bi = ei + pr;   // 2 conj X[256-k]
      const int k = l + 16 * k2;
      pw[k] = (float)(0.25 * fma(ar, ar, ai * ai));
      pw[NFFT / 2 - k] = (float)(0.25 * fma(br, br, bi * bi));
    }
    if (l == 0)                                  // X[128] = conj Z[128]
      pw[NFFT / 4] = (float)fma(re[pos16(8)], re[pos16(8)],
                                im[pos16(8)] * im[pos16(8)]);
    __syncthreads();                  // every frame's power row

    // mel: half-warp r sums the filters of tap run r (the host cuts the
    // filters into RUNS runs of about equal tap count, each padded to 4
    // taps), lane l for frame l; the taps are the same across the half,
    // four at a time
    {
      const int r = tid >> 4;
      const float* prow = pw_row(l);
      float acc = 0.f;
      const int q1 = idx[r + 1];
      for (int q = idx[r]; q < q1; q += 4) {
        const int4 e = *reinterpret_cast<const int4*>(idx + TAP_BASE + q);
        const float4 w = *reinterpret_cast<const float4*>(wt + q);
        const int ev[4] = {e.x, e.y, e.z, e.w};
        const float wv[4] = {w.x, w.y, w.z, w.w};
        float pv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) pv[u] = prow[ev[u] & TAP_BIN];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc = fmaf(pv[u], wv[u], acc);
          if (ev[u] & TAP_LAST) {
            lm[l * (n_mels + 1) + (ev[u] >> TAP_MEL_SHIFT)] = acc;
            acc = 0.f;
          }
        }
      }
    }
    __syncthreads();

    // log with the guard, over the whole tile at once; the rows inside
    // t_out go out coalesced
    const int rows = min(FRAMES, t_out - f0);
    float* dst = out + ((size_t)b * t_out + f0) * n_mels;
    for (int i = tid; i < FRAMES * n_mels; i += THREADS) {
      float* v = lm + i + i / n_mels;          // row pitch n_mels + 1
      *v = guard_clamp ? logf(fmaxf(*v, guard)) : logf(*v + guard);
      if (i < rows * n_mels) dst[i] = *v;
    }
    __syncthreads();
    // partials over the valid frames, in frame order, in one fp32 pass
    // over the deviations d = v - v0 from the tile's first frame: the sum
    // is c v0 + sum d rounded once and M2 = sum d^2 - (sum d)^2 / c (0
    // when no frame is valid), which cancels at most c = 16 times M2 (no
    // frame lies further than sqrt(c - 1) standard deviations from its
    // tile's mean). One sub a term more than plain sums of v and v^2;
    // frontend/cuda_frontend.py::tile_partials
    const int valid = min(seq_len[b] - f0, FRAMES);
    const float inv = 1.f / (float)max(valid, 1);
    float* part = parts + ((size_t)b * n_tiles + tile) * 2 * n_mels;
    for (int m = tid; m < n_mels; m += THREADS) {
      const float v0 = lm[m];
      float s1 = 0.f, s2 = 0.f;
      for (int i = 0; i < valid; ++i) {
        const float d = lm[i * (n_mels + 1) + m] - v0;
        s1 += d;
        s2 = fmaf(d, d, s2);
      }
      part[m] = valid > 0 ? fmaf((float)valid, v0, s1) : 0.f;
      part[n_mels + m] = valid > 0 ? fmaxf(s2 - s1 * s1 * inv, 0.f) : 0.f;
    }
    off = next_off;
  }
}

}  // namespace

extern "C" int vt_logmel_frames_per_tile() { return FRAMES; }

extern "C" int vt_logmel_fft_length() { return NFFT; }

extern "C" int vt_logmel_mel_runs() { return RUNS; }

extern "C" int vt_logmel_twiddle_rows() { return TW_ROWS; }

extern "C" int vt_logmel_tap_base() { return TAP_BASE; }

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Dynamic shared-memory bytes one launch asks for; 0 when the shape is
// outside the kernel's plan (the wrapper refuses it).
extern "C" long long vt_logmel_smem_bytes(int n_fft, int hop, int n_mels,
                                          int taps) {
  if (n_fft != NFFT || hop < 1 || hop > NFFT || n_mels < 1 ||
      n_mels > MAX_MELS || taps < n_mels || taps % 4 || taps > 4 * NFFT)
    return 0;
  return (long long)smem_bytes(hop, n_mels, taps);
}

// Returns cudaGetLastError() after the launch (0 = launched). xp must be
// 16-byte aligned; mel_index holds LANES + 1 run starts (each a multiple
// of 4), zero-padded to TAP_BASE, then the `taps` packed taps (a multiple
// of 4; frontend/cuda_frontend.py::pack_mel_taps); the window must be zero
// outside [win_lo, win_hi).
extern "C" int vt_logmel_forward(const void* xp, const void* seq_len,
                                 const void* window, const void* twiddle,
                                 const void* mel_index,
                                 const void* mel_weight, void* out,
                                 void* parts, int batch, int sp, int t_out,
                                 int n_fft, int hop, int n_mels, int taps,
                                 int win_lo, int win_hi, float guard,
                                 int guard_clamp, void* stream) {
  const long long smem = vt_logmel_smem_bytes(n_fft, hop, n_mels, taps);
  if (smem == 0 || win_lo < 0 || win_hi > n_fft || win_lo >= win_hi ||
      t_out < 1 || batch < 1 || sp < n_fft ||
      ((uintptr_t)xp & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (t_out + FRAMES - 1) / FRAMES;
  const long long total = (long long)n_tiles * batch;
  if (total > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // as many blocks as fit on the card at once, each walking its tiles
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, logmel_kernel, THREADS, (size_t)smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int blocks = (int)(total < (long long)sms * per_sm
                               ? total : (long long)sms * per_sm);
  logmel_kernel<<<blocks, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (const float*)xp, (long long)batch * sp, sp, (const int*)seq_len,
      (const float*)window, (const double2*)twiddle, (const int*)mel_index,
      (const float*)mel_weight, (float*)out, (float*)parts, t_out, n_tiles,
      (int)total, hop, n_mels, taps, win_lo, win_hi, guard, guard_clamp);
  return (int)cudaGetLastError();
}
