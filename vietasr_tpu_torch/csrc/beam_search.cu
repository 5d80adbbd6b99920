// Fused CTC prefix beam search for Hopper (sm_90a): the whole decode over T
// in one launch, with optional word-LM shallow fusion (order <= 5).
//
// Replaces: vietasr_tpu/ops/pallas_beam.py::_beam_kernel (the Pallas TPU
// kernel behind pallas_beam_search). Contract: the raw result of
// ops/device_beam.py::device_beam_search (return_raw=True) with canonical
// (space-normalised) beam identity, cutoff_top_n > 0, no char-LM table and
// W <= 128: the final packed state (B, W, n_cols) and the (parent, char)
// backpointers (T, B, W), slot by slot.
//
// What bounds it on the H100: neither bytes nor operations. One step of
// one utterance is a few hundred thousand simple operations at W = 100
// (the O(W^2) merge test, the W*(K+1) candidate ranking) over a few KB of
// state, and the T steps of an utterance are strictly sequential, each
// needing the previous step's beams. So the time is T times the latency of
// one step, and a step is a chain of phases separated by __syncthreads.
//
// The design, per utterance one thread block (blockIdx.x = b), the loop
// over t inside the kernel (the TPU kernel's sequential grid):
//   - the packed beam state lives in shared memory as columns (col * W +
//     slot), an old and a new copy, loaded from the start state once and
//     written back once after the last valid frame; frames t >= len write
//     identity backpointers and leave the state as it is;
//   - per step: the frame's log-prob row and top-K (computed by the
//     wrapper, as jax.lax.top_k was outside the Pallas call) go to shared
//     memory; per beam: p_total, the stay scores, the separator-folded
//     hash bases, the position of its last char in the top-K;
//   - word LM: one thread per (chain, beam) probes the open-addressing
//     (N, 4) table in device memory (L2-resident), as
//     _word_lm_score(dense=False) does; the Katz combine then runs per
//     beam with the carried context backoffs. The TPU kernel's dense match
//     over every row existed only because Mosaic could not gather;
//   - merge: a stay j can absorb only ext(i, last_j), and only when last_j
//     is in the frame's top-K. One thread per (j, i) pair tests the hash
//     pair and sets bit i of j's match mask; the absorbed extension is
//     marked dead with a plain store (for a fixed (i, c) at most one stay
//     absorbs it, so the store has no race). Then one thread per stay
//     takes the masked logsumexp over its matches, in ascending i;
//   - top-W select: every candidate (W stays, then W*K extensions, the
//     plain version's order) becomes one 64-bit key, (order-preserving
//     bits of its total) << 32 | ~index, and a bitonic sort of the padded
//     key array in shared memory puts them in value-descending,
//     index-ascending order: XLA's top_k order, hence the plain version's
//     slot order;
//   - one thread per new slot selects its parent, recomputes the extension
//     payload and the word/context/backoff state, and writes the
//     backpointers.
// fp32 IEEE expf/logf (no fast math), and alpha * s + beta as a separate
// multiply and add (no FMA contraction), as the plain version computes it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr float HALF_NEG = -5e29f;           // NEG / 2
constexpr uint32_t P1 = 1000003u, P2 = 69069u;
constexpr uint32_t Q1 = 2654435761u, Q2 = 40503u;
constexpr uint32_t MIX = 0x9E3779B9u, KEY_SEED = 1u;
constexpr int MAX_W = 128;
constexpr int MASK_WORDS = MAX_W / 32;
constexpr int MAX_LEVELS = 5;
constexpr int MAX_THREADS = 1024;
// packed-state columns (ops/device_beam.py)
constexpr int C_H1 = 0, C_H2 = 1, C_PB = 2, C_PNB = 3, C_LM = 4, C_LAST = 5,
              C_ROW = 6, C_PLEN = 7, C_WH1 = 8, C_WH2 = 9, C_CTX = 10;

struct Params {
  const float* lp;          // (B, T, V1)
  const int* lens;          // (B,)
  const float* top_lp;      // (B, T, K)
  const int* top_ci;        // (B, T, K)
  const uint32_t* st0;      // (B, W, NC)
  const uint4* lm;          // (N, 4): key1, key2, logp bits, backoff bits
  const long long* masks;   // (L,)
  const long long* bases;   // (L,)
  const float* unk;         // ()
  uint32_t* st_out;         // (B, W, NC)
  int* parents;             // (T, B, W)
  int* chars;               // (T, B, W)
  int B, T, V1, K, W, NC, blank, space, levels, probes, npad;
  float alpha, beta;
};

// byte offsets of the shared-memory arrays (16-byte aligned each)
struct Layout {
  int keys, st, lp, tlp, tci, ptot, spb, spnb, sm, sw, nbo, b1, b2, kpos,
      lmv, lmb, lmh, match, killed, total;
};

__host__ __device__ inline int take(int& off, int bytes) {
  const int at = off;
  off += (bytes + 15) & ~15;
  return at;
}

__host__ __device__ inline int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__host__ __device__ inline Layout layout(int W, int K, int V1, int NC,
                                         int levels, int npad) {
  const int n_bo = levels > 1 ? levels - 1 : 0;
  const int nl = levels > 0 ? levels : 1;
  Layout o;
  int off = 0;
  o.keys = take(off, 8 * npad);
  o.st = take(off, 4 * 2 * NC * W);
  o.lp = take(off, 4 * V1);
  o.tlp = take(off, 4 * K);
  o.tci = take(off, 4 * K);
  o.ptot = take(off, 4 * W);
  o.spb = take(off, 4 * W);
  o.spnb = take(off, 4 * W);
  o.sm = take(off, 4 * W);
  o.sw = take(off, 4 * W);
  o.nbo = take(off, 4 * W * (n_bo > 0 ? n_bo : 1));
  o.b1 = take(off, 4 * W);
  o.b2 = take(off, 4 * W);
  o.kpos = take(off, 4 * W);
  o.lmv = take(off, 4 * W * nl);
  o.lmb = take(off, 4 * W * nl);
  o.lmh = take(off, 4 * W * nl);
  o.match = take(off, 4 * W * MASK_WORDS);
  o.killed = take(off, W * K);
  o.total = off;
  return o;
}

__host__ __device__ inline int block_threads(int npad) {
  int nt = npad / 2;
  if (nt < 128) nt = 128;
  if (nt > MAX_THREADS) nt = MAX_THREADS;
  return nt;
}

__device__ __forceinline__ float lse2(float a, float b) {
  const float m = fmaxf(a, b);
  const bool dead = m <= HALF_NEG;
  const float safe = dead ? 0.0f : m;
  const float out =
      safe + logf(expf(fmaxf(a - safe, NEG)) + expf(fmaxf(b - safe, NEG)));
  return dead ? NEG : out;
}

// larger key = better candidate: value descending, then index ascending
__device__ __forceinline__ unsigned long long cand_key(float v, int idx) {
  if (v == 0.0f) v = 0.0f;                   // -0 ties +0, as in a sort
  const uint32_t u = __float_as_uint(v);
  const uint32_t ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)ord << 32) | (0xFFFFFFFFu - (uint32_t)idx);
}

__device__ __forceinline__ float key_value(unsigned long long key) {
  const uint32_t ord = (uint32_t)(key >> 32);
  return __uint_as_float((ord & 0x80000000u) ? (ord & 0x7FFFFFFFu) : ~ord);
}

__global__ void __launch_bounds__(MAX_THREADS)
    beam_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int W = p.W, K = p.K, NC = p.NC, T = p.T, V1 = p.V1;
  const int L = p.levels;
  const int n_ctxw = L - 1 > 1 ? L - 1 : 1;
  const int n_bo = L > 1 ? L - 1 : 0;
  const int C_BO = C_CTX + 2 * n_ctxw;
  const int n_cand = W * (K + 1);
  const uint32_t sp_u = (uint32_t)(p.space + 1);

  const Layout o = layout(W, K, V1, NC, L, p.npad);
  unsigned long long* keys = (unsigned long long*)(smem + o.keys);
  uint32_t* cur = (uint32_t*)(smem + o.st);
  uint32_t* nxt = cur + NC * W;
  float* lp = (float*)(smem + o.lp);
  float* tlp = (float*)(smem + o.tlp);
  int* tci = (int*)(smem + o.tci);
  float* ptot = (float*)(smem + o.ptot);
  float* stay_pb = (float*)(smem + o.spb);
  float* stay_pnb = (float*)(smem + o.spnb);
  float* stay_m = (float*)(smem + o.sm);
  float* sw = (float*)(smem + o.sw);
  float* newbo = (float*)(smem + o.nbo);      // (n_bo, W)
  uint32_t* b1 = (uint32_t*)(smem + o.b1);
  uint32_t* b2 = (uint32_t*)(smem + o.b2);
  int* kpos = (int*)(smem + o.kpos);
  float* lmv = (float*)(smem + o.lmv);        // (L, W)
  float* lmb = (float*)(smem + o.lmb);
  int* lmh = (int*)(smem + o.lmh);
  uint32_t* match = (uint32_t*)(smem + o.match);   // (W, MASK_WORDS)
  unsigned char* killed = smem + o.killed;         // (W, K)

  const uint32_t* st0 = p.st0 + (size_t)b * W * NC;
  for (int q = tid; q < W * NC; q += nt) cur[(q % NC) * W + q / NC] = st0[q];
  int len = p.lens[b];
  len = len < 0 ? 0 : (len > T ? T : len);
  __syncthreads();

  for (int t = 0; t < len; ++t) {
    // ---- frame inputs; clear the merge scratch ----
    const size_t frame = (size_t)b * T + t;
    for (int i = tid; i < V1; i += nt) lp[i] = p.lp[frame * V1 + i];
    for (int i = tid; i < K; i += nt) {
      tlp[i] = p.top_lp[frame * K + i];
      tci[i] = p.top_ci[frame * K + i];
    }
    for (int i = tid; i < W * K; i += nt) killed[i] = 0;
    for (int i = tid; i < W * MASK_WORDS; i += nt) match[i] = 0;
    __syncthreads();

    // ---- per beam: stay scores, hash bases, last char's top-K slot ----
    for (int j = tid; j < W; j += nt) {
      const float pb = __uint_as_float(cur[C_PB * W + j]);
      const float pnb = __uint_as_float(cur[C_PNB * W + j]);
      const int last = (int)cur[C_LAST * W + j] - 1;
      const float pt = lse2(pb, pnb);
      ptot[j] = pt;
      stay_pb[j] = pt + lp[p.blank];
      stay_pnb[j] = last >= 0 ? pnb + lp[last] : NEG;
      const uint32_t h1 = cur[C_H1 * W + j], h2 = cur[C_H2 * W + j];
      const bool need_sep =
          cur[C_WH1 * W + j] == 0u &&
          (cur[C_CTX * W + j] != 0u || cur[(C_CTX + 1) * W + j] != 0u);
      b1[j] = need_sep ? h1 * P1 + sp_u : h1;
      b2[j] = need_sep ? h2 * P2 + sp_u : h2;
      int kp = -1;
      if (last >= 0)
        for (int k = 0; k < K; ++k)
          if (tci[k] == last) { kp = k; break; }
      kpos[j] = kp;
    }
    // ---- word LM: probe chain lvl (the (lvl+1)-gram) for beam j ----
    for (int q = tid; q < L * W; q += nt) {
      const int lvl = q / W, j = q % W;
      const uint32_t wh1 = cur[C_WH1 * W + j];
      int hit = 0;
      float val = 0.0f, bo = 0.0f;
      if (wh1 != 0u) {     // an empty partial word is never scored
        uint32_t s1 = KEY_SEED, s2 = KEY_SEED;
        for (int i = lvl; i >= 1; --i) {      // oldest context first
          s1 = s1 * Q1 + cur[(C_CTX + 2 * (i - 1)) * W + j];
          s2 = s2 * Q2 + cur[(C_CTX + 2 * (i - 1) + 1) * W + j];
        }
        const uint32_t q1 = s1 * Q1 + wh1;
        const uint32_t q2 = s2 * Q2 + cur[C_WH2 * W + j];
        if (q1 != 0u) {                        // key 0 marks empty slots
          const uint32_t mask = (uint32_t)p.masks[lvl];
          const uint32_t base = (uint32_t)p.bases[lvl];
          const uint32_t idx0 = (q1 ^ (q2 * MIX)) & mask;
          for (int pr = 0; pr < p.probes; ++pr) {
            const uint4 row = __ldg(p.lm + base + ((idx0 + pr) & mask));
            if (!hit && row.x == q1 && row.y == q2) {
              hit = 1;
              val = __uint_as_float(row.z);
              bo = __uint_as_float(row.w);
            }
          }
        }
      }
      lmh[q] = hit;
      lmv[q] = val;
      lmb[q] = bo;
    }
    __syncthreads();

    // ---- merge test: stay j absorbs ext(i, last_j) ----
    for (int q = tid; q < W * W; q += nt) {
      const int j = q / W, i = q % W;
      const int kp = kpos[j];
      if (kp < 0) continue;
      const int lastj = (int)cur[C_LAST * W + j] - 1;
      uint32_t e1, e2;
      if (lastj == p.space) {
        e1 = cur[C_H1 * W + i];
        e2 = cur[C_H2 * W + i];
      } else {
        const uint32_t cpl = (uint32_t)(lastj + 1);
        e1 = b1[i] * P1 + cpl;
        e2 = b2[i] * P2 + cpl;
      }
      if (cur[C_H1 * W + j] == e1 && cur[C_H2 * W + j] == e2) {
        atomicOr(&match[j * MASK_WORDS + (i >> 5)], 1u << (i & 31));
        killed[i * K + kp] = 1;
      }
    }
    __syncthreads();

    // ---- per stay: masked logsumexp of its matches; word-LM combine ----
    for (int j = tid; j < W; j += nt) {
      const float sp = stay_pnb[j];
      const int kp = kpos[j];
      const int lastj = (int)cur[C_LAST * W + j] - 1;
      const float lpc = kp >= 0 ? tlp[kp] : 0.0f;
      float mmax = sp;
      for (int wd = 0; wd < MASK_WORDS; ++wd) {
        uint32_t m = match[j * MASK_WORDS + wd];
        while (m) {
          const int i = wd * 32 + __ffs(m) - 1;
          m &= m - 1;
          const float base = ((int)cur[C_LAST * W + i] - 1 == lastj)
                                 ? __uint_as_float(cur[C_PB * W + i])
                                 : ptot[i];
          mmax = fmaxf(mmax, base + lpc);
        }
      }
      const bool mdead = mmax <= HALF_NEG;
      const float msafe = mdead ? 0.0f : mmax;
      float s = 0.0f;
      for (int wd = 0; wd < MASK_WORDS; ++wd) {
        uint32_t m = match[j * MASK_WORDS + wd];
        while (m) {
          const int i = wd * 32 + __ffs(m) - 1;
          m &= m - 1;
          const float base = ((int)cur[C_LAST * W + i] - 1 == lastj)
                                 ? __uint_as_float(cur[C_PB * W + i])
                                 : ptot[i];
          s += expf(fmaxf(base + lpc - msafe, NEG));
        }
      }
      const float msum = expf(fmaxf(sp - msafe, NEG)) + s;
      stay_m[j] = mdead ? NEG : msafe + logf(fmaxf(msum, 1e-38f));

      float swj = 0.0f;
      if (L > 0 && cur[C_WH1 * W + j] != 0u) {
        // Katz backoff with the carried context backoffs
        float pr = lmh[j] ? lmv[j] : *p.unk;
        bool exists = true;
        for (int c = 1; c < L; ++c) {
          exists = exists && cur[(C_CTX + 2 * (c - 1)) * W + j] != 0u;
          const float carry = __uint_as_float(cur[(C_BO + c - 1) * W + j]);
          const float pj = lmh[c * W + j] ? lmv[c * W + j] : carry + pr;
          pr = exists ? pj : pr;
        }
        swj = __fadd_rn(__fmul_rn(p.alpha, pr), p.beta);
      }
      sw[j] = swj;
      for (int c = 0; c < n_bo; ++c)
        newbo[c * W + j] = lmh[c * W + j] ? lmb[c * W + j] : 0.0f;
    }
    __syncthreads();

    // ---- candidate keys: W stays, then ext (i, k) at W + i * K + k ----
    for (int c = tid; c < p.npad; c += nt) {
      unsigned long long key = 0ull;       // padding ranks below all
      if (c < W) {
        const float lm = __uint_as_float(cur[C_LM * W + c]);
        key = cand_key(lse2(stay_pb[c], stay_m[c]) + lm, c);
      } else if (c < n_cand) {
        const int e = c - W, i = e / K, k = e - i * K;
        const float base = ((int)cur[C_LAST * W + i] - 1 == tci[k])
                               ? __uint_as_float(cur[C_PB * W + i])
                               : ptot[i];
        const float epnb = killed[e] ? NEG : base + tlp[k];
        const float elm = __uint_as_float(cur[C_LM * W + i]) +
                          ((L > 0 && tci[k] == p.space) ? sw[i] : 0.0f);
        key = cand_key(epnb + elm, c);
      }
      keys[c] = key;
    }
    __syncthreads();

    // ---- bitonic sort, descending ----
    for (int k = 2; k <= p.npad; k <<= 1) {
      for (int jj = k >> 1; jj > 0; jj >>= 1) {
        for (int i = tid; i < p.npad / 2; i += nt) {
          const int a = 2 * i - (i & (jj - 1)), c = a + jj;
          const unsigned long long ka = keys[a], kc = keys[c];
          const bool desc = (a & k) == 0;
          if (desc ? (ka < kc) : (ka > kc)) {
            keys[a] = kc;
            keys[c] = ka;
          }
        }
        __syncthreads();
      }
    }

    // ---- new slot s: parent select, payload recompute, state update ----
    for (int s = tid; s < W; s += nt) {
      const unsigned long long key = keys[s];
      const int c = (int)(0xFFFFFFFFu - (uint32_t)key);
      const bool dead = key_value(key) <= HALF_NEG;
      const bool is_stay = c < W;
      const int e = is_stay ? 0 : c - W;
      const int par = is_stay ? c : e / K;
      const int kidx = e - (e / K) * K;
      const int sel_char = is_stay ? -1 : tci[kidx];

      const uint32_t p_h1 = cur[C_H1 * W + par], p_h2 = cur[C_H2 * W + par];
      const float p_pb = __uint_as_float(cur[C_PB * W + par]);
      const float p_lm = __uint_as_float(cur[C_LM * W + par]);
      const int p_last = (int)cur[C_LAST * W + par] - 1;
      const uint32_t p_wh1 = cur[C_WH1 * W + par];
      const uint32_t p_wh2 = cur[C_WH2 * W + par];
      const uint32_t p_c1h1 = cur[C_CTX * W + par];
      const uint32_t p_c1h2 = cur[(C_CTX + 1) * W + par];
      const bool sel_space = sel_char == p.space;

      float new_pb, new_pnb, new_lm;
      if (is_stay) {
        new_pb = stay_pb[par];
        new_pnb = stay_m[par];
        new_lm = p_lm;
      } else {
        new_pb = NEG;
        new_pnb = ((p_last == sel_char) ? p_pb : ptot[par]) + tlp[kidx];
        new_lm = p_lm + ((L > 0 && sel_space) ? sw[par] : 0.0f);
      }
      const uint32_t cplus = (uint32_t)(sel_char + 1);
      const bool sel_sep = p_wh1 == 0u && (p_c1h1 != 0u || p_c1h2 != 0u);
      const uint32_t nb1 = sel_sep ? p_h1 * P1 + sp_u : p_h1;
      const uint32_t nb2 = sel_sep ? p_h2 * P2 + sp_u : p_h2;
      const bool keep = is_stay || sel_space;
      uint32_t new_h1 = keep ? p_h1 : nb1 * P1 + cplus;
      uint32_t new_h2 = keep ? p_h2 : nb2 * P2 + cplus;
      const bool is_space_ext = !is_stay && sel_space;
      const bool shift = is_space_ext && p_wh1 != 0u;
      const bool hold = is_stay || is_space_ext;
      const uint32_t new_wh1 =
          hold ? (is_space_ext ? 0u : p_wh1) : p_wh1 * P1 + cplus;
      const uint32_t new_wh2 =
          hold ? (is_space_ext ? 0u : p_wh2) : p_wh2 * P2 + cplus;
      if (dead) {
        new_h1 = 0x80000000u + (uint32_t)s;
        new_h2 = 0xFFFFFFFFu;
        new_pb = NEG;
        new_pnb = NEG;
      }
      const bool is_ext = sel_char >= 0;

      nxt[C_H1 * W + s] = new_h1;
      nxt[C_H2 * W + s] = new_h2;
      nxt[C_PB * W + s] = __float_as_uint(new_pb);
      nxt[C_PNB * W + s] = __float_as_uint(new_pnb);
      nxt[C_LM * W + s] = __float_as_uint(new_lm);
      nxt[C_LAST * W + s] = (uint32_t)((is_ext ? sel_char : p_last) + 1);
      nxt[C_ROW * W + s] = cur[C_ROW * W + par];
      nxt[C_PLEN * W + s] = cur[C_PLEN * W + par] + (is_ext ? 1u : 0u);
      nxt[C_WH1 * W + s] = new_wh1;
      nxt[C_WH2 * W + s] = new_wh2;
      // completed-word context shift: c_1 <- w, c_j <- c_{j-1}
      nxt[C_CTX * W + s] = shift ? p_wh1 : p_c1h1;
      nxt[(C_CTX + 1) * W + s] = shift ? p_wh2 : p_c1h2;
      for (int c2 = 1; c2 < n_ctxw; ++c2) {
        const int col = C_CTX + 2 * c2;
        nxt[col * W + s] = cur[(shift ? col - 2 : col) * W + par];
        nxt[(col + 1) * W + s] = cur[(shift ? col - 1 : col + 1) * W + par];
      }
      for (int c2 = 0; c2 < n_bo; ++c2)
        nxt[(C_BO + c2) * W + s] = shift ? __float_as_uint(newbo[c2 * W + par])
                                         : cur[(C_BO + c2) * W + par];
      const size_t at = ((size_t)t * p.B + b) * W + s;
      p.parents[at] = par;
      p.chars[at] = sel_char;
    }
    __syncthreads();
    uint32_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  // frozen frames: identity backpointers
  for (int q = tid; q < (T - len) * W; q += nt) {
    const int t = len + q / W, s = q % W;
    const size_t at = ((size_t)t * p.B + b) * W + s;
    p.parents[at] = s;
    p.chars[at] = -1;
  }
  uint32_t* out = p.st_out + (size_t)b * W * NC;
  for (int q = tid; q < W * NC; q += nt) out[q] = cur[(q % NC) * W + q / NC];
}

}  // namespace

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Dynamic shared-memory bytes one launch asks for; 0 when the shape is
// outside the kernel's plan (the wrapper refuses it).
extern "C" long long vt_beam_smem_bytes(int W, int K, int V1, int NC,
                                        int levels) {
  if (W < 1 || W > MAX_W || K < 1 || V1 < 2 || levels < 0 ||
      levels > MAX_LEVELS)
    return 0;
  const int npad = next_pow2(W * (K + 1));
  return (long long)layout(W, K, V1, NC, levels, npad).total;
}

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int vt_beam_search(const void* lp, const void* lens,
                              const void* top_lp, const void* top_ci,
                              const void* st0, const void* lm,
                              const void* masks, const void* bases,
                              const void* unk, void* st_out, void* parents,
                              void* chars, int B, int T, int V1, int K, int W,
                              int NC, int blank, int space, int levels,
                              int probes, int smem, float alpha, float beta,
                              void* stream) {
  const int npad = next_pow2(W * (K + 1));
  if (W < 1 || W > MAX_W || levels < 0 || levels > MAX_LEVELS ||
      (levels > 0 && (lm == nullptr || probes < 1)) ||
      smem != layout(W, K, V1, NC, levels, npad).total)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  Params p;
  p.lp = (const float*)lp;
  p.lens = (const int*)lens;
  p.top_lp = (const float*)top_lp;
  p.top_ci = (const int*)top_ci;
  p.st0 = (const uint32_t*)st0;
  p.lm = (const uint4*)lm;
  p.masks = (const long long*)masks;
  p.bases = (const long long*)bases;
  p.unk = (const float*)unk;
  p.st_out = (uint32_t*)st_out;
  p.parents = (int*)parents;
  p.chars = (int*)chars;
  p.B = B;
  p.T = T;
  p.V1 = V1;
  p.K = K;
  p.W = W;
  p.NC = NC;
  p.blank = blank;
  p.space = space;
  p.levels = levels;
  p.probes = probes;
  p.npad = npad;
  p.alpha = alpha;
  p.beta = beta;
  cudaError_t err = cudaFuncSetAttribute(
      beam_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  beam_kernel<<<B, block_threads(npad), smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
