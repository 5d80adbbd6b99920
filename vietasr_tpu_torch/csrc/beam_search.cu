// Fused CTC prefix beam search for Hopper (sm_90a): the whole decode over T
// in one launch, with optional word-LM shallow fusion (order <= 5).
//
// Replaces: vietasr_tpu/ops/pallas_beam.py::_beam_kernel (the Pallas TPU
// kernel behind pallas_beam_search). Contract: the raw result of
// ops/device_beam.py::device_beam_search (return_raw=True) with canonical
// (space-normalised) beam identity, cutoff_top_n > 0, no char-LM table and
// W <= 128: the final packed state (B, W, n_cols) and the (parent, char)
// backpointers (T, B, W), slot by slot and bit for bit.
//
// What bounds it on the H100: neither bytes nor operations. The T steps of
// an utterance are strictly sequential, each needing the previous step's
// beams, and one utterance is one thread block on one SM. So the time is T
// times one step, and a step is a chain of phases separated by
// __syncthreads, each as long as the instructions its SM issues for it or
// its longest dependent chain. The design keeps both short: no O(W^2) or
// O(n log^2 n) work per step, and five phases.
//
// Per utterance one thread block (blockIdx.x = b), the loop over t inside
// the kernel (the TPU kernel's sequential grid). The packed beam state
// lives in shared memory as columns (col * W + slot), an old and a new
// copy, loaded once and written back once after the last valid frame;
// frames t >= len write identity backpointers. One step:
//   P1 thread j < W: the merge into stay j. Stay j absorbs ext(i, last_j)
//      iff b(i) * P + (last_j + 1) == hash(j), b(i) being beam i's
//      separator-folded hash base (for a space: iff hash(i) == hash(j)).
//      P is odd, so b(i) == (hash(j) - last_j - 1) * P^-1 mod 2^32: one
//      lookup in a chained hash table keyed by b (or by the hash), built
//      by the step before, instead of a scan over W parents. The matches
//      go into a 128-bit mask; the max over them, then the sum of expf
//      terms in ascending parent order (the plain version's order; another
//      order rounds differently). A matched extension is marked dead with
//      the step's stamp (t + 1); the tables' heads and the LM hit flags
//      carry stamps too, so nothing is ever cleared. The stay ends as its
//      64-bit key (P2). From the next warp on, one thread per (chain, beam)
//      probes the word LM's open-addressing (N, 4) table, copied to shared
//      memory when it has at most 4,096 rows, else read in device memory
//      (L2-resident): linear probing put every key before the first empty
//      row of its probe path, so the scan stops at a hit or an empty row,
//      and the table's keys are unique per level, so this is
//      _word_lm_score(dense=False)'s result. Once all chains are in (a
//      named barrier of those warps), one thread per beam takes the Katz
//      combine with the carried context backoffs. Frame t+1's log-prob row
//      and top-K go to the other half of a double buffer with cp.async.
//   P2 top-W select, part 1. A candidate (W stays, then W*K extensions,
//      the plain version's order) is the 64-bit key (order-preserving bits
//      of its total) << 32 | ~index: value descending, then index
//      ascending, XLA's top_k order, hence the plain version's slot order.
//      Warp r of R (>= W*(K+1)/64, coprime to K) computes the keys of
//      candidates r, r + R, r + 2R, ... (2 per lane; a stride coprime to K,
//      so that every run holds stays and extensions of every parent and
//      char alike) and stores them; a __shfl_xor_sync bitonic network (21
//      stages, no block barrier) sorts their 32-bit value bits, and the
//      k-th largest value, k = ceil(W / R), goes to theta (atomicMin).
//      Every run has k keys whose value is >= theta, so R*k >= W keys
//      have: the W best keys all have.
//   P3 the keys whose value is >= theta move to one array (ballot, popc,
//      one atomicAdd a warp): about 115 of the 900 at W = 100, K = 8.
//   P4 each of them counts the larger ones in that array, 32 at a time per
//      thread, the last of its parts to add in (one packed atomicAdd)
//      holding the total: its rank among all candidates, since every key
//      larger than it is in the array too. A rank < W is its slot. Above
//      256 of them (while most beams are dead, the first steps) the runs
//      are sorted (one more barrier), and a key's rank is its index in its
//      run plus a branch-free binary search in each other run, four in
//      flight. The Pallas kernel's radix threshold select needs a pass and
//      barrier per digit of the 64-bit key; a merge tree, one per level.
//   P5 thread s < W: new slot s selects its parent, recomputes the
//      extension payload and the word/context/backoff state, writes the
//      backpointers, and prepares its next step: p_total, the stay scores,
//      its last char's place in frame t+1's top-K, and its entries in the
//      merge's hash tables.
// Barriers per step: 5 block-wide (__syncthreads), 6 in a step of more
// than 256 keys >= theta. Where the caller passes `stats`, thread 0 of
// each block counts the barriers its steps took and the keys >= theta they
// ranked, so a run reports what it did. The block has 32 * clamp(max(R,
// ceil(W / 32) + 4 * L), 4, 32) threads: 512 at W = 100, K = 8 with a
// word 3-gram.
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
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MAX_W = 128;
constexpr int RUN = 64;                      // keys one warp sorts
constexpr int SEARCHES = 4;                  // binary searches in flight
constexpr int COUNT_MAX = 256;               // rank by counting up to here
constexpr int MAX_LEVELS = 5;
constexpr int MIN_WARPS = 4, MAX_WARPS = 32;
constexpr int MAX_THREADS = 32 * MAX_WARPS;
constexpr int PROBE_BATCH = 4;               // LM rows a probe loads at once
constexpr int BUCKET_BITS = 8;               // hash-table buckets: 256
constexpr int MAX_T = 1 << 23;               // stamp << 8 | slot fits int
constexpr int LM_SMEM_ROWS = 4096;           // word-LM tables up to 64 KB
constexpr int SMEM_MAX = 232448;             // shared memory of an H100 block
// packed-state columns (ops/device_beam.py)
constexpr int C_H1 = 0, C_H2 = 1, C_PB = 2, C_PNB = 3, C_LM = 4, C_LAST = 5,
              C_ROW = 6, C_PLEN = 7, C_WH1 = 8, C_WH2 = 9, C_CTX = 10;

// a^-1 mod 2^32 for odd a (Newton: each step doubles the correct bits)
constexpr uint32_t inverse32(uint32_t a) {
  uint32_t x = a;
  for (int i = 0; i < 5; ++i) x *= 2u - a * x;
  return x;
}
constexpr uint32_t INV_P1 = inverse32(P1), INV_P2 = inverse32(P2);
static_assert(P1 * INV_P1 == 1u && P2 * INV_P2 == 1u, "hash inverses");

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
  long long* stats;         // (B, 2): barriers, keys >= theta; or null
  int B, T, V1, K, W, NC, blank, space, levels, probes, lm_rows;
  float alpha, beta;
};

// byte offsets of the shared-memory arrays (16-byte aligned each)
struct Layout {
  int runs, surv, acc, top, skey, st, lp, tlp, tci, ik, ptot, spb, spnb, kpos,
      sm, sw, nbo, b1, b2, lmv, lmb, lmh, killed, head_a, head_b, next_a,
      next_b, misc, lmtab, tab_rows, total;
};

__host__ __device__ inline int take(int& off, int bytes) {
  const int at = off;
  off += (bytes + 15) & ~15;
  return at;
}

__host__ __device__ inline int gcd(int a, int b) {
  while (b) {
    const int r = a % b;
    a = b;
    b = r;
  }
  return a;
}

// runs of the select: enough for RUN keys each, coprime to K
__host__ __device__ inline int n_runs(int W, int K) {
  int r = (W * (K + 1) + RUN - 1) / RUN;
  while (gcd(r, K) > 1) ++r;
  return r;
}

__host__ __device__ inline int stay_threads(int W) { return (W + 31) & ~31; }

__host__ inline int block_threads(int W, int K, int levels) {
  const int p1 = stay_threads(W) + levels * MAX_W;
  int w = n_runs(W, K);
  w = w > (p1 + 31) / 32 ? w : (p1 + 31) / 32;
  w = w < MIN_WARPS ? MIN_WARPS : (w > MAX_WARPS ? MAX_WARPS : w);
  return 32 * w;
}

__host__ __device__ inline Layout layout(int W, int K, int V1, int NC,
                                         int levels, int lm_rows) {
  const int n_bo = levels > 1 ? levels - 1 : 0;
  const int nl = levels > 0 ? levels : 1;
  const int keys = n_runs(W, K) * RUN;
  Layout o;
  int off = 0;
  o.runs = take(off, 8 * keys);                // each warp's keys
  o.surv = take(off, 8 * COUNT_MAX);           // the keys >= theta
  o.acc = take(off, 4 * COUNT_MAX);            // their parts << 16 | rank
  o.top = take(off, 8 * W);                    // the W best keys, in order
  o.skey = take(off, 8 * W);                   // stay keys
  o.st = take(off, 4 * 2 * NC * W);
  o.lp = take(off, 4 * 2 * V1);                // double-buffered frame
  o.tlp = take(off, 4 * 2 * K);
  o.tci = take(off, 4 * 2 * K);
  o.ik = take(off, 2 * W * K);                 // ext e -> parent << 9 | k
  o.ptot = take(off, 4 * 2 * W);               // per beam, double-buffered
  o.spb = take(off, 4 * 2 * W);
  o.spnb = take(off, 4 * 2 * W);
  o.kpos = take(off, 4 * 2 * W);
  o.sm = take(off, 4 * W);
  o.sw = take(off, 4 * W);
  o.nbo = take(off, 4 * W * (n_bo > 0 ? n_bo : 1));
  o.b1 = take(off, 4 * W);
  o.b2 = take(off, 4 * W);
  o.lmv = take(off, 4 * W * nl);
  o.lmb = take(off, 4 * W * nl);
  o.lmh = take(off, 4 * W * nl);               // step stamp of a hit
  o.killed = take(off, 4 * W * K);             // step stamp of a merge
  o.head_a = take(off, 4 << BUCKET_BITS);      // stamp << 8 | first slot
  o.head_b = take(off, 4 << BUCKET_BITS);
  o.next_a = take(off, 4 * W);
  o.next_b = take(off, 4 * W);
  o.misc = take(off, 64);      // theta; LM masks and bases; survivors
  // the word-LM table's copy, where it fits
  const bool tab = levels > 0 && lm_rows <= LM_SMEM_ROWS &&
                   off + 16 * lm_rows <= SMEM_MAX;
  o.lmtab = take(off, tab ? 16 * lm_rows : 0);
  o.tab_rows = tab ? lm_rows : 0;
  o.total = off;
  return o;
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

__device__ __forceinline__ int bucket(uint32_t key) {
  return (int)((key * MIX) >> (32 - BUCKET_BITS));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// frame f's log-prob row and top-K into one half of the frame buffer
__device__ __forceinline__ void copy_frame(const Params& p, size_t f,
                                           float* lp, float* tlp, int* tci,
                                           int tid, int nt) {
  for (int i = tid; i < p.V1; i += nt) cp_async4(lp + i, p.lp + f * p.V1 + i);
  for (int i = tid; i < p.K; i += nt) {
    cp_async4(tlp + i, p.top_lp + f * p.K + i);
    cp_async4(tci + i, p.top_ci + f * p.K + i);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// What beam s needs at the step of `stamp` from its own state and that
// step's frame: p_total, the stay scores, its last char's place in the
// frame's top-K (arrays of that step's half), and its entries in the
// merge's hash tables: under its separator-folded hash base b (table a) and
// under its own hash (table b).
struct StepArrays {
  float *ptot, *spb, *spnb;
  int* kpos;
  uint32_t *b1, *b2;
  int *head_a, *head_b, *next_a, *next_b;
};

__device__ __forceinline__ void prepare_beam(
    const StepArrays& a, int s, float pb, float pnb, int last, uint32_t h1,
    uint32_t h2, bool need_sep, const float* lp, const int* tci, int K,
    int blank, uint32_t sp_u, int stamp) {
  const float pt = lse2(pb, pnb);
  a.ptot[s] = pt;
  a.spb[s] = pt + lp[blank];
  a.spnb[s] = last >= 0 ? pnb + lp[last] : NEG;
  int kp = -1;
  for (int k0 = 0; last >= 0 && k0 < K; k0 += 8) {
#pragma unroll
    for (int u = 7; u >= 0; --u)     // the first match wins
      if (k0 + u < K && tci[k0 + u] == last) kp = k0 + u;
    if (kp >= 0) break;
  }
  a.kpos[s] = kp;
  const uint32_t bs1 = need_sep ? h1 * P1 + sp_u : h1;
  a.b1[s] = bs1;
  a.b2[s] = need_sep ? h2 * P2 + sp_u : h2;
  const int entry = (stamp << 8) | s;
  int old = atomicExch(&a.head_a[bucket(bs1)], entry);
  a.next_a[s] = (old >> 8) == stamp ? (old & 0xFF) : -1;
  old = atomicExch(&a.head_b[bucket(h1)], entry);
  a.next_b[s] = (old >> 8) == stamp ? (old & 0xFF) : -1;
}

// 64 keys of one warp, a at position lane and b at lane + 32, sorted
// descending by a bitonic network of shuffles
template <typename Key>
__device__ __forceinline__ void warp_sort64(Key& a, Key& b, int lane) {
#pragma unroll
  for (int k = 2; k <= 2 * 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j == 32) {                 // k == 64: positions lane, lane + 32
        const Key hi = a > b ? a : b, lo = a > b ? b : a;
        a = hi;
        b = lo;
      } else {
        const Key pa = __shfl_xor_sync(FULL, a, j);
        const Key pb = __shfl_xor_sync(FULL, b, j);
        const bool lower = (lane & j) == 0;
        // a pair sorts descending where (position & k) == 0; its lower
        // position keeps the larger key then, the smaller key otherwise
        const bool keep_a_max = lower == ((lane & k) == 0);
        const bool keep_b_max = lower == (((lane + 32) & k) == 0);
        a = keep_a_max ? (a > pa ? a : pa) : (a < pa ? a : pa);
        b = keep_b_max ? (b > pb ? b : pb) : (b < pb ? b : pb);
      }
    }
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
    beam_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int W = p.W, K = p.K, NC = p.NC, T = p.T, V1 = p.V1;
  const int L = p.levels, P = p.probes;
  const int n_ctxw = L - 1 > 1 ? L - 1 : 1;
  const int n_bo = L > 1 ? L - 1 : 0;
  const int C_BO = C_CTX + 2 * n_ctxw;
  const int n_cand = W * (K + 1);
  const int R = n_runs(W, K);
  const int kth = (W + R - 1) / R;   // <= 32 and <= every run's keys
  const uint32_t sp_u = (uint32_t)(p.space + 1);

  const Layout o = layout(W, K, V1, NC, L, p.lm_rows);
  unsigned long long* runs = (unsigned long long*)(smem + o.runs);
  unsigned long long* surv = (unsigned long long*)(smem + o.surv);
  int* acc = (int*)(smem + o.acc);
  unsigned long long* top = (unsigned long long*)(smem + o.top);
  unsigned long long* skey = (unsigned long long*)(smem + o.skey);
  uint32_t* cur = (uint32_t*)(smem + o.st);
  uint32_t* nxt = cur + NC * W;
  float* lp_buf = (float*)(smem + o.lp);
  float* tlp_buf = (float*)(smem + o.tlp);
  int* tci_buf = (int*)(smem + o.tci);
  uint16_t* ik = (uint16_t*)(smem + o.ik);
  float* stay_m = (float*)(smem + o.sm);
  float* sw = (float*)(smem + o.sw);
  float* newbo = (float*)(smem + o.nbo);      // (n_bo, W)
  float* lmv = (float*)(smem + o.lmv);        // (L, W)
  float* lmb = (float*)(smem + o.lmb);
  int* lmh = (int*)(smem + o.lmh);
  // the word-LM table: its shared-memory copy where it fits
  const bool tab_smem = o.tab_rows > 0;
  uint4* lmtab = (uint4*)(smem + o.lmtab);
  int* killed = (int*)(smem + o.killed);      // (W, K)
  StepArrays sa;                              // the current step's half
  sa.b1 = (uint32_t*)(smem + o.b1);
  sa.b2 = (uint32_t*)(smem + o.b2);
  sa.head_a = (int*)(smem + o.head_a);
  sa.head_b = (int*)(smem + o.head_b);
  sa.next_a = (int*)(smem + o.next_a);
  sa.next_b = (int*)(smem + o.next_b);
  uint32_t* theta = (uint32_t*)(smem + o.misc);
  uint32_t* lm_mask = (uint32_t*)(smem + o.misc + 8);     // (L,)
  uint32_t* lm_base = lm_mask + MAX_LEVELS;                // (L,)
  int* n_surv = (int*)(lm_base + MAX_LEVELS);
  auto half_arrays = [&](int h) {
    StepArrays a = sa;
    a.ptot = (float*)(smem + o.ptot) + h * W;
    a.spb = (float*)(smem + o.spb) + h * W;
    a.spnb = (float*)(smem + o.spnb) + h * W;
    a.kpos = (int*)(smem + o.kpos) + h * W;
    return a;
  };

  const uint32_t* st0 = p.st0 + (size_t)b * W * NC;
  for (int q = tid; q < W * NC; q += nt) cur[(q % NC) * W + q / NC] = st0[q];
  for (int q = tid; q < W * (L > 0 ? L : 1); q += nt) lmh[q] = 0;
  if (tab_smem)
    for (int q = tid; q < p.lm_rows; q += nt) lmtab[q] = __ldg(p.lm + q);
  for (int q = tid; q < W * K; q += nt) {
    killed[q] = 0;
    ik[q] = (uint16_t)(((q / K) << 9) | (q % K));
  }
  for (int q = tid; q < (1 << BUCKET_BITS); q += nt)
    sa.head_a[q] = sa.head_b[q] = 0;
  if (tid < L) {
    lm_mask[tid] = (uint32_t)p.masks[tid];
    lm_base[tid] = (uint32_t)p.bases[tid];
  }
  const float unk = L > 0 ? *p.unk : 0.0f;
  int len = p.lens[b];
  len = len < 0 ? 0 : (len > T ? T : len);
  if (len > 0) copy_frame(p, (size_t)b * T, lp_buf, tlp_buf, tci_buf, tid, nt);
  cp_async_wait_all();
  __syncthreads();
  if (tid < W && len > 0)
    prepare_beam(half_arrays(0), tid, __uint_as_float(cur[C_PB * W + tid]),
                 __uint_as_float(cur[C_PNB * W + tid]),
                 (int)cur[C_LAST * W + tid] - 1, cur[C_H1 * W + tid],
                 cur[C_H2 * W + tid],
                 cur[C_WH1 * W + tid] == 0u &&
                     (cur[C_CTX * W + tid] != 0u ||
                      cur[(C_CTX + 1) * W + tid] != 0u),
                 lp_buf, tci_buf, K, p.blank, sp_u, 1);
  __syncthreads();
  // the barriers the steps took and the keys >= theta they ranked
  long long n_bar = 0, n_ranked = 0;

  for (int t = 0; t < len; ++t) {
    const int half = t & 1;
    const float* tlp = tlp_buf + half * K;
    const int* tci = tci_buf + half * K;
    const int stamp = t + 1;
    const StepArrays now = half_arrays(half);
    if (t + 1 < len)
      copy_frame(p, (size_t)b * T + t + 1, lp_buf + (half ^ 1) * V1,
                 tlp_buf + (half ^ 1) * K, tci_buf + (half ^ 1) * K, tid, nt);
    if (tid == 0) {
      *theta = ~0u;
      *n_surv = 0;
    }

    // ---- P1: merge into stay j (threads j < W); LM probes (threads from
    // the next warp on, item level * 128 + j), then the Katz combine of
    // beam j once every probe is in (a named barrier) ----
    const int st_n = stay_threads(W);
    if (tid >= st_n) {
      for (int q = tid - st_n; q < L * MAX_W; q += nt - st_n) {
        const int j = q & (MAX_W - 1), lvl = q >> 7;
        if (j >= W) continue;
        const uint32_t wh1 = cur[C_WH1 * W + j];
        if (wh1 == 0u) continue;       // an empty partial word is never scored
        uint32_t s1 = KEY_SEED, s2 = KEY_SEED;
        for (int i = lvl; i >= 1; --i) {        // oldest context first
          s1 = s1 * Q1 + cur[(C_CTX + 2 * (i - 1)) * W + j];
          s2 = s2 * Q2 + cur[(C_CTX + 2 * (i - 1) + 1) * W + j];
        }
        const uint32_t k1 = s1 * Q1 + wh1;
        const uint32_t k2 = s2 * Q2 + cur[C_WH2 * W + j];
        if (k1 == 0u) continue;                 // key 0 marks empty slots
        const uint32_t mask = lm_mask[lvl];
        const uint4* rows = (tab_smem ? lmtab : p.lm) + lm_base[lvl];
        const uint32_t idx0 = k1 ^ (k2 * MIX);
        // linear probing put every key before the first empty row of its
        // probe path (and within `probes` rows): the scan may stop there
        bool done = false;
        for (int pr0 = 0; pr0 < P && !done; pr0 += PROBE_BATCH) {
          uint4 row[PROBE_BATCH];
#pragma unroll
          for (int u = 0; u < PROBE_BATCH; ++u)
            if (pr0 + u < P) row[u] = rows[(idx0 + pr0 + u) & mask];
#pragma unroll
          for (int u = 0; u < PROBE_BATCH; ++u) {
            if (done || pr0 + u >= P) continue;
            if (row[u].x == k1 && row[u].y == k2) {
              lmh[lvl * W + j] = stamp;
              lmv[lvl * W + j] = __uint_as_float(row[u].z);
              lmb[lvl * W + j] = __uint_as_float(row[u].w);
            }
            done = row[u].x == 0u || (row[u].x == k1 && row[u].y == k2);
          }
        }
      }
      if (L > 0) {
        asm volatile("bar.sync 1, %0;\n" ::"r"(nt - st_n) : "memory");
        for (int j = tid - st_n; j < W; j += nt - st_n) {
          float swj = 0.0f;
          if (cur[C_WH1 * W + j] != 0u) {
            // Katz backoff with the carried context backoffs
            float pr = lmh[j] == stamp ? lmv[j] : unk;
            bool exists = true;
#pragma unroll
            for (int c = 1; c < MAX_LEVELS; ++c) {
              if (c >= L) continue;
              exists = exists && cur[(C_CTX + 2 * (c - 1)) * W + j] != 0u;
              const float carry = __uint_as_float(cur[(C_BO + c - 1) * W + j]);
              const float pj = lmh[c * W + j] == stamp ? lmv[c * W + j]
                                                       : carry + pr;
              pr = exists ? pj : pr;
            }
            swj = __fadd_rn(__fmul_rn(p.alpha, pr), p.beta);
          }
          sw[j] = swj;
          for (int c = 0; c < n_bo; ++c)
            newbo[c * W + j] = lmh[c * W + j] == stamp ? lmb[c * W + j] : 0.0f;
        }
      }
    } else if (tid < W) {
      const int j = tid;
      const float sp = now.spnb[j];
      const int kp = now.kpos[j];
      const int lastj = (int)cur[C_LAST * W + j] - 1;
      const float lpc = kp >= 0 ? tlp[kp] : 0.0f;
      unsigned long long lo = 0ull, hi = 0ull;      // matched parents
      float mmax = sp;
      if (kp >= 0) {
        const uint32_t hj1 = cur[C_H1 * W + j], hj2 = cur[C_H2 * W + j];
        const bool on_space = lastj == p.space;
        const uint32_t cpl = (uint32_t)(lastj + 1);
        const uint32_t t1 = on_space ? hj1 : (hj1 - cpl) * INV_P1;
        const uint32_t t2 = on_space ? hj2 : (hj2 - cpl) * INV_P2;
        const uint32_t* k1 = on_space ? cur + C_H1 * W : now.b1;
        const uint32_t* k2 = on_space ? cur + C_H2 * W : now.b2;
        const int* next = on_space ? now.next_b : now.next_a;
        const int h = (on_space ? now.head_b : now.head_a)[bucket(t1)];
        for (int i = (h >> 8) == stamp ? (h & 0xFF) : -1; i >= 0;
             i = next[i]) {
          if (k1[i] != t1 || k2[i] != t2) continue;
          if (i < 64) lo |= 1ull << i;
          else hi |= 1ull << (i - 64);
          const float base = ((int)cur[C_LAST * W + i] - 1 == lastj)
                                 ? __uint_as_float(cur[C_PB * W + i])
                                 : now.ptot[i];
          mmax = fmaxf(mmax, base + lpc);
          killed[i * K + kp] = stamp;
        }
      }
      const bool mdead = mmax <= HALF_NEG;
      const float msafe = mdead ? 0.0f : mmax;
      float s = 0.0f;
      for (int part = 0; part < 2; ++part) {
        unsigned long long m = part ? hi : lo;
        while (m) {                    // ascending parent order
          const int i = part * 64 + __ffsll((long long)m) - 1;
          m &= m - 1;
          const float base = ((int)cur[C_LAST * W + i] - 1 == lastj)
                                 ? __uint_as_float(cur[C_PB * W + i])
                                 : now.ptot[i];
          s += expf(fmaxf(base + lpc - msafe, NEG));
        }
      }
      const float msum = expf(fmaxf(sp - msafe, NEG)) + s;
      const float stm = mdead ? NEG : msafe + logf(fmaxf(msum, 1e-38f));
      stay_m[j] = stm;
      skey[j] = cand_key(
          lse2(now.spb[j], stm) + __uint_as_float(cur[C_LM * W + j]), j);
    }
    __syncthreads();                                          // 1
    ++n_bar;

    // ---- P2: warp r keys, sorts and stores run r: candidates r + R*p;
    // ext (i, k) is candidate W + i * K + k ----
    for (int r = warp; r < R; r += nwarps) {
      unsigned long long kk[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = r + R * (h * 32 + lane);
        unsigned long long key = 0ull;       // padding ranks below all
        if (c < W) {
          key = skey[c];
        } else if (c < n_cand) {
          const int e = c - W, i = ik[e] >> 9, k = ik[e] & 0x1FF;
          const int ck = tci[k];
          const float base = ((int)cur[C_LAST * W + i] - 1 == ck)
                                 ? __uint_as_float(cur[C_PB * W + i])
                                 : now.ptot[i];
          const float epnb = killed[e] == stamp ? NEG : base + tlp[k];
          const float elm = __uint_as_float(cur[C_LM * W + i]) +
                            ((L > 0 && ck == p.space) ? sw[i] : 0.0f);
          key = cand_key(epnb + elm, c);
        }
        kk[h] = key;
      }
      runs[r * RUN + lane] = kk[0];
      runs[r * RUN + lane + 32] = kk[1];
      uint32_t va = (uint32_t)(kk[0] >> 32), vb = (uint32_t)(kk[1] >> 32);
      warp_sort64(va, vb, lane);
      const uint32_t kv = __shfl_sync(FULL, va, kth - 1);
      if (lane == 0) atomicMin(theta, kv);
    }
    __syncthreads();                                          // 2
    ++n_bar;

    // ---- P3: the keys >= theta (a sorted prefix of each run) move to
    // `surv`, one warp per run ----
    const uint32_t th = *theta;
    for (int r = warp; r < R; r += nwarps) {
      const unsigned long long ka = runs[r * RUN + lane];
      const unsigned long long kb = runs[r * RUN + lane + 32];
      const bool in_a = (uint32_t)(ka >> 32) >= th;
      const bool in_b = (uint32_t)(kb >> 32) >= th;
      const unsigned va = __ballot_sync(FULL, in_a);
      const unsigned vb = __ballot_sync(FULL, in_b);
      const unsigned below = (1u << lane) - 1u;
      int at = 0;
      if (lane == 0 && (va | vb)) at = atomicAdd(n_surv, __popc(va) + __popc(vb));
      at = __shfl_sync(FULL, at, 0);
      const int ia = at + __popc(va & below);
      const int ib = at + __popc(va) + __popc(vb & below);
      if (in_a && ia < COUNT_MAX) {  // more: P4 ranks in the runs instead
        surv[ia] = ka;
        acc[ia] = 0;
      }
      if (in_b && ib < COUNT_MAX) {
        surv[ib] = kb;
        acc[ib] = 0;
      }
    }
    __syncthreads();                                          // 3
    ++n_bar;

    // ---- P4: each key >= theta finds its rank; ranks < W are the
    // slots. Every key larger than such a key is >= theta too, so its
    // rank among them is its rank among all candidates ----
    const int ns = *n_surv;
    if (ns <= COUNT_MAX) {
      // count the larger keys, 32 at a time per thread; the last of a
      // key's parts to add its count in holds the rank
      const int parts = (ns + 31) >> 5;
      for (int q = tid; q < ns * parts; q += nt) {
        const int part = q / ns, x = q - part * ns;
        const unsigned long long key = surv[x];
        const int m1 = min(part * 32 + 32, ns);
        int cnt = 0;
#pragma unroll 8
        for (int m2 = part * 32; m2 < m1; ++m2) cnt += surv[m2] > key;
        const int old = atomicAdd(&acc[x], (1 << 16) | cnt);
        const int rank = (old & 0xFFFF) + cnt;
        if ((old >> 16) == parts - 1 && rank < W) top[rank] = key;
      }
    } else {
      // sort the runs; then a key's rank is its index in its run plus the
      // larger keys in the others, by binary searches
      for (int r = warp; r < R; r += nwarps) {
        unsigned long long ka = runs[r * RUN + lane];
        unsigned long long kb = runs[r * RUN + lane + 32];
        warp_sort64(ka, kb, lane);
        runs[r * RUN + lane] = ka;
        runs[r * RUN + lane + 32] = kb;
      }
      __syncthreads();
      ++n_bar;
      for (int q = tid; q < R * RUN; q += nt) {
        const int i = q / R, a = q - i * R;    // index i in run a
        const unsigned long long key = runs[a * RUN + i];
        if ((uint32_t)(key >> 32) < th) continue;
        int rank = i;
        for (int r0 = 0; r0 < R; r0 += SEARCHES) {
          int pos[SEARCHES];
#pragma unroll
          for (int u = 0; u < SEARCHES; ++u) pos[u] = 0;
#pragma unroll
          for (int step = RUN; step > 0; step >>= 1) {
#pragma unroll
            for (int u = 0; u < SEARCHES; ++u) {
              const int r = r0 + u;
              if (r < R && r != a && pos[u] + step <= RUN &&
                  runs[r * RUN + pos[u] + step - 1] > key)
                pos[u] += step;
            }
          }
#pragma unroll
          for (int u = 0; u < SEARCHES; ++u) rank += pos[u];
        }
        if (rank < W) top[rank] = key;
      }
    }
    cp_async_wait_all();             // frame t + 1 has landed: P5 reads it
    __syncthreads();                                          // 4
    ++n_bar;
    n_ranked += ns;

    // ---- P5: new slot s: parent select, payload recompute, state
    // update; then what slot s needs at the next step ----
    if (tid < W) {
      const int s = tid;
      const unsigned long long key = top[s];
      const int c = (int)(0xFFFFFFFFu - (uint32_t)key);
      const bool dead = key_value(key) <= HALF_NEG;
      const bool is_stay = c < W;
      const int e = is_stay ? 0 : c - W;
      const int par = is_stay ? c : ik[e] >> 9;
      const int kidx = is_stay ? 0 : ik[e] & 0x1FF;
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
        new_pb = now.spb[par];
        new_pnb = stay_m[par];
        new_lm = p_lm;
      } else {
        new_pb = NEG;
        new_pnb = ((p_last == sel_char) ? p_pb : now.ptot[par]) + tlp[kidx];
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
      const int new_last = is_ext ? sel_char : p_last;
      // completed-word context shift: c_1 <- w, c_j <- c_{j-1}
      const uint32_t new_c1h1 = shift ? p_wh1 : p_c1h1;
      const uint32_t new_c1h2 = shift ? p_wh2 : p_c1h2;

      nxt[C_H1 * W + s] = new_h1;
      nxt[C_H2 * W + s] = new_h2;
      nxt[C_PB * W + s] = __float_as_uint(new_pb);
      nxt[C_PNB * W + s] = __float_as_uint(new_pnb);
      nxt[C_LM * W + s] = __float_as_uint(new_lm);
      nxt[C_LAST * W + s] = (uint32_t)(new_last + 1);
      nxt[C_ROW * W + s] = cur[C_ROW * W + par];
      nxt[C_PLEN * W + s] = cur[C_PLEN * W + par] + (is_ext ? 1u : 0u);
      nxt[C_WH1 * W + s] = new_wh1;
      nxt[C_WH2 * W + s] = new_wh2;
      nxt[C_CTX * W + s] = new_c1h1;
      nxt[(C_CTX + 1) * W + s] = new_c1h2;
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
      if (t + 1 < len)
        prepare_beam(half_arrays(half ^ 1), s, new_pb, new_pnb, new_last,
                     new_h1, new_h2,
                     new_wh1 == 0u && (new_c1h1 != 0u || new_c1h2 != 0u),
                     lp_buf + (half ^ 1) * V1, tci_buf + (half ^ 1) * K, K,
                     p.blank, sp_u, stamp + 1);
    }
    __syncthreads();                                          // 5
    ++n_bar;
    uint32_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  if (tid == 0 && p.stats != nullptr) {
    p.stats[2 * b] = n_bar;
    p.stats[2 * b + 1] = n_ranked;
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

bool plan_ok(int W, int K, int V1, int levels) {
  return W >= 1 && W <= MAX_W && K >= 1 && K < (1 << 9) && V1 >= 2 &&
         levels >= 0 && levels <= MAX_LEVELS;
}

}  // namespace

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Dynamic shared-memory bytes one launch asks for; 0 when the shape is
// outside the kernel's plan (the wrapper refuses it).
extern "C" long long vt_beam_smem_bytes(int W, int K, int V1, int NC,
                                        int levels, int lm_rows) {
  if (!plan_ok(W, K, V1, levels) || lm_rows < 0) return 0;
  return (long long)layout(W, K, V1, NC, levels, lm_rows).total;
}

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int vt_beam_search(const void* lp, const void* lens,
                              const void* top_lp, const void* top_ci,
                              const void* st0, const void* lm,
                              const void* masks, const void* bases,
                              const void* unk, void* st_out, void* parents,
                              void* chars, void* stats, int B, int T,
                              int V1, int K, int W,
                              int NC, int blank, int space, int levels,
                              int probes, int lm_rows, int smem, float alpha,
                              float beta,
                              void* stream) {
  if (!plan_ok(W, K, V1, levels) || T >= MAX_T ||
      (levels > 0 && (lm == nullptr || probes < 1)) ||
      lm_rows < 0 || smem != layout(W, K, V1, NC, levels, lm_rows).total)
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
  p.stats = (long long*)stats;
  p.B = B;
  p.T = T;
  p.V1 = V1;
  p.K = K;
  p.W = W;
  p.NC = NC;
  p.blank = blank;
  p.space = space;
  p.levels = levels;
  p.probes = levels > 0 ? probes : 1;
  p.lm_rows = levels > 0 ? lm_rows : 0;
  p.alpha = alpha;
  p.beta = beta;
  cudaError_t err = cudaFuncSetAttribute(
      beam_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  beam_kernel<<<B, block_threads(W, K, levels), smem,
                (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
