// CTC prefix beam search with n-gram LM shallow fusion — the host tier's
// native hot path (the port's own copy of vietasr_tpu/native/ctc_beam.cc,
// the same code).
//
// Replaces the reference's KenLM (C++) + pyctcdecode stack (its
// beam_search_decoder.py:82-102): an ARPA backoff LM loaded into a flat
// n-gram hash table plus the same prefix beam search as
// vietasr_tpu_torch/ops/beam_search.py (the Python tier, kept beside it).
//
// Built by vietasr_tpu_torch/native/__init__.py at first use:
//   g++ -O3 -std=c++17 -shared -fPIC ctc_beam.cc -o _build/ctcbeam-<hash>.so
// and called through ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <limits>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr float kNegInf = -std::numeric_limits<float>::infinity();
constexpr double kLog10 = 2.302585092994046;

inline float logsumexp2(float a, float b) {
  if (a == kNegInf) return b;
  if (b == kNegInf) return a;
  float m = a > b ? a : b;
  return m + std::log(std::exp(a - m) + std::exp(b - m));
}

// ---------------------------------------------------------------------------
// ARPA n-gram LM

struct NgramKey {
  std::vector<uint32_t> ids;
  bool operator==(const NgramKey& o) const { return ids == o.ids; }
};

struct NgramKeyHash {
  size_t operator()(const NgramKey& k) const {
    uint64_t h = 1469598103934665603ull;  // FNV-1a over ids
    for (uint32_t id : k.ids) {
      h ^= id;
      h *= 1099511628211ull;
    }
    return static_cast<size_t>(h);
  }
};

struct ArpaLM {
  std::unordered_map<std::string, uint32_t> word_ids;
  std::unordered_map<NgramKey, std::pair<float, float>, NgramKeyHash> ngrams;
  int order = 0;
  uint32_t unk_id = UINT32_MAX;
  uint32_t bos_id = UINT32_MAX;

  uint32_t intern(const std::string& w) {
    auto it = word_ids.find(w);
    if (it != word_ids.end()) return it->second;
    uint32_t id = static_cast<uint32_t>(word_ids.size());
    word_ids.emplace(w, id);
    return id;
  }

  uint32_t lookup(const std::string& w) const {
    auto it = word_ids.find(w);
    return it == word_ids.end() ? unk_id : it->second;
  }

  bool load(const std::string& path) {
    std::ifstream f(path);
    if (!f) return false;
    std::string line;
    int section = 0;
    while (std::getline(f, line)) {
      // trim
      while (!line.empty() && (line.back() == '\r' || line.back() == '\n' ||
                               line.back() == ' '))
        line.pop_back();
      if (line.empty()) continue;
      if (line[0] == '\\') {
        if (line == "\\end\\") break;
        auto pos = line.find("-grams:");
        if (pos != std::string::npos) {
          section = std::stoi(line.substr(1, pos - 1));
          if (section > order) order = section;
        }
        continue;
      }
      if (section == 0) continue;
      std::istringstream ss(line);
      float logp;
      if (!(ss >> logp)) continue;
      NgramKey key;
      key.ids.reserve(section);
      std::string w;
      for (int i = 0; i < section; ++i) {
        if (!(ss >> w)) break;
        key.ids.push_back(intern(w));
      }
      if (static_cast<int>(key.ids.size()) != section) continue;
      float backoff = 0.0f;
      ss >> backoff;
      ngrams[key] = {static_cast<float>(logp * kLog10),
                     static_cast<float>(backoff * kLog10)};
    }
    auto u = word_ids.find("<unk>");
    unk_id = u == word_ids.end() ? UINT32_MAX : u->second;
    auto b = word_ids.find("<s>");
    bos_id = b == word_ids.end() ? UINT32_MAX : b->second;
    return true;
  }

  // natural-log p(ids.back() | ids[:-1]) with backoff
  float score(const uint32_t* ids, int n) const {
    NgramKey key;
    key.ids.assign(ids, ids + n);
    auto it = ngrams.find(key);
    if (it != ngrams.end()) return it->second.first;
    if (n == 1) {
      if (unk_id != UINT32_MAX) {
        NgramKey uk;
        uk.ids.push_back(unk_id);
        auto iu = ngrams.find(uk);
        if (iu != ngrams.end()) return iu->second.first;
      }
      return -5e29f;
    }
    NgramKey ctx;
    ctx.ids.assign(ids, ids + n - 1);
    auto ic = ngrams.find(ctx);
    float bo = ic != ngrams.end() ? ic->second.second : 0.0f;
    return bo + score(ids + 1, n - 1);
  }

  // p(word | up to order-1 context words)
  float word_logp(uint32_t word, const std::vector<uint32_t>& context) const {
    std::vector<uint32_t> ids;
    int ctx_take = order - 1;
    int start = std::max(0, static_cast<int>(context.size()) - ctx_take);
    ids.assign(context.begin() + start, context.end());
    ids.push_back(word);
    return score(ids.data(), static_cast<int>(ids.size()));
  }
};

// ---------------------------------------------------------------------------
// prefix beam search (mirrors vietasr_tpu_torch/ops/beam_search.py)

struct Beam {
  std::string text;                  // completed words joined by ' '
  std::string partial;               // current partial word
  std::vector<uint32_t> word_ctx;    // lm ids of completed words
  int last_char = -1;
  float p_b = 0.0f;
  float p_nb = kNegInf;
  float lm_score = 0.0f;

  float total() const { return logsumexp2(p_b, p_nb) + lm_score; }
};

struct BeamKeyHash {
  size_t operator()(const std::string& k) const {
    return std::hash<std::string>()(k);
  }
};

std::string beam_key(const Beam& b) {
  std::string k = b.text;
  k.push_back('\x01');
  k += b.partial;
  k.push_back('\x01');
  k += std::to_string(b.last_char);
  return k;
}

struct Decoder {
  const ArpaLM* lm;
  float alpha, beta;

  float word_bonus(const Beam& b) const {
    if (!lm || b.partial.empty()) return 0.0f;
    return alpha * lm->word_logp(lm->lookup(b.partial), b.word_ctx) + beta;
  }
};

std::string decode(const float* logp, int t_max, int v,
                   const std::vector<std::string>& labels, const ArpaLM* lm,
                   float alpha, float beta, int beam_width,
                   float token_min_logp, int space_id, int cutoff_top_n,
                   float beam_prune_logp) {
  Decoder dec{lm, alpha, beta};
  std::unordered_map<std::string, Beam> beams;
  beams.emplace(beam_key(Beam{}), Beam{});
  const int blank = v - 1;

  std::unordered_map<std::string, Beam> next;
  std::vector<const Beam*> ranked;
  std::vector<int> cand;
  std::vector<int> order_idx(v);
  for (int t = 0; t < t_max; ++t) {
    const float* lp = logp + static_cast<size_t>(t) * v;
    next.clear();

    // token pruning: top cutoff_top_n by log-prob AND >= token_min_logp
    cand.clear();
    if (cutoff_top_n > 0 && cutoff_top_n < v) {
      for (int i = 0; i < v; ++i) order_idx[i] = i;
      std::nth_element(order_idx.begin(), order_idx.begin() + cutoff_top_n,
                       order_idx.end(),
                       [&](int a, int b) { return lp[a] > lp[b]; });
      for (int i = 0; i < cutoff_top_n; ++i) {
        int c = order_idx[i];
        if (lp[c] >= token_min_logp || c == blank) cand.push_back(c);
      }
      bool has_blank = false;
      for (int c : cand) has_blank |= (c == blank);
      if (!has_blank) cand.push_back(blank);
    } else {
      for (int c = 0; c < v; ++c)
        if (lp[c] >= token_min_logp || c == blank) cand.push_back(c);
    }

    auto bump = [&](Beam&& proto, float add_b, float add_nb) {
      std::string key = beam_key(proto);
      auto it = next.find(key);
      if (it == next.end()) {
        proto.p_b = add_b;
        proto.p_nb = add_nb;
        next.emplace(std::move(key), std::move(proto));
      } else {
        it->second.p_b = logsumexp2(it->second.p_b, add_b);
        it->second.p_nb = logsumexp2(it->second.p_nb, add_nb);
      }
    };

    auto extend = [&](const Beam& b, int c) -> Beam {
      Beam nb;
      nb.last_char = c;
      nb.lm_score = b.lm_score;
      if (c == space_id) {
        nb.text = b.text;
        nb.word_ctx = b.word_ctx;
        if (!b.partial.empty()) {
          nb.lm_score += dec.word_bonus(b);
          if (!nb.text.empty()) nb.text.push_back(' ');
          nb.text += b.partial;
          if (lm) nb.word_ctx.push_back(lm->lookup(b.partial));
        }
      } else {
        nb.text = b.text;
        nb.word_ctx = b.word_ctx;
        nb.partial = b.partial + labels[c];
      }
      return nb;
    };

    for (const auto& kv : beams) {
      const Beam& b = kv.second;
      float p_tot = logsumexp2(b.p_b, b.p_nb);
      for (int c : cand) {
        float pc = lp[c];
        if (c == blank) {
          Beam same = b;
          bump(std::move(same), p_tot + pc, kNegInf);
        } else if (c == b.last_char) {
          Beam same = b;
          bump(std::move(same), kNegInf, b.p_nb + pc);
          if (b.p_b != kNegInf)
            bump(extend(b, c), kNegInf, b.p_b + pc);
        } else {
          bump(extend(b, c), kNegInf, p_tot + pc);
        }
      }
    }

    // top-K by total score, plus relative pruning vs the best beam
    ranked.clear();
    ranked.reserve(next.size());
    for (const auto& kv : next) ranked.push_back(&kv.second);
    if (static_cast<int>(ranked.size()) > beam_width) {
      std::nth_element(ranked.begin(), ranked.begin() + beam_width,
                       ranked.end(), [](const Beam* a, const Beam* b) {
                         return a->total() > b->total();
                       });
      ranked.resize(beam_width);
    }
    float best_total = kNegInf;
    for (const Beam* b : ranked) best_total = std::max(best_total, b->total());
    std::unordered_map<std::string, Beam> kept;
    kept.reserve(ranked.size());
    for (const Beam* b : ranked)
      if (b->total() >= best_total + beam_prune_logp)
        kept.emplace(beam_key(*b), *b);
    beams.swap(kept);
  }

  const Beam* best = nullptr;
  float best_score = kNegInf;
  for (const auto& kv : beams) {
    const Beam& b = kv.second;
    float s = logsumexp2(b.p_b, b.p_nb) + b.lm_score + dec.word_bonus(b);
    if (s > best_score) {
      best_score = s;
      best = &b;
    }
  }
  if (!best) return "";
  std::string out = best->text;
  if (!best->partial.empty()) {
    if (!out.empty()) out.push_back(' ');
    out += best->partial;
  }
  return out;
}

}  // namespace

extern "C" {

void* vba_lm_load(const char* path) {
  auto* lm = new ArpaLM();
  if (!lm->load(path)) {
    delete lm;
    return nullptr;
  }
  return lm;
}

void vba_lm_free(void* lm) { delete static_cast<ArpaLM*>(lm); }

int vba_lm_order(void* lm) { return static_cast<ArpaLM*>(lm)->order; }

// natural-log p(word | context words), context space-separated
float vba_lm_logp(void* lm_ptr, const char* word, const char* context) {
  auto* lm = static_cast<ArpaLM*>(lm_ptr);
  std::vector<uint32_t> ctx;
  std::istringstream ss(context);
  std::string w;
  while (ss >> w) ctx.push_back(lm->lookup(w));
  return lm->word_logp(lm->lookup(word), ctx);
}

// log_probs: (t, v) row-major, labels v-1 strings (blank = last column).
// Returns bytes written (excluding NUL), or -1 on overflow.
int vba_beam_decode(const float* logp, int t, int v,
                    const char* const* labels, int n_labels, void* lm_ptr,
                    float alpha, float beta, int beam_width,
                    float token_min_logp, int cutoff_top_n,
                    float beam_prune_logp, char* out, int out_cap) {
  std::vector<std::string> lab(labels, labels + n_labels);
  int space_id = -1;
  for (int i = 0; i < n_labels; ++i)
    if (lab[i] == " ") space_id = i;
  std::string text =
      decode(logp, t, v, lab, static_cast<ArpaLM*>(lm_ptr), alpha, beta,
             beam_width, token_min_logp, space_id, cutoff_top_n,
             beam_prune_logp);
  if (static_cast<int>(text.size()) + 1 > out_cap) return -1;
  std::memcpy(out, text.c_str(), text.size() + 1);
  return static_cast<int>(text.size());
}

}  // extern "C"
