// n-gram language model: ARPA builder (interpolated modified Kneser-Ney) and
// backoff scorer with a C ABI for ctypes.
//
// Native replacement for the reference's external KenLM dependency
// (reference: create_lm.py:60 shells out to kenlm lmplz; processing/lm.py:17
// queries it through pyctcdecode). The builder reproduces lmplz's estimation
// (Chen & Goodman interpolated MKN with continuation counts for lower orders);
// the scorer implements standard ARPA backoff queries with an incremental
// state API sized for the beam-search inner loop.
//
// A copy of native/ngram_lm.cpp, linked with beam_search.cpp into one
// library at first use by conformer_tpu_torch/native/__init__.py::load
// (into build/); a command-line builder:
// g++ -O2 -std=c++17 -DNGRAM_MAIN ngram_lm.cpp -o ngram_build

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <iostream>
#include <memory>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kMaxOrder = 8;
constexpr double kLog10Min = -99.0;

using WordId = int32_t;

// Key for an n-gram: raw bytes of its word ids.
static inline std::string key_of(const WordId* ids, int n) {
  return std::string(reinterpret_cast<const char*>(ids), n * sizeof(WordId));
}

struct Vocab {
  std::unordered_map<std::string, WordId> to_id;
  std::vector<std::string> to_word;

  WordId add(const std::string& w) {
    auto it = to_id.find(w);
    if (it != to_id.end()) return it->second;
    WordId id = static_cast<WordId>(to_word.size());
    to_id.emplace(w, id);
    to_word.push_back(w);
    return id;
  }
  WordId find(const std::string& w) const {
    auto it = to_id.find(w);
    return it == to_id.end() ? -1 : it->second;
  }
};

// ---------------------------------------------------------------------------
// Builder: corpus -> interpolated modified Kneser-Ney ARPA.
// ---------------------------------------------------------------------------

struct Builder {
  int order;
  Vocab vocab;
  WordId bos, eos, unk;
  // counts[k]: (k+1)-gram -> count (adjusted counts for k+1 < order).
  std::vector<std::unordered_map<std::string, int64_t>> counts;

  explicit Builder(int order_) : order(order_), counts(order_) {
    unk = vocab.add("<unk>");
    bos = vocab.add("<s>");
    eos = vocab.add("</s>");
  }

  void add_line(const std::string& line) {
    std::vector<WordId> ids;
    ids.push_back(bos);
    std::istringstream ss(line);
    std::string tok;
    while (ss >> tok) ids.push_back(vocab.add(tok));
    if (ids.size() == 1) return;  // empty line
    ids.push_back(eos);
    // Raw counts at the highest order; also raw counts at lower orders for
    // n-grams that BEGIN with <s> (no preceding context exists for them).
    const int n = static_cast<int>(ids.size());
    for (int k = 1; k <= order; ++k) {
      for (int i = 0; i + k <= n; ++i) {
        if (ids[i] == bos && i > 0) continue;  // <s> only sentence-initial
        if (k == order || ids[i] == bos) {
          counts[k - 1][key_of(&ids[i], k)] += 1;
        }
      }
    }
  }

  // After all lines: derive continuation (adjusted) counts for lower orders:
  // c'(w_2..w_k) = |{w_1 : c(w_1..w_k) > 0}| — number of distinct left
  // extensions, computed from the (k+1)-gram count table.
  void finish_counts() {
    for (int k = order - 1; k >= 1; --k) {
      auto& lower = counts[k - 1];
      for (const auto& [key, cnt] : counts[k]) {
        (void)cnt;
        const WordId* ids = reinterpret_cast<const WordId*>(key.data());
        if (ids[1] == bos) continue;  // suffix starting with <s>: impossible
        // each distinct (k+1)-gram contributes 1 continuation count
        lower[key_of(ids + 1, k)] += 1;
      }
      // n-grams starting with <s> kept their raw counts from add_line.
    }
  }

  struct ProbEntry {
    double logp = kLog10Min;
    double backoff = 0.0;  // log10
    bool has_backoff = false;
  };

  // Estimation + ARPA write.
  void write_arpa(const std::string& path) {
    finish_counts();

    // Discounts per order from counts-of-counts of the (possibly adjusted)
    // counts: D1 = 1 - 2Y t2/t1, D2 = 2 - 3Y t3/t2, D3 = 3 - 4Y t4/t3,
    // Y = t1/(t1 + 2 t2).
    std::vector<std::array<double, 4>> D(order);  // D[k][c] for c=1,2,3+ (idx 1..3)
    for (int k = 0; k < order; ++k) {
      int64_t t[5] = {0, 0, 0, 0, 0};
      for (const auto& [key, cnt] : counts[k]) {
        (void)key;
        if (cnt >= 1 && cnt <= 4) t[cnt] += 1;
      }
      double Y = (t[1] + 2.0 * t[2]) > 0 ? t[1] / (t[1] + 2.0 * t[2]) : 0.5;
      auto disc = [&](int i) -> double {
        if (t[i] == 0 || t[i + 1] < 0) return i - 1 < 0 ? 0.0 : 0.5 * i;
        double d = i - (i + 1) * Y * (double)t[i + 1] / (double)t[i];
        if (d < 0 || !std::isfinite(d)) d = 0.5 * i;  // lmplz fallback-ish
        if (d > i) d = 0.5 * i;
        return d;
      };
      D[k] = {0.0, disc(1), disc(2), disc(3)};
    }

    // Context sums and continuation type counts N1/N2/N3+ per context.
    // prob tables per order.
    std::vector<std::unordered_map<std::string, ProbEntry>> table(order);

    // interpolated probabilities, bottom-up.
    // Unigrams: u(w) = c'(w) - D over total; gamma distributes to uniform.
    {
      auto& uni = counts[0];
      // ensure <unk> exists with zero count
      uni.emplace(key_of(&unk, 1), 0);
      // <s> gets prob -99 by convention (never predicted).
      int64_t total = 0;
      for (const auto& [key, cnt] : uni) {
        const WordId* ids = reinterpret_cast<const WordId*>(key.data());
        if (ids[0] == bos) continue;
        total += cnt;
      }
      double gamma_mass = 0.0;
      size_t vocab_size = 0;
      for (const auto& [key, cnt] : uni) {
        const WordId* ids = reinterpret_cast<const WordId*>(key.data());
        if (ids[0] == bos) continue;
        ++vocab_size;
        double d = cnt >= 3 ? D[0][3] : D[0][cnt];
        if (cnt > 0) gamma_mass += d;
      }
      for (auto& [key, cnt] : uni) {
        const WordId* ids = reinterpret_cast<const WordId*>(key.data());
        ProbEntry e;
        if (ids[0] == bos) {
          e.logp = kLog10Min;
        } else {
          double d = cnt >= 3 ? D[0][3] : D[0][cnt];
          double u = total > 0 ? std::max(0.0, (double)cnt - d) / total : 0.0;
          double p = u + (total > 0 ? gamma_mass / total : 1.0) / vocab_size;
          e.logp = std::log10(std::max(p, 1e-99));
        }
        table[0].emplace(key, e);
      }
    }

    // Higher orders.
    for (int k = 1; k < order; ++k) {
      // context sums + type counts
      std::unordered_map<std::string, int64_t> ctx_sum;
      std::unordered_map<std::string, std::array<int64_t, 4>> ctx_types;
      for (const auto& [key, cnt] : counts[k]) {
        const WordId* ids = reinterpret_cast<const WordId*>(key.data());
        std::string ctx = key_of(ids, k);
        ctx_sum[ctx] += cnt;
        auto& ty = ctx_types[ctx];
        int bucket = cnt >= 3 ? 3 : static_cast<int>(cnt);
        if (bucket >= 1) ty[bucket] += 1;
      }
      for (const auto& [key, cnt] : counts[k]) {
        const WordId* ids = reinterpret_cast<const WordId*>(key.data());
        std::string ctx = key_of(ids, k);
        int64_t csum = ctx_sum[ctx];
        if (csum <= 0) continue;
        double d = cnt >= 3 ? D[k][3] : D[k][cnt];
        double u = std::max(0.0, (double)cnt - d) / csum;
        const auto& ty = ctx_types[ctx];
        double gamma =
            (D[k][1] * ty[1] + D[k][2] * ty[2] + D[k][3] * ty[3]) / csum;
        // lower-order interpolated prob of (ids+1, k) -> last k words
        double lower_p;
        {
          auto it = table[k - 1].find(key_of(ids + 1, k));
          lower_p = it != table[k - 1].end() ? std::pow(10.0, it->second.logp)
                                             : 1e-99;
        }
        double p = u + gamma * lower_p;
        ProbEntry e;
        e.logp = std::log10(std::max(p, 1e-99));
        table[k].emplace(key, e);
      }
      // Backoff weights live on the CONTEXT entry one order lower.
      for (const auto& [ctx, csum] : ctx_sum) {
        if (csum <= 0) continue;
        const auto& ty = ctx_types[ctx];
        double gamma =
            (D[k][1] * ty[1] + D[k][2] * ty[2] + D[k][3] * ty[3]) / csum;
        auto it = table[k - 1].find(ctx);
        if (it != table[k - 1].end()) {
          it->second.backoff = std::log10(std::max(gamma, 1e-99));
          it->second.has_backoff = true;
        } else if (ctx.size() == sizeof(WordId) &&
                   *reinterpret_cast<const WordId*>(ctx.data()) == bos) {
          // <s> unigram exists with logp -99; set its backoff.
          auto it2 = table[0].find(ctx);
          if (it2 != table[0].end()) {
            it2->second.backoff = std::log10(std::max(gamma, 1e-99));
            it2->second.has_backoff = true;
          }
        }
      }
    }

    // Write ARPA.
    std::ofstream out(path);
    out.precision(7);
    out << "\\data\\\n";
    for (int k = 0; k < order; ++k)
      out << "ngram " << (k + 1) << "=" << table[k].size() << "\n";
    out << "\n";
    for (int k = 0; k < order; ++k) {
      out << "\\" << (k + 1) << "-grams:\n";
      for (const auto& [key, e] : table[k]) {
        const WordId* ids = reinterpret_cast<const WordId*>(key.data());
        out << e.logp;
        for (int i = 0; i <= k; ++i) out << (i ? " " : "\t") << vocab.to_word[ids[i]];
        if (k + 1 < order && e.has_backoff) out << "\t" << e.backoff;
        out << "\n";
      }
      out << "\n";
    }
    out << "\\end\\\n";
  }
};

// ---------------------------------------------------------------------------
// Scorer: ARPA -> backoff queries with incremental state.
// ---------------------------------------------------------------------------

struct Scorer {
  int order = 0;
  Vocab vocab;
  WordId bos = -1, eos = -1, unk = -1;
  struct Entry {
    float logp;
    float backoff;
  };
  std::vector<std::unordered_map<std::string, Entry>> table;

  bool load(const std::string& path) {
    std::ifstream in(path);
    if (!in) return false;
    std::string line;
    // \data\ header
    std::vector<size_t> sizes;
    while (std::getline(in, line)) {
      if (line.rfind("ngram ", 0) == 0) {
        sizes.push_back(std::stoul(line.substr(line.find('=') + 1)));
      } else if (line.rfind("\\1-grams:", 0) == 0) {
        break;
      }
    }
    order = static_cast<int>(sizes.size());
    if (order == 0 || order > kMaxOrder) return false;
    table.assign(order, {});
    for (int k = 0; k < order; ++k) table[k].reserve(sizes[k] * 2);

    int current = 1;
    while (std::getline(in, line)) {
      if (line.empty()) continue;
      if (line[0] == '\\') {
        if (line == "\\end\\") break;
        size_t dash = line.find("-grams:");
        if (dash != std::string::npos) current = std::stoi(line.substr(1, dash - 1));
        continue;
      }
      // logp \t w1 w2 ... \t backoff?
      std::istringstream ss(line);
      double logp;
      ss >> logp;
      WordId ids[kMaxOrder];
      std::string w;
      for (int i = 0; i < current; ++i) {
        ss >> w;
        ids[i] = vocab.add(w);
      }
      double backoff = 0.0;
      if (ss >> backoff) {
      }
      Entry e{static_cast<float>(logp), static_cast<float>(backoff)};
      table[current - 1].emplace(key_of(ids, current), e);
    }
    bos = vocab.find("<s>");
    eos = vocab.find("</s>");
    unk = vocab.find("<unk>");
    return true;
  }

  // log10 P(word | context), standard backoff.
  float score(const WordId* ctx, int ctx_len, WordId word) const {
    if (word < 0) word = unk;
    if (ctx_len > order - 1) {
      ctx += ctx_len - (order - 1);
      ctx_len = order - 1;
    }
    float backoff_sum = 0.0f;
    for (int use = ctx_len; use >= 0; --use) {
      WordId ids[kMaxOrder];
      for (int i = 0; i < use; ++i) ids[i] = ctx[ctx_len - use + i];
      ids[use] = word;
      auto it = table[use].find(key_of(ids, use + 1));
      if (it != table[use].end()) return backoff_sum + it->second.logp;
      // accumulate backoff of the context we failed to match
      if (use >= 1) {
        auto bit = table[use - 1].find(key_of(ids, use));
        if (bit != table[use - 1].end()) backoff_sum += bit->second.backoff;
      }
    }
    // total OOV (no <unk> in table): harsh penalty
    return backoff_sum + (unk >= 0 ? table[0].at(key_of(&unk, 1)).logp
                                   : (float)kLog10Min);
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void* lm_load(const char* arpa_path) {
  auto* s = new Scorer();
  if (!s->load(arpa_path)) {
    delete s;
    return nullptr;
  }
  return s;
}

void lm_free(void* lm) { delete static_cast<Scorer*>(lm); }

int lm_order(void* lm) { return static_cast<Scorer*>(lm)->order; }

int lm_vocab_id(void* lm, const char* word) {
  return static_cast<Scorer*>(lm)->vocab.find(word);
}

int lm_bos(void* lm) { return static_cast<Scorer*>(lm)->bos; }
int lm_eos(void* lm) { return static_cast<Scorer*>(lm)->eos; }
int lm_unk(void* lm) { return static_cast<Scorer*>(lm)->unk; }

float lm_score(void* lm, const int32_t* context, int ctx_len, int32_t word) {
  return static_cast<Scorer*>(lm)->score(context, ctx_len, word);
}

// Batch scoring of one word against many contexts (beam loop hot path).
void lm_score_batch(void* lm, const int32_t* contexts, const int32_t* ctx_lens,
                    const int32_t* words, int n, int ctx_stride, float* out) {
  auto* s = static_cast<Scorer*>(lm);
  for (int i = 0; i < n; ++i)
    out[i] = s->score(contexts + i * ctx_stride, ctx_lens[i], words[i]);
}

// Builder: corpus file -> ARPA file. Returns 0 on success.
int lm_build_arpa(const char* text_path, const char* arpa_path, int order) {
  if (order < 1 || order > kMaxOrder) return 1;
  std::ifstream in(text_path);
  if (!in) return 2;
  Builder b(order);
  std::string line;
  while (std::getline(in, line)) b.add_line(line);
  b.write_arpa(arpa_path);
  return 0;
}

}  // extern "C"

#ifdef NGRAM_MAIN
int main(int argc, char** argv) {
  int order = 5;
  std::string text, arpa;
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    if (a == "-o" && i + 1 < argc) order = std::atoi(argv[++i]);
    else if (a == "--text" && i + 1 < argc) text = argv[++i];
    else if (a == "--arpa" && i + 1 < argc) arpa = argv[++i];
  }
  if (text.empty() || arpa.empty()) {
    std::cerr << "usage: ngram_build -o N --text corpus.txt --arpa out.arpa\n";
    return 1;
  }
  int rc = lm_build_arpa(text.c_str(), arpa.c_str(), order);
  if (rc) std::cerr << "build failed rc=" << rc << "\n";
  return rc;
}
#endif
