// CTC prefix beam search with n-gram LM shallow fusion — native inner loop.
//
// A copy of native/beam_search.cpp. Exact C++ version of the Python decoder
// (conformer_tpu_torch/decode/beam_search.py::BeamSearchDecoder.decode_py): the Python
// implementation is the behavioral spec (itself matching the reference's
// pyctcdecode operating point, reference: processing/lm.py:10-15), and a fuzz
// test asserts transcript equality between the two. This exists because the
// reference's eval wall-clock is dominated by the Python per-frame *
// per-beam loop at width 190 (reference: test.py:149, lm.py:69-71); the same
// loop in C++ with a threaded batch API is an order of magnitude faster.
//
// Linked with ngram_lm.cpp into one library at first use by
// conformer_tpu_torch/native/__init__.py::load (into build/); the LM is the
// in-repo ARPA scorer (thread-safe: Scorer::score is read-only).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

extern "C" {
// From ngram_lm.cpp (same shared object).
void* lm_load(const char* arpa_path);
void lm_free(void* lm);
int lm_order(void* lm);
int lm_vocab_id(void* lm, const char* word);
int lm_bos(void* lm);
float lm_score(void* lm, const int32_t* context, int ctx_len, int32_t word);
}

namespace {

const double kNegInf = -std::numeric_limits<double>::infinity();
const double kLog10ToLn = std::log(10.0);

inline double logsumexp2(double a, double b) {
  if (a == kNegInf) return b;
  if (b == kNegInf) return a;
  double m = a > b ? a : b;
  return m + std::log(std::exp(a - m) + std::exp(b - m));
}

struct Beam {
  int last_token = -1;
  double p_b = 0.0;
  double p_nb = kNegInf;
  std::string text;
  std::string partial;
  std::vector<int32_t> lm_ctx;
  double lm_score = 0.0;

  double total() const { return logsumexp2(p_b, p_nb) + lm_score; }
};

struct Decoder {
  std::vector<std::string> vocab;
  int blank = 0, unk = -1, delim = -1;
  double alpha = 0.0, beta = 0.0;
  int beam_width = 190;
  double prune_logp = -20.0, token_min_logp = -5.0;
  double hotword_weight = 0.0;
  std::unordered_set<std::string> hotwords;
  void* lm = nullptr;
  int max_ctx = 1;

  ~Decoder() {
    if (lm) lm_free(lm);
  }

  // LM + hotword contribution of completing `word` (beam_search.py:86-107).
  double word_bonus(const Beam& b, const std::string& word,
                    std::vector<int32_t>* new_ctx) const {
    double delta = 0.0;
    *new_ctx = b.lm_ctx;
    if (lm) {
      int wid = lm_vocab_id(lm, word.c_str());
      delta += alpha * kLog10ToLn *
               (double)lm_score(lm, b.lm_ctx.data(), (int)b.lm_ctx.size(), wid);
      delta += beta;
      new_ctx->push_back(wid);
      while ((int)new_ctx->size() > max_ctx)
        new_ctx->erase(new_ctx->begin());
    }
    if (!hotwords.empty()) {
      std::string joined = b.text.empty() ? word : b.text + " " + word;
      std::vector<std::string> tail;
      size_t start = 0;
      while (start < joined.size()) {
        size_t sp = joined.find(' ', start);
        if (sp == std::string::npos) sp = joined.size();
        if (sp > start) tail.emplace_back(joined.substr(start, sp - start));
        start = sp + 1;
      }
      int n = (int)tail.size();
      int max_span = std::min(n, 4);
      for (int span = 1; span <= max_span; ++span) {
        std::string phrase;
        for (int i = n - span; i < n; ++i) {
          if (!phrase.empty()) phrase += ' ';
          phrase += tail[i];
        }
        if (hotwords.count(phrase)) {
          delta += hotword_weight * kLog10ToLn;
          break;
        }
      }
    }
    return delta;
  }

  std::vector<Beam> start_state() const {
    std::vector<Beam> beams(1);
    if (lm) beams[0].lm_ctx.push_back(lm_bos(lm));
    return beams;
  }

  // Advance `beams` through t_max frames. Prefix beam search is
  // frame-sequential, so feeding frames in chunks through a persistent
  // state is EXACTLY offline decode of the concatenation — this is what
  // makes the streaming API (bs_stream_*) lossless at the search level.
  void step(std::vector<Beam>& beams, const float* lp, int t_max,
            int v) const {
    std::vector<Beam> next;           // insertion order (Python dict order)
    std::unordered_map<std::string, size_t> index;
    std::vector<int> cand;
    std::string key;

    auto merge = [&](Beam&& nb) {
      key.clear();
      key += nb.text;
      key += '\1';
      key += nb.partial;
      key += '\1';
      key += std::to_string(nb.last_token);
      auto it = index.find(key);
      if (it == index.end()) {
        index.emplace(key, next.size());
        next.emplace_back(std::move(nb));
      } else {
        Beam& old = next[it->second];
        old.p_b = logsumexp2(old.p_b, nb.p_b);
        old.p_nb = logsumexp2(old.p_nb, nb.p_nb);
      }
    };

    for (int t = 0; t < t_max; ++t) {
      const float* frame = lp + (size_t)t * v;
      cand.clear();
      for (int c = 0; c < v; ++c)
        if ((double)frame[c] >= token_min_logp) cand.push_back(c);
      if (cand.empty()) {
        int best = 0;
        for (int c = 1; c < v; ++c)
          if (frame[c] > frame[best]) best = c;
        cand.push_back(best);
      }
      next.clear();
      index.clear();

      for (const Beam& beam : beams) {
        double p_total = logsumexp2(beam.p_b, beam.p_nb);
        for (int c : cand) {
          double clp = (double)frame[c];
          if (c == blank) {
            Beam nb;
            nb.last_token = beam.last_token;
            nb.p_b = p_total + clp;
            nb.p_nb = kNegInf;
            nb.text = beam.text;
            nb.partial = beam.partial;
            nb.lm_ctx = beam.lm_ctx;
            nb.lm_score = beam.lm_score;
            merge(std::move(nb));
            continue;
          }
          if (c == unk) continue;  // reference drops <UNK> (processor.py:309)
          double base;
          if (c == beam.last_token) {
            Beam rb;  // same prefix, repeat collapses
            rb.last_token = c;
            rb.p_b = kNegInf;
            rb.p_nb = beam.p_nb + clp;
            rb.text = beam.text;
            rb.partial = beam.partial;
            rb.lm_ctx = beam.lm_ctx;
            rb.lm_score = beam.lm_score;
            merge(std::move(rb));
            base = beam.p_b;  // extension only after a blank
          } else {
            base = p_total;
          }
          if (base == kNegInf) continue;
          if (c == delim) {
            Beam nb;
            nb.last_token = c;
            nb.p_b = kNegInf;
            nb.p_nb = base + clp;
            if (!beam.partial.empty()) {
              double delta = word_bonus(beam, beam.partial, &nb.lm_ctx);
              nb.text = beam.text.empty() ? beam.partial
                                          : beam.text + " " + beam.partial;
              nb.partial.clear();
              nb.lm_score = beam.lm_score + delta;
            } else {
              nb.text = beam.text;
              nb.partial.clear();
              nb.lm_ctx = beam.lm_ctx;
              nb.lm_score = beam.lm_score;
            }
            merge(std::move(nb));
          } else {
            Beam nb;
            nb.last_token = c;
            nb.p_b = kNegInf;
            nb.p_nb = base + clp;
            nb.text = beam.text;
            nb.partial = beam.partial + vocab[c];
            nb.lm_ctx = beam.lm_ctx;
            nb.lm_score = beam.lm_score;
            merge(std::move(nb));
          }
        }
      }

      // Stable sort by total desc == Python's stable sorted() over dict
      // insertion order, then width + score-floor pruning. Totals are
      // cached once (the comparator would otherwise logsumexp O(N log N)
      // times).
      std::vector<double> totals(next.size());
      for (size_t i = 0; i < next.size(); ++i) totals[i] = next[i].total();
      std::vector<size_t> order(next.size());
      for (size_t i = 0; i < order.size(); ++i) order[i] = i;
      std::stable_sort(order.begin(), order.end(), [&](size_t a, size_t b) {
        return totals[a] > totals[b];
      });
      double best = next.empty() ? 0.0 : totals[order[0]];
      double floor = best + prune_logp;
      beams.clear();
      for (size_t i = 0; i < order.size() && (int)i < beam_width; ++i) {
        if (totals[order[i]] >= floor)
          beams.push_back(std::move(next[order[i]]));
      }
      if (beams.empty() && !next.empty())
        beams.push_back(std::move(next[order[0]]));
    }
  }

  // finalize: score trailing partial word (beam_search.py:199-210).
  // Read-only — a streaming caller can snapshot the current hypothesis
  // mid-utterance and keep feeding frames afterwards.
  std::string best_text(const std::vector<Beam>& beams) const {
    double best_score = kNegInf;
    std::string best_text;
    bool first = true;
    for (const Beam& beam : beams) {
      double score = logsumexp2(beam.p_b, beam.p_nb) + beam.lm_score;
      std::string text = beam.text;
      if (!beam.partial.empty()) {
        std::vector<int32_t> scratch;
        score += word_bonus(beam, beam.partial, &scratch);
        text = text.empty() ? beam.partial : text + " " + beam.partial;
      }
      if (first || score > best_score) {  // stable: strict > keeps first
        best_score = score;
        best_text = text;
        first = false;
      }
    }
    return best_text;
  }

  std::string decode(const float* lp, int t_max, int v) const {
    std::vector<Beam> beams = start_state();
    step(beams, lp, t_max, v);
    return best_text(beams);
  }
};

}  // namespace

extern "C" {

void* bs_create(const char* arpa_path, const char** vocab, int n_vocab,
                int blank_id, int unk_id, int delim_id, double alpha,
                double beta, int beam_width, double prune_logp,
                double token_min_logp, const char** hotwords, int n_hotwords,
                double hotword_weight) {
  auto* d = new Decoder();
  d->vocab.reserve(n_vocab);
  for (int i = 0; i < n_vocab; ++i) d->vocab.emplace_back(vocab[i]);
  d->blank = blank_id;
  d->unk = unk_id;
  d->delim = delim_id;
  d->alpha = alpha;
  d->beta = beta;
  d->beam_width = beam_width;
  d->prune_logp = prune_logp;
  d->token_min_logp = token_min_logp;
  d->hotword_weight = hotword_weight;
  for (int i = 0; i < n_hotwords; ++i) d->hotwords.emplace(hotwords[i]);
  if (arpa_path && arpa_path[0]) {
    d->lm = lm_load(arpa_path);
    if (!d->lm) {
      delete d;
      return nullptr;
    }
    d->max_ctx = std::max(lm_order(d->lm) - 1, 1);
  }
  return d;
}

void bs_free(void* h) { delete static_cast<Decoder*>(h); }

int bs_decode(void* h, const float* log_probs, int t, int v, char* out,
              int out_cap) {
  std::string text = static_cast<Decoder*>(h)->decode(log_probs, t, v);
  int n = std::min((int)text.size(), out_cap - 1);
  std::memcpy(out, text.data(), n);
  out[n] = '\0';
  return (int)text.size();
}

// Batch decode with a thread pool; out is (B, out_stride) char matrix.
void bs_decode_batch(void* h, const float* log_probs, const int32_t* lengths,
                     int b, int t, int v, char* out, int out_stride,
                     int n_threads) {
  auto* d = static_cast<Decoder*>(h);
  if (n_threads < 1) n_threads = 1;
  n_threads = std::min(n_threads, b);
  std::vector<std::thread> pool;
  std::atomic_int cursor{0};
  auto work = [&]() {
    for (;;) {
      int i = cursor.fetch_add(1);
      if (i >= b) return;
      int ti = lengths ? lengths[i] : t;
      std::string text =
          d->decode(log_probs + (size_t)i * t * v, std::min(ti, t), v);
      int n = std::min((int)text.size(), out_stride - 1);
      std::memcpy(out + (size_t)i * out_stride, text.data(), n);
      out[(size_t)i * out_stride + n] = '\0';
    }
  };
  for (int w = 0; w < n_threads; ++w) pool.emplace_back(work);
  for (auto& th : pool) th.join();
}

// ---------------------------------------------------------------------------
// Streaming API: a persistent beam state fed frames chunk by chunk.
// Feeding [A; B] via two bs_stream_feed calls is bit-identical to one
// bs_decode over the concatenation (the search is frame-sequential).
// bs_stream_text snapshots the current best hypothesis without disturbing
// the state, so it can be polled between chunks for live partial results.

void* bs_stream_new(void* h) {
  auto* d = static_cast<Decoder*>(h);
  return new std::vector<Beam>(d->start_state());
}

void bs_stream_feed(void* h, void* state, const float* log_probs, int t,
                    int v) {
  auto* d = static_cast<Decoder*>(h);
  d->step(*static_cast<std::vector<Beam>*>(state), log_probs, t, v);
}

int bs_stream_text(void* h, void* state, char* out, int out_cap) {
  auto* d = static_cast<Decoder*>(h);
  std::string text = d->best_text(*static_cast<std::vector<Beam>*>(state));
  int n = std::min((int)text.size(), out_cap - 1);
  std::memcpy(out, text.data(), n);
  out[n] = '\0';
  return (int)text.size();
}

void bs_stream_free(void* state) {
  delete static_cast<std::vector<Beam>*>(state);
}

}  // extern "C"
