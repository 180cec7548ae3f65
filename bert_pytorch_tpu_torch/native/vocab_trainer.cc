// Native vocabulary-trainer merge engine (WordPiece + byte-level BPE).
//
// The reference delegated vocab training to the HF tokenizers Rust trainers
// (utils/build_vocab.py:39-58); bert_pytorch_tpu_torch/pipeline/vocab.py is the
// in-framework behavioral spec (pure Python). This module is the fast path
// for the spec's hot loop — greedy pair-merge selection — and is held to
// BITWISE-IDENTICAL selection order:
//   - scores are computed with the exact double-precision expression shape
//     the Python engine uses (left-to-right log sums, one final multiply),
//   - pair tiebreaks compare UTF-8 bytes (UTF-8 byte order == code-point
//     order, which is Python's str comparison),
//   - the WordPiece "-len(merged)" tiebreak counts CODE POINTS, as Python
//     len() does.
// Unicode normalization / pre-tokenization stays in Python (count_words);
// the boundary passes symbol sequences, so this file needs no unicode
// tables. Parity is enforced by tests/test_vocab_trainer.py against the
// Python engine on identical inputs.
//
// C ABI (ctypes, no pybind11 in this environment):
//   vt_train(words_tsv, len, init_vocab, len, vocab_size, wordpiece_mode,
//            min_pair_frequency, &out, &out_len) -> 0/-1
//     words_tsv:  "freq\tsym sym sym...\n" per (deduplicated) word
//     init_vocab: "token\n" per initial vocab entry (specials + alphabet),
//                 in final order
//     out: wordpiece -> "V\ttoken\n" lines (merged tokens appended in
//          selection order); bpe -> "M\ta b\n" merge lines interleaved with
//          "V\ttoken\n" for tokens that entered the vocab. The caller
//          replays these onto its initial vocab.
//   vt_free(ptr)

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

using std::string;
using std::vector;

struct PairHash {
  size_t operator()(const std::pair<int, int>& p) const {
    return (static_cast<size_t>(p.first) << 32) ^
           static_cast<uint32_t>(p.second);
  }
};

// log(n) memo for integer arguments: counts/totals are exact ints and
// repeat heavily across the scan; the memo turns ~4 libm calls per
// candidate per iteration into table lookups. std::log(double) == libm log
// == what CPython's math.log calls, so memoization cannot change bits.
struct LogMemo {
  vector<double> small;  // n < 1<<20
  std::unordered_map<int64_t, double> big;
  LogMemo() : small(1 << 20, -1.0) {}
  double operator()(int64_t n) {
    if (n > 0 && n < (1 << 20)) {
      double& v = small[n];
      if (v < 0) v = std::log(static_cast<double>(n));
      return v;
    }
    auto it = big.find(n);
    if (it != big.end()) return it->second;
    double v = std::log(static_cast<double>(n));
    big.emplace(n, v);
    return v;
  }
};

int utf8_codepoints(const string& s) {
  int n = 0;
  for (unsigned char c : s)
    if ((c & 0xC0) != 0x80) n++;
  return n;
}

struct Engine {
  vector<string> sym_names;                       // id -> symbol text
  std::unordered_map<string, int> sym_ids;
  vector<vector<int>> words;                      // symbol ids per word
  vector<int64_t> freqs;
  std::unordered_map<std::pair<int, int>, int64_t, PairHash> pairs;
  std::unordered_map<std::pair<int, int>, std::unordered_set<int>, PairHash>
      index;
  vector<int64_t> singles;                        // per symbol id
  int64_t total_singles = 0;

  int intern(const string& s) {
    auto it = sym_ids.find(s);
    if (it != sym_ids.end()) return it->second;
    int id = static_cast<int>(sym_names.size());
    sym_names.push_back(s);
    sym_ids.emplace(s, id);
    singles.push_back(0);
    return id;
  }

  void add_word(int idx) {
    const auto& syms = words[idx];
    int64_t f = freqs[idx];
    for (int s : syms) {
      singles[s] += f;
      total_singles += f;
    }
    for (size_t i = 0; i + 1 < syms.size(); ++i) {
      auto p = std::make_pair(syms[i], syms[i + 1]);
      pairs[p] += f;
      index[p].insert(idx);
    }
  }

  void remove_word(int idx) {
    const auto& syms = words[idx];
    int64_t f = freqs[idx];
    for (int s : syms) {
      singles[s] -= f;
      total_singles -= f;
    }
    for (size_t i = 0; i + 1 < syms.size(); ++i) {
      auto p = std::make_pair(syms[i], syms[i + 1]);
      auto it = pairs.find(p);
      if (it != pairs.end()) {
        it->second -= f;
        if (it->second <= 0) {
          pairs.erase(it);
          index.erase(p);
        } else {
          auto ix = index.find(p);
          if (ix != index.end()) ix->second.erase(idx);
        }
      }
    }
  }

  void merge(std::pair<int, int> best, int merged_id) {
    auto ix = index.find(best);
    if (ix != index.end()) {
      // copy: remove_word/add_word mutate the index sets
      vector<int> touched(ix->second.begin(), ix->second.end());
      for (int idx : touched) {
        remove_word(idx);
        auto& syms = words[idx];
        vector<int> merged;
        merged.reserve(syms.size());
        size_t i = 0;
        while (i < syms.size()) {
          if (i + 1 < syms.size() && syms[i] == best.first &&
              syms[i + 1] == best.second) {
            merged.push_back(merged_id);
            i += 2;
          } else {
            merged.push_back(syms[i]);
            i += 1;
          }
        }
        syms = std::move(merged);
        add_word(idx);
      }
    }
    // self-overlap residue: the merged pair must never be selected again
    pairs.erase(best);
    index.erase(best);
  }
};

// Python-tuple-comparison tiebreak on (sym_a, sym_b) as strings: byte-wise
// compare == code-point compare for UTF-8. Returns true when p > q.
bool pair_greater(const Engine& e, std::pair<int, int> p,
                  std::pair<int, int> q) {
  int c = e.sym_names[p.first].compare(e.sym_names[q.first]);
  if (c != 0) return c > 0;
  return e.sym_names[p.second].compare(e.sym_names[q.second]) > 0;
}

string wp_merged_name(const Engine& e, std::pair<int, int> p) {
  const string& a = e.sym_names[p.first];
  const string& b = e.sym_names[p.second];
  if (b.size() >= 2 && b[0] == '#' && b[1] == '#') return a + b.substr(2);
  return a + b;
}

}  // namespace

extern "C" {

int vt_train(const char* words_tsv, size_t words_len, const char* init_vocab,
             size_t init_len, int vocab_size, int wordpiece_mode,
             long min_pair_frequency, char** out_buf, size_t* out_len) {
  Engine e;
  // parse words: "freq\tsym sym ...\n"
  {
    const char* p = words_tsv;
    const char* end = words_tsv + words_len;
    while (p < end) {
      const char* nl = static_cast<const char*>(
          memchr(p, '\n', static_cast<size_t>(end - p)));
      if (!nl) nl = end;
      const char* tab = static_cast<const char*>(
          memchr(p, '\t', static_cast<size_t>(nl - p)));
      if (tab) {
        int64_t f = strtoll(p, nullptr, 10);
        vector<int> syms;
        const char* s = tab + 1;
        while (s < nl) {
          const char* sp = static_cast<const char*>(
              memchr(s, ' ', static_cast<size_t>(nl - s)));
          if (!sp) sp = nl;
          if (sp > s)
            syms.push_back(
                e.intern(string(s, static_cast<size_t>(sp - s))));
          s = sp + 1;
        }
        if (!syms.empty() && f > 0) {
          int idx = static_cast<int>(e.words.size());
          e.words.push_back(std::move(syms));
          e.freqs.push_back(f);
          e.add_word(idx);
        }
      }
      p = nl + 1;
    }
  }

  // seen-set seeded with the caller's initial vocab (specials + alphabet)
  std::unordered_set<string> seen;
  int cur_vocab = 0;
  {
    const char* p = init_vocab;
    const char* end = init_vocab + init_len;
    while (p < end) {
      const char* nl = static_cast<const char*>(
          memchr(p, '\n', static_cast<size_t>(end - p)));
      if (!nl) nl = end;
      if (nl > p) {
        if (seen.insert(string(p, static_cast<size_t>(nl - p))).second)
          cur_vocab++;
      }
      p = nl + 1;
    }
  }

  LogMemo lg;
  string out;
  out.reserve(1 << 20);

  while (cur_vocab < vocab_size) {
    bool have = false;
    std::pair<int, int> best{0, 0};
    double best_score = 0.0;
    int64_t best_count = 0;
    int best_len = 0;
    if (wordpiece_mode) {
      double log_total = lg(e.total_singles);
      for (const auto& kv : e.pairs) {
        int64_t c = kv.second;
        if (c < min_pair_frequency) continue;
        // EXACT Python expression shape:
        // c * (log(c) + log(total) - log(sa) - log(sb))
        double score =
            static_cast<double>(c) *
            (((lg(c) + log_total) - lg(e.singles[kv.first.first])) -
             lg(e.singles[kv.first.second]));
        int mlen = 0;
        if (have) {
          if (score < best_score) continue;
          if (score == best_score) {
            // tiebreak: larger -len(merged) i.e. SHORTER merged wins;
            // then lexicographically greater pair
            mlen = utf8_codepoints(wp_merged_name(e, kv.first));
            if (mlen > best_len) continue;
            if (mlen == best_len && !pair_greater(e, kv.first, best))
              continue;
          }
        }
        if (mlen == 0) mlen = utf8_codepoints(wp_merged_name(e, kv.first));
        best = kv.first;
        best_score = score;
        best_len = mlen;
        have = true;
      }
    } else {
      for (const auto& kv : e.pairs) {
        int64_t c = kv.second;
        if (have) {
          if (c < best_count) continue;
          if (c == best_count && !pair_greater(e, kv.first, best)) continue;
        }
        best = kv.first;
        best_count = c;
        have = true;
      }
    }
    if (!have) break;

    string new_symbol = wordpiece_mode
                            ? wp_merged_name(e, best)
                            : e.sym_names[best.first] + e.sym_names[best.second];
    if (!wordpiece_mode) {
      out += "M\t";
      out += e.sym_names[best.first];
      out += ' ';
      out += e.sym_names[best.second];
      out += '\n';
    }
    int merged_id = e.intern(new_symbol);
    e.merge(best, merged_id);
    if (seen.insert(new_symbol).second) {
      out += "V\t";
      out += new_symbol;
      out += '\n';
      cur_vocab++;
    }
  }

  char* buf = static_cast<char*>(malloc(out.size() + 1));
  if (!buf) return -1;
  memcpy(buf, out.data(), out.size());
  buf[out.size()] = '\0';
  *out_buf = buf;
  *out_len = out.size();
  return 0;
}

void vt_free(void* p) { free(p); }

}  // extern "C"
