// Native byte-level BPE batch encoder — the C++ fast path behind
// bert_pytorch_tpu_torch.data.tokenization.get_bpe_tokenizer.
//
// Byte-identical to the Python spec (data/tokenization.py:
// ByteLevelBPETokenizer): same GPT-2 pre-tokenization scanner (contractions,
// unicode letter/number runs with optional leading space, whitespace runs),
// same bytes<->printable-unicode mapping, same lowest-rank-first merge loop.
// Character classes (isalpha/isnumeric/isspace) come from tables generated
// from the SAME Python unicodedata (gen_unicode_tables.py), so the two
// scanners agree by construction. The reference got byte-level BPE from the
// Rust `tokenizers` crate (reference src/tokenization.py:51-57,
// utils/build_vocab.py:39-58); this closes the last native-tokenizer gap.
//
// C ABI only (consumed via ctypes) — no pybind11 in this environment.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "unicode_tables.h"

namespace {

bool in_ranges(const CpRange* r, size_t n, uint32_t cp) {
  size_t lo = 0, hi = n;
  while (lo < hi) {
    size_t mid = (lo + hi) / 2;
    if (cp < r[mid].lo) {
      hi = mid;
    } else if (cp > r[mid].hi) {
      lo = mid + 1;
    } else {
      return true;
    }
  }
  return false;
}

const CpMapEntry* find_map(const CpMapEntry* m, size_t n, uint32_t cp) {
  size_t lo = 0, hi = n;
  while (lo < hi) {
    size_t mid = (lo + hi) / 2;
    if (cp < m[mid].cp) {
      hi = mid;
    } else if (cp > m[mid].cp) {
      lo = mid + 1;
    } else {
      return &m[mid];
    }
  }
  return nullptr;
}

inline bool is_alpha(uint32_t cp) { return in_ranges(kAlpha, kAlpha_len, cp); }
inline bool is_numeric(uint32_t cp) {
  return in_ranges(kNumeric, kNumeric_len, cp);
}
inline bool is_space(uint32_t cp) {
  return in_ranges(kPySpace, kPySpace_len, cp);
}

uint32_t next_cp(const char* s, size_t len, size_t& i) {
  unsigned char c = s[i];
  if (c < 0x80) {
    i += 1;
    return c;
  }
  if ((c >> 5) == 0x6 && i + 1 < len) {
    uint32_t cp = ((c & 0x1F) << 6) | (s[i + 1] & 0x3F);
    i += 2;
    return cp;
  }
  if ((c >> 4) == 0xE && i + 2 < len) {
    uint32_t cp = ((c & 0x0F) << 12) | ((s[i + 1] & 0x3F) << 6) |
                  (s[i + 2] & 0x3F);
    i += 3;
    return cp;
  }
  if ((c >> 3) == 0x1E && i + 3 < len) {
    uint32_t cp = ((c & 0x07) << 18) | ((s[i + 1] & 0x3F) << 12) |
                  ((s[i + 2] & 0x3F) << 6) | (s[i + 3] & 0x3F);
    i += 4;
    return cp;
  }
  i += 1;
  return 0xFFFD;
}

void append_utf8(std::string& out, uint32_t cp) {
  if (cp < 0x80) {
    out.push_back(static_cast<char>(cp));
  } else if (cp < 0x800) {
    out.push_back(static_cast<char>(0xC0 | (cp >> 6)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out.push_back(static_cast<char>(0xE0 | (cp >> 12)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else {
    out.push_back(static_cast<char>(0xF0 | (cp >> 18)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
}

// Python str.lower() of one codepoint via the generated kLower map.
void lower_cp(uint32_t cp, std::vector<uint32_t>& out) {
  const CpMapEntry* e = find_map(kLower, kLower_len, cp);
  if (e == nullptr) {
    out.push_back(cp);
  } else {
    for (uint16_t k = 0; k < e->len; ++k)
      out.push_back(kLower_pool[e->offset + k]);
  }
}

inline bool is_cased(uint32_t cp) { return in_ranges(kCased, kCased_len, cp); }
inline bool is_case_ignorable(uint32_t cp) {
  return in_ranges(kCaseIgnorable, kCaseIgnorable_len, cp);
}

// str.lower() of a whole codepoint sequence, including its one
// context-sensitive rule: Greek capital sigma (U+03A3) lowers to final
// sigma U+03C2 when preceded by a cased codepoint (skipping
// case-ignorables) and not followed by one (CPython handle_capital_sigma).
void lower_seq(const std::vector<uint32_t>& in, std::vector<uint32_t>& out) {
  for (size_t i = 0; i < in.size(); ++i) {
    if (in[i] == 0x03A3) {
      bool before_cased = false;
      for (size_t j = i; j-- > 0;) {
        if (is_case_ignorable(in[j])) continue;
        before_cased = is_cased(in[j]);
        break;
      }
      bool after_cased = false;
      for (size_t j = i + 1; j < in.size(); ++j) {
        if (is_case_ignorable(in[j])) continue;
        after_cased = is_cased(in[j]);
        break;
      }
      out.push_back(before_cased && !after_cased ? 0x03C2 : 0x03C3);
      continue;
    }
    lower_cp(in[i], out);
  }
}

struct PairHash {
  size_t operator()(const std::pair<std::string, std::string>& p) const {
    return std::hash<std::string>()(p.first) * 1000003 ^
           std::hash<std::string>()(p.second);
  }
};

struct Tokenizer {
  std::unordered_map<std::string, int32_t> vocab;
  std::unordered_map<std::pair<std::string, std::string>, int32_t, PairHash>
      ranks;
  std::string byte_enc[256];  // byte -> mapped unicode char (UTF-8)
  bool lowercase = false;
  bool add_prefix_space = true;
  int32_t unk_id = 0;
};

// GPT-2 bytes_to_unicode bijection (data/tokenization.py bytes_to_unicode).
void build_byte_encoder(Tokenizer& t) {
  bool direct[256] = {false};
  for (int b = int('!'); b <= int('~'); ++b) direct[b] = true;
  for (int b = 0xa1; b <= 0xac; ++b) direct[b] = true;
  for (int b = 0xae; b <= 0xff; ++b) direct[b] = true;
  int n = 0;
  for (int b = 0; b < 256; ++b) {
    uint32_t cp;
    if (direct[b]) {
      cp = static_cast<uint32_t>(b);
    } else {
      cp = 256 + n;
      ++n;
    }
    std::string s;
    append_utf8(s, cp);
    t.byte_enc[b] = s;
  }
}

const char* kContractions[] = {"'s", "'t", "'re", "'ve", "'m", "'ll", "'d"};

// The hand-rolled GPT-2 scanner from ByteLevelBPETokenizer._pretokenize,
// ported codepoint-for-codepoint. Operates on a decoded codepoint array;
// emits [start, end) codepoint index chunks.
void pretokenize(const std::vector<uint32_t>& cps,
                 std::vector<std::pair<size_t, size_t>>& chunks) {
  size_t i = 0, n = cps.size();
  while (i < n) {
    if (cps[i] == '\'') {
      bool matched = false;
      for (const char* c : kContractions) {
        size_t len = std::strlen(c);
        if (i + len <= n) {
          bool ok = true;
          for (size_t k = 0; k < len; ++k)
            if (cps[i + k] != static_cast<uint32_t>(c[k])) {
              ok = false;
              break;
            }
          if (ok) {
            chunks.emplace_back(i, i + len);
            i += len;
            matched = true;
            break;
          }
        }
      }
      if (matched) continue;
      size_t j = i + 1;
      while (j < n && !(is_space(cps[j]) || is_alpha(cps[j]) ||
                        is_numeric(cps[j])))
        ++j;
      chunks.emplace_back(i, j);
      i = j;
      continue;
    }
    size_t start = i;
    bool lead_space = false;
    if (cps[i] == ' ' && i + 1 < n && !is_space(cps[i + 1])) {
      lead_space = true;
      ++i;
    }
    if (i < n && is_alpha(cps[i])) {
      while (i < n && is_alpha(cps[i])) ++i;
    } else if (i < n && is_numeric(cps[i])) {
      while (i < n && is_numeric(cps[i])) ++i;
    } else if (i < n && is_space(cps[i])) {
      while (i < n && is_space(cps[i])) ++i;
    } else {
      while (i < n && !(is_space(cps[i]) || is_alpha(cps[i]) ||
                        is_numeric(cps[i]) || cps[i] == '\''))
        ++i;
      if (i == start + (lead_space ? 1u : 0u)) ++i;  // safety fallthrough
    }
    if (i > start) chunks.emplace_back(start, i);
  }
}

// Lowest-rank-first merge loop (ByteLevelBPETokenizer._bpe), with a
// per-thread cache keyed by the mapped token.
void bpe_merge(const Tokenizer& t, const std::string& token,
               std::unordered_map<std::string, std::vector<std::string>>&
                   cache,
               std::vector<std::string>& out) {
  auto hit = cache.find(token);
  if (hit != cache.end()) {
    out = hit->second;
    return;
  }
  std::vector<std::string> word;
  size_t i = 0;
  while (i < token.size()) {
    size_t j = i;
    next_cp(token.data(), token.size(), j);
    word.emplace_back(token.substr(i, j - i));
    i = j;
  }
  const int32_t kNoRank = INT32_MAX;
  while (word.size() > 1) {
    int32_t best_rank = kNoRank;
    size_t best_i = 0;
    for (size_t k = 0; k + 1 < word.size(); ++k) {
      auto it = t.ranks.find({word[k], word[k + 1]});
      if (it != t.ranks.end() && it->second < best_rank) {
        best_rank = it->second;
        best_i = k;
      }
    }
    if (best_rank == kNoRank) break;
    const std::string left = word[best_i], right = word[best_i + 1];
    std::vector<std::string> merged;
    merged.reserve(word.size());
    size_t k = 0;
    while (k < word.size()) {
      if (k + 1 < word.size() && word[k] == left && word[k + 1] == right) {
        merged.push_back(left + right);
        k += 2;
      } else {
        merged.push_back(word[k]);
        k += 1;
      }
    }
    word.swap(merged);
  }
  cache.emplace(token, word);
  out = word;
}

void encode_one(const Tokenizer& t, const char* text, size_t len,
                std::unordered_map<std::string, std::vector<std::string>>&
                    cache,
                std::vector<int32_t>& ids) {
  std::vector<uint32_t> cps;
  cps.reserve(len + 1);
  {
    std::vector<uint32_t> raw;
    raw.reserve(len);
    size_t i = 0;
    while (i < len) raw.push_back(next_cp(text, len, i));
    if (t.lowercase) {
      lower_seq(raw, cps);
    } else {
      cps = std::move(raw);
    }
  }
  if (t.add_prefix_space && !cps.empty() && cps[0] != ' ')
    cps.insert(cps.begin(), ' ');

  std::vector<std::pair<size_t, size_t>> chunks;
  pretokenize(cps, chunks);

  std::string chunk_utf8, mapped;
  std::vector<std::string> pieces;
  for (auto [a, b] : chunks) {
    // whitespace runs other than a single space collapse to " "
    bool all_space = true;
    for (size_t k = a; k < b; ++k)
      if (!is_space(cps[k])) {
        all_space = false;
        break;
      }
    chunk_utf8.clear();
    if (all_space && !(b - a == 1 && cps[a] == ' ')) {
      chunk_utf8 = " ";
    } else {
      for (size_t k = a; k < b; ++k) append_utf8(chunk_utf8, cps[k]);
    }
    mapped.clear();
    for (unsigned char byte : chunk_utf8) mapped += t.byte_enc[byte];
    pieces.clear();
    bpe_merge(t, mapped, cache, pieces);
    for (const std::string& p : pieces) {
      auto it = t.vocab.find(p);
      ids.push_back(it == t.vocab.end() ? t.unk_id : it->second);
    }
  }
}

}  // namespace

extern "C" {

// vocab_blob: '\n'-joined "id<TAB>token" lines (explicit ids — a filtered
// or hand-edited vocab.json may have gaps, which a positional format would
// silently remap). merges_blob: '\n'-joined "left right" pairs in rank
// order. unk_id: id for unknown pieces.
void* bpe_create(const char* vocab_blob, const char* merges_blob,
                 int32_t lowercase, int32_t add_prefix_space,
                 int32_t unk_id) {
  auto* t = new Tokenizer();
  t->lowercase = lowercase != 0;
  t->add_prefix_space = add_prefix_space != 0;
  t->unk_id = unk_id;
  build_byte_encoder(*t);
  {
    const char* p = vocab_blob;
    while (*p) {
      const char* nl = std::strchr(p, '\n');
      size_t len = nl ? static_cast<size_t>(nl - p) : std::strlen(p);
      std::string line(p, len);
      size_t tab = line.find('\t');
      if (tab != std::string::npos) {
        t->vocab.emplace(line.substr(tab + 1),
                         static_cast<int32_t>(
                             std::strtol(line.c_str(), nullptr, 10)));
      }
      if (!nl) break;
      p = nl + 1;
    }
  }
  {
    const char* p = merges_blob;
    int32_t rank = 0;
    while (*p) {
      const char* nl = std::strchr(p, '\n');
      size_t len = nl ? static_cast<size_t>(nl - p) : std::strlen(p);
      std::string line(p, len);
      size_t sp = line.find(' ');
      if (sp != std::string::npos) {
        t->ranks.emplace(
            std::make_pair(line.substr(0, sp), line.substr(sp + 1)), rank++);
      }
      if (!nl) break;
      p = nl + 1;
    }
  }
  return t;
}

void bpe_destroy(void* h) { delete static_cast<Tokenizer*>(h); }

// texts/text_lens: n UTF-8 strings with explicit byte lengths. Outputs:
// out_lens (n int32), out_ids (total int32); caller frees both via
// bpe_free. Returns 0 on success.
int32_t bpe_encode_batch(void* h, const char** texts,
                         const int64_t* text_lens, int32_t n,
                         int32_t nthreads, int32_t** out_lens,
                         int32_t** out_ids, int64_t* out_total) {
  const Tokenizer& t = *static_cast<Tokenizer*>(h);
  std::vector<std::vector<int32_t>> results(n);

  auto work = [&](int32_t lo, int32_t hi) {
    std::unordered_map<std::string, std::vector<std::string>> cache;
    for (int32_t k = lo; k < hi; ++k) {
      encode_one(t, texts[k], static_cast<size_t>(text_lens[k]), cache,
                 results[k]);
    }
  };
  if (nthreads <= 1 || n < 2) {
    work(0, n);
  } else {
    int32_t nt = nthreads < n ? nthreads : n;
    std::vector<std::thread> threads;
    int32_t chunk = (n + nt - 1) / nt;
    for (int32_t w = 0; w < nt; ++w) {
      int32_t lo = w * chunk;
      int32_t hi = lo + chunk < n ? lo + chunk : n;
      if (lo >= hi) break;
      threads.emplace_back(work, lo, hi);
    }
    for (auto& th : threads) th.join();
  }

  int64_t total = 0;
  for (auto& r : results) total += static_cast<int64_t>(r.size());
  // malloc(0) may legally return NULL; allocate at least one element
  int64_t alloc = total > 0 ? total : 1;
  *out_lens = static_cast<int32_t*>(malloc(sizeof(int32_t) * (n > 0 ? n : 1)));
  *out_ids = static_cast<int32_t*>(malloc(sizeof(int32_t) * alloc));
  if (!*out_lens || !*out_ids) {
    free(*out_lens);
    free(*out_ids);
    *out_lens = nullptr;
    *out_ids = nullptr;
    return 1;
  }
  int64_t off = 0;
  for (int32_t k = 0; k < n; ++k) {
    (*out_lens)[k] = static_cast<int32_t>(results[k].size());
    std::memcpy(*out_ids + off, results[k].data(),
                results[k].size() * sizeof(int32_t));
    off += static_cast<int64_t>(results[k].size());
  }
  *out_total = total;
  return 0;
}

void bpe_free(void* p) { free(p); }

}  // extern "C"
