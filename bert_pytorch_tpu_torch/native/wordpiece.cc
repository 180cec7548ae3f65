// Native WordPiece batch encoder — the C++ fast path behind
// bert_pytorch_tpu_torch.data.tokenization.get_wordpiece_tokenizer.
//
// Byte-identical to the Python spec (data/tokenization.py:
// BertWordPieceTokenizer.encode/_words_with_offsets + WordpieceTokenizer):
// same pre-tokenization walk, same normalization (lowercase + NFD-minus-Mn
// via tables generated from the SAME Python unicodedata), same greedy
// longest-match, same (start, end) codepoint spans into the original text.
// The reference got this throughput from the Rust `tokenizers` crate
// (reference src/tokenization.py:42-57, utils/encode_data.py:280); here the
// offline-encode hot loop is plain C++ + std::thread over the batch.
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

inline bool is_whitespace(uint32_t cp) {
  return in_ranges(kWhitespace, kWhitespace_len, cp);
}
inline bool is_control(uint32_t cp) {
  return in_ranges(kControl, kControl_len, cp);
}
inline bool is_punct(uint32_t cp) { return in_ranges(kPunct, kPunct_len, cp); }
inline bool is_mn(uint32_t cp) { return in_ranges(kMn, kMn_len, cp); }
// str.isspace(): what whitespace_tokenize splits at
inline bool is_pyspace(uint32_t cp) {
  return in_ranges(kPySpace, kPySpace_len, cp);
}

inline bool is_cjk(uint32_t cp) {
  return (cp >= 0x4E00 && cp <= 0x9FFF) || (cp >= 0x3400 && cp <= 0x4DBF) ||
         (cp >= 0x20000 && cp <= 0x2A6DF) || (cp >= 0x2A700 && cp <= 0x2B73F) ||
         (cp >= 0x2B740 && cp <= 0x2B81F) || (cp >= 0x2B820 && cp <= 0x2CEAF) ||
         (cp >= 0xF900 && cp <= 0xFAFF) || (cp >= 0x2F800 && cp <= 0x2FA1F);
}

// Decode one UTF-8 codepoint at s[i]; advances i. Invalid bytes decode as
// 0xFFFD and advance one byte (matches Python's handling of already-decoded
// str input: the wrapper passes well-formed UTF-8, so this is a safety net).
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

// lower() then NFD then drop Mn — the Python _norm() pipeline. Returns the
// normalized word as a codepoint sequence (wordpiece slices by codepoint).
void normalize(const std::vector<uint32_t>& word, bool lowercase,
               std::vector<uint32_t>& out) {
  out.clear();
  std::vector<uint32_t> lowered;
  const std::vector<uint32_t>* src = &word;
  if (lowercase) {
    lowered.reserve(word.size());
    for (uint32_t cp : word) {
      const CpMapEntry* e = find_map(kLower, kLower_len, cp);
      if (e) {
        for (uint16_t k = 0; k < e->len; ++k)
          lowered.push_back(kLower_pool[e->offset + k]);
      } else {
        lowered.push_back(cp);
      }
    }
    src = &lowered;
    // NFD + drop Mn (strip_accents) runs only in lowercase mode, matching
    // BasicTokenizer.tokenize / BertWordPieceTokenizer._norm
    for (uint32_t cp : *src) {
      const CpMapEntry* e = find_map(kNFD, kNFD_len, cp);
      if (e) {
        for (uint16_t k = 0; k < e->len; ++k) {
          uint32_t d = kNFD_pool[e->offset + k];
          if (!is_mn(d)) out.push_back(d);
        }
      } else if (!is_mn(cp)) {
        out.push_back(cp);
      }
    }
  } else {
    out = word;
  }
}

struct Tokenizer {
  std::unordered_map<std::string, int32_t> vocab;
  bool lowercase = true;
  int32_t unk_id = 0;
  int32_t cls_id = -1;
  int32_t sep_id = -1;
  size_t max_chars_per_word = 200;
};

struct TextResult {
  std::vector<int32_t> ids;
  std::vector<int32_t> type_ids;
  std::vector<int32_t> starts;
  std::vector<int32_t> ends;
};

// Greedy longest-match-first over '##' continuations
// (WordpieceTokenizer._split_word). cps = normalized word.
// Appends token ids, or unk_id when the word cannot be split.
void wordpiece(const Tokenizer& t, const std::vector<uint32_t>& cps,
               std::vector<int32_t>& out_ids) {
  if (cps.size() > t.max_chars_per_word) {
    out_ids.push_back(t.unk_id);
    return;
  }
  // byte offsets of each codepoint in the utf8 rendering
  std::string utf8;
  std::vector<size_t> byte_at;
  byte_at.reserve(cps.size() + 1);
  for (uint32_t cp : cps) {
    byte_at.push_back(utf8.size());
    append_utf8(utf8, cp);
  }
  byte_at.push_back(utf8.size());

  std::vector<int32_t> pieces;
  size_t start = 0;
  std::string cand;
  while (start < cps.size()) {
    size_t end = cps.size();
    int32_t match = -1;
    while (start < end) {
      cand.clear();
      if (start > 0) cand = "##";
      cand.append(utf8, byte_at[start], byte_at[end] - byte_at[start]);
      auto it = t.vocab.find(cand);
      if (it != t.vocab.end()) {
        match = it->second;
        break;
      }
      --end;
    }
    if (match < 0) {
      out_ids.push_back(t.unk_id);
      return;
    }
    pieces.push_back(match);
    start = end;
  }
  out_ids.insert(out_ids.end(), pieces.begin(), pieces.end());
}

// _words_with_offsets + wordpiece + framing for one sequence; appends into r.
void encode_sequence(const Tokenizer& t, const char* text, size_t len,
                     int32_t type_id, TextResult& r) {
  size_t i = 0;      // byte cursor
  size_t cp_idx = 0; // codepoint cursor (Python str indices)
  std::vector<uint32_t> word;
  std::vector<uint32_t> norm;
  std::vector<uint32_t> piece;
  std::vector<int32_t> word_ids;
  while (i < len) {
    size_t save_i = i;
    uint32_t cp = next_cp(text, len, i);
    if (is_whitespace(cp) || is_control(cp) || cp == 0 || cp == 0xFFFD) {
      ++cp_idx;
      continue;
    }
    size_t start_cp = cp_idx;
    word.clear();
    if (is_punct(cp) || is_cjk(cp)) {
      word.push_back(cp);
      ++cp_idx;
    } else {
      // word run: scan until whitespace/control/punct/CJK
      word.push_back(cp);
      ++cp_idx;
      while (i < len) {
        size_t peek_i = i;
        uint32_t nxt = next_cp(text, len, peek_i);
        if (is_whitespace(nxt) || is_control(nxt) || is_punct(nxt) ||
            is_cjk(nxt))
          break;
        word.push_back(nxt);
        i = peek_i;
        ++cp_idx;
      }
    }
    (void)save_i;
    normalize(word, t.lowercase, norm);
    if (norm.empty()) continue;  // e.g. pure combining marks
    word_ids.clear();
    // WordpieceTokenizer.tokenize splits the word at str.isspace()
    // characters before matching: U+2028 and U+2029 are neither Zs nor C*,
    // so a word run keeps them
    for (size_t lo = 0; lo < norm.size();) {
      size_t hi = lo;
      while (hi < norm.size() && !is_pyspace(norm[hi])) ++hi;
      if (hi > lo) {
        piece.assign(norm.begin() + lo, norm.begin() + hi);
        wordpiece(t, piece, word_ids);
      }
      lo = hi + 1;
    }
    for (int32_t id : word_ids) {
      r.ids.push_back(id);
      r.type_ids.push_back(type_id);
      r.starts.push_back(static_cast<int32_t>(start_cp));
      r.ends.push_back(static_cast<int32_t>(cp_idx));
    }
  }
}

void encode_one(const Tokenizer& t, const char* text, size_t text_len,
                const char* pair, size_t pair_len, bool add_special,
                TextResult& r) {
  if (add_special) {
    r.ids.push_back(t.cls_id);
    r.type_ids.push_back(0);
    r.starts.push_back(0);
    r.ends.push_back(0);
  }
  encode_sequence(t, text, text_len, 0, r);
  if (add_special) {
    r.ids.push_back(t.sep_id);
    r.type_ids.push_back(0);
    r.starts.push_back(0);
    r.ends.push_back(0);
  }
  if (pair != nullptr) {
    encode_sequence(t, pair, pair_len, 1, r);
    if (add_special) {
      r.ids.push_back(t.sep_id);
      r.type_ids.push_back(1);
      r.starts.push_back(0);
      r.ends.push_back(0);
    }
  }
}

}  // namespace

extern "C" {

// vocab_text: '\n'-joined tokens in id order (same contract as vocab files;
// tokens are stripped by the Python loader before the call).
void* wp_create(const char* vocab_text, int32_t lowercase) {
  auto* t = new Tokenizer();
  t->lowercase = lowercase != 0;
  const char* p = vocab_text;
  int32_t id = 0;
  while (*p) {
    const char* nl = std::strchr(p, '\n');
    size_t n = nl ? static_cast<size_t>(nl - p) : std::strlen(p);
    // operator[] so a duplicated token keeps the LAST id, matching the
    // Python load_vocab dict assignment semantics
    t->vocab[std::string(p, n)] = id++;
    if (!nl) break;
    p = nl + 1;
  }
  auto unk = t->vocab.find("[UNK]");
  t->unk_id = unk == t->vocab.end() ? 0 : unk->second;
  auto cls = t->vocab.find("[CLS]");
  t->cls_id = cls == t->vocab.end() ? -1 : cls->second;
  auto sep = t->vocab.find("[SEP]");
  t->sep_id = sep == t->vocab.end() ? -1 : sep->second;
  return t;
}

void wp_destroy(void* h) { delete static_cast<Tokenizer*>(h); }

// Encode n texts (pairs[i] may be NULL; pairs itself may be NULL).
// Outputs are malloc'd flat arrays; *out_lens has n entries, the others
// sum(lens). Returns 0 on success. Caller frees each with wp_free().
// text_lens/pair_lens: explicit byte lengths (texts may contain NUL bytes,
// which the spec skips but must not truncate at).
int32_t wp_encode_batch(void* h, const char** texts, const int64_t* text_lens,
                        const char** pairs, const int64_t* pair_lens,
                        int32_t n, int32_t add_special, int32_t nthreads,
                        int32_t** out_lens, int32_t** out_ids,
                        int32_t** out_type_ids, int32_t** out_starts,
                        int32_t** out_ends, int64_t* out_total) {
  const Tokenizer& t = *static_cast<Tokenizer*>(h);
  std::vector<TextResult> results(n);

  auto work = [&](int32_t lo, int32_t hi) {
    for (int32_t k = lo; k < hi; ++k) {
      encode_one(t, texts[k], static_cast<size_t>(text_lens[k]),
                 pairs ? pairs[k] : nullptr,
                 pairs && pairs[k] ? static_cast<size_t>(pair_lens[k]) : 0,
                 add_special != 0, results[k]);
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
  for (auto& r : results) total += static_cast<int64_t>(r.ids.size());
  // malloc(0) may legally return NULL (non-glibc); allocate at least one
  // element so an all-empty batch is distinguishable from allocation failure
  int64_t alloc = total > 0 ? total : 1;
  *out_lens = static_cast<int32_t*>(malloc(sizeof(int32_t) * (n > 0 ? n : 1)));
  *out_ids = static_cast<int32_t*>(malloc(sizeof(int32_t) * alloc));
  *out_type_ids = static_cast<int32_t*>(malloc(sizeof(int32_t) * alloc));
  *out_starts = static_cast<int32_t*>(malloc(sizeof(int32_t) * alloc));
  *out_ends = static_cast<int32_t*>(malloc(sizeof(int32_t) * alloc));
  if (!*out_lens || !*out_ids || !*out_type_ids || !*out_starts ||
      !*out_ends) {
    // free the ones that did succeed — the caller sees rc!=0 and never calls
    // wp_free on any output
    int32_t** outs[] = {out_lens, out_ids, out_type_ids, out_starts,
                        out_ends};
    for (auto o : outs) {
      free(*o);
      *o = nullptr;
    }
    return 1;
  }
  int64_t off = 0;
  for (int32_t k = 0; k < n; ++k) {
    const TextResult& r = results[k];
    (*out_lens)[k] = static_cast<int32_t>(r.ids.size());
    std::memcpy(*out_ids + off, r.ids.data(), r.ids.size() * 4);
    std::memcpy(*out_type_ids + off, r.type_ids.data(), r.ids.size() * 4);
    std::memcpy(*out_starts + off, r.starts.data(), r.ids.size() * 4);
    std::memcpy(*out_ends + off, r.ends.data(), r.ids.size() * 4);
    off += static_cast<int64_t>(r.ids.size());
  }
  *out_total = total;
  return 0;
}

void wp_free(void* p) { free(p); }

}  // extern "C"
