// Byte-level BPE tokenizer — C++ core with a plain C ABI (ctypes-bound).
//
// Host-side parity component for the reference's Rust HF tokenizer
// (SURVEY §2b N7: `load_correct_tokenizer` at train_distributed.py:46,
// `batch_encode_plus` at distributed_actor.py:217/:222). The host-side
// tokenize/decode of every rollout runs here instead of through Python
// string code. Rust is not available in this environment, so the native
// component is C++ (SURVEY §2b note).
//
// Model format: the Python wrapper (distrl_llm_tpu_torch/native/tokenizer.py)
// converts an HF tokenizer.json (unicode-remapped byte-level tokens) into a
// raw-bytes serialization:
//
//   line 0:            V M S [P]        (vocab size, merge count, special
//                                        count, pretokenizer kind: 0 = GPT-2
//                                        pattern, 1 = Qwen2/cl100k pattern;
//                                        default 1)
//   next V lines:      <hex-bytes>      (token id = line index)
//   next M lines:      <hexL> <hexR>    (merge rank = line index)
//   next S lines:      <id>             (special token ids; matched verbatim
//                                        before pretokenization)
//
// Algorithm parity with the byte-level BPE the Rust crate implements:
//   1. split text on special tokens (longest match first);
//   2. pretokenization with the checkpoint's actual regex, evaluated over
//      decoded UTF-8 codepoints with real \p{L}/\p{N} class tables
//      (unicode_tables.h, generated from unicodedata):
//        P=1 (Qwen2/Llama-3 family, the models this framework trains):
//          (?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}
//          | ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+
//        P=0 (GPT-2):
//          's|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+
//          |\s+(?!\S)|\s+
//      Alternatives are ordered (leftmost alternation wins), each greedy —
//      matching onig's behavior for these patterns; the \s+(?!\S) lookahead
//      is the standard "maximal run minus trailing space" rule. Differential
//      tests against the Rust implementation: tests/test_native_tokenizer.py;
//   3. per pretoken, greedy lowest-rank pair merging over the merge table
//      (with a pretoken result cache, as the Rust implementation keeps).
//
// Decode is id -> byte-sequence concatenation (skipping specials on request).

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>
#include <mutex>

#include "unicode_tables.h"

namespace {

struct PairHash {
  size_t operator()(const std::pair<uint32_t, uint32_t>& p) const {
    return (static_cast<size_t>(p.first) << 32) ^ p.second;
  }
};

struct Tokenizer {
  std::vector<std::string> id_to_tok;                       // id -> raw bytes
  std::unordered_map<std::string, uint32_t> tok_to_id;      // raw bytes -> id
  std::unordered_map<std::pair<uint32_t, uint32_t>, uint32_t, PairHash>
      merge_rank;                                           // (idL,idR) -> rank
  std::unordered_map<std::pair<uint32_t, uint32_t>, uint32_t, PairHash>
      merge_result;                                         // (idL,idR) -> id
  std::vector<std::string> specials;                        // raw special strings
  std::vector<uint32_t> special_ids;
  int pretok_kind = 1;                                      // 0 gpt2, 1 qwen2
  std::unordered_map<std::string, std::vector<uint32_t>> cache;  // pretoken memo
  std::mutex cache_mu;
};

// ---------------------------------------------------------------- unicode ---

bool in_ranges(uint32_t cp, const uint32_t (*ranges)[2], size_t n) {
  size_t lo = 0, hi = n;
  while (lo < hi) {
    size_t mid = (lo + hi) / 2;
    if (cp < ranges[mid][0]) hi = mid;
    else if (cp > ranges[mid][1]) lo = mid + 1;
    else return true;
  }
  return false;
}

bool is_letter(uint32_t cp) { return in_ranges(cp, kUnicodeL, kUnicodeL_len); }
bool is_number(uint32_t cp) { return in_ranges(cp, kUnicodeN, kUnicodeN_len); }

// onig's \s in Unicode mode (the class the HF pretokenizer regex uses)
bool is_space_cp(uint32_t cp) {
  switch (cp) {
    case 0x09: case 0x0A: case 0x0B: case 0x0C: case 0x0D: case 0x20:
    case 0x85: case 0xA0: case 0x1680: case 0x2028: case 0x2029:
    case 0x202F: case 0x205F: case 0x3000:
      return true;
    default:
      return cp >= 0x2000 && cp <= 0x200A;
  }
}

// Decode one UTF-8 codepoint at byte offset i; returns codepoint and writes
// its byte length. Invalid bytes decode as single-byte codepoints (byte-level
// BPE always has a byte fallback, so this only affects class membership).
uint32_t utf8_next(const std::string& s, size_t i, size_t* len) {
  uint8_t b0 = static_cast<uint8_t>(s[i]);
  size_t n = s.size();
  if (b0 < 0x80) { *len = 1; return b0; }
  auto cont = [&](size_t k) {
    return i + k < n && (static_cast<uint8_t>(s[i + k]) & 0xC0) == 0x80;
  };
  if ((b0 & 0xE0) == 0xC0 && cont(1)) {
    *len = 2;
    return ((b0 & 0x1Fu) << 6) | (static_cast<uint8_t>(s[i + 1]) & 0x3Fu);
  }
  if ((b0 & 0xF0) == 0xE0 && cont(1) && cont(2)) {
    *len = 3;
    return ((b0 & 0x0Fu) << 12) | ((static_cast<uint8_t>(s[i + 1]) & 0x3Fu) << 6) |
           (static_cast<uint8_t>(s[i + 2]) & 0x3Fu);
  }
  if ((b0 & 0xF8) == 0xF0 && cont(1) && cont(2) && cont(3)) {
    *len = 4;
    return ((b0 & 0x07u) << 18) | ((static_cast<uint8_t>(s[i + 1]) & 0x3Fu) << 12) |
           ((static_cast<uint8_t>(s[i + 2]) & 0x3Fu) << 6) |
           (static_cast<uint8_t>(s[i + 3]) & 0x3Fu);
  }
  *len = 1;
  return b0;
}

// ----------------------------------------------------------- pretokenizer ---

// Case-insensitive contraction match at byte offset i ('s 't 're 've 'm 'll
// 'd). GPT-2's pattern is case-SENSITIVE; Qwen2's has the (?i:) group.
size_t match_contraction(const std::string& s, size_t i, bool case_insensitive) {
  size_t n = s.size();
  if (s[i] != '\'' || i + 1 >= n) return 0;
  auto low = [&](size_t k) {
    char c = s[i + k];
    if (!case_insensitive) return c;
    return (c >= 'A' && c <= 'Z') ? static_cast<char>(c - 'A' + 'a') : c;
  };
  char c1 = low(1);
  if (i + 2 < n) {
    char c2 = low(2);
    if ((c1 == 'r' && c2 == 'e') || (c1 == 'v' && c2 == 'e') ||
        (c1 == 'l' && c2 == 'l'))
      return 3;
  }
  if (c1 == 's' || c1 == 't' || c1 == 'm' || c1 == 'd') return 2;
  return 0;
}

// The Qwen2 / cl100k-style pattern (tokenizer.json pre_tokenizer regex):
//   (?i:'s|'t|'re|'ve|'m|'ll|'d)          contractions, any case
//   [^\r\n\p{L}\p{N}]?\p{L}+              optional joiner char + letter run
//   \p{N}{1,3}                            digits chunked 1-3 at a time
//   ' ?[^\s\p{L}\p{N}]+[\r\n]*'           symbol run absorbing newlines
//   \s*[\r\n]+                            whitespace ending in newlines
//   \s+(?!\S)                             trailing whitespace
//   \s+
std::vector<std::string> pretokenize_qwen2(const std::string& text) {
  std::vector<std::string> out;
  size_t i = 0, n = text.size();
  while (i < n) {
    size_t clen = match_contraction(text, i, /*case_insensitive=*/true);
    if (clen) { out.emplace_back(text.substr(i, clen)); i += clen; continue; }

    size_t len0;
    uint32_t cp0 = utf8_next(text, i, &len0);

    // [^\r\n\p{L}\p{N}]?\p{L}+
    {
      size_t j = i, jl = len0;
      uint32_t c = cp0;
      bool joiner = false;
      if (c != '\r' && c != '\n' && !is_letter(c) && !is_number(c)) {
        joiner = true;
        j += jl;
        if (j < n) c = utf8_next(text, j, &jl);
      }
      if (j < n && is_letter(c)) {
        size_t end = j;
        while (end < n) {
          size_t l;
          uint32_t cc = utf8_next(text, end, &l);
          if (!is_letter(cc)) break;
          end += l;
        }
        size_t start = joiner ? i : j;
        out.emplace_back(text.substr(start, end - start));
        i = end;
        continue;
      }
    }

    // \p{N}{1,3}
    if (is_number(cp0)) {
      size_t end = i, count = 0;
      while (end < n && count < 3) {
        size_t l;
        uint32_t cc = utf8_next(text, end, &l);
        if (!is_number(cc)) break;
        end += l;
        count++;
      }
      out.emplace_back(text.substr(i, end - i));
      i = end;
      continue;
    }

    // ' ?[^\s\p{L}\p{N}]+[\r\n]*'
    {
      size_t j = i;
      if (text[j] == ' ') j++;
      if (j < n) {
        size_t l;
        uint32_t cc = utf8_next(text, j, &l);
        if (!is_space_cp(cc) && !is_letter(cc) && !is_number(cc)) {
          size_t end = j;
          while (end < n) {
            uint32_t c2 = utf8_next(text, end, &l);
            if (is_space_cp(c2) || is_letter(c2) || is_number(c2)) break;
            end += l;
          }
          while (end < n && (text[end] == '\r' || text[end] == '\n')) end++;
          out.emplace_back(text.substr(i, end - i));
          i = end;
          continue;
        }
      }
    }

    // \s*[\r\n]+  — greedy: maximal whitespace run truncated at its LAST
    // newline (the [\r\n]+ suffix); fails if the run contains no newline
    if (is_space_cp(cp0)) {
      size_t end = i, l, last_nl_end = 0, last_len = 0;
      while (end < n) {
        uint32_t cc = utf8_next(text, end, &l);
        if (!is_space_cp(cc)) break;
        end += l;
        last_len = l;
        if (cc == '\r' || cc == '\n') last_nl_end = end;
      }
      if (last_nl_end > i) {
        out.emplace_back(text.substr(i, last_nl_end - i));
        i = last_nl_end;
        continue;
      }
      // \s+(?!\S) then \s+ : maximal run; drop the last space if a non-space
      // follows (it joins the next pretoken via the joiner/space alternatives)
      if (end < n && end - i > last_len) {
        out.emplace_back(text.substr(i, end - i - last_len));
        i = end - last_len;
      } else {
        out.emplace_back(text.substr(i, end - i));
        i = end;
      }
      continue;
    }

    // unreachable fallback: emit the codepoint as its own pretoken
    out.emplace_back(text.substr(i, len0));
    i += len0;
  }
  return out;
}

// GPT-2 pattern: 's|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+
std::vector<std::string> pretokenize_gpt2(const std::string& text) {
  std::vector<std::string> out;
  size_t i = 0, n = text.size();
  while (i < n) {
    size_t clen = match_contraction(text, i, /*case_insensitive=*/false);
    if (clen) { out.emplace_back(text.substr(i, clen)); i += clen; continue; }

    // ' ?' prefix shared by the letter/number/symbol alternatives
    size_t j = i;
    if (text[j] == ' ' && j + 1 < n) j++;
    if (j < n) {
      size_t l;
      uint32_t c = utf8_next(text, j, &l);
      auto run = [&](bool (*cls)(uint32_t)) {
        size_t end = j;
        while (end < n) {
          size_t ll;
          uint32_t cc = utf8_next(text, end, &ll);
          if (!cls(cc)) break;
          end += ll;
        }
        out.emplace_back(text.substr(i, end - i));
        i = end;
      };
      if (is_letter(c)) { run(is_letter); continue; }
      if (is_number(c)) { run(is_number); continue; }
      if (!is_space_cp(c)) {
        size_t end = j;
        while (end < n) {
          size_t ll;
          uint32_t cc = utf8_next(text, end, &ll);
          if (is_space_cp(cc) || is_letter(cc) || is_number(cc)) break;
          end += ll;
        }
        out.emplace_back(text.substr(i, end - i));
        i = end;
        continue;
      }
    }

    // whitespace: \s+(?!\S) | \s+
    size_t end = i, last_len = 0;
    while (end < n) {
      size_t l;
      uint32_t cc = utf8_next(text, end, &l);
      if (!is_space_cp(cc)) break;
      end += l;
      last_len = l;
    }
    if (end < n && end - i > last_len) {
      out.emplace_back(text.substr(i, end - i - last_len));
      i = end - last_len;
    } else {
      out.emplace_back(text.substr(i, end - i));
      i = end;
    }
  }
  return out;
}

std::vector<std::string> pretokenize(const Tokenizer* t, const std::string& text) {
  return t->pretok_kind == 0 ? pretokenize_gpt2(text) : pretokenize_qwen2(text);
}

std::vector<uint32_t> bpe_merge(Tokenizer* t, const std::string& piece) {
  {
    std::lock_guard<std::mutex> g(t->cache_mu);
    auto it = t->cache.find(piece);
    if (it != t->cache.end()) return it->second;
  }
  // initial symbols: single bytes (every byte has a vocab entry in byte-level BPE)
  std::vector<uint32_t> ids;
  ids.reserve(piece.size());
  for (unsigned char b : piece) {
    auto it = t->tok_to_id.find(std::string(1, b));
    if (it == t->tok_to_id.end()) return {};  // malformed vocab: no byte fallback
    ids.push_back(it->second);
  }
  while (ids.size() > 1) {
    uint32_t best_rank = UINT32_MAX;
    size_t best_i = 0;
    for (size_t i = 0; i + 1 < ids.size(); i++) {
      auto it = t->merge_rank.find({ids[i], ids[i + 1]});
      if (it != t->merge_rank.end() && it->second < best_rank) {
        best_rank = it->second;
        best_i = i;
      }
    }
    if (best_rank == UINT32_MAX) break;
    uint32_t merged = t->merge_result[{ids[best_i], ids[best_i + 1]}];
    ids[best_i] = merged;
    ids.erase(ids.begin() + best_i + 1);
  }
  {
    std::lock_guard<std::mutex> g(t->cache_mu);
    if (t->cache.size() < (1u << 20)) t->cache.emplace(piece, ids);
  }
  return ids;
}

void encode_ordinary(Tokenizer* t, const std::string& text,
                     std::vector<uint32_t>* out) {
  for (const auto& piece : pretokenize(t, text)) {
    auto whole = t->tok_to_id.find(piece);
    if (whole != t->tok_to_id.end()) {
      out->push_back(whole->second);
      continue;
    }
    auto ids = bpe_merge(t, piece);
    out->insert(out->end(), ids.begin(), ids.end());
  }
}

int hexval(char c) {
  if (c >= '0' && c <= '9') return c - '0';
  if (c >= 'a' && c <= 'f') return c - 'a' + 10;
  if (c >= 'A' && c <= 'F') return c - 'A' + 10;
  return -1;
}

bool unhex(const std::string& h, std::string* out) {
  if (h.size() % 2) return false;
  out->clear();
  out->reserve(h.size() / 2);
  for (size_t i = 0; i < h.size(); i += 2) {
    int a = hexval(h[i]), b = hexval(h[i + 1]);
    if (a < 0 || b < 0) return false;
    out->push_back(static_cast<char>((a << 4) | b));
  }
  return true;
}

}  // namespace

extern "C" {

// Parse the serialized model (format in the header comment). Returns an
// opaque handle or null on malformed input.
void* bpe_create(const char* data, int64_t len) {
  std::string s(data, static_cast<size_t>(len));
  auto* t = new Tokenizer();
  size_t pos = 0;
  auto next_line = [&](std::string* line) -> bool {
    if (pos >= s.size()) return false;
    size_t e = s.find('\n', pos);
    if (e == std::string::npos) e = s.size();
    line->assign(s, pos, e - pos);
    pos = e + 1;
    return true;
  };
  std::string line;
  if (!next_line(&line)) { delete t; return nullptr; }
  long v = 0, m = 0, sp = 0, pk = 1;
  int fields = sscanf(line.c_str(), "%ld %ld %ld %ld", &v, &m, &sp, &pk);
  if (fields < 3 || v <= 0 || pk < 0 || pk > 1) {
    delete t; return nullptr;
  }
  t->pretok_kind = static_cast<int>(pk);
  t->id_to_tok.resize(v);
  for (long i = 0; i < v; i++) {
    if (!next_line(&line)) { delete t; return nullptr; }
    std::string raw;
    if (!unhex(line, &raw)) { delete t; return nullptr; }
    t->id_to_tok[i] = raw;
    t->tok_to_id.emplace(raw, static_cast<uint32_t>(i));
  }
  for (long i = 0; i < m; i++) {
    if (!next_line(&line)) { delete t; return nullptr; }
    size_t sep = line.find(' ');
    if (sep == std::string::npos) { delete t; return nullptr; }
    std::string l, r;
    if (!unhex(line.substr(0, sep), &l) || !unhex(line.substr(sep + 1), &r)) {
      delete t; return nullptr;
    }
    auto li = t->tok_to_id.find(l), ri = t->tok_to_id.find(r),
         mi = t->tok_to_id.find(l + r);
    if (li == t->tok_to_id.end() || ri == t->tok_to_id.end() ||
        mi == t->tok_to_id.end())
      continue;  // merge over tokens pruned from the vocab
    std::pair<uint32_t, uint32_t> key{li->second, ri->second};
    if (!t->merge_rank.count(key)) {
      t->merge_rank.emplace(key, static_cast<uint32_t>(i));
      t->merge_result.emplace(key, mi->second);
    }
  }
  for (long i = 0; i < sp; i++) {
    if (!next_line(&line)) { delete t; return nullptr; }
    long id = strtol(line.c_str(), nullptr, 10);
    if (id < 0 || id >= v) { delete t; return nullptr; }
    t->special_ids.push_back(static_cast<uint32_t>(id));
    t->specials.push_back(t->id_to_tok[id]);
  }
  return t;
}

void bpe_free(void* h) { delete static_cast<Tokenizer*>(h); }

// Encode UTF-8 text. Special tokens in the text are matched verbatim.
// Returns the number of ids produced (may exceed max_out; only max_out are
// written), or -1 on error.
int64_t bpe_encode(void* h, const char* text, int64_t len, int32_t* out,
                   int64_t max_out) {
  auto* t = static_cast<Tokenizer*>(h);
  if (!t) return -1;
  std::string s(text, static_cast<size_t>(len));
  std::vector<uint32_t> ids;
  size_t start = 0;
  while (start < s.size()) {
    // find earliest special-token occurrence (ties: longest special wins)
    size_t best_pos = std::string::npos, best_len = 0;
    uint32_t best_id = 0;
    for (size_t k = 0; k < t->specials.size(); k++) {
      size_t p = s.find(t->specials[k], start);
      if (p == std::string::npos) continue;
      if (p < best_pos ||
          (p == best_pos && t->specials[k].size() > best_len)) {
        best_pos = p;
        best_len = t->specials[k].size();
        best_id = t->special_ids[k];
      }
    }
    if (best_pos == std::string::npos) {
      encode_ordinary(t, s.substr(start), &ids);
      break;
    }
    if (best_pos > start)
      encode_ordinary(t, s.substr(start, best_pos - start), &ids);
    ids.push_back(best_id);
    start = best_pos + best_len;
  }
  int64_t n = static_cast<int64_t>(ids.size());
  for (int64_t i = 0; i < n && i < max_out; i++)
    out[i] = static_cast<int32_t>(ids[i]);
  return n;
}

// Decode ids to UTF-8 bytes. skip_special drops special ids. Returns byte
// count (may exceed max_out; only max_out bytes are written), or -1.
int64_t bpe_decode(void* h, const int32_t* ids, int64_t n, int skip_special,
                   char* out, int64_t max_out) {
  auto* t = static_cast<Tokenizer*>(h);
  if (!t) return -1;
  std::string s;
  for (int64_t i = 0; i < n; i++) {
    uint32_t id = static_cast<uint32_t>(ids[i]);
    if (id >= t->id_to_tok.size()) continue;
    if (skip_special) {
      bool is_sp = false;
      for (uint32_t sid : t->special_ids)
        if (sid == id) { is_sp = true; break; }
      if (is_sp) continue;
    }
    s += t->id_to_tok[id];
  }
  int64_t bytes = static_cast<int64_t>(s.size());
  if (bytes > 0) memcpy(out, s.data(), static_cast<size_t>(std::min(bytes, max_out)));
  return bytes;
}

}  // extern "C"
