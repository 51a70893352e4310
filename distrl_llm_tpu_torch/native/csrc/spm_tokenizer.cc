// Sentencepiece Unigram tokenizer core (C ABI, ctypes-bound).
//
// The N7 parity component for sentencepiece model families (SURVEY §2b:
// "HF Rust tokenizers ... or sentencepiece-C++ where the model uses it"):
// Gemma-style checkpoints tokenize with a sentencepiece Unigram model, which
// HF serializes into tokenizer.json as {"model": {"type": "Unigram",
// "unk_id": ..., "vocab": [[piece, score], ...], "byte_fallback": ...}}.
// This file implements the encode/decode hot path; Python
// (native/spm.py) parses the JSON, applies the (trivial) normalizer chain,
// and feeds the serialized model below.
//
// Semantics pinned by differential tests against the Rust `tokenizers`
// Unigram implementation (tests/test_torch_spm.py):
// * Viterbi segmentation over UNICODE characters maximizing the sum of
//   piece log-probs; pieces participate by their literal text (including
//   the "<0xNN>" byte pieces — matching the Rust trie).
// * Unknown characters score min_vocab_score - 10 (the kUnkPenalty both
//   sentencepiece and the Rust port use); consecutive unknown characters
//   FUSE into one unk token.
// * With byte_fallback, a fused unknown run is expanded POST-Viterbi into
//   its UTF-8 bytes' "<0xNN>" piece ids (observed: a known piece wins over
//   a byte expansion regardless of score — byte pieces are fallback, not
//   lattice competitors).
// * Added/special tokens match verbatim on the incoming text, earliest
//   occurrence first (longest wins on ties) — same contract as the BPE
//   core (bpe_tokenizer.cc).
//
// Serialized model format (line-based, like the BPE core's):
//   line 0:            V unk_id byte_fallback S
//   lines 1..V:        hex(piece_utf8) score byte_value   (byte_value -1 when
//                      the piece is not a "<0xNN>" byte piece)
//   lines V+1..V+S:    special token id (decimal)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct SpmModel {
  std::vector<std::string> id_to_piece;
  std::vector<float> scores;
  std::vector<int> byte_value;             // -1 unless "<0xNN>" piece
  std::unordered_map<std::string, uint32_t> piece_to_id;
  int32_t byte_piece_id[256];              // -1 when absent
  std::vector<uint32_t> special_ids;
  std::vector<std::string> specials;
  int32_t unk_id = 0;
  bool byte_fallback = false;
  bool all_bytes_present = false;
  float unk_score = 0.0f;                  // min_score - 10
  size_t max_piece_bytes = 1;
};

bool unhex(const std::string& in, std::string* out) {
  if (in.size() % 2) return false;
  out->clear();
  out->reserve(in.size() / 2);
  for (size_t i = 0; i < in.size(); i += 2) {
    auto nib = [](char c) -> int {
      if (c >= '0' && c <= '9') return c - '0';
      if (c >= 'a' && c <= 'f') return c - 'a' + 10;
      if (c >= 'A' && c <= 'F') return c - 'A' + 10;
      return -1;
    };
    int hi = nib(in[i]), lo = nib(in[i + 1]);
    if (hi < 0 || lo < 0) return false;
    out->push_back(static_cast<char>((hi << 4) | lo));
  }
  return true;
}

// UTF-8 char length from the lead byte (invalid lead bytes advance 1 so the
// lattice always makes progress on malformed input).
inline size_t char_len(unsigned char b) {
  if (b < 0x80) return 1;
  if ((b & 0xE0) == 0xC0) return 2;
  if ((b & 0xF0) == 0xE0) return 3;
  if ((b & 0xF8) == 0xF0) return 4;
  return 1;
}

// Viterbi over one ordinary-text segment (no specials inside).
void encode_segment(const SpmModel* m, const std::string& s,
                    std::vector<uint32_t>* out) {
  if (s.empty()) return;
  // char boundaries: starts[0..n_chars], starts[n_chars] == s.size()
  std::vector<uint32_t> starts;
  for (size_t i = 0; i < s.size();) {
    starts.push_back(static_cast<uint32_t>(i));
    i += char_len(static_cast<unsigned char>(s[i]));
    if (i > s.size()) i = s.size();
  }
  const size_t n = starts.size();
  starts.push_back(static_cast<uint32_t>(s.size()));

  constexpr float NEG = -1e30f;
  constexpr int32_t UNK_BP = -2;
  std::vector<float> best(n + 1, NEG);
  std::vector<uint32_t> prev(n + 1, 0);
  std::vector<int32_t> via(n + 1, -1);  // piece id, or UNK_BP for unk edge
  best[0] = 0.0f;
  std::string key;
  for (size_t i = 0; i < n; i++) {
    if (best[i] <= NEG) continue;
    // unk edge: one character
    float u = best[i] + m->unk_score;
    if (u > best[i + 1]) { best[i + 1] = u; prev[i + 1] = i; via[i + 1] = UNK_BP; }
    // vocab pieces starting at this character
    for (size_t j = i + 1; j <= n; j++) {
      size_t blen = starts[j] - starts[i];
      if (blen > m->max_piece_bytes) break;
      key.assign(s, starts[i], blen);
      auto it = m->piece_to_id.find(key);
      if (it == m->piece_to_id.end()) continue;
      float v = best[i] + m->scores[it->second];
      if (v > best[j]) { best[j] = v; prev[j] = i; via[j] = static_cast<int32_t>(it->second); }
    }
  }
  // backtrack
  std::vector<std::pair<int32_t, uint32_t>> rev;  // (piece id / UNK_BP, char idx)
  for (size_t j = n; j > 0;) {
    rev.emplace_back(via[j], prev[j]);
    j = prev[j];
  }
  // emit in order, fusing consecutive unk chars; with byte_fallback the
  // fused run expands into its bytes' pieces
  size_t unk_run_begin = 0, unk_run_end = 0;
  bool in_unk = false;
  auto flush_unk = [&]() {
    if (!in_unk) return;
    in_unk = false;
    if (m->byte_fallback && m->all_bytes_present) {
      for (size_t b = unk_run_begin; b < unk_run_end; b++)
        out->push_back(static_cast<uint32_t>(
            m->byte_piece_id[static_cast<unsigned char>(s[b])]));
    } else {
      out->push_back(static_cast<uint32_t>(m->unk_id));
    }
  };
  for (auto it = rev.rbegin(); it != rev.rend(); ++it) {
    int32_t piece = it->first;
    size_t char_i = it->second;
    if (piece == UNK_BP) {
      if (!in_unk) { in_unk = true; unk_run_begin = starts[char_i]; }
      unk_run_end = starts[char_i + 1];
    } else {
      flush_unk();
      out->push_back(static_cast<uint32_t>(piece));
    }
  }
  flush_unk();
}

}  // namespace

extern "C" {

void* spm_create(const char* data, int64_t len) {
  std::string s(data, static_cast<size_t>(len));
  auto* m = new SpmModel();
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
  if (!next_line(&line)) { delete m; return nullptr; }
  long v = 0, unk = 0, bf = 0, sp = 0;
  if (sscanf(line.c_str(), "%ld %ld %ld %ld", &v, &unk, &bf, &sp) != 4 ||
      v <= 0 || unk < 0 || unk >= v || bf < 0 || bf > 1 || sp < 0) {
    delete m; return nullptr;
  }
  m->unk_id = static_cast<int32_t>(unk);
  m->byte_fallback = bf == 1;
  m->id_to_piece.resize(v);
  m->scores.resize(v);
  m->byte_value.assign(v, -1);
  for (int i = 0; i < 256; i++) m->byte_piece_id[i] = -1;
  float min_score = 0.0f;
  for (long i = 0; i < v; i++) {
    if (!next_line(&line)) { delete m; return nullptr; }
    size_t s1 = line.find(' ');
    size_t s2 = (s1 == std::string::npos) ? s1 : line.find(' ', s1 + 1);
    if (s2 == std::string::npos) { delete m; return nullptr; }
    std::string raw;
    if (!unhex(line.substr(0, s1), &raw)) { delete m; return nullptr; }
    float score = strtof(line.c_str() + s1 + 1, nullptr);
    long bv = strtol(line.c_str() + s2 + 1, nullptr, 10);
    if (bv < -1 || bv > 255) { delete m; return nullptr; }
    m->id_to_piece[i] = raw;
    m->scores[i] = score;
    m->byte_value[i] = static_cast<int>(bv);
    if (bv >= 0 && m->byte_piece_id[bv] < 0)
      m->byte_piece_id[bv] = static_cast<int32_t>(i);
    // first occurrence wins on duplicate pieces (matches the Rust trie)
    m->piece_to_id.emplace(raw, static_cast<uint32_t>(i));
    if (score < min_score) min_score = score;
    if (raw.size() > m->max_piece_bytes) m->max_piece_bytes = raw.size();
  }
  m->unk_score = min_score - 10.0f;
  bool all = true;
  for (int i = 0; i < 256; i++) all = all && m->byte_piece_id[i] >= 0;
  m->all_bytes_present = all;
  for (long i = 0; i < sp; i++) {
    if (!next_line(&line)) { delete m; return nullptr; }
    long id = strtol(line.c_str(), nullptr, 10);
    if (id < 0 || id >= v) { delete m; return nullptr; }
    m->special_ids.push_back(static_cast<uint32_t>(id));
    m->specials.push_back(m->id_to_piece[id]);
  }
  return m;
}

void spm_free(void* h) { delete static_cast<SpmModel*>(h); }

// Encode UTF-8 text (already normalized by the caller). Special tokens match
// verbatim, earliest first, longest on ties. Returns the id count (only
// max_out are written), or -1.
int64_t spm_encode(void* h, const char* text, int64_t len, int32_t* out,
                   int64_t max_out) {
  auto* m = static_cast<SpmModel*>(h);
  if (!m) return -1;
  std::string s(text, static_cast<size_t>(len));
  std::vector<uint32_t> ids;
  size_t start = 0;
  while (start < s.size()) {
    size_t best_pos = std::string::npos, best_len = 0;
    uint32_t best_id = 0;
    for (size_t k = 0; k < m->specials.size(); k++) {
      size_t p = s.find(m->specials[k], start);
      if (p == std::string::npos) continue;
      if (p < best_pos || (p == best_pos && m->specials[k].size() > best_len)) {
        best_pos = p;
        best_len = m->specials[k].size();
        best_id = m->special_ids[k];
      }
    }
    if (best_pos == std::string::npos) {
      encode_segment(m, s.substr(start), &ids);
      break;
    }
    if (best_pos > start)
      encode_segment(m, s.substr(start, best_pos - start), &ids);
    ids.push_back(best_id);
    start = best_pos + best_len;
  }
  int64_t nn = static_cast<int64_t>(ids.size());
  for (int64_t i = 0; i < nn && i < max_out; i++)
    out[i] = static_cast<int32_t>(ids[i]);
  return nn;
}

// Decode ids to raw bytes: byte pieces contribute their byte (sentencepiece
// ByteFallback+Fuse), other pieces their literal text. The Python wrapper
// does the final UTF-8 decode and "▁"→" " replacement. Returns the byte
// count (only max_out written), or -1.
int64_t spm_decode(void* h, const int32_t* ids, int64_t n, int skip_special,
                   char* out, int64_t max_out) {
  auto* m = static_cast<SpmModel*>(h);
  if (!m) return -1;
  std::string s;
  for (int64_t i = 0; i < n; i++) {
    uint32_t id = static_cast<uint32_t>(ids[i]);
    if (id >= m->id_to_piece.size()) continue;
    if (skip_special) {
      bool is_sp = false;
      for (uint32_t sid : m->special_ids)
        if (sid == id) { is_sp = true; break; }
      if (is_sp) continue;
    }
    if (m->byte_value[id] >= 0)
      s.push_back(static_cast<char>(m->byte_value[id]));
    else
      s += m->id_to_piece[id];
  }
  int64_t bytes = static_cast<int64_t>(s.size());
  if (bytes > 0)
    memcpy(out, s.data(), static_cast<size_t>(std::min(bytes, max_out)));
  return bytes;
}

}  // extern "C"
