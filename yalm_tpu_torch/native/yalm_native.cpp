// yalm_tpu native host components: mmap checkpoint reader + trie tokenizer.
//
// The reference implements these in C++ too (src/codec.cpp mmap loader,
// src/tokenizer.cpp trie) — this is the from-scratch equivalent for the TPU
// runtime, exposed through a C ABI consumed via ctypes (no pybind11 in the
// image). Design differences from the reference:
//   - self-contained minimal JSON parser for the safetensors header subset
//     (objects / arrays / strings / integers) instead of vendoring a 25k-line
//     JSON library;
//   - flat-array trie (nodes in one contiguous vector, 256-way fanout via a
//     sorted edge list) instead of per-node heap maps — cache-friendly for
//     long-prompt encodes;
//   - zero-copy contract: tensor data pointers point straight into the
//     MAP_PRIVATE mapping; Python wraps them as numpy views and JAX copies
//     to device from there.
//
// Build: make -C yalm_tpu/native   (produces libyalm_native.so)

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <string>
#include <vector>
#include <memory>
#include <algorithm>
#include <unordered_map>

#include "unicode_ln.h"

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

// ---------------------------------------------------------------------------
// Minimal JSON parser (safetensors header subset)
// ---------------------------------------------------------------------------

namespace mini_json {

struct Value;
using ValuePtr = std::unique_ptr<Value>;

struct Value {
  enum class Kind { Str, Int, Arr, Obj } kind;
  std::string str;
  int64_t num = 0;
  std::vector<ValuePtr> arr;
  std::vector<std::pair<std::string, ValuePtr>> obj;

  const Value* find(const std::string& key) const {
    for (auto& kv : obj)
      if (kv.first == key) return kv.second.get();
    return nullptr;
  }
};

struct Parser {
  const char* p;
  const char* end;
  std::string error;

  explicit Parser(const char* data, size_t len) : p(data), end(data + len) {}

  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) p++;
  }

  bool fail(const char* msg) {
    if (error.empty()) error = msg;
    return false;
  }

  bool parse_string(std::string& out) {
    skip_ws();
    if (p >= end || *p != '"') return fail("expected string");
    p++;
    out.clear();
    while (p < end && *p != '"') {
      char c = *p++;
      if (c == '\\') {
        if (p >= end) return fail("bad escape");
        char e = *p++;
        switch (e) {
          case '"': out.push_back('"'); break;
          case '\\': out.push_back('\\'); break;
          case '/': out.push_back('/'); break;
          case 'n': out.push_back('\n'); break;
          case 't': out.push_back('\t'); break;
          case 'r': out.push_back('\r'); break;
          case 'b': out.push_back('\b'); break;
          case 'f': out.push_back('\f'); break;
          case 'u': {
            if (end - p < 4) return fail("bad \\u escape");
            unsigned code = 0;
            for (int i = 0; i < 4; i++) {
              char h = *p++;
              code <<= 4;
              if (h >= '0' && h <= '9') code |= h - '0';
              else if (h >= 'a' && h <= 'f') code |= h - 'a' + 10;
              else if (h >= 'A' && h <= 'F') code |= h - 'A' + 10;
              else return fail("bad hex digit");
            }
            // encode as UTF-8 (BMP only; surrogate pairs unsupported — the
            // safetensors headers we read never contain them)
            if (code < 0x80) out.push_back((char)code);
            else if (code < 0x800) {
              out.push_back((char)(0xC0 | (code >> 6)));
              out.push_back((char)(0x80 | (code & 0x3F)));
            } else {
              out.push_back((char)(0xE0 | (code >> 12)));
              out.push_back((char)(0x80 | ((code >> 6) & 0x3F)));
              out.push_back((char)(0x80 | (code & 0x3F)));
            }
            break;
          }
          default: return fail("unknown escape");
        }
      } else {
        out.push_back(c);
      }
    }
    if (p >= end) return fail("unterminated string");
    p++;  // closing quote
    return true;
  }

  bool parse_value(ValuePtr& out) {
    skip_ws();
    if (p >= end) return fail("unexpected end");
    out = std::make_unique<Value>();
    if (*p == '"') {
      out->kind = Value::Kind::Str;
      return parse_string(out->str);
    }
    if (*p == '{') {
      out->kind = Value::Kind::Obj;
      p++;
      skip_ws();
      if (p < end && *p == '}') { p++; return true; }
      while (true) {
        std::string key;
        if (!parse_string(key)) return false;
        skip_ws();
        if (p >= end || *p != ':') return fail("expected ':'");
        p++;
        ValuePtr v;
        if (!parse_value(v)) return false;
        out->obj.emplace_back(std::move(key), std::move(v));
        skip_ws();
        if (p < end && *p == ',') { p++; continue; }
        if (p < end && *p == '}') { p++; return true; }
        return fail("expected ',' or '}'");
      }
    }
    if (*p == '[') {
      out->kind = Value::Kind::Arr;
      p++;
      skip_ws();
      if (p < end && *p == ']') { p++; return true; }
      while (true) {
        ValuePtr v;
        if (!parse_value(v)) return false;
        out->arr.push_back(std::move(v));
        skip_ws();
        if (p < end && *p == ',') { p++; continue; }
        if (p < end && *p == ']') { p++; return true; }
        return fail("expected ',' or ']'");
      }
    }
    if (*p == '-' || (*p >= '0' && *p <= '9')) {
      out->kind = Value::Kind::Int;
      bool neg = (*p == '-');
      if (neg) p++;
      int64_t v = 0;
      bool any = false;
      while (p < end && *p >= '0' && *p <= '9') {
        v = v * 10 + (*p - '0');
        p++;
        any = true;
      }
      // fractional/exponent parts are not needed for safetensors headers;
      // swallow them so odd metadata doesn't break parsing
      if (p < end && *p == '.') {
        p++;
        while (p < end && *p >= '0' && *p <= '9') p++;
      }
      if (p < end && (*p == 'e' || *p == 'E')) {
        p++;
        if (p < end && (*p == '+' || *p == '-')) p++;
        while (p < end && *p >= '0' && *p <= '9') p++;
      }
      if (!any) return fail("bad number");
      out->num = neg ? -v : v;
      return true;
    }
    // true/false/null — tolerate by skipping
    if (end - p >= 4 && memcmp(p, "true", 4) == 0) { p += 4; out->kind = Value::Kind::Int; out->num = 1; return true; }
    if (end - p >= 5 && memcmp(p, "false", 5) == 0) { p += 5; out->kind = Value::Kind::Int; out->num = 0; return true; }
    if (end - p >= 4 && memcmp(p, "null", 4) == 0) { p += 4; out->kind = Value::Kind::Int; out->num = 0; return true; }
    return fail("unexpected token");
  }
};

}  // namespace mini_json

// ---------------------------------------------------------------------------
// Checkpoint reader
// ---------------------------------------------------------------------------

struct YnTensor {
  std::string name;
  std::string dtype;
  int64_t shape[8] = {0};
  int ndim = 0;
  const void* data = nullptr;
  int64_t nbytes = 0;
};

struct YnFile {
  void* map = nullptr;
  size_t map_size = 0;
  std::vector<YnTensor> tensors;
  std::vector<std::pair<std::string, std::string>> metadata;
  std::string error;
};

extern "C" {

YnFile* yn_open(const char* path) {
  auto f = std::make_unique<YnFile>();
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) {
    f->error = std::string("open failed: ") + path;
    return f.release();
  }
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 8) {
    ::close(fd);
    f->error = "stat failed or file too small";
    return f.release();
  }
  f->map_size = (size_t)st.st_size;
  f->map = mmap(nullptr, f->map_size, PROT_READ, MAP_PRIVATE, fd, 0);
  ::close(fd);
  if (f->map == MAP_FAILED) {
    f->map = nullptr;
    f->error = "mmap failed";
    return f.release();
  }
  madvise(f->map, f->map_size, MADV_SEQUENTIAL);

  const uint8_t* base = (const uint8_t*)f->map;
  uint64_t header_size = 0;
  memcpy(&header_size, base, 8);  // little-endian host assumed (x86/ARM)
  if (header_size > f->map_size - 8) {
    f->error = "bad header size";
    return f.release();
  }
  const char* json = (const char*)(base + 8);
  mini_json::Parser parser(json, header_size);
  mini_json::ValuePtr root;
  if (!parser.parse_value(root) || root->kind != mini_json::Value::Kind::Obj) {
    f->error = "header parse error: " + parser.error;
    return f.release();
  }

  const uint8_t* data_start = base + 8 + header_size;
  size_t data_size = f->map_size - 8 - header_size;

  for (auto& kv : root->obj) {
    if (kv.first == "__metadata__") {
      for (auto& m : kv.second->obj) {
        if (m.second->kind == mini_json::Value::Kind::Str)
          f->metadata.emplace_back(m.first, m.second->str);
      }
      continue;
    }
    const mini_json::Value* v = kv.second.get();
    const mini_json::Value* dt = v->find("dtype");
    const mini_json::Value* sh = v->find("shape");
    const mini_json::Value* off = v->find("data_offsets");
    if (!dt || !sh || !off || off->arr.size() != 2) {
      f->error = "bad tensor entry: " + kv.first;
      return f.release();
    }
    YnTensor t;
    t.name = kv.first;
    t.dtype = dt->str;
    t.ndim = (int)sh->arr.size();
    if (t.ndim > 8) {
      f->error = "too many dims: " + kv.first;
      return f.release();
    }
    for (int i = 0; i < t.ndim; i++) t.shape[i] = sh->arr[i]->num;
    int64_t start = off->arr[0]->num, end = off->arr[1]->num;
    if (start < 0 || end < start || (size_t)end > data_size) {
      f->error = "bad offsets: " + kv.first;
      return f.release();
    }
    t.data = data_start + start;
    t.nbytes = end - start;
    f->tensors.push_back(std::move(t));
  }
  return f.release();
}

const char* yn_error(YnFile* f) { return f->error.empty() ? nullptr : f->error.c_str(); }

void yn_close(YnFile* f) {
  if (f->map) munmap(f->map, f->map_size);
  delete f;
}

int yn_n_tensors(YnFile* f) { return (int)f->tensors.size(); }

int yn_tensor_info(YnFile* f, int idx, const char** name, const char** dtype,
                   const int64_t** shape, int* ndim, const void** data,
                   int64_t* nbytes) {
  if (idx < 0 || idx >= (int)f->tensors.size()) return -1;
  const YnTensor& t = f->tensors[idx];
  *name = t.name.c_str();
  *dtype = t.dtype.c_str();
  *shape = t.shape;
  *ndim = t.ndim;
  *data = t.data;
  *nbytes = t.nbytes;
  return 0;
}

int yn_n_metadata(YnFile* f) { return (int)f->metadata.size(); }

int yn_metadata(YnFile* f, int idx, const char** key, const char** val) {
  if (idx < 0 || idx >= (int)f->metadata.size()) return -1;
  *key = f->metadata[idx].first.c_str();
  *val = f->metadata[idx].second.c_str();
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Trie tokenizer
// ---------------------------------------------------------------------------

struct TrieNode {
  // Sorted edge list: (byte, child index). Binary search at encode time.
  std::vector<std::pair<uint8_t, int32_t>> edges;
  int32_t token_id = -1;

  int32_t child(uint8_t b) const {
    size_t lo = 0, hi = edges.size();
    while (lo < hi) {
      size_t mid = (lo + hi) / 2;
      if (edges[mid].first < b) lo = mid + 1;
      else hi = mid;
    }
    if (lo < edges.size() && edges[lo].first == b) return edges[lo].second;
    return -1;
  }

  void add_edge(uint8_t b, int32_t idx) {
    size_t lo = 0;
    while (lo < edges.size() && edges[lo].first < b) lo++;
    edges.insert(edges.begin() + lo, {b, idx});
  }
};

struct BpeState {
  // (left_id << 32 | right_id) -> (rank, merged_id)
  std::unordered_map<uint64_t, std::pair<int32_t, int32_t>> ranks;
  std::unordered_map<std::string, int32_t> piece_id;  // lowest id wins
  std::vector<std::pair<std::string, int32_t>> added;  // longest-first
  int32_t byte_ids[256];
  int pretok = 0;   // 0 none, 1 metaspace, 2 bytelevel, 3 llama3
  int prefix = 0;   // metaspace: 0 never, 1 always, 2 first-segment-only;
                    // bytelevel: 1 = add_prefix_space
  bool fallback_ok = false;  // byte fallback usable in BPE mode
};

struct YtTokenizer {
  std::vector<TrieNode> nodes;   // nodes[0] is the root
  std::vector<std::string> pieces;
  int32_t byte_fallback_start = -1;
  int32_t n_vocab = 0;
  std::unique_ptr<BpeState> bpe;
};

extern "C" {

// vocab blob: NUL-terminated token byte strings back to back (the checkpoint's
// "tokenizer.tokens" tensor).
YtTokenizer* yt_create(const uint8_t* blob, int64_t blob_len) {
  auto t = std::make_unique<YtTokenizer>();
  t->nodes.emplace_back();  // root
  int32_t token_id = 0;
  int64_t i = 0;
  while (i < blob_len) {
    int64_t start = i;
    while (i < blob_len && blob[i] != 0) i++;
    int64_t len = i - start;
    // walk/extend the trie
    int32_t node = 0;
    for (int64_t j = 0; j < len; j++) {
      uint8_t b = blob[start + j];
      int32_t next = t->nodes[node].child(b);
      if (next < 0) {
        next = (int32_t)t->nodes.size();
        t->nodes.emplace_back();
        t->nodes[node].add_edge(b, next);
      }
      node = next;
    }
    if (len > 0) t->nodes[node].token_id = token_id;
    if (len == 6 && memcmp(blob + start, "<0x00>", 6) == 0)
      t->byte_fallback_start = token_id;
    t->pieces.emplace_back(reinterpret_cast<const char*>(blob + start),
                           (size_t)len);
    token_id++;
    i++;  // skip NUL
  }
  t->n_vocab = token_id;
  return t.release();
}

void yt_free(YtTokenizer* t) { delete t; }

int32_t yt_byte_fallback_start(YtTokenizer* t) { return t->byte_fallback_start; }
int32_t yt_n_vocab(YtTokenizer* t) { return t->n_vocab; }

// Greedy longest-prefix-match encode; returns number of ids written, or -1 if
// out_cap is too small. Bytes with no match use byte-fallback tokens when the
// vocab has them, and are skipped otherwise.
int64_t yt_encode(YtTokenizer* t, const uint8_t* text, int64_t text_len,
                  int32_t* out, int64_t out_cap) {
  int64_t n_out = 0;
  int64_t i = 0;
  while (i < text_len) {
    int32_t node = 0;
    int32_t best_id = -1;
    int64_t best_len = 0;
    int64_t j = i;
    while (j < text_len) {
      int32_t next = t->nodes[node].child(text[j]);
      if (next < 0) break;
      node = next;
      j++;
      if (t->nodes[node].token_id >= 0) {
        best_id = t->nodes[node].token_id;
        best_len = j - i;
      }
    }
    if (best_id < 0) {
      if (t->byte_fallback_start >= 0) {
        if (n_out >= out_cap) return -1;
        out[n_out++] = (int32_t)text[i] + t->byte_fallback_start;
      }
      i += 1;
    } else {
      if (n_out >= out_cap) return -1;
      out[n_out++] = best_id;
      i += best_len;
    }
  }
  return n_out;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Exact rank-based BPE (parity with yalm_tpu/tokenizer.py's BPE path):
// added-token extraction -> Metaspace / GPT-2 ByteLevel pre-tokenization ->
// lowest-rank pair merging -> model-vocab-only byte fallback. The reference
// tokenizer is greedy-only (src/tokenizer.cpp:57-94); this matches HF
// `tokenizers` byte-for-byte.
// ---------------------------------------------------------------------------

namespace bpe {

static bool in_ranges(uint32_t cp, const uint32_t (*ranges)[2], size_t n) {
  size_t lo = 0, hi = n;
  while (lo < hi) {
    size_t mid = (lo + hi) / 2;
    if (ranges[mid][1] < cp) lo = mid + 1;
    else hi = mid;
  }
  return lo < n && ranges[lo][0] <= cp && cp <= ranges[lo][1];
}

static bool is_letter(uint32_t cp) {
  return in_ranges(cp, kUnicodeLetterRanges, kUnicodeLetterRanges_len);
}
static bool is_number(uint32_t cp) {
  return in_ranges(cp, kUnicodeNumberRanges, kUnicodeNumberRanges_len);
}
// Python str.isspace(): Zs plus bidi WS/B/S control characters.
static bool is_space(uint32_t cp) {
  return (cp >= 0x09 && cp <= 0x0D) || (cp >= 0x1C && cp <= 0x1F) ||
         cp == 0x20 || cp == 0x85 || cp == 0xA0 || cp == 0x1680 ||
         (cp >= 0x2000 && cp <= 0x200A) || cp == 0x2028 || cp == 0x2029 ||
         cp == 0x202F || cp == 0x205F || cp == 0x3000;
}

// Decode one codepoint; invalid bytes come back as 0xDC00+byte (the lone
// surrogates Python's surrogateescape produces), which classify as
// non-letter/non-number/non-space — same as Python's category Cs.
static uint32_t next_cp(const uint8_t* s, int64_t i, int64_t n, int* len) {
  uint8_t b = s[i];
  *len = 1;
  if (b < 0x80) return b;
  int need;
  uint32_t cp;
  if ((b & 0xE0) == 0xC0) { need = 1; cp = b & 0x1F; }
  else if ((b & 0xF0) == 0xE0) { need = 2; cp = b & 0x0F; }
  else if ((b & 0xF8) == 0xF0) { need = 3; cp = b & 0x07; }
  else return 0xDC00u + b;
  if (i + need >= n) return 0xDC00u + b;  // truncated sequence
  for (int k = 1; k <= need; k++) {
    if ((s[i + k] & 0xC0) != 0x80) return 0xDC00u + b;
    cp = (cp << 6) | (s[i + k] & 0x3F);
  }
  // overlong / surrogate / out-of-range: surrogate-escape the lead byte
  static const uint32_t mins[4] = {0, 0x80, 0x800, 0x10000};
  if (cp < mins[need] || cp > 0x10FFFF || (cp >= 0xD800 && cp <= 0xDFFF))
    return 0xDC00u + b;
  *len = 1 + need;
  return cp;
}

// GPT-2 ByteLevel regex over [s, s+n): appends (start, len) word spans.
static void gpt2_pretok(const uint8_t* s, int64_t n,
                        std::vector<std::pair<int64_t, int64_t>>* words) {
  static const char* kContr[7] = {"'s", "'t", "'re", "'ve", "'m", "'ll", "'d"};
  int64_t i = 0;
  while (i < n) {
    if (s[i] == '\'') {
      bool hit = false;
      for (const char* c : kContr) {
        size_t cl = strlen(c);
        if (i + (int64_t)cl <= n && memcmp(s + i, c, cl) == 0) {
          words->push_back({i, (int64_t)cl});
          i += cl;
          hit = true;
          break;
        }
      }
      if (hit) continue;
    }
    int64_t j = i;
    if (s[i] == ' ' && i + 1 < n) j = i + 1;
    int cl;
    uint32_t cp = j < n ? next_cp(s, j, n, &cl) : 0;
    if (j < n && is_letter(cp)) {
      int64_t k = j;
      while (k < n) {
        uint32_t c2 = next_cp(s, k, n, &cl);
        if (!is_letter(c2)) break;
        k += cl;
      }
      words->push_back({i, k - i});
      i = k;
      continue;
    }
    if (j < n && is_number(cp)) {
      int64_t k = j;
      while (k < n) {
        uint32_t c2 = next_cp(s, k, n, &cl);
        if (!is_number(c2)) break;
        k += cl;
      }
      words->push_back({i, k - i});
      i = k;
      continue;
    }
    if (j < n && !is_space(cp)) {
      int64_t k = j;
      while (k < n) {
        uint32_t c2 = next_cp(s, k, n, &cl);
        if (is_space(c2) || is_letter(c2) || is_number(c2)) break;
        k += cl;
      }
      words->push_back({i, k - i});
      i = k;
      continue;
    }
    // whitespace: \s+(?!\S) leaves the run's last char for the next token
    int64_t k = i;
    int64_t last_len = 1;
    while (k < n) {
      uint32_t c2 = next_cp(s, k, n, &cl);
      if (!is_space(c2)) break;
      last_len = cl;
      k += cl;
    }
    if (k == n || k - i > last_len) {
      int64_t stop = (k == n) ? k : k - last_len;
      words->push_back({i, stop - i});
      i = stop;
    } else {
      words->push_back({i, k - i});
      i = k;
    }
  }
}

// Llama-3 (tiktoken-lineage) pre-tokenizer regex — the Python twin is
// tokenizer._llama3_pretok: case-insensitive contractions, ANY single
// non-newline non-alnum char may prefix a letter run, digits chunk in
// threes, punct swallows trailing newlines, newline runs coalesce.
static void llama3_pretok(const uint8_t* s, int64_t n,
                          std::vector<std::pair<int64_t, int64_t>>* words) {
  static const char* kContr[7] = {"'s", "'t", "'re", "'ve", "'m", "'ll", "'d"};
  auto is_nl = [](uint32_t cp) { return cp == '\r' || cp == '\n'; };
  int64_t i = 0;
  while (i < n) {
    int cl0;
    uint32_t c = next_cp(s, i, n, &cl0);
    if (c == '\'' && i + 1 < n) {
      bool hit = false;
      for (const char* ct : kContr) {
        size_t cln = strlen(ct);
        if (i + (int64_t)cln > n) continue;
        bool ok = true;
        for (size_t q = 0; q < cln; q++) {
          uint8_t b = s[i + q];
          if (b >= 'A' && b <= 'Z') b += 32;  // ASCII lowercase
          if (b != (uint8_t)ct[q]) { ok = false; break; }
        }
        if (ok) {
          words->push_back({i, (int64_t)cln});
          i += cln;
          hit = true;
          break;
        }
      }
      if (hit) continue;
    }
    // [^\r\n\p{L}\p{N}]?\p{L}+ (greedy optional prefix first)
    if (!is_nl(c) && !is_letter(c) && !is_number(c) && i + cl0 < n) {
      int cl1;
      uint32_t c1 = next_cp(s, i + cl0, n, &cl1);
      if (is_letter(c1)) {
        int64_t k = i + cl0;
        while (k < n) {
          int cl;
          uint32_t c2 = next_cp(s, k, n, &cl);
          if (!is_letter(c2)) break;
          k += cl;
        }
        words->push_back({i, k - i});
        i = k;
        continue;
      }
    }
    if (is_letter(c)) {
      int64_t k = i;
      while (k < n) {
        int cl;
        uint32_t c2 = next_cp(s, k, n, &cl);
        if (!is_letter(c2)) break;
        k += cl;
      }
      words->push_back({i, k - i});
      i = k;
      continue;
    }
    // \p{N}{1,3}
    if (is_number(c)) {
      int64_t k = i;
      int count = 0;
      while (k < n && count < 3) {
        int cl;
        uint32_t c2 = next_cp(s, k, n, &cl);
        if (!is_number(c2)) break;
        k += cl;
        count++;
      }
      words->push_back({i, k - i});
      i = k;
      continue;
    }
    //  ?[^\s\p{L}\p{N}]+[\r\n]*
    int64_t j = (c == ' ' && i + 1 < n) ? i + 1 : i;
    if (j < n) {
      int cl;
      uint32_t cj = next_cp(s, j, n, &cl);
      if (!is_space(cj) && !is_letter(cj) && !is_number(cj)) {
        int64_t k = j;
        while (k < n) {
          uint32_t c2 = next_cp(s, k, n, &cl);
          if (is_space(c2) || is_letter(c2) || is_number(c2)) break;
          k += cl;
        }
        while (k < n && is_nl(s[k])) k++;
        words->push_back({i, k - i});
        i = k;
        continue;
      }
    }
    // \s*[\r\n]+ — ends right after the run's LAST newline char
    int64_t k = i, last_nl_end = -1, last_len = 1;
    while (k < n) {
      int cl;
      uint32_t c2 = next_cp(s, k, n, &cl);
      if (!is_space(c2)) break;
      if (is_nl(c2)) last_nl_end = k + cl;
      last_len = cl;
      k += cl;
    }
    if (last_nl_end >= 0) {
      words->push_back({i, last_nl_end - i});
      i = last_nl_end;
      continue;
    }
    // \s+(?!\S) then \s+ (identical to the GPT-2 tail)
    if (k == n || k - i > last_len) {
      int64_t stop = (k == n) ? k : k - last_len;
      words->push_back({i, stop - i});
      i = stop;
    } else {
      words->push_back({i, k - i});
      i = k;
    }
  }
}

// Merge loop over one word; symbols are contiguous byte slices of `w`.
static void encode_word(const YtTokenizer* t, const uint8_t* w, int64_t n,
                        std::vector<int32_t>* out) {
  const BpeState& st = *t->bpe;
  struct Sym { int32_t id; int64_t start, len; };
  std::vector<Sym> syms;
  if (st.pretok >= 2) {  // bytelevel/llama3: one symbol per byte
    for (int64_t i = 0; i < n; i++)
      syms.push_back({st.byte_ids[w[i]], i, 1});
  } else {  // metaspace/sentencepiece lineage: one symbol per unicode char
    int64_t i = 0;
    while (i < n) {
      int cl;
      (void)next_cp(w, i, n, &cl);
      std::string cb(reinterpret_cast<const char*>(w + i), (size_t)cl);
      auto it = st.piece_id.find(cb);
      syms.push_back({it == st.piece_id.end() ? -1 : it->second, i, cl});
      i += cl;
    }
  }
  while (syms.size() > 1) {
    int best = -1;
    int32_t best_rank = INT32_MAX;
    int32_t best_out = -1;
    for (size_t i = 0; i + 1 < syms.size(); i++) {
      if (syms[i].id < 0 || syms[i + 1].id < 0) continue;
      uint64_t key = ((uint64_t)(uint32_t)syms[i].id << 32) |
                     (uint32_t)syms[i + 1].id;
      auto it = st.ranks.find(key);
      if (it != st.ranks.end() && it->second.first < best_rank) {
        best_rank = it->second.first;
        best_out = it->second.second;
        best = (int)i;
      }
    }
    if (best < 0) break;
    syms[best].id = best_out;
    syms[best].len += syms[best + 1].len;
    syms.erase(syms.begin() + best + 1);
  }
  for (const Sym& s : syms) {
    if (s.id >= 0) {
      out->push_back(s.id);
    } else if (st.fallback_ok) {
      for (int64_t k = 0; k < s.len; k++)
        out->push_back((int32_t)w[s.start + k] + t->byte_fallback_start);
    }
    // else: dropped (HF BPE with unk_token=None, added-only fallback block)
  }
}

static void encode_segment(const YtTokenizer* t, const uint8_t* s, int64_t n,
                           bool first, std::vector<int32_t>* out) {
  const BpeState& st = *t->bpe;
  bool prepend = st.prefix == 1 || (st.prefix == 2 && first);
  std::string buf;
  if (prepend && n > 0 && s[0] != ' ') {
    buf.reserve(n + 1);
    buf.push_back(' ');
    buf.append(reinterpret_cast<const char*>(s), (size_t)n);
    s = reinterpret_cast<const uint8_t*>(buf.data());
    n = (int64_t)buf.size();
  }
  if (st.pretok == 1) {
    // Metaspace split=true: every 0x20 starts a new piece (the replacement
    // char merges with what follows)
    int64_t start = 0;
    for (int64_t i = 1; i <= n; i++) {
      if (i == n || s[i] == ' ') {
        if (i > start) encode_word(t, s + start, i - start, out);
        start = i;
      }
    }
  } else if (st.pretok == 2 || st.pretok == 3) {
    std::vector<std::pair<int64_t, int64_t>> words;
    if (st.pretok == 3) llama3_pretok(s, n, &words);
    else gpt2_pretok(s, n, &words);
    for (auto& wsp : words) encode_word(t, s + wsp.first, wsp.second, out);
  } else if (n > 0) {
    encode_word(t, s, n, out);
  }
}

}  // namespace bpe

extern "C" {

// merges: n_merges (left_id, right_id) int32 pairs in rank order; added:
// added-token ids; pretok: "metaspace[:scheme]" | "bytelevel[:prefix]" | "".
// Returns 0 on success.
int32_t yt_set_bpe(YtTokenizer* t, const int32_t* merges, int64_t n_merges,
                   const int32_t* added, int64_t n_added,
                   const char* pretok) {
  auto st = std::make_unique<BpeState>();
  for (int32_t i = 0; i < t->n_vocab; i++)
    st->piece_id.emplace(t->pieces[i], i);  // emplace: lowest id wins
  for (int64_t r = 0; r < n_merges; r++) {
    int32_t li = merges[2 * r], ri = merges[2 * r + 1];
    if (li < 0 || ri < 0 || li >= t->n_vocab || ri >= t->n_vocab) continue;
    auto it = st->piece_id.find(t->pieces[li] + t->pieces[ri]);
    if (it == st->piece_id.end()) continue;
    uint64_t key = ((uint64_t)(uint32_t)li << 32) | (uint32_t)ri;
    st->ranks.emplace(key, std::make_pair((int32_t)r, it->second));
  }
  bool fallback_added = false;
  for (int64_t a = 0; a < n_added; a++) {
    int32_t id = added[a];
    if (id < 0 || id >= t->n_vocab) continue;
    st->added.emplace_back(t->pieces[id], id);
    if (id == t->byte_fallback_start) fallback_added = true;
  }
  std::stable_sort(st->added.begin(), st->added.end(),
                   [](const auto& x, const auto& y) {
                     return x.first.size() > y.first.size();
                   });
  st->fallback_ok = t->byte_fallback_start >= 0 && !fallback_added;
  for (int b = 0; b < 256; b++) {
    std::string s(1, (char)b);
    auto it = st->piece_id.find(s);
    st->byte_ids[b] = it == st->piece_id.end() ? -1 : it->second;
  }
  std::string p(pretok ? pretok : "");
  if (p.rfind("metaspace", 0) == 0) {
    st->pretok = 1;
    // HF Metaspace: 'always' prepends to EVERY split segment, 'first'
    // only to the segment at offset 0 of the whole text
    st->prefix = p.find(":always") != std::string::npos ? 1
               : p.find(":first") != std::string::npos ? 2 : 0;
  } else if (p.rfind("bytelevel", 0) == 0) {
    st->pretok = 2;
    st->prefix = p.find(":prefix") != std::string::npos;
  } else if (p.rfind("llama3", 0) == 0) {
    st->pretok = 3;
  }
  t->bpe = std::move(st);
  return 0;
}

// Exact-BPE encode; requires yt_set_bpe. Returns ids written or -1 on
// capacity overflow.
int64_t yt_encode_bpe(YtTokenizer* t, const uint8_t* text, int64_t text_len,
                      int32_t* out, int64_t out_cap) {
  if (!t->bpe) return -2;
  const BpeState& st = *t->bpe;
  std::vector<int32_t> ids;
  ids.reserve((size_t)text_len + 8);
  int64_t i = 0, start = 0;
  while (i < text_len) {
    const std::pair<std::string, int32_t>* hit = nullptr;
    for (const auto& a : st.added) {  // longest-first
      const std::string& p = a.first;
      if (!p.empty() && i + (int64_t)p.size() <= text_len &&
          memcmp(text + i, p.data(), p.size()) == 0) {
        hit = &a;
        break;
      }
    }
    if (!hit) {
      i++;
      continue;
    }
    if (i > start)
      bpe::encode_segment(t, text + start, i - start, start == 0, &ids);
    ids.push_back(hit->second);
    i += (int64_t)hit->first.size();
    start = i;
  }
  if (start < text_len)
    bpe::encode_segment(t, text + start, text_len - start, start == 0,
                        &ids);
  if ((int64_t)ids.size() > out_cap) return -1;
  memcpy(out, ids.data(), ids.size() * sizeof(int32_t));
  return (int64_t)ids.size();
}

}  // extern "C"
