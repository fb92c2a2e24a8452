// Native JSONL → packed-token pipeline (the data-loader hot path), host C++.
//
// Parse a JSONL dataset, tokenize byte-level (exact parity with
// finetune_controller_tpu_torch/data/loader.py::_byte_tokenize, including
// \uXXXX escapes decoded to UTF-8), and pack everything into
// (n_blocks, seq_len) int32 token/segment/loss-flag arrays with per-document
// segment ids.
//
// Row schemas (parity with loader.load_token_documents, same precedence):
//   {"tokens": [...]}                        flags all 1
//   {"text": "..."}                          flags all 1
//   {"prompt_tokens": [], "completion_tokens": []}  completion-only flags
//   {"prompt": "...", "completion": "..."}   completion-only flags
//   {"messages": [{"role","content"}, ...]}  chat template <|role|>\ncontent\n,
//                                            assistant content (+\n) flagged
//
// Exposed as a tiny C ABI for ctypes:
//   ftc_pack_file(path, seq_len, &handle)        -> n_blocks (<0 = error)
//   ftc_copy_packed(handle, tokens, segs, flags) -> 0 on success
//   ftc_last_error()                             -> static error string
//   ftc_free(handle)
//
// Build: the host route of finetune_controller_tpu_torch/ops/kernels/build.py
// (g++ -std=c++17 -O2 -shared -fPIC), at first use.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;

struct Packed {
  std::vector<int32_t> tokens;
  std::vector<int32_t> segments;
  std::vector<int32_t> flags;  // 1 = position counts toward the loss
  int64_t n_blocks = 0;
  int64_t seq_len = 0;
};

// ---------------------------------------------------------------------------
// Minimal JSON value scanning (only what the row schema needs)
// ---------------------------------------------------------------------------

void append_utf8(std::string* out, uint32_t cp) {
  if (cp < 0x80) {
    out->push_back(static_cast<char>(cp));
  } else if (cp < 0x800) {
    out->push_back(static_cast<char>(0xC0 | (cp >> 6)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out->push_back(static_cast<char>(0xE0 | (cp >> 12)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else {
    out->push_back(static_cast<char>(0xF0 | (cp >> 18)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
}

int hex_val(char c) {
  if (c >= '0' && c <= '9') return c - '0';
  if (c >= 'a' && c <= 'f') return c - 'a' + 10;
  if (c >= 'A' && c <= 'F') return c - 'A' + 10;
  return -1;
}

// Parse the JSON string starting at s[i] == '"'; returns decoded UTF-8 bytes
// and advances i past the closing quote. False on malformed input.
bool parse_json_string(const std::string& s, size_t* i, std::string* out) {
  if (s[*i] != '"') return false;
  ++*i;
  out->clear();
  while (*i < s.size()) {
    char c = s[*i];
    if (c == '"') {
      ++*i;
      return true;
    }
    if (c == '\\') {
      if (*i + 1 >= s.size()) return false;
      char e = s[*i + 1];
      *i += 2;
      switch (e) {
        case '"': out->push_back('"'); break;
        case '\\': out->push_back('\\'); break;
        case '/': out->push_back('/'); break;
        case 'b': out->push_back('\b'); break;
        case 'f': out->push_back('\f'); break;
        case 'n': out->push_back('\n'); break;
        case 'r': out->push_back('\r'); break;
        case 't': out->push_back('\t'); break;
        case 'u': {
          if (*i + 4 > s.size()) return false;
          uint32_t cp = 0;
          for (int k = 0; k < 4; ++k) {
            int h = hex_val(s[*i + k]);
            if (h < 0) return false;
            cp = (cp << 4) | static_cast<uint32_t>(h);
          }
          *i += 4;
          if (cp >= 0xD800 && cp <= 0xDBFF && *i + 6 <= s.size() &&
              s[*i] == '\\' && s[*i + 1] == 'u') {
            uint32_t lo = 0;
            bool ok = true;
            for (int k = 0; k < 4; ++k) {
              int h = hex_val(s[*i + 2 + k]);
              if (h < 0) { ok = false; break; }
              lo = (lo << 4) | static_cast<uint32_t>(h);
            }
            if (ok && lo >= 0xDC00 && lo <= 0xDFFF) {
              cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
              *i += 6;
            }
          }
          append_utf8(out, cp);
          break;
        }
        default:
          return false;
      }
      continue;
    }
    out->push_back(c);
    ++*i;
  }
  return false;  // unterminated
}

// Find `"key"` at the object TOP LEVEL only and return the index just past
// the ':'. Depth is tracked so nested objects/arrays can't shadow the row
// schema (parity with the Python loader's `"tokens" in row` check, which is
// top-level dict membership).
bool find_key(const std::string& s, const char* key, size_t* value_start) {
  size_t i = 0;
  int depth = 0;
  while (i < s.size()) {
    char c = s[i];
    if (c == '{' || c == '[') {
      ++depth;
      ++i;
      continue;
    }
    if (c == '}' || c == ']') {
      --depth;
      ++i;
      continue;
    }
    if (c == '"') {
      std::string tmp;
      if (!parse_json_string(s, &i, &tmp)) return false;
      if (depth == 1 && tmp == key) {
        while (i < s.size() && (s[i] == ' ' || s[i] == '\t')) ++i;
        if (i < s.size() && s[i] == ':') {
          *value_start = i + 1;
          return true;
        }
      }
      continue;
    }
    ++i;
  }
  return false;
}

// Skip any JSON value starting at s[i] (string, number, object, array,
// literal); advances i past it. Used to pass over message keys we ignore.
bool skip_value(const std::string& s, size_t* i) {
  while (*i < s.size() && (s[*i] == ' ' || s[*i] == '\t')) ++*i;
  if (*i >= s.size()) return false;
  char c = s[*i];
  if (c == '"') {
    std::string tmp;
    return parse_json_string(s, i, &tmp);
  }
  if (c == '{' || c == '[') {
    int depth = 0;
    while (*i < s.size()) {
      char d = s[*i];
      if (d == '"') {
        std::string tmp;
        if (!parse_json_string(s, i, &tmp)) return false;
        continue;
      }
      if (d == '{' || d == '[') ++depth;
      if (d == '}' || d == ']') {
        --depth;
        if (depth == 0) { ++*i; return true; }
      }
      ++*i;
    }
    return false;
  }
  // number / true / false / null: scan to a structural delimiter
  while (*i < s.size() && s[*i] != ',' && s[*i] != '}' && s[*i] != ']' &&
         s[*i] != ' ' && s[*i] != '\t') {
    ++*i;
  }
  return true;
}

// Parse {"messages": [...]} starting at the array and render the fixed chat
// template (loader._render_chat): header "<|role|>\n" (masked) + content
// "\n" (flagged iff role == "assistant"). Byte-level tokens.
bool parse_messages(const std::string& s, size_t i,
                    std::vector<int32_t>* toks, std::vector<int32_t>* flags) {
  while (i < s.size() && (s[i] == ' ' || s[i] == '\t')) ++i;
  if (i >= s.size() || s[i] != '[') return false;
  ++i;
  toks->clear();
  flags->clear();
  // the closing ']' is REQUIRED: a truncated row (interrupted download cut
  // mid-array) must error like the Python loader's json.loads, not train
  bool closed = false;
  while (i < s.size()) {
    while (i < s.size() &&
           (s[i] == ' ' || s[i] == '\t' || s[i] == ',')) {
      ++i;
    }
    if (i < s.size() && s[i] == ']') {
      closed = true;
      break;
    }
    if (i >= s.size() || s[i] != '{') return false;  // must be an object
    ++i;
    std::string role = "user";  // loader default: msg.get("role", "user")
    std::string content;        // loader default: ""
    bool in_obj = true;
    while (in_obj && i < s.size()) {
      while (i < s.size() && (s[i] == ' ' || s[i] == '\t' || s[i] == ',')) ++i;
      if (i < s.size() && s[i] == '}') {
        ++i;
        in_obj = false;
        break;
      }
      std::string key;
      if (i >= s.size() || !parse_json_string(s, &i, &key)) return false;
      while (i < s.size() && (s[i] == ' ' || s[i] == '\t')) ++i;
      if (i >= s.size() || s[i] != ':') return false;
      ++i;
      while (i < s.size() && (s[i] == ' ' || s[i] == '\t')) ++i;
      if ((key == "role" || key == "content") && i < s.size() && s[i] == '"') {
        std::string val;
        if (!parse_json_string(s, &i, &val)) return false;
        if (key == "role") role = val;
        else content = val;
      } else {
        // non-string role/content (loader stringifies) or extra keys: the
        // Python path owns those rows
        if (key == "role" || key == "content") return false;
        if (!skip_value(s, &i)) return false;
      }
    }
    if (in_obj) return false;  // unterminated object
    std::string header = "<|" + role + "|>\n";
    for (unsigned char ch : header) {
      toks->push_back(ch);
      flags->push_back(0);
    }
    int32_t body_flag = role == "assistant" ? 1 : 0;
    content.push_back('\n');
    for (unsigned char ch : content) {
      toks->push_back(ch);
      flags->push_back(body_flag);
    }
  }
  return closed && !toks->empty();
}

bool parse_int_array(const std::string& s, size_t i, std::vector<int32_t>* out) {
  while (i < s.size() && (s[i] == ' ' || s[i] == '\t')) ++i;
  if (i >= s.size() || s[i] != '[') return false;
  ++i;
  out->clear();
  while (i < s.size()) {
    while (i < s.size() && (s[i] == ' ' || s[i] == '\t' || s[i] == ',')) ++i;
    if (i < s.size() && s[i] == ']') return true;
    bool neg = false;
    if (i < s.size() && s[i] == '-') { neg = true; ++i; }
    if (i >= s.size() || s[i] < '0' || s[i] > '9') return false;
    int64_t v = 0;
    while (i < s.size() && s[i] >= '0' && s[i] <= '9') {
      v = v * 10 + (s[i] - '0');
      ++i;
    }
    out->push_back(static_cast<int32_t>(neg ? -v : v));
  }
  return false;
}

}  // namespace

extern "C" {

const char* ftc_last_error() { return g_error.c_str(); }

// Returns n_blocks >= 1 on success and sets *out_handle; negative on error.
int64_t ftc_pack_file(const char* path, int64_t seq_len, void** out_handle) {
  g_error.clear();
  if (seq_len <= 0) {
    g_error = "seq_len must be positive";
    return -1;
  }
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    g_error = std::string("cannot open ") + path;
    return -2;
  }
  auto* packed = new Packed();
  packed->seq_len = seq_len;
  std::vector<int32_t>& stream = packed->tokens;
  std::vector<int32_t>& segs = packed->segments;

  std::vector<int32_t>& lflags = packed->flags;
  std::string line;
  std::vector<int32_t> tok_buf;
  std::vector<int32_t> tok_buf2;
  std::vector<int32_t> flag_buf;
  std::string text_buf;
  std::string text_buf2;
  int32_t doc_id = 0;
  char buf[1 << 16];
  line.reserve(1 << 16);
  bool pending = false;
  // all-ones flags (plain LM rows)
  auto flush_doc = [&](const std::vector<int32_t>& toks) {
    ++doc_id;
    stream.insert(stream.end(), toks.begin(), toks.end());
    segs.insert(segs.end(), toks.size(), doc_id);
    lflags.insert(lflags.end(), toks.size(), 1);
  };
  // explicit flags (SFT/chat rows)
  auto flush_doc_flags = [&](const std::vector<int32_t>& toks,
                             const std::vector<int32_t>& fl) {
    ++doc_id;
    stream.insert(stream.end(), toks.begin(), toks.end());
    segs.insert(segs.end(), toks.size(), doc_id);
    lflags.insert(lflags.end(), fl.begin(), fl.end());
  };
  auto parse_string_field = [&](const std::string& row, size_t vi,
                                std::string* out) -> bool {
    while (vi < row.size() && (row[vi] == ' ' || row[vi] == '\t')) ++vi;
    return parse_json_string(row, &vi, out);
  };
  auto process_line = [&]() -> bool {
    // trim
    size_t b = line.find_first_not_of(" \t\r\n");
    if (b == std::string::npos) return true;
    size_t e = line.find_last_not_of(" \t\r\n");
    std::string row = line.substr(b, e - b + 1);
    // schema precedence mirrors loader.load_token_documents exactly
    size_t vi = 0;
    if (find_key(row, "tokens", &vi)) {
      if (!parse_int_array(row, vi, &tok_buf)) {
        g_error = "malformed 'tokens' array: " + row.substr(0, 80);
        return false;
      }
      flush_doc(tok_buf);
      return true;
    }
    if (find_key(row, "text", &vi)) {
      while (vi < row.size() && (row[vi] == ' ' || row[vi] == '\t')) ++vi;
      if (!parse_json_string(row, &vi, &text_buf)) {
        g_error = "malformed 'text' string: " + row.substr(0, 80);
        return false;
      }
      tok_buf.clear();
      tok_buf.reserve(text_buf.size());
      for (unsigned char ch : text_buf) tok_buf.push_back(ch);
      flush_doc(tok_buf);
      return true;
    }
    size_t pi = 0, ci = 0;
    if (find_key(row, "prompt_tokens", &pi) &&
        find_key(row, "completion_tokens", &ci)) {
      if (!parse_int_array(row, pi, &tok_buf) ||
          !parse_int_array(row, ci, &tok_buf2)) {
        g_error = "malformed prompt/completion token arrays: " +
                  row.substr(0, 80);
        return false;
      }
      flag_buf.assign(tok_buf.size(), 0);
      flag_buf.insert(flag_buf.end(), tok_buf2.size(), 1);
      tok_buf.insert(tok_buf.end(), tok_buf2.begin(), tok_buf2.end());
      flush_doc_flags(tok_buf, flag_buf);
      return true;
    }
    if (find_key(row, "prompt", &pi) && find_key(row, "completion", &ci)) {
      if (!parse_string_field(row, pi, &text_buf) ||
          !parse_string_field(row, ci, &text_buf2)) {
        g_error = "malformed prompt/completion strings: " + row.substr(0, 80);
        return false;
      }
      tok_buf.clear();
      flag_buf.clear();
      for (unsigned char ch : text_buf) {
        tok_buf.push_back(ch);
        flag_buf.push_back(0);
      }
      for (unsigned char ch : text_buf2) {
        tok_buf.push_back(ch);
        flag_buf.push_back(1);
      }
      flush_doc_flags(tok_buf, flag_buf);
      return true;
    }
    if (find_key(row, "messages", &vi)) {
      if (!parse_messages(row, vi, &tok_buf, &flag_buf)) {
        g_error = "unsupported 'messages' row (the Python loader owns it): " +
                  row.substr(0, 80);
        return false;
      }
      bool any = false;
      for (int32_t f : flag_buf) any |= (f != 0);
      if (!any) {
        // parity with the Python loader's wrong-role footgun check — the
        // caller falls back and the Python path raises the detailed error
        g_error = "chat row produced no assistant-content tokens: " +
                  row.substr(0, 80);
        return false;
      }
      flush_doc_flags(tok_buf, flag_buf);
      return true;
    }
    g_error =
        "jsonl rows must have 'tokens', 'text', 'prompt'/'completion', "
        "or 'messages' fields";
    return false;
  };

  while (std::fgets(buf, sizeof(buf), f)) {
    line.append(buf);
    pending = true;
    if (!line.empty() && line.back() == '\n') {
      if (!process_line()) {
        std::fclose(f);
        delete packed;
        return -3;
      }
      line.clear();
      pending = false;
    }
  }
  std::fclose(f);
  if (pending && !process_line()) {
    delete packed;
    return -3;
  }
  if (doc_id == 0) {
    g_error = "no documents found";
    delete packed;
    return -4;
  }

  // block math identical to data/loader.py::pack_documents
  int64_t n_blocks = static_cast<int64_t>(stream.size()) / seq_len;
  if (n_blocks < 1) n_blocks = 1;
  if (static_cast<int64_t>(stream.size()) < seq_len) {
    stream.resize(seq_len, 0);
    segs.resize(seq_len, 0);
    lflags.resize(seq_len, 0);
  }
  stream.resize(n_blocks * seq_len);
  segs.resize(n_blocks * seq_len);
  lflags.resize(n_blocks * seq_len);
  packed->n_blocks = n_blocks;
  *out_handle = packed;
  return n_blocks;
}

int32_t ftc_copy_packed(void* handle, int32_t* tokens, int32_t* segments,
                        int32_t* flags) {
  auto* p = static_cast<Packed*>(handle);
  if (!p) return -1;
  std::memcpy(tokens, p->tokens.data(), p->tokens.size() * sizeof(int32_t));
  std::memcpy(segments, p->segments.data(), p->segments.size() * sizeof(int32_t));
  std::memcpy(flags, p->flags.data(), p->flags.size() * sizeof(int32_t));
  return 0;
}

void ftc_free(void* handle) { delete static_cast<Packed*>(handle); }

}  // extern "C"
