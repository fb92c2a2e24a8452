// A decoder of Zstandard frames (RFC 8878) for the host, in C++.
//
// Replaces no TPU kernel: the JAX package's orbax checkpoints hold their
// zarr chunks and OCDBT B-tree nodes as zstd frames, and neither the
// standard library nor the card's machine has a zstd decoder.
// train/ocdbt.py reads a checkpoint through this one; utils/zstd.py is its
// plain version, step for step the same, and the tests hold the two against
// each other and against the `zstandard` package.
//
// What bounds it: the host CPU, one thread.  Most of a checkpoint is float
// data, which zstd codes as Huffman literals, so the time goes to one table
// lookup per output byte (a peek of at most 11 bits of a backward bit
// stream); the output is written once, in place, so a match reaching into
// an earlier block of the frame is a copy inside the output.
//
// It decodes raw, RLE and compressed blocks; raw, RLE, Huffman (one or four
// streams) and treeless literals; literal-length, offset and match-length
// codes under predefined, RLE, FSE-compressed or repeated tables; the three
// repeat offsets; skippable frames; and the content checksum (XXH64).  A
// frame that needs a dictionary, or that is corrupt, is refused with a
// message naming the input byte where decoding failed.
//
// Plain C interface, built by ops/kernels/build.py with the host compiler
// (g++ -O2 -shared -fPIC) and loaded with ctypes by train/ocdbt.py.

#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include <string>
#include <vector>

namespace {

constexpr uint32_t MAGIC = 0xFD2FB528u;
constexpr uint32_t SKIP_LO = 0x184D2A50u, SKIP_HI = 0x184D2A5Fu;
constexpr size_t BLOCK_MAX = 128 * 1024;

struct Error {
  size_t offset;
  std::string reason;
  bool too_small;
};

[[noreturn]] void fail(size_t offset, const std::string& reason) {
  throw Error{offset, reason, false};
}

// ---------------------------------------------------------------------------
// XXH64
// ---------------------------------------------------------------------------

constexpr uint64_t P1 = 0x9E3779B185EBCA87ull, P2 = 0xC2B2AE3D27D4EB4Full,
                   P3 = 0x165667B19E3779F9ull, P4 = 0x85EBCA77C2B2AE63ull,
                   P5 = 0x27D4EB2F165667C5ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t rd64(const uint8_t* p) { uint64_t v; memcpy(&v, p, 8); return v; }
inline uint32_t rd32(const uint8_t* p) { uint32_t v; memcpy(&v, p, 4); return v; }
inline uint64_t xround(uint64_t acc, uint64_t lane) { return rotl(acc + lane * P2, 31) * P1; }

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    for (uint64_t v : {v1, v2, v3, v4}) h = (h ^ xround(0, v)) * P1 + P4;
  } else {
    h = seed + P5;
  }
  h += n;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ ((uint64_t)rd32(p) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
}

// ---------------------------------------------------------------------------
// bit streams
// ---------------------------------------------------------------------------

// bits [lo, lo + n) of the little-endian integer data[0, len), zeros past
// the end; n <= 32
inline uint32_t extract(const uint8_t* data, size_t len, int64_t lo, int n) {
  const size_t byte = (size_t)(lo >> 3);
  uint64_t w = 0;
  if (byte + 8 <= len) {
    memcpy(&w, data + byte, 8);
  } else {
    for (size_t i = 0; byte + i < len && i < 8; ++i) w |= (uint64_t)data[byte + i] << (8 * i);
  }
  return (uint32_t)((w >> (lo & 7)) & ((1ull << n) - 1));
}

// A backward bit stream (RFC 8878 4.1): read from the last byte down, most
// significant bit first, after the last byte's highest set bit; reads past
// the start give zeros and count as overflow.
struct Backward {
  const uint8_t* data;
  size_t len;
  int64_t pos;  // bits still unread: the stream's bits [0, pos)

  Backward(const uint8_t* d, size_t n, size_t offset) : data(d), len(n) {
    if (n == 0 || d[n - 1] == 0) fail(offset + (n ? n - 1 : 0), "bit stream without its end mark");
    int hb = 7;
    while (!((d[n - 1] >> hb) & 1)) --hb;
    pos = 8 * (int64_t)(n - 1) + hb;
  }
  uint32_t read(int n) {
    if (n == 0) return 0;
    const uint32_t v = peek(n);
    pos -= n;
    return v;
  }
  uint32_t peek(int n) const {
    const int64_t lo = pos - n;
    if (lo >= 0) return extract(data, len, lo, n);
    return pos > 0 ? extract(data, len, 0, (int)pos) << (int)(-lo) : 0;
  }
  bool overflowed() const { return pos < 0; }
  bool done() const { return pos == 0; }
};

// ---------------------------------------------------------------------------
// FSE
// ---------------------------------------------------------------------------

struct FseEntry {
  uint16_t symbol;
  uint8_t bits;
  uint16_t base;
};
using FseTable = std::vector<FseEntry>;

// An FSE table description at data[pos, end): normalized counts, accuracy
// log and the bytes it takes (RFC 8878 4.1.1).
size_t read_ncount(const uint8_t* data, size_t pos, size_t end, int max_symbol, int max_log,
                   std::vector<int>& counts, int& log) {
  const uint8_t* p = data + pos;
  const size_t len = end - pos;
  int64_t bit = 0;
  auto take = [&](int n) { const uint32_t v = extract(p, len, bit, n); bit += n; return v; };
  log = (int)take(4) + 5;
  if (log > max_log) fail(pos, "FSE accuracy log " + std::to_string(log) + " above " +
                                   std::to_string(max_log));
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  bool previous0 = false;
  counts.clear();
  while (remaining > 1 && (int)counts.size() <= max_symbol) {
    if (previous0) {
      size_t n0 = counts.size();
      for (;;) {
        const uint32_t flag = take(2);
        n0 += flag;
        if (flag != 3) break;
        if (bit > 8 * (int64_t)len) fail(pos, "FSE zero run past the end of the block");
      }
      if (n0 > (size_t)max_symbol + 1) fail(pos + bit / 8, "FSE zero run past the last symbol");
      counts.resize(n0, 0);
      if ((int)counts.size() > max_symbol) break;
    }
    const int mx = (2 * threshold - 1) - remaining;
    const int low = (int)extract(p, len, bit, nbits - 1) & (threshold - 1);
    int count;
    if (low < mx) {
      count = low;
      bit += nbits - 1;
    } else {
      count = (int)extract(p, len, bit, nbits) & (2 * threshold - 1);
      if (count >= threshold) count -= mx;
      bit += nbits;
    }
    --count;
    remaining -= count < 0 ? -count : count;
    counts.push_back(count);
    previous0 = count == 0;
    while (remaining < threshold) {
      --nbits;
      threshold >>= 1;
    }
  }
  if (remaining != 1 || (int)counts.size() > max_symbol + 1)
    fail(pos, "FSE table description does not sum to its size");
  const size_t size = (size_t)((bit + 7) / 8);
  if (size > len) fail(end, "FSE table description past the end of the block");
  return size;
}

FseTable fse_table(const std::vector<int>& counts, int log) {
  const int size = 1 << log;
  std::vector<uint16_t> symbols(size, 0);
  std::vector<uint32_t> next(counts.size(), 0);
  int high = size - 1;
  for (size_t s = 0; s < counts.size(); ++s) {
    if (counts[s] == -1) {
      symbols[high--] = (uint16_t)s;
      next[s] = 1;
    } else {
      next[s] = (uint32_t)counts[s];
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (size_t s = 0; s < counts.size(); ++s)
    for (int i = 0; i < counts[s]; ++i) {
      symbols[pos] = (uint16_t)s;
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  if (pos != 0) fail(0, "FSE spread did not return to state 0");
  FseTable table(size);
  for (int u = 0; u < size; ++u) {
    const uint16_t s = symbols[u];
    const uint32_t state = next[s]++;
    int hb = 31;
    while (!((state >> hb) & 1)) --hb;
    const int nb = log - hb;
    table[u] = FseEntry{s, (uint8_t)nb, (uint16_t)((state << nb) - size)};
  }
  return table;
}

struct FseState {
  const FseTable* table;
  uint32_t state;
  FseState(const FseTable& t, Backward& in) : table(&t) {
    int log = 0;
    while ((1u << log) < t.size()) ++log;
    state = in.read(log);
  }
  uint16_t symbol() const { return (*table)[state].symbol; }
  void update(Backward& in) {
    const FseEntry& e = (*table)[state];
    state = e.base + in.read(e.bits);
  }
};

const std::vector<int> LL_DEFAULT = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                     2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const std::vector<int> ML_DEFAULT = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const std::vector<int> OF_DEFAULT = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                     1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t LL_BASE[36] = {0,  1,  2,   3,   4,   5,   6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,  20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24,  25,  26,  27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41,  43,  47,  51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// ---------------------------------------------------------------------------
// Huffman
// ---------------------------------------------------------------------------

struct Huffman {
  std::vector<uint16_t> table;  // symbol | bits << 8, indexed by the next max_bits bits
  int max_bits = 0;
};

Huffman huffman_table(std::vector<int> weights, size_t offset) {
  uint32_t total = 0;
  for (int w : weights)
    if (w) total += 1u << (w - 1);
  if (total == 0) fail(offset, "Huffman weights all zero");
  int max_bits = 0;
  while ((1u << max_bits) <= total) ++max_bits;
  const uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) fail(offset, "Huffman weights leave no power of two for the last symbol");
  int last = 0;
  while ((1u << last) <= rest) ++last;
  weights.push_back(last);
  if (max_bits > 11) fail(offset, "Huffman codes of " + std::to_string(max_bits) + " bits (at most 11)");
  if (weights.size() > 256) fail(offset, "more than 256 Huffman symbols");
  std::vector<uint32_t> rank(max_bits + 1, 0), start(max_bits + 1, 0);
  for (int w : weights) {
    if (w > max_bits) fail(offset, "Huffman weight above the maximum code length");
    ++rank[w];
  }
  uint32_t next = 0;
  for (int w = 1; w <= max_bits; ++w) {
    start[w] = next;
    next += rank[w] << (w - 1);
  }
  Huffman h;
  h.max_bits = max_bits;
  h.table.assign(1u << max_bits, 0);
  for (size_t s = 0; s < weights.size(); ++s) {
    const int w = weights[s];
    if (!w) continue;
    const uint32_t n = 1u << (w - 1);
    const uint16_t entry = (uint16_t)(s | ((max_bits + 1 - w) << 8));
    for (uint32_t i = 0; i < n; ++i) h.table[start[w] + i] = entry;
    start[w] += n;
  }
  return h;
}

// A Huffman tree description at data[pos, end); returns the bytes it takes.
size_t read_huffman_tree(const uint8_t* data, size_t pos, size_t end, Huffman& out) {
  if (pos >= end) fail(pos, "Huffman tree description missing");
  const uint8_t header = data[pos];
  std::vector<int> weights;
  size_t size;
  if (header >= 128) {  // weights as 4-bit fields
    const int n = header - 127;
    size = 1 + (n + 1) / 2;
    if (pos + size > end) fail(pos, "Huffman weights past the literals section");
    for (int i = 0; i < n; ++i) {
      const uint8_t byte = data[pos + 1 + i / 2];
      weights.push_back(i % 2 == 0 ? byte >> 4 : byte & 15);
    }
  } else {  // FSE-compressed weights, two interleaved states
    size = 1 + header;
    if (pos + size > end) fail(pos, "Huffman weights past the literals section");
    std::vector<int> counts;
    int log;
    const size_t used = read_ncount(data, pos + 1, pos + size, 255, 6, counts, log);
    const FseTable table = fse_table(counts, log);
    Backward in(data + pos + 1 + used, size - 1 - used, pos + 1 + used);
    FseState s1(table, in), s2(table, in);
    for (;;) {
      weights.push_back(s1.symbol());
      s1.update(in);
      if (in.overflowed()) {
        weights.push_back(s2.symbol());
        break;
      }
      weights.push_back(s2.symbol());
      s2.update(in);
      if (in.overflowed()) {
        weights.push_back(s1.symbol());
        break;
      }
      if (weights.size() > 255) fail(pos, "more than 255 Huffman weights");
    }
  }
  out = huffman_table(weights, pos);
  return size;
}

void huffman_stream(const uint8_t* data, size_t n, size_t offset, const Huffman& h,
                    uint8_t* out, size_t count) {
  Backward in(data, n, offset);
  const int mb = h.max_bits;
  for (size_t i = 0; i < count; ++i) {
    const uint16_t e = h.table[in.peek(mb)];
    out[i] = (uint8_t)e;
    in.pos -= e >> 8;
  }
  if (!in.done()) fail(offset, "Huffman stream not consumed exactly");
}

// ---------------------------------------------------------------------------
// blocks and frames
// ---------------------------------------------------------------------------

struct FrameState {
  Huffman huffman;
  bool have_huffman = false;
  FseTable tables[3];  // ll, of, ml
  bool have[3] = {false, false, false};
  uint64_t rep[3] = {1, 4, 8};
};

struct Output {
  uint8_t* dst;
  size_t cap, len;
  void need(size_t n) {
    if (len + n > cap) throw Error{0, "output larger than the buffer", true};
  }
};

// The literals section at src[pos, end) into lits; returns the next position.
size_t literals(const uint8_t* src, size_t pos, size_t end, FrameState& st,
                std::vector<uint8_t>& lits) {
  if (pos >= end) fail(pos, "literals section missing");
  const uint8_t b0 = src[pos];
  const int kind = b0 & 3, fmt = (b0 >> 2) & 3;
  if (kind == 0 || kind == 1) {
    size_t size, hl;
    if (fmt == 0 || fmt == 2) {
      size = b0 >> 3;
      hl = 1;
    } else if (fmt == 1) {
      if (pos + 2 > end) fail(pos, "literals header past the end of the block");
      size = (b0 >> 4) + ((size_t)src[pos + 1] << 4);
      hl = 2;
    } else {
      if (pos + 3 > end) fail(pos, "literals header past the end of the block");
      size = (b0 >> 4) + ((size_t)src[pos + 1] << 4) + ((size_t)src[pos + 2] << 12);
      hl = 3;
    }
    pos += hl;
    if (size > BLOCK_MAX) fail(pos, std::to_string(size) + " literals in one block");
    if (kind == 0) {
      if (pos + size > end) fail(pos, "raw literals past the end of the block");
      lits.assign(src + pos, src + pos + size);
      return pos + size;
    }
    if (pos >= end) fail(pos, "RLE literals byte missing");
    lits.assign(size, src[pos]);
    return pos + 1;
  }
  const int hl = fmt == 2 ? 4 : (fmt == 3 ? 5 : 3);
  const int bits = fmt == 2 ? 14 : (fmt == 3 ? 18 : 10);
  if (pos + hl > end) fail(pos, "literals header past the end of the block");
  uint64_t h = 0;
  for (int i = 0; i < hl; ++i) h |= (uint64_t)src[pos + i] << (8 * i);
  const size_t size = (h >> 4) & ((1u << bits) - 1);
  const size_t csize = (h >> (4 + bits)) & ((1u << bits) - 1);
  const int streams = fmt == 0 ? 1 : 4;
  pos += hl;
  if (pos + csize > end) fail(pos, "compressed literals past the end of the block");
  if (size > BLOCK_MAX) fail(pos, std::to_string(size) + " literals in one block");
  const size_t lit_end = pos + csize;
  if (kind == 2) {
    pos += read_huffman_tree(src, pos, lit_end, st.huffman);
    st.have_huffman = true;
  } else if (!st.have_huffman) {
    fail(pos, "treeless literals with no earlier Huffman tree");
  }
  lits.resize(size);
  if (streams == 1) {
    huffman_stream(src + pos, lit_end - pos, pos, st.huffman, lits.data(), size);
    return lit_end;
  }
  if (pos + 6 > lit_end) fail(pos, "literals jump table past the end");
  int64_t sizes[4];
  int64_t sum = 0;
  for (int i = 0; i < 3; ++i) {
    sizes[i] = src[pos + 2 * i] | (src[pos + 2 * i + 1] << 8);
    sum += sizes[i];
  }
  pos += 6;
  sizes[3] = (int64_t)(lit_end - pos) - sum;
  if (sizes[3] < 0) fail(pos, "literals jump table beyond the streams");
  const size_t seg = (size + 3) / 4;
  if (3 * seg > size) fail(pos, "literal count too small for four streams");
  size_t done = 0;
  for (int i = 0; i < 4; ++i) {
    const size_t count = i < 3 ? seg : size - 3 * seg;
    huffman_stream(src + pos, (size_t)sizes[i], pos, st.huffman, lits.data() + done, count);
    pos += (size_t)sizes[i];
    done += count;
  }
  return lit_end;
}

size_t sequence_table(int which, int mode, const uint8_t* src, size_t pos, size_t end,
                      FrameState& st) {
  static const int max_symbol[3] = {35, 31, 52}, max_log[3] = {9, 8, 9};
  static const char* names[3] = {"ll", "of", "ml"};
  if (mode == 0) {
    static const FseTable defaults[3] = {fse_table(LL_DEFAULT, 6), fse_table(OF_DEFAULT, 5),
                                         fse_table(ML_DEFAULT, 6)};
    st.tables[which] = defaults[which];
  } else if (mode == 1) {
    if (pos >= end) fail(pos, "RLE code missing");
    if (src[pos] > max_symbol[which])
      fail(pos, std::string("RLE ") + names[which] + " code " + std::to_string(src[pos]) +
                    " above " + std::to_string(max_symbol[which]));
    st.tables[which] = FseTable{FseEntry{src[pos], 0, 0}};
    ++pos;
  } else if (mode == 2) {
    std::vector<int> counts;
    int log;
    pos += read_ncount(src, pos, end, max_symbol[which], max_log[which], counts, log);
    st.tables[which] = fse_table(counts, log);
  } else if (!st.have[which]) {
    fail(pos, std::string("repeated ") + names[which] + " table with none before it");
  }
  st.have[which] = true;
  return pos;
}

void block(const uint8_t* src, size_t pos, size_t end, Output& out, size_t frame_start,
           FrameState& st, std::vector<uint8_t>& lits) {
  pos = literals(src, pos, end, st, lits);
  if (pos >= end) fail(pos, "sequences section missing");
  const uint8_t b0 = src[pos];
  size_t nseq;
  if (b0 < 128) {
    nseq = b0;
    pos += 1;
  } else if (b0 < 255) {
    if (pos + 2 > end) fail(pos, "sequence count past the end of the block");
    nseq = ((size_t)(b0 - 128) << 8) + src[pos + 1];
    pos += 2;
  } else {
    if (pos + 3 > end) fail(pos, "sequence count past the end of the block");
    nseq = src[pos + 1] + ((size_t)src[pos + 2] << 8) + 0x7F00;
    pos += 3;
  }
  const size_t start_len = out.len;
  if (nseq == 0) {
    if (pos != end) fail(pos, "bytes after a block with no sequences");
    out.need(lits.size());
    memcpy(out.dst + out.len, lits.data(), lits.size());
    out.len += lits.size();
    return;
  }
  if (pos >= end) fail(pos, "sequence modes missing");
  const uint8_t modes = src[pos];
  if (modes & 3) fail(pos, "reserved bits of the sequence modes set");
  ++pos;
  pos = sequence_table(0, (modes >> 6) & 3, src, pos, end, st);
  pos = sequence_table(1, (modes >> 4) & 3, src, pos, end, st);
  pos = sequence_table(2, (modes >> 2) & 3, src, pos, end, st);
  if (pos >= end) fail(pos, "sequence bit stream missing");
  Backward in(src + pos, end - pos, pos);
  FseState ll(st.tables[0], in), of(st.tables[1], in), ml(st.tables[2], in);
  uint64_t* rep = st.rep;
  size_t lit_pos = 0;
  for (size_t i = 0; i < nseq; ++i) {
    const int of_code = of.symbol(), ml_code = ml.symbol(), ll_code = ll.symbol();
    if (ml_code > 52 || ll_code > 35 || of_code > 31) fail(pos, "sequence code out of range");
    const uint64_t offset_value = (1ull << of_code) + in.read(of_code);
    const size_t match = ML_BASE[ml_code] + in.read(ML_BITS[ml_code]);
    const size_t lit_len = LL_BASE[ll_code] + in.read(LL_BITS[ll_code]);
    uint64_t dist;
    if (offset_value > 3) {
      dist = offset_value - 3;
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = dist;
    } else {
      const int idx = (int)offset_value + (lit_len == 0);
      if (idx == 1) {
        dist = rep[0];
      } else if (idx == 2) {
        dist = rep[1];
        rep[1] = rep[0];
        rep[0] = dist;
      } else if (idx == 3) {
        dist = rep[2];
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = dist;
      } else {
        dist = rep[0] - 1;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = dist;
      }
    }
    if (i + 1 < nseq) {
      ll.update(in);
      ml.update(in);
      of.update(in);
    }
    if (in.overflowed()) fail(pos, "sequence bit stream overrun");
    if (lit_pos + lit_len > lits.size()) fail(pos, "a sequence takes more literals than the block has");
    out.need(lit_len + match);
    memcpy(out.dst + out.len, lits.data() + lit_pos, lit_len);
    out.len += lit_len;
    lit_pos += lit_len;
    if (dist == 0 || dist > out.len - frame_start)
      fail(pos, "match offset " + std::to_string((long long)dist) + " outside the frame's output");
    uint8_t* o = out.dst + out.len;
    const uint8_t* from = o - dist;
    if (dist >= match) {
      memcpy(o, from, match);
    } else {
      for (size_t k = 0; k < match; ++k) o[k] = from[k];
    }
    out.len += match;
  }
  if (!in.done()) fail(pos, "sequence bit stream not consumed exactly");
  const size_t rest = lits.size() - lit_pos;
  out.need(rest);
  memcpy(out.dst + out.len, lits.data() + lit_pos, rest);
  out.len += rest;
  if (out.len - start_len > BLOCK_MAX) fail(pos, "block decodes to more than 128 KiB");
}

uint64_t le(const uint8_t* p, int n) {
  uint64_t v = 0;
  for (int i = 0; i < n; ++i) v |= (uint64_t)p[i] << (8 * i);
  return v;
}

// The frame header at src[pos, n) (after the magic): fills the header's
// fields and returns the position after it.
struct Header {
  bool checksum;
  bool has_content;
  uint64_t content, window;
};

size_t frame_header(const uint8_t* src, size_t n, size_t pos, Header& h) {
  if (pos >= n) fail(pos, "frame header missing");
  const uint8_t fhd = src[pos];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, dict_flag = fhd & 3;
  h.checksum = (fhd >> 2) & 1;
  if (fhd & 8) fail(pos, "reserved bit of the frame header set");
  ++pos;
  h.window = 0;
  if (!single) {
    if (pos >= n) fail(pos, "window descriptor missing");
    const uint8_t wd = src[pos++];
    const uint64_t base = 1ull << (10 + (wd >> 3));
    h.window = base + (base >> 3) * (wd & 7);
  }
  static const int dict_sizes[4] = {0, 1, 2, 4};
  const int dict_size = dict_sizes[dict_flag];
  if (pos + dict_size > n) fail(pos, "dictionary id past the end of the input");
  if (dict_size && le(src + pos, dict_size)) fail(pos, "frame needs a dictionary");
  pos += dict_size;
  const int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : (fcs_flag == 1 ? 2 : (fcs_flag == 2 ? 4 : 8));
  h.has_content = fcs_size > 0;
  h.content = 0;
  if (fcs_size) {
    if (pos + fcs_size > n) fail(pos, "frame content size past the end of the input");
    h.content = le(src + pos, fcs_size) + (fcs_size == 2 ? 256 : 0);
    pos += fcs_size;
  }
  if (single) h.window = h.content;
  return pos;
}

size_t frame(const uint8_t* src, size_t n, size_t pos, Output& out) {
  Header h;
  pos = frame_header(src, n, pos, h);
  const size_t block_max = h.window < BLOCK_MAX ? (size_t)h.window : BLOCK_MAX;
  const size_t start = out.len;
  FrameState st;
  std::vector<uint8_t> lits;
  lits.reserve(BLOCK_MAX);
  for (;;) {
    if (pos + 3 > n) fail(pos, "block header past the end of the input");
    const uint32_t bh = (uint32_t)le(src + pos, 3);
    const int last = bh & 1, kind = (bh >> 1) & 3;
    const size_t size = bh >> 3;
    pos += 3;
    if (kind == 3) fail(pos - 3, "reserved block type");
    if (kind == 1) {
      if (pos >= n) fail(pos, "RLE block byte missing");
      if (size > block_max) fail(pos - 3, "RLE block of " + std::to_string(size) + " bytes above " +
                                               std::to_string(block_max));
      out.need(size);
      memset(out.dst + out.len, src[pos], size);
      out.len += size;
      pos += 1;
    } else {
      if (size > block_max || pos + size > n)
        fail(pos - 3, "block of " + std::to_string(size) + " bytes past the input or above " +
                          std::to_string(block_max));
      if (kind == 0) {
        out.need(size);
        memcpy(out.dst + out.len, src + pos, size);
        out.len += size;
      } else {
        block(src, pos, pos + size, out, start, st, lits);
      }
      pos += size;
    }
    if (last) break;
  }
  if (h.has_content && out.len - start != h.content)
    fail(pos, "frame decodes to " + std::to_string(out.len - start) + " bytes, its header says " +
                  std::to_string(h.content));
  if (h.checksum) {
    if (pos + 4 > n) fail(pos, "content checksum past the end of the input");
    const uint32_t want = (uint32_t)le(src + pos, 4);
    if ((uint32_t)xxh64(out.dst + start, out.len - start, 0) != want)
      fail(pos, "content checksum mismatch");
    pos += 4;
  }
  return pos;
}

void write_error(char* err, size_t cap, const Error& e) {
  if (err == nullptr || cap == 0) return;
  snprintf(err, cap, "zstd: corrupt or unsupported frame at byte %zu: %s", e.offset,
           e.reason.c_str());
}

}  // namespace

extern "C" {

// Decodes every frame of src[0, n) (skippable frames skipped) into
// dst[0, cap); *written gets the bytes written.  Returns 0; 1 for a corrupt
// or unsupported frame, with the message in err; 2 when the output does not
// fit in cap.
int ftc_zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap,
                        size_t* written, char* err, size_t err_cap) {
  Output out{dst, cap, 0};
  try {
    if (n == 0) fail(0, "no frame");
    size_t pos = 0;
    while (pos < n) {
      if (pos + 4 > n) fail(pos, "truncated magic number");
      const uint32_t magic = (uint32_t)le(src + pos, 4);
      if (magic >= SKIP_LO && magic <= SKIP_HI) {
        if (pos + 8 > n) fail(pos, "truncated skippable frame");
        const uint64_t size = le(src + pos + 4, 4);
        if (pos + 8 + size > n) fail(pos, "skippable frame past the end of the input");
        pos += 8 + size;
        continue;
      }
      if (magic != MAGIC) {
        char hex[16];
        snprintf(hex, sizeof hex, "%#010x", magic);
        fail(pos, std::string("bad magic number ") + hex);
      }
      pos = frame(src, n, pos + 4, out);
    }
  } catch (const Error& e) {
    *written = out.len;
    write_error(err, err_cap, e);
    return e.too_small ? 2 : 1;
  } catch (const std::exception& e) {
    *written = out.len;
    write_error(err, err_cap, Error{0, e.what(), false});
    return 1;
  }
  *written = out.len;
  return 0;
}

// The content size every frame of src[0, n) declares, summed; -1 if a
// frame declares none or the input is not a sequence of frames.
long long ftc_zstd_content_size(const uint8_t* src, size_t n) {
  try {
    size_t pos = 0;
    long long total = 0;
    while (pos < n) {
      if (pos + 4 > n) return -1;
      const uint32_t magic = (uint32_t)le(src + pos, 4);
      if (magic >= SKIP_LO && magic <= SKIP_HI) {
        if (pos + 8 > n) return -1;
        pos += 8 + le(src + pos + 4, 4);
        continue;
      }
      if (magic != MAGIC) return -1;
      Header h;
      pos = frame_header(src, n, pos + 4, h);
      if (!h.has_content) return -1;
      total += (long long)h.content;
      for (;;) {  // walk the blocks to the next frame
        if (pos + 3 > n) return -1;
        const uint32_t bh = (uint32_t)le(src + pos, 3);
        pos += 3 + (((bh >> 1) & 3) == 1 ? 1 : (bh >> 3));
        if (bh & 1) break;
      }
      pos += h.checksum ? 4 : 0;
    }
    return total;
  } catch (...) {
    return -1;
  }
}

uint64_t ftc_xxh64(const uint8_t* p, size_t n, uint64_t seed) { return xxh64(p, n, seed); }

}  // extern "C"
