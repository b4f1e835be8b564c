// container_writer — the metadata of an MHTC container, written in C++:
// the table section and the sub-stream unit index of
// mhc_tpu_torch/container.py's build_container, byte for byte.
//
// The writer picks each section's form by size: the Markov tables raw or
// entropy-coded (packed only when strictly shorter), the unit index as
// the first shortest of the flat bit-packed index, the entropy-coded
// index and the grouped index at each group size. Every candidate's size
// follows from a histogram and its code lengths (entropy forms) or from
// each group's (min, max) (bit-packed forms), so the candidates are sized
// first and only the chosen one is written.
//
// Code lengths come from mhc_code_lengths (native/mhc_host.cpp), the
// builder the codec's tables use; utils/native.py compiles the three
// files into one library. The canonical codes are assigned here, as
// mhc_codec.cpp's canon_codes_ctx does, since its exported form
// (mhc_build_enc_table) asks the system for its thread count on every
// call, which costs more than the whole code when the call is cold.

#include <cstdint>
#include <cstring>

extern "C" void mhc_code_lengths(const int32_t* counts, int64_t nctx,
                                 int32_t max_len, uint8_t* out);

namespace {

constexpr int kMaxLen = 15;      // the metadata codes' longest code
constexpr int64_t kU16 = 65535;  // a base is stored as u16

// An order-0 canonical Huffman code of a (256,) histogram: the code
// lengths, the right-aligned codes and the coded stream's bit count.
struct Code {
  uint8_t len[256];
  uint32_t code[256];
  int64_t bits;
};

void make_code(const int64_t* hist, Code* c) {
  int32_t counts[256];
  for (int s = 0; s < 256; ++s) counts[s] = (int32_t)hist[s];
  mhc_code_lengths(counts, 1, kMaxLen, c->len);
  // canonical: codes ascend with (length, symbol), DEFLATE's numbering
  int per_len[kMaxLen + 1] = {0};
  for (int s = 0; s < 256; ++s)
    if (c->len[s]) ++per_len[c->len[s]];
  uint32_t next[kMaxLen + 1] = {0};
  for (int l = 1; l <= kMaxLen; ++l)
    next[l] = (next[l - 1] + (uint32_t)per_len[l - 1]) << 1;
  c->bits = 0;
  for (int s = 0; s < 256; ++s) {
    c->code[s] = c->len[s] ? next[c->len[s]]++ : 0;
    c->bits += hist[s] * c->len[s];
  }
}

// MSB-first bit writer, zero-padded to a whole byte. Each put stores the
// next 8 bytes whole, its partly filled byte in, with no branch: the
// buffer holds 8 bytes past the stream's end, and a put is 1 to 32 bits.
struct BitWriter {
  uint8_t* out;
  uint64_t acc = 0;
  int n = 0;  // bits of the partly filled byte at `out`, under 8
  void put(uint32_t code, int len) {
    acc = (acc << len) | code;
    n += len;
    uint64_t be = __builtin_bswap64(acc << (64 - n));
    std::memcpy(out, &be, 8);
    out += n >> 3;
    n &= 7;
  }
  uint8_t* end() const { return out + (n > 0); }
};

uint8_t* put_u32(uint8_t* p, uint32_t v) {
  for (int i = 0; i < 4; ++i) *p++ = (uint8_t)(v >> (8 * i));
  return p;
}

uint8_t* put_base(uint8_t* p, int64_t base, int nbits) {
  *p++ = (uint8_t)base;
  *p++ = (uint8_t)(base >> 8);
  *p++ = (uint8_t)nbits;
  return p;
}

// The nibble-packed lengths of a code: symbol 2i in the low nibble.
uint8_t* put_nibbles(uint8_t* p, const uint8_t* len, int n) {
  for (int i = 0; i < n; i += 2) *p++ = (uint8_t)(len[i] | (len[i + 1] << 4));
  return p;
}

int bit_length(uint64_t x) { return x ? 64 - __builtin_clzll(x) : 0; }

// `v`'s residuals over `base`, `nbits` each, LSB-first; returns the end
// of the ceil(n * nbits / 8) bytes written.
uint8_t* put_residuals(uint8_t* p, const int64_t* v, int64_t n,
                       int64_t base, int nbits) {
  unsigned __int128 acc = 0;  // holds up to 7 + 64 bits
  int k = 0;
  for (int64_t i = 0; i < n; ++i) {
    acc |= (unsigned __int128)(uint64_t)(v[i] - base) << k;
    for (k += nbits; k >= 8; k -= 8, acc >>= 8) *p++ = (uint8_t)acc;
  }
  if (k) *p++ = (uint8_t)acc;
  return p;
}

struct MinMax {
  int64_t lo, hi;
};

MinMax min_max(const int64_t* v, int64_t n) {
  MinMax m{v[0], v[0]};
  for (int64_t i = 1; i < n; ++i) {
    if (v[i] < m.lo) m.lo = v[i];
    if (v[i] > m.hi) m.hi = v[i];
  }
  return m;
}

// Bytes of the grouped index at group size g; -1 where a group's base
// does not fit its u16.
int64_t grouped_size(const int64_t* v, int64_t n, int64_t g) {
  int64_t size = 4;
  for (int64_t s = 0; s < n; s += g) {
    int64_t gn = n - s < g ? n - s : g;
    MinMax m = min_max(v + s, gn);
    if (m.lo > kU16) return -1;
    size += 3 + (gn * bit_length((uint64_t)(m.hi - m.lo)) + 7) / 8;
  }
  return size;
}

}  // namespace

extern "C" {

// The table section. Markov (`markov` 1): the 32-byte context-presence
// bitmap, then the 256 lengths of each present context, nibble-packed
// (raw) or entropy-coded (packed: the 16 nibble code lengths in 8 bytes,
// then the stream), packed only when strictly shorter. Order-0: the 256
// lengths nibble-packed. `out` holds 32 + 128 * 256 + 8 bytes. Returns the
// bytes written and sets *packed; -1 where a length is over 15.
int64_t mhc_write_tables(int32_t markov, const uint8_t* lengths,
                         uint8_t* out, int32_t* packed) {
  *packed = 0;
  if (!markov) {
    for (int s = 0; s < 256; ++s)
      if (lengths[s] > kMaxLen) return -1;
    return put_nibbles(out, lengths, 256) - out;
  }
  // one pass over each row: its OR tells presence and a length over 15;
  // four histograms of the nibbles keep the increments independent
  std::memset(out, 0, 32);
  int64_t quarter[4][16] = {};
  int npresent = 0;
  for (int c = 0; c < 256; ++c) {
    const uint8_t* row = lengths + c * 256;
    uint8_t any = 0;
    for (int s = 0; s < 256; ++s) any |= row[s];
    if (any > kMaxLen) return -1;
    if (!any) continue;
    out[c >> 3] |= (uint8_t)(1 << (c & 7));
    ++npresent;
    for (int s = 0; s < 256; s += 4)
      for (int q = 0; q < 4; ++q) ++quarter[q][row[s + q]];
  }
  int64_t hist[256] = {0};
  for (int v = 0; v < 16; ++v)
    hist[v] = quarter[0][v] + quarter[1][v] + quarter[2][v] + quarter[3][v];
  Code code;
  make_code(hist, &code);
  const int64_t raw_size = 32 + 128 * (int64_t)npresent;
  if (32 + 8 + (code.bits + 7) / 8 >= raw_size) {
    uint8_t* p = out + 32;
    for (int c = 0; c < 256; ++c)
      if ((out[c >> 3] >> (c & 7)) & 1)
        p = put_nibbles(p, lengths + c * 256, 256);
    return p - out;
  }
  *packed = 1;
  // the codes of two nibbles at a time: at most 2 * 15 bits
  uint32_t pair_code[256];
  uint8_t pair_len[256];
  for (int a = 0; a < 16; ++a)
    for (int b = 0; b < 16; ++b) {
      pair_code[a * 16 + b] = (code.code[a] << code.len[b]) | code.code[b];
      pair_len[a * 16 + b] = (uint8_t)(code.len[a] + code.len[b]);
    }
  BitWriter w{put_nibbles(out + 32, code.len, 16)};
  for (int c = 0; c < 256; ++c) {
    if (!((out[c >> 3] >> (c & 7)) & 1)) continue;
    const uint8_t* row = lengths + c * 256;
    for (int s = 0; s < 256; s += 2) {
      int pr = row[s] * 16 + row[s + 1];
      w.put(pair_code[pr], pair_len[pr]);
    }
  }
  return w.end() - out;
}

// The sub-stream unit index of `n` unit lengths, in the first shortest of
// these forms, whose number goes to *form: 0 the flat bit-packed index
// (u16 base, u8 nbits, the residuals), 1 the entropy-coded index (u16
// base, a byte set when a residual reaches 256, then the residuals' low
// and, if set, high bytes, each as 128 bytes of nibble code lengths, a
// u32 byte count and the stream), 2 + i the grouped index at `groups[i]`
// units a group (a u32 group size, then per group a u16 base, a u8 nbits
// and its residuals from a byte boundary). `out` holds 3 + 8 * n + 8
// bytes.
// Returns the bytes written; -1 where a length is negative or a base
// over 65535, which the format cannot hold.
int64_t mhc_write_index(const int64_t* lens, int64_t n,
                        const int64_t* groups, int32_t n_groups,
                        uint8_t* out, int32_t* form) {
  if (n == 0) {  // the flat form's 3 bytes are the least any form takes
    *form = 0;
    return put_base(out, 0, 0) - out;
  }
  const MinMax m = min_max(lens, n);
  if (m.lo < 0 || m.lo > kU16) return -1;
  const int nbits = bit_length((uint64_t)(m.hi - m.lo));
  int64_t best = 3 + (n * nbits + 7) / 8;
  *form = 0;
  const bool has_hi = m.hi - m.lo >= 256;
  int64_t hist_lo[256] = {0}, hist_hi[256] = {0};
  for (int64_t i = 0; i < n; ++i) {
    uint64_t r = (uint64_t)(lens[i] - m.lo);
    ++hist_lo[r & 255];
    ++hist_hi[(r >> 8) & 255];
  }
  Code lo, hi;
  make_code(hist_lo, &lo);
  int64_t size = 3 + 132 + (lo.bits + 7) / 8;
  if (has_hi) {
    make_code(hist_hi, &hi);
    size += 132 + (hi.bits + 7) / 8;
  }
  if (size < best) {
    best = size;
    *form = 1;
  }
  for (int32_t i = 0; i < n_groups; ++i) {
    size = grouped_size(lens, n, groups[i]);
    if (size < 0) return -1;
    if (size < best) {
      best = size;
      *form = 2 + i;
    }
  }
  uint8_t* p = out;
  if (*form == 0) {
    p = put_base(p, m.lo, nbits);
    return put_residuals(p, lens, n, m.lo, nbits) - out;
  }
  if (*form == 1) {
    p = put_base(p, m.lo, has_hi ? 1 : 0);
    for (int half = 0; half < (has_hi ? 2 : 1); ++half) {
      const Code& c = half ? hi : lo;
      p = put_u32(put_nibbles(p, c.len, 256), (uint32_t)((c.bits + 7) / 8));
      BitWriter w{p};
      for (int64_t i = 0; i < n; ++i) {
        uint8_t s = (uint8_t)((uint64_t)(lens[i] - m.lo) >> (8 * half));
        w.put(c.code[s], c.len[s]);
      }
      p = w.end();
    }
    return p - out;
  }
  const int64_t g = groups[*form - 2];
  p = put_u32(p, (uint32_t)g);
  for (int64_t s = 0; s < n; s += g) {
    int64_t gn = n - s < g ? n - s : g;
    MinMax gm = min_max(lens + s, gn);
    int gbits = bit_length((uint64_t)(gm.hi - gm.lo));
    p = put_residuals(put_base(p, gm.lo, gbits), lens + s, gn, gm.lo, gbits);
  }
  return p - out;
}

}  // extern "C"
