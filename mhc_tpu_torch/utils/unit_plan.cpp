// unit_plan — the engine's per-unit host plan, one pass each way:
// mhc_tpu_torch/engine.py's encode plan (the literal rule on the fetched
// bit counts, the container's stream lengths, the word offsets and the
// literal flags) and its decode plan (the unit length checks, each
// unit's stream length, the offsets, the literal mask from the container
// layout, the symbols to decode and the literal rows).
//
// Each output is the value the container format's rules give
// (docs/FORMAT.md; tests/test_torch_plan.py states them in numpy).
// Divisions by powers of two are arithmetic right shifts of int64, which
// floor as Python's // does, negative values included. The engine hands
// the offsets, flags, counts and rows their places in its one upload
// buffer, so nothing is copied after the pass.

#include <cstdint>

namespace {

// -(-a // 2**k): Python's ceiling division by a power of two.
inline int64_t ceil_shift(int64_t a, int k) { return -((-a) >> k); }

// The loops below keep each unit's valid bytes as `rest` = orig_len - i *
// du clamped to [0, du] (engine.host_n_valid) and pick every value
// without a branch: they are compiled once per layout and rule, and a
// literal's row is written whether or not it counts.

template <bool kAligned, bool kLiteral>
int64_t plan_encode(const int32_t* __restrict__ bits, int64_t n_units,
                    int64_t orig_len, int64_t du,
                    int64_t* __restrict__ bit_lens,
                    int64_t* __restrict__ byte_lens,
                    int64_t* __restrict__ bounds,
                    uint8_t* __restrict__ literal) {
  int64_t total = 0, rest = orig_len;
  bounds[0] = 0;
  for (int64_t i = 0; i < n_units; ++i, rest -= du) {
    const int64_t b = bits[i];
    const int64_t nv = rest < 0 ? 0 : (rest > du ? du : rest);
    const bool raw =
        kLiteral && (kAligned ? ((b + 31) >> 5) >= ((nv + 3) >> 2)
                              : ((b + 7) >> 3) >= nv);
    const int64_t bl = raw ? nv * 8 : b;
    const int64_t words = (bl + 31) >> 5;
    bit_lens[i] = bl;
    byte_lens[i] = kAligned ? words * 4 : (bl + 7) >> 3;
    total += words;
    bounds[i + 1] = total;
    literal[i] = raw;
  }
  return total;
}

// kLens: 0 words from the bits of a result, 1 stored bytes / 4 (parsed
// aligned), 2 stored bytes (parsed unaligned).
template <bool kAligned, bool kLiteral, int kLens>
int64_t plan_decode(const int64_t* __restrict__ byte_lens,
                    const int64_t* __restrict__ bit_lens, int64_t n_units,
                    int64_t orig_len, int64_t du, int64_t worst,
                    int64_t* __restrict__ bounds, int32_t* __restrict__ n_dec,
                    int64_t* __restrict__ rows, int64_t* __restrict__ width) {
  // the fewest stored bytes of m symbols at one bit each; m is du but in
  // the last unit, which holds orig_len - (n_units - 1) * du
  auto least_of = [](int64_t m) {
    return kAligned ? 4 * ceil_shift(m, 5) : ceil_shift(m, 3);
  };
  const int64_t least = least_of(du);
  const int64_t least_last = least_of(orig_len - (n_units - 1) * du);
  int64_t total = 0, longest = 0, n_raw = 0, rest = orig_len;
  bool bad = false;
  bounds[0] = 0;
  for (int64_t i = 0; i < n_units; ++i, rest -= du) {
    const int64_t sl = byte_lens[i];
    bad |= (sl > worst) | (sl < (i + 1 < n_units ? least : least_last));
    const int64_t len = kLens == 0   ? (bit_lens[i] + 31) >> 5
                        : kLens == 1 ? sl >> 2
                                     : sl;
    longest = i == 0 || len > longest ? len : longest;
    total += len;
    bounds[i + 1] = total;
    const int64_t nv = rest < 0 ? 0 : (rest > du ? du : rest);
    const bool raw = kLiteral && nv > 0 &&
                     sl == (kAligned ? ((nv + 3) >> 2) * 4 : nv);
    n_dec[i] = raw ? 0 : (int32_t)nv;
    rows[n_raw] = i;
    n_raw += raw;
  }
  if (bad) return -1;
  *width = n_units == 0 ? 1 : kLens == 2 ? ceil_shift(longest, 2) + 1
                                         : longest + 1;
  return n_raw;
}

template <bool kAligned, bool kLiteral>
int64_t plan_decode_lens(const int64_t* byte_lens, const int64_t* bit_lens,
                         int64_t n_units, int64_t orig_len, int64_t du,
                         int64_t worst, int64_t* bounds, int32_t* n_dec,
                         int64_t* rows, int64_t* width) {
  if (bit_lens)
    return plan_decode<kAligned, kLiteral, 0>(byte_lens, bit_lens, n_units,
                                              orig_len, du, worst, bounds,
                                              n_dec, rows, width);
  if (kAligned)
    return plan_decode<kAligned, kLiteral, 1>(byte_lens, bit_lens, n_units,
                                              orig_len, du, worst, bounds,
                                              n_dec, rows, width);
  return plan_decode<kAligned, kLiteral, 2>(byte_lens, bit_lens, n_units,
                                            orig_len, du, worst, bounds,
                                            n_dec, rows, width);
}

}  // namespace

extern "C" {

// The encode plan of `n_units` units from their coded bit counts `bits`.
// With `literal_rule` set (decode units are substreams of a block), a
// unit is a literal where its coded stream takes at least as much of the
// container layout as its bytes (bitpack.literal_unit_mask: words where
// `aligned`, else bytes); a row past the end (n_valid 0) is then a
// literal of 0 bits, as the decode side's n_valid > 0 test expects.
// Writes each unit's bit length (n_valid * 8 for a literal), its stream
// bytes in the container layout (container.stream_byte_lens), the
// (n_units + 1,) word offsets with the total last, and the literal flags
// (0 or 1). Returns the total words.
int64_t mhc_plan_encode(const int32_t* bits, int64_t n_units,
                        int64_t orig_len, int64_t du, int32_t literal_rule,
                        int32_t aligned, int64_t* bit_lens,
                        int64_t* byte_lens, int64_t* bounds,
                        uint8_t* literal) {
  auto run = aligned ? (literal_rule ? plan_encode<true, true>
                                     : plan_encode<true, false>)
                     : (literal_rule ? plan_encode<false, true>
                                     : plan_encode<false, false>);
  return run(bits, n_units, orig_len, du, bit_lens, byte_lens, bounds,
             literal);
}

// The decode plan of `n_units` units of a container layout (`aligned`:
// word-aligned streams) from their stored bytes `byte_lens`, and from
// their bit lengths `bit_lens` where the units are an encode's result
// (else null). Returns -1 where a unit's stored bytes lie outside what
// the encoder can write (engine.check_unit_lengths): above `worst`, or
// below what its symbols take at one bit each. Else writes the
// (n_units + 1,) offsets of each unit's stream in the payload (words
// from the bits of a result, stored bytes / 4 of a parsed aligned
// container, stored bytes of a parsed unaligned one), the symbols to
// decode (n_valid, 0 for a literal), the literal rows in order into the
// first entries of `rows` (n_units long), and *width, the expansion's
// row width in words (the longest stream's words + 1; 1 without units);
// returns the literal count. With `literal_rule` set, a unit is a
// literal where its stored bytes are its n_valid bytes in the layout
// (bitpack.raw_unit_mask), never by its word count, and never where
// n_valid is 0.
int64_t mhc_plan_decode(const int64_t* byte_lens, const int64_t* bit_lens,
                        int64_t n_units, int64_t orig_len, int64_t du,
                        int32_t aligned, int32_t literal_rule, int64_t worst,
                        int64_t* bounds, int32_t* n_dec, int64_t* rows,
                        int64_t* width) {
  auto run = aligned ? (literal_rule ? plan_decode_lens<true, true>
                                     : plan_decode_lens<true, false>)
                     : (literal_rule ? plan_decode_lens<false, true>
                                     : plan_decode_lens<false, false>);
  return run(byte_lens, bit_lens, n_units, orig_len, du, worst, bounds,
             n_dec, rows, width);
}

}  // extern "C"
