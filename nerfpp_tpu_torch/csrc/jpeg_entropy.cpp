// JPEG entropy coding on the host: one scan of 8x8 coefficient blocks
// decoded into, or encoded from, int16 arrays, sequential (baseline) or
// progressive, Huffman or arithmetic; and one lossless (SOF3) scan decoded
// into samples.
//
// The pixel stages around it (dequantisation, IDCT, upsampling, colour
// conversion and their inverses) run in PyTorch (utils/jpeg.py); entropy
// coding is sequential, so it stays on the CPU, as libjpeg keeps it. The
// semantics follow ITU T.81 and libjpeg-turbo's jdhuff.c / jchuff.c:
//
// - decoding: DC prediction per component, EOB and ZRL, byte stuffing
//   (FF 00), FF fill bytes before a marker, restart markers every
//   `restart_interval` MCUs (the bit buffer dropped, the RST number checked
//   and, where it is another, resynchronised as jpeg_resync_to_restart
//   does, the DC predictors reset); a marker met inside the data feeds
//   zero bits, and once a needed bit lies past the data the MCUs after it
//   are left as they are, as libjpeg does on a truncated segment
//   (insufficient_data);
// - encoding: the same MCU order, stuffing, and the last byte filled with
//   one bits (libjpeg's flush_bits);
// - progressive scans (jdphuff.c / jcphuff.c): DC first and refinement
//   scans (interleaved or not), AC first scans with EOB runs, AC refinement
//   scans with their correction bits, restarts inside any scan; the encoder
//   gathers each scan's symbol counts first and codes the scan with the
//   optimal tables of jchuff.c's jpeg_gen_optimal_table, which it returns;
// - arithmetic-coded scans (jdarith.c, T.81 Annex D and F.1.4 / G.1.3):
//   the QM decoder with its probability estimation table, the DC bins
//   conditioned on the previous difference by the DAC bounds L and U, the
//   AC bins split at Kx, sequential and the four progressive kinds, each
//   restart resetting the statistics and the decoder, zeros fed once a
//   marker is met;
// - lossless scans (jdlhuff.c, jddiffct.c, jdlossls.c): Huffman-coded
//   sample differences (size 16 meaning 32768), undone row by row with
//   predictors 1-7, the first row of the scan and of each restart interval
//   predicted from 2^(P - Pt - 1), every value kept modulo 2^16 and put out
//   shifted left by Pt as an 8-bit sample.
//
// Blocks are stored in natural (row-major) order, 64 int16 each.
//
// Built with g++ at first use by nerfpp_tpu_torch/utils/jpeg.py; plain C
// interface, loaded with ctypes.
#include <cstdint>
#include <cstring>
#include <utility>

namespace {

// zigzag index -> natural index, with 16 extra entries so that a corrupt
// run cannot index out of the block (libjpeg's jpeg_natural_order)
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

enum Error : int64_t {
  kBadTable = -1,
  kBadCode = -2,
  kBadArgs = -4,
  kNoRoom = -5,
  kBadValue = -6,
};

// ------------------------------------------------------------------ tables

struct DecodeTable {
  int32_t maxcode[18];     // largest code of each length, -1 if none
  int32_t valoffset[18];   // symbol index = code + valoffset[length]
  uint8_t symbols[256];
  uint16_t look[1 << kLookBits];  // (length << 8) | symbol, 0: longer code
};

// Annex C: code lengths and codes in symbol order. Returns the symbol
// count, or -1 for a table that is not a valid prefix code.
int code_table(const uint8_t* counts, int32_t* sizes, int32_t* codes) {
  int n = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < counts[len - 1]; ++i) {
      if (n >= 256) return -1;
      sizes[n++] = len;
    }
  }
  int32_t code = 0;
  int p = 0;
  for (int len = 1; len <= 16; ++len) {
    while (p < n && sizes[p] == len) codes[p++] = code++;
    if (code > (1 << len)) return -1;   // more codes than the length holds
    code <<= 1;
  }
  return n;
}

bool make_decode_table(const uint8_t* counts, const uint8_t* symbols,
                       DecodeTable* t) {
  int32_t sizes[256], codes[256];
  int n = code_table(counts, sizes, codes);
  if (n < 0) return false;
  std::memcpy(t->symbols, symbols, 256);
  std::memset(t->look, 0, sizeof(t->look));
  int p = 0;
  for (int len = 1; len <= 16; ++len) {
    if (counts[len - 1]) {
      t->valoffset[len] = p - codes[p];
      p += counts[len - 1];
      t->maxcode[len] = codes[p - 1];
    } else {
      t->maxcode[len] = -1;
    }
  }
  t->maxcode[17] = 0x7FFFFFFF;          // sentinel: ends a bad code's search
  for (int i = 0; i < n; ++i) {
    if (sizes[i] > kLookBits) continue;
    int shift = kLookBits - sizes[i];
    for (int k = 0; k < (1 << shift); ++k)
      t->look[(codes[i] << shift) | k] =
          static_cast<uint16_t>((sizes[i] << 8) | symbols[i]);
  }
  return true;
}

struct EncodeTable {
  uint32_t code[256];
  int32_t size[256];       // 0: the symbol has no code
};

bool make_encode_table(const uint8_t* counts, const uint8_t* symbols,
                       EncodeTable* t) {
  int32_t sizes[256], codes[256];
  int n = code_table(counts, sizes, codes);
  if (n < 0) return false;
  std::memset(t->size, 0, sizeof(t->size));
  for (int i = 0; i < n; ++i) {
    if (t->size[symbols[i]]) return false;   // a symbol listed twice
    t->code[symbols[i]] = static_cast<uint32_t>(codes[i]);
    t->size[symbols[i]] = sizes[i];
  }
  return true;
}

// ----------------------------------------------------------------- reading

// jdmarker.c's next_marker from `*pos`: stray bytes, FF fill bytes and FF 00
// pairs skipped. Returns the marker's code, `*at` its first FF and `*pos`
// the byte after it; at the end of the data the EOI that jpeg_stdio_src
// inserts there (cv2.imread reads files through it).
int next_marker(const uint8_t* data, int64_t size, int64_t* pos,
                int64_t* at) {
  int64_t p = *pos;
  for (;;) {
    while (p < size && data[p] != 0xFF) ++p;
    *at = p;
    while (p + 1 < size && data[p + 1] == 0xFF) ++p;
    if (p + 1 >= size) {
      *pos = size;
      return 0xD9;
    }
    if (data[p + 1] != 0) break;
    p += 2;                                       // FF 00: data, skipped
  }
  *pos = p + 2;
  return data[p + 1];
}

// jpeg_resync_to_restart: where the marker met is not RST `num`, an RST
// of the next two is left unread (its segment then reads as zeros), an
// earlier RST or an invalid marker skipped for the next one, any other RST
// taken as the expected one, any other marker left unread. Returns the
// marker left unread (0: none), with `*at` where it starts.
int resync_to_restart(const uint8_t* data, int64_t size, int64_t* pos,
                      int64_t* at, int marker, int num) {
  for (;;) {
    int action;
    if (marker < 0xC0) {
      action = 2;
    } else if (marker < 0xD0 || marker > 0xD7) {
      action = 3;
    } else if (marker == 0xD0 + ((num + 1) & 7) ||
               marker == 0xD0 + ((num + 2) & 7)) {
      action = 3;
    } else if (marker == 0xD0 + ((num - 1) & 7) ||
               marker == 0xD0 + ((num - 2) & 7)) {
      action = 2;
    } else {
      action = 1;
    }
    if (action == 1) return 0;
    if (action == 3) return marker;
    marker = next_marker(data, size, pos, at);
  }
}

struct BitReader {
  const uint8_t* data;
  int64_t size;
  int64_t pos;             // next byte to read
  uint64_t buf = 0;        // bits, most significant first
  int bits = 0;
  bool at_marker = false;  // pos is at a marker: feed zero bits
  int64_t fed = 0;         // zero bits fed past the data

  void fill() {
    while (bits <= 56) {
      uint32_t c = 0;
      bool real = false;
      if (!at_marker && pos < size) {
        c = data[pos];
        if (c == 0xFF) {
          int64_t q = pos + 1;
          while (q < size && data[q] == 0xFF) ++q;   // fill bytes
          if (q < size && data[q] == 0x00) {
            pos = q + 1;                             // stuffed FF
            real = true;
          } else {
            at_marker = true;                        // leave pos on it
            c = 0;
          }
        } else {
          ++pos;
          real = true;
        }
      }
      if (!real) fed += 8;
      buf |= static_cast<uint64_t>(c) << (56 - bits);
      bits += 8;
    }
  }

  // some of the zero bits fed past the data have been consumed (libjpeg's
  // insufficient_data): they sit behind every real bit of the buffer
  bool past_data() const { return bits < fed; }

  uint32_t peek(int n) {
    if (bits < n) fill();
    return static_cast<uint32_t>(buf >> (64 - n));
  }

  void skip(int n) {
    buf <<= n;
    bits -= n;
  }

  uint32_t get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return v;
  }

  // -1 for a code that is in no table
  int decode(const DecodeTable& t) {
    uint32_t look = t.look[peek(kLookBits)];
    if (look) {
      skip(look >> 8);
      return look & 0xFF;
    }
    int len = kLookBits + 1;
    int32_t code = static_cast<int32_t>(peek(len));
    while (code > t.maxcode[len]) {
      if (++len > 16) return -1;
      code = static_cast<int32_t>(peek(len));
    }
    skip(len);
    return t.symbols[(code + t.valoffset[len]) & 0xFF];
  }

  // drop the buffered bits and step over the RST marker numbered `num`,
  // resynchronising as libjpeg does when the marker met is another (one
  // left unread feeds zeros)
  void restart(int num) {
    buf = 0;
    bits = 0;
    fed = 0;
    int64_t at;
    int m = next_marker(data, size, &pos, &at);
    m = m == 0xD0 + num ? 0 : resync_to_restart(data, size, &pos, &at, m, num);
    at_marker = m != 0;
    if (at_marker) pos = at;
  }
};

inline int32_t extend(uint32_t v, int s) {
  // F.2.2.1: a value whose top bit is clear is negative
  return (s && v < (1u << (s - 1))) ? static_cast<int32_t>(v) - (1 << s) + 1
                                    : static_cast<int32_t>(v);
}

// ----------------------------------------------------------------- writing

struct BitWriter {
  uint8_t* out;
  int64_t cap;
  int64_t n = 0;
  uint64_t buf = 0;
  int bits = 0;
  bool full = false;

  void byte(uint8_t b) {
    if (n + 2 > cap) {
      full = true;
      return;
    }
    out[n++] = b;
    if (b == 0xFF) out[n++] = 0x00;
  }

  void put(uint32_t code, int size) {
    buf = (buf << size) | (code & ((1u << size) - 1));
    bits += size;
    while (bits >= 8) {
      bits -= 8;
      byte(static_cast<uint8_t>(buf >> bits));
    }
  }

  void flush() {
    if (bits) byte(static_cast<uint8_t>((buf << (8 - bits)) | (0xFF >> bits)));
    bits = 0;
  }
};

inline int bit_length(uint32_t v) {
  return v ? 32 - __builtin_clz(v) : 0;
}

// jchuff.c's jpeg_gen_optimal_table: code lengths by Huffman's procedure
// with the pseudo-symbol 256 (so that no code is all ones), ties to the
// larger symbol, lengths over 16 folded as Annex K.2 says. `freq` [257] is
// clobbered; writes counts [16] and symbols [256].
void gen_optimal_table(int64_t* freq, uint8_t* counts, uint8_t* symbols) {
  constexpr int kMaxLen = 32;
  int bits[kMaxLen + 1] = {0};
  int codesize[257] = {0};
  int others[257];
  for (int i = 0; i < 257; ++i) others[i] = -1;
  freq[256] = 1;
  for (;;) {
    int c1 = -1, c2 = -1;
    int64_t v = 1000000000LL;
    for (int i = 0; i <= 256; ++i) {
      if (freq[i] && freq[i] <= v) {
        v = freq[i];
        c1 = i;
      }
    }
    v = 1000000000LL;
    for (int i = 0; i <= 256; ++i) {
      if (freq[i] && freq[i] <= v && i != c1) {
        v = freq[i];
        c2 = i;
      }
    }
    if (c2 < 0) break;
    freq[c1] += freq[c2];
    freq[c2] = 0;
    ++codesize[c1];
    while (others[c1] >= 0) {
      c1 = others[c1];
      ++codesize[c1];
    }
    others[c1] = c2;
    ++codesize[c2];
    while (others[c2] >= 0) {
      c2 = others[c2];
      ++codesize[c2];
    }
  }
  for (int i = 0; i <= 256; ++i)
    if (codesize[i]) bits[codesize[i] > kMaxLen ? kMaxLen : codesize[i]]++;
  int i = kMaxLen;
  for (; i > 16; --i) {
    while (bits[i] > 0) {
      int j = i - 2;
      while (bits[j] == 0) --j;
      bits[i] -= 2;
      bits[i - 1]++;
      bits[j + 1] += 2;
      bits[j]--;
    }
  }
  while (i > 0 && bits[i] == 0) --i;
  bits[i]--;
  for (int k = 1; k <= 16; ++k) counts[k - 1] = static_cast<uint8_t>(bits[k]);
  int p = 0;
  std::memset(symbols, 0, 256);
  for (int len = 1; len <= kMaxLen; ++len)
    for (int j = 0; j <= 255; ++j)
      if (codesize[j] == len) symbols[p++] = static_cast<uint8_t>(j);
}

// The state of one progressive scan's encoder (jcphuff.c): in the gather
// pass symbols are counted and no bits written.
struct ProgressiveEncoder {
  BitWriter w;
  bool gather;
  int64_t (*freq)[257];       // per table
  const EncodeTable* tables;  // per table (output pass)
  int table = 0;              // the AC table of the scan
  int eobrun = 0;
  int be = 0;                 // buffered correction bits
  uint8_t bit_buffer[1000];   // MAX_CORR_BITS

  void symbol(int tbl, int sym) {
    if (gather)
      freq[tbl][sym]++;
    else
      w.put(tables[tbl].code[sym], tables[tbl].size[sym]);
  }
  void bits(uint32_t v, int n) {
    if (!gather && n) w.put(v, n);
  }
  void buffered(const uint8_t* b, int n) {
    if (gather) return;
    for (int i = 0; i < n; ++i) w.put(b[i], 1);
  }
  bool missing(int tbl, int sym) const {
    return !gather && !tables[tbl].size[sym];
  }
  bool emit_eobrun() {
    if (eobrun > 0) {
      int nbits = bit_length(static_cast<uint32_t>(eobrun)) - 1;
      if (nbits > 14 || missing(table, nbits << 4)) return false;
      symbol(table, nbits << 4);
      if (nbits) bits(static_cast<uint32_t>(eobrun), nbits);
      eobrun = 0;
      buffered(bit_buffer, be);
      be = 0;
    }
    return true;
  }
};


// ---------------------------------------------------------- arithmetic

// T.81 Table D.2: Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS of each
// state; entry 113 is libjpeg's fixed estimate of 0.5 (it never moves),
// the bin of a sign or a refinement bit
struct QeState {
  uint16_t qe;
  uint8_t nlps, nmps, swtch;
};
const QeState kQe[114] = {
    {0x5a1d, 1, 1, 1},     {0x2586, 14, 2, 0},    {0x1114, 16, 3, 0},
    {0x080b, 18, 4, 0},    {0x03d8, 20, 5, 0},    {0x01da, 23, 6, 0},
    {0x00e5, 25, 7, 0},    {0x006f, 28, 8, 0},    {0x0036, 30, 9, 0},
    {0x001a, 33, 10, 0},   {0x000d, 35, 11, 0},   {0x0006, 9, 12, 0},
    {0x0003, 10, 13, 0},   {0x0001, 12, 13, 0},   {0x5a7f, 15, 15, 1},
    {0x3f25, 36, 16, 0},   {0x2cf2, 38, 17, 0},   {0x207c, 39, 18, 0},
    {0x17b9, 40, 19, 0},   {0x1182, 42, 20, 0},   {0x0cef, 43, 21, 0},
    {0x09a1, 45, 22, 0},   {0x072f, 46, 23, 0},   {0x055c, 48, 24, 0},
    {0x0406, 49, 25, 0},   {0x0303, 51, 26, 0},   {0x0240, 52, 27, 0},
    {0x01b1, 54, 28, 0},   {0x0144, 56, 29, 0},   {0x00f5, 57, 30, 0},
    {0x00b7, 59, 31, 0},   {0x008a, 60, 32, 0},   {0x0068, 62, 33, 0},
    {0x004e, 63, 34, 0},   {0x003b, 32, 35, 0},   {0x002c, 33, 9, 0},
    {0x5ae1, 37, 37, 1},   {0x484c, 64, 38, 0},   {0x3a0d, 65, 39, 0},
    {0x2ef1, 67, 40, 0},   {0x261f, 68, 41, 0},   {0x1f33, 69, 42, 0},
    {0x19a8, 70, 43, 0},   {0x1518, 72, 44, 0},   {0x1177, 73, 45, 0},
    {0x0e74, 74, 46, 0},   {0x0bfb, 75, 47, 0},   {0x09f8, 77, 48, 0},
    {0x0861, 78, 49, 0},   {0x0706, 79, 50, 0},   {0x05cd, 48, 51, 0},
    {0x04de, 50, 52, 0},   {0x040f, 50, 53, 0},   {0x0363, 51, 54, 0},
    {0x02d4, 52, 55, 0},   {0x025c, 53, 56, 0},   {0x01f8, 54, 57, 0},
    {0x01a4, 55, 58, 0},   {0x0160, 56, 59, 0},   {0x0125, 57, 60, 0},
    {0x00f6, 58, 61, 0},   {0x00cb, 59, 62, 0},   {0x00ab, 61, 63, 0},
    {0x008f, 61, 32, 0},   {0x5b12, 65, 65, 1},   {0x4d04, 80, 66, 0},
    {0x412c, 81, 67, 0},   {0x37d8, 82, 68, 0},   {0x2fe8, 83, 69, 0},
    {0x293c, 84, 70, 0},   {0x2379, 86, 71, 0},   {0x1edf, 87, 72, 0},
    {0x1aa9, 87, 73, 0},   {0x174e, 72, 74, 0},   {0x1424, 72, 75, 0},
    {0x119c, 74, 76, 0},   {0x0f6b, 74, 77, 0},   {0x0d51, 75, 78, 0},
    {0x0bb6, 77, 79, 0},   {0x0a40, 77, 48, 0},   {0x5832, 80, 81, 1},
    {0x4d1c, 88, 82, 0},   {0x438e, 89, 83, 0},   {0x3bdd, 90, 84, 0},
    {0x34ee, 91, 85, 0},   {0x2eae, 92, 86, 0},   {0x299a, 93, 87, 0},
    {0x2516, 86, 71, 0},   {0x5570, 88, 89, 1},   {0x4ca9, 95, 90, 0},
    {0x44d9, 96, 91, 0},   {0x3e22, 97, 92, 0},   {0x3824, 99, 93, 0},
    {0x32b4, 99, 94, 0},   {0x2e17, 93, 86, 0},   {0x56a8, 95, 96, 1},
    {0x4f46, 101, 97, 0},  {0x47e5, 102, 98, 0},  {0x41cf, 103, 99, 0},
    {0x3c3d, 104, 100, 0}, {0x375e, 99, 93, 0},   {0x5231, 105, 102, 0},
    {0x4c0f, 106, 103, 0}, {0x4639, 107, 104, 0}, {0x415e, 103, 99, 0},
    {0x5627, 105, 106, 1}, {0x50e7, 108, 107, 0}, {0x4b85, 109, 103, 0},
    {0x5597, 110, 109, 0}, {0x504f, 111, 107, 0}, {0x5a10, 110, 111, 1},
    {0x5522, 112, 109, 0}, {0x59eb, 112, 111, 1}, {0x5a1d, 113, 113, 0}};

constexpr int kFixedBin = 113;
constexpr int kDcBins = 64;
constexpr int kAcBins = 256;

// jdarith.c's decoder: C holds the interval's base and the input bits
// (the cut between them moves with CT), A the interval's size; a bin is
// its state index with the MPS in bit 7
struct ArithReader {
  const uint8_t* data;
  int64_t size;
  int64_t pos;
  int64_t c = 0;
  int64_t a = 0;
  int ct = -16;              // -16: two bytes to read before the first bit
  int marker = 0;            // the marker met (0: none yet)
  int64_t marker_at = -1;    // where its FF bytes start

  // the next data byte; once a marker (or the end, read as libjpeg's
  // inserted EOI) is met, zeros
  int byte() {
    if (marker) return 0;
    if (pos >= size) {
      marker = 0xD9;
      marker_at = size;
      return 0;
    }
    int d = data[pos++];
    if (d != 0xFF) return d;
    int64_t at = pos - 1;
    do {
      if (pos >= size) {
        marker = 0xD9;
        marker_at = at;
        return 0;
      }
      d = data[pos++];
    } while (d == 0xFF);
    if (d == 0) return 0xFF;                    // stuffed
    marker = d;
    marker_at = at;
    return 0;
  }

  int decode(uint8_t* st) {
    while (a < 0x8000) {                        // D.2.6 renormalisation
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    const QeState& q = kQe[sv & 0x7F];
    int64_t qe = q.qe;
    int nl = q.nlps | (q.swtch << 7), nm = q.nmps;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {                            // D.2.4 / D.2.5
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // step over the RST marker numbered `num` (already met, or the next
  // marker) as read_restart_marker does, resynchronising where it is
  // another, and start again
  void restart(int num) {
    if (!marker) marker = next_marker(data, size, &pos, &marker_at);
    if (marker != 0xD0 + num)
      marker = resync_to_restart(data, size, &pos, &marker_at, marker, num);
    else
      marker = 0;
    c = 0;
    a = 0;
    ct = -16;
  }

  int64_t end() const { return marker ? marker_at : pos; }
};

// The statistics of one arithmetic scan: DC and AC bins per table (0-15),
// and the conditioning of each (DAC: L and U per DC table, Kx per AC table)
struct ArithStats {
  uint8_t dc[16][kDcBins];
  uint8_t ac[16][kAcBins];
  uint8_t fixed = kFixedBin;
  const uint8_t* cond;       // L [16], U [16], Kx [16]

  int dc_context(int m, int sign, int tbl) const {
    if (m < static_cast<int>((1L << cond[tbl]) >> 1)) return 0;
    if (m > static_cast<int>((1L << cond[16 + tbl]) >> 1)) return 12 + 4 * sign;
    return 4 + 4 * sign;
  }
};

// F.1.4.4.1 / Figure F.19-F.24: one DC difference of the bins at `s0`,
// updating the component's context; -1: a magnitude that overflows
int arith_dc_diff(ArithReader& in, ArithStats& stats, int tbl, int* context,
                  int32_t* diff) {
  uint8_t* st = stats.dc[tbl] + *context;
  if (in.decode(st) == 0) {
    *context = 0;
    *diff = 0;
    return 0;
  }
  int sign = in.decode(st + 1);
  st += 2 + sign;
  int m = in.decode(st);
  if (m) {
    st = stats.dc[tbl] + 20;                    // X1
    while (in.decode(st)) {
      if ((m <<= 1) == 0x8000) return -1;
      st += 1;
    }
  }
  *context = stats.dc_context(m, sign, tbl);
  int v = m;
  st += 14;
  while (m >>= 1)
    if (in.decode(st)) v |= m;
  v += 1;
  *diff = sign ? -v : v;
  return 0;
}

// the magnitude category and bits of an AC coefficient whose sign has just
// been read, the category's first bin at `st`; -1 on overflow
int arith_ac_value(ArithReader& in, ArithStats& stats, int tbl, int k,
                   uint8_t* st, int sign, int32_t* value) {
  int m = in.decode(st);
  if (m && in.decode(st)) {
    m <<= 1;
    st = stats.ac[tbl] + (k <= stats.cond[32 + tbl] ? 189 : 217);
    while (in.decode(st)) {
      if ((m <<= 1) == 0x8000) return -1;
      st += 1;
    }
  }
  int v = m;
  st += 14;
  while (m >>= 1)
    if (in.decode(st)) v |= m;
  v += 1;
  *value = sign ? -v : v;
  return 0;
}

// --------------------------------------------------------------- lossless

// jdlossls.c's predictors on the previous sample Ra, the one above Rb and
// the one above-left Rc
inline int32_t predict(int psv, int32_t ra, int32_t rb, int32_t rc) {
  switch (psv) {
    case 1: return ra;
    case 2: return rb;
    case 3: return rc;
    case 4: return ra + rb - rc;
    case 5: return ra + ((rb - rc) >> 1);
    case 6: return rb + ((ra - rc) >> 1);
    default: return (ra + rb) >> 1;
  }
}

}  // namespace

extern "C" {

int jpeg_entropy_version() { return 1; }

// The arithmetic decoder's state table: [114 * 4] Qe, Next_Index_LPS,
// Next_Index_MPS and Switch_MPS of each state.
void jpeg_arith_states(int32_t* out) {
  for (int i = 0; i < 114; ++i) {
    out[4 * i] = kQe[i].qe;
    out[4 * i + 1] = kQe[i].nlps;
    out[4 * i + 2] = kQe[i].nmps;
    out[4 * i + 3] = kQe[i].swtch;
  }
}

// Decode one baseline Huffman scan of `n_comp` components.
//
// comp_hv      [n_comp * 2]  blocks per MCU across and down (1, 1 in a
//                            scan of one component)
// comp_grid    [n_comp * 2]  block rows and block columns of each
//                            component's array; blocks outside are decoded
//                            and dropped
// comp_tables  [n_comp * 2]  DC table and AC table (0..3)
// counts       [8 * 16]      code counts per length of DC tables 0-3, then
//                            AC tables 0-3
// symbols      [8 * 256]     their symbols
// coefs        [n_comp]      int16 arrays [rows, cols, 64], natural order
//
// Returns the byte offset where reading stopped (a marker, or the end of
// the data), or a negative error code.
int64_t jpeg_decode_scan(const uint8_t* data, int64_t size, int64_t start,
                         int32_t n_comp, const int32_t* comp_hv,
                         const int32_t* comp_grid, const int32_t* comp_tables,
                         const uint8_t* counts, const uint8_t* symbols,
                         int32_t mcus_x, int32_t mcus_y,
                         int32_t restart_interval, int16_t** coefs) {
  if (n_comp < 1 || n_comp > 4 || mcus_x < 1 || mcus_y < 1 || start < 0)
    return kBadArgs;
  DecodeTable tables[8];
  bool built[8] = {false};
  for (int c = 0; c < n_comp; ++c) {
    for (int k = 0; k < 2; ++k) {
      int t = comp_tables[2 * c + k];
      if (t < 0 || t > 3) return kBadArgs;
      int slot = 4 * k + t;
      if (!built[slot]) {
        if (!make_decode_table(counts + 16 * slot, symbols + 256 * slot,
                               &tables[slot]))
          return kBadTable;
        built[slot] = true;
      }
    }
  }
  BitReader in{data, size, start};
  int32_t pred[4] = {0, 0, 0, 0};
  int16_t scratch[64];
  int64_t mcu = 0;
  int next_rst = 0;
  bool insufficient = false;
  for (int32_t my = 0; my < mcus_y; ++my) {
    for (int32_t mx = 0; mx < mcus_x; ++mx, ++mcu) {
      if (restart_interval > 0 && mcu > 0 && mcu % restart_interval == 0) {
        in.restart(next_rst);
        next_rst = (next_rst + 1) & 7;
        std::memset(pred, 0, sizeof(pred));
        if (!in.at_marker) insufficient = false;
      }
      if (insufficient) continue;        // past the data: blocks left zero
      for (int c = 0; c < n_comp; ++c) {
        const DecodeTable& dc = tables[comp_tables[2 * c]];
        const DecodeTable& ac = tables[4 + comp_tables[2 * c + 1]];
        int h = comp_hv[2 * c], v = comp_hv[2 * c + 1];
        int rows = comp_grid[2 * c], cols = comp_grid[2 * c + 1];
        for (int by = 0; by < v; ++by) {
          for (int bx = 0; bx < h; ++bx) {
            int64_t row = static_cast<int64_t>(my) * v + by;
            int64_t col = static_cast<int64_t>(mx) * h + bx;
            int16_t* block = (row < rows && col < cols)
                                 ? coefs[c] + (row * cols + col) * 64
                                 : scratch;
            std::memset(block, 0, 64 * sizeof(int16_t));
            int s = in.decode(dc);
            if (s < 0) return kBadCode;
            if (s > 16) return kBadValue;
            pred[c] += extend(in.get(s), s);
            block[0] = static_cast<int16_t>(pred[c]);
            for (int k = 1; k < 64;) {
              int rs = in.decode(ac);
              if (rs < 0) return kBadCode;
              int r = rs >> 4, sz = rs & 15;
              if (sz) {
                k += r;
                block[kNatural[k]] = static_cast<int16_t>(
                    extend(in.get(sz), sz));
                ++k;
              } else if (r == 15) {
                k += 16;                                // ZRL
              } else {
                break;                                  // EOB
              }
            }
          }
        }
      }
      insufficient = in.past_data();
    }
  }
  return in.pos;
}

// Encode `n_blocks` blocks (natural order, in scan order) as one scan:
// block_comp[i] is the scan component of block i (DC prediction and
// tables), comp_tables/counts/symbols as for decoding. Writes the stuffed
// entropy-coded segment (no markers) into out[cap] and returns its length,
// or a negative error code (kNoRoom: cap too small).
int64_t jpeg_encode_scan(const int16_t* blocks, int64_t n_blocks,
                         const int32_t* block_comp, int32_t n_comp,
                         const int32_t* comp_tables, const uint8_t* counts,
                         const uint8_t* symbols, uint8_t* out, int64_t cap) {
  if (n_comp < 1 || n_comp > 4 || n_blocks < 0) return kBadArgs;
  EncodeTable tables[8];
  bool built[8] = {false};
  for (int c = 0; c < n_comp; ++c) {
    for (int k = 0; k < 2; ++k) {
      int t = comp_tables[2 * c + k];
      if (t < 0 || t > 3) return kBadArgs;
      int slot = 4 * k + t;
      if (!built[slot]) {
        if (!make_encode_table(counts + 16 * slot, symbols + 256 * slot,
                               &tables[slot]))
          return kBadTable;
        built[slot] = true;
      }
    }
  }
  BitWriter w{out, cap};
  int32_t pred[4] = {0, 0, 0, 0};
  for (int64_t i = 0; i < n_blocks && !w.full; ++i) {
    int c = block_comp[i];
    if (c < 0 || c >= n_comp) return kBadArgs;
    const EncodeTable& dc = tables[comp_tables[2 * c]];
    const EncodeTable& ac = tables[4 + comp_tables[2 * c + 1]];
    const int16_t* block = blocks + i * 64;
    int32_t diff = block[0] - pred[c];
    pred[c] = block[0];
    uint32_t mag = static_cast<uint32_t>(diff < 0 ? -diff : diff);
    int nbits = bit_length(mag);
    if (nbits > 11 || !dc.size[nbits]) return kBadValue;
    w.put(dc.code[nbits], dc.size[nbits]);
    if (nbits) w.put(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff), nbits);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int32_t v = block[kNatural[k]];
      if (v == 0) {
        ++run;
        continue;
      }
      while (run > 15) {
        if (!ac.size[0xF0]) return kBadValue;
        w.put(ac.code[0xF0], ac.size[0xF0]);                // ZRL
        run -= 16;
      }
      mag = static_cast<uint32_t>(v < 0 ? -v : v);
      nbits = bit_length(mag);
      int sym = (run << 4) | nbits;
      if (nbits > 10 || !ac.size[sym]) return kBadValue;
      w.put(ac.code[sym], ac.size[sym]);
      w.put(static_cast<uint32_t>(v < 0 ? v - 1 : v), nbits);
      run = 0;
    }
    if (run > 0) {
      if (!ac.size[0]) return kBadValue;
      w.put(ac.code[0], ac.size[0]);                        // EOB
    }
  }
  w.flush();
  return w.full ? kNoRoom : w.n;
}


// Decode one progressive Huffman scan (jdphuff.c) of spectral band ss-se
// at successive approximation ah/al into the coefficient arrays, which hold
// the earlier scans' results (zero before the first). Arguments as
// jpeg_decode_scan; an AC scan has one component and comp_hv (1, 1).
// `rows_per_imcu`: MCU rows an iMCU row (1 when interleaved, else the
// component's v); `last_good` receives the iMCU row of the last MCU begun
// before the data ran out (jdcoefct.c's last_good_iMCU_row).
int64_t jpeg_decode_progressive_scan(
    const uint8_t* data, int64_t size, int64_t start, int32_t n_comp,
    const int32_t* comp_hv, const int32_t* comp_grid,
    const int32_t* comp_tables, const uint8_t* counts, const uint8_t* symbols,
    int32_t mcus_x, int32_t mcus_y, int32_t restart_interval, int32_t ss,
    int32_t se, int32_t ah, int32_t al, int32_t rows_per_imcu,
    int32_t* last_good, int16_t** coefs) {
  const bool dc = ss == 0;
  if (n_comp < 1 || n_comp > 4 || mcus_x < 1 || mcus_y < 1 || start < 0 ||
      (dc ? se != 0 : (ss > se || se > 63 || n_comp != 1)) ||
      (ah && al != ah - 1) || al > 13 || rows_per_imcu < 1)
    return kBadArgs;
  *last_good = 0;
  DecodeTable tables[8];
  bool built[8] = {false};
  if (!(dc && ah)) {                        // DC refinement needs no table
    for (int c = 0; c < n_comp; ++c) {
      int t = comp_tables[2 * c + (dc ? 0 : 1)];
      if (t < 0 || t > 3) return kBadArgs;
      int slot = (dc ? 0 : 4) + t;
      if (!built[slot]) {
        if (!make_decode_table(counts + 16 * slot, symbols + 256 * slot,
                               &tables[slot]))
          return kBadTable;
        built[slot] = true;
      }
    }
  }
  BitReader in{data, size, start};
  int32_t pred[4] = {0, 0, 0, 0};
  int eobrun = 0;
  const int p1 = 1 << al;
  const int m1 = -(1 << al);
  int16_t scratch[64];
  int64_t mcu = 0;
  int next_rst = 0;
  bool insufficient = false;
  for (int32_t my = 0; my < mcus_y; ++my) {
    for (int32_t mx = 0; mx < mcus_x; ++mx, ++mcu) {
      if (restart_interval > 0 && mcu > 0 && mcu % restart_interval == 0) {
        in.restart(next_rst);
        next_rst = (next_rst + 1) & 7;
        std::memset(pred, 0, sizeof(pred));
        eobrun = 0;
        if (!in.at_marker) insufficient = false;
      }
      if (insufficient) continue;        // past the data: blocks kept
      *last_good = my / rows_per_imcu;
      for (int c = 0; c < n_comp; ++c) {
        int h = comp_hv[2 * c], v = comp_hv[2 * c + 1];
        int rows = comp_grid[2 * c], cols = comp_grid[2 * c + 1];
        for (int by = 0; by < v; ++by) {
          for (int bx = 0; bx < h; ++bx) {
            int64_t row = static_cast<int64_t>(my) * v + by;
            int64_t col = static_cast<int64_t>(mx) * h + bx;
            int16_t* block = scratch;
            if (row < rows && col < cols) {
              block = coefs[c] + (row * cols + col) * 64;
            } else {
              std::memset(scratch, 0, sizeof(scratch));
            }
            if (dc && !ah) {                              // DC first
              int s = in.decode(tables[comp_tables[2 * c]]);
              if (s < 0) return kBadCode;
              if (s > 16) return kBadValue;
              pred[c] += extend(in.get(s), s);
              block[0] = static_cast<int16_t>(
                  static_cast<uint32_t>(pred[c]) << al);
            } else if (dc) {                              // DC refinement
              if (in.get(1)) block[0] = static_cast<int16_t>(block[0] | p1);
            } else if (!ah) {                             // AC first
              if (eobrun > 0) {
                --eobrun;
                continue;
              }
              const DecodeTable& t = tables[4 + comp_tables[2 * c + 1]];
              for (int k = ss; k <= se; ++k) {
                int rs = in.decode(t);
                if (rs < 0) return kBadCode;
                int r = rs >> 4, s = rs & 15;
                if (s) {
                  k += r;
                  block[kNatural[k]] = static_cast<int16_t>(
                      static_cast<uint32_t>(extend(in.get(s), s)) << al);
                } else if (r == 15) {
                  k += 15;                                // ZRL
                } else {
                  eobrun = 1 << r;                        // EOBr
                  if (r) eobrun += static_cast<int>(in.get(r));
                  --eobrun;
                  break;
                }
              }
            } else {                                      // AC refinement
              const DecodeTable& t = tables[4 + comp_tables[2 * c + 1]];
              int k = ss;
              if (eobrun == 0) {
                for (; k <= se; ++k) {
                  int rs = in.decode(t);
                  if (rs < 0) return kBadCode;
                  int r = rs >> 4, s = rs & 15;
                  if (s) {
                    s = in.get(1) ? p1 : m1;   // a size other than 1 is
                  } else if (r != 15) {        // taken as 1, as libjpeg
                    eobrun = 1 << r;
                    if (r) eobrun += static_cast<int>(in.get(r));
                    break;
                  }
                  do {
                    int16_t* coef = block + kNatural[k];
                    if (*coef != 0) {
                      if (in.get(1) && (*coef & p1) == 0)
                        *coef = static_cast<int16_t>(*coef + (*coef >= 0
                                                              ? p1 : m1));
                    } else if (--r < 0) {
                      break;
                    }
                    ++k;
                  } while (k <= se);
                  if (s) block[kNatural[k]] = static_cast<int16_t>(s);
                }
              }
              if (eobrun > 0) {
                for (; k <= se; ++k) {
                  int16_t* coef = block + kNatural[k];
                  if (*coef != 0 && in.get(1) && (*coef & p1) == 0)
                    *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1
                                                                     : m1));
                }
                --eobrun;
              }
            }
          }
        }
      }
      insufficient = in.past_data();
    }
  }
  return in.pos;
}

// Encode one progressive scan (jcphuff.c) of the quantised blocks, in two
// passes as libjpeg codes it with optimised tables: the gather pass counts
// each table's symbols, jpeg_gen_optimal_table builds the table, and the
// output pass codes the scan with it. Arguments as jpeg_decode_scan, with
// comp_tables [n_comp] the table of each component (its DC table in a DC
// scan, its AC table in an AC scan); the blocks of an interleaved scan
// (dummy blocks included) fill the grids. Writes each table the scan uses
// to counts [4 * 16] and symbols [4 * 256] (slot = table) and the stuffed
// entropy-coded segment, with RST markers, to out[cap]; returns its
// length or a negative error code.
int64_t jpeg_encode_progressive_scan(
    int32_t n_comp, const int32_t* comp_hv, const int32_t* comp_grid,
    const int32_t* comp_tables, int32_t mcus_x, int32_t mcus_y,
    int32_t restart_interval, int32_t ss, int32_t se, int32_t ah, int32_t al,
    const int16_t** coefs, uint8_t* counts, uint8_t* symbols, uint8_t* out,
    int64_t cap) {
  const bool dc = ss == 0;
  if (n_comp < 1 || n_comp > 4 || mcus_x < 1 || mcus_y < 1 ||
      (dc ? se != 0 : (ss > se || se > 63 || n_comp != 1)) ||
      (ah && al != ah - 1) || al > 13)
    return kBadArgs;
  for (int c = 0; c < n_comp; ++c)
    if (comp_tables[c] < 0 || comp_tables[c] > 3) return kBadArgs;
  static thread_local int64_t freq[4][257];
  std::memset(freq, 0, sizeof(freq));
  EncodeTable tables[4];
  int64_t length = 0;
  // DC refinement codes raw bits: no table, no gather pass
  for (int pass = dc && ah ? 1 : 0; pass < 2; ++pass) {
    ProgressiveEncoder e{BitWriter{out, cap}, pass == 0, freq, tables};
    e.table = comp_tables[0];
    int32_t last_dc[4] = {0, 0, 0, 0};
    int64_t mcu = 0;
    int next_rst = 0;
    int restarts_to_go = restart_interval;
    int absvalues[64];
    for (int32_t my = 0; my < mcus_y; ++my) {
      for (int32_t mx = 0; mx < mcus_x; ++mx, ++mcu) {
        if (restart_interval) {
          if (restarts_to_go == 0) {                 // emit_restart
            if (!e.emit_eobrun()) return kBadValue;
            if (!e.gather) {
              e.w.flush();
              if (e.w.n + 2 > e.w.cap) return kNoRoom;
              e.w.out[e.w.n++] = 0xFF;
              e.w.out[e.w.n++] = static_cast<uint8_t>(0xD0 + next_rst);
            }
            std::memset(last_dc, 0, sizeof(last_dc));
            e.eobrun = 0;
            e.be = 0;
            restarts_to_go = restart_interval;
            next_rst = (next_rst + 1) & 7;
          }
          --restarts_to_go;
        }
        for (int c = 0; c < n_comp; ++c) {
          int h = comp_hv[2 * c], v = comp_hv[2 * c + 1];
          int cols = comp_grid[2 * c + 1];
          for (int by = 0; by < v; ++by) {
            for (int bx = 0; bx < h; ++bx) {
              int64_t row = static_cast<int64_t>(my) * v + by;
              int64_t col = static_cast<int64_t>(mx) * h + bx;
              if (row >= comp_grid[2 * c] || col >= cols) return kBadArgs;
              const int16_t* block = coefs[c] + (row * cols + col) * 64;
              if (dc && !ah) {                            // DC first
                int32_t t2 = static_cast<int32_t>(block[0]) >> al;
                int32_t diff = t2 - last_dc[c];
                last_dc[c] = t2;
                uint32_t mag = static_cast<uint32_t>(diff < 0 ? -diff : diff);
                int nbits = bit_length(mag);
                if (nbits > 11 || e.missing(comp_tables[c], nbits))
                  return kBadValue;
                e.symbol(comp_tables[c], nbits);
                e.bits(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff),
                       nbits);
              } else if (dc) {                            // DC refinement
                e.bits(static_cast<uint32_t>(block[0] >> al) & 1, 1);
              } else if (!ah) {                           // AC first
                int r = 0;
                for (int k = ss; k <= se; ++k) {
                  int32_t t = block[kNatural[k]];
                  if (t == 0) {
                    ++r;
                    continue;
                  }
                  uint32_t t2;
                  if (t < 0) {
                    t = (-t) >> al;
                    t2 = ~static_cast<uint32_t>(t);
                  } else {
                    t >>= al;
                    t2 = static_cast<uint32_t>(t);
                  }
                  if (t == 0) {
                    ++r;
                    continue;
                  }
                  if (!e.emit_eobrun()) return kBadValue;
                  while (r > 15) {
                    if (e.missing(e.table, 0xF0)) return kBadValue;
                    e.symbol(e.table, 0xF0);
                    r -= 16;
                  }
                  int nbits = bit_length(static_cast<uint32_t>(t));
                  if (nbits > 10 || e.missing(e.table, (r << 4) + nbits))
                    return kBadValue;
                  e.symbol(e.table, (r << 4) + nbits);
                  e.bits(t2, nbits);
                  r = 0;
                }
                if (r > 0) {
                  if (++e.eobrun == 0x7FFF && !e.emit_eobrun())
                    return kBadValue;
                }
              } else {                                    // AC refinement
                int eob = 0;
                for (int k = ss; k <= se; ++k) {
                  int32_t t = block[kNatural[k]];
                  t = (t < 0 ? -t : t) >> al;
                  absvalues[k] = t;
                  if (t == 1) eob = k;
                }
                int r = 0, br = 0;
                uint8_t* br_buffer = e.bit_buffer + e.be;
                for (int k = ss; k <= se; ++k) {
                  int t = absvalues[k];
                  if (t == 0) {
                    ++r;
                    continue;
                  }
                  while (r > 15 && k <= eob) {
                    if (!e.emit_eobrun() || e.missing(e.table, 0xF0))
                      return kBadValue;
                    e.symbol(e.table, 0xF0);
                    r -= 16;
                    e.buffered(br_buffer, br);
                    br_buffer = e.bit_buffer;
                    br = 0;
                  }
                  if (t > 1) {
                    br_buffer[br++] = static_cast<uint8_t>(t & 1);
                    continue;
                  }
                  if (!e.emit_eobrun() || e.missing(e.table, (r << 4) + 1))
                    return kBadValue;
                  e.symbol(e.table, (r << 4) + 1);
                  e.bits(block[kNatural[k]] < 0 ? 0 : 1, 1);
                  e.buffered(br_buffer, br);
                  br_buffer = e.bit_buffer;
                  br = 0;
                  r = 0;
                }
                if (r > 0 || br > 0) {
                  ++e.eobrun;
                  e.be += br;
                  if ((e.eobrun == 0x7FFF || e.be > 1000 - 64 + 1) &&
                      !e.emit_eobrun())
                    return kBadValue;
                }
              }
            }
          }
        }
      }
    }
    if (!e.emit_eobrun()) return kBadValue;
    if (e.gather) {
      bool did[4] = {false, false, false, false};
      for (int c = 0; c < n_comp; ++c) {
        int t = comp_tables[c];
        if (did[t]) continue;
        gen_optimal_table(freq[t], counts + 16 * t, symbols + 256 * t);
        if (!make_encode_table(counts + 16 * t, symbols + 256 * t,
                               &tables[t]))
          return kBadTable;
        did[t] = true;
      }
    } else {
      e.w.flush();
      if (e.w.full) return kNoRoom;
      length = e.w.n;
    }
  }
  return length;
}


// Decode one arithmetic-coded scan (jdarith.c) into the coefficient arrays:
// sequential (`progressive` 0: every coefficient of each block) or one
// progressive pass of band ss-se at approximation ah/al (DC first, DC
// refinement on the fixed bin, AC first, AC refinement). Arguments as
// jpeg_decode_scan / jpeg_decode_progressive_scan, with comp_tables the DC
// and AC conditioning table of each component (0-15) and conditioning
// [48] each table's DAC values: L [16], U [16], Kx [16]. The statistics
// start at zero and restart with every restart interval (a marker other
// than the expected RST resynchronised as libjpeg does); past a marker the
// decoder reads zeros. A coefficient that overflows stops the scan's
// decoding until the next restart, as libjpeg stops it (the blocks after it
// keep what they hold). Returns where reading stopped (the marker after the
// data) or a negative error code.
int64_t jpeg_decode_arith_scan(
    const uint8_t* data, int64_t size, int64_t start, int32_t n_comp,
    const int32_t* comp_hv, const int32_t* comp_grid,
    const int32_t* comp_tables, const uint8_t* conditioning, int32_t mcus_x,
    int32_t mcus_y, int32_t restart_interval, int32_t progressive,
    int32_t ss, int32_t se, int32_t ah, int32_t al, int16_t** coefs) {
  const bool dc = ss == 0;
  if (n_comp < 1 || n_comp > 4 || mcus_x < 1 || mcus_y < 1 || start < 0)
    return kBadArgs;
  if (progressive && ((dc ? se != 0 : (ss > se || se > 63 || n_comp != 1)) ||
                      (ah && al != ah - 1) || al > 13))
    return kBadArgs;
  for (int k = 0; k < 2 * n_comp; ++k)
    if (comp_tables[k] < 0 || comp_tables[k] > 15) return kBadArgs;
  static thread_local ArithStats stats;
  stats.cond = conditioning;
  const bool uses_dc = !progressive || (dc && !ah);
  const bool uses_ac = !progressive || !dc;
  auto reset = [&](int32_t* last_dc, int* context) {
    for (int c = 0; c < n_comp; ++c) {
      if (uses_dc) {
        std::memset(stats.dc[comp_tables[2 * c]], 0, kDcBins);
        last_dc[c] = 0;
        context[c] = 0;
      }
      if (uses_ac) std::memset(stats.ac[comp_tables[2 * c + 1]], 0, kAcBins);
    }
  };
  int32_t last_dc[4] = {0, 0, 0, 0};
  int context[4] = {0, 0, 0, 0};
  reset(last_dc, context);
  ArithReader in{data, size, start};
  bool broken = false;         // libjpeg's ct == -1 after an overflow
  const int p1 = 1 << al;
  const int m1 = -(1 << al);
  int16_t scratch[64];
  int64_t mcu = 0;
  int next_rst = 0;
  for (int32_t my = 0; my < mcus_y; ++my) {
    for (int32_t mx = 0; mx < mcus_x; ++mx, ++mcu) {
      if (restart_interval > 0 && mcu > 0 && mcu % restart_interval == 0) {
        in.restart(next_rst);
        next_rst = (next_rst + 1) & 7;
        reset(last_dc, context);
        broken = false;
      }
      if (broken) continue;
      for (int c = 0; c < n_comp && !broken; ++c) {
        int h = comp_hv[2 * c], v = comp_hv[2 * c + 1];
        int rows = comp_grid[2 * c], cols = comp_grid[2 * c + 1];
        int dt = comp_tables[2 * c], at = comp_tables[2 * c + 1];
        for (int by = 0; by < v && !broken; ++by) {
          for (int bx = 0; bx < h && !broken; ++bx) {
            int64_t row = static_cast<int64_t>(my) * v + by;
            int64_t col = static_cast<int64_t>(mx) * h + bx;
            int16_t* block = scratch;
            if (row < rows && col < cols) {
              block = coefs[c] + (row * cols + col) * 64;
            } else {
              std::memset(scratch, 0, sizeof(scratch));
            }
            int32_t value;
            if (!progressive || (dc && !ah)) {            // DC
              if (arith_dc_diff(in, stats, dt, &context[c], &value) < 0) {
                broken = true;
                break;
              }
              last_dc[c] = (last_dc[c] + value) & 0xFFFF;
              block[0] = static_cast<int16_t>(
                  static_cast<uint32_t>(last_dc[c]) << (progressive ? al : 0));
              if (progressive) continue;
            }
            if (progressive && dc) {                      // DC refinement
              if (in.decode(&stats.fixed))
                block[0] = static_cast<int16_t>(block[0] | p1);
              continue;
            }
            const int first = progressive ? ss : 1, last = progressive ? se
                                                                        : 63;
            if (!ah || !progressive) {                    // AC (first)
              for (int k = first; k <= last; ++k) {
                uint8_t* st = stats.ac[at] + 3 * (k - 1);
                if (in.decode(st)) break;                 // EOB
                while (in.decode(st + 1) == 0) {
                  st += 3;
                  if (++k > last) {
                    broken = true;
                    break;
                  }
                }
                if (broken) break;
                int sign = in.decode(&stats.fixed);
                if (arith_ac_value(in, stats, at, k, st + 2, sign, &value) <
                    0) {
                  broken = true;
                  break;
                }
                block[kNatural[k]] = static_cast<int16_t>(
                    static_cast<uint32_t>(value) << (progressive ? al : 0));
              }
              continue;
            }
            int kex = se;                                 // AC refinement
            for (; kex > 0; --kex)
              if (block[kNatural[kex]]) break;
            for (int k = ss; k <= se; ++k) {
              uint8_t* st = stats.ac[at] + 3 * (k - 1);
              if (k > kex && in.decode(st)) break;        // EOB
              for (;;) {
                int16_t* coef = block + kNatural[k];
                if (*coef) {                              // already nonzero
                  if (in.decode(st + 2))
                    *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1
                                                                    : p1));
                  break;
                }
                if (in.decode(st + 1)) {                  // newly nonzero
                  *coef = static_cast<int16_t>(in.decode(&stats.fixed) ? m1
                                                                       : p1);
                  break;
                }
                st += 3;
                if (++k > se) {
                  broken = true;
                  break;
                }
              }
              if (broken) break;
            }
          }
        }
      }
    }
  }
  return in.end();
}

// Decode one lossless Huffman scan (SOF3) into 8-bit samples.
//
// comp_hv      [n_comp * 2]  samples per MCU across and down (1, 1 in a
//                            scan of one component)
// comp_size    [n_comp * 3]  each component's rows and columns of real
//                            samples (height and width_in_blocks) and its
//                            vertical sampling factor (a scan of one
//                            component takes that many rows an iMCU row)
// comp_tables  [n_comp]      DC table (0..3) of each component
// counts, symbols            as jpeg_decode_scan (DC slots 0-3)
// mcus_x, mcus_y             MCUs across and MCU rows of the scan
// psv, pt, precision         predictor (1-7), point transform, sample bits
// samples      [n_comp]      uint8 arrays [rows, cols]
//
// As jddiffct.c runs it: an iMCU row's MCU rows are decoded first (a
// restart, checked before each MCU row, sends the next row that each
// component undoes through the first-row predictor), then its sample rows
// undone. Once the data runs out, the MCU rows after it hold zero
// differences from a reset predictor (libjpeg's insufficient_data); a
// marker other than the expected RST is resynchronised as libjpeg does.
// Returns where reading stopped or a negative error code.
int64_t jpeg_decode_lossless_scan(
    const uint8_t* data, int64_t size, int64_t start, int32_t n_comp,
    const int32_t* comp_hv, const int32_t* comp_size,
    const int32_t* comp_tables, const uint8_t* counts, const uint8_t* symbols,
    int32_t mcus_x, int32_t mcus_y, int32_t restart_interval, int32_t psv,
    int32_t pt, int32_t precision, uint8_t** samples) {
  if (n_comp < 1 || n_comp > 4 || mcus_x < 1 || mcus_y < 1 || start < 0 ||
      psv < 1 || psv > 7 || pt < 0 || pt >= precision || precision > 16 ||
      (restart_interval > 0 && restart_interval % mcus_x))
    return kBadArgs;
  DecodeTable tables[4];
  bool built[4] = {false, false, false, false};
  for (int c = 0; c < n_comp; ++c) {
    int t = comp_tables[c];
    if (t < 0 || t > 3) return kBadArgs;
    if (!built[t]) {
      if (!make_decode_table(counts + 16 * t, symbols + 256 * t, &tables[t]))
        return kBadTable;
      built[t] = true;
    }
  }
  const bool interleaved = n_comp > 1;
  const int32_t initial = 1 << (precision - pt - 1);
  // per component: v rows of differences of the MCU columns, the previous
  // undone row, and whether its next row is a first row
  int32_t* diff[4];
  int32_t* prev[4];
  int32_t* cur[4];
  bool first_row[4];
  int64_t width[4];
  int64_t done_rows[4] = {0, 0, 0, 0};
  int64_t need = 0;
  for (int c = 0; c < n_comp; ++c) {
    width[c] = static_cast<int64_t>(mcus_x) * comp_hv[2 * c];
    need += width[c] * (comp_hv[2 * c + 1] + comp_size[3 * c + 2] + 2);
  }
  int32_t* pool = new int32_t[need + 1]();
  int32_t* at = pool;
  for (int c = 0; c < n_comp; ++c) {
    int rows = interleaved ? comp_hv[2 * c + 1] : comp_size[3 * c + 2];
    diff[c] = at;
    at += width[c] * rows;
    prev[c] = at;
    at += width[c];
    cur[c] = at;
    at += width[c];
    first_row[c] = true;
  }
  BitReader in{data, size, start};
  int64_t restart_rows = restart_interval > 0 ? restart_interval / mcus_x : 0;
  int64_t rows_to_go = restart_rows;
  int next_rst = 0;
  int64_t status = 0;
  bool insufficient = false;
  const int64_t imcu_rows = interleaved ? mcus_y
                                        : (mcus_y + comp_size[2] - 1) /
                                              comp_size[2];
  int64_t mcu_row = 0;
  for (int64_t imcu = 0; imcu < imcu_rows && !status; ++imcu) {
    int per_imcu = 1;
    if (!interleaved) {
      per_imcu = comp_size[2];
      if (imcu == imcu_rows - 1) {
        int64_t rem = comp_size[0] % comp_size[2];
        per_imcu = static_cast<int>(rem ? rem : comp_size[2]);
      }
    }
    for (int y = 0; y < per_imcu; ++y, ++mcu_row) {
      if (restart_rows) {
        if (rows_to_go == 0) {
          in.restart(next_rst);
          next_rst = (next_rst + 1) & 7;
          if (!in.at_marker) insufficient = false;
          for (int c = 0; c < n_comp; ++c) first_row[c] = true;
          rows_to_go = restart_rows;
        }
      }
      if (insufficient) {
        for (int c = 0; c < n_comp; ++c) {
          int rows = interleaved ? comp_hv[2 * c + 1] : 1;
          int64_t base = interleaved ? 0 : y;
          std::memset(diff[c] + base * width[c], 0,
                      sizeof(int32_t) * width[c] * rows);
          first_row[c] = true;
        }
      } else {
        for (int32_t mx = 0; mx < mcus_x && !status; ++mx) {
          for (int c = 0; c < n_comp && !status; ++c) {
            int h = interleaved ? comp_hv[2 * c] : 1;
            int v = interleaved ? comp_hv[2 * c + 1] : 1;
            const DecodeTable& t = tables[comp_tables[c]];
            for (int by = 0; by < v; ++by) {
              for (int bx = 0; bx < h; ++bx) {
                int s = in.decode(t);
                if (s < 0) {
                  status = kBadCode;
                  break;
                }
                if (s > 16) {
                  status = kBadValue;
                  break;
                }
                int32_t d = s == 16 ? 32768 : s ? extend(in.get(s), s) : 0;
                int64_t r = interleaved ? by : y;
                diff[c][r * width[c] + static_cast<int64_t>(mx) * h + bx] = d;
              }
              if (status) break;
            }
          }
        }
        insufficient = in.past_data();
      }
      if (restart_rows) --rows_to_go;
    }
    if (status) break;
    for (int c = 0; c < n_comp; ++c) {
      int64_t rows_c = comp_size[3 * c], cols = comp_size[3 * c + 1];
      int v = interleaved ? comp_hv[2 * c + 1] : comp_size[3 * c + 2];
      for (int r = 0; r < v && done_rows[c] < rows_c; ++r) {
        const int32_t* d = diff[c] + r * width[c];
        int32_t* out = cur[c];
        const int32_t* up = prev[c];
        if (first_row[c]) {
          int32_t ra = (d[0] + initial) & 0xFFFF;
          out[0] = ra;
          for (int64_t x = 1; x < cols; ++x) out[x] = ra = (d[x] + ra) & 0xFFFF;
          first_row[c] = false;
        } else {
          int32_t ra = (d[0] + up[0]) & 0xFFFF;
          out[0] = ra;
          for (int64_t x = 1; x < cols; ++x)
            out[x] = ra = (d[x] + predict(psv, ra, up[x], up[x - 1])) & 0xFFFF;
        }
        uint8_t* dst = samples[c] + done_rows[c] * cols;
        for (int64_t x = 0; x < cols; ++x)
          dst[x] = static_cast<uint8_t>(static_cast<uint32_t>(out[x]) << pt);
        std::swap(cur[c], prev[c]);
        ++done_rows[c];
      }
    }
  }
  delete[] pool;
  return status ? status : in.pos;
}

}  // extern "C"
