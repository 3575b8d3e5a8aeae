// JPEG entropy coding on the host: one Huffman-coded scan of 8x8
// coefficient blocks decoded into, or encoded from, int16 arrays, sequential
// (baseline) or progressive.
//
// The pixel stages around it (dequantisation, IDCT, upsampling, colour
// conversion and their inverses) run in PyTorch (utils/jpeg.py); Huffman
// coding is sequential, so it stays on the CPU, as libjpeg keeps it. The
// semantics follow ITU T.81 and libjpeg-turbo's jdhuff.c / jchuff.c:
//
// - decoding: DC prediction per component, EOB and ZRL, byte stuffing
//   (FF 00), FF fill bytes before a marker, restart markers every
//   `restart_interval` MCUs (the bit buffer dropped, the RST number checked,
//   the DC predictors reset); a marker met inside the data feeds zero bits,
//   as libjpeg does on a truncated segment;
// - encoding: the same MCU order, stuffing, and the last byte filled with
//   one bits (libjpeg's flush_bits);
// - progressive scans (jdphuff.c / jcphuff.c): DC first and refinement
//   scans (interleaved or not), AC first scans with EOB runs, AC refinement
//   scans with their correction bits, restarts inside any scan; the encoder
//   gathers each scan's symbol counts first and codes the scan with the
//   optimal tables of jchuff.c's jpeg_gen_optimal_table, which it returns.
//
// Blocks are stored in natural (row-major) order, 64 int16 each.
//
// Built with g++ at first use by nerfpp_tpu_torch/utils/jpeg.py; plain C
// interface, loaded with ctypes.
#include <cstdint>
#include <cstring>

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
  kBadRestart = -3,
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

struct BitReader {
  const uint8_t* data;
  int64_t size;
  int64_t pos;             // next byte to read
  uint64_t buf = 0;        // bits, most significant first
  int bits = 0;
  bool at_marker = false;  // pos is at a marker: feed zero bits

  void fill() {
    while (bits <= 56) {
      uint32_t c = 0;
      if (!at_marker && pos < size) {
        c = data[pos];
        if (c == 0xFF) {
          int64_t q = pos + 1;
          while (q < size && data[q] == 0xFF) ++q;   // fill bytes
          if (q < size && data[q] == 0x00) {
            pos = q + 1;                             // stuffed FF
          } else {
            at_marker = true;                        // leave pos on it
            c = 0;
          }
        } else {
          ++pos;
        }
      }
      buf |= static_cast<uint64_t>(c) << (56 - bits);
      bits += 8;
    }
  }

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

  // drop the buffered bits and step over the RST marker numbered `num`
  bool restart(int num) {
    buf = 0;
    bits = 0;
    at_marker = false;
    while (pos < size && data[pos] != 0xFF) ++pos;   // stray bytes
    while (pos + 1 < size && data[pos + 1] == 0xFF) ++pos;
    if (pos + 1 >= size || data[pos + 1] != 0xD0 + num) return false;
    pos += 2;
    return true;
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

}  // namespace

extern "C" {

int jpeg_entropy_version() { return 1; }

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
  for (int32_t my = 0; my < mcus_y; ++my) {
    for (int32_t mx = 0; mx < mcus_x; ++mx, ++mcu) {
      if (restart_interval > 0 && mcu > 0 && mcu % restart_interval == 0) {
        if (!in.restart(next_rst)) return kBadRestart;
        next_rst = (next_rst + 1) & 7;
        std::memset(pred, 0, sizeof(pred));
      }
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
int64_t jpeg_decode_progressive_scan(
    const uint8_t* data, int64_t size, int64_t start, int32_t n_comp,
    const int32_t* comp_hv, const int32_t* comp_grid,
    const int32_t* comp_tables, const uint8_t* counts, const uint8_t* symbols,
    int32_t mcus_x, int32_t mcus_y, int32_t restart_interval, int32_t ss,
    int32_t se, int32_t ah, int32_t al, int16_t** coefs) {
  const bool dc = ss == 0;
  if (n_comp < 1 || n_comp > 4 || mcus_x < 1 || mcus_y < 1 || start < 0 ||
      (dc ? se != 0 : (ss > se || se > 63 || n_comp != 1)) ||
      (ah && al != ah - 1) || al > 13)
    return kBadArgs;
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
  for (int32_t my = 0; my < mcus_y; ++my) {
    for (int32_t mx = 0; mx < mcus_x; ++mx, ++mcu) {
      if (restart_interval > 0 && mcu > 0 && mcu % restart_interval == 0) {
        if (!in.restart(next_rst)) return kBadRestart;
        next_rst = (next_rst + 1) & 7;
        std::memset(pred, 0, sizeof(pred));
        eobrun = 0;
      }
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

}  // extern "C"
