// Baseline JPEG entropy coding on the host: one Huffman-coded scan of 8x8
// coefficient blocks decoded into, or encoded from, int16 arrays.
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
//   one bits (libjpeg's flush_bits).
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

}  // extern "C"
