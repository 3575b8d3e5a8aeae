// TIFF strip and tile compression on the host: LZW (decoding and encoding),
// PackBits, CCITT fax, ThunderScan and SGILog (decoding), the codecs of
// TIFF that OpenCV's libtiff reads and writes. Deflate is zlib's, from
// Python; the predictor and the sample layout are numpy (utils/tiff.py).
//
// - LZW: TIFF's variant (section 13): codes of 9 to 12 bits, most
//   significant bit first, Clear 256 and EndOfInformation 257, the first
//   free entry 258, the code width raised one code early (the decoder reads
//   10 bits once its next free entry is 511, as libtiff's LZWDecode does);
//   the encoder emits Clear first and again when the table is full, as
//   libtiff's LZWEncode does, and EndOfInformation last. Old-style
//   (LSB-first) LZW of libtiff 4.0 and earlier decodes as libtiff's
//   LZWDecodeCompat does.
// - PackBits: a header byte n, n + 1 literal bytes for n in 0..127, the
//   next byte repeated 1 - n times for n in -127..-1, -128 a no-op.
// - CCITT fax (ITU-T T.4 and T.6): Modified Huffman rows byte- or
//   word-aligned (compression 2 and 32771), Group 3 one- or
//   two-dimensional rows each after an EOL (3), Group 4 (4). Decoded as
//   libtiff's tif_fax3.c decodes them, corrupt and cut data included: the
//   same run arrays, the same repairs of a row whose runs do not add up
//   to its width (a run cut or a last run added), the same resynchronising
//   on the next EOL in Group 3, a Group 4 strip ended at an EOL or at the
//   end of its data, and the codes looked up in tables filled as libtiff's
//   mkg3states fills its own (12 bits for white, 13 for black, 7 for the
//   two-dimensional modes; a pattern no code matches consumes no bits).
//   A row's runs alternate white (0 bits) and black (1 bits), starting
//   white; the rows not reached stay 0.
// - ThunderScan (4-bit; tif_thunder.c): runs, 2- and 3-bit deltas and raw
//   nibbles, each row as libtiff 4.7's ThunderDecode writes it (a run
//   that passes the row's end not written; a row short of data or past
//   its end ends the strip, its unpaired last pixel dropped).
// - SGILog (tif_luv.c LogL16Decode / LogLuvDecode32): each row's 2 (LogL)
//   or 4 (LogLuv) byte planes, most significant first, each runs (a byte
//   of 128 and up: the next byte that count less 126 times) and literals;
//   a row short of data stays 0 and ends the strip.
//
// Built with g++ at first use by nerfpp_tpu_torch/utils/tiff.py; plain C
// interface, loaded with ctypes.
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kClear = 256;
constexpr int kEoi = 257;
constexpr int kFirst = 258;
constexpr int kBitsMin = 9;
constexpr int kBitsMax = 12;
constexpr int kCodeMax = (1 << kBitsMax) - 1;

enum Error : int64_t {
  kNoRoom = -2,      // the output buffer is too small (encoding)
};

// libtiff's LZWDecodeCompat: the old-style LZW libtiff 4.0 and earlier
// wrote (data starting 0x00, then a byte of low bit 1: Clear, least
// significant bit first): codes least significant bit first, an entry
// added for every code but the first after a Clear, the width raised once
// the next free entry passes the widest code (one code later than TIFF
// 6.0's). Stops at EndOfInformation, at fewer bits left than a code, at a
// bad code or when out is full; returns the bytes written.
int64_t lzw_decode_old_style(const uint8_t* in, int64_t n, uint8_t* out,
                             int64_t cap) {
  constexpr int kSize = kCodeMax + 1024;      // libtiff's CSIZE
  std::vector<int32_t> prev(kSize, -1), length(kSize, 0);
  std::vector<uint8_t> value(kSize, 0), first(kSize, 0);
  for (int i = 0; i < 256; ++i) {
    value[i] = first[i] = static_cast<uint8_t>(i);
    length[i] = 1;
  }
  int nbits = kBitsMin, mask = (1 << kBitsMin) - 1;
  int free_ent = kFirst, old = 0;
  uint64_t data = 0;
  int nextbits = 0;
  int64_t pos = 0, bitsleft = n * 8, written = 0;
  auto next_code = [&]() -> int {               // GetNextCodeCompat
    if (bitsleft < nbits) return kEoi;
    data |= static_cast<uint64_t>(in[pos++]) << nextbits;
    nextbits += 8;
    if (nextbits < nbits) {
      data |= static_cast<uint64_t>(in[pos++]) << nextbits;
      nextbits += 8;
    }
    int code = static_cast<int>(data & static_cast<uint64_t>(mask));
    data >>= nbits;
    nextbits -= nbits;
    bitsleft -= nbits;
    return code;
  };
  while (written < cap) {
    int code = next_code();
    if (code == kEoi) break;
    if (code == kClear) {
      do {
        free_ent = kFirst;
        std::fill(length.begin() + kFirst, length.end(), 0);
        nbits = kBitsMin;
        mask = (1 << kBitsMin) - 1;
        code = next_code();
      } while (code == kClear);
      if (code == kEoi || code > kClear) break;
      out[written++] = static_cast<uint8_t>(code);
      old = code;
      continue;
    }
    if (free_ent >= kSize) break;
    prev[free_ent] = old;
    first[free_ent] = first[old];
    length[free_ent] = length[old] + 1;
    value[free_ent] = code < free_ent ? first[code] : first[free_ent];
    if (++free_ent > mask) {
      nbits = nbits < kBitsMax ? nbits + 1 : kBitsMax;
      mask = (1 << nbits) - 1;
    }
    old = code;
    if (code < 256) {
      out[written++] = static_cast<uint8_t>(code);
      continue;
    }
    if (length[code] == 0) break;               // a code past the table
    int64_t len = length[code];
    int c = code;
    while (len > cap - written) {               // the prefix that fits
      c = prev[c];
      len = length[c];
    }
    for (int64_t i = len - 1; i >= 0; --i) {
      out[written + i] = value[c];
      c = prev[c];
    }
    written += len;
  }
  return written;
}

}  // namespace

namespace fax {

// what a table entry means (libtiff's S_* states)
enum State : uint8_t {
  kNull, kPass, kHoriz, kV0, kVR, kVL, kExt, kTermW, kTermB, kMakeUpW,
  kMakeUpB, kMakeUp, kEol
};

struct Entry {
  uint8_t state = kNull;
  uint8_t width = 0;      // the bits the code takes
  int32_t param = 0;      // a run length, or a vertical mode's offset
};

// T.4 tables 2 and 3 (terminating codes, runs 0..63), the make-up codes
// (64..1728, by 64) and the extended make-up codes both colours share
// (1792..2560, by 64), most significant bit first
const char* const kWhiteTerm[64] = {
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111",
    "10011", "10100", "00111", "01000", "001000", "000011", "110100",
    "110101", "101010", "101011", "0100111", "0001100", "0001000",
    "0010111", "0000011", "0000100", "0101000", "0101011", "0010011",
    "0100100", "0011000", "00000010", "00000011", "00011010", "00011011",
    "00010010", "00010011", "00010100", "00010101", "00010110", "00010111",
    "00101000", "00101001", "00101010", "00101011", "00101100", "00101101",
    "00000100", "00000101", "00001010", "00001011", "01010010", "01010011",
    "01010100", "01010101", "00100100", "00100101", "01011000", "01011001",
    "01011010", "01011011", "01001010", "01001011", "00110010", "00110011",
    "00110100"};
const char* const kWhiteMakeUp[27] = {
    "11011", "10010", "010111", "0110111", "00110110", "00110111",
    "01100100", "01100101", "01101000", "01100111", "011001100",
    "011001101", "011010010", "011010011", "011010100", "011010101",
    "011010110", "011010111", "011011000", "011011001", "011011010",
    "011011011", "010011000", "010011001", "010011010", "011000",
    "010011011"};
const char* const kBlackTerm[64] = {
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011",
    "000101", "000100", "0000100", "0000101", "0000111", "00000100",
    "00000111", "000011000", "0000010111", "0000011000", "0000001000",
    "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010",
    "000011001011", "000011001100", "000011001101", "000001101000",
    "000001101001", "000001101010", "000001101011", "000011010010",
    "000011010011", "000011010100", "000011010101", "000011010110",
    "000011010111", "000001101100", "000001101101", "000011011010",
    "000011011011", "000001010100", "000001010101", "000001010110",
    "000001010111", "000001100100", "000001100101", "000001010010",
    "000001010011", "000000100100", "000000110111", "000000111000",
    "000000100111", "000000101000", "000001011000", "000001011001",
    "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111"};
const char* const kBlackMakeUp[27] = {
    "0000001111", "000011001000", "000011001001", "000001011011",
    "000000110011", "000000110100", "000000110101", "0000001101100",
    "0000001101101", "0000001001010", "0000001001011", "0000001001100",
    "0000001001101", "0000001110010", "0000001110011", "0000001110100",
    "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010",
    "0000001011011", "0000001100100", "0000001100101"};
const char* const kExtMakeUp[13] = {
    "00000001000", "00000001100", "00000001101", "000000010010",
    "000000010011", "000000010100", "000000010101", "000000010110",
    "000000010111", "000000011100", "000000011101", "000000011110",
    "000000011111"};

// Every index of a `bits`-bit table whose first code bits (the index's
// low bits: the decoder takes the stream least significant bit first)
// spell `code` gets the entry, as mkg3states's FillTable does.
void fill(std::vector<Entry>& table, int bits, const std::string& code,
          State state, int32_t param) {
  int width = static_cast<int>(code.size());
  int low = 0;
  for (int i = 0; i < width; ++i) low |= (code[i] == '1') << i;
  for (int index = low; index < (1 << bits); index += 1 << width)
    table[index] = Entry{state, static_cast<uint8_t>(width), param};
}

struct Tables {
  std::vector<Entry> main = std::vector<Entry>(1 << 7);
  std::vector<Entry> white = std::vector<Entry>(1 << 12);
  std::vector<Entry> black = std::vector<Entry>(1 << 13);
  uint8_t reversed[256];
  Tables() {
    fill(main, 7, "0001", kPass, 0);
    fill(main, 7, "001", kHoriz, 0);
    fill(main, 7, "1", kV0, 0);
    fill(main, 7, "011", kVR, 1);
    fill(main, 7, "000011", kVR, 2);
    fill(main, 7, "0000011", kVR, 3);
    fill(main, 7, "010", kVL, 1);
    fill(main, 7, "000010", kVL, 2);
    fill(main, 7, "0000010", kVL, 3);
    fill(main, 7, "0000001", kExt, 0);
    fill(main, 7, "0000000", kEol, 0);
    for (int k = 0; k < 27; ++k) {
      fill(white, 12, kWhiteMakeUp[k], kMakeUpW, 64 * (k + 1));
      fill(black, 13, kBlackMakeUp[k], kMakeUpB, 64 * (k + 1));
    }
    for (int k = 0; k < 13; ++k) {
      fill(white, 12, kExtMakeUp[k], kMakeUp, 1792 + 64 * k);
      fill(black, 13, kExtMakeUp[k], kMakeUp, 1792 + 64 * k);
    }
    for (int k = 0; k < 64; ++k) {
      fill(white, 12, kWhiteTerm[k], kTermW, k);
      fill(black, 13, kBlackTerm[k], kTermB, k);
    }
    fill(white, 12, "00000000000", kEol, 0);    // an EOL's 11 zeros
    fill(black, 13, "00000000000", kEol, 0);
    for (int b = 0; b < 256; ++b) {
      int r = 0;
      for (int i = 0; i < 8; ++i) r |= ((b >> i) & 1) << (7 - i);
      reversed[b] = static_cast<uint8_t>(r);
    }
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

enum Kind { kRle, kRleWord, kG3OneD, kG3TwoD, kG4 };
enum Step { kDone, kEof, kFail };   // a row's end, the data's, an overflow

// One strip or tile: libtiff's decoder state (Fax3CodecState) and its
// row macros as methods. Runs are uint32, positions int, as there.
class Decoder {
 public:
  Decoder(const uint8_t* in, int64_t n, int lastx, bool two_d,
          bool odd_base)
      : t_(tables()), cp_(in), ep_(in + n), base_(in), odd_(odd_base),
        lastx_(lastx) {
    // libtiff's run arrays: roundup(width + 1, 32) entries a row, twice
    // that for a reference line, a current and a reference array back to
    // back (two spare entries: the fill may write one past a full array)
    nruns_ = static_cast<int>((static_cast<int64_t>(lastx) + 1 + 31) / 32 *
                              32) * (two_d ? 2 : 1);
    runs_.assign(2 * static_cast<size_t>(nruns_) + 2, 0);
    cur_ = runs_.data();
    ref_ = two_d ? runs_.data() + nruns_ : nullptr;
    if (ref_) {                                // an all-white reference
      ref_[0] = static_cast<uint32_t>(lastx);
      ref_[1] = 0;
    }
  }

  int64_t rle(uint8_t* buf, int64_t rows, int64_t rowbytes, bool word);
  int64_t g3(uint8_t* buf, int64_t rows, int64_t rowbytes, bool two_d,
             bool* no_eol);
  int64_t g4(uint8_t* buf, int64_t rows, int64_t rowbytes);

 private:
  // NeedBits8 / NeedBits16: false only when no bit is left; past the
  // data's end the bits asked for are padded with zeros
  bool need(int n) {
    while (avail_ < n) {
      if (cp_ >= ep_) {
        if (avail_ == 0) return false;
        avail_ = n;
        return true;
      }
      acc_ |= static_cast<uint32_t>(t_.reversed[*cp_++]) << avail_;
      avail_ += 8;
    }
    return true;
  }
  uint32_t get(int n) const { return acc_ & ((1u << n) - 1); }
  void clr(int n) {
    avail_ -= n;
    acc_ >>= n;
  }
  bool setvalue(int x) {                       // SETVALUE
    if (pa_ >= row_ + nruns_) return false;
    *pa_++ = static_cast<uint32_t>(run_length_ + x);
    a0_ += x;
    run_length_ = 0;
    return true;
  }
  bool cleanup();
  Step sync_eol();
  Step expand_1d();
  Step expand_2d();
  void fill_row(uint8_t* buf);
  void start_row() {
    a0_ = 0;
    run_length_ = 0;
    pa_ = row_;
  }

  const Tables& t_;
  const uint8_t* cp_;
  const uint8_t* ep_;
  const uint8_t* base_;
  bool odd_;                  // the data starts at an odd file offset
  uint32_t acc_ = 0;
  int avail_ = 0;
  int lastx_;
  int nruns_;
  std::vector<uint32_t> runs_;
  uint32_t* cur_;             // the current and the reference run arrays
  uint32_t* ref_;
  uint32_t* row_ = nullptr;   // thisrun: the row being decoded
  uint32_t* pa_ = nullptr;
  uint32_t* pb_ = nullptr;
  int a0_ = 0;
  int run_length_ = 0;
  int b1_ = 0;
  int eol_count_ = 0;
  bool overflow_ = false;     // a horizontal-mode run overflowed the row
};

// CLEANUP_RUNS: a row whose runs do not reach its width exactly is cut or
// padded to it
bool Decoder::cleanup() {
  if (run_length_ && !setvalue(0)) return false;
  if (a0_ != lastx_) {
    while (a0_ > lastx_ && pa_ > row_) a0_ -= static_cast<int>(*--pa_);
    if (a0_ < lastx_) {
      if (a0_ < 0) a0_ = 0;
      if (((pa_ - row_) & 1) && !setvalue(0)) return false;
      if (!setvalue(lastx_ - a0_)) return false;
    } else if (a0_ > lastx_) {
      if (!setvalue(lastx_) || !setvalue(0)) return false;
    }
  }
  return true;
}

// SYNC_EOL: skip to past the next EOL (its 11 zeros already taken when
// eol_count_ is set), fill bits included. kEof: the data ended before 11
// zeros; kFail: it ended in zeros after them, no EOL's 1 found (libtiff
// 4.5 and later then decode the strip again from its start as Group 3
// without EOLs)
Step Decoder::sync_eol() {
  if (eol_count_ == 0) {
    for (;;) {
      if (!need(11)) return kEof;
      if (get(11) == 0) break;
      clr(1);
    }
  }
  for (;;) {
    if (!need(8)) return kFail;
    if (get(8)) break;
    clr(8);
  }
  while (get(1) == 0) clr(1);
  clr(1);
  eol_count_ = 0;
  return kDone;
}

// EXPAND1D: white and black Modified Huffman runs to the row's end, an
// EOL or a code that is not one (the row then cleaned up as it stands)
Step Decoder::expand_1d() {
  for (;;) {
    for (;;) {
      if (!need(12)) goto eof;
      const Entry& e = t_.white[get(12)];
      clr(e.width);
      if (e.state == kEol) {
        eol_count_ = 1;
        goto done;
      } else if (e.state == kTermW) {
        if (!setvalue(e.param)) return kFail;
        break;
      } else if (e.state == kMakeUpW || e.state == kMakeUp) {
        a0_ += e.param;
        run_length_ += e.param;
      } else {
        goto done;
      }
    }
    if (a0_ >= lastx_) goto done;
    for (;;) {
      if (!need(13)) goto eof;
      const Entry& e = t_.black[get(13)];
      clr(e.width);
      if (e.state == kEol) {
        eol_count_ = 1;
        goto done;
      } else if (e.state == kTermB) {
        if (!setvalue(e.param)) return kFail;
        break;
      } else if (e.state == kMakeUpB || e.state == kMakeUp) {
        a0_ += e.param;
        run_length_ += e.param;
      } else {
        goto done;
      }
    }
    if (a0_ >= lastx_) goto done;
    if (pa_[-1] == 0 && pa_[-2] == 0) pa_ -= 2;
  }
eof:
  if (!cleanup()) return kFail;
  return kEof;
done:
  if (!cleanup()) return kFail;
  return kDone;
}

// EXPAND2D: the modes of T.4 4.2 / T.6 against the reference row (ref_,
// walked by pb_ with b1_ the next change on it)
Step Decoder::expand_2d() {
  const uint32_t* ref_end = ref_ + nruns_;
  // CHECK_b1: b1 moved past a0 by whole colour pairs
  auto check_b1 = [&]() -> bool {
    if (pa_ != row_) {
      while (b1_ <= a0_ && b1_ < lastx_) {
        if (pb_ + 1 >= ref_end) return false;
        b1_ += static_cast<int>(pb_[0] + pb_[1]);
        pb_ += 2;
      }
    }
    return true;
  };
  // one horizontal-mode run of a colour: false at the data's end, `bad`
  // set at a code that is not that colour's
  auto run = [&](bool white, bool& bad) -> bool {
    for (;;) {
      if (!need(white ? 12 : 13)) return false;
      const Entry& e = white ? t_.white[get(12)] : t_.black[get(13)];
      clr(e.width);
      if (e.state == (white ? kTermW : kTermB)) {
        if (!setvalue(e.param)) {
          bad = true;
          overflow_ = true;
        }
        return true;
      }
      if (e.state == (white ? kMakeUpW : kMakeUpB) || e.state == kMakeUp) {
        a0_ += e.param;
        run_length_ += e.param;
      } else {
        bad = true;
        return true;
      }
    }
  };
  overflow_ = false;
  while (a0_ < lastx_) {
    if (pa_ >= row_ + nruns_) return kFail;
    if (!need(7)) goto eof;
    const Entry& e = t_.main[get(7)];
    clr(e.width);
    switch (e.state) {
      case kPass:
        if (!check_b1() || pb_ + 1 >= ref_end) return kFail;
        b1_ += static_cast<int>(*pb_++);
        run_length_ += b1_ - a0_;
        a0_ = b1_;
        b1_ += static_cast<int>(*pb_++);
        break;
      case kHoriz: {
        bool black_first = (pa_ - row_) & 1, bad = false;
        if (!run(!black_first, bad)) goto eof;
        if (overflow_) return kFail;
        if (bad) goto eol;
        if (!run(black_first, bad)) goto eof;
        if (overflow_) return kFail;
        if (bad) goto eol;
        if (!check_b1()) return kFail;
        break;
      }
      case kV0:
        if (!check_b1() || !setvalue(b1_ - a0_) || pb_ >= ref_end)
          return kFail;
        b1_ += static_cast<int>(*pb_++);
        break;
      case kVR:
        if (!check_b1() || !setvalue(b1_ - a0_ + e.param) || pb_ >= ref_end)
          return kFail;
        b1_ += static_cast<int>(*pb_++);
        break;
      case kVL:
        if (!check_b1()) return kFail;
        if (b1_ < a0_ + e.param) goto eol;          // unexpected
        if (!setvalue(b1_ - a0_ - e.param) || pb_ <= ref_) return kFail;
        b1_ -= static_cast<int>(*--pb_);
        break;
      case kExt:                    // uncompressed mode: not decoded
        *pa_++ = static_cast<uint32_t>(lastx_ - a0_);
        goto eol;
      case kEol:
        *pa_++ = static_cast<uint32_t>(lastx_ - a0_);
        if (!need(4)) goto eof;
        clr(4);
        eol_count_ = 1;
        goto eol;
      default:
        goto eol;
    }
  }
  if (run_length_) {
    if (run_length_ + a0_ < lastx_) {        // a final V0 is expected
      if (!need(1)) goto eof;
      if (!get(1)) goto eol;
      clr(1);
    }
    if (!setvalue(0)) return kFail;
  }
eol:
  if (!cleanup()) return kFail;
  return kDone;
eof:
  if (!cleanup()) return kFail;
  return kEof;
}

// _TIFFFax3fillruns: the runs as bits, white 0 and black 1, each cut to
// the row (the cut written back into the run array, which a
// two-dimensional row then reads as its reference)
void Decoder::fill_row(uint8_t* buf) {
  uint32_t* r = row_;
  uint32_t* end = pa_;
  if ((end - r) & 1) *end++ = 0;
  uint32_t x = 0, last = static_cast<uint32_t>(lastx_);
  for (; r < end; r += 2) {
    uint32_t white = r[0];
    if (x + white > last || white > last) white = r[0] = last - x;
    if (white) x += r[0];
    uint32_t black = r[1];
    if (x + black > last || black > last) black = r[1] = last - x;
    if (black) {
      for (uint32_t i = x; i < x + black; ++i)
        buf[i >> 3] |= static_cast<uint8_t>(0x80 >> (i & 7));
      x += r[1];
    }
  }
}

// Fax3DecodeRLE: Modified Huffman rows with no EOL, each ending on a byte
// (or 16-bit word of the file) boundary
int64_t Decoder::rle(uint8_t* buf, int64_t rows, int64_t rowbytes,
                     bool word) {
  row_ = cur_;
  for (int64_t y = 0; y < rows; ++y, buf += rowbytes) {
    start_row();
    Step s = expand_1d();
    if (s == kFail) return -1;
    fill_row(buf);
    if (s == kEof) return -1;
    if (!word) {
      clr(avail_ & 7);
    } else {
      clr(avail_ & 15);
      if (avail_ == 0 && (((cp_ - base_) & 1) != 0) != odd_) ++cp_;
    }
  }
  return 1;
}

// Fax3Decode1D / Fax3Decode2D: each row after an EOL, two-dimensional rows
// tagged by the bit after it. Where the data ends in zeros after an EOL's
// 11 (a strip cut short, or its last row's EOL padded), libtiff sets
// FAXMODE_NOEOL for the rest of the image and decodes the strip again
// from its start into the rows still due, without looking for EOLs
// (*no_eol: that mode, in and out).
int64_t Decoder::g3(uint8_t* buf, int64_t rows, int64_t rowbytes,
                    bool two_d, bool* no_eol) {
  int64_t y = 0;
restart:
  cp_ = base_;
  acc_ = 0;
  avail_ = 0;
  eol_count_ = 0;
  if (!two_d) row_ = cur_;
  for (; y < rows; ++y, buf += rowbytes) {
    if (two_d) row_ = cur_;
    start_row();
    if (!*no_eol) {
      Step sync = sync_eol();
      if (sync == kFail) {
        *no_eol = true;
        goto restart;
      }
      if (sync == kEof) {
        if (!cleanup()) return -1;
        fill_row(buf);
        return -1;
      }
    }
    bool one_d = true;
    if (two_d) {
      if (!need(1)) {
        if (!cleanup()) return -1;
        fill_row(buf);
        return -1;
      }
      one_d = get(1);
      clr(1);
      pb_ = ref_;
      b1_ = static_cast<int>(*pb_++);
    }
    Step s = one_d ? expand_1d() : expand_2d();
    if (s == kFail) return -1;
    fill_row(buf);
    if (s == kEof) return -1;
    if (two_d) {
      if (pa_ < row_ + nruns_) setvalue(0);   // the reference's last change
      std::swap(cur_, ref_);
    }
  }
  return 1;
}

// Fax4Decode: two-dimensional rows back to back; an EOL (the EOFB) or the
// data's end stops the strip, the row at hand filled as it stands
int64_t Decoder::g4(uint8_t* buf, int64_t rows, int64_t rowbytes) {
  for (int64_t y = 0; y < rows; ++y, buf += rowbytes) {
    row_ = cur_;
    start_row();
    pb_ = ref_;
    b1_ = static_cast<int>(*pb_++);
    Step s = expand_2d();
    if (s == kFail) return -1;
    if (s == kEof || eol_count_) {
      fill_row(buf);
      return y > 0 ? 1 : -1;
    }
    fill_row(buf);
    if (!setvalue(0)) return -1;
    std::swap(cur_, ref_);
  }
  return 1;
}

}  // namespace fax

extern "C" {

int tiff_codec_version() { return 2; }

// Decode the LZW data in[n] into out[cap]. Stops at EndOfInformation, at
// the end of the data, at a bad code (libtiff's decoder fails there, and
// its reader keeps what was written) or when out is full; returns the
// bytes written. Old-style data goes to lzw_decode_old_style.
int64_t tiff_lzw_decode(const uint8_t* in, int64_t n, uint8_t* out,
                        int64_t cap) {
  if (n >= 2 && in[0] == 0 && (in[1] & 1))
    return lzw_decode_old_style(in, n, out, cap);
  // entry k: its last byte, its length and its prefix entry
  std::vector<uint8_t> suffix(kCodeMax + 1);
  std::vector<int32_t> length(kCodeMax + 1), prefix(kCodeMax + 1);
  for (int i = 0; i < 256; ++i) {
    suffix[i] = static_cast<uint8_t>(i);
    length[i] = 1;
    prefix[i] = -1;
  }
  std::vector<uint8_t> str(kCodeMax + 2);
  int nbits = kBitsMin;
  int free_ent = kFirst;
  int old = -1;
  int64_t pos = 0, written = 0;
  uint64_t buf = 0;
  int bits = 0;
  for (;;) {
    while (bits < nbits && pos < n) {
      buf = (buf << 8) | in[pos++];
      bits += 8;
    }
    if (bits < nbits) break;                  // the data ran out
    int code = static_cast<int>((buf >> (bits - nbits)) & ((1u << nbits) - 1));
    bits -= nbits;
    if (code == kEoi) break;
    if (code == kClear) {
      nbits = kBitsMin;
      free_ent = kFirst;
      old = -1;
      continue;
    }
    int64_t len;
    if (old < 0) {                            // the first code after Clear
      if (code >= 256) break;
      len = 1;
    } else if (code < free_ent) {
      len = length[code];
    } else if (code == free_ent) {
      len = length[old] + 1;                  // old's string + its first byte
    } else {
      break;
    }
    // the string of `code`, written backwards (code == free_ent: old's
    // string, then its first byte)
    int c = code == free_ent ? old : code;
    int64_t m = code == free_ent ? len - 1 : len;
    for (int64_t i = m - 1; i >= 0; --i) {
      str[i] = suffix[c];
      c = prefix[c];
    }
    if (code == free_ent) str[m] = str[0];
    // past `cap` the data is dropped, as libtiff stops at the strip's size
    int64_t k = written + len > cap ? cap - written : len;
    std::memcpy(out + written, str.data(), static_cast<size_t>(k));
    if (old >= 0 && free_ent <= kCodeMax) {
      suffix[free_ent] = str[0];
      length[free_ent] = length[old] + 1;
      prefix[free_ent] = old;
      ++free_ent;
      if (free_ent > (1 << nbits) - 2 && nbits < kBitsMax) ++nbits;
    }
    written += k;
    old = code;
    if (written == cap) break;
  }
  return written;
}

// Encode in[n] as TIFF LZW into out[cap]; returns the bytes written or a
// negative error.
int64_t tiff_lzw_encode(const uint8_t* in, int64_t n, uint8_t* out,
                        int64_t cap) {
  // child[entry * 256 + byte]: the entry extending `entry` by `byte`, or 0
  std::vector<uint16_t> child(static_cast<size_t>(kCodeMax + 1) * 256, 0);
  int64_t written = 0;
  uint64_t buf = 0;
  int bits = 0;
  int nbits = kBitsMin;
  auto put = [&](int code) -> bool {
    buf = (buf << nbits) | static_cast<uint64_t>(code);
    bits += nbits;
    while (bits >= 8) {
      if (written >= cap) return false;
      out[written++] = static_cast<uint8_t>(buf >> (bits - 8));
      bits -= 8;
    }
    return true;
  };
  int free_ent = kFirst;
  auto grow = [&]() -> bool {             // after an entry was added
    if (free_ent == kCodeMax - 1) {       // the table is full: Clear
      if (!put(kClear)) return false;
      std::fill(child.begin(), child.end(), 0);
      nbits = kBitsMin;
      free_ent = kFirst;
    } else if (free_ent > (1 << nbits) - 1) {
      ++nbits;
    }
    return true;
  };
  if (!put(kClear)) return kNoRoom;
  if (n > 0) {
    int ent = in[0];
    for (int64_t i = 1; i < n; ++i) {
      uint8_t c = in[i];
      uint16_t next = child[static_cast<size_t>(ent) * 256 + c];
      if (next) {
        ent = next;
        continue;
      }
      if (!put(ent)) return kNoRoom;
      child[static_cast<size_t>(ent) * 256 + c] =
          static_cast<uint16_t>(free_ent++);
      ent = c;
      if (!grow()) return kNoRoom;
    }
    if (!put(ent)) return kNoRoom;
    ++free_ent;
    if (!grow()) return kNoRoom;
  }
  if (!put(kEoi)) return kNoRoom;
  if (bits > 0) {
    if (written >= cap) return kNoRoom;
    out[written++] = static_cast<uint8_t>(buf << (8 - bits));
  }
  return written;
}

// Decode PackBits data in[n] into out[cap]; returns the bytes written (the
// output stops at cap, as libtiff stops at the strip's size, and before a
// literal the data cuts short, as libtiff's PackBitsDecode does).
int64_t tiff_packbits_decode(const uint8_t* in, int64_t n, uint8_t* out,
                             int64_t cap) {
  int64_t pos = 0, written = 0;
  while (pos < n && written < cap) {
    int h = static_cast<int8_t>(in[pos++]);
    if (h >= 0) {
      int64_t k = h + 1;
      if (written + k > cap) k = cap - written;
      if (pos + k > n) break;        // a literal cut short: none of it
      std::memcpy(out + written, in + pos, static_cast<size_t>(k));
      pos += h + 1;
      written += k;
    } else if (h != -128) {
      if (pos >= n) break;
      int64_t k = 1 - h;
      if (written + k > cap) k = cap - written;
      std::memset(out + written, in[pos++], static_cast<size_t>(k));
      written += k;
    }
  }
  return written;
}

// Decode ThunderScan data in[n] into `rows` rows of `width` 4-bit pixels,
// (width + 1) / 2 bytes each, which the caller zeroes; returns the rows
// decoded whole (libtiff's decoder fails on the next).
int64_t tiff_thunder_decode(const uint8_t* in, int64_t n, uint8_t* out,
                            int64_t rows, int64_t width) {
  static const int kTwoBit[4] = {0, 1, 0, -1};
  static const int kThreeBit[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  const uint8_t* bp = in;
  int64_t cc = n;
  const int64_t rowbytes = (width + 1) / 2;
  for (int64_t y = 0; y < rows; ++y) {
    uint8_t* row = out + y * rowbytes;
    uint8_t* op = row;
    unsigned lastpixel = 0;
    int64_t npixels = 0;
    auto set = [&](unsigned v) {                  // SETPIXEL
      lastpixel = v & 0xf;
      if (npixels < width) {
        if (npixels++ & 1)
          *op++ |= static_cast<uint8_t>(lastpixel);
        else
          op[0] = static_cast<uint8_t>(lastpixel << 4);
      }
    };
    while (cc > 0 && npixels < width) {
      int c = *bp++;
      --cc;
      int delta;
      switch (c & 0xc0) {
        case 0x00: {                              // a run of the last pixel
          int k = c;
          if (npixels & 1) {
            op[0] |= static_cast<uint8_t>(lastpixel);
            lastpixel = *op++;
            ++npixels;
            --k;
          } else {
            lastpixel |= lastpixel << 4;
          }
          npixels += k;
          if (npixels <= width)
            for (; k > 0; k -= 2) *op++ = static_cast<uint8_t>(lastpixel);
          if (k == -1) *--op &= 0xf0;
          lastpixel &= 0xf;
          break;
        }
        case 0x40:                                // three 2-bit deltas
          if ((delta = (c >> 4) & 3) != 2) set(lastpixel + kTwoBit[delta]);
          if ((delta = (c >> 2) & 3) != 2) set(lastpixel + kTwoBit[delta]);
          if ((delta = c & 3) != 2) set(lastpixel + kTwoBit[delta]);
          break;
        case 0x80:                                // two 3-bit deltas
          if ((delta = (c >> 3) & 7) != 4) set(lastpixel + kThreeBit[delta]);
          if ((delta = c & 7) != 4) set(lastpixel + kThreeBit[delta]);
          break;
        default:                                  // a raw pixel
          set(static_cast<unsigned>(c));
          break;
      }
    }
    if (npixels != width) {
      // a failed row keeps its whole bytes only, as libtiff's reader does
      if ((npixels & 1) && op < row + rowbytes) *op = 0;
      return y;
    }
  }
  return rows;
}

// Decode SGILog data in[n] into `rows` rows of `width` words of `planes`
// bytes (2: LogL, 4: LogLuv); returns the rows decoded whole, the rest 0.
int64_t tiff_sgilog_decode(const uint8_t* in, int64_t n, uint32_t* out,
                           int64_t rows, int64_t width, int64_t planes) {
  const uint8_t* bp = in;
  int64_t cc = n;
  for (int64_t y = 0; y < rows; ++y) {
    uint32_t* tp = out + y * width;
    for (int shift = 8 * static_cast<int>(planes - 1); shift >= 0;
         shift -= 8) {
      int64_t i = 0;
      while (i < width && cc > 0) {
        if (*bp >= 128) {                         // a run
          if (cc < 2) break;
          int rc = *bp++ + (2 - 128);
          uint32_t b = static_cast<uint32_t>(*bp++) << shift;
          cc -= 2;
          while (rc-- && i < width) tp[i++] |= b;
        } else {                                  // literals
          int rc = *bp++;
          while (--cc && rc-- && i < width)
            tp[i++] |= static_cast<uint32_t>(*bp++) << shift;
        }
      }
      if (i != width) {
        std::memset(tp, 0, static_cast<size_t>(width) * sizeof(uint32_t));
        return y;
      }
    }
  }
  return rows;
}

// Decode one strip or tile of CCITT fax data in[n] (most significant bit
// first) into out: `rows` rows of `width` pixels, (width + 7) / 8 bytes
// each, which the caller zeroes; cut or corrupt data as libtiff's decoder
// leaves it. kind: 0 Modified Huffman (compression 2), 1 the same
// word-aligned (32771), 2 Group 3 1-D, 3 Group 3 2-D (T4Options bit 0), 4
// Group 4. flags: bit 0, the data starts at an odd file offset (RLEW
// aligns to the file's words, as libtiff's mapped file does); bit 1, Group
// 3 without EOLs (libtiff's FAXMODE_NOEOL, set by an earlier strip of the
// image). Returns that Group 3 mode for the image's next strip (0 or 1).
int64_t tiff_fax_decode(const uint8_t* in, int64_t n, uint8_t* out,
                        int64_t rows, int64_t width, int64_t kind,
                        int64_t flags) {
  bool two_d = kind == fax::kG3TwoD || kind == fax::kG4;
  bool no_eol = (flags & 2) != 0;
  fax::Decoder d(in, n, static_cast<int>(width), two_d, (flags & 1) != 0);
  int64_t rowbytes = (width + 7) / 8;
  if (kind == fax::kRle || kind == fax::kRleWord)
    d.rle(out, rows, rowbytes, kind == fax::kRleWord);
  else if (kind == fax::kG4)
    d.g4(out, rows, rowbytes);
  else
    d.g3(out, rows, rowbytes, kind == fax::kG3TwoD, &no_eol);
  return no_eol ? 1 : 0;
}

}  // extern "C"
