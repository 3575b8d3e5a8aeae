// TIFF strip and tile compression on the host: LZW (decoding and encoding)
// and PackBits (decoding), the sequential codecs of TIFF 6.0 that OpenCV's
// libtiff reads and writes. Deflate is zlib's, from Python; the predictor
// and the sample layout are numpy (utils/tiff.py).
//
// - LZW: TIFF's variant (section 13): codes of 9 to 12 bits, most
//   significant bit first, Clear 256 and EndOfInformation 257, the first
//   free entry 258, the code width raised one code early (the decoder reads
//   10 bits once its next free entry is 511, as libtiff's LZWDecode does);
//   the encoder emits Clear first and again when the table is full, as
//   libtiff's LZWEncode does, and EndOfInformation last. Old-style
//   (LSB-first) LZW of libtiff 4.0 and earlier is refused.
// - PackBits: a header byte n, n + 1 literal bytes for n in 0..127, the
//   next byte repeated 1 - n times for n in -127..-1, -128 a no-op.
//
// Built with g++ at first use by nerfpp_tpu_torch/utils/tiff.py; plain C
// interface, loaded with ctypes.
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kClear = 256;
constexpr int kEoi = 257;
constexpr int kFirst = 258;
constexpr int kBitsMin = 9;
constexpr int kBitsMax = 12;
constexpr int kCodeMax = (1 << kBitsMax) - 1;

enum Error : int64_t {
  kBadCode = -1,     // a code past the table, or data before a Clear
  kNoRoom = -2,      // the output buffer is too small (encoding)
  kOldStyle = -3,    // old-style LZW
};

}  // namespace

extern "C" {

int tiff_codec_version() { return 1; }

// Decode the LZW data in[n] into out[cap]. Stops at EndOfInformation, at
// the end of the data or when out is full; returns the bytes written or a
// negative error.
int64_t tiff_lzw_decode(const uint8_t* in, int64_t n, uint8_t* out,
                        int64_t cap) {
  if (n >= 2 && in[0] == 0 && (in[1] & 1)) return kOldStyle;
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
      if (code >= 256) return kBadCode;
      len = 1;
    } else if (code < free_ent) {
      len = length[code];
    } else if (code == free_ent) {
      len = length[old] + 1;                  // old's string + its first byte
    } else {
      return kBadCode;
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
// output stops at cap, as libtiff stops at the strip's size).
int64_t tiff_packbits_decode(const uint8_t* in, int64_t n, uint8_t* out,
                             int64_t cap) {
  int64_t pos = 0, written = 0;
  while (pos < n && written < cap) {
    int h = static_cast<int8_t>(in[pos++]);
    if (h >= 0) {
      int64_t k = h + 1;
      if (pos + k > n) k = n - pos;
      if (written + k > cap) k = cap - written;
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

}  // extern "C"
