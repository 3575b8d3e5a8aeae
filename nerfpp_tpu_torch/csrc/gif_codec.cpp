// GIF's sequential passes on the host, as OpenCV 5.0's imgcodecs runs
// them, so that the port reads and writes GIF as cv2.imread and
// cv2.imwrite do: the LZW decoder, the LZW encoder and the writer's
// palette mapping with its error diffusion. The container (header, colour
// tables, extensions, the scan of every block), the palette gather, the
// de-interlacing and the canvas are utils/gif.py's, in PyTorch on the
// device.
//
// - Decoding (gif_lzw_decode) starts at the minimum code size byte (2 to
//   11, else refused) and reads the data sub-blocks a byte at a time,
//   decoding every whole code after each byte, least significant bit
//   first. A clear code resets the table and the code width; so does the
//   end code, which also ends the codes taken from the current byte, but
//   not the data: the codes of the bytes after it are decoded as a new
//   stream. The width grows when the next free code reaches 1 << width,
//   up to 12 bits; a full table (4,096 codes) takes no new entries and
//   decoding goes on (a "deferred clear"). A literal of a minimum code
//   size above 8 keeps its low 8 bits. OpenCV's limits, found by probing
//   cv2.imread: a code above the next free one (or a first code after a
//   clear that is not a literal) and a string that passes the last pixel
//   refuse the file; once every pixel is decoded, the next data code is
//   dropped, and any byte read after that refuses the file (a code from
//   the last byte's bits alone does not); fewer pixels than the frame
//   holds, or data that ends before its block terminator, refuse it.
// - Encoding (gif_lzw_encode) is the greedy coder of OpenCV's GifEncoder:
//   a clear code first, the width grown once the next free code passes 1
//   << width, a clear code (at the width reached) once the table holds
//   4,096 codes, the end code last; 255-byte sub-blocks and the
//   terminator.
// - gif_dither is the writer's default colour reduction: the fixed 3-3-2
//   palette (R and G in steps of 36, B in steps of 85), each channel
//   rounded to its nearest level, ties up, and Floyd-Steinberg error
//   diffusion (7, 3, 5, 1 sixteenths, left to right on every row) in
//   float, without clamping, each pixel's error summed apart from it in
//   raster order of the pixels that spread it (the sum's rounding decides
//   ties); a pixel of alpha 0 takes the transparent
//   index 0x92 and spreads no error, and when the image has one, an
//   opaque pixel that lands on 0x92 is written as 0x8e (its error is the
//   0x92 colour's), and the palette's entry 0x92 holds the colour of the
//   last pixel of alpha 0.
//
// Built with g++ at first use by nerfpp_tpu_torch/utils/gif.py through
// native.build_library; plain C interface, loaded with ctypes.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Error : int64_t {
  kCodeSize = -1,   // a minimum code size outside 2..11
  kCut = -2,        // the data ends before its block terminator
  kBadCode = -3,    // a code above the next free one
  kTooLong = -4,    // a string past the last pixel, or bytes after it
  kTooShort = -5,   // fewer pixels than the frame holds
  kNoRoom = -6,     // the output buffer is too small (encoding)
};

constexpr int kMaxCodes = 4096;
constexpr uint8_t kTransparent = 0x92;

}  // namespace

extern "C" {

// LZW data from the minimum code size byte ``src[0]`` on (``n`` bytes
// available) -> ``npix`` palette indices in ``out``. Returns the bytes
// consumed (through the block terminator) or an Error.
int64_t gif_lzw_decode(const uint8_t* src, int64_t n, int64_t npix,
                       uint8_t* out) {
  if (n < 1) return kCut;
  const int mcs = src[0];
  if (mcs < 2 || mcs > 11) return kCodeSize;
  const int clear = 1 << mcs, end = clear + 1;
  std::vector<int32_t> prefix(kMaxCodes), length(kMaxCodes);
  std::vector<uint8_t> suffix(kMaxCodes), first(kMaxCodes);
  int width = mcs + 1, next = end, prev = -1;
  int64_t pos = 1, idx = 0;
  uint32_t bits = 0;
  int left = 0;
  bool full = false;   // every pixel decoded and one more code dropped
  if (pos >= n) return kCut;
  int block = src[pos++];
  while (block) {
    if (full) return kTooLong;
    if (left < width) {
      if (pos >= n) return kCut;
      bits |= uint32_t(src[pos++]) << left;
      --block;
      left += 8;
    }
    while (left >= width) {
      const int code = bits & ((1u << width) - 1);
      bits >>= width;
      left -= width;
      if (code == clear || code == end) {
        width = mcs + 1;
        next = end;
        prev = -1;
        if (code == end) break;
        continue;
      }
      if (idx == npix) {
        full = true;
        continue;
      }
      int len;
      uint8_t head;
      if (code < clear) {
        len = 1;
        head = uint8_t(code);
      } else if (code > end && code < next) {
        len = length[code];
        head = first[code];
      } else if (code == next && prev >= 0) {
        len = length[prev] + 1;
        head = first[prev];
      } else {
        return kBadCode;
      }
      if (idx + len > npix) return kTooLong;
      if (next < kMaxCodes) {
        if (prev >= 0) {
          prefix[next] = prev;
          suffix[next] = head;
          length[next] = length[prev] + 1;
          first[next] = first[prev];
          ++next;
        } else {
          next = end + 1;
        }
        if (next == (1 << width) && width < 12) ++width;
      }
      if (code < clear) {
        length[code] = 1;
        first[code] = head;
        out[idx] = head;
      } else {
        int c = code;
        for (int64_t k = idx + len - 1; k > idx; --k) {
          out[k] = suffix[c];
          c = prefix[c];
        }
        out[idx] = head;
      }
      idx += len;
      prev = code;
    }
    if (!block) {
      if (pos >= n) return kCut;
      block = src[pos++];
    }
  }
  if (idx < npix) return kTooShort;
  return pos;
}

// ``n`` palette indices -> OpenCV's LZW sub-blocks at minimum code size
// ``mcs`` (through the block terminator) in ``out`` (``cap`` bytes).
// Returns the byte count or kNoRoom.
int64_t gif_lzw_encode(const uint8_t* idx, int64_t n, int mcs, uint8_t* out,
                       int64_t cap) {
  const int clear = 1 << mcs, end = clear + 1;
  // child[code * 256 + pixel]: the code of string(code) + pixel, 0 if none
  std::vector<uint16_t> child(size_t(kMaxCodes) * 256, 0);
  std::vector<int> used;
  std::vector<uint8_t> data;
  data.reserve(size_t(n) * 3 / 2 + 16);
  uint64_t acc = 0;
  int nacc = 0, width = mcs + 1, next = end + 1;
  auto put = [&](int code) {
    acc |= uint64_t(code) << nacc;
    nacc += width;
    while (nacc >= 8) {
      data.push_back(uint8_t(acc));
      acc >>= 8;
      nacc -= 8;
    }
  };
  auto reset = [&]() {
    for (int k : used) child[k] = 0;
    used.clear();
    width = mcs + 1;
    next = end + 1;
  };
  put(clear);
  if (n > 0) {
    int s = idx[0];
    for (int64_t i = 1; i < n; ++i) {
      const int p = idx[i];
      const int k = s * 256 + p;
      if (child[k]) {
        s = child[k];
        continue;
      }
      put(s);
      child[k] = uint16_t(next);
      used.push_back(k);
      ++next;
      if (next > (1 << width) && width < 12) ++width;
      if (next == kMaxCodes) {
        put(clear);
        reset();
      }
      s = p;
    }
    put(s);
  }
  put(end);
  if (nacc) data.push_back(uint8_t(acc));
  const int64_t need = int64_t(data.size()) + (int64_t(data.size()) + 254) /
                       255 + 1;
  if (need > cap) return kNoRoom;
  int64_t o = 0;
  for (size_t i = 0; i < data.size(); i += 255) {
    const size_t take = std::min<size_t>(255, data.size() - i);
    out[o++] = uint8_t(take);
    std::memcpy(out + o, data.data() + i, take);
    o += int64_t(take);
  }
  out[o++] = 0;
  return o;
}

// uint8 RGB or RGBA [h, w, channels] -> palette indices [h, w] of the
// fixed 3-3-2 palette. Returns 1 if some pixel has alpha 0 (the image is
// then written with the transparent index, whose palette entry OpenCV
// sets to the colour of the last such pixel in raster order, written to
// ``key``), else 0.
int64_t gif_dither(const uint8_t* img, int64_t h, int64_t w, int channels,
                   uint8_t* out, uint8_t* key) {
  const float step[3] = {36.f, 36.f, 85.f};
  const int top[3] = {7, 7, 3};
  const int shift[3] = {5, 2, 0};
  bool transparent = false;
  if (channels == 4)
    for (int64_t i = 0; i < h * w && !transparent; ++i)
      transparent = img[i * 4 + 3] == 0;
  // the diffused error of this row and the next, each pixel's three
  // channels; a pixel's value is its own plus its error, in float
  std::vector<float> cur(size_t(w) * 3, 0.f), below(size_t(w) * 3, 0.f);
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* row = img + y * w * channels;
    std::fill(below.begin(), below.end(), 0.f);
    for (int64_t x = 0; x < w; ++x) {
      if (channels == 4 && row[x * 4 + 3] == 0) {
        out[y * w + x] = kTransparent;
        std::memcpy(key, row + x * 4, 3);
        continue;
      }
      int index = 0;
      for (int c = 0; c < 3; ++c) {
        const float v = float(row[x * channels + c]) + cur[x * 3 + c];
        int k = int(std::floor(v / step[c] + 0.5f));
        k = k < 0 ? 0 : (k > top[c] ? top[c] : k);
        index |= k << shift[c];
        const float e = v - float(k) * step[c];
        if (x + 1 < w) cur[(x + 1) * 3 + c] += e * 7.f / 16.f;
        if (x > 0) below[(x - 1) * 3 + c] += e * 3.f / 16.f;
        below[x * 3 + c] += e * 5.f / 16.f;
        if (x + 1 < w) below[(x + 1) * 3 + c] += e * 1.f / 16.f;
      }
      if (transparent && index == kTransparent) index = kTransparent - 4;
      out[y * w + x] = uint8_t(index);
    }
    cur.swap(below);
  }
  return transparent ? 1 : 0;
}

}  // extern "C"
