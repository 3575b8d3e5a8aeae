// Run-length passes of the uncompressed image formats on the host: BMP's
// RLE8 and RLE4 (decoding) and Radiance HDR's scanline coding (decoding
// and encoding), each as OpenCV 5.0's imgcodecs runs it, so that the port
// reads and writes these files as cv2.imread and cv2.imwrite do. The
// palette lookup, the RGBE conversion and the layout are numpy and
// PyTorch (utils/bmp.py, utils/hdr.py).
//
// - BMP RLE8 / RLE4 decode into palette indices, the first decoded row
//   first (the bottom row of a bottom-up file). A pair (n, v) with n > 0 is
//   a run of n pixels; (0, n > 2) n literal indices padded to an even byte
//   count; (0, 0) ends the line, (0, 1) the bitmap and (0, 2) dx dy skips
//   dx + dy * width pixels. Skipped pixels take index 0, as OpenCV fills
//   them with the palette's first colour. OpenCV's RLE4 differs: an
//   end-of-bitmap ends only the line, like an end-of-line, and a delta
//   skips dx pixels alone (dy is read and dropped); kept. A run or literal that passes the
//   end of its line is refused (OpenCV stops and returns no image), except
//   that an RLE8 run may end exactly at the line's end: it then wraps to
//   the next line, and an end-of-line right after it does not skip another
//   line.
// - HDR: scanlines of width 8 to 32767 are new-style run-length coded
//   (2, 2, w >> 8, w & 255, then the four byte planes, each as runs (128 +
//   n, v) and literals (n, n bytes)); a scanline that does not start with
//   that header is, with every pixel after it, read flat (four bytes a
//   pixel; old-style runs are not expanded, as OpenCV's rgbe.cpp does not
//   expand them). Other widths are flat throughout. The encoder is
//   rgbe.cpp's RGBE_WriteBytes_RLE: runs of at least 4 as (128 + n, v), a
//   short run just before a long one as its own run, literals of at most
//   128 bytes.
//
// Built with g++ at first use by nerfpp_tpu_torch/utils/bmp.py and
// utils/hdr.py through native.build_library; plain C interface, loaded
// with ctypes.
#include <algorithm>
#include <cstdint>
#include <cstring>

namespace {

enum Error : int64_t {
  kBad = -1,        // data OpenCV refuses (a run past the line, a bad count)
  kShort = -2,      // the data ends before the image does
  kNoRoom = -3,     // the output buffer is too small (encoding)
};

// OpenCV's FillUniColor in pixel units: `count` pixels of index v from
// (x, y), wrapping at the line's end; stops once y reaches h.
void fill(uint8_t* out, int64_t w, int64_t h, int64_t& x, int64_t& y,
          int64_t count, uint8_t v) {
  do {
    int64_t take = std::min(count, w - x);
    if (take > 0) std::memset(out + y * w + x, v, take);
    x += take;
    count -= take;
    if (x >= w) {
      x = 0;
      if (++y >= h) break;
    }
  } while (count > 0);
}

// rgbe.cpp's RGBE_WriteBytes_RLE of one byte plane of a scanline.
int64_t rle_plane(const uint8_t* data, int64_t numbytes, uint8_t* out,
                  int64_t cap) {
  constexpr int64_t kMinRun = 4;
  int64_t cur = 0, o = 0;
  auto put = [&](uint8_t b) -> bool {
    if (o >= cap) return false;
    out[o++] = b;
    return true;
  };
  while (cur < numbytes) {
    int64_t beg_run = cur, run_count = 0, old_run_count = 0;
    while (run_count < kMinRun && beg_run < numbytes) {
      beg_run += run_count;
      old_run_count = run_count;
      run_count = 1;
      while (beg_run + run_count < numbytes && run_count < 127 &&
             data[beg_run] == data[beg_run + run_count])
        run_count++;
    }
    if (old_run_count > 1 && old_run_count == beg_run - cur) {
      if (!put(static_cast<uint8_t>(128 + old_run_count)) || !put(data[cur]))
        return kNoRoom;
      cur = beg_run;
    }
    while (cur < beg_run) {
      int64_t nonrun = std::min<int64_t>(beg_run - cur, 128);
      if (!put(static_cast<uint8_t>(nonrun))) return kNoRoom;
      for (int64_t i = 0; i < nonrun; ++i)
        if (!put(data[cur + i])) return kNoRoom;
      cur += nonrun;
    }
    if (run_count >= kMinRun) {
      if (!put(static_cast<uint8_t>(128 + run_count)) ||
          !put(data[beg_run]))
        return kNoRoom;
      cur += run_count;
    }
  }
  return o;
}

}  // namespace

extern "C" {

int image_rle_version() { return 1; }

// Decode BMP RLE8 data in[n] into out[h * w] palette indices. Returns the
// bytes read or a negative error.
int64_t bmp_rle8_decode(const uint8_t* in, int64_t n, int64_t w, int64_t h,
                        uint8_t* out) {
  int64_t pos = 0, x = 0, y = 0, line_end_flag = 0;
  for (;;) {
    if (pos + 2 > n) return kShort;
    int64_t len = in[pos], code = in[pos + 1];
    pos += 2;
    if (len != 0) {                              // a run
      int64_t prev_y = y;
      if (x + len > w) return kBad;
      fill(out, w, h, x, y, len, static_cast<uint8_t>(code));
      line_end_flag = y - prev_y;
      if (y >= h) break;
    } else if (code > 2) {                       // literal indices
      if (x + code > w) return kBad;
      int64_t size = (code + 1) & ~int64_t{1};
      if (pos + size > n) return kShort;
      std::memcpy(out + y * w + x, in + pos, code);
      pos += size;
      x += code;
      line_end_flag = 0;
    } else {                                     // end of line / bitmap, delta
      int64_t x_shift = w - x, y_shift = h - y;
      if (code || !line_end_flag || x_shift < w) {
        if (code == 2) {
          if (pos + 2 > n) return kShort;
          x_shift = in[pos];
          y_shift = in[pos + 1];
          pos += 2;
        }
        if (code != 0) x_shift += y_shift * w;
        fill(out, w, h, x, y, x_shift, 0);
        if (y >= h) break;
      }
      line_end_flag = 0;
    }
  }
  return pos;
}

// Decode BMP RLE4 data in[n] into out[h * w] palette indices (the high
// nibble first). Returns the bytes read or a negative error.
int64_t bmp_rle4_decode(const uint8_t* in, int64_t n, int64_t w, int64_t h,
                        uint8_t* out) {
  int64_t pos = 0, x = 0, y = 0;
  for (;;) {
    if (pos + 2 > n) return kShort;
    int64_t len = in[pos], code = in[pos + 1];
    pos += 2;
    if (len != 0) {                              // a run of two alternating
      if (x + len > w) return kBad;
      uint8_t* row = out + y * w + x;
      for (int64_t i = 0; i < len; ++i)
        row[i] = static_cast<uint8_t>((i & 1) ? (code & 15) : (code >> 4));
      x += len;
    } else if (code > 2) {                       // literal nibbles
      if (x + code > w) return kBad;
      int64_t size = (((code + 1) >> 1) + 1) & ~int64_t{1};
      if (pos + size > n) return kShort;
      uint8_t* row = out + y * w + x;
      for (int64_t i = 0; i < code; ++i) {
        uint8_t b = in[pos + i / 2];
        row[i] = static_cast<uint8_t>((i & 1) ? (b & 15) : (b >> 4));
      }
      pos += size;
      x += code;
    } else {                 // end of line or bitmap: the line; a delta:
      int64_t x_shift = w - x;                   // dx alone (dy is read)
      if (code == 2) {
        if (pos + 2 > n) return kShort;
        x_shift = in[pos];
        pos += 2;
      }
      fill(out, w, h, x, y, x_shift, 0);
      if (y >= h) break;
    }
  }
  return pos;
}

// Decode Radiance HDR pixel data in[n] of an h x w image into out[h * w
// * 4] RGBE bytes. Returns the bytes read or a negative error.
int64_t hdr_decode(const uint8_t* in, int64_t n, int64_t w, int64_t h,
                   uint8_t* out) {
  const int64_t total = w * h;
  auto flat = [&](int64_t pos, int64_t first) -> int64_t {
    int64_t bytes = (total - first) * 4;
    if (pos + bytes > n) return kShort;
    std::memcpy(out + first * 4, in + pos, bytes);
    return pos + bytes;
  };
  if (w < 8 || w > 0x7fff) return flat(0, 0);
  int64_t pos = 0;
  for (int64_t y = 0; y < h; ++y) {
    if (pos + 4 > n) return kShort;
    const uint8_t* head = in + pos;
    if (head[0] != 2 || head[1] != 2 || (head[2] & 0x80))
      return flat(pos, y * w);                   // the rest is flat
    if (((head[2] << 8) | head[3]) != w) return kBad;
    pos += 4;
    uint8_t* row = out + y * w * 4;
    for (int c = 0; c < 4; ++c) {
      int64_t p = 0;
      while (p < w) {
        if (pos + 2 > n) return kShort;
        int64_t b0 = in[pos], b1 = in[pos + 1];
        pos += 2;
        int64_t count = b0 > 128 ? b0 - 128 : b0;
        if (count == 0 || count > w - p) return kBad;
        if (b0 > 128) {
          for (int64_t i = 0; i < count; ++i)
            row[(p + i) * 4 + c] = static_cast<uint8_t>(b1);
        } else {
          row[p * 4 + c] = static_cast<uint8_t>(b1);
          if (pos + count - 1 > n) return kShort;
          for (int64_t i = 1; i < count; ++i)
            row[(p + i) * 4 + c] = in[pos + i - 1];
          pos += count - 1;
        }
        p += count;
      }
    }
  }
  return pos;
}

// Encode an h x w image of RGBE bytes rgbe[h * w * 4] (8 <= w <= 32767)
// as new-style run-length scanlines into out[cap]. Returns the bytes
// written or a negative error.
int64_t hdr_encode(const uint8_t* rgbe, int64_t w, int64_t h, uint8_t* out,
                   int64_t cap) {
  if (w < 8 || w > 0x7fff) return kBad;
  uint8_t* plane = new uint8_t[w];
  int64_t o = 0;
  for (int64_t y = 0; y < h; ++y) {
    if (o + 4 > cap) {
      delete[] plane;
      return kNoRoom;
    }
    out[o++] = 2;
    out[o++] = 2;
    out[o++] = static_cast<uint8_t>(w >> 8);
    out[o++] = static_cast<uint8_t>(w & 0xFF);
    for (int c = 0; c < 4; ++c) {
      for (int64_t i = 0; i < w; ++i) plane[i] = rgbe[(y * w + i) * 4 + c];
      int64_t k = rle_plane(plane, w, out + o, cap - o);
      if (k < 0) {
        delete[] plane;
        return k;
      }
      o += k;
    }
  }
  delete[] plane;
  return o;
}

}  // extern "C"
