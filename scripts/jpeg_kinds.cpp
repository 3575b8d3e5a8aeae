// Arithmetic-coded JPEG scans written from quantised blocks, as
// libjpeg-turbo's jcarith.c codes them (ITU T.81 Annex D, F.1.4 and
// G.1.3): the QM coder with its carry handling (stacked FF bytes, zero
// bytes held back, the spacer bits of C), the DC bins conditioned on the
// previous difference by the DAC bounds L and U, the AC bins split at Kx,
// sequential scans and the four kinds of progressive scan, a restart
// marker every `restart_interval` MCUs (the coder flushed, the statistics
// reset), and the termination of D.1.8.
//
// Support for the tests and chip_smoke.py (scripts/jpeg_kinds.py builds it
// with g++ at first use through nerfpp_tpu_torch.native.build_library):
// neither package writes arithmetic-coded JPEG; the port only reads it
// (nerfpp_tpu_torch/csrc/jpeg_entropy.cpp). Plain C interface, loaded with
// ctypes. Blocks are in natural (row-major) order, 64 int16 each.
#include <cstdint>
#include <cstring>

namespace {

const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// T.81 Table D.2 (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS) and
// libjpeg's fixed state 113
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

struct Coder {
  uint8_t* out;
  int64_t cap;
  int64_t n = 0;
  bool full = false;
  int64_t c = 0;
  int64_t a = 0x10000;
  int64_t sc = 0;          // stacked FF bytes
  int64_t zc = 0;          // zero bytes held back
  int ct = 11;             // bits before the next byte is ready
  int buffer = -1;         // the byte that a carry may still change

  void emit(int b) {
    if (n >= cap) {
      full = true;
      return;
    }
    out[n++] = static_cast<uint8_t>(b);
  }
  void zeros() {
    for (; zc > 0; --zc) emit(0x00);
  }

  void encode(uint8_t* st, int val) {
    int sv = *st;
    const QeState& q = kQe[sv & 0x7F];
    int64_t qe = q.qe;
    int nl = q.nlps | (q.swtch << 7), nm = q.nmps;
    a -= qe;
    if (val != (sv >> 7)) {                       // the LPS
      if (a >= qe) {
        c += a;
        a = qe;
      }
      *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
    } else {                                      // the MPS
      if (a >= 0x8000) return;
      if (a < qe) {
        c += a;
        a = qe;
      }
      *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
    }
    do {                                          // D.1.6
      a <<= 1;
      c <<= 1;
      if (--ct == 0) {
        int64_t temp = c >> 19;
        if (temp > 0xFF) {                        // a carry
          if (buffer >= 0) {
            zeros();
            emit(buffer + 1);
            if (buffer + 1 == 0xFF) emit(0x00);
          }
          zc += sc;
          sc = 0;
          buffer = static_cast<int>(temp & 0xFF);
        } else if (temp == 0xFF) {
          ++sc;
        } else {
          if (buffer == 0) {
            ++zc;
          } else if (buffer >= 0) {
            zeros();
            emit(buffer);
          }
          if (sc) {
            zeros();
            for (; sc > 0; --sc) {
              emit(0xFF);
              emit(0x00);
            }
          }
          buffer = static_cast<int>(temp & 0xFF);
        }
        c &= 0x7FFFF;
        ct += 8;
      }
    } while (a < 0x8000);
  }

  void finish() {                                 // D.1.8
    int64_t temp = (a - 1 + c) & 0xFFFF0000L;
    c = temp < c ? temp + 0x8000 : temp;
    c <<= ct;
    if (c & 0xF8000000L) {
      if (buffer >= 0) {
        zeros();
        emit(buffer + 1);
        if (buffer + 1 == 0xFF) emit(0x00);
      }
      zc += sc;
      sc = 0;
    } else {
      if (buffer == 0) {
        ++zc;
      } else if (buffer >= 0) {
        zeros();
        emit(buffer);
      }
      if (sc) {
        zeros();
        for (; sc > 0; --sc) {
          emit(0xFF);
          emit(0x00);
        }
      }
    }
    if (c & 0x7FFF800L) {
      zeros();
      emit(static_cast<int>((c >> 19) & 0xFF));
      if (((c >> 19) & 0xFF) == 0xFF) emit(0x00);
      if (c & 0x7F800L) {
        emit(static_cast<int>((c >> 11) & 0xFF));
        if (((c >> 11) & 0xFF) == 0xFF) emit(0x00);
      }
    }
    c = 0;
    a = 0x10000;
    sc = zc = 0;
    ct = 11;
    buffer = -1;
  }
};

struct Stats {
  uint8_t dc[16][64];
  uint8_t ac[16][256];
  uint8_t fixed = 113;
  const uint8_t* cond;     // L [16], U [16], Kx [16]
};

// the magnitude category and bits of v - 1 > 0 ... (Figures F.8, F.9),
// `st` the category's first bin, `x1` the bin of its second and later
// decisions
void magnitude(Coder& e, uint8_t* st, uint8_t* x1, int v, bool dc, int* m_out) {
  int m = 0;
  if (v -= 1) {
    e.encode(st, 1);
    m = 1;
    int v2 = v;
    if (dc) {
      st = x1;
      while (v2 >>= 1) {
        e.encode(st, 1);
        m <<= 1;
        st += 1;
      }
    } else if (v2 >>= 1) {
      e.encode(st, 1);
      m <<= 1;
      st = x1;
      while (v2 >>= 1) {
        e.encode(st, 1);
        m <<= 1;
        st += 1;
      }
    }
  }
  e.encode(st, 0);
  st += 14;
  *m_out = m;
  while (m >>= 1) e.encode(st, (m & v) ? 1 : 0);
}

void encode_dc(Coder& e, Stats& s, int tbl, int* context, int32_t* last,
               int value) {
  uint8_t* st = s.dc[tbl] + *context;
  int v = value - *last;
  if (v == 0) {
    e.encode(st, 0);
    *context = 0;
    return;
  }
  *last = value;
  e.encode(st, 1);
  int sign = v < 0;
  if (sign) v = -v;
  e.encode(st + 1, sign);
  st += 2 + sign;
  int m;
  magnitude(e, st, s.dc[tbl] + 20, v, true, &m);
  if (m < static_cast<int>((1L << s.cond[tbl]) >> 1))
    *context = 0;
  else if (m > static_cast<int>((1L << s.cond[16 + tbl]) >> 1))
    *context = 12 + 4 * sign;
  else
    *context = 4 + 4 * sign;
}

// |coef| >> al with coef's sign
inline int shifted(int16_t coef, int al) {
  int v = coef;
  return v < 0 ? -((-v) >> al) : (v >> al);
}

}  // namespace

extern "C" {

// Encode one scan of `n_comp` components, sequential (`progressive` 0) or
// one progressive pass (band ss-se, approximation ah/al). comp_hv,
// comp_grid: as the port's decoder takes them (the grids hold every block
// the scan's MCUs cover); comp_tables: the DC and AC table of each
// component (0-15); conditioning [48]: L [16], U [16], Kx [16]. Writes the
// scan's stuffed data with its RST markers to out[cap]; returns its length,
// -4 for bad arguments or -5 when out is too small.
int64_t jpeg_encode_arith_scan(
    int32_t n_comp, const int32_t* comp_hv, const int32_t* comp_grid,
    const int32_t* comp_tables, const uint8_t* conditioning, int32_t mcus_x,
    int32_t mcus_y, int32_t restart_interval, int32_t progressive,
    int32_t ss, int32_t se, int32_t ah, int32_t al, const int16_t** coefs,
    uint8_t* out, int64_t cap) {
  const bool dc = ss == 0;
  if (n_comp < 1 || n_comp > 4 || mcus_x < 1 || mcus_y < 1) return -4;
  for (int k = 0; k < 2 * n_comp; ++k)
    if (comp_tables[k] < 0 || comp_tables[k] > 15) return -4;
  static thread_local Stats s;
  s.cond = conditioning;
  const bool uses_dc = !progressive || (dc && !ah);
  const bool uses_ac = !progressive || !dc;
  int32_t last[4];
  int context[4];
  auto reset = [&]() {
    for (int c = 0; c < n_comp; ++c) {
      if (uses_dc) {
        std::memset(s.dc[comp_tables[2 * c]], 0, 64);
        last[c] = 0;
        context[c] = 0;
      }
      if (uses_ac) std::memset(s.ac[comp_tables[2 * c + 1]], 0, 256);
    }
  };
  reset();
  Coder e{out, cap};
  int64_t mcu = 0;
  int next_rst = 0;
  for (int32_t my = 0; my < mcus_y; ++my) {
    for (int32_t mx = 0; mx < mcus_x; ++mx, ++mcu) {
      if (restart_interval > 0 && mcu > 0 && mcu % restart_interval == 0) {
        e.finish();
        e.emit(0xFF);
        e.emit(0xD0 + next_rst);
        next_rst = (next_rst + 1) & 7;
        reset();
      }
      for (int c = 0; c < n_comp; ++c) {
        int h = comp_hv[2 * c], v = comp_hv[2 * c + 1];
        int rows = comp_grid[2 * c], cols = comp_grid[2 * c + 1];
        int dt = comp_tables[2 * c], at = comp_tables[2 * c + 1];
        for (int by = 0; by < v; ++by) {
          for (int bx = 0; bx < h; ++bx) {
            int64_t row = static_cast<int64_t>(my) * v + by;
            int64_t col = static_cast<int64_t>(mx) * h + bx;
            if (row >= rows || col >= cols) return -4;
            const int16_t* block = coefs[c] + (row * cols + col) * 64;
            if (uses_dc) {
              int value = progressive ? (block[0] >> al) : block[0];
              encode_dc(e, s, dt, &context[c], &last[c], value);
              if (progressive) continue;
            }
            if (progressive && dc) {                  // DC refinement
              e.encode(&s.fixed, (block[0] >> al) & 1);
              continue;
            }
            int first = progressive ? ss : 1, end = progressive ? se : 63;
            int shift = progressive ? al : 0;
            int ke = end;                             // the last nonzero
            for (; ke >= first; --ke)
              if (shifted(block[kNatural[ke]], shift)) break;
            if (!progressive || !ah) {                // AC (first)
              int k = first;
              for (; k <= ke; ++k) {
                uint8_t* st = s.ac[at] + 3 * (k - 1);
                e.encode(st, 0);                      // not EOB
                int val;
                while ((val = shifted(block[kNatural[k]], shift)) == 0) {
                  e.encode(st + 1, 0);
                  st += 3;
                  ++k;
                }
                e.encode(st + 1, 1);
                e.encode(&s.fixed, val < 0);
                int m;
                magnitude(e, st + 2,
                          s.ac[at] + (k <= s.cond[32 + at] ? 189 : 217),
                          val < 0 ? -val : val, false, &m);
              }
              if (k <= end) e.encode(s.ac[at] + 3 * (k - 1), 1);  // EOB
              continue;
            }
            int kex = ke;                             // AC refinement
            for (; kex >= first; --kex)
              if (shifted(block[kNatural[kex]], ah)) break;
            int k = first;
            for (; k <= ke; ++k) {
              uint8_t* st = s.ac[at] + 3 * (k - 1);
              if (k > kex) e.encode(st, 0);
              for (;;) {
                int val = shifted(block[kNatural[k]], al);
                int mag = val < 0 ? -val : val;
                if (mag) {
                  if (mag >> 1) {                     // already nonzero
                    e.encode(st + 2, mag & 1);
                  } else {                            // newly nonzero
                    e.encode(st + 1, 1);
                    e.encode(&s.fixed, val < 0);
                  }
                  break;
                }
                e.encode(st + 1, 0);
                st += 3;
                ++k;
              }
            }
            if (k <= end) e.encode(s.ac[at] + 3 * (k - 1), 1);
          }
        }
      }
    }
  }
  e.finish();
  return e.full ? -5 : e.n;
}

}  // extern "C"
