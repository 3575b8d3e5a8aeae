// JPEG 2000 (ISO/IEC 15444-1) tier-1 and tier-2 coding, as OpenJPEG 2.5
// reads and writes them: the host part of nerfpp_tpu_torch/utils/jpeg2000.py.
//
// Decoding: the packets of one tile (any of the five progression orders,
// precincts, any number of layers, SOP and EPH markers) are parsed into
// each code-block's bytes and codeword segments, then each code-block is
// decoded by the MQ decoder and the significance, refinement and cleanup
// passes (code-block style 0). The result is one int32 plane per component in OpenJPEG's tile
// layout (each resolution's LL at the top left, HL right of it, LH below,
// HH diagonal), each value twice the coefficient plus the half step of its
// last decoded bit-plane, as OpenJPEG's tier-1 leaves it; the dequantisation
// and the inverse transforms run on the device.
//
// Encoding: the reversible 5/3 coefficients of one tile (from the device)
// are coded by tier-1, with each pass's rate and distortion decrease as
// OpenJPEG estimates them, then cut to a byte budget by OpenJPEG's threshold
// search for one layer, then written as LRCP packets. Built with
// -ffp-contract=off so that the double arithmetic of the estimates and the
// search rounds as OpenJPEG's does.
#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum { ERR_STREAM = -1, ERR_ROOM = -3 };

inline int64_t ceildiv_pow2(int64_t a, int b) {
    return (a + (int64_t(1) << b) - 1) >> b;
}
inline int64_t floordiv_pow2(int64_t a, int b) { return a >> b; }
inline int floorlog2(uint32_t a) {
    int l = 0;
    while (a > 1) { a >>= 1; ++l; }
    return l;
}

// ------------------------------------------------------------ MQ coder

const uint16_t QE[47] = {
    0x5601, 0x3401, 0x1801, 0x0ac1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801,
    0x3801, 0x3001, 0x2401, 0x1c01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801,
    0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201, 0x1c01, 0x1801, 0x1601,
    0x1401, 0x1201, 0x1101, 0x0ac1, 0x09c1, 0x08a1, 0x0521, 0x0441, 0x02a1,
    0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025, 0x0015, 0x0009, 0x0005,
    0x0001, 0x5601};
const uint8_t NMPS[47] = {
    1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38,
    39, 40, 41, 42, 43, 44, 45, 45, 46};
const uint8_t NLPS[47] = {
    1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16, 17,
    18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
    35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
const uint8_t SWITCH[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0};

// contexts: 0-8 zero coding, 9-13 sign, 14-16 refinement, 17 run, 18 uniform
enum { CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18, NCTX = 19 };

struct Contexts {
    uint8_t state[NCTX], mps[NCTX];
    void reset() {
        std::memset(state, 0, sizeof state);
        std::memset(mps, 0, sizeof mps);
        state[CTX_UNI] = 46;
        state[CTX_AGG] = 3;
        state[0] = 4;
    }
};

struct MqDecoder {
    const uint8_t* bp;   // data followed by 0xff 0xff
    uint32_t a, c;
    int ct;
    Contexts cx;

    void bytein() {
        uint32_t next = bp[1];
        if (bp[0] == 0xff) {
            if (next > 0x8f) {
                c += 0xff00;
                ct = 8;
            } else {
                ++bp;
                c += next << 9;
                ct = 7;
            }
        } else {
            ++bp;
            c += next << 8;
            ct = 8;
        }
    }
    // starts a codeword segment (the contexts carry over from the last)
    void init(const uint8_t* data, size_t len) {
        bp = data;
        c = len == 0 ? 0xffu << 16 : uint32_t(*bp) << 16;
        bytein();
        c <<= 7;
        ct -= 7;
        a = 0x8000;
    }
    void renorm() {
        do {
            if (ct == 0) bytein();
            a <<= 1;
            c <<= 1;
            --ct;
        } while (a < 0x8000);
    }
    int decode(int ctx) {
        int s = cx.state[ctx];
        uint32_t qe = QE[s];
        int d;
        a -= qe;
        if ((c >> 16) < qe) {
            if (a < qe) {
                a = qe;
                d = cx.mps[ctx];
                cx.state[ctx] = NMPS[s];
            } else {
                a = qe;
                d = 1 - cx.mps[ctx];
                if (SWITCH[s]) cx.mps[ctx] = uint8_t(1 - cx.mps[ctx]);
                cx.state[ctx] = NLPS[s];
            }
            renorm();
        } else {
            c -= qe << 16;
            if ((a & 0x8000) == 0) {
                if (a < qe) {
                    d = 1 - cx.mps[ctx];
                    if (SWITCH[s]) cx.mps[ctx] = uint8_t(1 - cx.mps[ctx]);
                    cx.state[ctx] = NLPS[s];
                } else {
                    d = cx.mps[ctx];
                    cx.state[ctx] = NMPS[s];
                }
                renorm();
            } else {
                d = cx.mps[ctx];
            }
        }
        return d;
    }
};

struct MqEncoder {
    std::vector<uint8_t> buf;   // buf[0] is the fake byte before the data
    size_t bp;                  // index of the last byte written
    uint32_t a, c;
    int ct;
    Contexts cx;

    void init() {
        buf.assign(4096, 0);
        bp = 0;
        a = 0x8000;
        c = 0;
        ct = 12;
        cx.reset();
    }
    uint8_t& at(size_t i) {
        if (i >= buf.size()) buf.resize(buf.size() * 2, 0);
        return buf[i];
    }
    // OpenJPEG's opj_mqc_numbytes: bp - start, start = 1, in 32 bits (it
    // is -1 before the first byte is out)
    uint32_t numbytes() const { return uint32_t(bp) - 1u; }
    void byteout() {
        if (buf[bp] == 0xff) {
            at(++bp) = uint8_t(c >> 20);
            c &= 0xfffff;
            ct = 7;
        } else if ((c & 0x8000000) == 0) {
            at(++bp) = uint8_t(c >> 19);
            c &= 0x7ffff;
            ct = 8;
        } else {
            ++buf[bp];
            if (buf[bp] == 0xff) {
                c &= 0x7ffffff;
                at(++bp) = uint8_t(c >> 20);
                c &= 0xfffff;
                ct = 7;
            } else {
                at(++bp) = uint8_t(c >> 19);
                c &= 0x7ffff;
                ct = 8;
            }
        }
    }
    void renorm() {
        do {
            a <<= 1;
            c <<= 1;
            if (--ct == 0) byteout();
        } while ((a & 0x8000) == 0);
    }
    void encode(int ctx, int d) {
        int s = cx.state[ctx];
        uint32_t qe = QE[s];
        if (cx.mps[ctx] == d) {
            a -= qe;
            if ((a & 0x8000) == 0) {
                if (a < qe) a = qe; else c += qe;
                cx.state[ctx] = NMPS[s];
                renorm();
            } else {
                c += qe;
            }
        } else {
            a -= qe;
            if (a < qe) c += qe; else a = qe;
            if (SWITCH[s]) cx.mps[ctx] = uint8_t(1 - cx.mps[ctx]);
            cx.state[ctx] = NLPS[s];
            renorm();
        }
    }
    void flush() {
        uint32_t tempc = c + a;
        c |= 0xffff;
        if (c >= tempc) c -= 0x8000;
        c <<= ct;
        byteout();
        c <<= ct;
        byteout();
        if (buf[bp] != 0xff) ++bp;
    }
};

// ------------------------------------------------------------ tier-1

enum : uint8_t { SIG = 1, VISIT = 2, REFINED = 4, NEG = 8 };

// zero-coding context of a sample from its neighbours' significance;
// orientation 1 (HL, high-pass along x) swaps the roles of the horizontal
// and vertical neighbours, 3 (HH) counts the diagonal ones first
inline int zc_context(const uint8_t* f, int stride, int orient) {
    int h = (f[-1] & SIG) + (f[1] & SIG);
    int v = (f[-stride] & SIG) + (f[stride] & SIG);
    int d = (f[-stride - 1] & SIG) + (f[-stride + 1] & SIG)
        + (f[stride - 1] & SIG) + (f[stride + 1] & SIG);
    if (orient == 3) {
        int hv = h + v;
        if (d == 0) return hv == 0 ? 0 : hv == 1 ? 1 : 2;
        if (d == 1) return hv == 0 ? 3 : hv == 1 ? 4 : 5;
        if (d == 2) return hv == 0 ? 6 : 7;
        return 8;
    }
    if (orient == 1) std::swap(h, v);
    if (h == 0) {
        if (v == 0) return d == 0 ? 0 : d == 1 ? 1 : 2;
        return v == 1 ? 3 : 4;
    }
    if (h == 1) return v == 0 ? (d == 0 ? 5 : 6) : 7;
    return 8;
}

inline int contribution(uint8_t a, uint8_t b) {
    int s = 0;
    if (a & SIG) s += (a & NEG) ? -1 : 1;
    if (b & SIG) s += (b & NEG) ? -1 : 1;
    return s > 0 ? 1 : s < 0 ? -1 : 0;
}

// sign context and the bit the sign is XORed with
inline int sc_context(const uint8_t* f, int stride, int* xorbit) {
    int h = contribution(f[-1], f[1]);
    int v = contribution(f[-stride], f[stride]);
    if (h < 0) { h = -h; v = -v; *xorbit = 1; } else if (h == 0 && v < 0) {
        v = -v; *xorbit = 1;
    } else {
        *xorbit = 0;
    }
    if (h == 0) return CTX_SC + (v == 0 ? 0 : 1);
    return CTX_SC + 3 + v;   // v in {-1, 0, 1}: 11, 12, 13
}

inline int mag_context(const uint8_t* f, int stride) {
    if (f[0] & REFINED) return CTX_MAG + 2;
    int any = (f[-1] | f[1] | f[-stride] | f[stride] | f[-stride - 1]
               | f[-stride + 1] | f[stride - 1] | f[stride + 1]) & SIG;
    return CTX_MAG + (any ? 1 : 0);
}

inline bool no_sig_neighbour(const uint8_t* f, int stride) {
    return ((f[-1] | f[1] | f[-stride] | f[stride] | f[-stride - 1]
             | f[-stride + 1] | f[stride - 1] | f[stride + 1]) & SIG) == 0;
}

// A codeword segment: its bytes and passes. With code-block style 0 a
// segment holds at most 109 passes (OpenJPEG's opj_t2_init_seg), which only
// a broken stream passes.
struct Segment { uint32_t len, passes; };
const uint32_t SEGMENT_PASSES = 109;

// Decodes the passes of a w x h code-block from its segments (``data``,
// their bytes one after the other), the first a cleanup pass of bit-plane
// ``bpno_plus_one`` - 1, into ``out`` (row stride ``ostride``). Each
// segment restarts the MQ decoder, its bytes followed by 0xff 0xff.
void decode_block(const uint8_t* data, const std::vector<Segment>& segs,
                  int bpno_plus_one, int orient, int w, int h, int32_t* out,
                  int ostride) {
    const int stride = w + 2;
    std::vector<uint8_t> flags(size_t(stride) * (h + 2), 0);
    std::vector<int32_t> val(size_t(w) * h, 0);
    std::vector<uint8_t> buf;
    MqDecoder mq;
    mq.cx.reset();
    int passtype = 2;
    for (const Segment& sg : segs) {
        for (uint32_t p = 0; p < sg.passes && bpno_plus_one >= 1; ++p) {
            if (p == 0) {
                buf.assign(data, data + sg.len);
                buf.push_back(0xff);
                buf.push_back(0xff);
                data += sg.len;
                mq.init(buf.data(), sg.len);
            }
            const int32_t one = int32_t(1) << bpno_plus_one;
            const int32_t half = one >> 1, oneplushalf = one | half;
            for (int k = 0; k < h; k += 4) {
                for (int i = 0; i < w; ++i) {
                    int jend = std::min(k + 4, h);
                    int j = k;
                    if (passtype == 2 && k + 4 <= h) {
                        bool run = true;
                        for (int jj = k; jj < k + 4 && run; ++jj) {
                            const uint8_t* f = &flags[size_t(jj + 1) * stride + i + 1];
                            run = !(*f & (SIG | VISIT)) && no_sig_neighbour(f, stride);
                        }
                        if (run) {
                            if (!mq.decode(CTX_AGG)) continue;
                            int r = mq.decode(CTX_UNI) << 1;
                            r |= mq.decode(CTX_UNI);
                            j = k + r;
                            uint8_t* f = &flags[size_t(j + 1) * stride + i + 1];
                            int xorbit;
                            int ctx = sc_context(f, stride, &xorbit);
                            int neg = mq.decode(ctx) ^ xorbit;
                            val[size_t(j) * w + i] = neg ? -oneplushalf : oneplushalf;
                            *f |= SIG | (neg ? NEG : 0);
                            ++j;
                        }
                    }
                    for (; j < jend; ++j) {
                        uint8_t* f = &flags[size_t(j + 1) * stride + i + 1];
                        int32_t& v = val[size_t(j) * w + i];
                        if (passtype == 1) {
                            if ((*f & (SIG | VISIT)) != SIG) continue;
                            int bit = mq.decode(mag_context(f, stride));
                            v += (bit ^ (v < 0)) ? half : -half;
                            *f |= REFINED;
                            continue;
                        }
                        if (*f & (SIG | VISIT)) {
                            if (passtype == 2) *f &= uint8_t(~VISIT);
                            continue;
                        }
                        int ctx = zc_context(f, stride, orient);
                        if (passtype == 0) {
                            if (ctx == 0) continue;
                            *f |= VISIT;
                        }
                        if (mq.decode(ctx)) {
                            int xorbit;
                            int sctx = sc_context(f, stride, &xorbit);
                            int neg = mq.decode(sctx) ^ xorbit;
                            v = neg ? -oneplushalf : oneplushalf;
                            *f |= SIG | (neg ? NEG : 0);
                        }
                    }
                }
            }
            if (passtype == 2) {
                for (auto& f : flags) f &= uint8_t(~VISIT);
            }
            if (++passtype == 3) {
                passtype = 0;
                --bpno_plus_one;
            }
        }
    }
    for (int j = 0; j < h; ++j)
        std::memcpy(out + size_t(j) * ostride, &val[size_t(j) * w], sizeof(int32_t) * w);
}

// OpenJPEG's distortion tables (t1_generate_luts.c), T1_NMSEDEC_BITS = 7
const int NMSEDEC_BITS = 7, FRACBITS = 6;
int16_t lut_sig[128], lut_sig0[128], lut_ref[128], lut_ref0[128];

void make_luts() {
    static bool done = false;
    if (done) return;
    const double s = std::pow(2.0, FRACBITS);
    for (int i = 0; i < (1 << NMSEDEC_BITS); ++i) {
        double t = i / s;
        double u = t, v = t - 1.5;
        lut_sig[i] = int16_t(std::max(0, int(std::floor((u * u - v * v) * s + 0.5) / s * 8192.0)));
        lut_sig0[i] = int16_t(std::max(0, int(std::floor((u * u) * s + 0.5) / s * 8192.0)));
        u = t - 1.0;
        v = (i & (1 << (NMSEDEC_BITS - 1))) ? t - 1.5 : t - 0.5;
        lut_ref[i] = int16_t(std::max(0, int(std::floor((u * u - v * v) * s + 0.5) / s * 8192.0)));
        lut_ref0[i] = int16_t(std::max(0, int(std::floor((u * u) * s + 0.5) / s * 8192.0)));
    }
    done = true;
}

inline int nmsedec_sig(uint32_t x, int bitpos) {
    return bitpos > 0 ? lut_sig[(x >> bitpos) & 127] : lut_sig0[x & 127];
}
inline int nmsedec_ref(uint32_t x, int bitpos) {
    return bitpos > 0 ? lut_ref[(x >> bitpos) & 127] : lut_ref0[x & 127];
}

struct Pass {
    uint32_t rate;
    double distortiondec;
    bool term;
    uint32_t len;
};

// One code-block's coded passes and bytes (the encoder's state).
struct EncBlock {
    int numbps = 0;
    std::vector<Pass> passes;
    std::vector<uint8_t> data;      // the coded bytes
    int layer_passes = 0;           // passes of the layer being made
    uint32_t layer_len = 0;
    int numpasses = 0;              // passes written so far (tier-2)
    int numlenbits = 0;
};

// Encodes a w x h block of 5/3 coefficients (row stride ``istride``) as
// OpenJPEG's opj_t1_encode_cblk does with code-block style 0; ``weight``
// is opj_t1_getwmsedec's w1 * w2 * stepsize (here the band's DWT norm).
void encode_block(const int32_t* in, int istride, int w, int h, int orient,
                  double weight, EncBlock& blk) {
    const int stride = w + 2;
    std::vector<uint8_t> flags(size_t(stride) * (h + 2), 0);
    std::vector<uint32_t> mag(size_t(w) * h);
    uint32_t mx = 0;
    for (int j = 0; j < h; ++j)
        for (int i = 0; i < w; ++i) {
            int32_t v = in[size_t(j) * istride + i];
            uint32_t m = uint32_t(v < 0 ? -v : v) << FRACBITS;
            mag[size_t(j) * w + i] = m;
            if (v < 0) flags[size_t(j + 1) * stride + i + 1] |= NEG;
            mx = std::max(mx, m);
        }
    blk.numbps = mx ? (floorlog2(mx) + 1) - FRACBITS : 0;
    blk.passes.clear();
    if (blk.numbps <= 0) {
        blk.numbps = 0;
        blk.data.clear();
        return;
    }
    MqEncoder mq;
    mq.init();
    double cum = 0.0;
    int bpno = blk.numbps - 1, passtype = 2;
    while (bpno >= 0) {
        int nmsedec = 0;
        const uint32_t one = uint32_t(1) << (bpno + FRACBITS);
        for (int k = 0; k < h; k += 4) {
            for (int i = 0; i < w; ++i) {
                int jend = std::min(k + 4, h);
                int j = k;
                if (passtype == 2 && k + 4 <= h) {
                    bool run = true;
                    for (int jj = k; jj < k + 4 && run; ++jj) {
                        const uint8_t* f = &flags[size_t(jj + 1) * stride + i + 1];
                        run = !(*f & (SIG | VISIT)) && no_sig_neighbour(f, stride);
                    }
                    if (run) {
                        int r = 0;
                        while (r < 4 && !(mag[size_t(k + r) * w + i] & one)) ++r;
                        mq.encode(CTX_AGG, r < 4);
                        if (r == 4) continue;
                        mq.encode(CTX_UNI, r >> 1);
                        mq.encode(CTX_UNI, r & 1);
                        j = k + r;
                        uint8_t* f = &flags[size_t(j + 1) * stride + i + 1];
                        uint32_t m = mag[size_t(j) * w + i];
                        nmsedec += nmsedec_sig(m, bpno);
                        int xorbit;
                        int ctx = sc_context(f, stride, &xorbit);
                        mq.encode(ctx, ((*f & NEG) ? 1 : 0) ^ xorbit);
                        *f |= SIG;
                        ++j;
                    }
                }
                for (; j < jend; ++j) {
                    uint8_t* f = &flags[size_t(j + 1) * stride + i + 1];
                    uint32_t m = mag[size_t(j) * w + i];
                    if (passtype == 1) {
                        if ((*f & (SIG | VISIT)) != SIG) continue;
                        nmsedec += nmsedec_ref(m, bpno);
                        mq.encode(mag_context(f, stride), (m & one) ? 1 : 0);
                        *f |= REFINED;
                        continue;
                    }
                    if (*f & (SIG | VISIT)) {
                        if (passtype == 2) *f &= uint8_t(~VISIT);
                        continue;
                    }
                    int ctx = zc_context(f, stride, orient);
                    if (passtype == 0) {
                        if (ctx == 0) continue;
                        *f |= VISIT;
                    }
                    int bit = (m & one) ? 1 : 0;
                    mq.encode(ctx, bit);
                    if (bit) {
                        nmsedec += nmsedec_sig(m, bpno);
                        int xorbit;
                        int sctx = sc_context(f, stride, &xorbit);
                        mq.encode(sctx, ((*f & NEG) ? 1 : 0) ^ xorbit);
                        *f |= SIG;
                    }
                }
            }
        }
        if (passtype == 2) {
            for (auto& f : flags) f &= uint8_t(~VISIT);
        }
        // opj_t1_getwmsedec
        double wmsedec = weight * double(1 << bpno);
        wmsedec *= wmsedec * nmsedec / 8192.0;
        cum += wmsedec;
        Pass pass;
        pass.distortiondec = cum;
        if (passtype == 2 && bpno == 0) {
            mq.flush();
            pass.term = true;
            pass.rate = mq.numbytes();
        } else {
            pass.term = false;
            pass.rate = mq.numbytes() + 3;
        }
        blk.passes.push_back(pass);
        if (++passtype == 3) {
            passtype = 0;
            --bpno;
        }
    }
    uint32_t last = mq.numbytes();
    for (size_t p = blk.passes.size(); p-- > 0;) {
        if (blk.passes[p].rate > last) blk.passes[p].rate = last;
        else last = blk.passes[p].rate;
    }
    mq.at(mq.bp + 2);
    blk.data.assign(mq.buf.begin() + 1, mq.buf.begin() + 1 + mq.numbytes());
    blk.data.resize(std::max<size_t>(blk.data.size(), blk.passes.back().rate), 0);
    for (size_t p = 0; p < blk.passes.size(); ++p) {
        Pass& pass = blk.passes[p];
        if (pass.rate > 0 && mq.at(pass.rate) == 0xff) --pass.rate;
        pass.len = pass.rate - (p == 0 ? 0 : blk.passes[p - 1].rate);
    }
}

// ------------------------------------------------------------ tag trees

struct TagTree {
    struct Node { int parent, value, low, known; };
    std::vector<Node> nodes;
    void build(int w, int h) {
        nodes.clear();
        if (w <= 0 || h <= 0) return;
        std::vector<int> lw, lh, off;
        int n = 0;
        int cw = w, ch = h;
        for (;;) {
            lw.push_back(cw);
            lh.push_back(ch);
            off.push_back(n);
            n += cw * ch;
            if (cw * ch <= 1) break;
            cw = (cw + 1) / 2;
            ch = (ch + 1) / 2;
        }
        nodes.assign(n, Node{-1, 999, 0, 0});
        for (size_t l = 0; l + 1 < lw.size(); ++l)
            for (int j = 0; j < lh[l]; ++j)
                for (int i = 0; i < lw[l]; ++i)
                    nodes[off[l] + j * lw[l] + i].parent =
                        off[l + 1] + (j / 2) * lw[l + 1] + i / 2;
    }
    void reset() {
        for (auto& nd : nodes) { nd.value = 999; nd.low = 0; nd.known = 0; }
    }
    void setvalue(int leaf, int value) {
        int n = leaf;
        while (n >= 0 && nodes[n].value > value) {
            nodes[n].value = value;
            n = nodes[n].parent;
        }
    }
    int path(int leaf, int* stk) const {
        int depth = 0;
        int n = leaf;
        while (nodes[n].parent >= 0) { stk[depth++] = n; n = nodes[n].parent; }
        stk[depth++] = n;
        return depth;   // stk[depth - 1] is the root
    }
};

// ------------------------------------------------------------ bit I/O

struct BitReader {
    const uint8_t *start, *bp, *end;
    uint32_t buf = 0;
    int ct = 0;
    bool past = false;   // a bit was asked for past the end
    void bytein() {
        buf = (buf << 8) & 0xffff;
        ct = buf == 0xff00 ? 7 : 8;
        if (bp < end) buf |= *bp++; else past = true;
    }
    uint32_t bit() {
        if (ct == 0) bytein();
        --ct;
        return (buf >> ct) & 1;
    }
    uint32_t read(int n) {
        uint32_t v = 0;
        for (int i = n - 1; i >= 0; --i) v |= bit() << i;
        return v;
    }
    void align() {
        if ((buf & 0xff) == 0xff) bytein();
        ct = 0;
    }
};

struct BitWriter {
    uint8_t *start, *bp, *end;
    uint32_t buf = 0;
    int ct = 8;
    bool full = false;
    void byteout() {
        buf = (buf << 8) & 0xffff;
        ct = buf == 0xff00 ? 7 : 8;
        if (bp >= end) { full = true; return; }
        *bp++ = uint8_t(buf >> 8);
    }
    void put(uint32_t b) {
        if (ct == 0) byteout();
        --ct;
        buf |= b << ct;
    }
    void write(uint32_t v, int n) {
        for (int i = n - 1; i >= 0; --i) put((v >> i) & 1);
    }
    void flush() {
        byteout();
        if (ct == 7) byteout();
    }
};

int tgt_decode(BitReader& bio, TagTree& t, int leaf, int threshold) {
    int stk[32];
    int depth = t.path(leaf, stk);
    int low = 0;
    int node = -1;
    for (int s = depth - 1; s >= 0; --s) {
        node = stk[s];
        TagTree::Node& nd = t.nodes[node];
        if (low > nd.low) nd.low = low; else low = nd.low;
        while (low < threshold && low < nd.value) {
            if (bio.bit()) nd.value = low; else ++low;
        }
        nd.low = low;
    }
    return t.nodes[node].value < threshold ? 1 : 0;
}

void tgt_encode(BitWriter& bio, TagTree& t, int leaf, int threshold) {
    int stk[32];
    int depth = t.path(leaf, stk);
    int low = 0;
    for (int s = depth - 1; s >= 0; --s) {
        TagTree::Node& nd = t.nodes[stk[s]];
        if (low > nd.low) nd.low = low; else low = nd.low;
        while (low < threshold) {
            if (low >= nd.value) {
                if (!nd.known) { bio.put(1); nd.known = 1; }
                break;
            }
            bio.put(0);
            ++low;
        }
        nd.low = low;
    }
}

// ------------------------------------------------------------ geometry

struct Block {
    int x0, y0, x1, y1;
    // decoder
    int numbps = 0, numlenbits = 0;
    bool seen = false;
    std::vector<uint8_t> bytes;
    std::vector<Segment> segs;
    EncBlock enc;
};

struct Precinct {
    int cw = 0, ch = 0;
    std::vector<Block> blocks;
    TagTree incl, imsb;
};

struct Band {
    int orient;          // 0 LL, 1 HL, 2 LH, 3 HH
    int x0, y0, x1, y1;
    int numbps;          // expn + guard bits - 1
    int offx, offy;      // where the band lies in the tile plane
    std::vector<Precinct> precincts;
    bool empty() const { return x1 <= x0 || y1 <= y0; }
};

struct Resolution {
    int x0, y0, x1, y1, pdx, pdy, pw, ph;
    std::vector<Band> bands;
};

struct Component {
    int numres, cblkw, cblkh;
    int x0, y0, x1, y1;
    std::vector<Resolution> res;
};

struct Tile {
    int x0, y0, x1, y1, ncomp, nlayers, prog, csty;
    std::vector<Component> comps;
};

// params: tx0 ty0 tx1 ty1 ncomp nlayers prog csty, then per component:
// numres cblkw cblkh, numres pairs (pdx, pdy), 3 numres - 2 band numbps
bool build_tile(const int32_t* p, Tile& t) {
    t.x0 = p[0]; t.y0 = p[1]; t.x1 = p[2]; t.y1 = p[3];
    t.ncomp = p[4]; t.nlayers = p[5]; t.prog = p[6]; t.csty = p[7];
    p += 8;
    t.comps.resize(t.ncomp);
    for (auto& c : t.comps) {
        c.numres = p[0]; c.cblkw = p[1]; c.cblkh = p[2];
        p += 3;
        c.x0 = t.x0; c.y0 = t.y0; c.x1 = t.x1; c.y1 = t.y1;
        std::vector<int> pdx(c.numres), pdy(c.numres);
        for (int r = 0; r < c.numres; ++r) { pdx[r] = p[0]; pdy[r] = p[1]; p += 2; }
        const int32_t* numbps = p;
        p += 3 * c.numres - 2;
        c.res.resize(c.numres);
        for (int r = 0; r < c.numres; ++r) {
            Resolution& R = c.res[r];
            int level = c.numres - 1 - r;
            R.x0 = int(ceildiv_pow2(c.x0, level));
            R.y0 = int(ceildiv_pow2(c.y0, level));
            R.x1 = int(ceildiv_pow2(c.x1, level));
            R.y1 = int(ceildiv_pow2(c.y1, level));
            R.pdx = pdx[r]; R.pdy = pdy[r];
            int64_t px0 = floordiv_pow2(R.x0, R.pdx) << R.pdx;
            int64_t py0 = floordiv_pow2(R.y0, R.pdy) << R.pdy;
            int64_t px1 = ceildiv_pow2(R.x1, R.pdx) << R.pdx;
            int64_t py1 = ceildiv_pow2(R.y1, R.pdy) << R.pdy;
            R.pw = R.x0 == R.x1 ? 0 : int((px1 - px0) >> R.pdx);
            R.ph = R.y0 == R.y1 ? 0 : int((py1 - py0) >> R.pdy);
            int64_t cbgx0, cbgy0;
            int cbgw, cbgh;
            if (r == 0) {
                cbgx0 = px0; cbgy0 = py0; cbgw = R.pdx; cbgh = R.pdy;
            } else {
                cbgx0 = ceildiv_pow2(px0, 1); cbgy0 = ceildiv_pow2(py0, 1);
                cbgw = R.pdx - 1; cbgh = R.pdy - 1;
            }
            int xcb = std::min(c.cblkw, cbgw), ycb = std::min(c.cblkh, cbgh);
            int nb = r == 0 ? 1 : 3;
            R.bands.resize(nb);
            for (int b = 0; b < nb; ++b) {
                Band& B = R.bands[b];
                B.orient = r == 0 ? 0 : b + 1;
                int x0b = B.orient & 1, y0b = B.orient >> 1;
                if (r == 0) {
                    B.x0 = R.x0; B.y0 = R.y0; B.x1 = R.x1; B.y1 = R.y1;
                    B.numbps = numbps[0];
                    B.offx = 0; B.offy = 0;
                } else {
                    B.x0 = int(ceildiv_pow2(int64_t(c.x0) - (int64_t(x0b) << level), level + 1));
                    B.y0 = int(ceildiv_pow2(int64_t(c.y0) - (int64_t(y0b) << level), level + 1));
                    B.x1 = int(ceildiv_pow2(int64_t(c.x1) - (int64_t(x0b) << level), level + 1));
                    B.y1 = int(ceildiv_pow2(int64_t(c.y1) - (int64_t(y0b) << level), level + 1));
                    B.numbps = numbps[3 * (r - 1) + b + 1];
                    const Resolution& P = c.res[r - 1];
                    B.offx = x0b ? P.x1 - P.x0 : 0;
                    B.offy = y0b ? P.y1 - P.y0 : 0;
                }
                B.precincts.resize(size_t(R.pw) * R.ph);
                for (int pi = 0; pi < R.pw * R.ph; ++pi) {
                    Precinct& P = B.precincts[pi];
                    int64_t gx0 = cbgx0 + int64_t(pi % R.pw) * (int64_t(1) << cbgw);
                    int64_t gy0 = cbgy0 + int64_t(pi / R.pw) * (int64_t(1) << cbgh);
                    int64_t prx0 = std::max<int64_t>(gx0, B.x0);
                    int64_t pry0 = std::max<int64_t>(gy0, B.y0);
                    int64_t prx1 = std::min<int64_t>(gx0 + (int64_t(1) << cbgw), B.x1);
                    int64_t pry1 = std::min<int64_t>(gy0 + (int64_t(1) << cbgh), B.y1);
                    if (B.empty() || prx1 <= prx0 || pry1 <= pry0) continue;
                    int64_t bx0 = floordiv_pow2(prx0, xcb) << xcb;
                    int64_t by0 = floordiv_pow2(pry0, ycb) << ycb;
                    int64_t bx1 = ceildiv_pow2(prx1, xcb) << xcb;
                    int64_t by1 = ceildiv_pow2(pry1, ycb) << ycb;
                    P.cw = int((bx1 - bx0) >> xcb);
                    P.ch = int((by1 - by0) >> ycb);
                    P.blocks.resize(size_t(P.cw) * P.ch);
                    for (int k = 0; k < P.cw * P.ch; ++k) {
                        Block& K = P.blocks[k];
                        int64_t cx0 = bx0 + int64_t(k % P.cw) * (int64_t(1) << xcb);
                        int64_t cy0 = by0 + int64_t(k / P.cw) * (int64_t(1) << ycb);
                        K.x0 = int(std::max(cx0, prx0));
                        K.y0 = int(std::max(cy0, pry0));
                        K.x1 = int(std::min(cx0 + (int64_t(1) << xcb), prx1));
                        K.y1 = int(std::min(cy0 + (int64_t(1) << ycb), pry1));
                    }
                    P.incl.build(P.cw, P.ch);
                    P.imsb.build(P.cw, P.ch);
                }
            }
        }
    }
    return true;
}

struct PacketId { int layer, res, comp, prec; };

// The packets of a tile in its progression order (OpenJPEG's pi.c for one
// progression over the whole tile, each packet once).
std::vector<PacketId> packet_order(const Tile& t) {
    std::vector<PacketId> out;
    int maxres = 0;
    for (auto& c : t.comps) maxres = std::max(maxres, c.numres);
    auto emit_precincts = [&](int l, int r, int ci) {
        const Component& c = t.comps[ci];
        if (r >= c.numres) return;
        const Resolution& R = c.res[r];
        for (int p = 0; p < R.pw * R.ph; ++p) out.push_back({l, r, ci, p});
    };
    if (t.prog == 0) {          // LRCP
        for (int l = 0; l < t.nlayers; ++l)
            for (int r = 0; r < maxres; ++r)
                for (int ci = 0; ci < t.ncomp; ++ci) emit_precincts(l, r, ci);
        return out;
    }
    if (t.prog == 1) {          // RLCP
        for (int r = 0; r < maxres; ++r)
            for (int l = 0; l < t.nlayers; ++l)
                for (int ci = 0; ci < t.ncomp; ++ci) emit_precincts(l, r, ci);
        return out;
    }
    // position-driven orders: RPCL 2, PCRL 3, CPRL 4
    std::vector<std::vector<std::vector<char>>> done(t.ncomp);
    for (int ci = 0; ci < t.ncomp; ++ci) {
        done[ci].resize(t.comps[ci].numres);
        for (int r = 0; r < t.comps[ci].numres; ++r)
            done[ci][r].assign(size_t(t.comps[ci].res[r].pw) * t.comps[ci].res[r].ph, 0);
    }
    auto steps = [&](int ci0, int ci1, int64_t& dx, int64_t& dy) {
        dx = dy = 0;
        for (int ci = ci0; ci < ci1; ++ci) {
            const Component& c = t.comps[ci];
            for (int r = 0; r < c.numres; ++r) {
                int level = c.numres - 1 - r;
                int64_t sx = int64_t(1) << (c.res[r].pdx + level);
                int64_t sy = int64_t(1) << (c.res[r].pdy + level);
                dx = dx == 0 ? sx : std::min(dx, sx);
                dy = dy == 0 ? sy : std::min(dy, sy);
            }
        }
    };
    // the precinct of component ci, resolution r at (x, y), or -1
    auto precinct_at = [&](int ci, int r, int64_t x, int64_t y) -> int {
        const Component& c = t.comps[ci];
        if (r >= c.numres) return -1;
        const Resolution& R = c.res[r];
        int level = c.numres - 1 - r;
        int64_t trx0 = ceildiv_pow2(t.x0, level), try0 = ceildiv_pow2(t.y0, level);
        int64_t trx1 = ceildiv_pow2(t.x1, level), try1 = ceildiv_pow2(t.y1, level);
        int rpx = R.pdx + level, rpy = R.pdy + level;
        if (!((y % (int64_t(1) << rpy) == 0) ||
              (y == t.y0 && ((try0 << level) % (int64_t(1) << rpy)))))
            return -1;
        if (!((x % (int64_t(1) << rpx) == 0) ||
              (x == t.x0 && ((trx0 << level) % (int64_t(1) << rpx)))))
            return -1;
        if (R.pw == 0 || R.ph == 0) return -1;
        if (trx0 == trx1 || try0 == try1) return -1;
        int64_t prci = floordiv_pow2(ceildiv_pow2(x, level), R.pdx) - floordiv_pow2(trx0, R.pdx);
        int64_t prcj = floordiv_pow2(ceildiv_pow2(y, level), R.pdy) - floordiv_pow2(try0, R.pdy);
        return int(prci + prcj * R.pw);
    };
    auto emit_layers = [&](int ci, int r, int p) {
        if (p < 0 || done[ci][r][p]) return;
        done[ci][r][p] = 1;
        for (int l = 0; l < t.nlayers; ++l) out.push_back({l, r, ci, p});
    };
    int64_t dx, dy;
    if (t.prog == 2) {          // RPCL
        steps(0, t.ncomp, dx, dy);
        for (int r = 0; r < maxres; ++r)
            for (int64_t y = t.y0; y < t.y1; y += dy - (y % dy))
                for (int64_t x = t.x0; x < t.x1; x += dx - (x % dx))
                    for (int ci = 0; ci < t.ncomp; ++ci)
                        emit_layers(ci, r, precinct_at(ci, r, x, y));
    } else if (t.prog == 3) {   // PCRL
        steps(0, t.ncomp, dx, dy);
        for (int64_t y = t.y0; y < t.y1; y += dy - (y % dy))
            for (int64_t x = t.x0; x < t.x1; x += dx - (x % dx))
                for (int ci = 0; ci < t.ncomp; ++ci)
                    for (int r = 0; r < t.comps[ci].numres; ++r)
                        emit_layers(ci, r, precinct_at(ci, r, x, y));
    } else {                    // CPRL
        for (int ci = 0; ci < t.ncomp; ++ci) {
            steps(ci, ci + 1, dx, dy);
            for (int64_t y = t.y0; y < t.y1; y += dy - (y % dy))
                for (int64_t x = t.x0; x < t.x1; x += dx - (x % dx))
                    for (int r = 0; r < t.comps[ci].numres; ++r)
                        emit_layers(ci, r, precinct_at(ci, r, x, y));
        }
    }
    return out;
}

uint32_t read_numpasses(BitReader& bio) {
    if (!bio.bit()) return 1;
    if (!bio.bit()) return 2;
    uint32_t n = bio.read(2);
    if (n != 3) return 3 + n;
    n = bio.read(5);
    if (n != 31) return 6 + n;
    return 37 + bio.read(7);
}

// Reads one packet at ``*pos``; returns false where the stream is broken.
bool read_packet(Tile& t, const PacketId& id, const uint8_t* data, size_t len,
                 size_t* pos) {
    Component& c = t.comps[id.comp];
    Resolution& R = c.res[id.res];
    size_t p = *pos;
    if ((t.csty & 2) && p + 6 <= len && data[p] == 0xff && data[p + 1] == 0x91)
        p += 6;
    if (p > len) return false;
    BitReader bio{data, data + p, data + len};
    struct Incl { Block* blk; size_t seg; uint32_t n, bytes; };
    std::vector<Incl> incl;
    if (id.layer == 0) {
        for (auto& B : R.bands) {
            if (B.empty()) continue;
            Precinct& P = B.precincts[id.prec];
            P.incl.reset();
            P.imsb.reset();
        }
    }
    if (bio.bit()) {
        for (auto& B : R.bands) {
            if (B.empty()) continue;
            Precinct& P = B.precincts[id.prec];
            for (int k = 0; k < P.cw * P.ch; ++k) {
                Block& K = P.blocks[k];
                int included;
                if (!K.seen) included = tgt_decode(bio, P.incl, k, id.layer + 1);
                else included = int(bio.bit());
                if (!included) continue;
                if (!K.seen) {
                    int i = 0;
                    while (!tgt_decode(bio, P.imsb, k, i)) {
                        if (++i > 64) return false;
                    }
                    K.numbps = B.numbps + 1 - i;
                    K.numlenbits = 3;
                    K.seen = true;
                }
                uint32_t n = read_numpasses(bio);
                int inc = 0;
                while (bio.bit()) {
                    if (++inc > 32) return false;
                }
                K.numlenbits += inc;
                if (K.segs.empty() || K.segs.back().passes == SEGMENT_PASSES)
                    K.segs.push_back({0, 0});
                uint32_t open = K.segs.back().passes;
                while (n > 0) {
                    uint32_t take = std::min(SEGMENT_PASSES - open, n);
                    int bits = K.numlenbits + floorlog2(take);
                    if (bits > 32) return false;
                    incl.push_back({&K, K.segs.size() - 1, take, bio.read(bits)});
                    n -= take;
                    if (n > 0) {
                        K.segs.push_back({0, 0});
                        open = 0;
                    }
                }
            }
        }
    }
    bio.align();
    if (bio.past) return false;
    p = size_t(bio.bp - data);
    if ((t.csty & 4) && p + 2 <= len && data[p] == 0xff && data[p + 1] == 0x92)
        p += 2;
    for (auto& in : incl) {
        if (p + in.bytes > len) return false;
        in.blk->bytes.insert(in.blk->bytes.end(), data + p, data + p + in.bytes);
        in.blk->segs[in.seg].len += in.bytes;
        in.blk->segs[in.seg].passes += in.n;
        p += in.bytes;
    }
    *pos = p;
    return true;
}


// ------------------------------------------------------------ encoder

// opj_dwt_norms: the 5/3 synthesis norms by orientation and level
const double DWT_NORMS[4][10] = {
    {1.000, 1.500, 2.750, 5.375, 10.68, 21.34, 42.67, 85.33, 170.7, 341.3},
    {1.038, 1.592, 2.919, 5.703, 11.33, 22.64, 45.25, 90.48, 180.9},
    {1.038, 1.592, 2.919, 5.703, 11.33, 22.64, 45.25, 90.48, 180.9},
    {.7186, .9218, 1.586, 3.043, 6.019, 12.01, 24.00, 47.97, 95.93}};
double dwt_norm(int level, int orient) {
    if (orient == 0 && level >= 10) level = 9;
    else if (orient > 0 && level >= 9) level = 8;
    return DWT_NORMS[orient][level];
}

void put_numpasses(BitWriter& bio, uint32_t n) {
    if (n == 1) bio.write(0, 1);
    else if (n == 2) bio.write(2, 2);
    else if (n <= 5) bio.write(0xc | (n - 3), 4);
    else if (n <= 36) bio.write(0x1e0 | (n - 6), 9);
    else bio.write(0xff80 | (n - 37), 16);
}

// opj_tcd_makelayer for layer 0: each block's passes at ``thresh``.
void make_layer(Tile& t, double thresh) {
    for (auto& c : t.comps)
        for (auto& R : c.res)
            for (auto& B : R.bands) {
                if (B.empty()) continue;
                for (auto& P : B.precincts)
                    for (auto& K : P.blocks) {
                        EncBlock& e = K.enc;
                        const int total = int(e.passes.size());
                        int n = 0;
                        for (int p = 0; p < total; ++p) {
                            const Pass& pass = e.passes[p];
                            uint32_t dr;
                            double dd;
                            if (n == 0) {
                                dr = pass.rate;
                                dd = pass.distortiondec;
                            } else {
                                dr = pass.rate - e.passes[n - 1].rate;
                                dd = pass.distortiondec - e.passes[n - 1].distortiondec;
                            }
                            if (!dr) {
                                if (dd != 0) n = p + 1;
                                continue;
                            }
                            if (thresh - (dd / dr) < DBL_EPSILON) n = p + 1;
                        }
                        e.layer_passes = n;
                        e.layer_len = n ? e.passes[n - 1].rate : 0;
                    }
            }
}

// Writes the packets of layer 0 in LRCP order into [dst, dst + cap) and
// returns their bytes, or -1 where they do not fit.
int64_t write_packets(Tile& t, uint8_t* dst, int64_t cap, bool copy) {
    int64_t used = 0;
    for (const auto& id : packet_order(t)) {
        Resolution& R = t.comps[id.comp].res[id.res];
        for (auto& B : R.bands) {
            if (B.empty()) continue;
            Precinct& P = B.precincts[id.prec];
            P.incl.reset();
            P.imsb.reset();
            for (int k = 0; k < P.cw * P.ch; ++k) {
                Block& K = P.blocks[k];
                K.enc.numpasses = 0;
                P.imsb.setvalue(k, B.numbps - K.enc.numbps);
            }
        }
        BitWriter bio{dst + used, dst + used, dst + cap};
        // OpenJPEG 2.5.3 marks every packet present, even one that
        // includes no code-block
        bio.put(1);
        for (auto& B : R.bands) {
            if (B.empty()) continue;
            Precinct& P = B.precincts[id.prec];
            for (int k = 0; k < P.cw * P.ch; ++k) {
                EncBlock& e = P.blocks[k].enc;
                if (!e.numpasses && e.layer_passes) P.incl.setvalue(k, 0);
            }
            for (int k = 0; k < P.cw * P.ch; ++k) {
                EncBlock& e = P.blocks[k].enc;
                if (!e.numpasses) tgt_encode(bio, P.incl, k, 1);
                else bio.write(e.layer_passes != 0, 1);
                if (!e.layer_passes) continue;
                if (!e.numpasses) {
                    e.numlenbits = 3;
                    tgt_encode(bio, P.imsb, k, 999);
                }
                put_numpasses(bio, uint32_t(e.layer_passes));
                const int last = e.numpasses + e.layer_passes;
                int increment = 0, nump = 0;
                uint32_t len = 0;
                for (int p = e.numpasses; p < last; ++p) {
                    ++nump;
                    len += e.passes[p].len;
                    if (e.passes[p].term || p == last - 1) {
                        increment = std::max(increment, floorlog2(len) + 1
                                             - (e.numlenbits + floorlog2(uint32_t(nump))));
                        len = 0;
                        nump = 0;
                    }
                }
                for (int i = 0; i < increment; ++i) bio.put(1);
                bio.put(0);
                e.numlenbits += increment;
                for (int p = e.numpasses; p < last; ++p) {
                    ++nump;
                    len += e.passes[p].len;
                    if (e.passes[p].term || p == last - 1) {
                        bio.write(len, e.numlenbits + floorlog2(uint32_t(nump)));
                        len = 0;
                        nump = 0;
                    }
                }
            }
        }
        bio.flush();
        if (bio.full) return -1;
        used = bio.bp - dst;
        for (auto& B : R.bands) {
            if (B.empty()) continue;
            Precinct& P = B.precincts[id.prec];
            for (int k = 0; k < P.cw * P.ch; ++k) {
                EncBlock& e = P.blocks[k].enc;
                if (!e.layer_passes) continue;
                if (int64_t(e.layer_len) > cap - used) return -1;
                if (copy) std::memcpy(dst + used, e.data.data(), e.layer_len);
                e.numpasses += e.layer_passes;
                used += e.layer_len;
            }
        }
    }
    return used;
}

}  // namespace

extern "C" {

// Encodes one tile of reversible 5/3 coefficients (``coeffs``: one int32
// plane per component in OpenJPEG's tile layout, no colour transform, as
// cv2 writes them) as one layer of LRCP packets cut to ``maxlen`` bytes by
// OpenJPEG's threshold search, into ``out``. Returns the packets' bytes, or
// a negative error. The search ends where the threshold moves by at most
// 5e-6 of itself, as OpenJPEG 2.5.3's does.
int64_t j2k_encode_tile(const int32_t* coeffs, const int32_t* params,
                        int64_t maxlen, uint8_t* out, int64_t cap) {
    make_luts();
    Tile t;
    if (!build_tile(params, t)) return ERR_STREAM;
    const int64_t tw = t.x1 - t.x0, th = t.y1 - t.y0;
    struct Job { const int32_t* src; Block* blk; int orient; double weight; };
    std::vector<Job> jobs;
    for (int ci = 0; ci < t.ncomp; ++ci) {
        Component& c = t.comps[ci];
        const int32_t* plane = coeffs + ci * tw * th;
        for (int r = 0; r < c.numres; ++r)
            for (auto& B : c.res[r].bands) {
                if (B.empty()) continue;
                // opj_t1_getwmsedec's w1 * w2 * stepsize: no MCT norm, step 1
                double weight = dwt_norm(c.numres - 1 - r, B.orient);
                for (auto& P : B.precincts)
                    for (auto& K : P.blocks)
                        jobs.push_back({plane + int64_t(B.offy + K.y0 - B.y0) * tw
                                        + (B.offx + K.x0 - B.x0), &K, B.orient,
                                        weight});
            }
    }
    // code-blocks are coded independently, each on one thread
#pragma omp parallel for schedule(dynamic, 1)
    for (int64_t j = 0; j < int64_t(jobs.size()); ++j) {
        Block& K = *jobs[j].blk;
        encode_block(jobs[j].src, int(tw), K.x1 - K.x0, K.y1 - K.y0,
                     jobs[j].orient, jobs[j].weight, K.enc);
    }
    double lo = DBL_MAX, hi = 0.0;
    for (const Job& job : jobs) {
        const auto& ps = job.blk->enc.passes;
        for (size_t p = 0; p < ps.size(); ++p) {
            int32_t dr = int32_t(p == 0 ? ps[p].rate : ps[p].rate - ps[p - 1].rate);
            double dd = p == 0 ? ps[p].distortiondec
                : ps[p].distortiondec - ps[p - 1].distortiondec;
            if (dr == 0) continue;
            double slope = dd / dr;
            if (slope < lo) lo = slope;
            if (slope > hi) hi = slope;
        }
    }
    std::vector<uint8_t> scratch(size_t(std::max<int64_t>(maxlen, 1)));
    double thresh = 0.0, stable = 0.0;
    for (int i = 0; i < 128; ++i) {
        double next = (lo + hi) / 2;
        if (std::fabs(next - thresh) <= 0.5 * 1e-5 * thresh) break;
        thresh = next;
        make_layer(t, thresh);
        if (write_packets(t, scratch.data(), maxlen, false) < 0) {
            lo = thresh;
            continue;
        }
        hi = thresh;
        stable = thresh;
    }
    make_layer(t, stable == 0 ? thresh : stable);
    int64_t n = write_packets(t, out, cap, true);
    return n < 0 ? int64_t(ERR_ROOM) : n;
}


// Decodes one tile's packets (``data``, ``len`` bytes: the bodies of its
// tile-parts in order) into ``out``: one int32 plane per component, each
// (ty1 - ty0) x (tx1 - tx0), in OpenJPEG's tile layout. Returns 0, or a
// negative error.
int64_t j2k_decode_tile(const uint8_t* data, int64_t len, const int32_t* params,
                        int32_t* out) {
    Tile t;
    if (!build_tile(params, t)) return ERR_STREAM;
    std::vector<PacketId> order = packet_order(t);
    size_t pos = 0;
    for (const auto& id : order) {
        if (pos >= size_t(len)) break;    // the remaining packets are absent
        if (!read_packet(t, id, data, size_t(len), &pos)) return ERR_STREAM;
    }
    const int64_t tw = t.x1 - t.x0, th = t.y1 - t.y0;
    struct Job { Block* blk; int orient; int32_t* dst; };
    std::vector<Job> jobs;
    std::memset(out, 0, sizeof(int32_t) * tw * th * t.ncomp);
    for (int ci = 0; ci < t.ncomp; ++ci) {
        int32_t* plane = out + ci * tw * th;
        for (auto& R : t.comps[ci].res)
            for (auto& B : R.bands) {
                if (B.empty()) continue;
                for (auto& P : B.precincts)
                    for (auto& K : P.blocks) {
                        if (K.segs.empty()) continue;
                        if (K.numbps >= 31) return ERR_STREAM;
                        jobs.push_back({&K, B.orient, plane + int64_t(B.offy + K.y0 - B.y0) * tw
                                        + (B.offx + K.x0 - B.x0)});
                    }
            }
    }
#pragma omp parallel for schedule(dynamic, 1)
    for (int64_t j = 0; j < int64_t(jobs.size()); ++j) {
        Block& K = *jobs[j].blk;
        decode_block(K.bytes.data(), K.segs, K.numbps, jobs[j].orient,
                     K.x1 - K.x0, K.y1 - K.y0, jobs[j].dst, int(tw));
    }
    return 0;
}

}  // extern "C"
