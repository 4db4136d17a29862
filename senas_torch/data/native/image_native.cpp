// JPEG decoding and Pillow's resampling passes for the generic loaders, in
// C++ behind a plain C interface (loaded with ctypes).
//
// jpeg_decode gives the pixels that Pillow's bundled libjpeg-turbo gives
// with Pillow's settings (the accurate integer IDCT, fancy upsampling, no
// block smoothing needed on complete files):
//   - Huffman-coded baseline, extended sequential and progressive files
//     (successive approximation included), 8-bit samples, 1 or 3
//     components, sampling factors 1-2, restart intervals, any size;
//   - the integer IDCT of jidctint.c (output saturated, as the SIMD
//     version does);
//   - the upsampling of jdsample.c: h2v1 and h2v2 "fancy" (triangle)
//     where the downsampled width exceeds 2, else replication; h1v2 fancy
//     always; context rows above the first and below the last row repeat
//     that row (jdmainct.c);
//   - jdcolor.c's fixed-point YCbCr -> RGB tables, and the colour space
//     rule of jdapimin.c default_decompress_parms: JFIF means YCbCr, else
//     Adobe's transform flag, else component ids 'R','G','B' mean RGB.
// Anything else (arithmetic coding, lossless, hierarchical, 12-bit, 4
// components) fails with a message that names it.
//
// warp_affine_nearest, rgb_to_hsv and hsv_to_rgb are twins of cv2 5.0's
// warpAffine(INTER_NEAREST, BORDER_CONSTANT 0) and float32 cvtColor
// RGB <-> HSV on x86-64 (AVX2), rules found against cv2 on that host:
//   - warpAffine: the inverse matrix in double, cast to float; columns in
//     whole blocks of 16 map with fmaf(M0, x, float(y * M1) + M2), the
//     rest with fmaf(x, M0, y * M1) + M2; coordinates round half to even;
//   - RGB -> HSV: h = fmaf(d, 60 / (max - min + eps), base), base 0, 120,
//     240 or 360 (r the max and g < b), s = (max - min) / (|max| + eps);
//   - HSV -> RGB: h * (6 / 360), the sector trunc(h), tab2 = v * fmaf(-s,
//     f, 1), tab3 = v * fmaf(-s, 1 - f, 1).
// fmaf is libm's (correctly rounded); nothing else here is contracted,
// since the library is built without -mfma.
//
// resample_h / resample_v are the two integer passes of Pillow's
// ImagingResample on 8-bit images (Resample.c): each output is
// (1 << 21) + sum(in * k) over its window, shifted right by 22 and
// clipped to [0, 255]. The coefficients are computed by the caller
// (senas_torch/data/pilresample.py), which also holds numpy twins.
//
// Built at first use by senas_torch/data/native/build.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
    std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Error{msg}; }

const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries so that a corrupt run past 63 stays in the block
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
    bool defined = false;
    int maxcode[18];
    int valptr[17];
    int mincode[17];
    uint8_t vals[256];
    // 9-bit lookahead: (length << 8) | value, 0 where the code is longer
    uint16_t look[512];

    void build(const uint8_t* bits, const uint8_t* values, int nvals) {
        std::memcpy(vals, values, nvals);
        int code = 0, k = 0;
        std::memset(look, 0, sizeof(look));
        for (int len = 1; len <= 16; ++len) {
            valptr[len] = k;
            mincode[len] = code;
            for (int i = 0; i < bits[len - 1]; ++i) {
                if (len <= 9) {
                    int shift = 9 - len;
                    for (int f = 0; f < (1 << shift); ++f)
                        look[(code << shift) | f] = static_cast<uint16_t>((len << 8) | vals[k]);
                }
                ++code;
                ++k;
            }
            maxcode[len] = bits[len - 1] ? code - 1 : -1;
            code <<= 1;
        }
        maxcode[17] = 0x7fffffff;
        defined = true;
    }
};

struct BitReader {
    const uint8_t* data;
    size_t size;
    size_t pos;
    uint64_t buf = 0;
    int nbits = 0;
    bool at_marker = false;

    void fill(int need) {
        while (nbits < need) {
            uint32_t byte = 0;
            if (!at_marker && pos < size) {
                byte = data[pos];
                if (byte == 0xFF) {
                    uint8_t next = pos + 1 < size ? data[pos + 1] : 0xD9;
                    if (next == 0x00) {
                        pos += 2;
                    } else {
                        at_marker = true;  // a marker: zeros from here on
                        byte = 0;
                    }
                } else {
                    pos += 1;
                }
            }
            buf = (buf << 8) | byte;
            nbits += 8;
        }
    }
    int bits(int n) {
        if (n == 0) return 0;
        fill(n);
        nbits -= n;
        return static_cast<int>((buf >> nbits) & ((1u << n) - 1));
    }
    int bit() { return bits(1); }
    int decode(const Huffman& h) {
        fill(16);
        int peek = static_cast<int>((buf >> (nbits - 9)) & 511);
        uint16_t e = h.look[peek];
        if (e) {
            nbits -= e >> 8;
            return e & 255;
        }
        int code = bits(9);
        int len = 9;
        while (code > h.maxcode[len]) {
            code = (code << 1) | bit();
            if (++len > 16) return 0;  // a corrupt code: libjpeg warns and gives 0
        }
        return h.vals[h.valptr[len] + code - h.mincode[len]];
    }
    void restart(int expected) {
        buf = 0;
        nbits = 0;
        at_marker = false;
        // skip to the marker; the restart marker must come next
        while (pos + 1 < size && !(data[pos] == 0xFF && data[pos + 1] != 0x00 &&
                                   data[pos + 1] != 0xFF))
            ++pos;
        if (pos + 1 < size && data[pos + 1] == 0xD0 + expected) pos += 2;
    }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int td = 0, ta = 0;
    int bw = 0, bh = 0;  // blocks allocated (whole MCUs)
    int dw = 0, dh = 0;  // downsampled width and height in samples
    int dc_pred = 0;
    bool quant_latched = false;
    uint16_t quant[64];
    std::vector<int16_t> coef;
};

struct Decoder {
    const uint8_t* data;
    size_t size;
    size_t pos = 0;
    int width = 0, height = 0, ncomp = 0;
    bool progressive = false, frame = false;
    bool saw_jfif = false, saw_adobe = false;
    int adobe_transform = 0;
    int restart_interval = 0;
    int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
    uint16_t qt[4][64];
    bool qt_defined[4] = {false, false, false, false};
    Huffman dc[4], ac[4];
    Component comp[3];
    int eobrun = 0;

    int u16(size_t at) const {
        if (at + 2 > size) fail("truncated JPEG");
        return (data[at] << 8) | data[at + 1];
    }

    void parse_sof(size_t at, int len, int marker) {
        if (frame) fail("JPEG with more than one frame is not supported");
        int precision = data[at];
        if (precision != 8)
            fail(std::to_string(precision) + "-bit JPEG is not supported (8-bit samples only)");
        height = u16(at + 1);
        width = u16(at + 3);
        ncomp = data[at + 5];
        if (height == 0) fail("JPEG with its height in a DNL marker is not supported");
        if (width == 0) fail("JPEG of width 0");
        if (ncomp == 4)
            fail("4-component (CMYK or YCCK) JPEG is not supported (1 or 3 components only)");
        if (ncomp != 1 && ncomp != 3)
            fail(std::to_string(ncomp) + "-component JPEG is not supported (1 or 3 components only)");
        if (len < 6 + 3 * ncomp) fail("truncated JPEG frame header");
        for (int i = 0; i < ncomp; ++i) {
            Component& c = comp[i];
            c.id = data[at + 6 + 3 * i];
            c.h = data[at + 7 + 3 * i] >> 4;
            c.v = data[at + 7 + 3 * i] & 15;
            c.tq = data[at + 8 + 3 * i] & 3;
            if (c.h < 1 || c.h > 2 || c.v < 1 || c.v > 2)
                fail("JPEG sampling factor " + std::to_string(c.h) + "x" + std::to_string(c.v) +
                     " is not supported (factors 1-2 only)");
            hmax = std::max(hmax, c.h);
            vmax = std::max(vmax, c.v);
        }
        mcux = (width + 8 * hmax - 1) / (8 * hmax);
        mcuy = (height + 8 * vmax - 1) / (8 * vmax);
        for (int i = 0; i < ncomp; ++i) {
            Component& c = comp[i];
            c.dw = (width * c.h + hmax - 1) / hmax;
            c.dh = (height * c.v + vmax - 1) / vmax;
            c.bw = mcux * c.h;
            c.bh = mcuy * c.v;
            c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
        }
        progressive = marker == 0xC2;
        frame = true;
    }

    void parse_dht(size_t at, int len) {
        size_t end = at + len;
        while (at < end) {
            int tc = data[at] >> 4, th = data[at] & 15;
            if (th > 3 || tc > 1) fail("bad JPEG Huffman table");
            if (at + 17 > end) fail("truncated JPEG Huffman table");
            const uint8_t* bits = data + at + 1;
            int n = 0;
            for (int i = 0; i < 16; ++i) n += bits[i];
            if (n > 256 || at + 17 + n > end) fail("bad JPEG Huffman table");
            (tc == 0 ? dc[th] : ac[th]).build(bits, data + at + 17, n);
            at += 17 + n;
        }
    }

    void parse_dqt(size_t at, int len) {
        size_t end = at + len;
        while (at < end) {
            int pq = data[at] >> 4, tq = data[at] & 15;
            if (tq > 3) fail("bad JPEG quantization table");
            size_t need = 1 + 64 * (pq ? 2 : 1);
            if (at + need > end) fail("truncated JPEG quantization table");
            for (int k = 0; k < 64; ++k)
                qt[tq][kNatural[k]] = pq ? static_cast<uint16_t>(u16(at + 1 + 2 * k))
                                         : data[at + 1 + k];
            qt_defined[tq] = true;
            at += need;
        }
    }

    // One scan; returns the position after its entropy-coded data.
    size_t scan(size_t at, int len) {
        if (!frame) fail("JPEG scan before its frame header");
        int ns = data[at];
        if (ns < 1 || ns > ncomp || len < 4 + 2 * ns) fail("bad JPEG scan header");
        Component* sc[4];
        for (int i = 0; i < ns; ++i) {
            int cid = data[at + 1 + 2 * i];
            sc[i] = nullptr;
            for (int j = 0; j < ncomp; ++j)
                if (comp[j].id == cid) sc[i] = &comp[j];
            if (!sc[i]) fail("JPEG scan names an unknown component");
            sc[i]->td = data[at + 2 + 2 * i] >> 4;
            sc[i]->ta = data[at + 2 + 2 * i] & 15;
            if (sc[i]->td > 3 || sc[i]->ta > 3) fail("bad JPEG scan header");
            if (!sc[i]->quant_latched) {  // libjpeg latches a table at its first scan
                if (!qt_defined[sc[i]->tq]) fail("JPEG quantization table is missing");
                std::memcpy(sc[i]->quant, qt[sc[i]->tq], sizeof(sc[i]->quant));
                sc[i]->quant_latched = true;
            }
        }
        int ss = data[at + 1 + 2 * ns], se = data[at + 2 + 2 * ns];
        int ah = data[at + 3 + 2 * ns] >> 4, al = data[at + 3 + 2 * ns] & 15;
        if (!progressive) {
            ss = 0;
            se = 63;
            ah = al = 0;
        } else if (ss > se || se > 63 || (ss == 0 && se != 0) || (ss > 0 && ns != 1) ||
                   al > 13) {
            fail("bad progressive JPEG scan parameters");
        }
        for (int i = 0; i < ns; ++i) {
            bool needs_dc = ss == 0 && ah == 0;
            bool needs_ac = se > 0;
            if ((needs_dc && !dc[sc[i]->td].defined) || (needs_ac && !ac[sc[i]->ta].defined))
                fail("JPEG Huffman table is missing");
            sc[i]->dc_pred = 0;
        }
        eobrun = 0;
        BitReader br{data, size, at + len};

        // the MCUs of the scan: whole MCUs if interleaved, else the
        // component's own blocks
        int units_x, units_y;
        if (ns == 1) {
            units_x = (sc[0]->dw + 7) / 8;
            units_y = (sc[0]->dh + 7) / 8;
        } else {
            units_x = mcux;
            units_y = mcuy;
        }
        long total = static_cast<long>(units_x) * units_y;
        int rst = 0;
        for (long m = 0; m < total; ++m) {
            if (restart_interval && m > 0 && m % restart_interval == 0) {
                br.restart(rst);
                rst = (rst + 1) & 7;
                for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
                eobrun = 0;
            }
            int mx = static_cast<int>(m % units_x), my = static_cast<int>(m / units_x);
            if (ns == 1) {
                block(br, *sc[0], mx, my, ss, se, ah, al);
            } else {
                for (int i = 0; i < ns; ++i)
                    for (int y = 0; y < sc[i]->v; ++y)
                        for (int x = 0; x < sc[i]->h; ++x)
                            block(br, *sc[i], mx * sc[i]->h + x, my * sc[i]->v + y, ss, se, ah,
                                  al);
            }
        }
        // the entropy-coded data ends at the next marker that is not a restart
        size_t p = br.pos;
        while (p + 1 < size) {
            if (data[p] == 0xFF && data[p + 1] != 0x00 && data[p + 1] != 0xFF &&
                !(data[p + 1] >= 0xD0 && data[p + 1] <= 0xD7))
                break;
            ++p;
        }
        return p;
    }

    void block(BitReader& br, Component& c, int bx, int by, int ss, int se, int ah, int al) {
        int16_t* b = &c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64];
        if (!progressive) {
            int t = br.decode(dc[c.td]);
            int diff = t ? extend(br.bits(t), t) : 0;
            c.dc_pred += diff;
            b[0] = static_cast<int16_t>(c.dc_pred);
            const Huffman& h = ac[c.ta];
            for (int k = 1; k < 64; ++k) {
                int rs = br.decode(h);
                int r = rs >> 4, s = rs & 15;
                if (s) {
                    k += r;
                    b[kNatural[k]] = static_cast<int16_t>(extend(br.bits(s), s));
                } else {
                    if (r != 15) break;
                    k += 15;
                }
            }
            return;
        }
        if (ss == 0) {  // DC scans
            if (ah == 0) {
                int t = br.decode(dc[c.td]);
                int diff = t ? extend(br.bits(t), t) : 0;
                c.dc_pred += diff;
                b[0] = static_cast<int16_t>(c.dc_pred * (1 << al));
            } else if (br.bit()) {
                b[0] = static_cast<int16_t>(b[0] | (1 << al));
            }
            return;
        }
        const Huffman& h = ac[c.ta];
        if (ah == 0) {  // AC first scan (jdphuff.c decode_mcu_AC_first)
            if (eobrun > 0) {
                --eobrun;
                return;
            }
            for (int k = ss; k <= se; ++k) {
                int rs = br.decode(h);
                int r = rs >> 4, s = rs & 15;
                if (s) {
                    k += r;
                    b[kNatural[k]] = static_cast<int16_t>(extend(br.bits(s), s) * (1 << al));
                } else if (r == 15) {
                    k += 15;
                } else {
                    eobrun = 1 << r;
                    if (r) eobrun += br.bits(r);
                    --eobrun;
                    break;
                }
            }
            return;
        }
        // AC refinement (jdphuff.c decode_mcu_AC_refine)
        int p1 = 1 << al, m1 = -1 * (1 << al);
        int k = ss;
        if (eobrun == 0) {
            for (; k <= se; ++k) {
                int rs = br.decode(h);
                int r = rs >> 4, s = rs & 15;
                if (s) {
                    s = br.bit() ? p1 : m1;
                } else if (r != 15) {
                    eobrun = 1 << r;
                    if (r) eobrun += br.bits(r);
                    break;
                }
                do {
                    int16_t* t = b + kNatural[k];
                    if (*t != 0) {
                        if (br.bit() && (*t & p1) == 0)
                            *t = static_cast<int16_t>(*t >= 0 ? *t + p1 : *t + m1);
                    } else if (--r < 0) {
                        break;
                    }
                    ++k;
                } while (k <= se);
                if (s) b[kNatural[k]] = static_cast<int16_t>(s);
            }
        }
        if (eobrun > 0) {
            for (; k <= se; ++k) {
                int16_t* t = b + kNatural[k];
                if (*t != 0 && br.bit() && (*t & p1) == 0)
                    *t = static_cast<int16_t>(*t >= 0 ? *t + p1 : *t + m1);
            }
            --eobrun;
        }
    }

    // Every segment to the end of the image, or with `headers_only` up to
    // the frame header (what jpeg_info needs).
    void parse(bool headers_only = false) {
        if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file");
        pos = 2;
        bool scanned = false;
        while (true) {
            // find the next marker (fill bytes 0xFF may precede it)
            while (pos < size && data[pos] != 0xFF) ++pos;
            while (pos < size && data[pos] == 0xFF) ++pos;
            if (pos >= size) {
                if (scanned) return;  // no EOI: libjpeg warns and ends the image
                fail("truncated JPEG");
            }
            int marker = data[pos++];
            if (marker == 0xD9) return;
            if (marker >= 0xD0 && marker <= 0xD7) continue;
            if (marker == 0x01) continue;
            int len = u16(pos);
            if (len < 2 || pos + len > size) fail("truncated JPEG segment");
            size_t body = pos + 2;
            int blen = len - 2;
            switch (marker) {
                case 0xC0:
                case 0xC1:
                case 0xC2:
                    parse_sof(body, blen, marker);
                    if (headers_only) return;
                    break;
                case 0xC3:
                    fail("lossless JPEG is not supported");
                case 0xC5:
                case 0xC6:
                case 0xC7:
                case 0xDE:
                    fail("hierarchical (differential) JPEG is not supported");
                case 0xC9:
                case 0xCA:
                case 0xCB:
                case 0xCD:
                case 0xCE:
                case 0xCF:
                case 0xCC:
                    fail("arithmetic-coded JPEG is not supported");
                case 0xC4:
                    parse_dht(body, blen);
                    break;
                case 0xDB:
                    parse_dqt(body, blen);
                    break;
                case 0xDD:
                    if (blen < 2) fail("bad JPEG restart interval");
                    restart_interval = u16(body);
                    break;
                case 0xE0:
                    if (blen >= 14 && std::memcmp(data + body, "JFIF\0", 5) == 0) saw_jfif = true;
                    break;
                case 0xEE:
                    if (blen >= 12 && std::memcmp(data + body, "Adobe", 5) == 0) {
                        saw_adobe = true;
                        adobe_transform = data[body + 11];
                    }
                    break;
                case 0xDA: {
                    pos = scan(body, blen);
                    scanned = true;
                    if (!progressive) {
                        // a sequential file ends once every component was scanned
                    }
                    continue;
                }
                default:
                    break;
            }
            pos += len;
        }
    }

    bool rgb_colour_space() const {
        if (ncomp != 3) return false;
        if (saw_jfif) return false;
        if (saw_adobe) return adobe_transform == 0;
        return comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
    }
};

// jidctint.c jpeg_idct_islow on one block, output saturated to 8 bits.
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    const int CONST_BITS = 13, PASS1_BITS = 2;
    const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;
    int ws[64];
    for (int c = 0; c < 8; ++c) {
        auto dq = [&](int r) { return static_cast<int64_t>(in[r * 8 + c]) * q[r * 8 + c]; };
        int64_t z2 = dq(2), z3 = dq(6);
        int64_t z1 = (z2 + z3) * F0541;
        int64_t tmp2 = z1 + z3 * (-F1847);
        int64_t tmp3 = z1 + z2 * F0765;
        z2 = dq(0);
        z3 = dq(4);
        int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
        int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = dq(7);
        tmp1 = dq(5);
        tmp2 = dq(3);
        tmp3 = dq(1);
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * F1175;
        tmp0 *= F0298;
        tmp1 *= F2053;
        tmp2 *= F3072;
        tmp3 *= F1501;
        z1 *= -F0899;
        z2 *= -F2562;
        z3 *= -F1961;
        z4 *= -F0390;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int sh = CONST_BITS - PASS1_BITS;
        const int64_t rnd = int64_t(1) << (sh - 1);
        ws[0 * 8 + c] = static_cast<int>((tmp10 + tmp3 + rnd) >> sh);
        ws[7 * 8 + c] = static_cast<int>((tmp10 - tmp3 + rnd) >> sh);
        ws[1 * 8 + c] = static_cast<int>((tmp11 + tmp2 + rnd) >> sh);
        ws[6 * 8 + c] = static_cast<int>((tmp11 - tmp2 + rnd) >> sh);
        ws[2 * 8 + c] = static_cast<int>((tmp12 + tmp1 + rnd) >> sh);
        ws[5 * 8 + c] = static_cast<int>((tmp12 - tmp1 + rnd) >> sh);
        ws[3 * 8 + c] = static_cast<int>((tmp13 + tmp0 + rnd) >> sh);
        ws[4 * 8 + c] = static_cast<int>((tmp13 - tmp0 + rnd) >> sh);
    }
    for (int r = 0; r < 8; ++r) {
        const int* w = ws + r * 8;
        int64_t z2 = w[2], z3 = w[6];
        int64_t z1 = (z2 + z3) * F0541;
        int64_t tmp2 = z1 + z3 * (-F1847);
        int64_t tmp3 = z1 + z2 * F0765;
        int64_t tmp0 = (int64_t(w[0]) + w[4]) * (1 << CONST_BITS);
        int64_t tmp1 = (int64_t(w[0]) - w[4]) * (1 << CONST_BITS);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = w[7];
        tmp1 = w[5];
        tmp2 = w[3];
        tmp3 = w[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * F1175;
        tmp0 *= F0298;
        tmp1 *= F2053;
        tmp2 *= F3072;
        tmp3 *= F1501;
        z1 *= -F0899;
        z2 *= -F2562;
        z3 *= -F1961;
        z4 *= -F0390;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int sh = CONST_BITS + PASS1_BITS + 3;
        const int64_t rnd = int64_t(1) << (sh - 1);
        auto put = [&](int col, int64_t v) {
            int64_t s = ((v + rnd) >> sh) + 128;
            out[r * stride + col] = static_cast<uint8_t>(s < 0 ? 0 : (s > 255 ? 255 : s));
        };
        put(0, tmp10 + tmp3);
        put(7, tmp10 - tmp3);
        put(1, tmp11 + tmp2);
        put(6, tmp11 - tmp2);
        put(2, tmp12 + tmp1);
        put(5, tmp12 - tmp1);
        put(3, tmp13 + tmp0);
        put(4, tmp13 - tmp0);
    }
}

// The component's samples at full resolution [height][width] (jdsample.c).
std::vector<uint8_t> upsample(const Component& c, const std::vector<uint8_t>& plane,
                              int pw, int hmax, int vmax, int width, int height) {
    const int hr = hmax / c.h, vr = vmax / c.v;
    const int dw = c.dw, dh = c.dh;
    std::vector<uint8_t> out(static_cast<size_t>(width) * height);
    auto row = [&](int y) {
        y = y < 0 ? 0 : (y >= dh ? dh - 1 : y);  // context rows repeat the edge rows
        return plane.data() + static_cast<size_t>(y) * pw;
    };
    std::vector<uint8_t> line(2 * static_cast<size_t>(dw) + 2);
    for (int oy = 0; oy < height; ++oy) {
        uint8_t* o = out.data() + static_cast<size_t>(oy) * width;
        if (hr == 1 && vr == 1) {
            std::memcpy(o, row(oy), width);
        } else if (hr == 2 && vr == 1) {
            const uint8_t* in = row(oy);
            if (dw > 2) {  // h2v1_fancy_upsample
                uint8_t* p = line.data();
                int v = in[0];
                *p++ = static_cast<uint8_t>(v);
                *p++ = static_cast<uint8_t>((v * 3 + in[1] + 2) >> 2);
                for (int x = 1; x < dw - 1; ++x) {
                    v = in[x] * 3;
                    *p++ = static_cast<uint8_t>((v + in[x - 1] + 1) >> 2);
                    *p++ = static_cast<uint8_t>((v + in[x + 1] + 2) >> 2);
                }
                v = in[dw - 1];
                *p++ = static_cast<uint8_t>((v * 3 + in[dw - 2] + 1) >> 2);
                *p++ = static_cast<uint8_t>(v);
                std::memcpy(o, line.data(), width);
            } else {
                for (int x = 0; x < width; ++x) o[x] = in[x >> 1];
            }
        } else if (hr == 1 && vr == 2) {  // h1v2_fancy_upsample
            int iy = oy >> 1;
            const uint8_t* near = row(iy);
            const uint8_t* far = (oy & 1) ? row(iy + 1) : row(iy - 1);
            int bias = (oy & 1) ? 2 : 1;
            for (int x = 0; x < width; ++x) o[x] = static_cast<uint8_t>((near[x] * 3 + far[x] + bias) >> 2);
        } else {  // 2, 2
            int iy = oy >> 1;
            if (dw > 2) {  // h2v2_fancy_upsample
                const uint8_t* i0 = row(iy);
                const uint8_t* i1 = (oy & 1) ? row(iy + 1) : row(iy - 1);
                uint8_t* p = line.data();
                int thiscol = i0[0] * 3 + i1[0];
                int nextcol = i0[1] * 3 + i1[1];
                *p++ = static_cast<uint8_t>((thiscol * 4 + 8) >> 4);
                *p++ = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
                int lastcol = thiscol;
                thiscol = nextcol;
                for (int x = 2; x < dw; ++x) {
                    nextcol = i0[x] * 3 + i1[x];
                    *p++ = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
                    *p++ = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
                    lastcol = thiscol;
                    thiscol = nextcol;
                }
                *p++ = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
                *p++ = static_cast<uint8_t>((thiscol * 4 + 7) >> 4);
                std::memcpy(o, line.data(), width);
            } else {
                const uint8_t* in = row(iy);
                for (int x = 0; x < width; ++x) o[x] = in[x >> 1];
            }
        }
    }
    return out;
}

void decode_pixels(Decoder& d, uint8_t* out) {
    std::vector<std::vector<uint8_t>> full(d.ncomp);
    for (int ci = 0; ci < d.ncomp; ++ci) {
        Component& c = d.comp[ci];
        if (!c.quant_latched) fail("JPEG component without a scan");
        int pw = c.bw * 8;
        std::vector<uint8_t> plane(static_cast<size_t>(pw) * c.bh * 8);
        for (int by = 0; by < c.bh; ++by)
            for (int bx = 0; bx < c.bw; ++bx)
                idct_islow(&c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64], c.quant,
                           plane.data() + static_cast<size_t>(by) * 8 * pw + bx * 8, pw);
        full[ci] = upsample(c, plane, pw, d.hmax, d.vmax, d.width, d.height);
    }
    size_t n = static_cast<size_t>(d.width) * d.height;
    if (d.ncomp == 1) {
        std::memcpy(out, full[0].data(), n);
        return;
    }
    if (d.rgb_colour_space()) {
        for (size_t i = 0; i < n; ++i)
            for (int k = 0; k < 3; ++k) out[3 * i + k] = full[k][i];
        return;
    }
    // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert
    const int SCALEBITS = 16;
    const int64_t ONE_HALF = int64_t(1) << (SCALEBITS - 1);
    auto FIX = [](double x) { return static_cast<int64_t>(x * (1L << 16) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
        int64_t x = i - 128;
        cr_r[i] = static_cast<int>((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
        cb_b[i] = static_cast<int>((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
        cr_g[i] = -FIX(0.71414) * x;
        cb_g[i] = -FIX(0.34414) * x + ONE_HALF;
    }
    auto clamp = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    for (size_t i = 0; i < n; ++i) {
        int y = full[0][i], cb = full[1][i], cr = full[2][i];
        out[3 * i + 0] = clamp(y + cr_r[cr]);
        out[3 * i + 1] = clamp(y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
        out[3 * i + 2] = clamp(y + cb_b[cb]);
    }
}

void put_error(char* err, int errlen, const std::string& msg) {
    if (errlen <= 0) return;
    std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
}

}  // namespace

extern "C" {

// The size of a JPEG image: writes width, height and its components (1 or
// 3) and returns 0, or writes a message to `err` and returns 1.
int jpeg_info(const uint8_t* data, long size, int* width, int* height, int* comps, char* err,
              int errlen) {
    try {
        Decoder d;
        d.data = data;
        d.size = static_cast<size_t>(size);
        d.parse(true);
        if (!d.frame) fail("JPEG without a frame header");
        *width = d.width;
        *height = d.height;
        *comps = d.ncomp;
        return 0;
    } catch (const Error& e) {
        put_error(err, errlen, e.msg);
        return 1;
    }
}

// Decode into `out`: uint8 [height][width] for one component, else
// [height][width][3] in RGB. Returns 0, or 1 with a message in `err`.
int jpeg_decode(const uint8_t* data, long size, uint8_t* out, char* err, int errlen) {
    try {
        Decoder d;
        d.data = data;
        d.size = static_cast<size_t>(size);
        d.parse();
        if (!d.frame) fail("JPEG without a frame header");
        decode_pixels(d, out);
        return 0;
    } catch (const Error& e) {
        put_error(err, errlen, e.msg);
        return 1;
    }
}

// Pillow's horizontal pass: in uint8 [rows][in_w][ch] from row `first`,
// out uint8 [out_rows][out_w][ch]; output column x reads the bounds[2x+1]
// inputs from bounds[2x] with the fixed-point weights k[x * ksize + i].
void resample_h(const uint8_t* in, int in_w, int ch, int first, int out_rows, uint8_t* out,
                int out_w, const int32_t* bounds, const int32_t* k, int ksize) {
    for (int y = 0; y < out_rows; ++y) {
        const uint8_t* src = in + static_cast<size_t>(y + first) * in_w * ch;
        uint8_t* dst = out + static_cast<size_t>(y) * out_w * ch;
        for (int x = 0; x < out_w; ++x) {
            int xmin = bounds[2 * x], xn = bounds[2 * x + 1];
            const int32_t* kk = k + static_cast<size_t>(x) * ksize;
            for (int c = 0; c < ch; ++c) {
                int32_t ss = 1 << 21;
                for (int i = 0; i < xn; ++i) ss += src[(xmin + i) * ch + c] * kk[i];
                int v = ss >> 22;
                dst[x * ch + c] = static_cast<uint8_t>(ss <= 0 ? 0 : (v > 255 ? 255 : v));
            }
        }
    }
}

// Pillow's vertical pass: in uint8 [in_h][w][ch], out uint8 [out_h][w][ch];
// output row y reads the bounds[2y+1] rows from bounds[2y].
void resample_v(const uint8_t* in, int w, int ch, uint8_t* out, int out_h,
                const int32_t* bounds, const int32_t* k, int ksize) {
    const size_t stride = static_cast<size_t>(w) * ch;
    for (int y = 0; y < out_h; ++y) {
        int ymin = bounds[2 * y], yn = bounds[2 * y + 1];
        const int32_t* kk = k + static_cast<size_t>(y) * ksize;
        uint8_t* dst = out + y * stride;
        for (size_t x = 0; x < stride; ++x) {
            int32_t ss = 1 << 21;
            for (int i = 0; i < yn; ++i) ss += in[(ymin + i) * stride + x] * kk[i];
            int v = ss >> 22;
            dst[x] = static_cast<uint8_t>(ss <= 0 ? 0 : (v > 255 ? 255 : v));
        }
    }
}

// cv2.warpAffine(src, M, (w, h), flags=INTER_NEAREST, borderValue=0) of
// an image [h][w] of `pix`-byte pixels; `m` is the inverse map as float.
void warp_affine_nearest(const uint8_t* src, int h, int w, int pix, uint8_t* out,
                         const float* m) {
    const int cut = (w / 16) * 16;
    for (int y = 0; y < h; ++y) {
        const float fy = static_cast<float>(y);
        const float ax = fy * m[1], ay = fy * m[4];
        const float bx = ax + m[2], by = ay + m[5];
        for (int x = 0; x < w; ++x) {
            const float fx = static_cast<float>(x);
            float sx, sy;
            if (x < cut) {
                sx = std::fmaf(m[0], fx, bx);
                sy = std::fmaf(m[3], fx, by);
            } else {
                sx = std::fmaf(fx, m[0], ax) + m[2];
                sy = std::fmaf(fx, m[3], ay) + m[5];
            }
            const float rx = std::nearbyintf(sx), ry = std::nearbyintf(sy);
            uint8_t* o = out + (static_cast<size_t>(y) * w + x) * pix;
            if (rx >= 0.f && rx < static_cast<float>(w) && ry >= 0.f && ry < static_cast<float>(h)) {
                const uint8_t* s = src + (static_cast<size_t>(ry) * w + static_cast<size_t>(rx)) * pix;
                std::memcpy(o, s, pix);
            } else {
                std::memset(o, 0, pix);
            }
        }
    }
}

// cv2.cvtColor(rgb, COLOR_RGB2HSV) of n float32 pixels (h in [0, 360)).
void rgb_to_hsv(const float* in, float* out, long n) {
    const float eps = 1.1920928955078125e-07f;
    for (long i = 0; i < n; ++i) {
        const float r = in[3 * i], g = in[3 * i + 1], b = in[3 * i + 2];
        const float v = std::max(std::max(r, g), b), lo = std::min(std::min(r, g), b);
        const float diff = v - lo;
        const float s = diff / (std::fabs(v) + eps);
        const bool rmax = r == v, gmax = g == v;
        const float num = rmax ? g - b : (gmax ? b - r : r - g);
        const float base = rmax ? (g < b ? 360.f : 0.f) : (gmax ? 120.f : 240.f);
        const float d = 60.f / (diff + eps);
        out[3 * i] = std::fmaf(num, d, base);
        out[3 * i + 1] = s;
        out[3 * i + 2] = v;
    }
}

// cv2.cvtColor(hsv, COLOR_HSV2RGB) of n float32 pixels.
void hsv_to_rgb(const float* in, float* out, long n) {
    static const int sector_data[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1},
                                          {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};
    const float hscale = 6.f / 360.f;
    for (long i = 0; i < n; ++i) {
        float h = in[3 * i] * hscale;
        const float s = in[3 * i + 1], v = in[3 * i + 2];
        const float pre = std::trunc(h);
        h = h - pre;
        float sector = pre - std::trunc(pre * (1.f / 6.f)) * 6.f;
        float tab[4];
        tab[0] = v;
        tab[1] = v * (1.f - s);
        tab[2] = v * std::fmaf(-s, h, 1.f);
        tab[3] = v * std::fmaf(-s, 1.f - h, 1.f);
        int k = static_cast<int>(sector);
        k = k < 0 ? 0 : (k > 5 ? 5 : k);
        out[3 * i] = tab[sector_data[k][2]];
        out[3 * i + 1] = tab[sector_data[k][1]];
        out[3 * i + 2] = tab[sector_data[k][0]];
    }
}

}  // extern "C"
