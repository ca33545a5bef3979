// Native EXR PIZ decompressor (format per the OpenEXR file-format spec:
// 16-bit wavelet transform + bitmap LUT + canonical Huffman coding).
//
// Role parity: the reference reads/writes EXR through OpenEXR
// (src/core/bitmap.cpp); all of its shipped renders (results/*.exr) and
// scene assets (scenes/*/*.exr) are PIZ-compressed HALF scanline images.
// This decoder lets the renderer load those assets (envmaps) and
// validate against the reference's actual renders without OpenEXR.
//
// Exposed C ABI (ctypes, see mitsuba3_plt_tpu/utils/exr.py):
//   piz_uncompress(src, src_len, num_channels, ch_size_u16, ch_nx, ny,
//                  out, out_len_u16) -> 0 on success, <0 error code.
// Output layout matches an uncompressed EXR scanline block: for each
// scanline, each channel's row in chlist order.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------- bitmap/LUT
constexpr int USHORT_RANGE = 1 << 16;
constexpr int BITMAP_SIZE = USHORT_RANGE >> 3;

uint16_t reverse_lut_from_bitmap(const uint8_t bitmap[BITMAP_SIZE],
                                 uint16_t lut[USHORT_RANGE]) {
    int k = 0;
    for (int i = 0; i < USHORT_RANGE; ++i) {
        if (i == 0 || (bitmap[i >> 3] & (1 << (i & 7))))
            lut[k++] = (uint16_t)i;
    }
    int n = k - 1;
    while (k < USHORT_RANGE) lut[k++] = 0;
    return (uint16_t)n;  // maximum value stored in lut
}

// ---------------------------------------------------------------- Huffman
constexpr int HUF_ENCBITS = 16;
constexpr int HUF_DECBITS = 14;
constexpr int HUF_ENCSIZE = (1 << HUF_ENCBITS) + 1;
constexpr int HUF_DECSIZE = 1 << HUF_DECBITS;
constexpr int HUF_DECMASK = HUF_DECSIZE - 1;

struct HufDec {
    int len = 0;   // code length, if short code
    int lit = 0;   // symbol (short) or number of long-code candidates
    std::vector<int> p;  // long-code candidate symbols
};

inline int64_t huf_length(int64_t code) { return code & 63; }
inline int64_t huf_code(int64_t code) { return code >> 6; }

inline bool get_char(int64_t &c, int &lc, const uint8_t *&in,
                     const uint8_t *ie) {
    if (in >= ie) return false;
    c = (c << 8) | *in++;
    lc += 8;
    return true;
}

inline bool get_bits(int nBits, int64_t &c, int &lc, const uint8_t *&in,
                     const uint8_t *ie, int64_t &out) {
    while (lc < nBits) {
        if (!get_char(c, lc, in, ie)) return false;
    }
    lc -= nBits;
    out = (c >> lc) & ((1 << nBits) - 1);
    return true;
}

constexpr int SHORT_ZEROCODE_RUN = 59;
constexpr int LONG_ZEROCODE_RUN = 63;
constexpr int SHORTEST_LONG_RUN = 2 + LONG_ZEROCODE_RUN - SHORT_ZEROCODE_RUN;

// Unpack the per-symbol code-length table (6-bit lengths, zero-run coded),
// then rebuild the canonical code table in place.
bool huf_unpack_enc_table(const uint8_t *&in, const uint8_t *ie, int im,
                          int iM, int64_t *hcode) {
    memset(hcode, 0, sizeof(int64_t) * HUF_ENCSIZE);
    int64_t c = 0;
    int lc = 0;
    for (; im <= iM; im++) {
        int64_t l;
        if (!get_bits(6, c, lc, in, ie, l)) return false;
        hcode[im] = l;
        if (l == LONG_ZEROCODE_RUN) {
            int64_t zerun8;
            if (!get_bits(8, c, lc, in, ie, zerun8)) return false;
            int64_t zerun = zerun8 + SHORTEST_LONG_RUN;
            if (im + zerun > iM + 1) return false;
            while (zerun--) hcode[im++] = 0;
            im--;
        } else if (l >= SHORT_ZEROCODE_RUN) {
            int64_t zerun = l - SHORT_ZEROCODE_RUN + 2;
            if (im + zerun > iM + 1) return false;
            while (zerun--) hcode[im++] = 0;
            im--;
        }
    }
    // canonical codes from lengths
    int64_t n[59] = {0};
    for (int i = 0; i < HUF_ENCSIZE; ++i) n[hcode[i]] += 1;
    int64_t cc = 0;
    for (int i = 58; i > 0; --i) {
        int64_t nc = (cc + n[i]) >> 1;
        n[i] = cc;
        cc = nc;
    }
    for (int i = 0; i < HUF_ENCSIZE; ++i) {
        int l = (int)hcode[i];
        if (l > 0) hcode[i] = l | (n[l]++ << 6);
    }
    return true;
}

bool huf_build_dec_table(const int64_t *hcode, int im, int iM,
                         std::vector<HufDec> &hdecod) {
    hdecod.assign(HUF_DECSIZE, HufDec());
    for (; im <= iM; im++) {
        int64_t c = huf_code(hcode[im]);
        int l = (int)huf_length(hcode[im]);
        if (c >> l) return false;  // code longer than its length claims
        if (l > HUF_DECBITS) {
            HufDec &pl = hdecod[c >> (l - HUF_DECBITS)];
            if (pl.len) return false;
            pl.lit++;
            pl.p.push_back(im);
        } else if (l) {
            HufDec *pl = &hdecod[c << (HUF_DECBITS - l)];
            for (int64_t i = ((int64_t)1) << (HUF_DECBITS - l); i > 0;
                 i--, pl++) {
                if (pl->len || !pl->p.empty()) return false;
                pl->len = l;
                pl->lit = im;
            }
        }
    }
    return true;
}

inline bool emit_code(int po, int rlc, int64_t &c, int &lc,
                      const uint8_t *&in, const uint8_t *ie, uint16_t *&out,
                      uint16_t *oe) {
    if (po == rlc) {
        if (lc < 8 && !get_char(c, lc, in, ie)) return false;
        lc -= 8;
        int cs = (int)((c >> lc) & 0xff);
        if (out + cs > oe || out == nullptr) return false;
        uint16_t s = out[-1];
        while (cs-- > 0) *out++ = s;
    } else {
        if (out >= oe) return false;
        *out++ = (uint16_t)po;
    }
    return true;
}

bool huf_decode(const int64_t *hcode, const std::vector<HufDec> &hdecod,
                const uint8_t *in, int ni /*bits*/, int rlc, uint16_t *out,
                int no) {
    int64_t c = 0;
    int lc = 0;
    const uint8_t *ie = in + (ni + 7) / 8;
    uint16_t *op = out;
    uint16_t *oe = out + no;

    while (in < ie) {
        if (!get_char(c, lc, in, ie)) break;
        while (lc >= HUF_DECBITS) {
            const HufDec &pl = hdecod[(c >> (lc - HUF_DECBITS)) & HUF_DECMASK];
            if (pl.len) {
                lc -= pl.len;
                if (!emit_code(pl.lit, rlc, c, lc, in, ie, op, oe))
                    return false;
            } else {
                if (pl.p.empty()) return false;
                int j;
                for (j = 0; j < pl.lit; j++) {
                    int l = (int)huf_length(hcode[pl.p[j]]);
                    while (lc < l && in < ie) get_char(c, lc, in, ie);
                    if (lc >= l) {
                        if (huf_code(hcode[pl.p[j]]) ==
                            ((c >> (lc - l)) & (((int64_t)1 << l) - 1))) {
                            lc -= l;
                            if (!emit_code(pl.p[j], rlc, c, lc, in, ie, op,
                                           oe))
                                return false;
                            break;
                        }
                    }
                }
                if (j == pl.lit) return false;
            }
        }
    }
    // flush remaining bits
    int i = (8 - ni) & 7;
    c >>= i;
    lc -= i;
    while (lc > 0) {
        const HufDec &pl = hdecod[(c << (HUF_DECBITS - lc)) & HUF_DECMASK];
        if (pl.len && pl.len <= lc) {
            lc -= pl.len;
            if (!emit_code(pl.lit, rlc, c, lc, in, ie, op, oe)) return false;
        } else {
            return false;
        }
    }
    return op == oe;
}

bool huf_uncompress(const uint8_t *src, int n, uint16_t *out, int no) {
    if (n < 20) return false;
    auto rd32 = [&](int off) {
        int32_t v;
        memcpy(&v, src + off, 4);
        return v;
    };
    int im = rd32(0), iM = rd32(4), nBits = rd32(12);
    if (im < 0 || im >= HUF_ENCSIZE || iM < 0 || iM >= HUF_ENCSIZE)
        return false;
    const uint8_t *ptr = src + 20;
    const uint8_t *end = src + n;
    std::vector<int64_t> freq(HUF_ENCSIZE);
    if (!huf_unpack_enc_table(ptr, end, im, iM, freq.data())) return false;
    if (nBits > 8 * (int64_t)(end - ptr)) return false;
    std::vector<HufDec> hdec;
    if (!huf_build_dec_table(freq.data(), im, iM, hdec)) return false;
    return huf_decode(freq.data(), hdec, ptr, nBits, iM, out, no);
}

// ---------------------------------------------------------------- wavelet
constexpr int NBITS = 16;
constexpr int A_OFFSET = 1 << (NBITS - 1);
constexpr int MOD_MASK = (1 << NBITS) - 1;

inline void wdec14(uint16_t l, uint16_t h, uint16_t &a, uint16_t &b) {
    int16_t ls = (int16_t)l;
    int16_t hs = (int16_t)h;
    int hi = hs;
    int ai = ls + (hi & 1) + (hi >> 1);
    a = (uint16_t)ai;
    b = (uint16_t)(ai - hi);
}

inline void wdec16(uint16_t l, uint16_t h, uint16_t &a, uint16_t &b) {
    int m = l;
    int d = h;
    int bb = (m - (d >> 1)) & MOD_MASK;
    int aa = (d + bb - A_OFFSET) & MOD_MASK;
    b = (uint16_t)bb;
    a = (uint16_t)aa;
}

void wav2_decode(uint16_t *in, int nx, int ox, int ny, int oy, uint16_t mx) {
    bool w14 = (mx < (1 << 14));
    int n = (nx > ny) ? ny : nx;
    int p = 1;
    while (p <= n) p <<= 1;
    p >>= 1;
    int p2 = p;
    p >>= 1;

    while (p >= 1) {
        uint16_t *py = in;
        uint16_t *ey = in + oy * (ny - p2);
        int oy1 = oy * p, oy2 = oy * p2;
        int ox1 = ox * p, ox2 = ox * p2;
        uint16_t i00, i01, i10, i11;

        for (; py <= ey; py += oy2) {
            uint16_t *px = py;
            uint16_t *ex = py + ox * (nx - p2);
            for (; px <= ex; px += ox2) {
                uint16_t *p01 = px + ox1;
                uint16_t *p10 = px + oy1;
                uint16_t *p11 = p10 + ox1;
                if (w14) {
                    wdec14(*px, *p10, i00, i10);
                    wdec14(*p01, *p11, i01, i11);
                    wdec14(i00, i01, *px, *p01);
                    wdec14(i10, i11, *p10, *p11);
                } else {
                    wdec16(*px, *p10, i00, i10);
                    wdec16(*p01, *p11, i01, i11);
                    wdec16(i00, i01, *px, *p01);
                    wdec16(i10, i11, *p10, *p11);
                }
            }
            if (nx & p) {
                uint16_t *p10 = px + oy1;
                if (w14)
                    wdec14(*px, *p10, i00, *p10);
                else
                    wdec16(*px, *p10, i00, *p10);
                *px = i00;
            }
        }
        if (ny & p) {
            uint16_t *px = py;
            uint16_t *ex = py + ox * (nx - p2);
            for (; px <= ex; px += ox2) {
                uint16_t *p01 = px + ox1;
                if (w14)
                    wdec14(*px, *p01, i00, *p01);
                else
                    wdec16(*px, *p01, i00, *p01);
                *px = i00;
            }
        }
        p2 = p;
        p >>= 1;
    }
}

}  // namespace

extern "C" {

// Decompress one PIZ scanline block. ch_size_u16[i]: channel pixel size in
// uint16 units (HALF=1, FLOAT/UINT=2); ch_nx[i]: pixels per row. ny:
// scanlines in the block. Output: scanline-interleaved uncompressed block.
int piz_uncompress(const uint8_t *src, int src_len, int num_channels,
                   const int *ch_size_u16, const int *ch_nx, int ny,
                   uint16_t *out, int out_len_u16) {
    if (src_len < 4) return -1;
    uint16_t min_nz, max_nz;
    memcpy(&min_nz, src, 2);
    memcpy(&max_nz, src + 2, 2);
    if (min_nz >= BITMAP_SIZE || max_nz >= BITMAP_SIZE) return -2;
    int off = 4;
    uint8_t bitmap[BITMAP_SIZE];
    memset(bitmap, 0, sizeof(bitmap));
    if (max_nz >= min_nz) {
        int nbytes = max_nz - min_nz + 1;
        if (off + nbytes > src_len) return -3;
        memcpy(bitmap + min_nz, src + off, nbytes);
        off += nbytes;
    }
    std::vector<uint16_t> lut(USHORT_RANGE);
    uint16_t max_value = reverse_lut_from_bitmap(bitmap, lut.data());

    if (off + 4 > src_len) return -4;
    int32_t huf_len;
    memcpy(&huf_len, src + off, 4);
    off += 4;
    if (huf_len < 0 || off + huf_len > src_len) return -5;

    // total u16 count and per-channel offsets
    int64_t total = 0;
    std::vector<int64_t> ch_start(num_channels);
    for (int c = 0; c < num_channels; ++c) {
        ch_start[c] = total;
        total += (int64_t)ch_nx[c] * ch_size_u16[c] * ny;
    }
    if (total != out_len_u16) return -6;

    std::vector<uint16_t> tmp(total);
    if (!huf_uncompress(src + off, huf_len, tmp.data(), (int)total))
        return -7;

    for (int c = 0; c < num_channels; ++c) {
        int sz = ch_size_u16[c], nx = ch_nx[c];
        for (int j = 0; j < sz; ++j)
            wav2_decode(tmp.data() + ch_start[c] + j, nx, sz, ny, nx * sz,
                        max_value);
    }
    for (int64_t i = 0; i < total; ++i) tmp[i] = lut[tmp[i]];

    // channel-major -> scanline-interleaved
    uint16_t *op = out;
    for (int y = 0; y < ny; ++y) {
        for (int c = 0; c < num_channels; ++c) {
            int row = ch_nx[c] * ch_size_u16[c];
            memcpy(op, tmp.data() + ch_start[c] + (int64_t)y * row,
                   row * sizeof(uint16_t));
            op += row;
        }
    }
    return 0;
}

}  // extern "C"
