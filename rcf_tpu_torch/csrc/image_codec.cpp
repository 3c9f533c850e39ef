// Host image codec of the port: baseline JPEG decode and encode, PNG unfilter.
//
// The card machine has neither PIL nor cv2, so the data pipeline decodes
// its frames here. Built with the host compiler (c++ -O3 -shared -fPIC
// -std=c++17) into rcf_tpu_torch/build/ at first use and called through
// ctypes, which releases the GIL: the loader's threads decode in parallel.
//
// JPEG decode computes what libjpeg(-turbo) computes with its default
// decompression settings, as PIL uses them:
//   * the islow integer IDCT (jidctint.c: 13-bit constants, 2 pass-1 bits,
//     the post-IDCT range-limit table indexed modulo 1024);
//   * "fancy" triangle upsampling of subsampled components (jdsample.c:
//     h2v1, h1v2, h2v2; the plain replicating upsampler where a component
//     is at most 2 samples wide), with the rows above the first and below
//     the last real row replicated, as jdmainct.c's context pointers do;
//   * the fixed-point YCbCr -> RGB conversion (jdcolor.c, 16 fraction bits).
// Accepted: SOF0/SOF1 (sequential Huffman), 8-bit samples, 1 or 3
// components in one interleaved scan, sampling factors 1-2, restart
// intervals. Everything else (progressive, lossless, arithmetic coding,
// 12-bit, CMYK, several scans) is refused with a message.
//
// JPEG encode (RGB): baseline, the Annex-K quantization tables scaled as
// libjpeg's jpeg_quality_scaling, the Annex-K Huffman tables, 4:2:0
// (jcsample.c's h2v2 box with alternating bias), jccolor.c's fixed-point
// RGB -> YCbCr, a float DCT.
//
// PNG: the inflate (zlib) and chunk parsing stay in Python; the row
// unfilter (Sub, Up, Average, Paeth are serial along a row) runs here.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

constexpr int kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                             12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                             35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                             58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Error {
  std::string msg;
};

void set_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    std::snprintf(err, errlen, "%s", msg.c_str());
  }
}

// ---------------------------------------------------------------------------
// JPEG decode
// ---------------------------------------------------------------------------

struct Huffman {
  bool defined = false;
  uint8_t vals[256] = {};
  int maxcode[18] = {};
  int valptr[17] = {};
  int mincode[17] = {};
  uint16_t lookup[512] = {};  // 9-bit lookahead: (length << 8) | value, 0 = longer code
};

void build_huffman(Huffman& h, const uint8_t bits[16], const uint8_t* vals, int nvals) {
  std::memset(h.lookup, 0, sizeof(h.lookup));
  std::memcpy(h.vals, vals, nvals);
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    h.valptr[len] = k;
    h.mincode[len] = code;
    int n = bits[len - 1];
    for (int i = 0; i < n; ++i, ++k, ++code) {
      if (len <= 9) {
        int shift = 9 - len;
        for (int j = 0; j < (1 << shift); ++j) {
          h.lookup[(code << shift) | j] = static_cast<uint16_t>((len << 8) | vals[k]);
        }
      }
    }
    h.maxcode[len] = n ? code - 1 : -1;
    code <<= 1;
  }
  h.maxcode[17] = 0x7fffffff;
  h.defined = true;
}

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int bits = 0;
  bool marker = false;  // reached a marker: feed zeros from here

  void fill() {
    while (bits <= 56) {
      uint32_t byte = 0;
      if (!marker && p < end) {
        byte = *p;
        if (byte == 0xFF) {
          uint8_t next = (p + 1 < end) ? p[1] : 0xD9;
          if (next == 0x00) {
            p += 2;
          } else {
            marker = true;
            byte = 0;
          }
        } else {
          ++p;
        }
      }
      buf |= static_cast<uint64_t>(byte) << (56 - bits);
      bits += 8;
    }
  }
  int get(int n) {  // n in 1..16
    if (bits < n) fill();
    int v = static_cast<int>(buf >> (64 - n));
    buf <<= n;
    bits -= n;
    return v;
  }
  int decode(const Huffman& h) {
    if (bits < 16) fill();
    int look = static_cast<int>(buf >> (64 - 9));
    uint16_t e = h.lookup[look];
    if (e) {
      int len = e >> 8;
      buf <<= len;
      bits -= len;
      return e & 0xFF;
    }
    int code = static_cast<int>(buf >> (64 - 10));
    int len = 10;
    while (len <= 16 && code > h.maxcode[len]) {
      ++len;
      code = static_cast<int>(buf >> (64 - len));
    }
    if (len > 16) throw Error{"corrupt Huffman data"};
    buf <<= len;
    bits -= len;
    return h.vals[h.valptr[len] + code - h.mincode[len]];
  }
  void restart() {  // drop the segment's padding bits, skip its RSTn marker
    buf = 0;
    bits = 0;
    marker = false;
    while (p + 1 < end) {
      if (p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7) {
        p += 2;
        return;
      }
      if (p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF) return;  // another marker: stop here
      ++p;
    }
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int bw = 0, bh = 0;  // blocks per row / column in the plane
  int dw = 0, dh = 0;  // downsampled_width / downsampled_height
  std::vector<uint8_t> plane;
  int stride = 0;
  int pred = 0;
};

// libjpeg's post-IDCT range limit: index (x & 1023) for x centred on 0.
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      int x = i < 512 ? i : i - 1024;  // -512..511
      int y = x + 128;
      t[i] = static_cast<uint8_t>(y < 0 ? 0 : (y > 255 ? 255 : y));
    }
  }
};
const RangeLimit kRange;

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0_298631336 = 2446, F0_390180644 = 3196, F0_541196100 = 4433,
                  F0_765366865 = 6270, F0_899976223 = 7373, F1_175875602 = 9633,
                  F1_501321110 = 12299, F1_847759065 = 15137, F1_961570560 = 16069,
                  F2_053119869 = 16819, F2_562915447 = 20995, F3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// jpeg_idct_islow: coef in natural order, already dequantized.
void idct_islow(const int32_t* in, uint8_t* out, int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int32_t* ip = in + c;
    int32_t* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int32_t dc = ip[0] * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = ip[16], z3 = ip[48];
    int64_t z1 = (z2 + z3) * F0_541196100;
    int64_t tmp2 = z1 + z3 * -F1_847759065;
    int64_t tmp3 = z1 + z2 * F0_765366865;
    z2 = ip[0];
    z3 = ip[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56];
    tmp1 = ip[40];
    tmp2 = ip[24];
    tmp3 = ip[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175875602;
    tmp0 *= F0_298631336;
    tmp1 *= F2_053119869;
    tmp2 *= F3_072711026;
    tmp3 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 *= -F1_961570560;
    z4 *= -F0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits - kPass1Bits;
    wp[0] = static_cast<int32_t>(descale(tmp10 + tmp3, s));
    wp[56] = static_cast<int32_t>(descale(tmp10 - tmp3, s));
    wp[8] = static_cast<int32_t>(descale(tmp11 + tmp2, s));
    wp[48] = static_cast<int32_t>(descale(tmp11 - tmp2, s));
    wp[16] = static_cast<int32_t>(descale(tmp12 + tmp1, s));
    wp[40] = static_cast<int32_t>(descale(tmp12 - tmp1, s));
    wp[24] = static_cast<int32_t>(descale(tmp13 + tmp0, s));
    wp[32] = static_cast<int32_t>(descale(tmp13 - tmp0, s));
  }
  constexpr int s2 = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int32_t* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t dc = kRange.t[static_cast<int>(descale(wp[0], kPass1Bits + 3)) & 1023];
      for (int c = 0; c < 8; ++c) op[c] = dc;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F0_541196100;
    int64_t tmp2 = z1 + z3 * -F1_847759065;
    int64_t tmp3 = z1 + z2 * F0_765366865;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175875602;
    tmp0 *= F0_298631336;
    tmp1 *= F2_053119869;
    tmp2 *= F3_072711026;
    tmp3 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 *= -F1_961570560;
    z4 *= -F0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = kRange.t[static_cast<int>(descale(tmp10 + tmp3, s2)) & 1023];
    op[7] = kRange.t[static_cast<int>(descale(tmp10 - tmp3, s2)) & 1023];
    op[1] = kRange.t[static_cast<int>(descale(tmp11 + tmp2, s2)) & 1023];
    op[6] = kRange.t[static_cast<int>(descale(tmp11 - tmp2, s2)) & 1023];
    op[2] = kRange.t[static_cast<int>(descale(tmp12 + tmp1, s2)) & 1023];
    op[5] = kRange.t[static_cast<int>(descale(tmp12 - tmp1, s2)) & 1023];
    op[3] = kRange.t[static_cast<int>(descale(tmp13 + tmp0, s2)) & 1023];
    op[4] = kRange.t[static_cast<int>(descale(tmp13 - tmp0, s2)) & 1023];
  }
}

struct Jpeg {
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1;
  int restart_interval = 0;
  bool adobe = false, jfif = false;
  int adobe_transform = -1;
  uint16_t qt[4][64] = {};
  bool qt_defined[4] = {};
  Huffman dc[4], ac[4];
  Component comp[3];
  bool have_frame = false;
};

inline int u16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

// Parses markers up to (and, with decode, including) the one scan.
// Returns the position of the entropy-coded data after SOS, or nullptr for a
// header-only parse that stopped at SOF.
const uint8_t* parse_headers(Jpeg& j, const uint8_t* p, const uint8_t* end, bool header_only,
                             int scan_comp[3], int* scan_ncomp) {
  if (end - p < 4 || p[0] != 0xFF || p[1] != 0xD8) throw Error{"not a JPEG (no SOI marker)"};
  p += 2;
  while (true) {
    while (p < end && *p != 0xFF) ++p;  // tolerate garbage between segments
    while (p < end && *p == 0xFF) ++p;
    if (p >= end) throw Error{"truncated JPEG (no scan)"};
    int m = *p++;
    if (m == 0xD9) throw Error{"JPEG ends before its scan"};
    if (m >= 0xD0 && m <= 0xD7) continue;
    if (end - p < 2) throw Error{"truncated JPEG segment"};
    int len = u16(p);
    if (len < 2 || end - p < len) throw Error{"truncated JPEG segment"};
    const uint8_t* s = p + 2;
    int n = len - 2;
    if (m == 0xC0 || m == 0xC1) {
      if (n < 6) throw Error{"short SOF segment"};
      if (s[0] != 8) throw Error{"unsupported JPEG sample precision " + std::to_string(s[0]) + " bits (8 only)"};
      j.height = u16(s + 1);
      j.width = u16(s + 3);
      j.ncomp = s[5];
      if (j.ncomp != 1 && j.ncomp != 3)
        throw Error{"unsupported JPEG with " + std::to_string(j.ncomp) +
                    " components (1 or 3 only; CMYK is not supported)"};
      if (n < 6 + 3 * j.ncomp) throw Error{"short SOF segment"};
      if (j.width == 0 || j.height == 0) throw Error{"JPEG with a zero or undefined size"};
      for (int c = 0; c < j.ncomp; ++c) {
        Component& cp = j.comp[c];
        cp.id = s[6 + 3 * c];
        cp.h = s[7 + 3 * c] >> 4;
        cp.v = s[7 + 3 * c] & 15;
        cp.tq = s[8 + 3 * c];
        if (cp.h < 1 || cp.h > 2 || cp.v < 1 || cp.v > 2)
          throw Error{"unsupported JPEG sampling factors " + std::to_string(cp.h) + "x" +
                      std::to_string(cp.v) + " (1 or 2 only)"};
        if (cp.tq > 3) throw Error{"bad quantization table index"};
        j.hmax = std::max(j.hmax, cp.h);
        j.vmax = std::max(j.vmax, cp.v);
      }
      j.have_frame = true;
      if (header_only) return nullptr;
    } else if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) {
      throw Error{"progressive JPEG is not supported (baseline sequential only)"};
    } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
      throw Error{"lossless JPEG is not supported (baseline sequential only)"};
    } else if (m == 0xC9 || m == 0xCD || m == 0xCC) {
      throw Error{"arithmetic-coded JPEG is not supported (Huffman only)"};
    } else if (m == 0xC5) {
      throw Error{"hierarchical JPEG is not supported"};
    } else if (m == 0xDB) {
      int off = 0;
      while (off < n) {
        int pq = s[off] >> 4, tq = s[off] & 15;
        if (tq > 3 || pq > 1) throw Error{"bad DQT segment"};
        int need = 1 + 64 * (pq ? 2 : 1);
        if (off + need > n) throw Error{"short DQT segment"};
        for (int k = 0; k < 64; ++k) {
          j.qt[tq][kZigzag[k]] = pq ? u16(s + off + 1 + 2 * k) : s[off + 1 + k];
        }
        j.qt_defined[tq] = true;
        off += need;
      }
    } else if (m == 0xC4) {
      int off = 0;
      while (off < n) {
        if (off + 17 > n) throw Error{"short DHT segment"};
        int tc = s[off] >> 4, th = s[off] & 15;
        if (tc > 1 || th > 3) throw Error{"bad DHT segment"};
        uint8_t bits[16];
        int total = 0;
        for (int k = 0; k < 16; ++k) total += (bits[k] = s[off + 1 + k]);
        if (total > 256 || off + 17 + total > n) throw Error{"bad DHT segment"};
        build_huffman(tc ? j.ac[th] : j.dc[th], bits, s + off + 17, total);
        off += 17 + total;
      }
    } else if (m == 0xDD) {
      if (n < 2) throw Error{"short DRI segment"};
      j.restart_interval = u16(s);
    } else if (m == 0xE0) {
      if (n >= 5 && std::memcmp(s, "JFIF\0", 5) == 0) j.jfif = true;
    } else if (m == 0xEE) {
      if (n >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
        j.adobe = true;
        j.adobe_transform = s[11];
      }
    } else if (m == 0xDA) {
      if (!j.have_frame) throw Error{"JPEG scan before its frame header"};
      int ns = s[0];
      if (ns != j.ncomp)
        throw Error{"JPEG with several scans is not supported (one interleaved scan only)"};
      for (int k = 0; k < ns; ++k) {
        int cid = s[1 + 2 * k];
        int idx = -1;
        for (int c = 0; c < j.ncomp; ++c)
          if (j.comp[c].id == cid) idx = c;
        if (idx < 0) throw Error{"JPEG scan names an unknown component"};
        j.comp[idx].td = s[2 + 2 * k] >> 4;
        j.comp[idx].ta = s[2 + 2 * k] & 15;
        if (j.comp[idx].td > 3 || j.comp[idx].ta > 3) throw Error{"bad Huffman table index"};
        scan_comp[k] = idx;
      }
      *scan_ncomp = ns;
      int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], ahal = s[3 + 2 * ns];
      if (ss != 0 || se != 63 || ahal != 0) throw Error{"progressive JPEG scan is not supported"};
      return p + len;
    } else if (m >= 0xC0 && m <= 0xCF) {
      throw Error{"unsupported JPEG frame type"};
    }
    p += len;
  }
}

void decode_block(BitReader& br, Component& cp, const Huffman& dc, const Huffman& ac,
                  const uint16_t* q, uint8_t* out, int stride) {
  int32_t coef[64] = {};
  int s = br.decode(dc);
  int diff = 0;
  if (s) {
    if (s > 16) throw Error{"corrupt JPEG DC coefficient"};
    diff = extend(br.get(s), s);
  }
  cp.pred += diff;
  coef[0] = static_cast<int16_t>(cp.pred) * static_cast<int32_t>(q[0]);
  for (int k = 1; k < 64;) {
    int rs = br.decode(ac);
    int r = rs >> 4, sz = rs & 15;
    if (sz == 0) {
      if (r != 15) break;
      k += 16;
      continue;
    }
    k += r;
    if (k > 63) throw Error{"corrupt JPEG AC coefficients"};
    int z = kZigzag[k];
    coef[z] = static_cast<int16_t>(extend(br.get(sz), sz)) * static_cast<int32_t>(q[z]);
    ++k;
  }
  idct_islow(coef, out, stride);
}

// One component's upsampled row ``y`` (full-resolution), into ``out`` (width samples).
void upsample_row(const Jpeg& j, const Component& cp, int y, uint8_t* out) {
  const int rh = j.hmax / cp.h, rv = j.vmax / cp.v;
  const int W = j.width, dw = cp.dw;
  const bool fancy = dw > 2;
  auto row = [&](int r) { return cp.plane.data() + static_cast<size_t>(r) * cp.stride; };
  int inrow = y / rv;
  const uint8_t* p0 = row(inrow);
  if (rh == 1 && rv == 1) {
    std::memcpy(out, p0, W);
    return;
  }
  if (!fancy) {  // h2v1_upsample / h2v2_upsample / int_upsample: replicate
    for (int x = 0; x < W; ++x) out[x] = p0[x / rh];
    return;
  }
  if (rv == 1) {  // h2v1 fancy
    std::vector<uint8_t> tmp(2 * dw);
    uint8_t* o = tmp.data();
    const uint8_t* ip = p0;
    int v = *ip++;
    *o++ = static_cast<uint8_t>(v);
    *o++ = static_cast<uint8_t>((v * 3 + ip[0] + 2) >> 2);
    for (int c = dw - 2; c > 0; --c) {
      v = (*ip++) * 3;
      *o++ = static_cast<uint8_t>((v + ip[-2] + 1) >> 2);
      *o++ = static_cast<uint8_t>((v + ip[0] + 2) >> 2);
    }
    v = *ip;
    *o++ = static_cast<uint8_t>((v * 3 + ip[-1] + 1) >> 2);
    *o++ = static_cast<uint8_t>(v);
    std::memcpy(out, tmp.data(), W);
    return;
  }
  const int vpar = y % 2;
  int far = vpar == 0 ? std::max(inrow - 1, 0) : std::min(inrow + 1, cp.dh - 1);
  const uint8_t* p1 = row(far);
  if (rh == 1) {  // h1v2 fancy
    int bias = vpar == 0 ? 1 : 2;
    for (int x = 0; x < W; ++x) out[x] = static_cast<uint8_t>((p0[x] * 3 + p1[x] + bias) >> 2);
    return;
  }
  // h2v2 fancy
  std::vector<uint8_t> tmp(2 * dw);
  uint8_t* o = tmp.data();
  const uint8_t *i0 = p0, *i1 = p1;
  int thiscol = (*i0++) * 3 + (*i1++);
  int nextcol = (*i0++) * 3 + (*i1++);
  *o++ = static_cast<uint8_t>((thiscol * 4 + 8) >> 4);
  *o++ = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
  int lastcol = thiscol;
  thiscol = nextcol;
  for (int c = dw - 2; c > 0; --c) {
    nextcol = (*i0++) * 3 + (*i1++);
    *o++ = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
    *o++ = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
    lastcol = thiscol;
    thiscol = nextcol;
  }
  *o++ = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
  *o++ = static_cast<uint8_t>((thiscol * 4 + 7) >> 4);
  std::memcpy(out, tmp.data(), W);
}

struct YccTables {
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  YccTables() {
    constexpr int kBits = 16;
    constexpr int64_t half = int64_t(1) << (kBits - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * (1 << kBits) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> kBits);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> kBits);
      cr_g[i] = static_cast<int>(-fix(0.71414) * x);
      cb_g[i] = static_cast<int>(-fix(0.34414) * x + half);
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

void jpeg_decode(const uint8_t* data, size_t size, uint8_t* out, int out_channels) {
  Jpeg j;
  int scan_comp[3] = {0, 1, 2}, scan_n = 0;
  const uint8_t* end = data + size;
  const uint8_t* p = parse_headers(j, data, end, false, scan_comp, &scan_n);
  const int W = j.width, H = j.height;
  // One component in a scan is non-interleaved: its MCU is one block.
  const bool interleaved = scan_n > 1;
  const int mcux = (W + 8 * j.hmax - 1) / (8 * j.hmax);
  const int mcuy = (H + 8 * j.vmax - 1) / (8 * j.vmax);
  for (int c = 0; c < j.ncomp; ++c) {
    Component& cp = j.comp[c];
    if (!j.qt_defined[cp.tq]) throw Error{"JPEG uses an undefined quantization table"};
    if (!j.dc[cp.td].defined || !j.ac[cp.ta].defined)
      throw Error{"JPEG uses an undefined Huffman table"};
    cp.dw = (W * cp.h + j.hmax - 1) / j.hmax;
    cp.dh = (H * cp.v + j.vmax - 1) / j.vmax;
    if (interleaved) {
      cp.bw = mcux * cp.h;
      cp.bh = mcuy * cp.v;
    } else {
      cp.bw = (cp.dw + 7) / 8;
      cp.bh = (cp.dh + 7) / 8;
    }
    cp.stride = cp.bw * 8;
    cp.plane.assign(static_cast<size_t>(cp.stride) * cp.bh * 8, 0);
  }
  BitReader br{p, end};
  const int n_mcu = interleaved ? mcux * mcuy : j.comp[scan_comp[0]].bw * j.comp[scan_comp[0]].bh;
  const int mcu_w = interleaved ? mcux : j.comp[scan_comp[0]].bw;
  int todo = j.restart_interval;
  for (int m = 0; m < n_mcu; ++m) {
    if (j.restart_interval) {
      if (todo == 0) {
        br.restart();
        for (int c = 0; c < j.ncomp; ++c) j.comp[c].pred = 0;
        todo = j.restart_interval;
      }
      --todo;
    }
    const int mx = m % mcu_w, my = m / mcu_w;
    for (int k = 0; k < scan_n; ++k) {
      Component& cp = j.comp[scan_comp[k]];
      const int nh = interleaved ? cp.h : 1, nv = interleaved ? cp.v : 1;
      for (int by = 0; by < nv; ++by) {
        for (int bx = 0; bx < nh; ++bx) {
          const int row = (my * nv + by) * 8, col = (mx * nh + bx) * 8;
          decode_block(br, cp, j.dc[cp.td], j.ac[cp.ta], j.qt[cp.tq],
                       cp.plane.data() + static_cast<size_t>(row) * cp.stride + col, cp.stride);
        }
      }
    }
  }
  if (j.ncomp == 1) {
    const Component& cp = j.comp[0];
    for (int y = 0; y < H; ++y) {
      const uint8_t* src = cp.plane.data() + static_cast<size_t>(y) * cp.stride;
      uint8_t* dst = out + static_cast<size_t>(y) * W * out_channels;
      if (out_channels == 1) {
        std::memcpy(dst, src, W);
      } else {
        for (int x = 0; x < W; ++x) dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = src[x];
      }
    }
    return;
  }
  // libjpeg's default colour space for three components.
  bool rgb = false;
  if (j.adobe) {
    rgb = j.adobe_transform == 0;
  } else if (!j.jfif && j.comp[0].id == 'R' && j.comp[1].id == 'G' && j.comp[2].id == 'B') {
    rgb = true;
  }
  std::vector<uint8_t> r0(W), r1(W), r2(W);
  for (int y = 0; y < H; ++y) {
    upsample_row(j, j.comp[0], y, r0.data());
    upsample_row(j, j.comp[1], y, r1.data());
    upsample_row(j, j.comp[2], y, r2.data());
    uint8_t* dst = out + static_cast<size_t>(y) * W * 3;
    if (rgb) {
      for (int x = 0; x < W; ++x) {
        dst[3 * x] = r0[x];
        dst[3 * x + 1] = r1[x];
        dst[3 * x + 2] = r2[x];
      }
      continue;
    }
    for (int x = 0; x < W; ++x) {
      int yy = r0[x], cb = r1[x], cr = r2[x];
      dst[3 * x] = clamp255(yy + kYcc.cr_r[cr]);
      dst[3 * x + 1] = clamp255(yy + ((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
      dst[3 * x + 2] = clamp255(yy + kYcc.cb_b[cb]);
    }
  }
}

// ---------------------------------------------------------------------------
// JPEG encode
// ---------------------------------------------------------------------------

constexpr uint8_t kStdLumaQ[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,
                                   58, 60, 55, 14, 13, 16, 24,  40,  57,  69,  56, 14, 17,
                                   22, 29, 51, 87, 80, 62, 18,  22,  37,  56,  68, 109, 103,
                                   77, 24, 35, 55, 64, 81, 104, 113, 92,  49,  64, 78, 87,
                                   103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
constexpr uint8_t kStdChromaQ[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99,
                                     99, 99, 99, 24, 26, 56, 99, 99, 99, 99, 99, 47, 66,
                                     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                                     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                                     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

constexpr uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
constexpr uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
constexpr uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
constexpr uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
constexpr uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
constexpr uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct Code {
  uint16_t code[256] = {};
  uint8_t len[256] = {};
};

Code make_codes(const uint8_t bits[16], const uint8_t* vals) {
  Code c;
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l - 1]; ++i, ++k, ++code) {
      c.code[vals[k]] = static_cast<uint16_t>(code);
      c.len[vals[k]] = static_cast<uint8_t>(l);
    }
    code <<= 1;
  }
  return c;
}

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int n = 0;
  void put(uint32_t v, int len) {
    for (int i = len - 1; i >= 0; --i) {
      acc = (acc << 1) | ((v >> i) & 1);
      if (++n == 8) {
        out.push_back(static_cast<uint8_t>(acc));
        if (acc == 0xFF) out.push_back(0);
        acc = 0;
        n = 0;
      }
    }
  }
  void flush() {
    while (n) put(1, 1);
  }
};

void scale_quant(const uint8_t* std_table, int quality, uint8_t* out_natural) {
  quality = quality < 1 ? 1 : (quality > 100 ? 100 : quality);
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = (static_cast<long>(std_table[i]) * scale + 50) / 100;
    out_natural[i] = static_cast<uint8_t>(t < 1 ? 1 : (t > 255 ? 255 : t));
  }
}

struct DctMatrix {
  double c[8][8];
  DctMatrix() {
    for (int u = 0; u < 8; ++u)
      for (int x = 0; x < 8; ++x)
        c[u][x] = (u == 0 ? std::sqrt(0.125) : 0.5) * std::cos((2 * x + 1) * u * M_PI / 16.0);
  }
};
const DctMatrix kDct;

void encode_block(const double* px, const uint8_t* q, int& pred, const Code& dc, const Code& ac,
                  BitWriter& bw) {
  double tmp[64], coef[64];
  for (int u = 0; u < 8; ++u)
    for (int x = 0; x < 8; ++x) {
      double s = 0;
      for (int y = 0; y < 8; ++y) s += kDct.c[u][y] * px[y * 8 + x];
      tmp[u * 8 + x] = s;
    }
  for (int u = 0; u < 8; ++u)
    for (int v = 0; v < 8; ++v) {
      double s = 0;
      for (int x = 0; x < 8; ++x) s += tmp[u * 8 + x] * kDct.c[v][x];
      coef[u * 8 + v] = s;
    }
  int qc[64];
  for (int k = 0; k < 64; ++k) {
    int z = kZigzag[k];
    qc[k] = static_cast<int>(std::lround(coef[z] / q[z]));
  }
  auto emit = [&](const Code& t, int sym) {
    if (!t.len[sym]) throw Error{"JPEG encoder: symbol without a code"};
    bw.put(t.code[sym], t.len[sym]);
  };
  auto magnitude = [](int v) {
    int a = v < 0 ? -v : v, s = 0;
    while (a) {
      ++s;
      a >>= 1;
    }
    return s;
  };
  int diff = qc[0] - pred;
  pred = qc[0];
  int s = magnitude(diff);
  emit(dc, s);
  if (s) bw.put(static_cast<uint32_t>(diff < 0 ? diff + (1 << s) - 1 : diff), s);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    if (qc[k] == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      emit(ac, 0xF0);
      run -= 16;
    }
    int v = qc[k];
    int sz = magnitude(v);
    if (sz > 10) throw Error{"JPEG encoder: coefficient out of the baseline range"};
    emit(ac, (run << 4) | sz);
    bw.put(static_cast<uint32_t>(v < 0 ? v + (1 << sz) - 1 : v), sz);
    run = 0;
  }
  if (run) emit(ac, 0x00);
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(static_cast<uint8_t>(v >> 8));
  o.push_back(static_cast<uint8_t>(v & 0xFF));
}

void put_dht(std::vector<uint8_t>& o, int tc, int th, const uint8_t bits[16], const uint8_t* vals) {
  int n = 0;
  for (int i = 0; i < 16; ++i) n += bits[i];
  o.push_back(0xFF);
  o.push_back(0xC4);
  put16(o, 2 + 17 + n);
  o.push_back(static_cast<uint8_t>((tc << 4) | th));
  for (int i = 0; i < 16; ++i) o.push_back(bits[i]);
  for (int i = 0; i < n; ++i) o.push_back(vals[i]);
}

std::vector<uint8_t> jpeg_encode(const uint8_t* img, int W, int H, int quality) {
  constexpr int ncomp = 3, hs = 2, mcu = 16;
  uint8_t ql[64], qcr[64];
  scale_quant(kStdLumaQ, quality, ql);
  scale_quant(kStdChromaQ, quality, qcr);
  // Planes: Y at full size padded to the MCU grid by edge replication;
  // Cb, Cr downsampled 2x2 (jcsample.c h2v2: box, bias 1, 2, 1, 2 ...).
  const int PW = (W + mcu - 1) / mcu * mcu, PH = (H + mcu - 1) / mcu * mcu;
  std::vector<uint8_t> Y(static_cast<size_t>(PW) * PH), cbf(Y.size()), crf(Y.size());
  constexpr int kBits = 16;
  auto fix = [](double x) { return static_cast<int64_t>(x * (1 << kBits) + 0.5); };
  const int64_t half = int64_t(1) << (kBits - 1), off = int64_t(128) << kBits;
  for (int y = 0; y < PH; ++y) {
    const int sy = y < H ? y : H - 1;
    for (int x = 0; x < PW; ++x) {
      const int sx = x < W ? x : W - 1;
      const uint8_t* p = img + (static_cast<size_t>(sy) * W + sx) * 3;
      const size_t i = static_cast<size_t>(y) * PW + x;
      const int64_t r = p[0], g = p[1], b = p[2];
      Y[i] = static_cast<uint8_t>((fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + half) >> kBits);
      cbf[i] = static_cast<uint8_t>((-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + off + half - 1) >> kBits);
      crf[i] = static_cast<uint8_t>((fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + off + half - 1) >> kBits);
    }
  }
  const int CW = PW / hs, CH = PH / hs;
  std::vector<uint8_t> Cb(static_cast<size_t>(CW) * CH), Cr(Cb.size());
  for (int y = 0; y < CH; ++y) {
    int bias = 1;
    for (int x = 0; x < CW; ++x) {
      const size_t a = static_cast<size_t>(2 * y) * PW + 2 * x, b = a + PW;
      Cb[static_cast<size_t>(y) * CW + x] =
          static_cast<uint8_t>((cbf[a] + cbf[a + 1] + cbf[b] + cbf[b + 1] + bias) >> 2);
      Cr[static_cast<size_t>(y) * CW + x] =
          static_cast<uint8_t>((crf[a] + crf[a + 1] + crf[b] + crf[b + 1] + bias) >> 2);
      bias ^= 3;
    }
  }
  std::vector<uint8_t> o;
  o.reserve(static_cast<size_t>(W) * H / 2 + 1024);
  o.insert(o.end(), {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0});
  for (int t = 0; t < 2; ++t) {
    const uint8_t* q = t ? qcr : ql;
    o.push_back(0xFF);
    o.push_back(0xDB);
    put16(o, 67);
    o.push_back(static_cast<uint8_t>(t));
    for (int k = 0; k < 64; ++k) o.push_back(q[kZigzag[k]]);
  }
  o.push_back(0xFF);
  o.push_back(0xC0);
  put16(o, 8 + 3 * ncomp);
  o.push_back(8);
  put16(o, H);
  put16(o, W);
  o.push_back(static_cast<uint8_t>(ncomp));
  for (int c = 0; c < ncomp; ++c) {
    o.push_back(static_cast<uint8_t>(c + 1));
    o.push_back(static_cast<uint8_t>(c == 0 ? (hs << 4) | hs : 0x11));
    o.push_back(static_cast<uint8_t>(c == 0 ? 0 : 1));
  }
  put_dht(o, 0, 0, kDcLumaBits, kDcVals);
  put_dht(o, 1, 0, kAcLumaBits, kAcLumaVals);
  put_dht(o, 0, 1, kDcChromaBits, kDcVals);
  put_dht(o, 1, 1, kAcChromaBits, kAcChromaVals);
  o.push_back(0xFF);
  o.push_back(0xDA);
  put16(o, 6 + 2 * ncomp);
  o.push_back(static_cast<uint8_t>(ncomp));
  for (int c = 0; c < ncomp; ++c) {
    o.push_back(static_cast<uint8_t>(c + 1));
    o.push_back(static_cast<uint8_t>(c == 0 ? 0x00 : 0x11));
  }
  o.push_back(0);
  o.push_back(63);
  o.push_back(0);
  static const Code dcl = make_codes(kDcLumaBits, kDcVals), acl = make_codes(kAcLumaBits, kAcLumaVals),
                    dcc = make_codes(kDcChromaBits, kDcVals), acc = make_codes(kAcChromaBits, kAcChromaVals);
  BitWriter bw{o};
  int py = 0, pcb = 0, pcr = 0;
  double px[64];
  auto load = [&](const std::vector<uint8_t>& plane, int stride, int x0, int y0) {
    for (int r = 0; r < 8; ++r)
      for (int c = 0; c < 8; ++c)
        px[r * 8 + c] = static_cast<double>(plane[static_cast<size_t>(y0 + r) * stride + x0 + c]) - 128.0;
  };
  for (int my = 0; my < PH / mcu; ++my) {
    for (int mx = 0; mx < PW / mcu; ++mx) {
      for (int by = 0; by < hs; ++by)
        for (int bx = 0; bx < hs; ++bx) {
          load(Y, PW, mx * mcu + bx * 8, my * mcu + by * 8);
          encode_block(px, ql, py, dcl, acl, bw);
        }
      load(Cb, CW, mx * 8, my * 8);
      encode_block(px, qcr, pcb, dcc, acc, bw);
      load(Cr, CW, mx * 8, my * 8);
      encode_block(px, qcr, pcr, dcc, acc, bw);
    }
  }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  return o;
}

// ---------------------------------------------------------------------------
// PNG unfilter
// ---------------------------------------------------------------------------

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

void png_unfilter(const uint8_t* in, uint8_t* out, int height, int row_bytes, int bpp) {
  std::vector<uint8_t> zero(row_bytes, 0);
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = in + static_cast<size_t>(y) * (row_bytes + 1);
    const int ft = src[0];
    ++src;
    uint8_t* dst = out + static_cast<size_t>(y) * row_bytes;
    const uint8_t* up = y ? dst - row_bytes : zero.data();
    switch (ft) {
      case 0:
        std::memcpy(dst, src, row_bytes);
        break;
      case 1:
        for (int i = 0; i < row_bytes; ++i) dst[i] = static_cast<uint8_t>(src[i] + (i >= bpp ? dst[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < row_bytes; ++i) dst[i] = static_cast<uint8_t>(src[i] + up[i]);
        break;
      case 3:
        for (int i = 0; i < row_bytes; ++i)
          dst[i] = static_cast<uint8_t>(src[i] + (((i >= bpp ? dst[i - bpp] : 0) + up[i]) >> 1));
        break;
      case 4:
        for (int i = 0; i < row_bytes; ++i) {
          int a = i >= bpp ? dst[i - bpp] : 0, c = i >= bpp ? up[i - bpp] : 0;
          dst[i] = static_cast<uint8_t>(src[i] + paeth(a, up[i], c));
        }
        break;
      default:
        throw Error{"bad PNG filter type " + std::to_string(ft) + " in row " + std::to_string(y)};
    }
  }
}

}  // namespace

extern "C" {

// Frame header of a JPEG: its size and component count. 0 on success.
int rcf_jpeg_info(const uint8_t* data, size_t size, int* width, int* height, int* comps, char* err,
                  int errlen) {
  try {
    Jpeg j;
    int sc[3], sn = 0;
    parse_headers(j, data, data + size, true, sc, &sn);
    if (!j.have_frame) throw Error{"no frame header"};
    *width = j.width;
    *height = j.height;
    *comps = j.ncomp;
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return 1;
  }
}

// Decodes into out [height, width, channels] (channels 3: RGB, gray
// replicated; channels 1: a one-component JPEG only). 0 on success.
int rcf_jpeg_decode(const uint8_t* data, size_t size, uint8_t* out, int channels, char* err,
                    int errlen) {
  try {
    jpeg_decode(data, size, out, channels);
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return 1;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return 1;
  }
}

// Encodes img [height, width, 3] RGB as baseline JPEG. The encoded size goes
// to *out_size; the bytes to out when it holds them (capacity), else the
// call only reports the size (returns 2).
int rcf_jpeg_encode(const uint8_t* img, int width, int height, int quality, uint8_t* out,
                    size_t capacity, size_t* out_size, char* err, int errlen) {
  try {
    if (width < 1 || height < 1 || width > 65535 || height > 65535) throw Error{"bad JPEG size"};
    std::vector<uint8_t> o = jpeg_encode(img, width, height, quality);
    *out_size = o.size();
    if (o.size() > capacity) return 2;
    std::memcpy(out, o.data(), o.size());
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return 1;
  }
}

// PNG rows [height, 1 + row_bytes] (filter byte first) -> [height, row_bytes].
int rcf_png_unfilter(const uint8_t* in, uint8_t* out, int height, int row_bytes, int bpp, char* err,
                     int errlen) {
  try {
    png_unfilter(in, out, height, row_bytes, bpp);
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return 1;
  }
}

}  // extern "C"
