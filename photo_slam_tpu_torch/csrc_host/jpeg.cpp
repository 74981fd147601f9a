// Baseline JPEG decoding on the host, for machines without OpenCV or PIL.
//
// Reads what the datasets ship (Replica's frame*.jpg, COLMAP image sets):
// 8-bit Huffman-coded sequential JPEG (SOF0, SOF1) with 1 or 3 components,
// chroma at 4:4:4, 4:2:2 (h2v1) or 4:2:0 (h2v2), restart intervals, and
// APPn / COM segments, which it skips. It refuses, naming the kind:
// progressive, arithmetic-coded, lossless, hierarchical or 12-bit frames,
// other sampling factors, 4 components, RGB-coded 3-component files and an
// EXIF orientation other than 1 (cv2.imread would rotate the image).
//
// The arithmetic is libjpeg-turbo's defaults, so the pixels equal
// cv2.imread's (which decodes with libjpeg-turbo): the ISLOW integer IDCT
// (jidctint.c, with its range-limit table), "fancy" triangle upsampling for
// h2v1 and h2v2 chroma (jdsample.c; edge rows replicated as jdmainct.c
// does), and jdcolor.c's fixed-point YCbCr -> RGB tables.
//
// Plain C interface (io/jpeg.py loads it over ctypes):
//   jpeg_info(data, n, &h, &w, &c, err, cap)    -> 0, or 1 with err set
//   jpeg_decode(data, n, gray, out, err, cap)   -> 0, or 1 with err set
// `out` holds h x w x 3 bytes of RGB, or h x w bytes of gray when c is 1 or
// `gray` is set (the luma plane, as libjpeg's JCS_GRAYSCALE output).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// Zigzag index -> natural (row-major) index; 16 extra entries catch a
// corrupt run length as libjpeg's jpeg_natural_order does.
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  uint8_t vals[256] = {};
  int mincode[17] = {}, maxcode[18] = {}, valptr[17] = {};
  uint8_t look_len[512] = {}, look_val[512] = {};  // 9-bit lookahead

  void build(const uint8_t* counts, const uint8_t* symbols, int total) {
    std::memcpy(vals, symbols, total);
    int code = 0, k = 0;
    std::memset(look_len, 0, sizeof(look_len));
    for (int l = 1; l <= 16; ++l) {
      // Checked before the fill: an over-full length would index the
      // lookahead past its 512 entries.
      if (code + counts[l - 1] > (1 << l))
        throw Error("corrupt JPEG: bad Huffman table");
      valptr[l] = k;
      mincode[l] = code;
      for (int i = 0; i < counts[l - 1]; ++i, ++k, ++code) {
        if (l <= 9) {
          const int shift = 9 - l;
          for (int j = 0; j < (1 << shift); ++j) {
            look_len[(code << shift) | j] = (uint8_t)l;
            look_val[(code << shift) | j] = vals[k];
          }
        }
      }
      maxcode[l] = counts[l - 1] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;        // Huffman tables of the current scan
  int pred = 0;              // DC prediction
  int width = 0, height = 0; // downsampled size (libjpeg's downsampled_*)
  int stride = 0, rows = 0;  // the plane, padded to whole MCUs
  std::vector<uint8_t> plane;
};

// The entropy-coded segment's bit reader: 0xFF00 stuffing, markers stop
// it. Past a marker or the end it feeds zero bits and counts them, so a
// decode that consumes any of them is known to be truncated.
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int cnt = 0;
  int fake = 0;  // zero bits fed past the data, still in buf or consumed
  bool stopped = false;

  void fill() {
    while (cnt <= 56) {
      uint32_t byte = 0;
      if (!stopped && p < end) {
        if (*p == 0xFF) {
          if (p + 1 < end && p[1] == 0x00) {
            byte = 0xFF;
            p += 2;
          } else if (p + 1 < end && p[1] == 0xFF) {
            ++p;  // a fill byte before a marker
            continue;
          } else {
            stopped = true;  // a marker (or the end): left for the caller
            fake += 8;
          }
        } else {
          byte = *p++;
        }
      } else {
        fake += 8;
      }
      buf |= (uint64_t)byte << (56 - cnt);
      cnt += 8;
    }
  }
  void consume(int n) {
    buf <<= n;
    cnt -= n;
  }
  bool overrun() const { return fake > cnt; }
  void reset() {
    buf = 0;
    cnt = 0;
    fake = 0;
    stopped = false;
  }

  int decode(const Huffman& h) {
    if (cnt < 16) fill();
    const int look = (int)(buf >> 55);
    if (h.look_len[look]) {
      const int l = h.look_len[look];
      consume(l);
      return h.look_val[look];
    }
    for (int l = 10; l <= 16; ++l) {
      const int code = (int)(buf >> (64 - l));
      if (code <= h.maxcode[l]) {
        consume(l);
        return h.vals[h.valptr[l] + code - h.mincode[l]];
      }
    }
    throw Error("corrupt JPEG: bad Huffman code");
  }

  int receive_extend(int s) {
    if (s == 0) return 0;
    if (cnt < s) fill();
    int v = (int)(buf >> (64 - s));
    consume(s);
    if (v < (1 << (s - 1))) v -= (1 << s) - 1;
    return v;
  }
};

// ---------------------------------------------------------------------------
// jidctint.c's jpeg_idct_islow
// ---------------------------------------------------------------------------

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t kFix0298631336 = 2446;
constexpr int64_t kFix0390180644 = 3196;
constexpr int64_t kFix0541196100 = 4433;
constexpr int64_t kFix0765366865 = 6270;
constexpr int64_t kFix0899976223 = 7373;
constexpr int64_t kFix1175875602 = 9633;
constexpr int64_t kFix1501321110 = 12299;
constexpr int64_t kFix1847759065 = 15137;
constexpr int64_t kFix1961570560 = 16069;
constexpr int64_t kFix2053119869 = 16819;
constexpr int64_t kFix2562915447 = 20995;
constexpr int64_t kFix3072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + ((int64_t)1 << (n - 1))) >> n;
}

// jdmaster.c's post-IDCT range limit: index (x & 1023) of the value x
// before the +128 shift.
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      if (i < 128) t[i] = (uint8_t)(i + 128);
      else if (i < 512) t[i] = 255;
      else if (i < 896) t[i] = 0;
      else t[i] = (uint8_t)(i - 896);
    }
  }
};
const RangeLimit kRange;

// The odd and even parts shared by both passes: in[0..7] -> out[0..7].
inline void idct_1d(const int64_t in[8], int64_t out[8]) {
  int64_t z2 = in[2], z3 = in[6];
  int64_t z1 = (z2 + z3) * kFix0541196100;
  int64_t tmp2 = z1 + z3 * -kFix1847759065;
  int64_t tmp3 = z1 + z2 * kFix0765366865;
  z2 = in[0];
  z3 = in[4];
  int64_t tmp0 = (z2 + z3) << kConstBits;
  int64_t tmp1 = (z2 - z3) << kConstBits;
  const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  tmp0 = in[7];
  tmp1 = in[5];
  tmp2 = in[3];
  tmp3 = in[1];
  z1 = tmp0 + tmp3;
  z2 = tmp1 + tmp2;
  z3 = tmp0 + tmp2;
  int64_t z4 = tmp1 + tmp3;
  const int64_t z5 = (z3 + z4) * kFix1175875602;
  tmp0 *= kFix0298631336;
  tmp1 *= kFix2053119869;
  tmp2 *= kFix3072711026;
  tmp3 *= kFix1501321110;
  z1 *= -kFix0899976223;
  z2 *= -kFix2562915447;
  z3 *= -kFix1961570560;
  z4 *= -kFix0390180644;
  z3 += z5;
  z4 += z5;
  tmp0 += z1 + z3;
  tmp1 += z2 + z4;
  tmp2 += z2 + z3;
  tmp3 += z1 + z4;
  out[0] = tmp10 + tmp3;
  out[7] = tmp10 - tmp3;
  out[1] = tmp11 + tmp2;
  out[6] = tmp11 - tmp2;
  out[2] = tmp12 + tmp1;
  out[5] = tmp12 - tmp1;
  out[3] = tmp13 + tmp0;
  out[4] = tmp13 - tmp0;
}

// coef: dequantized coefficients in natural order (int16 as JCOEF times
// the quantizer); writes 8 x 8 samples at dst with the given stride.
void idct_islow(const int32_t coef[64], uint8_t* dst, int stride) {
  int64_t ws[64];
  for (int col = 0; col < 8; ++col) {
    int64_t in[8], out[8];
    for (int r = 0; r < 8; ++r) in[r] = coef[r * 8 + col];
    idct_1d(in, out);
    for (int r = 0; r < 8; ++r)
      ws[r * 8 + col] = (int)descale(out[r], kConstBits - kPass1Bits);
  }
  for (int row = 0; row < 8; ++row) {
    int64_t in[8], out[8];
    for (int c = 0; c < 8; ++c) in[c] = ws[row * 8 + c];
    idct_1d(in, out);
    uint8_t* o = dst + (size_t)row * stride;
    for (int c = 0; c < 8; ++c)
      o[c] = kRange.t[(int)descale(out[c], kConstBits + kPass1Bits + 3)
                      & 1023];
  }
}

// ---------------------------------------------------------------------------
// The decoder
// ---------------------------------------------------------------------------

struct Decoder {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart = 0;
  bool frame = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  uint16_t quant[4][64] = {};
  bool quant_defined[4] = {};
  Huffman dc[4], ac[4];
  Component comp[3];

  Decoder(const uint8_t* d, size_t len) : data(d), n(len) {}

  int u8() {
    if (pos >= n) throw Error("truncated JPEG: ends inside a header");
    return data[pos++];
  }
  int u16() {
    const int hi = u8();
    return (hi << 8) | u8();
  }

  // The next marker's code, skipping fill bytes.
  int marker() {
    int b = u8();
    if (b != 0xFF) throw Error("corrupt JPEG: expected a marker");
    while (b == 0xFF) b = u8();
    return b;
  }

  void segment_end(size_t start, int len) {
    if (start + len > n) throw Error("truncated JPEG: ends inside a segment");
    pos = start + len;
  }

  void read_exif(size_t at, int len) {
    // APP1 "Exif\0\0", a TIFF header, IFD0: tag 0x0112 is the orientation.
    const uint8_t* p = data + at;
    if (len < 6 + 8 || std::memcmp(p, "Exif\0\0", 6) != 0) return;
    const uint8_t* t = p + 6;
    const int tlen = len - 6;
    const bool le = t[0] == 'I';
    if (!(le ? (t[0] == 'I' && t[1] == 'I') : (t[0] == 'M' && t[1] == 'M')))
      return;
    auto r16 = [&](int o) -> int {
      if (o < 0 || o + 2 > tlen) throw Error("corrupt JPEG: bad EXIF");
      return le ? (t[o] | (t[o + 1] << 8)) : ((t[o] << 8) | t[o + 1]);
    };
    auto r32 = [&](int o) -> long {
      return le ? ((long)r16(o) | ((long)r16(o + 2) << 16))
                : (((long)r16(o) << 16) | (long)r16(o + 2));
    };
    const long ifd = r32(4);
    if (ifd < 8 || ifd + 2 > tlen) return;
    const int count = r16((int)ifd);
    for (int i = 0; i < count; ++i) {
      const int e = (int)ifd + 2 + 12 * i;
      if (e + 12 > tlen) break;
      if (r16(e) == 0x0112) {
        const int orientation = r16(e + 8);
        if (orientation != 1)
          throw Error("EXIF orientation " + std::to_string(orientation) +
                      " is not supported (only 1, the stored orientation)");
      }
    }
  }

  void read_dqt(int len) {
    const size_t end = pos + len - 2;
    while (pos < end) {
      const int pq_tq = u8();
      const int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) throw Error("corrupt JPEG: bad quantization table");
      for (int k = 0; k < 64; ++k)
        quant[tq][kNatural[k]] = (uint16_t)(pq ? u16() : u8());
      quant_defined[tq] = true;
    }
  }

  void read_dht(int len) {
    const size_t end = pos + len - 2;
    while (pos < end) {
      const int tc_th = u8();
      const int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) throw Error("corrupt JPEG: bad Huffman table");
      uint8_t counts[16], symbols[256];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = (uint8_t)u8();
      if (total > 256) throw Error("corrupt JPEG: bad Huffman table");
      for (int i = 0; i < total; ++i) symbols[i] = (uint8_t)u8();
      (tc ? ac[th] : dc[th]).build(counts, symbols, total);
    }
  }

  void read_sof(int code) {
    if (frame) throw Error("corrupt JPEG: two frames");
    const int precision = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (precision != 8)
      throw Error(std::to_string(precision) +
                  "-bit JPEG is not supported (8-bit only)");
    if (height == 0)
      throw Error("JPEG with the height in a DNL marker is not supported");
    if (width == 0) throw Error("corrupt JPEG: zero width");
    if (ncomp != 1 && ncomp != 3)
      throw Error("JPEG with " + std::to_string(ncomp) +
                  " components is not supported (1 or 3)");
    (void)code;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = u8();
      const int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        throw Error("corrupt JPEG: bad component");
    }
    if (ncomp == 1) {
      comp[0].h = comp[0].v = 1;  // one component: one block an MCU
    } else {
      const bool chroma_one = comp[1].h == 1 && comp[1].v == 1 &&
                              comp[2].h == 1 && comp[2].v == 1;
      const int h = comp[0].h, v = comp[0].v;
      if (!chroma_one || !((h == 1 && v == 1) || (h == 2 && v == 1) ||
                           (h == 2 && v == 2))) {
        char buf[96];
        std::snprintf(buf, sizeof(buf),
                      "JPEG sampling factors %dx%d,%dx%d,%dx%d are not "
                      "supported (4:4:4, 4:2:2, 4:2:0 only)",
                      comp[0].h, comp[0].v, comp[1].h, comp[1].v, comp[2].h,
                      comp[2].v);
        throw Error(buf);
      }
    }
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; ++i) {
      hmax = std::max(hmax, comp[i].h);
      vmax = std::max(vmax, comp[i].v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.width = (width * c.h + hmax - 1) / hmax;
      c.height = (height * c.v + vmax - 1) / vmax;
      c.stride = mcux * c.h * 8;
      c.rows = mcuy * c.v * 8;
    }
    frame = true;
  }

  // Read the headers up to the first scan (pos then at the SOS segment's
  // length), or up to the frame header when stop_at_frame (jpeg_info).
  void headers(bool stop_at_frame) {
    pos = 0;
    if (n < 2 || data[0] != 0xFF || data[1] != 0xD8)
      throw Error("not a JPEG file (no SOI marker)");
    pos = 2;
    for (;;) {
      const int m = marker();
      if (m == 0xD9) throw Error("corrupt JPEG: no scan before EOI");
      const size_t start = pos;
      const int len = u16();
      if (len < 2) throw Error("corrupt JPEG: bad segment length");
      if (start + len > n) throw Error("truncated JPEG: ends inside a segment");
      if (m == 0xC0 || m == 0xC1) {
        read_sof(m);
        if (stop_at_frame) return;
      } else if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) {
        throw Error("progressive JPEG is not supported");
      } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
        throw Error("lossless JPEG is not supported");
      } else if (m == 0xC5) {
        throw Error("hierarchical JPEG is not supported");
      } else if (m == 0xC9) {
        throw Error("arithmetic-coded JPEG is not supported");
      } else if (m == 0xCC) {
        throw Error("arithmetic-coded JPEG is not supported");
      } else if (m == 0xC4) {
        read_dht(len);
      } else if (m == 0xDB) {
        read_dqt(len);
      } else if (m == 0xDD) {
        restart = u16();
      } else if (m == 0xDA) {
        pos = start;  // the scan header is read by decode()
        return;
      } else if (m == 0xE0) {
        if (len >= 7 && std::memcmp(data + start + 2, "JFIF\0", 5) == 0)
          jfif = true;
      } else if (m == 0xE1) {
        read_exif(start + 2, len - 2);
      } else if (m == 0xEE) {
        if (len >= 14 && std::memcmp(data + start + 2, "Adobe", 5) == 0) {
          adobe = true;
          adobe_transform = data[start + 13];
        }
      }
      // APPn, COM and anything else: skipped.
      segment_end(start, len);
    }
  }

  bool rgb_coded() const {
    if (ncomp != 3) return false;
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
  }

  void decode_block(Bits& b, Component& c, uint8_t* dst) {
    const Huffman& dch = dc[c.td];
    const Huffman& ach = ac[c.ta];
    int32_t coef[64] = {};
    const uint16_t* q = quant[c.tq];
    const int t = b.decode(dch);
    if (t > 11) throw Error("corrupt JPEG: bad DC difference");
    c.pred += b.receive_extend(t);
    coef[0] = (int16_t)c.pred * (int32_t)q[0];
    for (int k = 1; k < 64;) {
      const int rs = b.decode(ach);
      const int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        const int z = kNatural[k];
        coef[z] = (int16_t)b.receive_extend(s) * (int32_t)q[z];
        ++k;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
    idct_islow(coef, dst, c.stride);
  }

  // One scan: pos at the SOS segment's length. Returns after its
  // entropy-coded data, at the next marker.
  void scan() {
    const size_t start = pos;
    const int len = u16();
    const int ns = u8();
    if (ns < 1 || ns > ncomp) throw Error("corrupt JPEG: bad scan");
    Component* sc[3];
    for (int i = 0; i < ns; ++i) {
      const int id = u8(), tables = u8();
      Component* found = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == id) found = &comp[j];
      if (!found) throw Error("corrupt JPEG: scan names no component");
      found->td = tables >> 4;
      found->ta = tables & 15;
      if (found->td > 3 || found->ta > 3 || !dc[found->td].defined ||
          !ac[found->ta].defined)
        throw Error("corrupt JPEG: scan uses an undefined Huffman table");
      if (!quant_defined[found->tq])
        throw Error("corrupt JPEG: undefined quantization table");
      sc[i] = found;
    }
    const int ss = u8(), se = u8(), ahal = u8();
    if (ss != 0 || se != 63 || ahal != 0)
      throw Error("progressive JPEG is not supported");
    segment_end(start, len);
    for (int i = 0; i < ns; ++i) sc[i]->pred = 0;

    Bits b{data + pos, data + n};
    int units_x, units_y;  // MCUs
    if (ns == 1) {
      units_x = (sc[0]->width + 7) / 8;
      units_y = (sc[0]->height + 7) / 8;
    } else {
      units_x = mcux;
      units_y = mcuy;
    }
    const long total = (long)units_x * units_y;
    int next_rst = 0;
    for (long m = 0; m < total; ++m) {
      if (restart && m > 0 && m % restart == 0) {
        // Byte-align, then the expected RSTn marker.
        pos = b.p - data;
        b.reset();
        if (pos + 1 >= n || data[pos] != 0xFF)
          throw Error("truncated JPEG: a restart marker is missing");
        while (pos < n && data[pos] == 0xFF) ++pos;
        if (pos >= n || data[pos] != 0xD0 + next_rst)
          throw Error("corrupt JPEG: a restart marker is missing");
        ++pos;
        next_rst = (next_rst + 1) & 7;
        b.p = data + pos;
        for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
      }
      try {
        decode_mcu(b, sc, ns, (int)(m % units_x), (int)(m / units_x));
      } catch (const Error&) {
        // Zero bits fed past the data decode to anything, a bad code too.
        if (b.fake > 0) throw Error("truncated JPEG: the scan's data ends early");
        throw;
      }
      if (b.overrun()) throw Error("truncated JPEG: the scan's data ends early");
    }
    pos = b.p - data;
  }

  void decode_mcu(Bits& b, Component** sc, int ns, int mx, int my) {
    {
      if (ns == 1) {
        Component& c = *sc[0];
        decode_block(b, c, &c.plane[(size_t)my * 8 * c.stride + mx * 8]);
      } else {
        for (int i = 0; i < ns; ++i) {
          Component& c = *sc[i];
          for (int by = 0; by < c.v; ++by)
            for (int bx = 0; bx < c.h; ++bx) {
              const size_t y = (size_t)(my * c.v + by) * 8;
              const size_t x = (size_t)(mx * c.h + bx) * 8;
              decode_block(b, c, &c.plane[y * c.stride + x]);
            }
        }
      }
    }
  }

  void decode_all() {
    headers(false);
    if (!frame) throw Error("corrupt JPEG: no frame header before the scan");
    if (rgb_coded()) throw Error("RGB-coded JPEG is not supported (YCbCr)");
    for (int i = 0; i < ncomp; ++i)
      comp[i].plane.assign((size_t)comp[i].stride * comp[i].rows, 0);
    for (;;) {
      scan();
      // Markers between scans (tables, restart interval) until EOI.
      for (;;) {
        while (pos < n && data[pos] != 0xFF) ++pos;  // tolerate garbage
        if (pos + 1 >= n) throw Error("truncated JPEG: no EOI marker");
        size_t q = pos;
        while (q < n && data[q] == 0xFF) ++q;
        if (q >= n) throw Error("truncated JPEG: no EOI marker");
        const int m = data[q];
        if (m == 0xD9) return;
        if (m == 0xDA) {
          pos = q + 1;
          break;
        }
        pos = q + 1;
        const size_t start = pos;
        const int len = u16();
        if (m == 0xC4) read_dht(len);
        else if (m == 0xDB) read_dqt(len);
        else if (m == 0xDD) restart = u16();
        segment_end(start, len);
      }
    }
  }
};

// jdsample.c: h2v1 and h2v2 fancy upsampling of one output row into out
// (2 x width values), from the component's row `near` and (h2v2) `far`.
void upsample_row(const Component& c, int near, int far, bool h2v2,
                  uint8_t* out) {
  const uint8_t* a = &c.plane[(size_t)near * c.stride];
  const int w = c.width;
  if (!h2v2) {
    if (w <= 2) {
      for (int x = 0; x < w; ++x) out[2 * x] = out[2 * x + 1] = a[x];
      return;
    }
    out[0] = a[0];
    out[1] = (uint8_t)((a[0] * 3 + a[1] + 2) >> 2);
    for (int x = 1; x < w - 1; ++x) {
      const int v = a[x] * 3;
      out[2 * x] = (uint8_t)((v + a[x - 1] + 1) >> 2);
      out[2 * x + 1] = (uint8_t)((v + a[x + 1] + 2) >> 2);
    }
    out[2 * (w - 1)] = (uint8_t)((a[w - 1] * 3 + a[w - 2] + 1) >> 2);
    out[2 * (w - 1) + 1] = a[w - 1];
    return;
  }
  if (w <= 2) {
    for (int x = 0; x < w; ++x) out[2 * x] = out[2 * x + 1] = a[x];
    return;
  }
  const uint8_t* b = &c.plane[(size_t)far * c.stride];
  int this_sum = a[0] * 3 + b[0];
  int next_sum = a[1] * 3 + b[1];
  out[0] = (uint8_t)((this_sum * 4 + 8) >> 4);
  out[1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
  int last_sum = this_sum;
  this_sum = next_sum;
  for (int x = 1; x < w - 1; ++x) {
    next_sum = a[x + 1] * 3 + b[x + 1];
    out[2 * x] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
    out[2 * x + 1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
    last_sum = this_sum;
    this_sum = next_sum;
  }
  out[2 * (w - 1)] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
  out[2 * (w - 1) + 1] = (uint8_t)((this_sum * 4 + 7) >> 4);
}

// jdcolor.c's tables (SCALEBITS 16).
struct ColorTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  ColorTables() {
    const int64_t one_half = (int64_t)1 << 15;
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = (int)((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
  }
};
const ColorTables kColor;

inline uint8_t clamp255(int v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

void write_output(const Decoder& d, bool gray, uint8_t* out) {
  const int w = d.width, h = d.height;
  const Component& y = d.comp[0];
  if (gray || d.ncomp == 1) {
    for (int r = 0; r < h; ++r)
      std::memcpy(out + (size_t)r * w, &y.plane[(size_t)r * y.stride], w);
    return;
  }
  const bool h2 = d.hmax == 2, v2 = d.vmax == 2;
  std::vector<uint8_t> cb((size_t)2 * d.comp[1].width + 2),
      cr((size_t)2 * d.comp[2].width + 2);
  for (int r = 0; r < h; ++r) {
    const uint8_t* cbrow;
    const uint8_t* crrow;
    if (!h2) {
      cbrow = &d.comp[1].plane[(size_t)r * d.comp[1].stride];
      crrow = &d.comp[2].plane[(size_t)r * d.comp[2].stride];
    } else {
      const int near = v2 ? r / 2 : r;
      int far = near;
      if (v2) {
        const int ch = d.comp[1].height;
        far = (r & 1) ? std::min(near + 1, ch - 1) : std::max(near - 1, 0);
      }
      upsample_row(d.comp[1], near, far, v2, cb.data());
      upsample_row(d.comp[2], near, far, v2, cr.data());
      cbrow = cb.data();
      crrow = cr.data();
    }
    const uint8_t* yrow = &y.plane[(size_t)r * y.stride];
    uint8_t* o = out + (size_t)r * w * 3;
    for (int x = 0; x < w; ++x) {
      const int yy = yrow[x], b = cbrow[x], c = crrow[x];
      o[3 * x] = clamp255(yy + kColor.cr_r[c]);
      o[3 * x + 1] =
          clamp255(yy + (int)((kColor.cb_g[b] + kColor.cr_g[c]) >> 16));
      o[3 * x + 2] = clamp255(yy + kColor.cb_b[b]);
    }
  }
}

void set_error(char* err, int cap, const char* what) {
  if (err && cap > 0) {
    std::strncpy(err, what, cap - 1);
    err[cap - 1] = 0;
  }
}

}  // namespace

extern "C" int jpeg_info(const uint8_t* data, long n, int* h, int* w,
                         int* c, char* err, int cap) {
  try {
    Decoder d(data, (size_t)n);
    d.headers(true);
    if (!d.frame) throw Error("corrupt JPEG: no frame header");
    *h = d.height;
    *w = d.width;
    *c = d.ncomp;
    return 0;
  } catch (const std::exception& e) {
    set_error(err, cap, e.what());
    return 1;
  }
}

extern "C" int jpeg_decode(const uint8_t* data, long n, int gray,
                           uint8_t* out, char* err, int cap) {
  try {
    Decoder d(data, (size_t)n);
    d.decode_all();
    write_output(d, gray != 0, out);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, cap, e.what());
    return 1;
  }
}
