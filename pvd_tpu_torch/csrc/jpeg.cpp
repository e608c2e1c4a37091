// Sequential Huffman JPEG decoder for the port's data path
// (pvd_tpu_torch/data/jpeg.py binds it through ctypes).
//
// Reads baseline (SOF0) and extended sequential (SOF1) Huffman JPEG with
// 8-bit samples, one component (grey) or three (YCbCr), any integral
// sampling factors, restart intervals and any image size.  The output is
// libjpeg's (and so libjpeg-turbo's, which cv2 and PIL use) with its
// default decompression settings, bit for bit:
//   * the integer "islow" IDCT (jidctint.c), with its range limiting;
//   * "fancy" triangle upsampling (jdsample.c: h2v1, h1v2 and h2v2 with
//     context rows replicated at the image edges), box replication for
//     other integral factors and for components two samples wide or less;
//   * the fixed-point YCbCr -> RGB conversion (jdcolor.c, 16 fraction
//     bits).
// Progressive, arithmetic-coded, lossless, hierarchical, 12-bit, CMYK and
// RGB-coded files are refused with a message (the Python side raises
// ValueError), as are truncated or malformed headers.
//
// C interface: jpg_info(data, n, &h, &w, &c, err, errlen) reads the header
// (c = 1 grey or 3 RGB); jpg_decode(data, n, out, err, errlen) writes
// h * w * c bytes, rows top to bottom, RGB interleaved.  Both return 0 on
// success and -1 with a message in err otherwise.

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

// zigzag position -> natural (row-major) position, padded as libjpeg's
// jpeg_natural_order so a run past 63 lands on 63
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool present = false;
  int maxcode[18];     // largest code of each length, -1 if none
  int valoffset[18];   // index of the first value of each length - its code
  uint8_t vals[256];
  // first 9 bits -> (length << 8 | value), 0 where the code is longer
  uint16_t look[512];
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;        // table ids of the current scan
  int bw = 0, bh = 0;        // blocks per row / column, MCU-padded
  int dw = 0, dh = 0;        // downsampled width / height in samples
  int pred = 0;              // DC predictor
  std::vector<int16_t> coef;  // bh * bw blocks of 64, natural order
};

[[noreturn]] void fail(const std::string& msg) {
  throw std::runtime_error(msg);
}

struct Decoder {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;
  uint16_t qt[4][64];
  bool qt_set[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int width = 0, height = 0, ncomp = 0;
  Component comp[3];
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  bool frame = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  // entropy-coded data reader
  uint64_t acc = 0;
  int nbits = 0;
  bool at_marker = false;

  Decoder(const uint8_t* d, size_t len) : data(d), n(len) {}

  int byte() {
    if (pos >= n) fail("truncated JPEG");
    return data[pos++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  // ---- headers --------------------------------------------------------
  int next_marker() {
    // skip anything up to 0xFF, then fill bytes
    while (pos < n && data[pos] != 0xFF) pos++;
    while (pos < n && data[pos] == 0xFF) pos++;
    if (pos >= n) fail("truncated JPEG: no EOI marker");
    return data[pos++];
  }

  void read_sof() {
    if (frame) fail("JPEG with more than one frame");
    int len = word();
    int precision = byte();
    if (precision != 8)
      fail("JPEG with " + std::to_string(precision) +
           "-bit samples is not supported (8-bit only)");
    height = word();
    width = word();
    ncomp = byte();
    if (height == 0) fail("JPEG height given by a DNL marker is not supported");
    if (width == 0) fail("JPEG of width 0");
    if (ncomp == 4) fail("CMYK JPEG is not supported (grey or YCbCr only)");
    if (ncomp != 1 && ncomp != 3)
      fail("JPEG with " + std::to_string(ncomp) +
           " components is not supported (grey or YCbCr only)");
    if (len != 8 + 3 * ncomp) fail("bad SOF length");
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("bad JPEG sampling factors or quantization table id");
      if (c.h > hmax) hmax = c.h;
      if (c.v > vmax) vmax = c.v;
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      if (hmax % c.h || vmax % c.v)
        fail("JPEG with fractional sampling factors is not supported");
      c.dw = (int)(((long)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((long)height * c.v + vmax - 1) / vmax);
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }
    frame = true;
  }

  void read_dht() {
    int len = word() - 2;
    while (len > 0) {
      int tc_th = byte();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("bad JPEG Huffman table id");
      Huffman& t = tc == 0 ? dc[th] : ac[th];
      int counts[17];
      int total = 0;
      for (int l = 1; l <= 16; l++) {
        counts[l] = byte();
        total += counts[l];
      }
      if (total > 256 || 17 + total > len) fail("bad JPEG Huffman table");
      for (int i = 0; i < total; i++) t.vals[i] = (uint8_t)byte();
      // canonical codes (jdhuff.c jpeg_make_d_derived_tbl)
      int code = 0, k = 0;
      std::memset(t.look, 0, sizeof(t.look));
      for (int l = 1; l <= 16; l++) {
        t.valoffset[l] = k - code;
        for (int i = 0; i < counts[l]; i++, k++, code++) {
          if (l <= 9) {
            int shift = 9 - l;
            for (int f = 0; f < (1 << shift); f++)
              t.look[(code << shift) | f] = (uint16_t)((l << 8) | t.vals[k]);
          }
        }
        t.maxcode[l] = counts[l] ? code - 1 : -1;
        if (code > (1 << l)) fail("bad JPEG Huffman table: too many codes");
        code <<= 1;
      }
      t.maxcode[17] = 0x7FFFFFFF;
      t.present = true;
      len -= 17 + total;
    }
    if (len != 0) fail("bad DHT length");
  }

  void read_dqt() {
    int len = word() - 2;
    while (len > 0) {
      int pq_tq = byte();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (pq > 1 || tq > 3) fail("bad JPEG quantization table");
      for (int i = 0; i < 64; i++)
        qt[tq][kNatural[i]] = (uint16_t)(pq ? word() : byte());
      qt_set[tq] = true;
      len -= 1 + 64 * (pq + 1);
    }
    if (len != 0) fail("bad DQT length");
  }

  void read_app(int marker) {
    int len = word() - 2;
    if (len < 0) fail("bad marker length");
    size_t start = pos;
    if (pos + len > n) fail("truncated JPEG");
    if (marker == 0xE0 && len >= 5 && !std::memcmp(data + pos, "JFIF\0", 5))
      jfif = true;
    if (marker == 0xEE && len >= 12 && !std::memcmp(data + pos, "Adobe", 5)) {
      adobe = true;
      adobe_transform = data[pos + 11];
    }
    pos = start + len;
  }

  void skip_segment() {
    int len = word() - 2;
    if (len < 0 || pos + len > n) fail("truncated JPEG");
    pos += len;
  }

  // libjpeg's choice of color space for three components (jdapimin.c)
  void check_color_space() {
    if (ncomp != 3) return;
    bool rgb;
    if (jfif)
      rgb = false;
    else if (adobe)
      rgb = adobe_transform == 0;
    else
      rgb = comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
    if (rgb) fail("RGB-coded JPEG is not supported (grey or YCbCr only)");
  }

  // ---- entropy-coded data ---------------------------------------------
  void fill() {
    while (nbits <= 56) {
      int b = 0;
      if (!at_marker && pos < n) {
        b = data[pos];
        if (b == 0xFF) {
          size_t q = pos + 1;
          while (q < n && data[q] == 0xFF) q++;  // fill bytes
          if (q < n && data[q] == 0) {
            pos = q + 1;  // stuffed 0xFF
          } else {
            at_marker = true;  // a marker: feed zeros from here, as libjpeg
            pos = q - 1;
            b = 0;
          }
        } else {
          pos++;
        }
      }
      acc |= (uint64_t)b << (56 - nbits);
      nbits += 8;
    }
  }

  int bits(int k) {
    if (k == 0) return 0;
    if (nbits < k) fill();
    int v = (int)(acc >> (64 - k));
    acc <<= k;
    nbits -= k;
    return v;
  }

  int decode(const Huffman& t) {
    if (nbits < 16) fill();
    int e = t.look[acc >> 55];
    if (e) {
      int l = e >> 8;
      acc <<= l;
      nbits -= l;
      return e & 0xFF;
    }
    int code = (int)(acc >> 54);  // 10 bits
    int l = 10;
    while (l <= 16 && code > t.maxcode[l]) {
      l++;
      code = (int)(acc >> (64 - l));
    }
    if (l > 16) fail("corrupt JPEG data: bad Huffman code");
    acc <<= l;
    nbits -= l;
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }

  static int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }

  void decode_block(Component& c, int16_t* blk) {
    const Huffman& tdc = dc[c.td];
    const Huffman& tac = ac[c.ta];
    int s = decode(tdc);
    if (s > 15) fail("corrupt JPEG data: bad DC size");
    int diff = s ? extend(bits(s), s) : 0;
    c.pred += diff;
    blk[0] = (int16_t)c.pred;
    for (int k = 1; k < 64; k++) {
      int rs = decode(tac);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)extend(bits(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void restart() {
    acc = 0;
    nbits = 0;
    // the bytes left before the marker belong to this interval
    if (!at_marker) skip_to_marker();
    if (pos + 1 < n && data[pos] == 0xFF && data[pos + 1] >= 0xD0 &&
        data[pos + 1] <= 0xD7)
      pos += 2;  // the RSTn marker
    at_marker = false;
    for (int i = 0; i < ncomp; i++) comp[i].pred = 0;
  }

  void read_sos() {
    if (!frame) fail("JPEG scan before its frame header");
    int len = word();
    int ns = byte();
    if (ns < 1 || ns > ncomp || len != 6 + 2 * ns) fail("bad SOS header");
    Component* sc[3];
    for (int i = 0; i < ns; i++) {
      int id = byte();
      int tdta = byte();
      Component* c = nullptr;
      for (int j = 0; j < ncomp; j++)
        if (comp[j].id == id) c = &comp[j];
      if (!c) fail("JPEG scan names an unknown component");
      c->td = tdta >> 4;
      c->ta = tdta & 15;
      if (c->td > 3 || c->ta > 3 || !dc[c->td].present ||
          !ac[c->ta].present)
        fail("JPEG scan uses a missing Huffman table");
      sc[i] = c;
    }
    int ss = byte(), se = byte(), ahal = byte();
    if (ss != 0 || se != 63 || ahal != 0)
      fail("bad spectral selection for a sequential JPEG");
    acc = 0;
    nbits = 0;
    at_marker = false;
    for (int i = 0; i < ncomp; i++) comp[i].pred = 0;

    int rows, cols;
    if (ns == 1) {  // non-interleaved: one block per MCU
      cols = (sc[0]->dw + 7) / 8;
      rows = (sc[0]->dh + 7) / 8;
    } else {
      cols = mcux;
      rows = mcuy;
    }
    int todo = restart_interval;
    for (int my = 0; my < rows; my++) {
      for (int mx = 0; mx < cols; mx++) {
        if (restart_interval) {
          if (todo == 0) {
            restart();
            todo = restart_interval;
          }
          todo--;
        }
        if (ns == 1) {
          Component& c = *sc[0];
          decode_block(c, &c.coef[((size_t)my * c.bw + mx) * 64]);
          continue;
        }
        for (int i = 0; i < ns; i++) {
          Component& c = *sc[i];
          for (int by = 0; by < c.v; by++)
            for (int bx = 0; bx < c.h; bx++) {
              size_t row = (size_t)my * c.v + by;
              size_t col = (size_t)mx * c.h + bx;
              decode_block(c, &c.coef[(row * c.bw + col) * 64]);
            }
        }
      }
    }
    // leave pos at the next marker
    if (!at_marker) skip_to_marker();
    at_marker = false;
    acc = 0;
    nbits = 0;
  }

  // move pos to the 0xFF of the next marker, past stuffed and fill bytes
  void skip_to_marker() {
    while (pos < n) {
      if (data[pos] == 0xFF) {
        size_t q = pos + 1;
        while (q < n && data[q] == 0xFF) q++;
        if (q < n && data[q] != 0) {
          pos = q - 1;
          return;
        }
        pos = q + 1;
      } else {
        pos++;
      }
    }
  }

  // ---- headers up to the first scan, or the whole file ------------------
  void parse(bool decode_scans) {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file");
    pos = 2;
    bool scanned = false;
    for (;;) {
      int m = next_marker();
      if (m == 0xD8) fail("bad JPEG: second SOI marker");
      if (m == 0xD9) break;  // EOI
      if (m == 0xC0 || m == 0xC1) {
        read_sof();
      } else if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) {
        fail("progressive JPEG is not supported (sequential only)");
      } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
        fail("lossless JPEG is not supported");
      } else if (m == 0xC5) {
        fail("hierarchical JPEG is not supported");
      } else if (m == 0xC9 || m == 0xCD || m == 0xCC) {
        fail("arithmetic-coded JPEG is not supported (Huffman only)");
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xDD) {
        if (word() != 4) fail("bad DRI length");
        restart_interval = word();
      } else if (m == 0xDA) {
        if (!decode_scans) {
          check_color_space();
          return;
        }
        check_color_space();
        read_sos();
        scanned = true;
      } else if (m >= 0xD0 && m <= 0xD7) {
        // a stray RSTn between segments: nothing to read
      } else if (m >= 0xE0 && m <= 0xEF) {
        read_app(m);
      } else if (m == 0x01) {
        // TEM: no length
      } else {
        skip_segment();  // COM, DNL, DHP, EXP, JPGn
      }
    }
    if (!frame) fail("JPEG without a frame header");
    if (decode_scans && !scanned) fail("JPEG without a scan");
  }

  // ---- IDCT (jidctint.c jpeg_idct_islow) ----------------------------------
  static uint8_t limit_idct(long x) {
    // libjpeg's post-IDCT range table, indexed by x & 1023 (x centred on 0)
    int t = (int)(x & 1023);
    int y = t < 512 ? t : t - 1024;
    y += 128;
    return (uint8_t)(y < 0 ? 0 : y > 255 ? 255 : y);
  }

  static void idct_block(const int16_t* in, const uint16_t* q, uint8_t* out,
                         int stride) {
    const int CONST_BITS = 13, PASS1_BITS = 2;
    const long F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
               F0_899 = 7373, F1_175 = 9633, F1_501 = 12299, F1_847 = 15137,
               F1_961 = 16069, F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;
    auto descale = [](long x, int n) { return (x + (1L << (n - 1))) >> n; };
    int ws[64];
    for (int c = 0; c < 8; c++) {
      const int16_t* ip = in + c;
      const uint16_t* qp = q + c;
      int* wp = ws + c;
      if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
          !ip[56]) {
        int dcval = (int)((long)ip[0] * qp[0] * (1 << PASS1_BITS));
        for (int r = 0; r < 8; r++) wp[8 * r] = dcval;
        continue;
      }
      long z2 = (long)ip[16] * qp[16], z3 = (long)ip[48] * qp[48];
      long z1 = (z2 + z3) * F0_541;
      long tmp2 = z1 + z3 * (-F1_847);
      long tmp3 = z1 + z2 * F0_765;
      z2 = (long)ip[0] * qp[0];
      z3 = (long)ip[32] * qp[32];
      long tmp0 = (z2 + z3) * (1L << CONST_BITS);
      long tmp1 = (z2 - z3) * (1L << CONST_BITS);
      long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = (long)ip[56] * qp[56];
      tmp1 = (long)ip[40] * qp[40];
      tmp2 = (long)ip[24] * qp[24];
      tmp3 = (long)ip[8] * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      long z4 = tmp1 + tmp3;
      long z5 = (z3 + z4) * F1_175;
      tmp0 *= F0_298;
      tmp1 *= F2_053;
      tmp2 *= F3_072;
      tmp3 *= F1_501;
      z1 *= -F0_899;
      z2 *= -F2_562;
      z3 *= -F1_961;
      z4 *= -F0_390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = CONST_BITS - PASS1_BITS;
      wp[0] = (int)descale(tmp10 + tmp3, sh);
      wp[56] = (int)descale(tmp10 - tmp3, sh);
      wp[8] = (int)descale(tmp11 + tmp2, sh);
      wp[48] = (int)descale(tmp11 - tmp2, sh);
      wp[16] = (int)descale(tmp12 + tmp1, sh);
      wp[40] = (int)descale(tmp12 - tmp1, sh);
      wp[24] = (int)descale(tmp13 + tmp0, sh);
      wp[32] = (int)descale(tmp13 - tmp0, sh);
    }
    for (int r = 0; r < 8; r++) {
      const int* wp = ws + 8 * r;
      uint8_t* op = out + (size_t)r * stride;
      if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] &&
          !wp[7]) {
        uint8_t v = limit_idct(descale(wp[0], PASS1_BITS + 3));
        for (int c = 0; c < 8; c++) op[c] = v;
        continue;
      }
      long z2 = wp[2], z3 = wp[6];
      long z1 = (z2 + z3) * F0_541;
      long tmp2 = z1 + z3 * (-F1_847);
      long tmp3 = z1 + z2 * F0_765;
      long tmp0 = ((long)wp[0] + wp[4]) * (1L << CONST_BITS);
      long tmp1 = ((long)wp[0] - wp[4]) * (1L << CONST_BITS);
      long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = wp[7];
      tmp1 = wp[5];
      tmp2 = wp[3];
      tmp3 = wp[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      long z4 = tmp1 + tmp3;
      long z5 = (z3 + z4) * F1_175;
      tmp0 *= F0_298;
      tmp1 *= F2_053;
      tmp2 *= F3_072;
      tmp3 *= F1_501;
      z1 *= -F0_899;
      z2 *= -F2_562;
      z3 *= -F1_961;
      z4 *= -F0_390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = CONST_BITS + PASS1_BITS + 3;
      op[0] = limit_idct(descale(tmp10 + tmp3, sh));
      op[7] = limit_idct(descale(tmp10 - tmp3, sh));
      op[1] = limit_idct(descale(tmp11 + tmp2, sh));
      op[6] = limit_idct(descale(tmp11 - tmp2, sh));
      op[2] = limit_idct(descale(tmp12 + tmp1, sh));
      op[5] = limit_idct(descale(tmp12 - tmp1, sh));
      op[3] = limit_idct(descale(tmp13 + tmp0, sh));
      op[4] = limit_idct(descale(tmp13 - tmp0, sh));
    }
  }

  // a component's samples [bh * 8][bw * 8]
  std::vector<uint8_t> plane(const Component& c) {
    if (!qt_set[c.tq]) fail("JPEG component uses a missing quantization table");
    int stride = c.bw * 8;
    std::vector<uint8_t> p((size_t)stride * c.bh * 8);
    for (int by = 0; by < c.bh; by++)
      for (int bx = 0; bx < c.bw; bx++)
        idct_block(&c.coef[((size_t)by * c.bw + bx) * 64], qt[c.tq],
                   &p[(size_t)by * 8 * stride + bx * 8], stride);
    return p;
  }

  // the component upsampled to [height][width] (jdsample.c)
  std::vector<uint8_t> upsample(const Component& c,
                                const std::vector<uint8_t>& p) {
    int stride = c.bw * 8;
    int hx = hmax / c.h, vx = vmax / c.v;
    std::vector<uint8_t> out((size_t)width * height);
    auto in = [&](int y, int x) { return (int)p[(size_t)y * stride + x]; };
    auto row = [&](int y) { return y < 0 ? 0 : y >= c.dh ? c.dh - 1 : y; };
    bool h2 = hx == 2 && c.dw > 2;  // fancy horizontal doubling
    std::vector<int> tmp;
    if (hx == 1 && vx == 1) {
      for (int y = 0; y < height; y++)
        std::memcpy(&out[(size_t)y * width], &p[(size_t)y * stride], width);
    } else if (h2 && vx == 1) {  // h2v1_fancy_upsample
      std::vector<uint8_t> line(2 * c.dw);
      for (int y = 0; y < height; y++) {
        int n1 = c.dw;
        line[0] = (uint8_t)in(y, 0);
        line[1] = (uint8_t)((in(y, 0) * 3 + in(y, 1) + 2) >> 2);
        for (int i = 1; i < n1 - 1; i++) {
          int v3 = in(y, i) * 3;
          line[2 * i] = (uint8_t)((v3 + in(y, i - 1) + 1) >> 2);
          line[2 * i + 1] = (uint8_t)((v3 + in(y, i + 1) + 2) >> 2);
        }
        line[2 * n1 - 2] =
            (uint8_t)((in(y, n1 - 1) * 3 + in(y, n1 - 2) + 1) >> 2);
        line[2 * n1 - 1] = (uint8_t)in(y, n1 - 1);
        std::memcpy(&out[(size_t)y * width], line.data(), width);
      }
    } else if (hx == 1 && vx == 2) {  // h1v2_fancy_upsample
      for (int y = 0; y < height; y++) {
        int y0 = y >> 1;
        int y1 = row((y & 1) ? y0 + 1 : y0 - 1);
        int bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < width; x++)
          out[(size_t)y * width + x] =
              (uint8_t)((in(y0, x) * 3 + in(y1, x) + bias) >> 2);
      }
    } else if (h2 && vx == 2) {  // h2v2_fancy_upsample
      std::vector<uint8_t> line(2 * c.dw);
      std::vector<int> col(c.dw);
      for (int y = 0; y < height; y++) {
        int y0 = y >> 1;
        int y1 = row((y & 1) ? y0 + 1 : y0 - 1);
        for (int i = 0; i < c.dw; i++) col[i] = in(y0, i) * 3 + in(y1, i);
        int n1 = c.dw;
        line[0] = (uint8_t)((col[0] * 4 + 8) >> 4);
        line[1] = (uint8_t)((col[0] * 3 + col[1] + 7) >> 4);
        for (int i = 1; i < n1 - 1; i++) {
          line[2 * i] = (uint8_t)((col[i] * 3 + col[i - 1] + 8) >> 4);
          line[2 * i + 1] = (uint8_t)((col[i] * 3 + col[i + 1] + 7) >> 4);
        }
        line[2 * n1 - 2] = (uint8_t)((col[n1 - 1] * 3 + col[n1 - 2] + 8) >> 4);
        line[2 * n1 - 1] = (uint8_t)((col[n1 - 1] * 4 + 7) >> 4);
        std::memcpy(&out[(size_t)y * width], line.data(), width);
      }
    } else {  // int_upsample / h2v1_upsample / h2v2_upsample: replication
      for (int y = 0; y < height; y++)
        for (int x = 0; x < width; x++)
          out[(size_t)y * width + x] = (uint8_t)in(y / vx, x / hx);
    }
    return out;
  }

  void decode_image(uint8_t* out) {
    parse(true);
    std::vector<uint8_t> planes[3];
    for (int i = 0; i < ncomp; i++)
      planes[i] = upsample(comp[i], plane(comp[i]));
    size_t npix = (size_t)width * height;
    if (ncomp == 1) {
      std::memcpy(out, planes[0].data(), npix);
      return;
    }
    // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert
    const int SCALEBITS = 16;
    const long ONE_HALF = 1L << (SCALEBITS - 1);
    auto fix = [](double x) { return (long)(x * (1L << 16) + 0.5); };
    int cr_r[256], cb_b[256];
    long cr_g[256], cb_g[256];
    for (int i = 0; i < 256; i++) {
      long x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = (int)((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
    const uint8_t *Y = planes[0].data(), *Cb = planes[1].data(),
                  *Cr = planes[2].data();
    for (size_t i = 0; i < npix; i++) {
      int y = Y[i], cb = Cb[i], cr = Cr[i];
      out[3 * i] = clamp(y + cr_r[cr]);
      out[3 * i + 1] = clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
      out[3 * i + 2] = clamp(y + cb_b[cb]);
    }
  }
};

void set_error(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) {
    std::strncpy(err, msg, (size_t)errlen - 1);
    err[errlen - 1] = 0;
  }
}

}  // namespace

extern "C" {

int jpg_info(const uint8_t* data, size_t n, int* h, int* w, int* c,
             char* err, int errlen) {
  try {
    Decoder d(data, n);
    d.parse(false);
    *h = d.height;
    *w = d.width;
    *c = d.ncomp;
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

int jpg_decode(const uint8_t* data, size_t n, uint8_t* out, char* err,
               int errlen) {
  try {
    Decoder d(data, n);
    d.decode_image(out);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

}  // extern "C"
