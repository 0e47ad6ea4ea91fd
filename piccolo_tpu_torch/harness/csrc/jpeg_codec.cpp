// Baseline JPEG decoding and encoding for the port's host image IO.
//
// The decoder reproduces libjpeg(-turbo)'s default decompression, which
// cv2.imread uses, so that its pixels equal cv2's bit for bit:
//   * Huffman entropy decoding with restart intervals (jdhuff.c);
//   * the ISLOW integer inverse DCT (jidctint.c) and its range limit;
//   * "fancy" triangle-filter chroma upsampling (jdsample.c: h2v1, h2v2 and
//     h1v2, with their edge columns, edge-replicated context rows and
//     rounding biases), box replication where libjpeg uses it;
//   * the 16-bit fixed-point YCbCr -> RGB conversion (jdcolor.c).
// The encoder writes the entropy-coded segment of a baseline 4:2:0 or
// 4:4:4 JPEG: jccolor.c's fixed-point RGB -> YCbCr, jcsample.c's h2v2
// downsampling, the ISLOW forward DCT (jfdctint.c) and rounded
// quantisation.  Markers and tables are written by the Python caller.
//
// Plain C interface, loaded with ctypes (which releases the GIL for the
// call).  Both entry points return 0, or a non-zero code with a message in
// `err`.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr int kZigzag[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // libjpeg's guard entries: a corrupt run past 63 lands on 63
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------- Huffman

struct HuffTable {
  // canonical decode (libjpeg's jpeg_huff_decode): codes of length l are
  // mincode[l]..maxcode[l], value index valptr[l] + (code - mincode[l])
  int32_t maxcode[18];
  int32_t mincode[17];
  int32_t valptr[17];
  uint8_t vals[256];
  // 9-bit lookahead: length (0 = longer code) and value
  uint8_t look_len[512];
  uint8_t look_val[512];
};

bool build_huff(const uint8_t* bits, const uint8_t* vals, HuffTable* t) {
  int code = 0, k = 0;
  std::memset(t->look_len, 0, sizeof(t->look_len));
  for (int l = 1; l <= 16; ++l) {
    t->valptr[l] = k;
    t->mincode[l] = code;
    code += bits[l - 1];
    k += bits[l - 1];
    if (k > 256) return false;
    t->maxcode[l] = bits[l - 1] ? code - 1 : -1;
    code <<= 1;
  }
  t->maxcode[17] = 0x7FFFFFFF;
  std::memcpy(t->vals, vals, 256);
  for (int l = 1; l <= 9; ++l) {
    for (int c = t->mincode[l]; c <= t->maxcode[l]; ++c) {
      int v = t->vals[t->valptr[l] + c - t->mincode[l]];
      int shift = 9 - l;
      for (int f = 0; f < (1 << shift); ++f) {
        t->look_len[(c << shift) | f] = (uint8_t)l;
        t->look_val[(c << shift) | f] = (uint8_t)v;
      }
    }
  }
  return true;
}

// Reads the entropy-coded segment: removes 0xFF00 stuffing, stops at a
// marker and then feeds zero bits, as libjpeg does.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int nbits = 0;
  bool at_marker = false;

  void fill() {
    while (nbits <= 56) {
      uint32_t byte = 0;
      if (!at_marker && p < end) {
        byte = *p;
        if (byte == 0xFF) {
          if (p + 1 < end && p[1] == 0x00) {
            p += 2;
          } else {
            at_marker = true;  // leave the marker for the caller
            byte = 0;
          }
        } else {
          ++p;
        }
      }
      acc |= (uint64_t)byte << (56 - nbits);
      nbits += 8;
    }
  }
  uint32_t peek(int n) {
    if (nbits < n) fill();
    return (uint32_t)(acc >> (64 - n));
  }
  void skip(int n) {
    acc <<= n;
    nbits -= n;
  }
  int get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return (int)v;
  }
  // a restart marker: drop the buffered bits and step over RSTn (a
  // missing marker is tolerated, as in libjpeg)
  void restart() {
    acc = 0;
    nbits = 0;
    at_marker = false;
    while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF)) {
      ++p;  // skip to the marker (libjpeg tolerates junk before it)
    }
    if (p + 1 < end && p[1] >= 0xD0 && p[1] <= 0xD7) p += 2;
  }
};

inline int decode_huff(BitReader& br, const HuffTable& t) {
  uint32_t look = br.peek(9);
  int l = t.look_len[look];
  if (l) {
    br.skip(l);
    return t.look_val[look];
  }
  uint32_t code16 = br.peek(16);
  for (l = 10; l <= 16; ++l) {
    int32_t code = (int32_t)(code16 >> (16 - l));
    if (code <= t.maxcode[l]) {
      br.skip(l);
      return t.vals[(t.valptr[l] + code - t.mincode[l]) & 0xFF];
    }
  }
  br.skip(16);
  return 0;  // corrupt data: libjpeg warns and returns 0
}

inline int extend(int v, int s) {  // HUFF_EXTEND
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// ------------------------------------------------------ ISLOW inverse DCT

constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                  FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                  FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + ((int64_t)1 << (n - 1))) >> n;
}

// libjpeg's post-IDCT range limit: table[x & 1023] of the centred output
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int m = 0; m < 1024; ++m) {
      int v;
      if (m < 128) v = m + 128;
      else if (m < 512) v = 255;
      else if (m < 896) v = 0;
      else v = m - 896;
      t[m] = (uint8_t)v;
    }
  }
};
const RangeLimit kRange;

// coef: 64 coefficients in natural order; q: the quantisation table
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qt = q + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
        in[40] == 0 && in[48] == 0 && in[56] == 0) {
      int dc = (int)in[0] * (int)qt[0] * (1 << PASS1_BITS);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
      continue;
    }
    int64_t z2 = (int64_t)in[16] * qt[16], z3 = (int64_t)in[48] * qt[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)in[0] * qt[0];
    z3 = (int64_t)in[32] * qt[32];
    int64_t tmp0 = (z2 + z3) * ((int64_t)1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * ((int64_t)1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = (int64_t)in[56] * qt[56];
    tmp1 = (int64_t)in[40] * qt[40];
    tmp2 = (int64_t)in[24] * qt[24];
    tmp3 = (int64_t)in[8] * qt[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int n = CONST_BITS - PASS1_BITS;
    ws[0 * 8 + c] = (int)descale(tmp10 + tmp3, n);
    ws[7 * 8 + c] = (int)descale(tmp10 - tmp3, n);
    ws[1 * 8 + c] = (int)descale(tmp11 + tmp2, n);
    ws[6 * 8 + c] = (int)descale(tmp11 - tmp2, n);
    ws[2 * 8 + c] = (int)descale(tmp12 + tmp1, n);
    ws[5 * 8 + c] = (int)descale(tmp12 - tmp1, n);
    ws[3 * 8 + c] = (int)descale(tmp13 + tmp0, n);
    ws[4 * 8 + c] = (int)descale(tmp13 - tmp0, n);
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + (size_t)r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      uint8_t dc = kRange.t[(int)descale(w[0], PASS1_BITS + 3) & 1023];
      for (int c = 0; c < 8; ++c) o[c] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * ((int64_t)1 << CONST_BITS);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * ((int64_t)1 << CONST_BITS);
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
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int n = CONST_BITS + PASS1_BITS + 3;
    o[0] = kRange.t[(int)descale(tmp10 + tmp3, n) & 1023];
    o[7] = kRange.t[(int)descale(tmp10 - tmp3, n) & 1023];
    o[1] = kRange.t[(int)descale(tmp11 + tmp2, n) & 1023];
    o[6] = kRange.t[(int)descale(tmp11 - tmp2, n) & 1023];
    o[2] = kRange.t[(int)descale(tmp12 + tmp1, n) & 1023];
    o[5] = kRange.t[(int)descale(tmp12 - tmp1, n) & 1023];
    o[3] = kRange.t[(int)descale(tmp13 + tmp0, n) & 1023];
    o[4] = kRange.t[(int)descale(tmp13 - tmp0, n) & 1023];
  }
}

// ------------------------------------------------------------ upsampling

struct Plane {
  std::vector<uint8_t> px;
  int stride = 0;  // allocated width (whole blocks)
  int w = 0, h = 0;  // real (downsampled) size
  uint8_t at(int r, int c) const { return px[(size_t)r * stride + c]; }
};

// one component at full output size (out_w x out_h), libjpeg's choice of
// method for its sampling factors (jdsample.c jinit_upsampler)
bool upsample(const Plane& in, int hf, int vf, int out_w, int out_h,
              std::vector<uint8_t>& out) {
  out.assign((size_t)out_w * out_h, 0);
  const int dw = in.w, dh = in.h;
  auto row = [&](int r) {  // context rows replicate the edge rows
    r = r < 0 ? 0 : (r >= dh ? dh - 1 : r);
    return &in.px[(size_t)r * in.stride];
  };
  if (hf == 1 && vf == 1) {
    for (int r = 0; r < out_h; ++r)
      std::memcpy(&out[(size_t)r * out_w], row(r), out_w);
    return true;
  }
  std::vector<uint8_t> line((size_t)2 * dw + 2);
  if (hf == 2 && vf == 1 && dw > 2) {  // h2v1 fancy
    for (int r = 0; r < out_h; ++r) {
      const uint8_t* ip = row(r);
      uint8_t* op = line.data();
      int inv = ip[0];
      *op++ = (uint8_t)inv;
      *op++ = (uint8_t)((inv * 3 + ip[1] + 2) >> 2);
      for (int c = 1; c < dw - 1; ++c) {
        inv = ip[c] * 3;
        *op++ = (uint8_t)((inv + ip[c - 1] + 1) >> 2);
        *op++ = (uint8_t)((inv + ip[c + 1] + 2) >> 2);
      }
      inv = ip[dw - 1];
      *op++ = (uint8_t)((inv * 3 + ip[dw - 2] + 1) >> 2);
      *op++ = (uint8_t)inv;
      std::memcpy(&out[(size_t)r * out_w], line.data(), out_w);
    }
    return true;
  }
  if (hf == 2 && vf == 2 && dw > 2) {  // h2v2 fancy
    for (int r = 0; r < out_h; ++r) {
      int inrow = r >> 1;
      const uint8_t* i0 = row(inrow);
      const uint8_t* i1 = row((r & 1) ? inrow + 1 : inrow - 1);
      uint8_t* op = line.data();
      int thiscol = i0[0] * 3 + i1[0];
      int nextcol = i0[1] * 3 + i1[1];
      *op++ = (uint8_t)((thiscol * 4 + 8) >> 4);
      *op++ = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
      int lastcol = thiscol;
      thiscol = nextcol;
      for (int c = 2; c < dw; ++c) {
        nextcol = i0[c] * 3 + i1[c];
        *op++ = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
        *op++ = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
        lastcol = thiscol;
        thiscol = nextcol;
      }
      *op++ = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
      *op++ = (uint8_t)((thiscol * 4 + 7) >> 4);
      std::memcpy(&out[(size_t)r * out_w], line.data(), out_w);
    }
    return true;
  }
  if (hf == 1 && vf == 2) {  // h1v2 fancy
    for (int r = 0; r < out_h; ++r) {
      int inrow = r >> 1;
      const uint8_t* i0 = row(inrow);
      const uint8_t* i1 = row((r & 1) ? inrow + 1 : inrow - 1);
      int bias = (r & 1) ? 2 : 1;
      uint8_t* op = &out[(size_t)r * out_w];
      for (int c = 0; c < out_w; ++c)
        op[c] = (uint8_t)((i0[c] * 3 + i1[c] + bias) >> 2);
    }
    return true;
  }
  if (hf < 1 || vf < 1) return false;
  // box replication (h2v1/h2v2 at widths <= 2, and integral factors)
  for (int r = 0; r < out_h; ++r) {
    const uint8_t* ip = &in.px[(size_t)(r / vf) * in.stride];
    uint8_t* op = &out[(size_t)r * out_w];
    for (int c = 0; c < out_w; ++c) op[c] = ip[c / hf];
  }
  return true;
}

void set_err(char* err, int err_len, const char* msg) {
  if (err && err_len > 0) std::snprintf(err, err_len, "%s", msg);
}

// ---------------------------------------------------------- colour tables

struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t half = (int64_t)1 << 15;
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + half) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

}  // namespace

extern "C" {

// Decode one baseline scan holding every component of the frame.
//   scan/scan_len: the bytes after the SOS header (to the end of the file)
//   hs, vs, tq, td, ta: per component sampling factors, quantisation table
//     slot and DC/AC Huffman table slots
//   qt: 4 x 64 quantisation values in natural order
//   dc_bits/dc_vals, ac_bits/ac_vals: 4 tables each, 16 counts and 256
//     values
//   out: height x width x 3 RGB (three components are YCbCr)
int pj_decode(const uint8_t* scan, long scan_len, int width, int height,
              int ncomp, const int* hs, const int* vs, const int* tq,
              const int* td, const int* ta, const uint16_t* qt,
              const uint8_t* dc_bits, const uint8_t* dc_vals,
              const uint8_t* ac_bits, const uint8_t* ac_vals,
              int restart_interval, uint8_t* out, char* err, int err_len) {
  if (ncomp != 1 && ncomp != 3) {
    set_err(err, err_len, "only 1- and 3-component scans are decoded");
    return 1;
  }
  HuffTable dct[4], act[4];
  for (int i = 0; i < 4; ++i) {
    if (!build_huff(dc_bits + 16 * i, dc_vals + 256 * i, &dct[i]) ||
        !build_huff(ac_bits + 16 * i, ac_vals + 256 * i, &act[i])) {
      set_err(err, err_len, "bad Huffman table");
      return 1;
    }
  }
  int hmax = 1, vmax = 1;
  for (int c = 0; c < ncomp; ++c) {
    if (hs[c] > hmax) hmax = hs[c];
    if (vs[c] > vmax) vmax = vs[c];
  }
  Plane planes[3];
  int bx[3], by[3];
  int mcus_x, mcus_y;
  if (ncomp == 1) {  // non-interleaved: an MCU is one block
    int dw = (width * hs[0] + hmax - 1) / hmax;
    int dh = (height * vs[0] + vmax - 1) / vmax;
    mcus_x = (dw + 7) / 8;
    mcus_y = (dh + 7) / 8;
    bx[0] = by[0] = 1;
  } else {
    mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
    mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
    for (int c = 0; c < ncomp; ++c) {
      bx[c] = hs[c];
      by[c] = vs[c];
    }
  }
  for (int c = 0; c < ncomp; ++c) {
    Plane& p = planes[c];
    p.stride = mcus_x * bx[c] * 8;
    p.px.assign((size_t)p.stride * mcus_y * by[c] * 8, 0);
    p.w = (width * hs[c] + hmax - 1) / hmax;
    p.h = (height * vs[c] + vmax - 1) / vmax;
  }

  BitReader br{scan, scan + scan_len};
  int pred[3] = {0, 0, 0};
  int16_t coef[64];
  long mcus_left = restart_interval;
  for (int my = 0; my < mcus_y; ++my) {
    for (int mx = 0; mx < mcus_x; ++mx) {
      if (restart_interval) {
        if (mcus_left == 0) {
          br.restart();
          pred[0] = pred[1] = pred[2] = 0;
          mcus_left = restart_interval;
        }
        --mcus_left;
      }
      for (int c = 0; c < ncomp; ++c) {
        const HuffTable& dt = dct[td[c]];
        const HuffTable& at = act[ta[c]];
        const uint16_t* q = qt + 64 * tq[c];
        Plane& p = planes[c];
        for (int yb = 0; yb < by[c]; ++yb) {
          for (int xb = 0; xb < bx[c]; ++xb) {
            std::memset(coef, 0, sizeof(coef));
            int s = decode_huff(br, dt);
            if (s) pred[c] += extend(br.get(s), s);
            coef[0] = (int16_t)pred[c];
            for (int k = 1; k < 64; ++k) {
              int rs = decode_huff(br, at);
              int r = rs >> 4;
              s = rs & 15;
              if (s) {
                k += r;
                coef[kZigzag[k]] = (int16_t)extend(br.get(s), s);
              } else {
                if (r != 15) break;
                k += 15;
              }
            }
            int row0 = (my * by[c] + yb) * 8, col0 = (mx * bx[c] + xb) * 8;
            idct_islow(coef, q, &p.px[(size_t)row0 * p.stride + col0],
                       p.stride);
          }
        }
      }
    }
  }

  const size_t npx = (size_t)width * height;
  std::vector<uint8_t> full[3];
  for (int c = 0; c < ncomp; ++c) {
    int hf = hmax / hs[c], vf = vmax / vs[c];
    if (hf * hs[c] != hmax || vf * vs[c] != vmax ||
        !upsample(planes[c], hf, vf, width, height, full[c])) {
      set_err(err, err_len, "fractional sampling factors are not decoded");
      return 1;
    }
  }
  if (ncomp == 1) {
    for (size_t i = 0; i < npx; ++i)
      out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = full[0][i];
    return 0;
  }
  for (size_t i = 0; i < npx; ++i) {
    int y = full[0][i], cb = full[1][i], cr = full[2][i];
    out[3 * i] = clamp255(y + kYcc.cr_r[cr]);
    out[3 * i + 1] =
        clamp255(y + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
    out[3 * i + 2] = clamp255(y + kYcc.cb_b[cb]);
  }
  return 0;
}

}  // extern "C"

// ----------------------------------------------------------------- encoder

namespace {

struct BitWriter {
  std::vector<uint8_t> buf;
  uint64_t acc = 0;
  int nbits = 0;
  void put(uint32_t code, int len) {
    if (len == 0) return;
    acc = (acc << len) | (code & ((1u << len) - 1));
    nbits += len;
    while (nbits >= 8) {
      uint8_t b = (uint8_t)(acc >> (nbits - 8));
      buf.push_back(b);
      if (b == 0xFF) buf.push_back(0x00);
      nbits -= 8;
    }
  }
  void flush() {  // pad the last byte with 1 bits
    if (nbits) put((1u << (8 - nbits)) - 1, 8 - nbits);
  }
};

struct HuffCodes {
  uint32_t code[256];
  int len[256];
};

void build_codes(const uint8_t* bits, const uint8_t* vals, HuffCodes* h) {
  std::memset(h->len, 0, sizeof(h->len));
  uint32_t code = 0;
  int k = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l - 1]; ++i, ++k) {
      h->code[vals[k]] = code++;
      h->len[vals[k]] = l;
    }
    code <<= 1;
  }
}

void fdct_islow(int* d) {
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass ? 8 : 1, inc = pass ? 1 : 8;
    for (int i = 0; i < 8; ++i) {
      int* p = d + i * inc;
      int64_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      int64_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      int64_t tmp2 = p[2 * step] + p[5 * step],
              tmp5 = p[2 * step] - p[5 * step];
      int64_t tmp3 = p[3 * step] + p[4 * step],
              tmp4 = p[3 * step] - p[4 * step];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      const int n = pass ? CONST_BITS + PASS1_BITS : CONST_BITS - PASS1_BITS;
      if (pass) {
        p[0] = (int)descale(tmp10 + tmp11, PASS1_BITS);
        p[4 * step] = (int)descale(tmp10 - tmp11, PASS1_BITS);
      } else {
        p[0] = (int)((tmp10 + tmp11) * (1 << PASS1_BITS));
        p[4 * step] = (int)((tmp10 - tmp11) * (1 << PASS1_BITS));
      }
      int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
      p[2 * step] = (int)descale(z1 + tmp13 * FIX_0_765366865, n);
      p[6 * step] = (int)descale(z1 + tmp12 * -FIX_1_847759065, n);
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * FIX_1_175875602;
      tmp4 *= FIX_0_298631336;
      tmp5 *= FIX_2_053119869;
      tmp6 *= FIX_3_072711026;
      tmp7 *= FIX_1_501321110;
      z1 *= -FIX_0_899976223;
      z2 *= -FIX_2_562915447;
      z3 *= -FIX_1_961570560;
      z4 *= -FIX_0_390180644;
      z3 += z5;
      z4 += z5;
      p[7 * step] = (int)descale(tmp4 + z1 + z3, n);
      p[5 * step] = (int)descale(tmp5 + z2 + z4, n);
      p[3 * step] = (int)descale(tmp6 + z2 + z3, n);
      p[step] = (int)descale(tmp7 + z1 + z4, n);
    }
  }
}

int nbits_of(int v) {
  int n = 0;
  v = v < 0 ? -v : v;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

void encode_block(BitWriter& bw, const uint8_t* px, int stride,
                  const uint16_t* q, int& pred, const HuffCodes& dc,
                  const HuffCodes& ac) {
  int d[64];
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) d[r * 8 + c] = (int)px[r * stride + c] - 128;
  fdct_islow(d);
  int zz[64];
  for (int k = 0; k < 64; ++k) {
    int i = kZigzag[k];
    int div = (int)q[i] * 8;  // the forward DCT is scaled up by 8
    int t = d[i];
    zz[k] = t < 0 ? -((-t + (div >> 1)) / div) : (t + (div >> 1)) / div;
  }
  int diff = zz[0] - pred;
  pred = zz[0];
  int s = nbits_of(diff);
  bw.put(dc.code[s], dc.len[s]);
  bw.put((uint32_t)(diff < 0 ? diff - 1 : diff), s);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = zz[k];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw.put(ac.code[0xF0], ac.len[0xF0]);
      run -= 16;
    }
    s = nbits_of(v);
    int rs = (run << 4) | s;
    bw.put(ac.code[rs], ac.len[rs]);
    bw.put((uint32_t)(v < 0 ? v - 1 : v), s);
    run = 0;
  }
  if (run) bw.put(ac.code[0], ac.len[0]);
}

}  // namespace

extern "C" {

// Encode an RGB image (height x width x 3) as one interleaved baseline scan
// with 4:2:0 (subsample = 1) or 4:4:4 chroma.  qt: 2 x 64 quantisation
// values in natural order (luma, chroma); bits/vals: the 4 Huffman tables
// in the order luma DC, luma AC, chroma DC, chroma AC.  Writes at most
// out_cap bytes of entropy-coded data to out; returns their count, or -1
// when out_cap is too small.
long pj_encode(const uint8_t* rgb, int width, int height, int subsample,
               const uint16_t* qt, const uint8_t* bits, const uint8_t* vals,
               uint8_t* out, long out_cap) {
  HuffCodes hc[4];
  for (int i = 0; i < 4; ++i) build_codes(bits + 16 * i, vals + 256 * i, &hc[i]);
  const int f = subsample ? 2 : 1;
  const int mcu = 8 * f;
  const int mcus_x = (width + mcu - 1) / mcu, mcus_y = (height + mcu - 1) / mcu;
  const int pw = mcus_x * mcu, ph = mcus_y * mcu;
  // jccolor.c's fixed-point conversion on the edge-replicated padded image
  auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
  const int64_t half = (int64_t)1 << 15, off = (int64_t)128 << 16;
  std::vector<uint8_t> ycc[3];
  for (auto& v : ycc) v.resize((size_t)pw * ph);
  for (int r = 0; r < ph; ++r) {
    const uint8_t* src = rgb + (size_t)(r < height ? r : height - 1) * width * 3;
    for (int c = 0; c < pw; ++c) {
      const uint8_t* p = src + (size_t)(c < width ? c : width - 1) * 3;
      int64_t R = p[0], G = p[1], B = p[2];
      size_t i = (size_t)r * pw + c;
      ycc[0][i] = (uint8_t)((fix(0.29900) * R + fix(0.58700) * G +
                             fix(0.11400) * B + half) >> 16);
      ycc[1][i] = (uint8_t)((-fix(0.16874) * R - fix(0.33126) * G +
                             fix(0.50000) * B + off + half - 1) >> 16);
      ycc[2][i] = (uint8_t)((fix(0.50000) * R - fix(0.41869) * G -
                             fix(0.08131) * B + off + half - 1) >> 16);
    }
  }
  std::vector<uint8_t> chroma[2];
  int cw = pw, cstride = pw;
  const uint8_t* cplane[2] = {ycc[1].data(), ycc[2].data()};
  if (subsample) {  // jcsample.c h2v2_downsample: alternating bias 1, 2
    cw = cstride = pw / 2;
    for (int k = 0; k < 2; ++k) {
      chroma[k].resize((size_t)cw * (ph / 2));
      const std::vector<uint8_t>& s = ycc[1 + k];
      for (int r = 0; r < ph / 2; ++r) {
        for (int c = 0; c < cw; ++c) {
          size_t i = (size_t)(2 * r) * pw + 2 * c;
          int bias = (c & 1) ? 2 : 1;
          chroma[k][(size_t)r * cw + c] =
              (uint8_t)((s[i] + s[i + 1] + s[i + pw] + s[i + pw + 1] + bias) >> 2);
        }
      }
      cplane[k] = chroma[k].data();
    }
  }
  BitWriter bw;
  bw.buf.reserve((size_t)pw * ph / 2);
  int pred[3] = {0, 0, 0};
  for (int my = 0; my < mcus_y; ++my) {
    for (int mx = 0; mx < mcus_x; ++mx) {
      for (int yb = 0; yb < f; ++yb)
        for (int xb = 0; xb < f; ++xb)
          encode_block(bw, &ycc[0][(size_t)(my * mcu + yb * 8) * pw + mx * mcu + xb * 8],
                       pw, qt, pred[0], hc[0], hc[1]);
      for (int k = 0; k < 2; ++k)
        encode_block(bw, cplane[k] + (size_t)(my * 8) * cstride + mx * 8, cstride,
                     qt + 64, pred[1 + k], hc[2], hc[3]);
    }
  }
  bw.flush();
  if ((long)bw.buf.size() > out_cap) return -1;
  std::memcpy(out, bw.buf.data(), bw.buf.size());
  return (long)bw.buf.size();
}

}  // extern "C"
