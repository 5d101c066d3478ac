// Baseline JPEG encoder for the offline data tools (PVNet conversion),
// writing the bytes `cv2.imwrite(".jpg")` writes with its defaults, i.e.
// what libjpeg-turbo writes after `jpeg_set_defaults` and
// `jpeg_set_quality(q, TRUE)`:
//   * SOI, a JFIF 1.01 APP0 (no density unit, 1 x 1), one DQT per table, SOF0,
//     one DHT per table (luminance DC, AC, then chrominance DC, AC), SOS, the
//     entropy-coded data, EOI; no restart markers;
//   * three components (YCbCr from RGB, `jccolor.c`'s 16-bit fixed-point
//     tables) at 2x2 / 1x1 / 1x1 sampling (4:2:0), or one gray component;
//   * chroma downsampled by `jcsample.c`'s h2v2 box with the alternating
//     1, 2 rounding bias; edges replicated to the block and MCU grid
//     (`expand_right_edge`, `expand_bottom_edge`); blocks past the image in
//     an MCU are the coefficient controller's dummy blocks (zero AC, the DC
//     of the block before them);
//   * the ISLOW forward DCT (`jfdctint.c`: 13 constant bits, 2 pass-1
//     bits) and libjpeg-turbo's reciprocal quantisation (`jcdctmgr.c`
//     `compute_reciprocal` with 16-bit DCT elements);
//   * the standard quantisation tables of Annex K scaled to the quality
//     (clamped to 1..255) and the standard Huffman tables, not optimised;
//     0xFF bytes stuffed, the last byte padded with 1 bits.
//
// C ABI (loaded with ctypes by `cpp/jpeg.py`):
//   int rnnpose_jpeg_encode(pixels, width, height, channels, quality,
//                           out, capacity, &out_len, err, errlen)
// `pixels` is height x width x channels bytes (channels 1 = gray, 3 = RGB);
// returns 0 on success with the file's bytes in out[0 .. out_len).
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct JpegError : std::runtime_error {
  explicit JpegError(const std::string& m) : std::runtime_error(m) {}
};

// zig-zag position -> natural (row-major) position in the 8x8 block
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Annex K.1, natural order.
const int kLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3: code counts per length 1..16, then the symbols.
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffSpec {
  const uint8_t* bits;
  const uint8_t* vals;
  int nvals;
};

// Code and length per symbol (`jpeg_make_c_derived_tbl`).
struct HuffCodes {
  uint32_t code[256] = {};
  int size[256] = {};
  explicit HuffCodes(const HuffSpec& s) {
    uint32_t code_value = 0;
    int k = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < s.bits[len - 1]; ++i, ++k) {
        code[s.vals[k]] = code_value++;
        size[s.vals[k]] = len;
      }
      code_value <<= 1;
    }
  }
};

// Quantisation table at a quality (`jpeg_quality_scaling`,
// `jpeg_add_quant_table` with force_baseline).
void scaled_table(const int* basic, int quality, int* out) {
  quality = std::min(std::max(quality, 1), 100);
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = (static_cast<long>(basic[i]) * scale + 50L) / 100L;
    out[i] = static_cast<int>(std::min(std::max(t, 1L), 255L));
  }
}

// `compute_reciprocal` for a 16-bit DCT element: the quantised value is
// sign(x) * (((|x| + corr) * recip) >> shift).
struct Divisor {
  uint32_t recip, corr;
  int shift;
  explicit Divisor(uint32_t divisor) {
    int b = 31 - __builtin_clz(divisor);  // flss(divisor) - 1
    int r = 16 + b;
    uint32_t fq = static_cast<uint32_t>((1ULL << r) / divisor);
    uint32_t fr = static_cast<uint32_t>((1ULL << r) % divisor);
    uint32_t c = divisor / 2;
    if (fr == 0) {
      fq >>= 1;
      --r;
    } else if (fr <= divisor / 2U) {
      ++c;
    } else {
      ++fq;
    }
    recip = fq;
    corr = c;
    shift = r;
  }
  int quantize(int x) const {
    if (x < 0) return -static_cast<int>(((static_cast<uint32_t>(-x) + corr) * recip) >> shift);
    return static_cast<int>(((static_cast<uint32_t>(x) + corr) * recip) >> shift);
  }
};

// ISLOW forward DCT (`jfdctint.c`), in place on centred samples.
void fdct_islow(int32_t* data) {
  const int kConstBits = 13, kPass1Bits = 2;
  const int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                F2562 = 20995, F3072 = 25172;
  auto descale = [](int64_t x, int n) {
    return static_cast<int32_t>((x + (int64_t{1} << (n - 1))) >> n);
  };
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass == 0 ? 1 : 8;    // along a row, then down a column
    const int stride = pass == 0 ? 8 : 1;  // to the next row / column
    const int odd_shift = pass == 0 ? kConstBits - kPass1Bits : kConstBits + kPass1Bits;
    for (int line = 0; line < 8; ++line) {
      int32_t* d = data + line * stride;
      int64_t tmp0 = d[0] + d[7 * step], tmp7 = d[0] - d[7 * step];
      int64_t tmp1 = d[step] + d[6 * step], tmp6 = d[step] - d[6 * step];
      int64_t tmp2 = d[2 * step] + d[5 * step], tmp5 = d[2 * step] - d[5 * step];
      int64_t tmp3 = d[3 * step] + d[4 * step], tmp4 = d[3 * step] - d[4 * step];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass == 0) {
        d[0] = static_cast<int32_t>((tmp10 + tmp11) * (1 << kPass1Bits));
        d[4 * step] = static_cast<int32_t>((tmp10 - tmp11) * (1 << kPass1Bits));
      } else {
        d[0] = descale(tmp10 + tmp11, kPass1Bits);
        d[4 * step] = descale(tmp10 - tmp11, kPass1Bits);
      }
      int64_t z1 = (tmp12 + tmp13) * F0541;
      d[2 * step] = descale(z1 + tmp13 * F0765, odd_shift);
      d[6 * step] = descale(z1 + tmp12 * -F1847, odd_shift);
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * F1175;
      tmp4 *= F0298;
      tmp5 *= F2053;
      tmp6 *= F3072;
      tmp7 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      d[7 * step] = descale(tmp4 + z1 + z3, odd_shift);
      d[5 * step] = descale(tmp5 + z2 + z4, odd_shift);
      d[3 * step] = descale(tmp6 + z2 + z3, odd_shift);
      d[step] = descale(tmp7 + z1 + z4, odd_shift);
    }
  }
}

class BitWriter {
 public:
  explicit BitWriter(std::vector<uint8_t>& out) : out_(out) {}
  void put(uint32_t code, int size) {
    acc_ = (acc_ << size) | (code & ((1u << size) - 1u));
    nbits_ += size;
    while (nbits_ >= 8) {
      uint8_t byte = static_cast<uint8_t>(acc_ >> (nbits_ - 8));
      out_.push_back(byte);
      if (byte == 0xFF) out_.push_back(0x00);
      nbits_ -= 8;
    }
    acc_ &= (nbits_ ? ((uint64_t{1} << nbits_) - 1) : 0);
  }
  void flush() { put(0x7F, 7); nbits_ = 0; acc_ = 0; }  // pad with 1 bits

 private:
  std::vector<uint8_t>& out_;
  uint64_t acc_ = 0;
  int nbits_ = 0;
};

int nbits_of(int v) {
  int n = 0;
  while (v) { ++n; v >>= 1; }
  return n;
}

struct Component {
  int id, h, v, tq;          // sampling factors, quant table
  const HuffCodes* dc;
  const HuffCodes* ac;
  int bw, bh;                // blocks that hold image samples
  int pw, ph;                // padded plane size in samples
  std::vector<uint8_t> plane;
  int pred = 0;
};

void emit_marker(std::vector<uint8_t>& o, uint8_t m) { o.push_back(0xFF); o.push_back(m); }
void emit_u16(std::vector<uint8_t>& o, int v) {
  o.push_back(static_cast<uint8_t>(v >> 8));
  o.push_back(static_cast<uint8_t>(v & 0xFF));
}

void emit_dht(std::vector<uint8_t>& o, int index, const HuffSpec& s) {
  emit_marker(o, 0xC4);
  emit_u16(o, 2 + 1 + 16 + s.nvals);
  o.push_back(static_cast<uint8_t>(index));
  o.insert(o.end(), s.bits, s.bits + 16);
  o.insert(o.end(), s.vals, s.vals + s.nvals);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

std::vector<uint8_t> encode(const uint8_t* px, int W, int H, int C, int quality) {
  if (W <= 0 || H <= 0 || W > 65535 || H > 65535)
    throw JpegError("image size out of range for baseline JPEG");
  if (C != 1 && C != 3) throw JpegError("channels must be 1 (gray) or 3 (RGB)");
  const bool color = C == 3;
  const int max_h = color ? 2 : 1, max_v = color ? 2 : 1;
  const int mcu_cols = ceil_div(W, 8 * max_h), mcu_rows = ceil_div(H, 8 * max_v);

  int qtab[2][64];
  scaled_table(kLumaQuant, quality, qtab[0]);
  scaled_table(kChromaQuant, quality, qtab[1]);
  static const HuffSpec dc_luma{kDcLumaBits, kDcVals, 12}, ac_luma{kAcLumaBits, kAcLumaVals, 162},
      dc_chroma{kDcChromaBits, kDcVals, 12}, ac_chroma{kAcChromaBits, kAcChromaVals, 162};
  static const HuffCodes dc_luma_c(dc_luma), ac_luma_c(ac_luma), dc_chroma_c(dc_chroma),
      ac_chroma_c(ac_chroma);

  std::vector<Component> comps;
  comps.push_back({1, max_h, max_v, 0, &dc_luma_c, &ac_luma_c, 0, 0, 0, 0, {}});
  if (color) {
    comps.push_back({2, 1, 1, 1, &dc_chroma_c, &ac_chroma_c, 0, 0, 0, 0, {}});
    comps.push_back({3, 1, 1, 1, &dc_chroma_c, &ac_chroma_c, 0, 0, 0, 0, {}});
  }
  for (auto& c : comps) {
    c.bw = ceil_div(W * c.h, max_h * 8);
    c.bh = ceil_div(H * c.v, max_v * 8);
    c.pw = c.bw * 8;
    c.ph = mcu_rows * c.v * 8;
    c.plane.assign(static_cast<size_t>(c.pw) * c.ph, 0);
  }

  // Colour conversion (`jccolor.c`), full resolution.
  std::vector<uint8_t> full[3];
  for (int k = 0; k < C; ++k) full[k].resize(static_cast<size_t>(W) * H);
  if (color) {
    const int32_t kScale = 16, kHalf = 1 << (kScale - 1), kCbCrOff = 128 << kScale;
    auto fix = [](double x) { return static_cast<int32_t>(x * (1 << 16) + 0.5); };
    const int32_t ry = fix(0.29900), gy = fix(0.58700), by = fix(0.11400);
    const int32_t rcb = -fix(0.16874), gcb = -fix(0.33126), bcb = fix(0.5);
    const int32_t rcr = fix(0.5), gcr = -fix(0.41869), bcr = -fix(0.08131);
    for (size_t i = 0; i < static_cast<size_t>(W) * H; ++i) {
      int32_t r = px[3 * i], g = px[3 * i + 1], b = px[3 * i + 2];
      full[0][i] = static_cast<uint8_t>((ry * r + gy * g + by * b + kHalf) >> kScale);
      full[1][i] = static_cast<uint8_t>((rcb * r + gcb * g + bcb * b + kCbCrOff + kHalf - 1)
                                        >> kScale);
      full[2][i] = static_cast<uint8_t>((rcr * r + gcr * g + bcr * b + kCbCrOff + kHalf - 1)
                                        >> kScale);
    }
  } else {
    std::memcpy(full[0].data(), px, static_cast<size_t>(W) * H);
  }
  auto at = [&](int k, int y, int x) {
    return static_cast<int>(full[k][static_cast<size_t>(std::min(y, H - 1)) * W +
                                    std::min(x, W - 1)]);
  };
  // Luma: edges replicated (`fullsize_downsample`, `expand_bottom_edge`).
  for (int y = 0; y < comps[0].ph; ++y)
    for (int x = 0; x < comps[0].pw; ++x)
      comps[0].plane[static_cast<size_t>(y) * comps[0].pw + x] = static_cast<uint8_t>(at(0, y, x));
  // Chroma: `h2v2_downsample` on the edge-replicated input, then the last
  // downsampled row replicated to the MCU grid.
  for (int k = 1; k < C; ++k) {
    Component& c = comps[k];
    const int rows = ceil_div(H, 2);
    for (int y = 0; y < c.ph; ++y) {
      int sy = std::min(y, rows - 1);
      for (int x = 0; x < c.pw; ++x) {
        int sum = at(k, 2 * sy, 2 * x) + at(k, 2 * sy, 2 * x + 1) + at(k, 2 * sy + 1, 2 * x) +
                  at(k, 2 * sy + 1, 2 * x + 1);
        c.plane[static_cast<size_t>(y) * c.pw + x] =
            static_cast<uint8_t>((sum + ((x & 1) ? 2 : 1)) >> 2);
      }
    }
  }

  std::vector<uint8_t> out;
  out.reserve(static_cast<size_t>(W) * H * C / 4 + 1024);
  emit_marker(out, 0xD8);
  emit_marker(out, 0xE0);
  const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  emit_u16(out, 16);
  out.insert(out.end(), jfif, jfif + 14);
  for (int t = 0; t < (color ? 2 : 1); ++t) {
    emit_marker(out, 0xDB);
    emit_u16(out, 67);
    out.push_back(static_cast<uint8_t>(t));
    for (int i = 0; i < 64; ++i) out.push_back(static_cast<uint8_t>(qtab[t][kNatural[i]]));
  }
  emit_marker(out, 0xC0);
  emit_u16(out, 8 + 3 * C);
  out.push_back(8);
  emit_u16(out, H);
  emit_u16(out, W);
  out.push_back(static_cast<uint8_t>(C));
  for (auto& c : comps) {
    out.push_back(static_cast<uint8_t>(c.id));
    out.push_back(static_cast<uint8_t>((c.h << 4) | c.v));
    out.push_back(static_cast<uint8_t>(c.tq));
  }
  emit_dht(out, 0x00, dc_luma);
  emit_dht(out, 0x10, ac_luma);
  if (color) {
    emit_dht(out, 0x01, dc_chroma);
    emit_dht(out, 0x11, ac_chroma);
  }
  emit_marker(out, 0xDA);
  emit_u16(out, 6 + 2 * C);
  out.push_back(static_cast<uint8_t>(C));
  for (int k = 0; k < C; ++k) {
    out.push_back(static_cast<uint8_t>(comps[k].id));
    out.push_back(static_cast<uint8_t>(k == 0 ? 0x00 : 0x11));
  }
  out.push_back(0);
  out.push_back(63);
  out.push_back(0);

  std::vector<Divisor> div[2];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) div[t].emplace_back(static_cast<uint32_t>(qtab[t][i]) << 3);

  BitWriter bits(out);
  auto encode_block = [&](Component& c, const int* q) {
    int diff = q[0] - c.pred;
    c.pred = q[0];
    int mag = diff < 0 ? -diff : diff;
    int n = nbits_of(mag);
    bits.put(c.dc->code[n], c.dc->size[n]);
    if (n) bits.put(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff), n);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int v = q[kNatural[k]];
      if (v == 0) { ++run; continue; }
      while (run > 15) {
        bits.put(c.ac->code[0xF0], c.ac->size[0xF0]);
        run -= 16;
      }
      int m = v < 0 ? -v : v;
      int nb = nbits_of(m);
      int sym = (run << 4) + nb;
      bits.put(c.ac->code[sym], c.ac->size[sym]);
      bits.put(static_cast<uint32_t>(v < 0 ? v - 1 : v), nb);
      run = 0;
    }
    if (run > 0) bits.put(c.ac->code[0x00], c.ac->size[0x00]);
  };

  int32_t work[64];
  int blocks[4][64];
  for (int mr = 0; mr < mcu_rows; ++mr) {
    for (int mc = 0; mc < mcu_cols; ++mc) {
      for (auto& c : comps) {
        const Divisor* d = div[c.tq].data();
        int nb = 0;
        for (int yi = 0; yi < c.v; ++yi) {
          int by = mr * c.v + yi;
          for (int xi = 0; xi < c.h; ++xi, ++nb) {
            int bx = mc * c.h + xi;
            int* q = blocks[nb];
            if (by >= c.bh) {  // a row of dummy blocks below the image
              std::memset(q, 0, sizeof(int) * 64);
              q[0] = blocks[yi * c.h - 1][0];
            } else if (bx >= c.bw) {  // dummy blocks right of the image
              std::memset(q, 0, sizeof(int) * 64);
              q[0] = blocks[nb - 1][0];
            } else {
              for (int y = 0; y < 8; ++y)
                for (int x = 0; x < 8; ++x)
                  work[y * 8 + x] =
                      static_cast<int32_t>(c.plane[static_cast<size_t>(by * 8 + y) * c.pw +
                                                   bx * 8 + x]) - 128;
              fdct_islow(work);
              for (int i = 0; i < 64; ++i) q[i] = d[i].quantize(work[i]);
            }
            encode_block(c, q);
          }
        }
      }
    }
  }
  bits.flush();
  emit_marker(out, 0xD9);
  return out;
}

void set_error(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) {
    std::strncpy(err, msg, static_cast<size_t>(errlen - 1));
    err[errlen - 1] = '\0';
  }
}

}  // namespace

extern "C" {

int rnnpose_jpeg_encode(const uint8_t* pixels, int width, int height, int channels, int quality,
                        uint8_t* out, int64_t capacity, int64_t* out_len, char* err,
                        int errlen) {
  try {
    std::vector<uint8_t> bytes = encode(pixels, width, height, channels, quality);
    if (static_cast<int64_t>(bytes.size()) > capacity)
      throw JpegError("output buffer too small");
    std::memcpy(out, bytes.data(), bytes.size());
    *out_len = static_cast<int64_t>(bytes.size());
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

}  // extern "C"
