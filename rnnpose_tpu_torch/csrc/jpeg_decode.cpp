// Baseline, extended-sequential and progressive Huffman JPEG decoder for
// the host data path (VOC backgrounds, PVNet-format frames), computing what
// libjpeg-turbo computes by default, so the pixels equal `cv2.imread`'s:
//   * entropy decoding of SOF0 / SOF1 / SOF2 8-bit frames, gray or three
//     components, sampling factors 1-4 (integral ratios), restart markers;
//   * the ISLOW integer IDCT (`jidctint.c`: 13 constant bits, 2 pass-1
//     bits, the post-IDCT range-limit table);
//   * fancy upsampling (`jdsample.c`: h2v1, h1v2, h2v2 triangle filters,
//     edges replicated; plain replication where libjpeg uses it);
//   * the fixed-point YCbCr -> RGB tables of `jdcolor.c` (16 bits).
// Progressive files are buffered whole; block smoothing does not apply to a
// completed image (every coefficient refined to bit 0), as libjpeg decides.
// Arithmetic coding, lossless, hierarchical, 12-bit and 4-component files,
// and any corrupt or truncated stream, fail with a message.
//
// C ABI (loaded with ctypes by `cpp/jpeg.py`):
//   int rnnpose_jpeg_info(data, n, &width, &height, &channels, err, errlen)
//   int rnnpose_jpeg_decode(data, n, out, err, errlen)
// Both return 0 on success; `out` holds height x width x channels bytes
// (channels 1 = gray, 3 = RGB).
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

struct Huff {
  bool present = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint8_t look_len[512];  // 9-bit lookahead: code length, 0 = longer
  uint8_t look_val[512];
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int bw = 0, bh = 0;            // blocks of the padded MCU grid
  int real_bw = 0, real_bh = 0;  // blocks a non-interleaved scan covers
  int dw = 0, dh = 0;            // downsampled width and height in samples
  bool latched = false;          // quant table copied at its first scan
  uint16_t q[64];
  std::vector<int16_t> coef;     // bh x bw x 64
  int dc_pred = 0;
  std::vector<int> coef_bits;    // progressive: -1 never seen, else Al
};

class BitReader {
 public:
  BitReader(const uint8_t* d, size_t n, size_t pos) : d_(d), n_(n), pos_(pos) {}
  size_t pos() const { return pos_; }
  bool overrun() const { return overrun_; }
  bool eof() const { return eof_; }

  void fill() {
    while (nbits_ <= 56) {
      uint32_t b = 0;
      if (!stop_) {
        if (pos_ >= n_) {
          stop_ = eof_ = true;
        } else if (d_[pos_] == 0xFF) {
          if (pos_ + 1 >= n_) {
            stop_ = eof_ = true;
          } else if (d_[pos_ + 1] == 0x00) {
            b = 0xFF;
            pos_ += 2;
          } else {
            stop_ = true;  // a marker: stop before it
          }
        } else {
          b = d_[pos_++];
        }
      }
      if (stop_) pad_ += 8;
      acc_ = (acc_ << 8) | b;
      nbits_ += 8;
    }
  }
  uint32_t peek(int k) {
    if (nbits_ < k) fill();
    return static_cast<uint32_t>((acc_ >> (nbits_ - k)) & ((1ull << k) - 1));
  }
  void skip(int k) {
    nbits_ -= k;
    if (nbits_ < pad_) {
      overrun_ = true;
      pad_ = nbits_;
    }
  }
  int bits(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    skip(k);
    return static_cast<int>(v);
  }
  // Drop the buffered bits (a restart interval ends byte-aligned); the
  // caller then moves past the RST marker with set_pos.
  void reset() {
    acc_ = 0;
    nbits_ = 0;
    pad_ = 0;
    stop_ = false;
  }
  void set_pos(size_t p) { pos_ = p; }

 private:
  const uint8_t* d_;
  size_t n_, pos_;
  uint64_t acc_ = 0;
  int nbits_ = 0, pad_ = 0;
  bool stop_ = false, eof_ = false, overrun_ = false;
};

inline int extend(int v, int s) { return (s && v < (1 << (s - 1))) ? v - (1 << s) + 1 : v; }

class Decoder {
 public:
  Decoder(const uint8_t* d, size_t n) : d_(d), n_(n) {}

  void parse_header_only() { run(false); }
  void decode(uint8_t* out) {
    run(true);
    output(out);
  }
  int width() const { return width_; }
  int height() const { return height_; }
  int channels() const { return ncomp_ == 1 ? 1 : 3; }

 private:
  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0;
  int width_ = 0, height_ = 0, ncomp_ = 0;
  bool progressive_ = false, have_frame_ = false;
  int hmax_ = 1, vmax_ = 1, mcus_x_ = 0, mcus_y_ = 0;
  int restart_ = 0;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  uint16_t qt_[4][64];
  bool qt_present_[4] = {false, false, false, false};
  Huff dc_[4], ac_[4];
  Component comp_[3];

  uint8_t byte() {
    if (pos_ >= n_) throw JpegError("truncated file (ended inside a marker segment)");
    return d_[pos_++];
  }
  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  void run(bool decode) {
    if (n_ < 3 || d_[0] != 0xFF || d_[1] != 0xD8) throw JpegError("not a JPEG file (no SOI)");
    pos_ = 2;
    for (;;) {
      // next marker; fill bytes 0xFF may precede it
      if (pos_ >= n_) throw JpegError("truncated file (no EOI marker)");
      if (d_[pos_] != 0xFF) throw JpegError("corrupt data: expected a marker");
      while (pos_ < n_ && d_[pos_] == 0xFF) pos_++;
      int m = byte();
      if (m == 0xD9) {  // EOI
        if (!have_frame_) throw JpegError("no frame before EOI");
        return;
      }
      if (m >= 0xD0 && m <= 0xD7) continue;  // stray RST: skip, as libjpeg does
      if (m == 0x01) continue;               // TEM
      int len = u16();
      if (len < 2 || pos_ + len - 2 > n_)
        throw JpegError("truncated file (marker segment runs past the end)");
      size_t seg_end = pos_ + len - 2;
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2:
          read_sof(m, seg_end);
          if (!decode) return;
          break;
        case 0xC3: throw JpegError("unsupported JPEG: lossless (SOF3)");
        case 0xC5: case 0xC6: case 0xC7:
          throw JpegError("unsupported JPEG: hierarchical (SOF5-7)");
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          throw JpegError("unsupported JPEG: arithmetic coding");
        case 0xC4: read_dht(seg_end); break;
        case 0xDB: read_dqt(seg_end); break;
        case 0xDD:
          if (len != 4) throw JpegError("corrupt DRI segment");
          restart_ = (d_[pos_] << 8) | d_[pos_ + 1];
          break;
        case 0xDA:
          if (!have_frame_) throw JpegError("SOS before the frame header");
          read_sos_and_scan(seg_end);
          continue;  // the scan moved pos_ to the next marker
        case 0xDC: throw JpegError("unsupported JPEG: DNL marker");
        case 0xE0:
          if (len >= 16 && memcmp(d_ + pos_, "JFIF\0", 5) == 0) jfif_ = true;
          break;
        case 0xEE:
          if (len >= 14 && memcmp(d_ + pos_, "Adobe", 5) == 0) {
            adobe_ = true;
            adobe_transform_ = d_[pos_ + 11];
          }
          break;
        default:
          if (m < 0xC0) throw JpegError("corrupt data: unknown marker");
          break;  // APPn, COM and others: skipped
      }
      pos_ = seg_end;
    }
  }

  void read_sof(int m, size_t seg_end) {
    if (have_frame_) throw JpegError("corrupt data: a second frame header");
    progressive_ = (m == 0xC2);
    int precision = byte();
    height_ = u16();
    width_ = u16();
    ncomp_ = byte();
    if (precision != 8) throw JpegError("unsupported JPEG: " + std::to_string(precision) + "-bit samples");
    if (height_ == 0) throw JpegError("unsupported JPEG: height 0 (defined by DNL)");
    if (width_ == 0) throw JpegError("corrupt frame header: width 0");
    if (ncomp_ == 4) throw JpegError("unsupported JPEG: 4 components (CMYK/YCCK)");
    if (ncomp_ != 1 && ncomp_ != 3)
      throw JpegError("unsupported JPEG: " + std::to_string(ncomp_) + " components");
    if (pos_ + 3 * ncomp_ > seg_end) throw JpegError("corrupt frame header");
    hmax_ = vmax_ = 1;
    for (int i = 0; i < ncomp_; ++i) {
      Component& c = comp_[i];
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        throw JpegError("corrupt frame header: sampling factors or table index");
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    if (ncomp_ == 1) {  // one component: the MCU is one block whatever it declares
      comp_[0].h = comp_[0].v = hmax_ = vmax_ = 1;
    }
    mcus_x_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcus_y_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
    for (int i = 0; i < ncomp_; ++i) {
      Component& c = comp_[i];
      if (hmax_ % c.h || vmax_ % c.v)
        throw JpegError("unsupported JPEG: fractional sampling ratios");
      c.dw = static_cast<int>((static_cast<long>(width_) * c.h + hmax_ - 1) / hmax_);
      c.dh = static_cast<int>((static_cast<long>(height_) * c.v + vmax_ - 1) / vmax_);
      c.real_bw = (c.dw + 7) / 8;
      c.real_bh = (c.dh + 7) / 8;
      c.bw = mcus_x_ * c.h;
      c.bh = mcus_y_ * c.v;
      c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
      c.coef_bits.assign(64, -1);
    }
    have_frame_ = true;
  }

  void read_dqt(size_t seg_end) {
    while (pos_ < seg_end) {
      int pq_tq = byte();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) throw JpegError("corrupt DQT segment");
      for (int k = 0; k < 64; ++k) qt_[tq][kNatural[k]] = static_cast<uint16_t>(pq ? u16() : byte());
      qt_present_[tq] = true;
    }
    if (pos_ != seg_end) throw JpegError("corrupt DQT segment length");
  }

  void read_dht(size_t seg_end) {
    while (pos_ < seg_end) {
      int tc_th = byte();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) throw JpegError("corrupt DHT segment");
      uint8_t counts[17];
      int total = 0;
      for (int l = 1; l <= 16; ++l) total += counts[l] = byte();
      if (total > 256 || pos_ + total > seg_end) throw JpegError("corrupt DHT segment");
      Huff& hf = tc ? ac_[th] : dc_[th];
      for (int i = 0; i < total; ++i) {
        hf.vals[i] = byte();
        if (!tc && hf.vals[i] > 15) throw JpegError("corrupt DHT segment: DC symbol > 15");
      }
      // canonical codes (jdhuff.c jpeg_make_d_derived_tbl)
      int code = 0, k = 0;
      memset(hf.look_len, 0, sizeof(hf.look_len));
      for (int l = 1; l <= 16; ++l) {
        if (counts[l]) {
          hf.valoffset[l] = k - code;
          for (int i = 0; i < counts[l]; ++i, ++k, ++code) {
            if (l <= 9) {
              int shift = 9 - l;
              for (int f = 0; f < (1 << shift); ++f) {
                hf.look_len[(code << shift) | f] = static_cast<uint8_t>(l);
                hf.look_val[(code << shift) | f] = hf.vals[k];
              }
            }
          }
          hf.maxcode[l] = code - 1;
          if (code >= (1 << l)) throw JpegError("corrupt DHT segment: bad code lengths");
        } else {
          hf.maxcode[l] = -1;
        }
        code <<= 1;
      }
      hf.maxcode[17] = 0x7FFFFFFF;
      hf.present = true;
    }
    if (pos_ != seg_end) throw JpegError("corrupt DHT segment length");
  }

  static int decode_huff(BitReader& br, const Huff& hf) {
    uint32_t look = br.peek(16);
    uint32_t idx = look >> 7;
    int l = hf.look_len[idx];
    if (l) {
      br.skip(l);
      return hf.look_val[idx];
    }
    for (l = 10; l <= 16; ++l) {
      int32_t code = static_cast<int32_t>(look >> (16 - l));
      if (code <= hf.maxcode[l]) {
        br.skip(l);
        return hf.vals[hf.valoffset[l] + code];
      }
    }
    throw JpegError("corrupt data: bad Huffman code");
  }

  struct Scan {
    int ns;
    Component* c[4];
    int ss, se, ah, al;
  };

  void read_sos_and_scan(size_t seg_end) {
    Scan sc;
    sc.ns = byte();
    if (sc.ns < 1 || sc.ns > ncomp_ || pos_ + 2 * sc.ns + 3 > seg_end)
      throw JpegError("corrupt SOS segment");
    for (int i = 0; i < sc.ns; ++i) {
      int cid = byte(), t = byte();
      Component* found = nullptr;
      for (int j = 0; j < ncomp_; ++j)
        if (comp_[j].id == cid) found = &comp_[j];
      if (!found) throw JpegError("corrupt SOS segment: unknown component");
      for (int j = 0; j < i; ++j)
        if (sc.c[j] == found) throw JpegError("corrupt SOS segment: repeated component");
      found->td = t >> 4;
      found->ta = t & 15;
      if (found->td > 3 || found->ta > 3) throw JpegError("corrupt SOS segment: table index");
      sc.c[i] = found;
    }
    sc.ss = byte();
    sc.se = byte();
    int a = byte();
    sc.ah = a >> 4;
    sc.al = a & 15;
    pos_ = seg_end;
    if (progressive_) {
      if (sc.ss == 0 ? sc.se != 0 : (sc.se < sc.ss || sc.se > 63 || sc.ns != 1))
        throw JpegError("corrupt progressive scan parameters");
      if (sc.ah > 13 || sc.al > 13) throw JpegError("corrupt progressive scan parameters");
    } else if (sc.ss != 0 || sc.se != 63 || sc.ah != 0 || sc.al != 0) {
      throw JpegError("corrupt sequential scan parameters");
    }
    // Tables the scan needs, and the quant tables latched at first use.
    for (int i = 0; i < sc.ns; ++i) {
      Component* c = sc.c[i];
      bool needs_dc = sc.ss == 0 && sc.ah == 0;
      bool needs_ac = sc.se > 0;
      if ((needs_dc && !dc_[c->td].present) || (needs_ac && !ac_[c->ta].present))
        throw JpegError("corrupt data: a scan uses an undefined Huffman table");
      if (!c->latched) {
        if (!qt_present_[c->tq]) throw JpegError("corrupt data: undefined quantization table");
        memcpy(c->q, qt_[c->tq], sizeof(c->q));
        c->latched = true;
      }
      if (progressive_) {
        for (int k = sc.ss; k <= sc.se; ++k) {
          int expect = sc.ah == 0 ? -1 : sc.ah;
          if (sc.ss > 0 && c->coef_bits[0] < 0)
            throw JpegError("corrupt progression: AC scan before the DC scan");
          if (c->coef_bits[k] != expect && !(sc.ah == 0 && c->coef_bits[k] < 0))
            throw JpegError("corrupt progression: successive approximation out of order");
          c->coef_bits[k] = sc.al;
        }
      }
      c->dc_pred = 0;
    }
    BitReader br(d_, n_, pos_);
    try {
      decode_scan(sc, br);
    } catch (const JpegError& e) {
      // zero bits past the end of a cut file decode as garbage first
      if (br.eof() && std::string(e.what()).rfind("truncated", 0) != 0)
        throw JpegError(std::string("truncated file (") + e.what() + ")");
      throw;
    }
  }

  void decode_scan(const Scan& sc, BitReader& br) {
    int eobrun = 0;
    long total_mcus;
    int mx = 0;
    if (sc.ns == 1) {
      mx = sc.c[0]->real_bw;
      total_mcus = static_cast<long>(sc.c[0]->real_bw) * sc.c[0]->real_bh;
    } else {
      mx = mcus_x_;
      total_mcus = static_cast<long>(mcus_x_) * mcus_y_;
    }
    int todo = restart_;
    int next_rst = 0;
    for (long m = 0; m < total_mcus; ++m) {
      if (restart_ && todo == 0) {
        // interval end: byte-align, expect RSTn, reset the predictors
        if (br.overrun()) throw JpegError(br.eof() ? "truncated file" : "corrupt data");
        size_t p = br.pos();
        while (p < n_ && d_[p] == 0xFF && p + 1 < n_ && d_[p + 1] == 0xFF) ++p;
        if (p + 1 >= n_) throw JpegError("truncated file");
        if (d_[p] != 0xFF || d_[p + 1] != 0xD0 + next_rst)
          throw JpegError("corrupt data: restart marker missing");
        br.reset();
        br.set_pos(p + 2);
        next_rst = (next_rst + 1) & 7;
        todo = restart_;
        eobrun = 0;
        for (int i = 0; i < sc.ns; ++i) sc.c[i]->dc_pred = 0;
      }
      if (sc.ns == 1) {
        Component* c = sc.c[0];
        int by = static_cast<int>(m / mx), bx = static_cast<int>(m % mx);
        decode_block(br, sc, c, &c->coef[(static_cast<size_t>(by) * c->bw + bx) * 64], eobrun);
      } else {
        int my = static_cast<int>(m / mx), mxx = static_cast<int>(m % mx);
        for (int i = 0; i < sc.ns; ++i) {
          Component* c = sc.c[i];
          for (int v = 0; v < c->v; ++v)
            for (int h = 0; h < c->h; ++h) {
              int by = my * c->v + v, bx = mxx * c->h + h;
              decode_block(br, sc, c, &c->coef[(static_cast<size_t>(by) * c->bw + bx) * 64],
                           eobrun);
            }
        }
      }
      if (restart_) --todo;
    }
    if (br.overrun()) throw JpegError(br.eof() ? "truncated file" : "corrupt data");
    // move to the marker after the scan
    size_t p = br.pos();
    while (p + 1 < n_ && !(d_[p] == 0xFF && d_[p + 1] != 0x00 &&
                           !(d_[p + 1] >= 0xD0 && d_[p + 1] <= 0xD7) && d_[p + 1] != 0xFF))
      ++p;
    if (p + 1 >= n_) throw JpegError("truncated file (the scan has no end marker)");
    pos_ = p;
  }

  void decode_block(BitReader& br, const Scan& sc, Component* c, int16_t* blk, int& eobrun) {
    if (!progressive_) {
      int s = decode_huff(br, dc_[c->td]);
      if (s > 16) throw JpegError("corrupt data: DC magnitude");
      int diff = s ? extend(br.bits(s), s) : 0;
      c->dc_pred += diff;
      blk[0] = static_cast<int16_t>(c->dc_pred);
      const Huff& ac = ac_[c->ta];
      for (int k = 1; k < 64; ++k) {
        int rs = decode_huff(br, ac);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          if (k > 63) throw JpegError("corrupt data: AC run past the block");
          blk[kNatural[k]] = static_cast<int16_t>(extend(br.bits(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (sc.ss == 0) {
      if (sc.ah == 0) {  // DC first
        int s = decode_huff(br, dc_[c->td]);
        if (s > 16) throw JpegError("corrupt data: DC magnitude");
        int diff = s ? extend(br.bits(s), s) : 0;
        c->dc_pred += diff;
        blk[0] = static_cast<int16_t>(static_cast<unsigned>(c->dc_pred) << sc.al);
      } else if (br.bits(1)) {  // DC refine
        blk[0] = static_cast<int16_t>(blk[0] | (1 << sc.al));
      }
      return;
    }
    const Huff& ac = ac_[c->ta];
    if (sc.ah == 0) {  // AC first
      if (eobrun > 0) {
        --eobrun;
        return;
      }
      for (int k = sc.ss; k <= sc.se; ++k) {
        int rs = decode_huff(br, ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          if (k > 63) throw JpegError("corrupt data: AC run past the block");
          blk[kNatural[k]] =
              static_cast<int16_t>(static_cast<unsigned>(extend(br.bits(s), s)) << sc.al);
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
    // AC refine (jdphuff.c decode_mcu_AC_refine)
    int p1 = 1 << sc.al, m1 = -1 * (1 << sc.al);
    int k = sc.ss;
    if (eobrun == 0) {
      for (; k <= sc.se; ++k) {
        int rs = decode_huff(br, ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) throw JpegError("corrupt data: refinement magnitude");
          s = br.bits(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (br.bits(1) && (*coef & p1) == 0)
              *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= sc.se);
        if (s) {
          if (k > 63) throw JpegError("corrupt data: AC run past the block");
          blk[kNatural[k]] = static_cast<int16_t>(s);
        }
      }
    }
    if (eobrun > 0) {
      for (; k <= sc.se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0 && br.bits(1) && (*coef & p1) == 0)
          *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
      }
      --eobrun;
    }
  }

  // ---- reconstruction ----

  struct RangeLimit {
    uint8_t t[1024];
    RangeLimit() {
      for (int i = 0; i < 1024; ++i)
        t[i] = static_cast<uint8_t>(i < 128 ? i + 128 : i < 512 ? 255 : i < 896 ? 0 : i - 896);
    }
  };

  // The post-IDCT part of libjpeg's sample_range_limit table, indexed by
  // (value & 1023) where value is the centred sample. A function-local
  // static: initialised once, thread-safely (the loader threads decode at
  // once, ctypes releases the GIL).
  static const uint8_t* idct_limit() {
    static const RangeLimit limit;
    return limit.t;
  }

  struct YccTables {  // jdcolor.c build_ycc_rgb_table, SCALEBITS 16
    int cr_r[256], cb_b[256];
    long cr_g[256], cb_g[256];
    YccTables() {
      const long one_half = 1L << 15;
      auto fix = [](double x) { return static_cast<long>(x * 65536.0 + 0.5); };
      for (int i = 0; i < 256; ++i) {
        long x = i - 128;
        cr_r[i] = static_cast<int>((fix(1.40200) * x + one_half) >> 16);
        cb_b[i] = static_cast<int>((fix(1.77200) * x + one_half) >> 16);
        cr_g[i] = -fix(0.71414) * x;
        cb_g[i] = -fix(0.34414) * x + one_half;
      }
    }
  };

  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    typedef long JLONG;
    const int CB = 13, P1 = 2;
    const JLONG F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270, F0_899 = 7373,
                F1_175 = 9633, F1_501 = 12299, F1_847 = 15137, F1_961 = 16069,
                F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;
    auto descale = [](JLONG x, int n) { return (x + (static_cast<JLONG>(1) << (n - 1))) >> n; };
    const uint8_t* lim = idct_limit();
    int ws[64];
    for (int c = 0; c < 8; ++c) {
      const int16_t* ip = in + c;
      const uint16_t* qp = q + c;
      int* wp = ws + c;
      if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
        int dc = static_cast<int>(static_cast<JLONG>(ip[0]) * qp[0]) * (1 << P1);
        for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
        continue;
      }
      JLONG z2 = static_cast<JLONG>(ip[16]) * qp[16], z3 = static_cast<JLONG>(ip[48]) * qp[48];
      JLONG z1 = (z2 + z3) * F0_541;
      JLONG tmp2 = z1 + z3 * (-F1_847);
      JLONG tmp3 = z1 + z2 * F0_765;
      z2 = static_cast<JLONG>(ip[0]) * qp[0];
      z3 = static_cast<JLONG>(ip[32]) * qp[32];
      JLONG tmp0 = (z2 + z3) * (1 << CB), tmp1 = (z2 - z3) * (1 << CB);
      JLONG tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = static_cast<JLONG>(ip[56]) * qp[56];
      tmp1 = static_cast<JLONG>(ip[40]) * qp[40];
      tmp2 = static_cast<JLONG>(ip[24]) * qp[24];
      tmp3 = static_cast<JLONG>(ip[8]) * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      JLONG z4 = tmp1 + tmp3;
      JLONG z5 = (z3 + z4) * F1_175;
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
      wp[0] = static_cast<int>(descale(tmp10 + tmp3, CB - P1));
      wp[56] = static_cast<int>(descale(tmp10 - tmp3, CB - P1));
      wp[8] = static_cast<int>(descale(tmp11 + tmp2, CB - P1));
      wp[48] = static_cast<int>(descale(tmp11 - tmp2, CB - P1));
      wp[16] = static_cast<int>(descale(tmp12 + tmp1, CB - P1));
      wp[40] = static_cast<int>(descale(tmp12 - tmp1, CB - P1));
      wp[24] = static_cast<int>(descale(tmp13 + tmp0, CB - P1));
      wp[32] = static_cast<int>(descale(tmp13 - tmp0, CB - P1));
    }
    for (int r = 0; r < 8; ++r) {
      const int* wp = ws + 8 * r;
      uint8_t* op = out + static_cast<long>(r) * stride;
      if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
        uint8_t v = lim[static_cast<int>(descale(wp[0], P1 + 3)) & 1023];
        for (int c = 0; c < 8; ++c) op[c] = v;
        continue;
      }
      JLONG z2 = wp[2], z3 = wp[6];
      JLONG z1 = (z2 + z3) * F0_541;
      JLONG tmp2 = z1 + z3 * (-F1_847);
      JLONG tmp3 = z1 + z2 * F0_765;
      JLONG tmp0 = (static_cast<JLONG>(wp[0]) + wp[4]) * (1 << CB);
      JLONG tmp1 = (static_cast<JLONG>(wp[0]) - wp[4]) * (1 << CB);
      JLONG tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = wp[7];
      tmp1 = wp[5];
      tmp2 = wp[3];
      tmp3 = wp[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      JLONG z4 = tmp1 + tmp3;
      JLONG z5 = (z3 + z4) * F1_175;
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
      const int n = CB + P1 + 3;
      op[0] = lim[static_cast<int>(descale(tmp10 + tmp3, n)) & 1023];
      op[7] = lim[static_cast<int>(descale(tmp10 - tmp3, n)) & 1023];
      op[1] = lim[static_cast<int>(descale(tmp11 + tmp2, n)) & 1023];
      op[6] = lim[static_cast<int>(descale(tmp11 - tmp2, n)) & 1023];
      op[2] = lim[static_cast<int>(descale(tmp12 + tmp1, n)) & 1023];
      op[5] = lim[static_cast<int>(descale(tmp12 - tmp1, n)) & 1023];
      op[3] = lim[static_cast<int>(descale(tmp13 + tmp0, n)) & 1023];
      op[4] = lim[static_cast<int>(descale(tmp13 - tmp0, n)) & 1023];
    }
  }

  // The component's samples upsampled to the full image size (W x H).
  std::vector<uint8_t> full_plane(const Component& c) {
    const int pw = c.bw * 8, ph = c.bh * 8;
    std::vector<uint8_t> plane(static_cast<size_t>(pw) * ph);
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(&c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64], c.q,
                   &plane[static_cast<size_t>(by) * 8 * pw + bx * 8], pw);
    const int rh = hmax_ / c.h, rv = vmax_ / c.v;
    const int W = width_, H = height_, dw = c.dw, dh = c.dh;
    std::vector<uint8_t> out(static_cast<size_t>(W) * H);
    auto s = [&](int y, int x) -> int {
      y = std::min(std::max(y, 0), dh - 1);
      x = std::min(std::max(x, 0), dw - 1);
      return plane[static_cast<size_t>(y) * pw + x];
    };
    for (int y = 0; y < H; ++y) {
      uint8_t* o = &out[static_cast<size_t>(y) * W];
      if (rh == 1 && rv == 1) {
        for (int x = 0; x < W; ++x) o[x] = static_cast<uint8_t>(s(y, x));
      } else if (rh == 2 && rv == 1 && dw > 2) {  // h2v1_fancy_upsample
        for (int x = 0; x < W; ++x) {
          int j = x >> 1, t = 3 * s(y, j);
          o[x] = static_cast<uint8_t>((x & 1) ? (t + s(y, j + 1) + 2) >> 2
                                              : (t + s(y, j - 1) + 1) >> 2);
        }
      } else if (rh == 1 && rv == 2) {  // h1v2_fancy_upsample
        int i = y >> 1, near = (y & 1) ? i + 1 : i - 1, bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < W; ++x)
          o[x] = static_cast<uint8_t>((3 * s(i, x) + s(near, x) + bias) >> 2);
      } else if (rh == 2 && rv == 2 && dw > 2) {  // h2v2_fancy_upsample
        int i = y >> 1, near = (y & 1) ? i + 1 : i - 1;
        for (int x = 0; x < W; ++x) {
          int j = x >> 1;
          int cs = 3 * s(i, j) + s(near, j);
          o[x] = static_cast<uint8_t>(
              (x & 1) ? (3 * cs + 3 * s(i, j + 1) + s(near, j + 1) + 7) >> 4
                      : (3 * cs + 3 * s(i, j - 1) + s(near, j - 1) + 8) >> 4);
        }
      } else {  // plain replication (h2v1_upsample, h2v2_upsample, int_upsample)
        for (int x = 0; x < W; ++x) o[x] = static_cast<uint8_t>(s(y / rv, x / rh));
      }
    }
    return out;
  }

  void output(uint8_t* out) {
    if (progressive_) {
      for (int i = 0; i < ncomp_; ++i)
        if (comp_[i].coef_bits[0] < 0) throw JpegError("truncated file (a component has no DC scan)");
    }
    for (int i = 0; i < ncomp_; ++i)
      if (!comp_[i].latched) throw JpegError("truncated file (a component has no scan)");
    const size_t npix = static_cast<size_t>(width_) * height_;
    if (ncomp_ == 1) {
      std::vector<uint8_t> g = full_plane(comp_[0]);
      memcpy(out, g.data(), npix);
      return;
    }
    std::vector<uint8_t> p0 = full_plane(comp_[0]), p1 = full_plane(comp_[1]),
                         p2 = full_plane(comp_[2]);
    bool rgb;
    if (jfif_) {
      rgb = false;
    } else if (adobe_) {
      rgb = adobe_transform_ == 0;
    } else {
      rgb = comp_[0].id == 82 && comp_[1].id == 71 && comp_[2].id == 66;
    }
    if (rgb) {
      for (size_t k = 0; k < npix; ++k) {
        out[3 * k] = p0[k];
        out[3 * k + 1] = p1[k];
        out[3 * k + 2] = p2[k];
      }
      return;
    }
    static const YccTables ycc;
    auto clamp = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); };
    for (size_t k = 0; k < npix; ++k) {
      int y = p0[k], cb = p1[k], cr = p2[k];
      out[3 * k] = clamp(y + ycc.cr_r[cr]);
      out[3 * k + 1] = clamp(y + static_cast<int>((ycc.cb_g[cb] + ycc.cr_g[cr]) >> 16));
      out[3 * k + 2] = clamp(y + ycc.cb_b[cb]);
    }
  }
};

void set_error(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) {
    strncpy(err, msg, static_cast<size_t>(errlen) - 1);
    err[errlen - 1] = '\0';
  }
}

}  // namespace

extern "C" {

int rnnpose_jpeg_info(const uint8_t* data, int64_t n, int* width, int* height, int* channels,
                      char* err, int errlen) {
  try {
    Decoder dec(data, static_cast<size_t>(n));
    dec.parse_header_only();
    *width = dec.width();
    *height = dec.height();
    *channels = dec.channels();
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

int rnnpose_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, char* err, int errlen) {
  try {
    Decoder dec(data, static_cast<size_t>(n));
    dec.decode(out);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

}  // extern "C"
