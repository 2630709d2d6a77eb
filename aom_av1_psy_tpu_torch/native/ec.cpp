// Native od_ec range coder — the serial hot path of the codec runtime.
//
// Same normative semantics as ec/coder.py (aom_dsp/entenc.c / entdec.c):
// 64-bit low window encoder with carry propagation, 32-bit dif window
// decoder, Q15 inverse-CDF convention, update_cdf adaptation. Exposed via a
// plain C ABI for ctypes; CDF arrays are updated in place in caller memory
// (numpy uint16 buffers), so the Python and native paths are interchangeable.
//
// Build: g++ -O2 -shared -fPIC ec.cpp -o libaomtpu_ec.so
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kCdfProbTop = 1 << 15;
constexpr int kProbShift = 6;
constexpr int kMinProb = 4;

inline void update_cdf(uint16_t *cdf, int val, int nsymbs) {
  const int count = cdf[nsymbs];
  const int rate = 4 + (count >> 4) + (nsymbs > 3);
  for (int i = 0; i < nsymbs - 1; ++i) {
    if (i < val) {
      cdf[i] += (kCdfProbTop - cdf[i]) >> rate;
    } else {
      cdf[i] -= cdf[i] >> rate;
    }
  }
  cdf[nsymbs] += (count < 32);
}

struct Encoder {
  std::vector<uint8_t> buf;
  uint64_t low = 0;
  unsigned rng = 0x8000;
  int cnt = -9;
  bool allow_update = true;

  void carry(size_t idx) {
    for (;;) {
      const int s = buf[idx] + 1;
      buf[idx] = static_cast<uint8_t>(s);
      if (s < 256) return;
      --idx;
    }
  }

  void normalize(uint64_t low_v, unsigned rng_v) {
    int d = 16;
    for (unsigned r = rng_v; r; r >>= 1) --d;
    int s = cnt + d;
    if (s >= 40) {
      int c = cnt;
      const int nbr = (s >> 3) + 1;
      c += 24 - (nbr << 3);
      uint64_t output = low_v >> c;
      low_v &= (uint64_t(1) << c) - 1;
      const uint64_t mask = uint64_t(1) << (nbr << 3);
      const bool has_carry = (output & mask) != 0;
      output &= mask - 1;
      const size_t pre = buf.size();
      for (int i = nbr - 1; i >= 0; --i)
        buf.push_back(static_cast<uint8_t>(output >> (8 * i)));
      if (has_carry) carry(pre - 1);
      s = c + d - 24;
    }
    low = low_v << d;
    rng = rng_v << d;
    cnt = s;
  }

  void encode_q15(unsigned fl, unsigned fh, int sym, int nsyms) {
    uint64_t l = low;
    unsigned r = rng;
    const int n = nsyms - 1;
    if (fl < kCdfProbTop) {
      const unsigned u = ((r >> 8) * (fl >> kProbShift) >> (7 - kProbShift)) +
                         kMinProb * (n - (sym - 1));
      const unsigned v = ((r >> 8) * (fh >> kProbShift) >> (7 - kProbShift)) +
                         kMinProb * (n - sym);
      l += r - u;
      r = u - v;
    } else {
      r -= ((r >> 8) * (fh >> kProbShift) >> (7 - kProbShift)) +
           kMinProb * (n - sym);
    }
    normalize(l, r);
  }

  void encode_symbol(int sym, uint16_t *icdf, int nsyms) {
    const unsigned fl = sym > 0 ? icdf[sym - 1] : kCdfProbTop;
    encode_q15(fl, icdf[sym], sym, nsyms);
    if (allow_update) update_cdf(icdf, sym, nsyms);
  }

  void encode_bool_q15(int val, unsigned f) {
    uint64_t l = low;
    unsigned r = rng;
    const unsigned v =
        ((r >> 8) * (f >> kProbShift) >> (7 - kProbShift)) + kMinProb;
    if (val) {
      l += r - v;
      r = v;
    } else {
      r -= v;
    }
    normalize(l, r);
  }

  void write_bit(int bit) {
    encode_bool_q15(bit, (0x7FFFFF - (128 << 15) + 128) >> 8);
  }

  void write_literal(unsigned data, int bits) {
    for (int b = bits - 1; b >= 0; --b) write_bit((data >> b) & 1);
  }

  size_t done() {
    uint64_t l = low;
    int c = cnt;
    int s = 10 + c;
    const uint64_t m = 0x3FFF;
    uint64_t e = ((l + m) & ~m) | (m + 1);
    if (s > 0) {
      uint64_t n = (uint64_t(1) << (c + 16)) - 1;
      do {
        const unsigned val = static_cast<unsigned>(e >> (c + 16)) & 0xFFFF;
        buf.push_back(static_cast<uint8_t>(val & 0xFF));
        if (val & 0x100) carry(buf.size() - 2);
        e &= n;
        s -= 8;
        c -= 8;
        n >>= 8;
      } while (s > 0);
    }
    return buf.size();
  }
};

struct Decoder {
  const uint8_t *buf = nullptr;
  size_t bptr = 0;
  size_t end = 0;
  int tell_offs = 10 - (32 - 8);
  uint32_t dif = (1u << 31) - 1;
  unsigned rng = 0x8000;
  int cnt = -15;
  bool allow_update = true;

  void refill() {
    int s = 32 - 9 - (cnt + 15);
    while (s >= 0 && bptr < end) {
      dif ^= static_cast<uint32_t>(buf[bptr]) << s;
      cnt += 8;
      ++bptr;
      s -= 8;
    }
    if (bptr >= end) {
      tell_offs += 0x4000 - cnt;
      cnt = 0x4000;
    }
  }

  int normalize(uint32_t dif_v, unsigned rng_v, int ret) {
    int d = 16;
    for (unsigned r = rng_v; r; r >>= 1) --d;
    cnt -= d;
    dif = ((dif_v + 1) << d) - 1;
    rng = rng_v << d;
    if (cnt < 0) refill();
    return ret;
  }

  int decode_cdf(const uint16_t *icdf, int nsyms) {
    uint32_t dif_v = dif;
    unsigned r = rng;
    const int n = nsyms - 1;
    const unsigned c = dif_v >> 16;
    unsigned v = r;
    int ret = -1;
    unsigned u;
    do {
      u = v;
      ++ret;
      v = ((r >> 8) * (unsigned(icdf[ret]) >> kProbShift) >> (7 - kProbShift)) +
          kMinProb * (n - ret);
    } while (c < v);
    r = u - v;
    dif_v -= v << 16;
    return normalize(dif_v, r, ret);
  }

  int decode_symbol(uint16_t *icdf, int nsyms) {
    const int ret = decode_cdf(icdf, nsyms);
    if (allow_update) update_cdf(icdf, ret, nsyms);
    return ret;
  }

  int decode_bool_q15(unsigned f) {
    uint32_t dif_v = dif;
    unsigned r = rng;
    const unsigned v =
        ((r >> 8) * (f >> kProbShift) >> (7 - kProbShift)) + kMinProb;
    const uint32_t vw = v << 16;
    int ret = 1;
    unsigned r_new = v;
    if (dif_v >= vw) {
      r_new = r - v;
      dif_v -= vw;
      ret = 0;
    }
    return normalize(dif_v, r_new, ret);
  }

  int read_bit() {
    return decode_bool_q15((0x7FFFFF - (128 << 15) + 128) >> 8);
  }

  unsigned read_literal(int bits) {
    unsigned v = 0;
    for (int b = bits - 1; b >= 0; --b) v |= unsigned(read_bit()) << b;
    return v;
  }
};

}  // namespace

extern "C" {

Encoder *ec_enc_new() { return new Encoder(); }
void ec_enc_free(Encoder *e) { delete e; }
void ec_enc_set_allow_update(Encoder *e, int v) { e->allow_update = v != 0; }
void ec_enc_symbol(Encoder *e, int sym, uint16_t *icdf, int nsyms) {
  e->encode_symbol(sym, icdf, nsyms);
}
void ec_enc_cdf(Encoder *e, int sym, const uint16_t *icdf, int nsyms) {
  const unsigned fl = sym > 0 ? icdf[sym - 1] : kCdfProbTop;
  e->encode_q15(fl, icdf[sym], sym, nsyms);
}
void ec_enc_bit(Encoder *e, int bit) { e->write_bit(bit); }
void ec_enc_literal(Encoder *e, unsigned v, int bits) {
  e->write_literal(v, bits);
}
long ec_enc_done(Encoder *e) { return static_cast<long>(e->done()); }
long ec_enc_size(Encoder *e) { return static_cast<long>(e->buf.size()); }
void ec_enc_copy(Encoder *e, uint8_t *dst) {
  std::memcpy(dst, e->buf.data(), e->buf.size());
}
long ec_enc_tell(Encoder *e) {
  return e->cnt + 10 + static_cast<long>(e->buf.size()) * 8;
}

Decoder *ec_dec_new(const uint8_t *data, long size) {
  Decoder *d = new Decoder();
  d->buf = data;
  d->end = static_cast<size_t>(size);
  d->refill();
  return d;
}
void ec_dec_free(Decoder *d) { delete d; }
void ec_dec_set_allow_update(Decoder *d, int v) { d->allow_update = v != 0; }
int ec_dec_symbol(Decoder *d, uint16_t *icdf, int nsyms) {
  return d->decode_symbol(icdf, nsyms);
}
int ec_dec_cdf(Decoder *d, const uint16_t *icdf, int nsyms) {
  return d->decode_cdf(icdf, nsyms);
}
int ec_dec_bit(Decoder *d) { return d->read_bit(); }
unsigned ec_dec_literal(Decoder *d, int bits) { return d->read_literal(bits); }
long ec_dec_tell(Decoder *d) {
  return static_cast<long>(d->bptr) * 8 - d->cnt + d->tell_offs;
}

// ---------------------------------------------------------------------------
// Batched coefficient coding — the per-txb base/br/sign/golomb loops of
// av1_write_coeffs_txb in one native call (mirrors ec/coeffs.py, which is
// the bit-exactness reference; python keeps writing the txb_skip/tx_type/
// eob prefix symbols). Context derivation per av1/common/txb_common.h.
// ---------------------------------------------------------------------------

namespace {

constexpr int kTxPadHor = 4;
constexpr int kNumBaseLevels = 2;
constexpr int kCoeffBaseRange = 12;
constexpr int kBrCdfSize = 4;

inline int clip3(int v) { return v < 3 ? v : 3; }

inline int get_nz_mag(const uint8_t *b, int p, int bhl, int tx_class) {
  const int s = (1 << bhl) + kTxPadHor;
  int mag = clip3(b[p + s]) + clip3(b[p + 1]);
  if (tx_class == 0) {
    mag += clip3(b[p + s + 1]) + clip3(b[p + 2 * s]) + clip3(b[p + 2]);
  } else if (tx_class == 2) {
    mag += clip3(b[p + 2]) + clip3(b[p + 3]) + clip3(b[p + 4]);
  } else {
    mag += clip3(b[p + 2 * s]) + clip3(b[p + 3 * s]) + clip3(b[p + 4 * s]);
  }
  return mag;
}

const int kNzCtxOffset1D[32] = { 26, 31, 36, 36, 36, 36, 36, 36, 36, 36, 36,
                                 36, 36, 36, 36, 36, 36, 36, 36, 36, 36, 36,
                                 36, 36, 36, 36, 36, 36, 36, 36, 36, 36 };

inline int get_nz_map_ctx(const uint8_t *b, int pos, int bhl, int tx_class,
                          const int32_t *nz_off) {
  const int padded = pos + ((pos >> bhl) << 2);
  const int stats = get_nz_mag(b, padded, bhl, tx_class);
  if ((tx_class | pos) == 0) return 0;
  int ctx = (stats + 1) >> 1;
  if (ctx > 4) ctx = 4;
  if (tx_class == 0) return ctx + nz_off[pos];
  const int col = pos >> bhl;
  const int row = pos - (col << bhl);
  const int idx = tx_class == 1 ? col : row;
  return ctx + kNzCtxOffset1D[idx < 32 ? idx : 31];
}

inline int get_br_ctx(const uint8_t *b, int pos, int bhl, int tx_class) {
  const int col = pos >> bhl;
  const int row = pos - (col << bhl);
  const int s = (1 << bhl) + kTxPadHor;
  const int p = col * s + row;
  int mag = b[p + 1] + b[p + s];
  if (tx_class == 0) {
    mag += b[p + s + 1];
    mag = (mag + 1) >> 1;
    if (mag > 6) mag = 6;
    if (pos == 0) return mag;
    if (row < 2 && col < 2) return mag + 7;
  } else if (tx_class == 1) {
    mag += b[p + 2 * s];
    mag = (mag + 1) >> 1;
    if (mag > 6) mag = 6;
    if (pos == 0) return mag;
    if (col == 0) return mag + 7;
  } else {
    mag += b[p + 2];
    mag = (mag + 1) >> 1;
    if (mag > 6) mag = 6;
    if (pos == 0) return mag;
    if (row == 0) return mag + 7;
  }
  return mag + 14;
}

inline int lower_levels_ctx_eob(int bhl, int width, int scan_idx) {
  if (scan_idx == 0) return 0;
  if (scan_idx <= (width << bhl) / 8) return 1;
  if (scan_idx <= (width << bhl) / 4) return 2;
  return 3;
}

inline void write_golomb(Encoder *e, int level) {
  int x = level + 1;
  int length = 0;
  for (int v = x; v; v >>= 1) ++length;
  for (int i = 0; i < length - 1; ++i) e->write_bit(0);
  for (int i = length - 1; i >= 0; --i) e->write_bit((x >> i) & 1);
}

}  // namespace

// Returns cul_level (with dc sign folded per set_dc_sign).
int ec_enc_coeffs(Encoder *e, const int32_t *coeff, int width, int height,
                  int bhl, int eob, const int32_t *scan, int tx_class,
                  const int32_t *nz_off, uint16_t *base_eob_cdf,
                  int base_eob_stride, uint16_t *base_cdf, int base_stride,
                  uint16_t *br_cdf, int br_stride, uint16_t *dc_sign_cdf) {
  // build the padded |levels| buffer (av1_txb_init_levels)
  const int stride = height + kTxPadHor;
  std::vector<uint8_t> levels((width + 4) * stride + 16, 0);
  for (int c = 0; c < width; ++c) {
    for (int r = 0; r < height; ++r) {
      int a = coeff[c * height + r];
      if (a < 0) a = -a;
      levels[c * stride + r] = static_cast<uint8_t>(a < 127 ? a : 127);
    }
  }
  const uint8_t *b = levels.data();

  for (int c = eob - 1; c >= 0; --c) {
    const int pos = scan[c];
    int level = coeff[pos];
    if (level < 0) level = -level;
    if (c == eob - 1) {
      const int ctx = lower_levels_ctx_eob(bhl, width, c);
      e->encode_symbol((level < 3 ? level : 3) - 1,
                       base_eob_cdf + ctx * base_eob_stride, 3);
    } else {
      const int ctx = get_nz_map_ctx(b, pos, bhl, tx_class, nz_off);
      e->encode_symbol(level < 3 ? level : 3, base_cdf + ctx * base_stride,
                       4);
    }
    if (level > kNumBaseLevels) {
      const int base_range = level - 1 - kNumBaseLevels;
      const int br = get_br_ctx(b, pos, bhl, tx_class);
      uint16_t *cdf = br_cdf + br * br_stride;
      for (int idx = 0; idx < kCoeffBaseRange; idx += kBrCdfSize - 1) {
        int k = base_range - idx;
        if (k > kBrCdfSize - 1) k = kBrCdfSize - 1;
        e->encode_symbol(k, cdf, kBrCdfSize);
        if (k < kBrCdfSize - 1) break;
      }
    }
  }

  int cul_level = 0;
  int dc_val = 0;
  for (int c = 0; c < eob; ++c) {
    const int v = coeff[scan[c]];
    int level = v < 0 ? -v : v;
    const int sign = v < 0 ? 1 : 0;
    if (level) {
      if (c == 0) {
        e->encode_symbol(sign, dc_sign_cdf, 2);
        dc_val = v;
      } else {
        e->write_bit(sign);
      }
      if (level > kCoeffBaseRange + kNumBaseLevels) {
        write_golomb(e, level - kCoeffBaseRange - 1 - kNumBaseLevels);
      }
      cul_level += level;
    }
  }
  if (cul_level > 7) cul_level = 7;       // COEFF_CONTEXT_MASK
  if (dc_val < 0) cul_level |= 1 << 3;    // set_dc_sign (COEFF_CONTEXT_BITS)
  else if (dc_val > 0) cul_level += 2 << 3;
  return cul_level;
}

// ---------------------------------------------------------------------------
// Full-tile KEY-frame packer for the uniform-grid TPU plan (the fused path).
//
// One native call packs the entire tile's syntax — partition tree, skip,
// kf y/uv intra modes, angle deltas, ext-tx, and every coefficient block —
// replacing the per-symbol Python loop (av1/encoder/bitstream.c
// av1_pack_bitstream analogue, restricted to the plan's feature set:
// KEY frame, square blocks of one size, TX == block size, DCT only,
// modes {DC,V,H,SMOOTH,SMOOTH_V,SMOOTH_H,PAETH}, 4:2:0 or monochrome).
// CDF tables adapt in place exactly like the Python encoder, so the
// resulting stream is bit-identical to the per-symbol path.
// ---------------------------------------------------------------------------

namespace {

// Partition enum values (normative/enums.py Partition)
enum { PART_NONE = 0, PART_HORZ = 1, PART_VERT = 2, PART_SPLIT = 3,
       PART_HORZ_A = 4, PART_HORZ_B = 5, PART_VERT_A = 6, PART_VERT_B = 7,
       PART_HORZ_4 = 8, PART_VERT_4 = 9 };

inline int cdf_el_prob(const uint16_t *icdf, int el) {
  const int prev = el > 0 ? icdf[el - 1] : 32768;
  return prev - icdf[el];
}

// partition_gather_{horz,vert}_alike -> 2-symbol icdf (decoder/frame.py)
inline void gather_partition_cdf(const uint16_t *icdf, bool horz,
                                 uint16_t out[3]) {
  int p = 32768;
  if (horz) {
    p -= cdf_el_prob(icdf, PART_HORZ) + cdf_el_prob(icdf, PART_SPLIT) +
         cdf_el_prob(icdf, PART_HORZ_A) + cdf_el_prob(icdf, PART_HORZ_B) +
         cdf_el_prob(icdf, PART_VERT_A) + cdf_el_prob(icdf, PART_HORZ_4);
  } else {
    p -= cdf_el_prob(icdf, PART_VERT) + cdf_el_prob(icdf, PART_SPLIT) +
         cdf_el_prob(icdf, PART_HORZ_A) + cdf_el_prob(icdf, PART_VERT_A) +
         cdf_el_prob(icdf, PART_VERT_B) + cdf_el_prob(icdf, PART_VERT_4);
  }
  out[0] = static_cast<uint16_t>(32768 - p);
  out[1] = 0;
  out[2] = 0;
}

struct KfPackParams {        // mirrored by ctypes in ec/native_coder.py
  // plan arrays (all int32 unless noted)
  const int32_t *y_mode;     // R*C  (AV1 mode ids 0..12)
  const int32_t *uv_mode;    // R*C
  const uint8_t *skip;       // R*C
  const int32_t *y_levels;   // R*C*bs*bs (C layout col*H+row)
  const int32_t *y_eob;      // R*C
  const int32_t *uv_levels;  // 2*R*C*cbs*cbs
  const int32_t *uv_eob;     // 2*R*C
  const int32_t *y_scan;     // bs*bs
  const int32_t *uv_scan;    // cbs*cbs
  const int32_t *y_nzoff;    // nz_map_ctx_offset for luma tx
  const int32_t *uv_nzoff;
  const int32_t *eob_group_start;   // 12
  const int32_t *eob_offset_bits;   // 12
  const int32_t *intra_mode_ctx;    // 13
  // CDF tables (uint16, adapted in place; shapes per ec/context.py)
  uint16_t *part_cdf;        // (20, 11)
  uint16_t *skip_cdf;        // (3, 3)
  uint16_t *kf_y_cdf;        // (5, 5, 14)
  uint16_t *angle_cdf;       // (8, 8)
  uint16_t *uv_cdf;          // (13, 15)  == uv_mode_cdf[cfl_allowed=1]
  uint16_t *ext_tx_cdf;      // (13, 17)  == intra_ext_tx_cdf[eset][sqr]
  uint16_t *y_txb_skip;      // (13, 3)   txb_skip_cdf[y_txs_ctx]
  uint16_t *uv_txb_skip;     // (13, 3)
  uint16_t *y_eob_cdf;       // one row, y_eob_nsyms+1 wide
  uint16_t *uv_eob_cdf;
  uint16_t *y_eob_extra;     // (9, 3)
  uint16_t *uv_eob_extra;
  uint16_t *y_base_eob;      // (4, 4)
  uint16_t *uv_base_eob;
  uint16_t *y_base;          // (42, 5)
  uint16_t *uv_base;
  uint16_t *y_br;            // (21, 5)
  uint16_t *uv_br;
  uint16_t *y_dc_sign;       // (3, 3)
  uint16_t *uv_dc_sign;
  // scalars
  int64_t R, C, bs;          // block grid + luma block size (8/16/32)
  int64_t mi_rows, mi_cols;  // true mi dims (grid covers them exactly)
  int64_t nplanes;           // 1 or 3
  int64_t y_eob_nsyms, uv_eob_nsyms;
  int64_t tx_type_nsyms;     // 0 => tx type not coded (TX_32X32)
  int64_t tx_type_sym;       // EXT_TX_IND[set][DCT_DCT]
  int64_t block_bsize;       // BlockSize enum of the uniform block
  int64_t part_ctx_above, part_ctx_left;  // PARTITION_CTX_* [block_bsize]
};

struct PackState {
  const KfPackParams *p;
  Encoder *e;
  std::vector<int32_t> above_part;     // per mi col
  int32_t left_part[16];
  std::vector<uint8_t> above_ent_y, above_ent_u, above_ent_v;
  uint8_t left_ent_y[16], left_ent_u[8], left_ent_v[8];
  int mi_bs;                           // block size in mi units
};

inline int dc_sign_ctx_from(const uint8_t *a, int na, const uint8_t *l,
                            int nl) {
  static const int kSigns[3] = { 0, -1, 1 };
  int s = 0;
  for (int k = 0; k < na; ++k) s += kSigns[a[k] >> 3];
  for (int k = 0; k < nl; ++k) s += kSigns[l[k] >> 3];
  return s == 0 ? 0 : (s < 0 ? 1 : 2);
}

// One transform block: txb_skip + (luma) ext-tx + eob prefix + coeff loops.
// Returns cul_level.
int pack_txb(PackState &st, int pt, const int32_t *levels, int eob, int width,
             int bhl, int txb_skip_ctx, int dc_sign_ctx, int mode) {
  const KfPackParams &p = *st.p;
  Encoder *e = st.e;
  uint16_t *skip_cdf = (pt ? p.uv_txb_skip : p.y_txb_skip) + txb_skip_ctx * 3;
  e->encode_symbol(eob == 0 ? 1 : 0, skip_cdf, 2);
  if (eob == 0) return 0;
  if (pt == 0 && p.tx_type_nsyms > 0)
    e->encode_symbol(static_cast<int>(p.tx_type_sym),
                     p.ext_tx_cdf + mode * 17,
                     static_cast<int>(p.tx_type_nsyms));
  // eob position token (av1_get_eob_pos_token)
  int eob_pt = 0;
  while (eob_pt + 1 < 12 && p.eob_group_start[eob_pt + 1] <= eob) ++eob_pt;
  const int eob_extra = eob - p.eob_group_start[eob_pt];
  e->encode_symbol(eob_pt - 1, pt ? p.uv_eob_cdf : p.y_eob_cdf,
                   static_cast<int>(pt ? p.uv_eob_nsyms : p.y_eob_nsyms));
  const int ofs_bits = p.eob_offset_bits[eob_pt];
  if (ofs_bits > 0) {
    const int eob_ctx = eob_pt - 3;
    e->encode_symbol((eob_extra >> (ofs_bits - 1)) & 1,
                     (pt ? p.uv_eob_extra : p.y_eob_extra) + eob_ctx * 3, 2);
    for (int i = 1; i < ofs_bits; ++i)
      e->write_bit((eob_extra >> (ofs_bits - 1 - i)) & 1);
  }
  return ec_enc_coeffs(
      e, levels, width, width, bhl, eob, pt ? p.uv_scan : p.y_scan, 0,
      pt ? p.uv_nzoff : p.y_nzoff, pt ? p.uv_base_eob : p.y_base_eob, 4,
      pt ? p.uv_base : p.y_base, 5, pt ? p.uv_br : p.y_br, 5,
      (pt ? p.uv_dc_sign : p.y_dc_sign) + dc_sign_ctx * 3);
}

void pack_block(PackState &st, int mi_row, int mi_col) {
  const KfPackParams &p = *st.p;
  Encoder *e = st.e;
  const int C = static_cast<int>(p.C);
  const int r = mi_row / st.mi_bs, c = mi_col / st.mi_bs;
  const int bi = r * C + c;
  const bool up = mi_row > 0, left = mi_col > 0;
  const int skip = p.skip[bi];

  // skip flag (skip_txfm_cdfs, neighbor-sum ctx)
  int skip_ctx = 0;
  if (up) skip_ctx += p.skip[bi - C];
  if (left) skip_ctx += p.skip[bi - 1];
  e->encode_symbol(skip, p.skip_cdf + skip_ctx * 3, 2);

  // kf y mode (kf_y_cdf[above_ctx][left_ctx])
  const int mode = p.y_mode[bi];
  const int am = up ? p.y_mode[bi - C] : 0;
  const int lm = left ? p.y_mode[bi - 1] : 0;
  const int actx = p.intra_mode_ctx[am], lctx = p.intra_mode_ctx[lm];
  e->encode_symbol(mode, p.kf_y_cdf + (actx * 5 + lctx) * 14, 13);
  const bool y_dir = mode >= 1 && mode <= 8;
  if (y_dir) e->encode_symbol(3, p.angle_cdf + (mode - 1) * 8, 7);

  int uvm = 0;
  if (p.nplanes > 1) {
    uvm = p.uv_mode[bi];
    e->encode_symbol(uvm, p.uv_cdf + mode * 15, 14);
    if (uvm >= 1 && uvm <= 8)
      e->encode_symbol(3, p.angle_cdf + (uvm - 1) * 8, 7);
  }

  const int wu = static_cast<int>(p.bs) / 4;       // luma tx units
  const int cwu = wu / 2;                          // chroma (4:2:0)
  const int acol = mi_col, lrow = mi_row & 15;
  const int cacol = mi_col >> 1, clrow = (mi_row & 15) >> 1;

  if (skip) {  // reset entropy contexts, no residual
    std::memset(st.above_ent_y.data() + acol, 0, wu);
    std::memset(st.left_ent_y + lrow, 0, wu);
    if (p.nplanes > 1) {
      std::memset(st.above_ent_u.data() + cacol, 0, cwu);
      std::memset(st.above_ent_v.data() + cacol, 0, cwu);
      std::memset(st.left_ent_u + clrow, 0, cwu);
      std::memset(st.left_ent_v + clrow, 0, cwu);
    }
    return;
  }

  // luma txb: block size == tx size -> txb_skip_ctx = 0 (get_txb_ctx)
  const int bs = static_cast<int>(p.bs);
  const int n = bs * bs;
  const int bhl_y = 31 - __builtin_clz(bs);
  int dctx = dc_sign_ctx_from(st.above_ent_y.data() + acol, wu,
                              st.left_ent_y + lrow, wu);
  int cul = pack_txb(st, 0, p.y_levels + bi * n, p.y_eob[bi], bs, bhl_y, 0,
                     dctx, mode);
  std::memset(st.above_ent_y.data() + acol, cul, wu);
  std::memset(st.left_ent_y + lrow, cul, wu);

  if (p.nplanes > 1) {
    const int cbs = bs / 2, m = cbs * cbs;
    const int bhl_c = 31 - __builtin_clz(cbs);
    uint8_t *aents[2] = { st.above_ent_u.data(), st.above_ent_v.data() };
    uint8_t *lents[2] = { st.left_ent_u, st.left_ent_v };
    const int total = static_cast<int>(p.R) * C;
    for (int pl = 0; pl < 2; ++pl) {
      const uint8_t *a = aents[pl] + cacol;
      const uint8_t *l = lents[pl] + clrow;
      // chroma skip ctx: (above!=0)+(left!=0) + 7 (npels equal)
      int above_ec = 0, left_ec = 0;
      for (int k = 0; k < cwu; ++k) above_ec |= a[k];
      for (int k = 0; k < cwu; ++k) left_ec |= l[k];
      const int sctx = (above_ec ? 1 : 0) + (left_ec ? 1 : 0) + 7;
      dctx = dc_sign_ctx_from(a, cwu, l, cwu);
      cul = pack_txb(st, 1, p.uv_levels + (pl * total + bi) * m,
                     p.uv_eob[pl * total + bi], cbs, bhl_c, sctx, dctx, 0);
      std::memset(aents[pl] + cacol, cul, cwu);
      std::memset(lents[pl] + clrow, cul, cwu);
    }
  }
}

void pack_partition(PackState &st, int mi_row, int mi_col, int bsize) {
  const KfPackParams &p = *st.p;
  if (mi_row >= p.mi_rows || mi_col >= p.mi_cols) return;
  // square-bsize ladder: BLOCK_8X8=3 (2 mi) .. BLOCK_64X64=12 (16 mi)
  const int mi_w = 2 << ((bsize - 3) / 3);
  const int hbs = mi_w / 2;
  const bool has_rows = mi_row + hbs < p.mi_rows;
  const bool has_cols = mi_col + hbs < p.mi_cols;
  const bool is_leaf = bsize == p.block_bsize;
  const int partition =
      (!is_leaf || !(has_rows && has_cols)) ? PART_SPLIT : PART_NONE;
  // partition ctx (encoder/frame.py partition_ctx)
  const int bsl = (bsize - 3) / 3;  // log2(mi_w) - 1
  const int above = (st.above_part[mi_col] >> bsl) & 1;
  const int lft = (st.left_part[mi_row & 15] >> bsl) & 1;
  const int ctx = (lft * 2 + above) + bsl * 4;
  uint16_t *cdf = p.part_cdf + ctx * 11;
  const int nsyms = bsize <= 3 ? 4 : 10;
  if (has_rows && has_cols) {
    st.e->encode_symbol(partition, cdf, nsyms);
  } else if (!has_rows && !has_cols) {
    // nothing coded: split implied
  } else {
    uint16_t g[3];
    gather_partition_cdf(cdf, /*horz=*/!has_cols, g);
    const int sym = partition == PART_SPLIT ? 1 : 0;
    const unsigned fl = sym > 0 ? g[sym - 1] : 32768;
    st.e->encode_q15(fl, g[sym], sym, 2);  // non-adaptive (gathered)
  }
  if (partition == PART_NONE) {
    pack_block(st, mi_row, mi_col);
    st.above_part[mi_col] = static_cast<int32_t>(p.part_ctx_above);
    for (int i = 1; i < mi_w; ++i)
      st.above_part[mi_col + i] = static_cast<int32_t>(p.part_ctx_above);
    for (int i = 0; i < mi_w; ++i)
      st.left_part[(mi_row & 15) + i] = static_cast<int32_t>(p.part_ctx_left);
  } else {
    const int sub = bsize - 3;  // split subsize on the square ladder
    pack_partition(st, mi_row, mi_col, sub);
    pack_partition(st, mi_row, mi_col + hbs, sub);
    pack_partition(st, mi_row + hbs, mi_col, sub);
    pack_partition(st, mi_row + hbs, mi_col + hbs, sub);
  }
}

}  // namespace

// Pack one whole KEY-frame tile from the uniform-grid plan. Returns 0.
int ec_enc_pack_kf_uniform(Encoder *e, const KfPackParams *params) {
  PackState st;
  st.p = params;
  st.e = e;
  st.mi_bs = static_cast<int>(params->bs) / 4;
  const int mi_cols = static_cast<int>(params->mi_cols);
  const int mi_rows = static_cast<int>(params->mi_rows);
  const int ncols = (mi_cols + 15) / 16 * 16;
  st.above_part.assign(ncols, 0);
  st.above_ent_y.assign(ncols, 0);
  st.above_ent_u.assign(ncols / 2 + 1, 0);
  st.above_ent_v.assign(ncols / 2 + 1, 0);
  for (int r0 = 0; r0 < mi_rows; r0 += 16) {
    std::memset(st.left_part, 0, sizeof(st.left_part));
    std::memset(st.left_ent_y, 0, sizeof(st.left_ent_y));
    std::memset(st.left_ent_u, 0, sizeof(st.left_ent_u));
    std::memset(st.left_ent_v, 0, sizeof(st.left_ent_v));
    for (int c0 = 0; c0 < mi_cols; c0 += 16)
      pack_partition(st, r0, c0, 12 /*BLOCK_64X64*/);
  }
  return 0;
}

// Decode side of the same loops (mirrors read_coeffs_txb after the eob
// prefix): fills coeff (signed int32, C layout) and returns cul_level.
int ec_dec_coeffs(Decoder *d, int32_t *coeff, int width, int height, int bhl,
                  int eob, const int32_t *scan, int tx_class,
                  const int32_t *nz_off, uint16_t *base_eob_cdf,
                  int base_eob_stride, uint16_t *base_cdf, int base_stride,
                  uint16_t *br_cdf, int br_stride, uint16_t *dc_sign_cdf) {
  const int stride = height + kTxPadHor;
  std::vector<uint8_t> levels((width + 4) * stride + 16, 0);
  uint8_t *b = levels.data();

  auto read_br = [&](uint16_t *cdf, int level) {
    for (int idx = 0; idx < kCoeffBaseRange; idx += kBrCdfSize - 1) {
      const int k = d->decode_symbol(cdf, kBrCdfSize);
      level += k;
      if (k < kBrCdfSize - 1) break;
    }
    return level;
  };

  {  // eob-position coefficient
    const int c = eob - 1;
    const int pos = scan[c];
    const int ctx = lower_levels_ctx_eob(bhl, width, c);
    int level =
        d->decode_symbol(base_eob_cdf + ctx * base_eob_stride, 3) + 1;
    if (level > kNumBaseLevels) {
      // get_br_ctx_eob
      const int col = pos >> bhl;
      const int row = pos - (col << bhl);
      int br;
      if (pos == 0) br = 0;
      else if ((tx_class == 0 && row < 2 && col < 2) ||
               (tx_class == 1 && col == 0) || (tx_class == 2 && row == 0))
        br = 7;
      else br = 14;
      level = read_br(br_cdf + br * br_stride, level);
    }
    const int padded = pos + ((pos >> bhl) << 2);
    b[padded] = static_cast<uint8_t>(level < 255 ? level : 255);
  }
  for (int c = eob - 2; c >= 0; --c) {
    const int pos = scan[c];
    const int ctx = get_nz_map_ctx(b, pos, bhl, tx_class, nz_off);
    int level = d->decode_symbol(base_cdf + ctx * base_stride, 4);
    if (level > kNumBaseLevels) {
      const int br = get_br_ctx(b, pos, bhl, tx_class);
      level = read_br(br_cdf + br * br_stride, level);
    }
    const int padded = pos + ((pos >> bhl) << 2);
    b[padded] = static_cast<uint8_t>(level < 255 ? level : 255);
  }

  std::memset(coeff, 0, sizeof(int32_t) * width * height);
  int cul_level = 0;
  int dc_val = 0;
  for (int c = 0; c < eob; ++c) {
    const int pos = scan[c];
    const int padded = pos + ((pos >> bhl) << 2);
    int level = b[padded];
    if (!level) continue;
    int sign;
    if (c == 0) sign = d->decode_symbol(dc_sign_cdf, 2);
    else sign = d->read_bit();
    if (level >= kCoeffBaseRange + kNumBaseLevels + 1) {
      // read_golomb
      int length = 0;
      while (!d->read_bit()) {
        ++length;
        if (length > 20) break;
      }
      int x = 1;
      for (int i = 0; i < length; ++i) x = (x << 1) | d->read_bit();
      level += x - 1;
    }
    if (c == 0) dc_val = sign ? -level : level;
    coeff[pos] = sign ? -level : level;
    cul_level += level;
  }
  if (cul_level > 7) cul_level = 7;
  if (dc_val < 0) cul_level |= 1 << 3;
  else if (dc_val > 0) cul_level += 2 << 3;
  return cul_level;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Pack v2: KEY-frame tile with a two-level partition tree (64 -> 32 cells,
// each PARTITION_NONE or SPLIT into four 16s) from the partitioned TPU plan
// (encoder/tpu_intra.py plan_frame_part). Mirrors the same write order as
// the v1 uniform pack; adds per-bsize mode/level arrays, rolling mode/skip
// neighbour context (the decoder's above_mi/left_mi), and per-tx-size CDF
// bundles. av1/encoder/bitstream.c write_modes / encodeframe.c analogue.
// ---------------------------------------------------------------------------

extern "C" {

struct Pack2Params {  // mirrored by ctypes in ec/native_coder.py
  // plan arrays (int32 unless noted); grids: 32-level (R,C), 16-level (2R,2C)
  const uint8_t *split32;     // R*C
  const int32_t *y_mode32;    // AV1 mode ids
  const int32_t *y_mode16;
  const int32_t *y_lv32;      // R*C*1024 (C layout col*H+row)
  const int32_t *y_lv16;      // 2R*2C*256
  const int32_t *y_eob32;
  const int32_t *y_eob16;
  const int32_t *uv_mode16;   // chroma of NONE cells (R,C)
  const int32_t *uv_mode8;    // chroma of split subs (2R,2C)
  const int32_t *uv_lv16;     // 2*R*C*256
  const int32_t *uv_lv8;      // 2*2R*2C*64
  const int32_t *uv_eob16;    // 2*R*C
  const int32_t *uv_eob8;     // 2*2R*2C
  // scans / nz offsets per tx size
  const int32_t *scan32, *scan16, *scan8;
  const int32_t *nzoff32, *nzoff16, *nzoff8;
  const int32_t *eob_group_start, *eob_offset_bits, *intra_mode_ctx;
  // CDFs (adapted in place)
  uint16_t *part_cdf;   // (20,11)
  uint16_t *skip_cdf;   // (3,3)
  uint16_t *kf_y_cdf;   // (5,5,14)
  uint16_t *angle_cdf;  // (8,8)
  uint16_t *uv_cdf;     // (13,15) cfl_allowed=1
  uint16_t *ext_tx16;   // (13,17) intra set for TX_16X16 luma
  // per-size coeff bundles (slices at the right ectx/plane)
  uint16_t *txb_skip_y32, *txb_skip_y16, *txb_skip_uv16, *txb_skip_uv8;
  uint16_t *eob_y32, *eob_y16, *eob_uv16, *eob_uv8;      // one row each
  uint16_t *eobex_y32, *eobex_y16, *eobex_uv16, *eobex_uv8;  // (9,3)
  uint16_t *beob_y32, *beob_y16, *beob_uv16, *beob_uv8;  // (4,4)
  uint16_t *base_y32, *base_y16, *base_uv16, *base_uv8;  // (42,5)
  uint16_t *br_y32, *br_y16, *br_uv16, *br_uv8;          // (21,5)
  uint16_t *dcs_y, *dcs_uv;                              // (3,3)
  // per-block luma angle deltas (-3..3) for directional modes (same grid
  // layouts as y_mode32/y_mode16); written as symbol delta+3
  const int32_t *y_delta32, *y_delta16;
  // scalars
  int64_t R, C, mi_rows, mi_cols, nplanes;
  int64_t eobn_y32, eobn_y16, eobn_uv16, eobn_uv8;
  int64_t txt16_nsyms, txt16_sym;        // TX_16X16 luma tx-type coding
  int64_t pctx_a32, pctx_l32, pctx_a16, pctx_l16;  // PARTITION_CTX_* values
  // tile-column support: mi_cols above is the tile-relative VISIT bound;
  // has_cols / visible-unit clamps use absolute frame bounds
  int64_t mi_col_off;     // absolute mi col of the tile start
  int64_t mi_cols_frame;  // frame mi cols
};

}  // extern "C"

namespace {

struct Pack2State {
  const Pack2Params *p;
  Encoder *e;
  std::vector<int32_t> above_part;
  int32_t left_part[16];
  std::vector<uint8_t> above_mode, above_skip;   // per mi col (AV1 mode id)
  uint8_t left_mode[16], left_skip[16];
  std::vector<uint8_t> above_ent_y, above_ent_u, above_ent_v;
  uint8_t left_ent_y[16], left_ent_u[8], left_ent_v[8];
};

struct TxBundle {
  uint16_t *txb_skip;  // (13,3)
  uint16_t *eob;       // one row
  uint16_t *eobex;     // (9,3)
  uint16_t *beob;      // (4,4)
  uint16_t *base;      // (42,5)
  uint16_t *br;        // (21,5)
  uint16_t *dcs;       // (3,3)
  const int32_t *scan;
  const int32_t *nzoff;
  int eob_nsyms;
  int width;           // tx dim (square)
  int bhl;
};

// txb with a bundle; returns cul_level. mode indexes ext-tx cdf (luma 16).
int pack2_txb(Pack2State &st, const TxBundle &tb, bool luma16,
              const int32_t *levels, int eob, int txb_skip_ctx,
              int dc_sign_ctx, int mode) {
  const Pack2Params &p = *st.p;
  Encoder *e = st.e;
  e->encode_symbol(eob == 0 ? 1 : 0, tb.txb_skip + txb_skip_ctx * 3, 2);
  if (eob == 0) return 0;
  if (luma16 && p.txt16_nsyms > 0)
    e->encode_symbol(static_cast<int>(p.txt16_sym), p.ext_tx16 + mode * 17,
                     static_cast<int>(p.txt16_nsyms));
  int eob_pt = 0;
  while (eob_pt + 1 < 12 && p.eob_group_start[eob_pt + 1] <= eob) ++eob_pt;
  const int eob_extra = eob - p.eob_group_start[eob_pt];
  e->encode_symbol(eob_pt - 1, tb.eob, tb.eob_nsyms);
  const int ofs_bits = p.eob_offset_bits[eob_pt];
  if (ofs_bits > 0) {
    e->encode_symbol((eob_extra >> (ofs_bits - 1)) & 1,
                     tb.eobex + (eob_pt - 3) * 3, 2);
    for (int i = 1; i < ofs_bits; ++i)
      e->write_bit((eob_extra >> (ofs_bits - 1 - i)) & 1);
  }
  return ec_enc_coeffs(e, levels, tb.width, tb.width, tb.bhl, eob, tb.scan,
                       0, tb.nzoff, tb.beob, 4, tb.base, 5, tb.br, 5,
                       tb.dcs + dc_sign_ctx * 3);
}

void pack2_block(Pack2State &st, const TxBundle &yb, const TxBundle &uvb,
                 int mi_row, int mi_col, int bs) {
  const Pack2Params &p = *st.p;
  Encoder *e = st.e;
  const int C2 = static_cast<int>(p.C) * 2;
  const int Cc = static_cast<int>(p.C);
  const int total32 = static_cast<int>(p.R) * Cc;
  const int total16 = 4 * total32;
  int ymode, uvm, ydelta = 0;
  const int32_t *ylv;
  int yeob;
  const int32_t *uvlv[2];
  int uveob[2];
  if (bs == 32) {
    const int bi = (mi_row / 8) * Cc + (mi_col / 8);
    ymode = p.y_mode32[bi];
    if (p.y_delta32) ydelta = p.y_delta32[bi];
    ylv = p.y_lv32 + static_cast<long>(bi) * 1024;
    yeob = p.y_eob32[bi];
    uvm = p.nplanes > 1 ? p.uv_mode16[bi] : 0;
    for (int pl = 0; pl < 2; ++pl) {
      uvlv[pl] = p.uv_lv16 + (static_cast<long>(pl) * total32 + bi) * 256;
      uveob[pl] = p.nplanes > 1 ? p.uv_eob16[pl * total32 + bi] : 0;
    }
  } else {
    const int bi = (mi_row / 4) * C2 + (mi_col / 4);
    ymode = p.y_mode16[bi];
    if (p.y_delta16) ydelta = p.y_delta16[bi];
    ylv = p.y_lv16 + static_cast<long>(bi) * 256;
    yeob = p.y_eob16[bi];
    uvm = p.nplanes > 1 ? p.uv_mode8[bi] : 0;
    for (int pl = 0; pl < 2; ++pl) {
      uvlv[pl] = p.uv_lv8 + (static_cast<long>(pl) * total16 + bi) * 64;
      uveob[pl] = p.nplanes > 1 ? p.uv_eob8[pl * total16 + bi] : 0;
    }
  }
  const bool up = mi_row > 0, left = mi_col > 0;
  int skip = yeob == 0;
  if (p.nplanes > 1) skip = skip && uveob[0] == 0 && uveob[1] == 0;

  int skip_ctx = 0;
  if (up) skip_ctx += st.above_skip[mi_col];
  if (left) skip_ctx += st.left_skip[mi_row & 15];
  e->encode_symbol(skip, p.skip_cdf + skip_ctx * 3, 2);

  const int am = up ? st.above_mode[mi_col] : 0;
  const int lm = left ? st.left_mode[mi_row & 15] : 0;
  const int actx = p.intra_mode_ctx[am], lctx = p.intra_mode_ctx[lm];
  e->encode_symbol(ymode, p.kf_y_cdf + (actx * 5 + lctx) * 14, 13);
  if (ymode >= 1 && ymode <= 8)
    e->encode_symbol(3 + ydelta, p.angle_cdf + (ymode - 1) * 8, 7);
  if (p.nplanes > 1) {
    e->encode_symbol(uvm, p.uv_cdf + ymode * 15, 14);
    if (uvm >= 1 && uvm <= 8)
      e->encode_symbol(3, p.angle_cdf + (uvm - 1) * 8, 7);
  }

  // rolling neighbour state over the block's mi span
  const int w4 = bs / 4;
  for (int i = 0;
       i < w4 && p.mi_col_off + mi_col + i < p.mi_cols_frame; ++i) {
    st.above_mode[mi_col + i] = static_cast<uint8_t>(ymode);
    st.above_skip[mi_col + i] = static_cast<uint8_t>(skip);
  }
  for (int i = 0; i < w4; ++i) {
    st.left_mode[(mi_row + i) & 15] = static_cast<uint8_t>(ymode);
    st.left_skip[(mi_row + i) & 15] = static_cast<uint8_t>(skip);
  }

  const int wu = bs / 4;       // luma tx 4px units
  const int cwu = wu / 2;
  const int acol = mi_col, lrow = mi_row & 15;
  const int cacol = mi_col >> 1, clrow = (mi_row & 15) >> 1;
  // av1_set_entropy_contexts: tx units past the frame (mi) edge stay 0 —
  // overhanging blocks write cul only to the visible units
  int vis_w = static_cast<int>(p.mi_cols_frame - p.mi_col_off) - mi_col;
  int vis_h = static_cast<int>(p.mi_rows) - mi_row;
  if (vis_w > wu) vis_w = wu;
  if (vis_h > wu) vis_h = wu;
  // chroma 4px units: (visible mi * 4 luma px >> 1) >> 2
  int cvis_w = (vis_w * 4 >> 1) >> 2;
  int cvis_h = (vis_h * 4 >> 1) >> 2;
  if (cvis_w > cwu) cvis_w = cwu;
  if (cvis_h > cwu) cvis_h = cwu;
  if (skip) {
    std::memset(st.above_ent_y.data() + acol, 0, wu);
    std::memset(st.left_ent_y + lrow, 0, wu);
    if (p.nplanes > 1) {
      std::memset(st.above_ent_u.data() + cacol, 0, cwu);
      std::memset(st.above_ent_v.data() + cacol, 0, cwu);
      std::memset(st.left_ent_u + clrow, 0, cwu);
      std::memset(st.left_ent_v + clrow, 0, cwu);
    }
    return;
  }

  int dctx = dc_sign_ctx_from(st.above_ent_y.data() + acol, wu,
                              st.left_ent_y + lrow, wu);
  int cul = pack2_txb(st, yb, bs == 16, ylv, yeob, 0, dctx, ymode);
  std::memset(st.above_ent_y.data() + acol, cul, vis_w);
  std::memset(st.above_ent_y.data() + acol + vis_w, 0, wu - vis_w);
  std::memset(st.left_ent_y + lrow, cul, vis_h);
  std::memset(st.left_ent_y + lrow + vis_h, 0, wu - vis_h);

  if (p.nplanes > 1) {
    uint8_t *aents[2] = { st.above_ent_u.data(), st.above_ent_v.data() };
    uint8_t *lents[2] = { st.left_ent_u, st.left_ent_v };
    for (int pl = 0; pl < 2; ++pl) {
      const uint8_t *a = aents[pl] + cacol;
      const uint8_t *l = lents[pl] + clrow;
      int above_ec = 0, left_ec = 0;
      for (int k = 0; k < cwu; ++k) above_ec |= a[k];
      for (int k = 0; k < cwu; ++k) left_ec |= l[k];
      const int sctx = (above_ec ? 1 : 0) + (left_ec ? 1 : 0) + 7;
      dctx = dc_sign_ctx_from(a, cwu, l, cwu);
      cul = pack2_txb(st, uvb, false, uvlv[pl], uveob[pl], sctx, dctx, 0);
      std::memset(aents[pl] + cacol, cul, cvis_w);
      std::memset(aents[pl] + cacol + cvis_w, 0, cwu - cvis_w);
      std::memset(lents[pl] + clrow, cul, cvis_h);
      std::memset(lents[pl] + clrow + cvis_h, 0, cwu - cvis_h);
    }
  }
}

void pack2_partition(Pack2State &st, const TxBundle &y32, const TxBundle &y16,
                     const TxBundle &uv16, const TxBundle &uv8,
                     int mi_row, int mi_col, int bsize) {
  const Pack2Params &p = *st.p;
  if (mi_row >= p.mi_rows || mi_col >= p.mi_cols) return;
  const int bsl = (bsize - 3) / 3;
  const int mi_w = 2 << bsl;
  const int hbs = mi_w / 2;
  const bool has_rows = mi_row + hbs < p.mi_rows;
  const bool has_cols = p.mi_col_off + mi_col + hbs < p.mi_cols_frame;
  int partition;
  if (bsize == 6) {           // BLOCK_16X16 leaf
    partition = PART_NONE;
  } else if (bsize == 9) {    // BLOCK_32X32 cell
    partition = p.split32[(mi_row / 8) * p.C + (mi_col / 8)]
                    ? PART_SPLIT : PART_NONE;
  } else {                    // BLOCK_64X64 superblock
    partition = PART_SPLIT;
  }
  const int above = (st.above_part[mi_col] >> bsl) & 1;
  const int lft = (st.left_part[mi_row & 15] >> bsl) & 1;
  const int ctx = (lft * 2 + above) + bsl * 4;
  uint16_t *cdf = p.part_cdf + ctx * 11;
  if (has_rows && has_cols) {
    st.e->encode_symbol(partition, cdf, 10);
  } else if (!has_rows && !has_cols) {
    // implied split, nothing coded
  } else {
    uint16_t g[3];
    gather_partition_cdf(cdf, /*horz=*/!has_cols, g);
    const int sym = partition == PART_SPLIT ? 1 : 0;
    const unsigned fl = sym > 0 ? g[sym - 1] : 32768;
    st.e->encode_q15(fl, g[sym], sym, 2);
  }
  if (partition == PART_NONE) {
    const bool is32 = bsize == 9;
    pack2_block(st, is32 ? y32 : y16, is32 ? uv16 : uv8, mi_row, mi_col,
                is32 ? 32 : 16);
    const int pa = static_cast<int>(is32 ? p.pctx_a32 : p.pctx_a16);
    const int pl = static_cast<int>(is32 ? p.pctx_l32 : p.pctx_l16);
    for (int i = 0; i < mi_w; ++i) st.above_part[mi_col + i] = pa;
    for (int i = 0; i < mi_w; ++i) st.left_part[(mi_row + i) & 15] = pl;
  } else {
    const int sub = bsize - 3;
    pack2_partition(st, y32, y16, uv16, uv8, mi_row, mi_col, sub);
    pack2_partition(st, y32, y16, uv16, uv8, mi_row, mi_col + hbs, sub);
    pack2_partition(st, y32, y16, uv16, uv8, mi_row + hbs, mi_col, sub);
    pack2_partition(st, y32, y16, uv16, uv8, mi_row + hbs, mi_col + hbs, sub);
  }
}

}  // namespace

extern "C" {

int ec_enc_pack_kf_part2(Encoder *e, const Pack2Params *params) {
  Pack2State st;
  st.p = params;
  st.e = e;
  const int mi_cols = static_cast<int>(params->mi_cols);
  const int mi_rows = static_cast<int>(params->mi_rows);
  const int ncols = (mi_cols + 15) / 16 * 16;
  st.above_part.assign(ncols, 0);
  st.above_mode.assign(ncols, 0);
  st.above_skip.assign(ncols, 0);
  st.above_ent_y.assign(ncols, 0);
  st.above_ent_u.assign(ncols / 2 + 1, 0);
  st.above_ent_v.assign(ncols / 2 + 1, 0);
  const Pack2Params &p = *params;
  TxBundle y32 = { p.txb_skip_y32, p.eob_y32, p.eobex_y32, p.beob_y32,
                   p.base_y32, p.br_y32, p.dcs_y, p.scan32, p.nzoff32,
                   static_cast<int>(p.eobn_y32), 32, 5 };
  TxBundle y16 = { p.txb_skip_y16, p.eob_y16, p.eobex_y16, p.beob_y16,
                   p.base_y16, p.br_y16, p.dcs_y, p.scan16, p.nzoff16,
                   static_cast<int>(p.eobn_y16), 16, 4 };
  TxBundle uv16 = { p.txb_skip_uv16, p.eob_uv16, p.eobex_uv16, p.beob_uv16,
                    p.base_uv16, p.br_uv16, p.dcs_uv, p.scan16, p.nzoff16,
                    static_cast<int>(p.eobn_uv16), 16, 4 };
  TxBundle uv8 = { p.txb_skip_uv8, p.eob_uv8, p.eobex_uv8, p.beob_uv8,
                   p.base_uv8, p.br_uv8, p.dcs_uv, p.scan8, p.nzoff8,
                   static_cast<int>(p.eobn_uv8), 8, 3 };
  for (int r0 = 0; r0 < mi_rows; r0 += 16) {
    std::memset(st.left_part, 0, sizeof(st.left_part));
    std::memset(st.left_mode, 0, sizeof(st.left_mode));
    std::memset(st.left_skip, 0, sizeof(st.left_skip));
    std::memset(st.left_ent_y, 0, sizeof(st.left_ent_y));
    std::memset(st.left_ent_u, 0, sizeof(st.left_ent_u));
    std::memset(st.left_ent_v, 0, sizeof(st.left_ent_v));
    for (int c0 = 0; c0 < mi_cols; c0 += 16)
      pack2_partition(st, y32, y16, uv16, uv8, r0, c0, 12 /*BLOCK_64X64*/);
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Symbol-script executor: the pack as data. Python (which knows the whole
// frame's final decisions) builds a flat op list mirroring the decoder's
// parse order; this loop plays it into the range coder. New syntax (inter
// modes, MVs, deltas) needs no new native code — only new script writers.
// Ops (5 x int32 per entry):
//   0: adaptive symbol      a=cdf_id, b=row, c=sym, d=nsyms
//   1: raw literal          a=value, b=nbits
//   2: coefficient txb      a=bundle_id | txb_skip_ctx<<8 | dc_sign_ctx<<16
//                              | mode<<24,  b=levels_index, c=eob, d=unused
//      (writes txb_skip, optional tx-type, eob prefix, then the coeff loops;
//       levels buffer = levels_base + levels_index * bundle.n)
// CDF registry: cdf_ptrs[cdf_id] with cdf_strides[cdf_id] (uint16 rows,
// adapted in place, same update_cdf as everywhere).
// ---------------------------------------------------------------------------

extern "C" {

struct ScriptBundle {   // per-tx-size coeff tables (mirror of TxBundle)
  uint16_t *txb_skip, *eob, *eobex, *beob, *base, *br, *dcs;
  const int32_t *scan, *nzoff;
  int64_t eob_nsyms, width, bhl, n;   // n = width*width levels per block
  uint16_t *ext_tx;                   // nullptr when tx type not coded
  int64_t ext_nsyms, ext_sym, ext_stride;
};

int ec_enc_run_script(Encoder *e, const int32_t *ops, long n_ops,
                      uint16_t **cdf_ptrs, const int64_t *cdf_strides,
                      const ScriptBundle *bundles,
                      const int32_t *levels_base,
                      const int32_t *eob_group_start,
                      const int32_t *eob_offset_bits) {
  for (long i = 0; i < n_ops; ++i) {
    const int32_t *o = ops + i * 5;
    switch (o[0]) {
      case 0:
        e->encode_symbol(o[3], cdf_ptrs[o[1]] + o[2] * cdf_strides[o[1]],
                         o[4]);
        break;
      case 1:
        e->write_literal(static_cast<unsigned>(o[1]), o[2]);
        break;
      case 2: {
        const int bid = o[1] & 0xFF;
        const int skip_ctx = (o[1] >> 8) & 0xFF;
        const int dctx = (o[1] >> 16) & 0xFF;
        const int mode = (o[1] >> 24) & 0x7F;
        const ScriptBundle &tb = bundles[bid];
        const int eob = o[3];
        e->encode_symbol(eob == 0 ? 1 : 0, tb.txb_skip + skip_ctx * 3, 2);
        if (eob == 0) break;
        if (tb.ext_tx)
          e->encode_symbol(static_cast<int>(tb.ext_sym),
                           tb.ext_tx + mode * tb.ext_stride,
                           static_cast<int>(tb.ext_nsyms));
        int eob_pt = 0;
        while (eob_pt + 1 < 12 && eob_group_start[eob_pt + 1] <= eob)
          ++eob_pt;
        const int eob_extra = eob - eob_group_start[eob_pt];
        e->encode_symbol(eob_pt - 1, tb.eob,
                         static_cast<int>(tb.eob_nsyms));
        const int ofs_bits = eob_offset_bits[eob_pt];
        if (ofs_bits > 0) {
          e->encode_symbol((eob_extra >> (ofs_bits - 1)) & 1,
                           tb.eobex + (eob_pt - 3) * 3, 2);
          for (int k = 1; k < ofs_bits; ++k)
            e->write_bit((eob_extra >> (ofs_bits - 1 - k)) & 1);
        }
        ec_enc_coeffs(e, levels_base + static_cast<long>(o[2]) * tb.n,
                      static_cast<int>(tb.width), static_cast<int>(tb.width),
                      static_cast<int>(tb.bhl), eob, tb.scan, 0, tb.nzoff,
                      tb.beob, 4, tb.base, 5, tb.br, 5, tb.dcs + dctx * 3);
        break;
      }
      case 3: {  // gathered partition bit at a partial frame edge:
                 // a=cdf_id, b=row, c=sym, d=horz_flag (non-adaptive)
        uint16_t g[3];
        gather_partition_cdf(cdf_ptrs[o[1]] + o[2] * cdf_strides[o[1]],
                             o[4] != 0, g);
        const int sym = o[3];
        const unsigned fl = sym > 0 ? g[sym - 1] : 32768;
        e->encode_q15(fl, g[sym], sym, 2);
        break;
      }
      default:
        return 1;
    }
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// The inter frame's symbol walk: the ops of the script above for a P-frame
// of the device inter plan (encoder/tpu_interframe.py, script_ops_plain is
// the same walk in Python). 64x64 superblocks in raster order, each split
// into 32x32 cells, each coded whole or split into four 16x16 blocks; every
// block inter, single reference LAST, one tile. The frame state is the
// slice the encoder's header fixes (checked by the caller): identity global
// motion (the global MV is (0, 0) and no candidate is a global block), no
// temporal candidates, no high-precision MVs, no integer MVs. So the MV
// reference search is setup_ref_mv_list (av1/common/mvref_common.c:474)
// for one reference and square blocks: the nearest row / column / top-right
// scans, the outer ring, the weight sort and the single-reference fill.
// Ops are written in the decoder's parse order into ``ops`` (cap rows of 5
// int32); cdf ids and bundle ids follow the caller's registry.
// ---------------------------------------------------------------------------

extern "C" {

struct InterWalkParams {  // mirrored by ctypes in ec/native_coder.py
  const uint8_t *split32;   // (Rc, Cc)
  const int32_t *mv8;       // (R2, C2, 2): (row, col) in 1/8 pel
  const uint8_t *skip32;    // (Rc, Cc)
  const uint8_t *skip16;    // (R2, C2)
  const int32_t *y_eob32, *y_eob16;    // (Rc, Cc), (R2, C2)
  const int32_t *uv_eob16, *uv_eob8;   // (2, Rc, Cc), (2, R2, C2)
  const int32_t *cul_y32, *cul_y16;    // entropy-context bytes of each txb
  const int32_t *cul_u16, *cul_v16, *cul_u8, *cul_v8;
  const int64_t *roff;      // element offset of each level-store region
  int32_t *ops;             // out: (cap, 5)
  int64_t Rc, Cc, mi_rows, mi_cols, nplanes, cap;
  int64_t pctx_a32, pctx_l32, pctx_a16, pctx_l16;  // PARTITION_CTX_* values
  int64_t blocks;           // out: blocks walked
};

}  // extern "C"

namespace {

// script registry (tpu_interframe.py's CDF and bundle order)
enum { kCdfPart, kCdfSkip, kCdfIntraInter, kCdfSingleRef, kCdfNewmv,
       kCdfZeromv, kCdfRefmv, kCdfDrl, kCdfJoint, kCdfComp0 };
enum { kBndY32, kBndY16, kBndUv16, kBndUv8 };
enum { kNearest = 13, kNear = 14, kGlobal = 15, kNew = 16 };
constexpr int kRefCatLevel = 640;
constexpr int kMaxRefMvStack = 8;
constexpr int kMvBorder = 16 << 3;

struct WalkMi {      // the coded block covering one mi (mi_grid_base)
  int32_t mv[2];
  uint8_t n4;        // block width (= height) in mi; 0 = not yet coded
  uint8_t skip, is_inter, newmv;
};

struct RefMvs {
  int32_t mv[kMaxRefMvStack][2];
  int weight[kMaxRefMvStack];
  int count;
};

struct WalkState {
  const InterWalkParams *p;
  int mi_rows, mi_cols, Cc, C2;
  std::vector<WalkMi> mi;
  std::vector<int32_t> above_part;
  int32_t left_part[16];
  std::vector<uint8_t> aent[3];
  uint8_t lent[3][16];
  long n;
  int fault;         // 1: ops past cap; 2: a read of an uncoded mi

  void op(int t, int a, int b, int c, int d) {
    if (n >= p->cap) {
      fault = 1;
      return;
    }
    int32_t *o = p->ops + n * 5;
    o[0] = t; o[1] = a; o[2] = b; o[3] = c; o[4] = d;
    ++n;
  }
  const WalkMi &at(int r, int c) {
    const WalkMi &m = mi[static_cast<long>(r) * mi_cols + c];
    if (m.n4 == 0) fault = 2;
    return m;
  }
};

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

inline void add_ref_mv_candidate(const WalkMi &cand, int weight, RefMvs &s,
                                 int &match, int &newmv) {
  if (!cand.is_inter) return;
  int i = 0;
  while (i < s.count && !(s.mv[i][0] == cand.mv[0] &&
                          s.mv[i][1] == cand.mv[1]))
    ++i;
  if (i < s.count) {
    s.weight[i] += weight;
  } else if (s.count < kMaxRefMvStack) {
    s.mv[s.count][0] = cand.mv[0];
    s.mv[s.count][1] = cand.mv[1];
    s.weight[s.count] = weight;
    ++s.count;
  }
  if (cand.newmv) ++newmv;
  ++match;
}

// scan_row / scan_col of a square block of w mi; vertical picks the column
void scan_line(WalkState &st, int mi_row, int mi_col, int w, int offset,
               int max_offset, bool vertical, int &processed, RefMvs &s,
               int &match, int &newmv) {
  const int room = vertical ? st.mi_rows - mi_row : st.mi_cols - mi_col;
  int end_mi = w < room ? w : room;
  if (end_mi > 16) end_mi = 16;
  int across = 0;
  if (offset < -1 || offset > 1) {
    across = 1;
    if (((vertical ? mi_row : mi_col) & 1) && w < 2) across = 0;
  }
  const bool step16 = w >= 16;
  for (int i = 0; i < end_mi;) {
    const int r = vertical ? mi_row + across + i : mi_row + offset;
    const int c = vertical ? mi_col + offset : mi_col + across + i;
    if (r < 0 || c < 0 || r >= st.mi_rows || c >= st.mi_cols) {
      st.fault = 2;
      return;
    }
    const WalkMi &cand = st.at(r, c);
    if (st.fault) return;
    const int n4 = cand.n4;
    int len = w < n4 ? w : n4;
    if (step16) {
      if (len < 4) len = 4;
    } else if (offset < -1 || offset > 1) {
      if (len < 2) len = 2;
    }
    int weight = 2;
    if (w >= 2 && w <= n4) {
      int inc = -max_offset + offset + 1;
      if (inc > n4) inc = n4;
      if (inc > weight) weight = inc;
      processed = inc - offset - 1;
    }
    add_ref_mv_candidate(cand, len * weight, s, match, newmv);
    i += len;
  }
}

void scan_point(WalkState &st, int mi_row, int mi_col, int row_off,
                int col_off, RefMvs &s, int &match, int &newmv) {
  const int r = mi_row + row_off, c = mi_col + col_off;
  if (r < 0 || c < 0 || r >= st.mi_rows || c >= st.mi_cols) return;
  const WalkMi &cand = st.at(r, c);
  if (st.fault) return;
  add_ref_mv_candidate(cand, 4, s, match, newmv);
}

bool has_top_right(int mi_row, int mi_col, int bs) {
  const int mask_row = mi_row & 15, mask_col = mi_col & 15;
  if (bs > 16) return false;
  bool has_tr = !((mask_row & bs) && (mask_col & bs));
  for (int b = bs; b < 16; b <<= 1) {
    if (!(mask_col & b)) break;
    if ((mask_col & (2 * b)) && (mask_row & (2 * b))) {
      has_tr = false;
      break;
    }
  }
  return has_tr;
}

// setup_ref_mv_list for LAST and a square block of w mi. Returns mode_ctx;
// s holds the clamped, sorted stack, list the two reference MVs.
int find_ref_mvs(WalkState &st, int mi_row, int mi_col, int w, RefMvs &s,
                 int32_t list[2][2]) {
  s.count = 0;
  for (int i = 0; i < kMaxRefMvStack; ++i) s.weight[i] = 0;
  const bool up = mi_row > 0, left = mi_col > 0;
  const int max_row_offset = up ? clampi(-6, -mi_row, st.mi_rows - mi_row - 1)
                                : 0;
  const int max_col_offset = left ? clampi(-6, -mi_col,
                                           st.mi_cols - mi_col - 1) : 0;
  int processed_rows = 0, processed_cols = 0;
  int row_match = 0, col_match = 0, newmv = 0, match;
  if (max_row_offset <= -1) {
    match = 0;
    scan_line(st, mi_row, mi_col, w, -1, max_row_offset, false,
              processed_rows, s, match, newmv);
    row_match += match;
  }
  if (max_col_offset <= -1) {
    match = 0;
    scan_line(st, mi_row, mi_col, w, -1, max_col_offset, true,
              processed_cols, s, match, newmv);
    col_match += match;
  }
  if (has_top_right(mi_row, mi_col, w)) {
    match = 0;
    scan_point(st, mi_row, mi_col, -1, w, s, match, newmv);
    row_match += match;
  }
  const int newmv_count = newmv;
  const int nearest_match = (row_match > 0) + (col_match > 0);
  const int nearest_count = s.count;
  for (int i = 0; i < nearest_count; ++i) s.weight[i] += kRefCatLevel;

  // the outer ring (its new-MV counts go nowhere)
  match = 0;
  scan_point(st, mi_row, mi_col, -1, -1, s, match, newmv);
  row_match += match;
  for (int idx = 2; idx <= 3; ++idx) {
    const int off = -(idx << 1) + 1;
    if (-off <= -max_row_offset && -off > processed_rows) {
      match = 0;
      scan_line(st, mi_row, mi_col, w, off, max_row_offset, false,
                processed_rows, s, match, newmv);
      row_match += match;
    }
    if (-off <= -max_col_offset && -off > processed_cols) {
      match = 0;
      scan_line(st, mi_row, mi_col, w, off, max_col_offset, true,
                processed_cols, s, match, newmv);
      col_match += match;
    }
  }
  if (st.fault) return 0;

  const int ref_match = (row_match > 0) + (col_match > 0);
  int mode_ctx = 0;
  if (nearest_match == 0) {
    if (ref_match >= 1) mode_ctx |= 1;
    if (ref_match == 1) mode_ctx |= 1 << 4;
    else if (ref_match >= 2) mode_ctx |= 2 << 4;
  } else if (nearest_match == 1) {
    mode_ctx |= newmv_count > 0 ? 2 : 3;
    if (ref_match == 1) mode_ctx |= 3 << 4;
    else if (ref_match >= 2) mode_ctx |= 4 << 4;
  } else {
    mode_ctx |= newmv_count >= 1 ? 4 : 5;
    mode_ctx |= 5 << 4;
  }

  // the weight sort, nearest and outer apart
  auto sort_range = [&s](int lo, int hi) {
    int len = hi;
    while (len > lo) {
      int nr_len = lo;
      for (int i = lo + 1; i < len; ++i) {
        if (s.weight[i - 1] < s.weight[i]) {
          std::swap(s.mv[i - 1][0], s.mv[i][0]);
          std::swap(s.mv[i - 1][1], s.mv[i][1]);
          std::swap(s.weight[i - 1], s.weight[i]);
          nr_len = i;
        }
      }
      len = nr_len;
    }
  };
  sort_range(0, nearest_count);
  sort_range(nearest_count, s.count);

  // fewer than two: the above row's and left column's MVs, unweighted
  int mi_size = w;
  if (mi_size > 16) mi_size = 16;
  if (mi_size > st.mi_cols - mi_col) mi_size = st.mi_cols - mi_col;
  if (mi_size > st.mi_rows - mi_row) mi_size = st.mi_rows - mi_row;
  for (int pass = 0; pass < 2; ++pass) {
    const bool col = pass == 1;
    if ((col ? max_col_offset : max_row_offset) > -1) continue;
    for (int idx = 0; idx < mi_size && s.count < 2;) {
      const WalkMi &cand = col ? st.at(mi_row + idx, mi_col - 1)
                               : st.at(mi_row - 1, mi_col + idx);
      if (st.fault) return 0;
      int k = 0;
      while (k < s.count && !(s.mv[k][0] == cand.mv[0] &&
                              s.mv[k][1] == cand.mv[1]))
        ++k;
      if (k == s.count) {
        s.mv[s.count][0] = cand.mv[0];
        s.mv[s.count][1] = cand.mv[1];
        s.weight[s.count] = 2;
        ++s.count;
      }
      idx += cand.n4;
    }
  }

  // clamp_mv_ref
  const int bpx8 = w * 4 * 8;
  const int lo_row = -(mi_row * 32) - bpx8 - kMvBorder;
  const int hi_row = (st.mi_rows - w - mi_row) * 32 + bpx8 + kMvBorder;
  const int lo_col = -(mi_col * 32) - bpx8 - kMvBorder;
  const int hi_col = (st.mi_cols - w - mi_col) * 32 + bpx8 + kMvBorder;
  for (int i = 0; i < s.count; ++i) {
    s.mv[i][0] = clampi(s.mv[i][0], lo_row, hi_row);
    s.mv[i][1] = clampi(s.mv[i][1], lo_col, hi_col);
  }
  for (int i = 0; i < 2; ++i) {
    list[i][0] = i < s.count ? s.mv[i][0] : 0;
    list[i][1] = i < s.count ? s.mv[i][1] : 0;
  }
  return mode_ctx;
}

inline int drl_ctx(const RefMvs &s, int idx) {
  const bool a = s.weight[idx] >= kRefCatLevel;
  const bool b = s.weight[idx + 1] >= kRefCatLevel;
  if (a && !b) return 1;
  if (!a && !b) return 2;
  return 0;
}

inline int lower_mv(int v) {   // lower_mv_precision without high precision
  return (v & 1) ? v + (v > 0 ? -1 : 1) : v;
}

// encode_mv (av1/encoder/encodemv.c) of mv - ref, precision 1
void mv_ops(WalkState &st, const int32_t mv[2], const int32_t ref[2]) {
  const int diff[2] = { mv[0] - ref[0], mv[1] - ref[1] };
  st.op(0, kCdfJoint, 0, 2 * (diff[0] != 0) + (diff[1] != 0), 4);
  for (int comp = 0; comp < 2; ++comp) {
    if (diff[comp] == 0) continue;
    const int base = kCdfComp0 + comp * 8;
    const int sign = diff[comp] < 0;
    const int z = (sign ? -diff[comp] : diff[comp]) - 1;
    int mv_class = 0;
    for (int q = z >> 3; q > 1; q >>= 1) ++mv_class;
    if (mv_class > 10) mv_class = 10;
    const int offset = z - (mv_class == 0 ? 0 : 2 << (mv_class + 2));
    const int d = offset >> 3, fr = (offset >> 1) & 3;
    st.op(0, base + 0, 0, sign, 2);
    st.op(0, base + 1, 0, mv_class, 11);
    if (mv_class == 0) {
      st.op(0, base + 2, 0, d, 2);
      st.op(0, base + 4, d, fr, 4);
    } else {
      for (int i = 0; i < mv_class; ++i) st.op(0, base + 3, i, (d >> i) & 1, 2);
      st.op(0, base + 5, 0, fr, 4);
    }
  }
}

inline void ent_update(uint8_t *a, uint8_t *l, int wu, int cul, int vis_w,
                       int vis_h) {
  std::memset(a, cul, vis_w);
  std::memset(a + vis_w, 0, wu - vis_w);
  std::memset(l, cul, vis_h);
  std::memset(l + vis_h, 0, wu - vis_h);
}

inline int lv_index(const InterWalkParams &p, int region, long block, int n) {
  return static_cast<int>((p.roff[region] + block * n) / n);
}

void walk_block(WalkState &st, int mi_row, int mi_col, int bs) {
  const InterWalkParams &p = *st.p;
  const int w = bs / 4;
  const int r32 = mi_row / 8, c32 = mi_col / 8;
  const int r16 = mi_row / 4, c16 = mi_col / 4;
  const bool up = mi_row > 0, left = mi_col > 0;
  const long b32 = static_cast<long>(r32) * st.Cc + c32;
  const long b16 = static_cast<long>(r16) * st.C2 + c16;
  const long blk = bs == 32 ? b32 : b16;
  const int skip = bs == 32 ? p.skip32[b32] : p.skip16[b16];
  const int32_t *m8 = p.mv8 + (bs == 32 ? 2 * r32 * st.C2 + 2 * c32 : b16) * 2;
  const int32_t mv[2] = { m8[0], m8[1] };

  RefMvs s;
  int32_t list[2][2];
  const int mode_ctx = find_ref_mvs(st, mi_row, mi_col, w, s, list);
  if (st.fault) return;
  const int32_t nearest[2] = { lower_mv(list[0][0]), lower_mv(list[0][1]) };
  const int32_t near[2] = { lower_mv(list[1][0]), lower_mv(list[1][1]) };
  int mode;
  if (mv[0] == nearest[0] && mv[1] == nearest[1]) mode = kNearest;
  else if (mv[0] == near[0] && mv[1] == near[1]) mode = kNear;
  else if (mv[0] == 0 && mv[1] == 0) mode = kGlobal;
  else mode = kNew;

  // ---- syntax (decoder parse order) ----
  const WalkMi *above = up ? &st.at(mi_row - 1, mi_col) : nullptr;
  const WalkMi *lmb = left ? &st.at(mi_row, mi_col - 1) : nullptr;
  if (st.fault) return;
  st.op(0, kCdfSkip, (above ? above->skip : 0) + (lmb ? lmb->skip : 0), skip,
        2);
  int ctx = 0;
  if (above && lmb) {
    const bool ai = !above->is_inter, li = !lmb->is_inter;
    ctx = (ai && li) ? 3 : (ai || li);
  } else if (above || lmb) {
    ctx = 2 * !(above ? above : lmb)->is_inter;
  }
  st.op(0, kCdfIntraInter, ctx, 1, 2);
  // single_ref_p1, p3, p4 all vote LAST neighbours against none
  const int last = (above && above->is_inter) + (lmb && lmb->is_inter);
  const int rctx = last ? 2 : 1;
  st.op(0, kCdfSingleRef, rctx * 6 + 0, 0, 2);
  st.op(0, kCdfSingleRef, rctx * 6 + 2, 0, 2);
  st.op(0, kCdfSingleRef, rctx * 6 + 3, 0, 2);
  st.op(0, kCdfNewmv, mode_ctx & 7, mode != kNew, 2);
  if (mode != kNew) {
    st.op(0, kCdfZeromv, (mode_ctx >> 3) & 1, mode != kGlobal, 2);
    if (mode != kGlobal)
      st.op(0, kCdfRefmv, (mode_ctx >> 4) & 15, mode != kNearest, 2);
  }
  if (mode == kNew && s.count > 1) st.op(0, kCdfDrl, drl_ctx(s, 0), 0, 2);
  if (mode == kNear && s.count > 2) st.op(0, kCdfDrl, drl_ctx(s, 1), 0, 2);
  if (mode == kNew) mv_ops(st, mv, s.count <= 1 ? nearest : s.mv[0]);

  // ---- store the block's mode info ----
  const WalkMi cur = { { mv[0], mv[1] }, static_cast<uint8_t>(w),
                       static_cast<uint8_t>(skip), 1,
                       static_cast<uint8_t>(mode == kNew) };
  const int r1 = mi_row + w < st.mi_rows ? mi_row + w : st.mi_rows;
  const int c1 = mi_col + w < st.mi_cols ? mi_col + w : st.mi_cols;
  for (int r = mi_row; r < r1; ++r)
    for (int c = mi_col; c < c1; ++c)
      st.mi[static_cast<long>(r) * st.mi_cols + c] = cur;

  // ---- residual ----
  const int wu = w, cwu = wu / 2;
  const int acol = mi_col, lrow = mi_row & 15;
  const int cacol = mi_col >> 1, clrow = (mi_row & 15) >> 1;
  const int vis_w = wu < st.mi_cols - mi_col ? wu : st.mi_cols - mi_col;
  const int vis_h = wu < st.mi_rows - mi_row ? wu : st.mi_rows - mi_row;
  int cvw = (vis_w * 4 >> 1) >> 2, cvh = (vis_h * 4 >> 1) >> 2;
  if (cvw > cwu) cvw = cwu;
  if (cvh > cwu) cvh = cwu;
  const bool chroma = p.nplanes > 1;
  if (skip) {
    ent_update(st.aent[0].data() + acol, st.lent[0] + lrow, wu, 0, wu, wu);
    if (chroma)
      for (int pl = 1; pl < 3; ++pl)
        ent_update(st.aent[pl].data() + cacol, st.lent[pl] + clrow, cwu, 0,
                   cwu, cwu);
    return;
  }
  int dctx = dc_sign_ctx_from(st.aent[0].data() + acol, wu, st.lent[0] + lrow,
                              wu);
  int cul;
  if (bs == 32) {
    st.op(2, kBndY32 | (dctx << 16), lv_index(p, 0, blk, 1024), p.y_eob32[blk],
          0);
    cul = p.cul_y32[blk];
  } else {
    st.op(2, kBndY16 | (dctx << 16), lv_index(p, 1, blk, 256), p.y_eob16[blk],
          0);
    cul = p.cul_y16[blk];
  }
  ent_update(st.aent[0].data() + acol, st.lent[0] + lrow, wu, cul, vis_w,
             vis_h);
  if (!chroma) return;
  const long n32 = static_cast<long>(st.Cc) * (p.Rc);
  const long n16 = 4 * n32;
  for (int pl = 1; pl < 3; ++pl) {
    uint8_t *a = st.aent[pl].data() + cacol;
    uint8_t *l = st.lent[pl] + clrow;
    int any_a = 0, any_l = 0;
    for (int k = 0; k < cwu; ++k) any_a |= a[k];
    for (int k = 0; k < cwu; ++k) any_l |= l[k];
    const int sctx = (any_a != 0) + (any_l != 0) + 7;
    dctx = dc_sign_ctx_from(a, cwu, l, cwu);
    if (bs == 32) {
      st.op(2, kBndUv16 | (sctx << 8) | (dctx << 16),
            lv_index(p, 1 + pl, blk, 256), p.uv_eob16[(pl - 1) * n32 + blk],
            0);
      cul = (pl == 1 ? p.cul_u16 : p.cul_v16)[blk];
    } else {
      st.op(2, kBndUv8 | (sctx << 8) | (dctx << 16),
            lv_index(p, 3 + pl, blk, 64), p.uv_eob8[(pl - 1) * n16 + blk], 0);
      cul = (pl == 1 ? p.cul_u8 : p.cul_v8)[blk];
    }
    ent_update(a, l, cwu, cul, cvw, cvh);
  }
}

void walk_partition(WalkState &st, int mi_row, int mi_col, int bsize,
                    long &blocks) {
  const InterWalkParams &p = *st.p;
  if (mi_row >= st.mi_rows || mi_col >= st.mi_cols || st.fault) return;
  const int bsl = (bsize - 3) / 3;
  const int mi_w = 2 << bsl;
  const int hbs = mi_w / 2;
  const bool has_rows = mi_row + hbs < st.mi_rows;
  const bool has_cols = mi_col + hbs < st.mi_cols;
  int partition;
  if (bsize == 6) partition = PART_NONE;          // BLOCK_16X16
  else if (bsize == 9)                            // BLOCK_32X32
    partition = p.split32[(mi_row / 8) * st.Cc + mi_col / 8] ? PART_SPLIT
                                                              : PART_NONE;
  else partition = PART_SPLIT;                    // BLOCK_64X64
  const int above = (st.above_part[mi_col] >> bsl) & 1;
  const int lft = (st.left_part[mi_row & 15] >> bsl) & 1;
  const int ctx = (lft * 2 + above) + bsl * 4;
  if (has_rows && has_cols)
    st.op(0, kCdfPart, ctx, partition, 10);
  else if (has_rows || has_cols)
    st.op(3, kCdfPart, ctx, partition == PART_SPLIT, !has_cols);
  if (partition == PART_NONE) {
    const bool is32 = bsize == 9;
    walk_block(st, mi_row, mi_col, is32 ? 32 : 16);
    ++blocks;
    const int pa = static_cast<int>(is32 ? p.pctx_a32 : p.pctx_a16);
    const int pl = static_cast<int>(is32 ? p.pctx_l32 : p.pctx_l16);
    for (int i = 0; i < mi_w; ++i) st.above_part[mi_col + i] = pa;
    for (int i = 0; i < mi_w; ++i) st.left_part[(mi_row + i) & 15] = pl;
  } else {
    const int sub = bsize - 3;
    walk_partition(st, mi_row, mi_col, sub, blocks);
    walk_partition(st, mi_row, mi_col + hbs, sub, blocks);
    walk_partition(st, mi_row + hbs, mi_col, sub, blocks);
    walk_partition(st, mi_row + hbs, mi_col + hbs, sub, blocks);
  }
}

}  // namespace

extern "C" {

// Returns the number of ops written, -1 when they would pass cap, -2 when
// the walk would read a block not yet coded (a malformed plan).
long ec_inter_script_walk(InterWalkParams *params) {
  WalkState st;
  st.p = params;
  st.mi_rows = static_cast<int>(params->mi_rows);
  st.mi_cols = static_cast<int>(params->mi_cols);
  st.Cc = static_cast<int>(params->Cc);
  st.C2 = 2 * st.Cc;
  st.n = 0;
  st.fault = 0;
  const int ncols = (st.mi_cols + 15) / 16 * 16;
  st.mi.assign(static_cast<long>(st.mi_rows) * st.mi_cols, WalkMi());
  st.above_part.assign(ncols, 0);
  for (int pl = 0; pl < 3; ++pl) st.aent[pl].assign(ncols, 0);
  long blocks = 0;
  for (int r0 = 0; r0 < st.mi_rows && !st.fault; r0 += 16) {
    std::memset(st.left_part, 0, sizeof(st.left_part));
    std::memset(st.lent, 0, sizeof(st.lent));
    for (int c0 = 0; c0 < st.mi_cols; c0 += 16)
      walk_partition(st, r0, c0, 12 /*BLOCK_64X64*/, blocks);
  }
  params->blocks = blocks;
  if (st.fault) return -st.fault;
  return st.n;
}

}  // extern "C"
