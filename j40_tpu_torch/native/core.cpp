// j40_tpu native host core: hot serial decode loops (entropy, modular
// prediction, VarDCT HF coefficients).
//
// The TPU handles all pixel math; this library handles the inherently
// sequential bitstream work that dominates host time.  Semantics mirror the
// Python oracle modules (j40_tpu.entropy / j40_tpu.modular) which are kept as
// correctness references; both are validated against the reference dj40
// binary (reference: j40.h bitstream/entropy/modular layers).
//
// C ABI, consumed via ctypes.  No global state: every call operates on
// caller-provided buffers.  Build: make -C j40_tpu/native

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <type_traits>
#include <unordered_map>
#include <vector>

#define J40T_API extern "C" __attribute__((visibility("default")))
#define J40T_RESTRICT __restrict__

namespace {

// ---------------------------------------------------------------- bit reader

struct Bits {
  const uint8_t* data;
  int64_t size;     // bytes
  int64_t pos;      // next byte
  uint64_t bits;    // accumulator, LSB-first
  int32_t nbits;
  bool overrun;     // set when reads run past the end ("shrt")

  inline void refill() {
    if (pos + 8 <= size) {
      // branch-free bulk refill: load 8 bytes, take what fits
      uint64_t chunk;
      memcpy(&chunk, data + pos, 8);
      bits |= chunk << nbits;
      int32_t take = (63 - nbits) >> 3;
      pos += take;
      nbits += take * 8;
      // restore the invariant bits >> nbits == 0 (partial top byte)
      bits &= ~(uint64_t)0 >> (64 - nbits);
      return;
    }
    while (nbits <= 56 && pos < size) {
      bits |= (uint64_t)data[pos++] << nbits;
      nbits += 8;
    }
  }
  inline uint32_t u(int32_t n) {
    if (n == 0) return 0;
    if (nbits < n) {
      refill();
      if (nbits < n) { overrun = true; }
    }
    uint32_t ret = (uint32_t)(bits & (((uint64_t)1 << n) - 1));
    bits >>= n;
    nbits -= n;
    if (nbits < 0) { bits = 0; nbits = 0; }
    return ret;
  }
  // peek up to n bits zero-padded (for prefix codes near EOF)
  inline uint64_t peek(int32_t n) {
    if (nbits < n) refill();
    return bits & (((uint64_t)1 << n) - 1);
  }
  inline void consume(int32_t n) {
    if (n > nbits) { overrun = true; bits = 0; nbits = 0; return; }
    bits >>= n;
    nbits -= n;
  }
  inline int64_t bit_position() const { return pos * 8 - nbits; }
  void seek_bits(int64_t bitpos) {
    pos = bitpos >> 3;
    bits = 0;
    nbits = 0;
    overrun = false;
    int32_t rem = (int32_t)(bitpos & 7);
    if (rem) u(rem);
  }
};

// ------------------------------------------------------------- prefix codes

// two-level LUT like the reference (j40.h:2030-2043), rebuilt from lengths
struct PrefixTable {
  int32_t fast_len = 0, max_len = 0;
  std::vector<int32_t> table;  // entry: sym<<16 | (code>>fast_len)<<4 | len
  int32_t single_symbol = -1;  // zero-bit code

  // decode: mirrors j40__prefix_code (j40.h:2256-2273)
  inline int32_t decode(Bits& br) const {
    if (single_symbol >= 0) return single_symbol;
    if (br.nbits < max_len) br.refill();
    int32_t entry = table[br.bits & (((uint64_t)1 << fast_len) - 1)];
    if (entry < 0 && fast_len < max_len) {
      // overflow entries
      uint64_t rest = (br.bits >> fast_len);
      const int32_t* p = table.data() + (-entry);
      for (;;) {
        int32_t e = *p++;
        int32_t code = (e >> 4) & 0xfff;
        int32_t code_len = e & 15;
        if (code == (int32_t)(rest & (((uint64_t)1 << code_len) - 1))) {
          entry = e;
          break;
        }
      }
      int32_t code_len = (entry & 15) + fast_len;
      br.consume(code_len);
      return entry >> 16;
    }
    br.consume(entry & 15);
    return entry >> 16;
  }
};

// build from per-symbol entries (len | LSB-first pattern << 4); returns
// false on invalid code.  Patterns travel explicitly because simple flat-4
// codes are not canonical (j40.h:2091).
static bool build_prefix(const int32_t* entries, int32_t n, PrefixTable* out) {
  std::vector<int32_t> lengths_v((size_t)n);
  for (int32_t i = 0; i < n; ++i) lengths_v[(size_t)i] = entries[i] & 15;
  const int32_t* lengths = lengths_v.data();
  int32_t max_len = 0, nonzero = 0, only = -1;
  for (int32_t i = 0; i < n; ++i) {
    if (lengths[i] > 0) { ++nonzero; only = i; if (lengths[i] > max_len) max_len = lengths[i]; }
  }
  if (nonzero == 0) return false;
  if (nonzero == 1) { out->single_symbol = only; out->fast_len = out->max_len = 0; return true; }
  if (max_len > 15) return false;

  int32_t counts[16] = {0};
  for (int32_t i = 0; i < n; ++i) if (lengths[i]) ++counts[lengths[i]];

  // choose fast_len like the reference (j40.h:2186-2212)
  int32_t fast_len = max_len <= 7 ? max_len : 7;
  int32_t size_used = 1 << fast_len;
  if (max_len > 7) {
    int32_t size = 1 << fast_len;
    for (int32_t i = fast_len + 1; i <= max_len; ++i) size += counts[i];
    size_used = size;
    int32_t size_limit = size * 2;
    for (int32_t i = fast_len + 1; i <= max_len; ++i) {
      size = size + (1 << i) - counts[i];
      if (size <= size_limit) { size_used = size; fast_len = i; }
    }
  }
  out->fast_len = fast_len;
  out->max_len = max_len;
  out->table.assign((size_t)size_used + 1, 0);

  int32_t starts[17], overflows[17];
  starts[1] = 0;
  for (int32_t i = 2; i <= max_len; ++i)
    starts[i] = starts[i - 1] + (counts[i - 1] << (max_len - (i - 1)));
  // kraft check
  {
    int64_t total = 0;
    for (int32_t i = 1; i <= max_len; ++i) total += (int64_t)counts[i] << (max_len - i);
    if (total != (int64_t)1 << max_len) return false;
  }
  if (fast_len < max_len) {
    overflows[fast_len + 1] = 1 << fast_len;
    for (int32_t i = fast_len + 2; i <= max_len; ++i)
      overflows[i] = overflows[i - 1] + counts[i - 1];
  }

  for (int32_t i = 0; i < n; ++i) {
    int32_t len = lengths[i];
    if (!len) continue;
    int32_t start = starts[len];
    starts[len] += (1 << max_len) >> len;
    uint32_t code = (uint32_t)(entries[i] >> 4);
    (void)start;
    if (len <= fast_len) {
      for (int32_t c = (int32_t)code; c < (1 << fast_len); c += 1 << len)
        out->table[c] = (i << 16) | len;
    } else {
      // exactly one code per overflow group is a LUT-covered prefix plus
      // zeroes; point the LUT slot at its first overflow entry (j40.h:2227)
      if ((code >> fast_len) == 0)
        out->table[code] = -overflows[len];
      out->table[overflows[len]++] =
          (i << 16) | ((int32_t)(code >> fast_len) << 4) | (len - fast_len);
    }
  }
  return true;
}

// ------------------------------------------------------------------- rANS

struct AliasBucket { int16_t cutoff, offset, symbol; };

static bool build_alias(const int16_t* D, int32_t log_alpha, std::vector<AliasBucket>* out) {
  const int32_t DIST_BITS = 12;
  int32_t log_bucket = DIST_BITS - log_alpha;
  int32_t bucket_size = 1 << log_bucket;
  int32_t table_size = 1 << log_alpha;
  out->assign((size_t)table_size, AliasBucket{0, 0, 0});
  auto& b = *out;

  int32_t nonzero = 0, only = -1;
  for (int32_t i = 0; i < table_size; ++i) if (D[i]) { ++nonzero; if (only < 0) only = i; }
  if (nonzero == 1) {
    for (int32_t j = 0; j < table_size; ++j) {
      b[j].symbol = (int16_t)only;
      b[j].offset = (int16_t)(j << log_bucket);
      b[j].cutoff = 0;
    }
    return true;
  }

  std::vector<int16_t> next(table_size);
  int32_t u = -1, o = -1;
  for (int32_t i = 0; i < table_size; ++i) {
    int16_t cutoff = D[i];
    b[i].cutoff = cutoff;
    if (cutoff > bucket_size) { next[i] = (int16_t)o; o = i; }
    else if (cutoff < bucket_size) { next[i] = (int16_t)u; u = i; }
    else { b[i].symbol = (int16_t)i; b[i].offset = 0; }
  }
  while (o >= 0) {
    if (u < 0) return false;
    int32_t by = bucket_size - b[u].cutoff;
    int32_t nu = next[u];
    b[o].cutoff = (int16_t)(b[o].cutoff - by);
    b[u].symbol = (int16_t)o;
    b[u].offset = (int16_t)(b[o].cutoff - b[u].cutoff);
    u = nu;
    if (b[o].cutoff < bucket_size) {
      int32_t no = next[o];
      next[o] = (int16_t)u;
      u = o;
      o = no;
    } else if (b[o].cutoff == bucket_size) {
      int32_t no = next[o];
      b[o].offset = 0;
      b[o].symbol = (int16_t)o;
      o = no;
    }
  }
  return u < 0;
}

// --------------------------------------------------------- clustered code

struct HybridConfig { int32_t split_exp, msb, lsb; };

// fully-tabulated rANS step: for each 12-bit state residue, the symbol,
// its frequency, and (alias offset + in-bucket position) pre-added — one
// 8-byte load replaces the alias-bucket branch + D[] chase per symbol
struct FlatEntry { uint16_t sym, dfreq, bias, pad; };

struct Cluster {
  HybridConfig cfg;
  PrefixTable prefix;             // if use_prefix
  std::vector<int16_t> D;         // if ANS
  std::vector<AliasBucket> alias;
  std::vector<FlatEntry> flat;    // 1<<12 entries, built from alias
};

struct CodeSpec {
  bool use_prefix = false, lz77 = false;
  int32_t min_symbol = 0x7fffffff, min_length = 0x7fffffff;
  HybridConfig lz_cfg{0, 0, 0};
  int32_t num_dist = 0, log_alpha = 0;
  std::vector<uint8_t> cluster_map;
  std::vector<Cluster> clusters;
  // per-context direct tables (one load to the decode data instead of the
  // cluster_map -> clusters[] -> vector-data pointer chase per symbol)
  std::vector<const FlatEntry*> ctx_flat;
  std::vector<const PrefixTable*> ctx_prefix;
  std::vector<HybridConfig> ctx_cfg;

  void build_ctx_tables() {
    ctx_flat.resize((size_t)num_dist);
    ctx_prefix.resize((size_t)num_dist);
    ctx_cfg.resize((size_t)num_dist);
    for (int32_t k = 0; k < num_dist; ++k) {
      const Cluster& cl = clusters[cluster_map[k]];
      ctx_flat[k] = cl.flat.empty() ? nullptr : cl.flat.data();
      ctx_prefix[k] = &cl.prefix;
      ctx_cfg[k] = cl.cfg;
    }
  }
};

struct CodeState {
  const CodeSpec* spec;
  uint32_t ans_state = 0;
  int32_t num_to_copy = 0, num_decoded = 0, copy_pos = 0;
  std::vector<int32_t> window;  // lazily sized 1<<20
  bool error = false;
};

static const uint8_t SPECIAL_DISTANCES[120] = {
  0x71,0x80,0x81,0x61,0x72,0x90,0x82,0x62,0x91,0x51,0x92,0x52,
  0x73,0xa0,0x83,0x63,0xa1,0x41,0x93,0x53,0xa2,0x42,0x74,0xb0,
  0x84,0x64,0xb1,0x31,0xa3,0x43,0x94,0x54,0xb2,0x32,0x75,0xa4,
  0x44,0xb3,0x33,0xc0,0x85,0x65,0xc1,0x21,0x95,0x55,0xc2,0x22,
  0xb4,0x34,0xa5,0x45,0xc3,0x23,0x76,0xd0,0x86,0x66,0xd1,0x11,
  0x96,0x56,0xd2,0x12,0xb5,0x35,0xc4,0x24,0xa6,0x46,0xd3,0x13,
  0x77,0xe0,0x87,0x67,0xc5,0x25,0xe1,0x01,0xb6,0x36,0xd4,0x14,
  0x97,0x57,0xe2,0x02,0xa7,0x47,0xe3,0x03,0xc6,0x26,0xd5,0x15,
  0xf0,0xb7,0x37,0xe4,0x04,0xf1,0xf2,0xd6,0x16,0xf3,0xc7,0x27,
  0xe5,0x05,0xf4,0xd7,0x17,0xe6,0x06,0xf5,0xe7,0x07,0xf6,0xf7,
};

static inline int32_t ans_code(Bits& br, CodeState& cs, const Cluster& cl) {
  uint32_t state = cs.ans_state;
  if (__builtin_expect(state == 0, 0)) {
    state = br.u(16);
    state |= (uint32_t)br.u(16) << 16;
  }
  const FlatEntry e = cl.flat[state & 0xfff];
  state = (uint32_t)e.dfreq * (state >> 12) + (uint32_t)e.bias;
  if (state < (1u << 16)) state = (state << 16) | br.u(16);
  cs.ans_state = state;
  return e.sym;
}

static inline int64_t hybrid_int(Bits& br, int32_t token, const HybridConfig& c);

// ---- fast path (no-LZ77 streams) -------------------------------------------
//
// Shared by code_one_nolz and the register-local HF / modular loops.  The
// renorm and hybrid-split branches stay branches: measured branchless
// (select-based) variants lost 5-15% on both low- and high-entropy streams
// — the predictor handles them well and the extra ALU work is pure cost.

static inline int32_t ans_symbol_fast(Bits& b, uint32_t& ans,
                                      const FlatEntry* flat) {
  uint32_t state = ans;
  if (__builtin_expect(state == 0, 0)) {
    state = b.u(16);
    state |= (uint32_t)b.u(16) << 16;
  }
  const FlatEntry e = flat[state & 0xfff];
  state = (uint32_t)e.dfreq * (state >> 12) + (uint32_t)e.bias;
  if (state < (1u << 16)) state = (state << 16) | b.u(16);
  ans = state;
  return e.sym;
}

static inline int32_t code_symbol_fast(Bits& b, uint32_t& ans,
                                       const CodeSpec& s, int32_t ctx,
                                       bool* err) {
  const int32_t token = s.use_prefix ? s.ctx_prefix[ctx]->decode(b)
                                     : ans_symbol_fast(b, ans, s.ctx_flat[ctx]);
  const int64_t value = hybrid_int(b, token, s.ctx_cfg[ctx]);
  if (__builtin_expect(value < 0, 0)) { *err = true; return 0; }
  return (int32_t)value;
}

static inline int32_t cluster_symbol(Bits& br, CodeState& cs, const Cluster& cl) {
  const CodeSpec& s = *cs.spec;
  return s.use_prefix ? cl.prefix.decode(br) : ans_code(br, cs, cl);
}

static inline int64_t hybrid_int(Bits& br, int32_t token, const HybridConfig& c) {
  int32_t split = 1 << c.split_exp;
  if (token < split) return token;
  int32_t bit = c.msb + c.lsb;
  // largest token whose decoded value stays below 2^30 (j40.h:2308); the
  // Python oracle raises "iovf" past this, so the native path must reject
  // identically (a looser guard would truncate to int32 downstream)
  if (token > split + (((int32_t)30 - c.split_exp) << bit) - 1) return -1;
  int32_t midbits = c.split_exp - bit + ((token - split) >> bit);
  int64_t mid = br.u(midbits);
  int32_t top = 1 << c.msb;
  int32_t lo = token & ((1 << c.lsb) - 1);
  int32_t hi = (token >> c.lsb) & (top - 1);
  return (((int64_t)(top | hi)) << (midbits + c.lsb)) | (mid << c.lsb) | lo;
}

// the central symbol decoder (j40.h:2804-2876)
static int32_t code_one(Bits& br, CodeState& cs, int32_t ctx, int32_t dist_mult) {
  const CodeSpec& s = *cs.spec;
  const int32_t MASK = 0xfffff;
  if (cs.num_to_copy > 0) {
    --cs.num_to_copy;
    int32_t v = cs.window[cs.copy_pos++ & MASK];
    cs.window[cs.num_decoded++ & MASK] = v;
    return v;
  }
  const Cluster& cl = s.clusters[s.cluster_map[ctx]];
  int32_t token = cluster_symbol(br, cs, cl);
  if (token >= s.min_symbol) {
    const Cluster& lz = s.clusters[s.cluster_map[s.num_dist - 1]];
    int64_t len64 = hybrid_int(br, token - s.min_symbol, s.lz_cfg);
    if (len64 < 0) { cs.error = true; return 0; }  // iovf parity (j40.h:2833)
    int32_t num_to_copy = (int32_t)len64 + s.min_length;
    token = cluster_symbol(br, cs, lz);
    int64_t dist64 = hybrid_int(br, token, lz.cfg);
    if (dist64 < 0) { cs.error = true; return 0; }
    int32_t distance = (int32_t)dist64;
    if (!dist_mult) ++distance;
    else if (distance >= 120) distance -= 119;
    else {
      int32_t special = SPECIAL_DISTANCES[distance];
      int32_t d = ((special >> 4) - 7) + dist_mult * (special & 7);
      distance = d < 1 ? 1 : d;
    }
    if (distance > cs.num_decoded) distance = cs.num_decoded;
    if (distance > (1 << 20)) distance = 1 << 20;
    cs.copy_pos = cs.num_decoded - distance;
    if (cs.window.empty()) cs.window.assign((size_t)1 << 20, 0);
    cs.num_to_copy = num_to_copy - 1;
    int32_t v = cs.window[cs.copy_pos++ & MASK];
    cs.window[cs.num_decoded++ & MASK] = v;
    return v;
  }
  int64_t value = hybrid_int(br, token, cl.cfg);
  if (value < 0) { cs.error = true; return 0; }
  if (s.lz77) {
    if (cs.window.empty()) cs.window.assign((size_t)1 << 20, 0);
    cs.window[cs.num_decoded++ & MASK] = (int32_t)value;
  }
  return (int32_t)value;
}

// specialization for streams with LZ77 off (min_symbol unreachable, no
// window bookkeeping) — the HF coefficient and simple-modular hot loops
static inline int32_t code_one_nolz(Bits& br, CodeState& cs, int32_t ctx) {
  bool err = false;
  int32_t v = code_symbol_fast(br, cs.ans_state, *cs.spec, ctx, &err);
  if (__builtin_expect(err, 0)) cs.error = true;
  return v;
}

// -------------------------------------------------- spec blob deserializer
//
// int32 layout (produced by j40_tpu/native/bindings.py serialize_spec):
// [0] use_prefix [1] lz77 [2] min_symbol [3] min_length
// [4..6] lz_cfg  [7] num_dist [8] num_clusters [9] log_alpha
// [10..10+num_dist) cluster_map
// per cluster: [3] cfg; if prefix: [1] alphabet_size, [alphabet] len|pat<<4
//              else: [1<<log_alpha] D
static bool parse_spec(const int32_t* blob, int64_t blob_len, CodeSpec* out) {
  int64_t i = 0;
  auto need = [&](int64_t n) { return i + n <= blob_len; };
  if (!need(10)) return false;
  out->use_prefix = blob[0] != 0;
  out->lz77 = blob[1] != 0;
  out->min_symbol = blob[2];
  out->min_length = blob[3];
  out->lz_cfg = HybridConfig{blob[4], blob[5], blob[6]};
  out->num_dist = blob[7];
  int32_t num_clusters = blob[8];
  out->log_alpha = blob[9];
  i = 10;
  if (!need(out->num_dist)) return false;
  out->cluster_map.resize((size_t)out->num_dist);
  for (int32_t k = 0; k < out->num_dist; ++k) out->cluster_map[k] = (uint8_t)blob[i++];
  out->clusters.resize((size_t)num_clusters);
  for (int32_t c = 0; c < num_clusters; ++c) {
    Cluster& cl = out->clusters[c];
    if (!need(3)) return false;
    cl.cfg = HybridConfig{blob[i], blob[i + 1], blob[i + 2]};
    i += 3;
    if (out->use_prefix) {
      if (!need(1)) return false;
      int32_t alpha = blob[i++];
      if (!need(alpha)) return false;
      if (alpha == 1) {
        cl.prefix.single_symbol = 0;
      } else if (!build_prefix(blob + i, alpha, &cl.prefix)) return false;
      i += alpha;
    } else {
      int32_t ts = 1 << out->log_alpha;
      if (!need(ts)) return false;
      cl.D.resize((size_t)ts);
      for (int32_t k = 0; k < ts; ++k) cl.D[k] = (int16_t)blob[i + k];
      i += ts;
      if (!build_alias(cl.D.data(), out->log_alpha, &cl.alias)) return false;
      // flatten the alias map over all 4096 state residues
      cl.flat.resize((size_t)1 << 12);
      const int32_t log_bucket = 12 - out->log_alpha;
      for (int32_t idx = 0; idx < (1 << 12); ++idx) {
        const int32_t bi = idx >> log_bucket;
        const int32_t pos = idx & ((1 << log_bucket) - 1);
        const AliasBucket& b = cl.alias[bi];
        const int32_t sym = pos < b.cutoff ? bi : b.symbol;
        const int32_t off = pos < b.cutoff ? 0 : b.offset;
        cl.flat[idx] = FlatEntry{(uint16_t)sym, (uint16_t)cl.D[sym],
                                 (uint16_t)(off + pos), 0};
      }
    }
  }
  out->build_ctx_tables();
  return true;
}

// ----------------------------------------------------- modular channel

// I = int32_t for 16-bit planes (the reference's wp32, j40.h:3938: error
// magnitudes for |pixel| <= 2^15 fit comfortably), int64_t for wide planes
template <typename I>
struct WpStateT {
  int32_t width;
  int32_t p1, p2, p3[5], w[4];
  int32_t rowmask = 1;    // error ring rows - 1 (pow2-1); wavefront uses 7
  std::vector<I> errors;  // width*(rowmask+1) rows of 5
  I pred[5];
  I trueerrw, trueerrn, trueerrnw, trueerrne;

  void init(int32_t wdt, const int32_t* params, int32_t rows = 2) {
    width = wdt;
    rowmask = rows - 1;
    p1 = params[0]; p2 = params[1];
    for (int i = 0; i < 5; ++i) p3[i] = params[2 + i];
    for (int i = 0; i < 4; ++i) w[i] = params[7 + i];
    errors.assign((size_t)wdt * rows * 5, 0);
    for (int i = 0; i < 5; ++i) pred[i] = 0;
    trueerrw = trueerrn = trueerrnw = trueerrne = 0;
  }
  inline I* row_err(int32_t y) {
    return errors.data() + (size_t)(y & rowmask) * width * 5;
  }
  inline const I* row_err_prev(int32_t y) const {
    // y == 0 indexes an untouched (all-zero) ring row; wp_before gates all
    // y-1 reads on y > 0 anyway
    return errors.data() + (size_t)((y - 1) & rowmask) * width * 5;
  }
};
using WpState = WpStateT<int64_t>;

static const int64_t DIV24[64] = {
  0x1000000,0x800000,0x555555,0x400000,0x333333,0x2aaaaa,0x249249,0x200000,
  0x1c71c7,0x199999,0x1745d1,0x155555,0x13b13b,0x124924,0x111111,0x100000,
  0xf0f0f,0xe38e3,0xd7943,0xccccc,0xc30c3,0xba2e8,0xb2164,0xaaaaa,
  0xa3d70,0x9d89d,0x97b42,0x92492,0x8d3dc,0x88888,0x84210,0x80000,
  0x7c1f0,0x78787,0x75075,0x71c71,0x6eb3e,0x6bca1,0x69069,0x66666,
  0x63e70,0x61861,0x5f417,0x5d174,0x5b05b,0x590b2,0x57262,0x55555,
  0x53978,0x51eb8,0x50505,0x4ec4e,0x4d487,0x4bda1,0x4a790,0x49249,
  0x47dc1,0x469ee,0x456c7,0x44444,0x4325c,0x42108,0x41041,0x40000,
};

static inline int32_t floor_lg64(uint64_t x) {
  return x ? 63 - __builtin_clzll(x) : -1;
}

template <typename I>
static void wp_before(WpStateT<I>& wp, int32_t x, int32_t y,
                      int64_t pw64, int64_t pn64, int64_t pnw64, int64_t pne64,
                      int64_t pnn64) {
  const I pw = (I)pw64, pn = (I)pn64, pnw = (I)pnw64, pne = (I)pne64,
          pnn = (I)pnn64;
  static const I ZERO[5] = {0, 0, 0, 0, 0};
  I* err = wp.row_err(y);
  const I* nerr = wp.row_err_prev(y);
  const I* errw = x > 0 ? err + (size_t)(x - 1) * 5 : ZERO;
  const I* errn = y > 0 ? nerr + (size_t)x * 5 : ZERO;
  const I* errnw = (x > 0 && y > 0) ? nerr + (size_t)(x - 1) * 5 : errn;
  const I* errne = (x + 1 < wp.width && y > 0) ? nerr + (size_t)(x + 1) * 5 : errn;
  const I* errww = x > 1 ? err + (size_t)(x - 2) * 5 : ZERO;
  const I* errw2 = x + 1 < wp.width ? ZERO : errw;

  wp.trueerrw = x > 0 ? err[(size_t)(x - 1) * 5 + 4] : 0;
  wp.trueerrn = y > 0 ? nerr[(size_t)x * 5 + 4] : 0;
  wp.trueerrnw = (x > 0 && y > 0) ? nerr[(size_t)(x - 1) * 5 + 4] : wp.trueerrn;
  wp.trueerrne = (x + 1 < wp.width && y > 0) ? nerr[(size_t)(x + 1) * 5 + 4] : wp.trueerrn;

  wp.pred[0] = (pw + pne - pn) * 8;
  wp.pred[1] = pn * 8 - (I)(((wp.trueerrw + wp.trueerrn + wp.trueerrne) * wp.p1) >> 5);
  wp.pred[2] = pw * 8 - (I)(((wp.trueerrw + wp.trueerrn + wp.trueerrnw) * wp.p2) >> 5);
  wp.pred[3] = pn * 8 - (I)((wp.trueerrnw * wp.p3[0] + wp.trueerrn * wp.p3[1] +
                             wp.trueerrne * wp.p3[2] + (pnn - pn) * 8 * wp.p3[3] +
                             (pnw - pw) * 8 * wp.p3[4]) >> 5);
  // accumulation widths mirror the reference's wp32/wp64 exactly (int2P_t
  // w/wsum/sum, uint2P_t floor_lg operands, j40.h:4021-4048): only the two
  // DIV24 products widen to 64-bit.  Wrapping adds go through the unsigned
  // twin so out-of-range streams wrap like the oracle instead of UB.
  using U = typename std::make_unsigned<I>::type;
  I w[4], wsum = 0, sum = 0;
  for (int i = 0; i < 4; ++i) {
    I errsum = (I)((U)errn[i] + (U)errw[i] + (U)errnw[i] + (U)errww[i] +
                   (U)errne[i] + (U)errw2[i]);
    int32_t shift = floor_lg64((uint64_t)((U)errsum + 1)) - 5;
    if (shift < 0) shift = 0;
    w[i] = (I)(4 + (((int64_t)wp.w[i] * DIV24[errsum >> shift]) >> shift));
  }
  int32_t logw =
      floor_lg64((uint64_t)(U)((U)w[0] + (U)w[1] + (U)w[2] + (U)w[3])) - 4;
  for (int i = 0; i < 4; ++i) {
    w[i] >>= logw;
    wsum = (I)((U)wsum + (U)w[i]);
    sum = (I)((U)sum + (U)((int64_t)wp.pred[i] * w[i]));
  }
  wp.pred[4] = (I)((((int64_t)sum + (wsum >> 1) - 1) * DIV24[wsum - 1]) >> 24);
  if (((wp.trueerrn ^ wp.trueerrw) | (wp.trueerrn ^ wp.trueerrnw)) <= 0) {
    I lo = pw < pn ? pw : pn; lo = lo < pne ? lo : pne; lo *= 8;
    I hi = pw > pn ? pw : pn; hi = hi > pne ? hi : pne; hi *= 8;
    if (wp.pred[4] < lo) wp.pred[4] = lo;
    if (wp.pred[4] > hi) wp.pred[4] = hi;
  }
}

template <typename I>
static void wp_after(WpStateT<I>& wp, int32_t x, int32_t y, int64_t val) {
  I* err = wp.row_err(y) + (size_t)x * 5;
  I v8 = (I)val * 8;
  for (int i = 0; i < 4; ++i) {
    I d = wp.pred[i] - v8;
    err[i] = ((d < 0 ? -d : d) + 3) >> 3;
  }
  err[4] = wp.pred[4] - v8;
}

static inline int64_t gradient64(int64_t w, int64_t n, int64_t nw) {
  int64_t lo = w < n ? w : n;
  int64_t hi = w > n ? w : n;
  int64_t g = w + n - nw;
  return g < lo ? lo : (g > hi ? hi : g);
}

static inline int64_t trunc_div2(int64_t v) { return v / 2; }  // C trunc

template <typename W>
static inline int64_t predict(int32_t p, const W* wp, int64_t w, int64_t n,
                              int64_t nw, int64_t ne, int64_t nn, int64_t nee,
                              int64_t ww) {
  switch (p) {
    case 0: return 0;
    case 1: return w;
    case 2: return n;
    case 3: return (w + n) / 2;
    case 4: { int64_t a = n - nw, b = w - nw; if (a < 0) a = -a; if (b < 0) b = -b;
              return a < b ? w : n; }
    case 5: return gradient64(w, n, nw);
    case 6: return wp ? ((wp->pred[4] + 3) >> 3) : 0;
    case 7: return ne;
    case 8: return nw;
    case 9: return ww;
    case 10: return (w + nw) / 2;
    case 11: return (n + nw) / 2;
    case 12: return (n + ne) / 2;
    case 13: return (6 * n - 2 * nn + 7 * w + ww + nee + 3 * ne + 8) / 16;
    default: return 0;
  }
}

// tree node: 8 ints [prop, value, left, right, ctx, predictor, offset, multiplier]
struct TreeNode {
  int32_t prop, value, left, right, ctx, predictor, offset, multiplier;
};

}  // namespace

// ------------------------------------------------------------------ C ABI

// persistent decode context for one entropy-coded stream
struct J40TStream {
  Bits bits;
  std::shared_ptr<const CodeSpec> spec_holder;
  CodeState state;
};

// parsed-spec cache: a frame's HfGlobal coefficient spec (with its flat
// rANS tables / prefix LUTs) is shared by EVERY pass-group section, so
// parsing + table building per section is pure rework (0.5-1 ms per
// section on wide-context specs).  Keyed by an FNV-1a hash of the blob
// with a full byte compare on hit; shared_ptr keeps evicted specs alive
// for streams still using them.
namespace speccache {
std::mutex mu;
struct Entry {
  std::vector<int32_t> blob;
  std::shared_ptr<const CodeSpec> spec;
};
std::unordered_map<uint64_t, Entry> map;

static uint64_t fnv1a(const int32_t* p, int64_t n) {
  uint64_t h = 1469598103934665603ull;
  const uint8_t* b = (const uint8_t*)p;
  for (int64_t i = 0; i < n * 4; ++i) h = (h ^ b[i]) * 1099511628211ull;
  return h;
}

static std::shared_ptr<const CodeSpec> get(const int32_t* blob, int64_t n) {
  const uint64_t h = fnv1a(blob, n);
  {
    std::lock_guard<std::mutex> lock(mu);
    auto it = map.find(h);
    if (it != map.end() && (int64_t)it->second.blob.size() == n &&
        memcmp(it->second.blob.data(), blob, (size_t)n * 4) == 0)
      return it->second.spec;
  }
  auto spec = std::make_shared<CodeSpec>();
  if (!parse_spec(blob, n, const_cast<CodeSpec*>(spec.get()))) return nullptr;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (map.size() > 512) map.clear();  // bound memory (fuzzers churn specs)
    Entry& e = map[h];
    e.blob.assign(blob, blob + n);
    e.spec = spec;
  }
  return spec;
}
}  // namespace speccache

J40T_API J40TStream* j40t_stream_new(const uint8_t* data, int64_t size,
                                     int64_t bitpos, const int32_t* spec_blob,
                                     int64_t blob_len) {
  J40TStream* s = new (std::nothrow) J40TStream();
  if (!s) return nullptr;
  s->bits.data = data;
  s->bits.size = size;
  s->bits.seek_bits(bitpos);
  s->spec_holder = speccache::get(spec_blob, blob_len);
  if (!s->spec_holder) { delete s; return nullptr; }
  s->state.spec = s->spec_holder.get();
  return s;
}

J40T_API void j40t_stream_free(J40TStream* s) { delete s; }

J40T_API int64_t j40t_stream_bitpos(const J40TStream* s) {
  return s->bits.bit_position();
}

J40T_API int32_t j40t_stream_error(const J40TStream* s) {
  return (s->bits.overrun || s->state.error) ? 1 : 0;
}

J40T_API uint32_t j40t_stream_ans_state(const J40TStream* s) {
  return s->state.ans_state;
}

// decode a run of symbols with explicit contexts (diagnostics / simple uses)
J40T_API void j40t_decode_symbols(J40TStream* s, const int32_t* ctxs, int64_t n,
                                  int32_t dist_mult, int32_t* out) {
  if (!s->state.spec->lz77) {
    Bits b = s->bits;
    CodeState cs = s->state;  // window empty when lz77 off; cheap copy
    for (int64_t i = 0; i < n; ++i) out[i] = code_one_nolz(b, cs, ctxs[i]);
    s->bits = b;
    s->state.ans_state = cs.ans_state;
    if (cs.error) s->state.error = true;
    return;
  }
  for (int64_t i = 0; i < n; ++i) out[i] = code_one(s->bits, s->state, ctxs[i], dist_mult);
}

// fast path: single-leaf tree with gradient (5) or zero (0) predictor,
// multiplier 1, offset 0, no LZ77 — the fjxl-style shape our encoder's
// default output takes.  Inlines the symbol decode (no LZ77/window/copy
// checks, cluster hoisted) and loads only the W/N/NW neighbors the gradient
// needs; ~2x over the generic loop.
template <int PRED>
static int32_t decode_channel_simple(Bits& br, CodeState& cs, const Cluster& cl,
                                     int32_t width, int32_t height,
                                     int32_t* out, int32_t stride,
                                     int64_t range_max) {
  const bool use_prefix = cs.spec->use_prefix;
  const FlatEntry* flat = cl.flat.empty() ? nullptr : cl.flat.data();
  // register-local bit reader + ANS state: the struct references would
  // otherwise round-trip through memory every symbol (aliasing with out)
  Bits b = br;
  uint32_t ans_state = cs.ans_state;
  auto restore = [&]() { br = b; cs.ans_state = ans_state; };
  auto decode_px = [&](int64_t pred, int32_t* dst) -> int32_t {
    int32_t token;
    if (use_prefix) {
      token = cl.prefix.decode(b);
    } else {
      uint32_t state = ans_state;
      if (__builtin_expect(state == 0, 0)) {
        state = b.u(16);
        state |= (uint32_t)b.u(16) << 16;
      }
      const FlatEntry e = flat[state & 0xfff];
      state = (uint32_t)e.dfreq * (state >> 12) + (uint32_t)e.bias;
      if (state < (1u << 16)) state = (state << 16) | b.u(16);
      ans_state = state;
      token = e.sym;
    }
    int64_t value = hybrid_int(b, token, cl.cfg);
    if (value < 0) { cs.error = true; return 3; }
    int64_t uv = (value & 1) ? -((value >> 1) + 1) : (value >> 1);
    int64_t val = uv + pred;
    if (val < -range_max - 1 || val > range_max) return 1;
    *dst = (int32_t)val;
    return 0;
  };
  for (int32_t y = 0; y < height; ++y) {
    int32_t* row = out + (size_t)y * stride;
    const int32_t* prow = row - stride;
    int32_t r;
    if (PRED == 0) {
      for (int32_t x = 0; x < width; ++x)
        if ((r = decode_px(0, row + x)) != 0) { restore(); return r; }
    } else if (y == 0) {
      // edge substitution collapses the gradient to W on the first row
      int64_t prev = 0;
      for (int32_t x = 0; x < width; ++x) {
        if ((r = decode_px(prev, row + x)) != 0) { restore(); return r; }
        prev = row[x];
      }
    } else {
      if ((r = decode_px(prow[0], row)) != 0) { restore(); return r; }
      for (int32_t x = 1; x < width; ++x) {
        int64_t w_ = row[x - 1], n_ = prow[x], nw = prow[x - 1];
        int64_t lo = w_ < n_ ? w_ : n_;
        int64_t hi = w_ < n_ ? n_ : w_;
        int64_t g = w_ + n_ - nw;
        if ((r = decode_px(g < lo ? lo : (g > hi ? hi : g), row + x)) != 0) {
          restore();
          return r;
        }
      }
    }
  }
  restore();
  return (br.overrun || cs.error) ? 3 : 0;
}

// generic modular channel loop, templated on the LZ77 flag so the no-LZ77
// case keeps the bit reader + ANS state register-local across all pixels
template <bool LZ, typename I>
static int32_t modular_generic(
    J40TStream* s, const TreeNode* nodes, bool single_leaf, bool use_wp,
    WpStateT<I>& wp, int32_t dist_mult, int32_t cidx, int64_t sidx,
    int32_t width, int32_t height,
    const int32_t* const* refs, int32_t nrefs,
    int32_t* out, int32_t out_stride, int32_t ref_stride, int64_t range_max) {
  const CodeSpec& spec = *s->state.spec;
  Bits b = s->bits;
  uint32_t ans = s->state.ans_state;
  bool err = false;
  auto code_fast = [&](int32_t ctx) -> int32_t {
    return code_symbol_fast(b, ans, spec, ctx, &err);
  };
  auto finish = [&](int32_t ret) -> int32_t {
    if (!LZ) {
      s->bits = b;
      s->state.ans_state = ans;
      if (err) s->state.error = true;
    }
    return ret;
  };

  for (int32_t y = 0; y < height; ++y) {
    int32_t* row = out + (size_t)y * out_stride;
    const int32_t* prow = y > 0 ? row - out_stride : nullptr;
    const int32_t* pprow = y > 1 ? row - 2 * (size_t)out_stride : nullptr;
    for (int32_t x = 0; x < width; ++x) {
      int64_t w_ = x > 0 ? row[x - 1] : (y > 0 ? prow[x] : 0);
      int64_t n_ = y > 0 ? prow[x] : w_;
      int64_t nw = (x > 0 && y > 0) ? prow[x - 1] : w_;
      int64_t ne = (x + 1 < width && y > 0) ? prow[x + 1] : n_;
      int64_t nn = y > 1 ? pprow[x] : n_;
      int64_t nee = (x + 2 < width && y > 0) ? prow[x + 2] : ne;
      int64_t ww = x > 1 ? row[x - 2] : w_;
      int64_t nww = (x > 1 && y > 0) ? prow[x - 2] : ww;

      if (use_wp) wp_before(wp, x, y, w_, n_, nw, ne, nn);

      const TreeNode* node = nodes;
      if (!single_leaf) {
        while (node->prop >= 0) {
          int64_t val;
          switch (node->prop) {
            case 0: val = cidx; break;
            case 1: val = sidx; break;
            case 2: val = y; break;
            case 3: val = x; break;
            case 4: val = n_ < 0 ? -n_ : n_; break;
            case 5: val = w_ < 0 ? -w_ : w_; break;
            case 6: val = n_; break;
            case 7: val = w_; break;
            case 8: val = x > 0 ? w_ - (ww + nw - nww) : w_; break;
            case 9: val = w_ + n_ - nw; break;
            case 10: val = w_ - nw; break;
            case 11: val = nw - n_; break;
            case 12: val = n_ - ne; break;
            case 13: val = n_ - nn; break;
            case 14: val = w_ - ww; break;
            case 15: {
              if (use_wp) {
                int64_t v = (int64_t)wp.trueerrw;
                auto absl = [](int64_t t) { return t < 0 ? -t : t; };
                if (absl(v) < absl((int64_t)wp.trueerrn)) v = wp.trueerrn;
                if (absl(v) < absl((int64_t)wp.trueerrnw)) v = wp.trueerrnw;
                if (absl(v) < absl((int64_t)wp.trueerrne)) v = wp.trueerrne;
                val = v;
              } else val = 0;
              break;
            }
            default: {
              int32_t refcidx = (node->prop - 16) / 4;
              if (refcidx >= nrefs) return finish(2);
              const int32_t* rc = refs[refcidx];
              int64_t v = rc[(size_t)y * ref_stride + x];
              if (node->prop & 2) {
                int64_t rw = x > 0 ? rc[(size_t)y * ref_stride + x - 1] : 0;
                int64_t rn = y > 0 ? rc[(size_t)(y - 1) * ref_stride + x] : rw;
                int64_t rnw = (x > 0 && y > 0) ? rc[(size_t)(y - 1) * ref_stride + x - 1] : rw;
                v -= gradient64(rw, rn, rnw);
              }
              if (node->prop & 1) v = v < 0 ? -v : v;
              val = v;
              break;
            }
          }
          node = nodes + (val > node->value ? node->left : node->right);
        }
      }

      int32_t token = LZ ? code_one(s->bits, s->state, node->ctx, dist_mult)
                         : code_fast(node->ctx);
      int64_t uv = (token & 1) ? -((int64_t)(token / 2) + 1) : token / 2;
      int64_t val = uv * node->multiplier + node->offset;
      val += predict(node->predictor, use_wp ? &wp : nullptr, w_, n_, nw, ne, nn,
                     nee, ww);
      if (val < -range_max - 1 || val > range_max) return finish(1);
      row[x] = (int32_t)val;
      if (use_wp) wp_after(wp, x, y, val);
    }
  }
  finish(0);
  if (s->bits.overrun || s->state.error) return 3;
  return 0;
}

// Weighted-predictor fast loop (no LZ77): the WP math dominates the
// MA-tree flagship shape (measured ~2/3 of modular_e3 decode time), and the
// generic per-pixel path pays edge branches, pointer selects, and
// through-struct state traffic on every pixel.  This variant runs the row
// interior (2 <= x < width-2, y >= 2) with unconditional loads and fully
// register-resident WP state; edge pixels fall back to the generic-step
// lambda.  Identical integer arithmetic to wp_before/wp_after — bit-exact
// by construction (reference hot loop: j40.h:4127-4240, wp32 j40.h:3938).
// context-free token prepass: when every leaf of a tree codes through the
// SAME cluster, symbol boundaries don't depend on contexts, so the whole
// channel's tokens can be ripped in one single-table loop before any
// prediction work (the per-pixel entropy<->WP dependency chain is what
// serializes the interleaved loop).  Returns zigzag-unpacked values; error
// behavior matches the interleaved path exactly (on iovf/overrun the old
// loop also kept decoding deterministic garbage).
static void token_prepass(Bits& b, uint32_t& ans, const CodeSpec& spec,
                          int32_t ctx, int64_t n, int32_t* J40T_RESTRICT uv,
                          bool* err) {
  const HybridConfig cfg = spec.ctx_cfg[ctx];
  if (spec.use_prefix) {
    const PrefixTable* pt = spec.ctx_prefix[ctx];
    for (int64_t i = 0; i < n; ++i) {
      int32_t token = pt->decode(b);
      int64_t value = hybrid_int(b, token, cfg);
      if (__builtin_expect(value < 0, 0)) { *err = true; value = 0; }
      uv[i] = (int32_t)((value >> 1) ^ -(value & 1));  // branchless zigzag
    }
  } else {
    const FlatEntry* flat = spec.ctx_flat[ctx];
    // Bulk loop: one refill check per symbol.  A symbol consumes at most
    // 16 renorm bits (32-bit rANS state renorms once per step) plus
    // <= 30 hybrid mid bits, so topping the accumulator to > 47 bits up
    // front makes every bit extract branch-free.  The tail (last 16 input
    // bytes) falls back to the checked path, which also preserves the
    // overrun flag semantics near EOF.
    uint32_t state = ans;
    if (state == 0 && n > 0) {  // lazy init, as ans_symbol_fast
      state = b.u(16);
      state |= (uint32_t)b.u(16) << 16;
    }
    int64_t i = 0;
    while (i < n && b.pos + 8 <= b.size) {
      if (b.nbits <= 47) {
        uint64_t chunk;
        memcpy(&chunk, b.data + b.pos, 8);
        b.bits |= chunk << b.nbits;
        int32_t take = (63 - b.nbits) >> 3;
        b.pos += take;
        b.nbits += take * 8;
        b.bits &= ~(uint64_t)0 >> (64 - b.nbits);
      }
      const FlatEntry e = flat[state & 0xfff];
      state = (uint32_t)e.dfreq * (state >> 12) + (uint32_t)e.bias;
      if (state < (1u << 16)) {
        state = (state << 16) | (uint32_t)(b.bits & 0xffff);
        b.bits >>= 16;
        b.nbits -= 16;
      }
      int32_t token = e.sym;
      int64_t value;
      if (token < (1 << cfg.split_exp)) {
        value = token;
      } else {
        const int32_t split = 1 << cfg.split_exp;
        const int32_t bit = cfg.msb + cfg.lsb;
        if (__builtin_expect(
                token > split + (((int32_t)30 - cfg.split_exp) << bit) - 1,
                0)) {
          *err = true;
          value = 0;
        } else {
          int32_t midbits = cfg.split_exp - bit + ((token - split) >> bit);
          int64_t mid = (int64_t)(b.bits & ((((uint64_t)1) << midbits) - 1));
          b.bits >>= midbits;
          b.nbits -= midbits;
          int32_t top = 1 << cfg.msb;
          int32_t lo = token & ((1 << cfg.lsb) - 1);
          int32_t hi = (token >> cfg.lsb) & (top - 1);
          value = (((int64_t)(top | hi)) << (midbits + cfg.lsb)) |
                  (mid << cfg.lsb) | lo;
        }
      }
      uv[i++] = (int32_t)((value >> 1) ^ -(value & 1));
    }
    ans = state;
    for (; i < n; ++i) {
      int32_t token = ans_symbol_fast(b, ans, flat);
      int64_t value = hybrid_int(b, token, cfg);
      if (__builtin_expect(value < 0, 0)) { *err = true; value = 0; }
      uv[i] = (int32_t)((value >> 1) ^ -(value & 1));
    }
  }
}

// do all leaves of the tree code through one cluster?  (then the token
// stream is context-free and the prepass applies)
static bool tree_single_cluster(const CodeSpec& spec, const TreeNode* nodes,
                                int32_t ntree) {
  int32_t cl = -1;
  for (int32_t i = 0; i < ntree; ++i) {
    if (nodes[i].prop >= 0) continue;
    int32_t ctx = nodes[i].ctx;
    if (ctx < 0 || ctx >= spec.num_dist) return false;
    int32_t c = spec.cluster_map[ctx];
    if (cl < 0) cl = c;
    else if (c != cl) return false;
  }
  return cl >= 0;
}

template <typename I, bool PRE>
static int32_t modular_wp_nolz(
    J40TStream* s, const TreeNode* nodes, WpStateT<I>& wp,
    int32_t cidx, int64_t sidx, int32_t width, int32_t height,
    const int32_t* const* refs, int32_t nrefs,
    int32_t* out, int32_t out_stride, int32_t ref_stride, int64_t range_max,
    int32_t* pre_uv, int32_t pre_ctx) {
  const CodeSpec& spec = *s->state.spec;
  Bits b = s->bits;
  uint32_t ans = s->state.ans_state;
  bool err = false;
  if (PRE) {
    // rip the whole channel's tokens first (context-free: one cluster),
    // then reconstruct below with the entropy reads already out of the
    // per-pixel dependency chain
    token_prepass(b, ans, spec, pre_ctx, (int64_t)width * height, pre_uv,
                  &err);
  }
  using U = typename std::make_unsigned<I>::type;
  const I p1 = (I)wp.p1, p2 = (I)wp.p2;
  I p3[5], wbase[4];
  for (int i = 0; i < 5; ++i) p3[i] = (I)wp.p3[i];
  for (int i = 0; i < 4; ++i) wbase[i] = (I)wp.w[i];

  // one generic pixel step (edge pixels; same body as modular_generic)
  auto slow_px = [&](int32_t x, int32_t y, int32_t* row, const int32_t* prow,
                     const int32_t* pprow) -> int32_t {
    int64_t w_ = x > 0 ? row[x - 1] : (y > 0 ? prow[x] : 0);
    int64_t n_ = y > 0 ? prow[x] : w_;
    int64_t nw = (x > 0 && y > 0) ? prow[x - 1] : w_;
    int64_t ne = (x + 1 < width && y > 0) ? prow[x + 1] : n_;
    int64_t nn = y > 1 ? pprow[x] : n_;
    int64_t nee = (x + 2 < width && y > 0) ? prow[x + 2] : ne;
    int64_t ww = x > 1 ? row[x - 2] : w_;
    int64_t nww = (x > 1 && y > 0) ? prow[x - 2] : ww;
    wp_before(wp, x, y, w_, n_, nw, ne, nn);
    const TreeNode* node = nodes;
    while (node->prop >= 0) {
      int64_t val;
      switch (node->prop) {
        case 0: val = cidx; break;
        case 1: val = sidx; break;
        case 2: val = y; break;
        case 3: val = x; break;
        case 4: val = n_ < 0 ? -n_ : n_; break;
        case 5: val = w_ < 0 ? -w_ : w_; break;
        case 6: val = n_; break;
        case 7: val = w_; break;
        case 8: val = x > 0 ? w_ - (ww + nw - nww) : w_; break;
        case 9: val = w_ + n_ - nw; break;
        case 10: val = w_ - nw; break;
        case 11: val = nw - n_; break;
        case 12: val = n_ - ne; break;
        case 13: val = n_ - nn; break;
        case 14: val = w_ - ww; break;
        case 15: {
          int64_t v = (int64_t)wp.trueerrw;
          auto absl = [](int64_t t) { return t < 0 ? -t : t; };
          if (absl(v) < absl((int64_t)wp.trueerrn)) v = wp.trueerrn;
          if (absl(v) < absl((int64_t)wp.trueerrnw)) v = wp.trueerrnw;
          if (absl(v) < absl((int64_t)wp.trueerrne)) v = wp.trueerrne;
          val = v;
          break;
        }
        default: {
          int32_t refcidx = (node->prop - 16) / 4;
          if (refcidx >= nrefs) return 2;
          const int32_t* rc = refs[refcidx];
          int64_t v = rc[(size_t)y * ref_stride + x];
          if (node->prop & 2) {
            int64_t rw = x > 0 ? rc[(size_t)y * ref_stride + x - 1] : 0;
            int64_t rn = y > 0 ? rc[(size_t)(y - 1) * ref_stride + x] : rw;
            int64_t rnw = (x > 0 && y > 0)
                              ? rc[(size_t)(y - 1) * ref_stride + x - 1] : rw;
            v -= gradient64(rw, rn, rnw);
          }
          if (node->prop & 1) v = v < 0 ? -v : v;
          val = v;
          break;
        }
      }
      node = nodes + (val > node->value ? node->left : node->right);
    }
    int64_t uv;
    if (PRE) {
      uv = pre_uv[(size_t)y * width + x];
    } else {
      int32_t token = code_symbol_fast(b, ans, spec, node->ctx, &err);
      uv = (token & 1) ? -((int64_t)(token / 2) + 1) : token / 2;
    }
    int64_t val = uv * node->multiplier + node->offset;
    val += predict(node->predictor, &wp, w_, n_, nw, ne, nn, nee, ww);
    if (val < -range_max - 1 || val > range_max) return 1;
    row[x] = (int32_t)val;
    wp_after(wp, x, y, val);
    return 0;
  };

  const int32_t xlo = 2, xhi = width - 2;  // interior: [xlo, xhi)

  // Per-row cursor for the interior loop (2 <= x < width-2, y >= 2): all
  // loads unconditional, and the loop-carried state (w/ww pixel values,
  // both error-lane vectors, true errors) lives in registers so the
  // ecur(x) -> errsum(x+1) dependency skips the store-to-load forward.
  // (Measured negatives on this host, do not redo blindly: a 128-bit AVX2
  // version of the 4-lane weight math was ~10% slower -- the gather and
  // GPR<->SIMD crossings lengthen the serial chain; a two-row wavefront
  // at a pixel lag was ~14% slower -- doubled live state spills.  The
  // loop is issue-bound, not chain-bound, at ~2 GHz shared cores.)
  struct Cursor {
    int32_t y;
    int32_t* row; const int32_t* prow; const int32_t* pprow;
    I* erow; const I* nrow;
    int64_t cw, cww, cnw, cn, cne;
    I ew0, ew1, ew2, ew3, eww0, eww1, eww2, eww3, ctew, ctenw;
  };
  auto make_cursor = [&](int32_t y, int32_t* row, const int32_t* prow,
                         const int32_t* pprow, I* erow,
                         const I* nrow) -> Cursor {
    // carried registers (xlo == 2, so the x-2 initial loads hit index 0)
    Cursor c;
    c.y = y; c.row = row; c.prow = prow; c.pprow = pprow;
    c.erow = erow; c.nrow = nrow;
    c.cw = row[xlo - 1]; c.cww = row[xlo - 2];
    c.cnw = prow[xlo - 1]; c.cn = prow[xlo]; c.cne = prow[xlo + 1];
    const I* ew = erow + (size_t)(xlo - 1) * 5;
    c.ew0 = ew[0]; c.ew1 = ew[1]; c.ew2 = ew[2]; c.ew3 = ew[3];
    c.eww0 = erow[0]; c.eww1 = erow[1]; c.eww2 = erow[2]; c.eww3 = erow[3];
    c.ctew = ew[4];
    c.ctenw = nrow[(size_t)(xlo - 1) * 5 + 4];
    return c;
  };
  auto fast_px = [&](Cursor& c, int32_t x)
      __attribute__((always_inline)) -> int32_t {
    const int64_t w_ = c.cw, n_ = c.cn, nw = c.cnw;
    const int64_t ne = c.cne, nn = c.pprow[x], nee = c.prow[x + 2];
    const int64_t ww = c.cww;
    // ---- wp_before, interior form (errw2 == ZERO since x+1 < width)
    const I* en = c.nrow + (size_t)x * 5;
    const I* ene = en + 5;
    const I tew = c.ctew, ten = en[4], tenw = c.ctenw, tene = ene[4];
    const I pw = (I)w_, pn = (I)n_, pnw = (I)nw, pne = (I)ne, pnn = (I)nn;
    I pred0 = (pw + pne - pn) * 8;
    I pred1 = pn * 8 - (I)(((tew + ten + tene) * p1) >> 5);
    I pred2 = pw * 8 - (I)(((tew + ten + tenw) * p2) >> 5);
    I pred3 = pn * 8 - (I)((tenw * p3[0] + ten * p3[1] + tene * p3[2] +
                            (pnn - pn) * 8 * p3[3] +
                            (pnw - pw) * 8 * p3[4]) >> 5);
    const I* enw = en - 5;
    auto lane = [](I enl, I ewl, I enwl, I ewwl, I enel, I wb)
        __attribute__((always_inline)) -> I {
      I errsum = (I)((U)enl + (U)ewl + (U)enwl + (U)ewwl + (U)enel);
      int32_t shift = floor_lg64((uint64_t)((U)errsum + 1)) - 5;
      if (shift < 0) shift = 0;
      return (I)(4 + (((int64_t)wb * DIV24[errsum >> shift]) >> shift));
    };
    I wv0 = lane(en[0], c.ew0, enw[0], c.eww0, ene[0], wbase[0]);
    I wv1 = lane(en[1], c.ew1, enw[1], c.eww1, ene[1], wbase[1]);
    I wv2 = lane(en[2], c.ew2, enw[2], c.eww2, ene[2], wbase[2]);
    I wv3 = lane(en[3], c.ew3, enw[3], c.eww3, ene[3], wbase[3]);
    int32_t logw = floor_lg64(
        (uint64_t)(U)((U)wv0 + (U)wv1 + (U)wv2 + (U)wv3)) - 4;
    wv0 >>= logw; wv1 >>= logw; wv2 >>= logw; wv3 >>= logw;
    const I wsum = (I)((U)wv0 + (U)wv1 + (U)wv2 + (U)wv3);
    const I sum = (I)((U)((int64_t)pred0 * wv0) + (U)((int64_t)pred1 * wv1) +
                      (U)((int64_t)pred2 * wv2) + (U)((int64_t)pred3 * wv3));
    I pred4 = (I)((((int64_t)sum + (wsum >> 1) - 1) * DIV24[wsum - 1]) >> 24);
    {
      // branchless clamp: the sign-agreement gate is data-dependent
      // (~coin-flip on natural content), so compute the clamped value
      // unconditionally and select
      I lo = pw < pn ? pw : pn; lo = lo < pne ? lo : pne; lo *= 8;
      I hi = pw > pn ? pw : pn; hi = hi > pne ? hi : pne; hi *= 8;
      I pc = pred4 < lo ? lo : pred4;
      pc = pc > hi ? hi : pc;
      pred4 = (((ten ^ tew) | (ten ^ tenw)) <= 0) ? pc : pred4;
    }
    // ---- tree walk (interior property forms, all loads unconditional)
    const TreeNode* node = nodes;
    while (node->prop >= 0) {
      int64_t val;
      switch (node->prop) {
        case 0: val = cidx; break;
        case 1: val = sidx; break;
        case 2: val = c.y; break;
        case 3: val = x; break;
        case 4: val = n_ < 0 ? -n_ : n_; break;
        case 5: val = w_ < 0 ? -w_ : w_; break;
        case 6: val = n_; break;
        case 7: val = w_; break;
        case 8: val = w_ - (ww + nw - (int64_t)c.prow[x - 2]); break;
        case 9: val = w_ + n_ - nw; break;
        case 10: val = w_ - nw; break;
        case 11: val = nw - n_; break;
        case 12: val = n_ - ne; break;
        case 13: val = n_ - nn; break;
        case 14: val = w_ - ww; break;
        case 15: {
          int64_t v = tew;
          auto absl = [](int64_t t) { return t < 0 ? -t : t; };
          if (absl(v) < absl((int64_t)ten)) v = ten;
          if (absl(v) < absl((int64_t)tenw)) v = tenw;
          if (absl(v) < absl((int64_t)tene)) v = tene;
          val = v;
          break;
        }
        default: {
          int32_t refcidx = (node->prop - 16) / 4;
          if (refcidx >= nrefs) return 2;
          const int32_t* rc = refs[refcidx];
          int64_t v = rc[(size_t)c.y * ref_stride + x];
          if (node->prop & 2) {
            int64_t rw = rc[(size_t)c.y * ref_stride + x - 1];
            int64_t rn = rc[(size_t)(c.y - 1) * ref_stride + x];
            int64_t rnw = rc[(size_t)(c.y - 1) * ref_stride + x - 1];
            v -= gradient64(rw, rn, rnw);
          }
          if (node->prop & 1) v = v < 0 ? -v : v;
          val = v;
          break;
        }
      }
      node = nodes + (val > node->value ? node->left : node->right);
    }
    // ---- decode + reconstruct
    int64_t uv;
    if (PRE) {
      uv = pre_uv[(size_t)c.y * width + x];
    } else {
      int32_t token = code_symbol_fast(b, ans, spec, node->ctx, &err);
      uv = (token & 1) ? -((int64_t)(token / 2) + 1) : token / 2;
    }
    int64_t val = uv * node->multiplier + node->offset;
    int64_t pd;
    const int32_t p = node->predictor;
    if (__builtin_expect(p == 5 || p == 6, 1)) {
      // predictors 5 (gradient) and 6 (WP) dominate real trees and the
      // leaf choice is data-dependent: compute both, select branchless
      int64_t g = gradient64(w_, n_, nw);
      pd = p == 6 ? (int64_t)((pred4 + 3) >> 3) : g;
    } else {
      pd = predict(p, (const WpStateT<I>*)nullptr, w_, n_,
                   nw, ne, nn, nee, ww);
    }
    val += pd;
    if (val < -range_max - 1 || val > range_max) return 1;
    c.row[x] = (int32_t)val;
    // ---- wp_after: update the carried registers, mirror to memory
    // (edge pixels and the next row read the ring through erow)
    {
      I* ecur = c.erow + (size_t)x * 5;
      const I v8 = (I)val * 8;
      I d0 = pred0 - v8, d1 = pred1 - v8, d2 = pred2 - v8, d3 = pred3 - v8;
      d0 = ((d0 < 0 ? -d0 : d0) + 3) >> 3;
      d1 = ((d1 < 0 ? -d1 : d1) + 3) >> 3;
      d2 = ((d2 < 0 ? -d2 : d2) + 3) >> 3;
      d3 = ((d3 < 0 ? -d3 : d3) + 3) >> 3;
      const I tec = pred4 - v8;
      ecur[0] = d0; ecur[1] = d1; ecur[2] = d2; ecur[3] = d3;
      ecur[4] = tec;
      c.eww0 = c.ew0; c.eww1 = c.ew1; c.eww2 = c.ew2; c.eww3 = c.ew3;
      c.ew0 = d0; c.ew1 = d1; c.ew2 = d2; c.ew3 = d3;
      c.ctew = tec; c.ctenw = ten;
      c.cww = c.cw; c.cw = val; c.cnw = c.cn; c.cn = c.cne; c.cne = nee;
    }
    return 0;
  };

  auto finish = [&](int32_t ret) -> int32_t {
    s->bits = b;
    s->state.ans_state = ans;
    if (err) s->state.error = true;
    if (ret == 0 && (s->bits.overrun || s->state.error)) return 3;
    return ret;
  };

  {
    for (int32_t y = 0; y < height; ++y) {
      int32_t* J40T_RESTRICT row = out + (size_t)y * out_stride;
      const int32_t* prow = y > 0 ? row - out_stride : nullptr;
      const int32_t* pprow = y > 1 ? row - 2 * (size_t)out_stride : nullptr;
      int32_t r;
      if (y < 2 || width < 8) {
        for (int32_t x = 0; x < width; ++x)
          if ((r = slow_px(x, y, row, prow, pprow)) != 0) return finish(r);
        continue;
      }
      for (int32_t x = 0; x < xlo; ++x)
        if ((r = slow_px(x, y, row, prow, pprow)) != 0) return finish(r);
      Cursor c = make_cursor(y, row, prow, pprow, wp.row_err(y),
                             wp.row_err_prev(y));
      for (int32_t x = xlo; x < xhi; ++x)
        if ((r = fast_px(c, x)) != 0) return finish(r);
      for (int32_t x = xhi; x < width; ++x)
        if ((r = slow_px(x, y, row, prow, pprow)) != 0) return finish(r);
    }
    return finish(0);
  }

}

// LZ77 single-leaf predictor-0 fast path: copy runs bulk through the
// window ring without re-entering the per-symbol decoder (screen-content
// style streams are mostly copies; the generic loop costs ~6x more per
// copied pixel).  Values in the window are raw tokens; pixels are their
// zigzag unpack (predictor 0, multiplier 1, offset 0).
static int32_t decode_channel_simple_lz0(
    Bits& br, CodeState& cs, int32_t leaf_ctx, int32_t dist_mult,
    int32_t width, int32_t height, int32_t* out, int32_t stride,
    int64_t range_max) {
  const int32_t MASK = 0xfffff;
  for (int32_t y = 0; y < height; ++y) {
    int32_t* row = out + (size_t)y * stride;
    for (int32_t x = 0; x < width;) {
      if (cs.num_to_copy > 0) {
        int32_t n = cs.num_to_copy < width - x ? cs.num_to_copy : width - x;
        for (int32_t k = 0; k < n; ++k) {
          int32_t v = cs.window[cs.copy_pos++ & MASK];
          cs.window[cs.num_decoded++ & MASK] = v;
          int64_t val = (v & 1) ? -((int64_t)(v >> 1) + 1) : (v >> 1);
          if (val < -range_max - 1 || val > range_max) return 1;
          row[x + k] = (int32_t)val;
        }
        cs.num_to_copy -= n;
        x += n;
      } else {
        int32_t v = code_one(br, cs, leaf_ctx, dist_mult);
        int64_t val = (v & 1) ? -((int64_t)(v >> 1) + 1) : (v >> 1);
        if (val < -range_max - 1 || val > range_max) return 1;
        row[x++] = (int32_t)val;
      }
    }
  }
  return (br.overrun || cs.error) ? 3 : 0;
}

// decode one modular channel; returns 0 on success, 1 on range error ("povf"),
// 2 on tree/ref error, 3 on bitstream overrun
J40T_API int32_t j40t_decode_modular_channel(
    J40TStream* s,
    const int32_t* tree, int32_t ntree,
    const int32_t* wp_params,       // p1,p2,p3[5],w[4] (11 ints)
    int32_t dist_mult,
    int32_t cidx, int64_t sidx,
    int32_t width, int32_t height,
    const int32_t* const* refs, int32_t nrefs,  // previous same-shape channels
    int32_t* out,
    int32_t out_stride,     // row stride in elements (== width if contiguous)
    int32_t ref_stride,
    int64_t range_max) {    // 32767 for 16-bit buffers, INT32_MAX for wide
  const TreeNode* nodes = (const TreeNode*)tree;

  // does the tree need the weighted predictor?
  bool use_wp = false;
  for (int32_t i = 0; i < ntree; ++i) {
    if (nodes[i].prop == 15 || (nodes[i].prop < 0 && nodes[i].predictor == 6)) {
      use_wp = true;
      break;
    }
  }
  const bool single_leaf = ntree == 1 && nodes[0].prop < 0;

  if (single_leaf && s->state.spec->lz77 && nodes[0].multiplier == 1 &&
      nodes[0].offset == 0 && nodes[0].predictor == 0) {
    return decode_channel_simple_lz0(s->bits, s->state, nodes[0].ctx,
                                     dist_mult, width, height, out,
                                     out_stride, range_max);
  }
  if (single_leaf && !s->state.spec->lz77 && nodes[0].multiplier == 1 &&
      nodes[0].offset == 0 &&
      (nodes[0].predictor == 5 || nodes[0].predictor == 0)) {
    const Cluster& cl = s->state.spec->clusters[s->state.spec->cluster_map[nodes[0].ctx]];
    return nodes[0].predictor == 5
               ? decode_channel_simple<5>(s->bits, s->state, cl, width, height,
                                          out, out_stride, range_max)
               : decode_channel_simple<0>(s->bits, s->state, cl, width, height,
                                          out, out_stride, range_max);
  }

  // 16-bit planes run the int32 WP instantiation (the reference's wp32,
  // j40.h:3938); wide planes keep 64-bit error state (wp64)
  // single-cluster trees rip all tokens context-free before reconstruction
  int32_t* pre_uv = nullptr;
  int32_t pre_ctx = 0;
  static thread_local std::vector<int32_t> pre_buf;
  if (use_wp && !s->state.spec->lz77 &&
      tree_single_cluster(*s->state.spec, nodes, ntree)) {
    for (int32_t i = 0; i < ntree; ++i)
      if (nodes[i].prop < 0) { pre_ctx = nodes[i].ctx; break; }
    pre_buf.resize((size_t)width * height);
    pre_uv = pre_buf.data();
  }

  if (range_max <= 32767) {
    WpStateT<int32_t> wp;
    if (use_wp) wp.init(width, wp_params, pre_uv ? 8 : 2);
    if (use_wp && !s->state.spec->lz77)
      return pre_uv
          ? modular_wp_nolz<int32_t, true>(
                s, nodes, wp, cidx, sidx, width, height, refs, nrefs, out,
                out_stride, ref_stride, range_max, pre_uv, pre_ctx)
          : modular_wp_nolz<int32_t, false>(
                s, nodes, wp, cidx, sidx, width, height, refs, nrefs, out,
                out_stride, ref_stride, range_max, nullptr, 0);
    auto fn = s->state.spec->lz77 ? modular_generic<true, int32_t>
                           : modular_generic<false, int32_t>;
    return fn(s, nodes, single_leaf, use_wp, wp, dist_mult, cidx, sidx, width,
              height, refs, nrefs, out, out_stride, ref_stride, range_max);
  }
  WpState wp;
  if (use_wp) wp.init(width, wp_params, pre_uv ? 8 : 2);
  if (use_wp && !s->state.spec->lz77)
    return pre_uv
        ? modular_wp_nolz<int64_t, true>(
              s, nodes, wp, cidx, sidx, width, height, refs, nrefs, out,
              out_stride, ref_stride, range_max, pre_uv, pre_ctx)
        : modular_wp_nolz<int64_t, false>(
              s, nodes, wp, cidx, sidx, width, height, refs, nrefs, out,
              out_stride, ref_stride, range_max, nullptr, 0);
  auto fn = s->state.spec->lz77 ? modular_generic<true, int64_t>
                         : modular_generic<false, int64_t>;
  return fn(s, nodes, single_leaf, use_wp, wp, dist_mult, cidx, sidx, width,
            height, refs, nrefs, out, out_stride, ref_stride, range_max);
}

// VarDCT HF coefficient decode for one (pass, group) (j40.h:6888-7005).
// blocks: (gh8p, gw8p) slice of the LF group block map starting at the group's
// top-left 8x8 position; arrays indexed per varblock by voff.
template <bool LZ>
static int32_t decode_hf_group_impl(
    J40TStream* s,
    int32_t ctxoff,
    const int32_t* blocks, int32_t blocks_stride,  // full LF-group width8
    int32_t gw8, int32_t gh8,
    const int64_t* vb_coeffoff,
    const int32_t* vb_qfidx,
    const uint8_t* lfindices, int32_t lf_stride,
    int32_t gx8_in_gg, int32_t gy8_in_gg,
    const uint8_t* block_ctx_map,
    int32_t nb_block_ctx, int32_t nb_qf_thr, int32_t lfidx_size,
    const int32_t* dct_select,       // 27*4: log_rows, log_cols, param, order
    const int32_t* const* orders,    // [13*3] per-(order_idx, channel) tables
    float* const* coeffs)            // [3] coefficient planes
{
  static const int8_t TWICE_FREQ[64] = {
    -1, 0, 2, 4, 6, 8,10,12,14,16,18,20,22,24,26,28,
    30,30,32,32,34,34,36,36,38,38,40,40,42,42,44,44,
    46,46,46,46,48,48,48,48,50,50,50,50,52,52,52,52,
    54,54,54,54,56,56,56,56,58,58,58,58,60,60,60,60,
  };
  static const int16_t TWICE_NNZ[64] = {
      0,  0, 62,124,124,186,186,186,186,246,246,246,246,304,304,304,
    304,304,304,304,304,360,360,360,360,360,360,360,360,360,360,360,
    360,412,412,412,412,412,412,412,412,412,412,412,412,412,412,412,
    412,412,412,412,412,412,412,412,412,412,412,412,412,412,412,412,
  };
  static const int32_t YXB2XYB[3] = {1, 0, 2};

  std::vector<int8_t> nonzeros((size_t)gw8 * gh8 * 3, 0);

  // register-local bit reader + ANS state for the no-LZ77 fast path: the
  // J40TStream fields would otherwise round-trip through memory per symbol
  const CodeSpec& spec = *s->state.spec;
  Bits b = s->bits;
  uint32_t ans = s->state.ans_state;
  bool err = false;
  auto code_fast = [&](int32_t ctx) -> int32_t {
    return code_symbol_fast(b, ans, spec, ctx, &err);
  };
  auto finish = [&](int32_t ret) -> int32_t {
    if (!LZ) {
      s->bits = b;
      s->state.ans_state = ans;
      if (err) s->state.error = true;
    }
    return ret;
  };

  for (int32_t y8 = 0; y8 < gh8; ++y8) {
    for (int32_t x8 = 0; x8 < gw8; ++x8) {
      int32_t ggx8 = x8 + gx8_in_gg, ggy8 = y8 + gy8_in_gg;
      int32_t nzpos = y8 * gw8 + x8;
      int32_t voff = blocks[(size_t)ggy8 * blocks_stride + ggx8];
      int32_t dctsel = voff >> 20;
      if (dctsel < 2) continue;
      dctsel -= 2;
      voff &= 0xfffff;
      int32_t log_rows = dct_select[dctsel * 4];
      int32_t log_columns = dct_select[dctsel * 4 + 1];
      int32_t order_idx = dct_select[dctsel * 4 + 3];
      int32_t log_size = log_rows + log_columns;
      int64_t coeffoff = vb_coeffoff[voff];
      int32_t qfidx = vb_qfidx[voff];
      int32_t lfidx = lfindices[(size_t)ggy8 * lf_stride + ggx8];
      int32_t bctx0 = (order_idx * (nb_qf_thr + 1) + qfidx) * lfidx_size + lfidx;
      int32_t bctxc = 13 * (nb_qf_thr + 1) * lfidx_size;

      for (int32_t c_yxb = 0; c_yxb < 3; ++c_yxb) {
        int32_t c = YXB2XYB[c_yxb];
        float* cf = coeffs[c] + coeffoff;
        const int32_t* order = orders[order_idx * 3 + c];
        int32_t bctx = block_ctx_map[bctx0 + bctxc * c_yxb];
        int32_t nz;
        if (x8 > 0) {
          nz = y8 > 0 ? (nonzeros[(size_t)(nzpos - 1) * 3 + c] +
                         nonzeros[(size_t)(nzpos - gw8) * 3 + c] + 1) >> 1
                      : nonzeros[(size_t)(nzpos - 1) * 3 + c];
        } else {
          nz = y8 > 0 ? nonzeros[(size_t)(nzpos - gw8) * 3 + c] : 32;
        }
        int32_t nzctx = ctxoff + bctx + (nz < 8 ? nz : 4 + nz / 2) * nb_block_ctx;
        nz = LZ ? code_one(s->bits, s->state, nzctx, 0) : code_fast(nzctx);
        if (nz > (63 << (log_size - 6))) return finish(1);
        int32_t llf = 1 << (log_size - 6);
        int32_t qnz = (nz + llf - 1) >> (log_size - 6);
        for (int32_t i = 0; i < (1 << (log_rows - 3)); ++i)
          for (int32_t j = 0; j < (1 << (log_columns - 3)); ++j)
            nonzeros[(size_t)(nzpos + i * gw8 + j) * 3 + c] = (int8_t)qnz;
        int32_t cctx = ctxoff + 458 * bctx + 37 * nb_block_ctx;
        int32_t prev = nz <= (1 << (log_size - 4)) ? 1 : 0;
        if (!LZ && log_size == 6) {
          // 8x8 specialization (the dominant class): llf = 1 and both
          // table shifts are no-ops; the nnz bucket only moves when a
          // nonzero lands
          int32_t nnz_tab = TWICE_NNZ[nz];
          for (int32_t i = 1; nz > 0 && i < 64; ++i) {
            int32_t ucoeff = code_fast(cctx + nnz_tab + TWICE_FREQ[i] + prev);
            int32_t sv = (ucoeff & 1) ? -((ucoeff >> 1) + 1) : (ucoeff >> 1);
            cf[order[i]] += (float)sv;
            if (ucoeff != 0) {
              prev = 1;
              nnz_tab = TWICE_NNZ[--nz];
            } else {
              prev = 0;
            }
          }
        } else {
          for (int32_t i = llf; nz > 0 && i < (1 << log_size); ++i) {
            int32_t ctx = cctx + TWICE_NNZ[(nz + llf - 1) >> (log_size - 6)] +
                          TWICE_FREQ[i >> (log_size - 6)] + prev;
            int32_t ucoeff = LZ ? code_one(s->bits, s->state, ctx, 0)
                                : code_fast(ctx);
            int32_t sv = (ucoeff & 1) ? -((ucoeff >> 1) + 1) : (ucoeff >> 1);
            cf[order[i]] += (float)sv;
            prev = ucoeff != 0 ? 1 : 0;
            nz -= prev;
          }
        }
        if (nz != 0) return finish(1);
      }
    }
  }
  finish(0);
  return (s->bits.overrun || s->state.error) ? 3 : 0;
}

J40T_API int32_t j40t_decode_hf_group(
    J40TStream* s,
    int32_t ctxoff,
    const int32_t* blocks, int32_t blocks_stride,
    int32_t gw8, int32_t gh8,
    const int64_t* vb_coeffoff,
    const int32_t* vb_qfidx,
    const uint8_t* lfindices, int32_t lf_stride,
    int32_t gx8_in_gg, int32_t gy8_in_gg,
    const uint8_t* block_ctx_map,
    int32_t nb_block_ctx, int32_t nb_qf_thr, int32_t lfidx_size,
    const int32_t* dct_select,
    const int32_t* const* orders,
    float* const* coeffs)
{
  const bool lz = s->state.spec->lz77;
  auto fn = lz ? decode_hf_group_impl<true> : decode_hf_group_impl<false>;
  return fn(s, ctxoff, blocks, blocks_stride, gw8, gh8, vb_coeffoff,
            vb_qfidx, lfindices, lf_stride, gx8_in_gg, gy8_in_gg,
            block_ctx_map, nb_block_ctx, nb_qf_thr, lfidx_size, dct_select,
            orders, coeffs);
}

// greedy raster-scan varblock placement (j40.h:6636-6687): assigns each
// decoded BlockInfo entry its top-left 8px cell, validates that DctSelect-
// sized rects stay inside the LF group and never cross a 256px group
// boundary, and fills the `blocks` map consumed by the HF coefficient loop.
// Pure integer bookkeeping, but it runs once per 8px cell of the frame —
// a GIL-bound Python loop here serializes the whole thread pool at 12MP+.
//
// dct_select: 27*4 ints [log_rows, log_cols, param_idx, order_idx] (the
// same blob j40t_decode_hf_group takes).  Outputs: blocks (zeroed by the
// caller), coeffoff_arr / vb_x8 / vb_y8 per varblock, and used[2] =
// {dct_select_used bitset, order_used bitset}.
// Returns 0 ok, 1 "vblk" placement error, 2 "dct?" bad DctSelect.
J40T_API int32_t j40t_place_varblocks(
    const int32_t* dctsel_arr, int32_t nb_varblocks,
    int32_t ggw8, int32_t ggh8, int32_t log_gsize8,
    const int32_t* dct_select,
    int32_t* blocks,
    int64_t* coeffoff_arr, int32_t* vb_x8, int32_t* vb_y8,
    uint32_t* used)
{
  int32_t voff = 0;
  int64_t coeffoff = 0;
  uint32_t used_dct = 0, used_order = 0;
  for (int32_t y0 = 0; y0 < ggh8; ++y0) {
    int32_t* brow = blocks + (size_t)y0 * ggw8;
    for (int32_t x0 = 0; x0 < ggw8; ++x0) {
      if (brow[x0]) continue;
      if (voff >= nb_varblocks) return 1;
      int32_t dctsel = dctsel_arr[voff];
      if (dctsel < 0 || dctsel >= 27) return 2;
      int32_t log_vh = dct_select[dctsel * 4];
      int32_t log_vw = dct_select[dctsel * 4 + 1];
      int32_t order_idx = dct_select[dctsel * 4 + 3];
      used_dct |= 1u << dctsel;
      used_order |= 1u << order_idx;
      coeffoff_arr[voff] = coeffoff;
      vb_x8[voff] = x0;
      vb_y8[voff] = y0;
      int32_t vw8 = 1 << (log_vw - 3), vh8 = 1 << (log_vh - 3);
      int32_t x1 = x0 + vw8 - 1, y1 = y0 + vh8 - 1;
      if (x1 >= ggw8 || (x0 >> log_gsize8) != (x1 >> log_gsize8)) return 1;
      if (y1 >= ggh8 || (y0 >> log_gsize8) != (y1 >> log_gsize8)) return 1;
      int32_t cover = (1 << 20) | voff;
      for (int32_t dy = 0; dy < vh8; ++dy) {
        int32_t* row = blocks + (size_t)(y0 + dy) * ggw8 + x0;
        for (int32_t dx = 0; dx < vw8; ++dx) row[dx] = cover;
      }
      brow[x0] = ((dctsel + 2) << 20) | voff;
      coeffoff += (int64_t)1 << (log_vw + log_vh);
      ++voff;
    }
  }
  if (voff != nb_varblocks) return 1;
  used[0] = used_dct;
  used[1] = used_order;
  return 0;
}

// Single-pass coefficient pack for the batched device serving path
// (parallel/batch.py): integral-f32 coefficients -> clamped int8 plus an
// exception list of the values outside [-lim, lim], indices emitted with a
// caller-supplied flat base offset.  Also counts |v| > 7 so the caller can
// choose the 4-bit nibble upload form from an exact census.  Runs inside
// the entropy worker threads (ctypes releases the GIL), replacing the
// serial numpy multi-pass pack that dominated the serving pipeline.
// Returns the exception count, or -1 when it would exceed exc_cap.
J40T_API int64_t j40t_pack_i8(
    const float* J40T_RESTRICT src, int64_t count, int8_t* J40T_RESTRICT dst,
    int32_t lim, int64_t exc_base, int32_t* J40T_RESTRICT exc_idx,
    int32_t* J40T_RESTRICT exc_val, int64_t exc_cap,
    int64_t* J40T_RESTRICT n_gt7)
{
  int64_t nexc = 0, gt7 = 0;
  for (int64_t i = 0; i < count; ++i) {
    int32_t iv = (int32_t)src[i];  // decoded coefficients are integral f32
    int32_t a = iv < 0 ? -iv : iv;
    gt7 += a > 7;
    int32_t c = iv < -lim ? -lim : (iv > lim ? lim : iv);
    dst[i] = (int8_t)c;
    if (__builtin_expect(a > lim, 0)) {
      if (nexc >= exc_cap) return -1;
      exc_idx[nexc] = (int32_t)(exc_base + i);
      exc_val[nexc] = iv;
      ++nexc;
    }
  }
  *n_gt7 = gt7;
  return nexc;
}

// Fused gather+pack for the all-DCT8x8 serving path: reads each raster
// block's 64 coefficients through the varblock offset table and emits the
// clamped-int8 upload form directly (j40t_pack_i8 semantics), skipping the
// intermediate dense f32 gather entirely.  blocks is the (h8, w8) raster
// placement map ((dctsel+2)<<20 | voff entries); coeffoff maps voff ->
// flat coefficient offset.  Exception indices are image-flat over the
// (3, nblk, 64) destination.  Returns exception count or -1 on overflow.
J40T_API int64_t j40t_gather_pack_dct8(
    const float* const* coeffs3, const int32_t* J40T_RESTRICT blocks,
    int64_t nblk, const int64_t* J40T_RESTRICT coeffoff,
    int8_t* J40T_RESTRICT dst, int32_t lim,
    int32_t* J40T_RESTRICT exc_idx, int32_t* J40T_RESTRICT exc_val,
    int64_t exc_cap, int64_t* J40T_RESTRICT n_gt7)
{
  int64_t nexc = 0, gt7 = 0;
  for (int32_t c = 0; c < 3; ++c) {
    const float* J40T_RESTRICT src = coeffs3[c];
    int8_t* J40T_RESTRICT d = dst + (size_t)c * nblk * 64;
    const int64_t base = (int64_t)c * nblk * 64;
    for (int64_t i = 0; i < nblk; ++i) {
      const float* J40T_RESTRICT s = src + coeffoff[blocks[i] & 0xFFFFF];
      int8_t* J40T_RESTRICT dd = d + i * 64;
      for (int k = 0; k < 64; ++k) {
        int32_t iv = (int32_t)s[k];
        int32_t a = iv < 0 ? -iv : iv;
        gt7 += a > 7;
        int32_t cl = iv < -lim ? -lim : (iv > lim ? lim : iv);
        dd[k] = (int8_t)cl;
        if (__builtin_expect(a > lim, 0)) {
          if (nexc >= exc_cap) return -1;
          exc_idx[nexc] = (int32_t)(base + i * 64 + k);
          exc_val[nexc] = iv;
          ++nexc;
        }
      }
    }
  }
  *n_gt7 = gt7;
  return nexc;
}

// Chunk-level int8 -> packed-int4 conversion for the device serving path:
// one pass over the assembled int8 slab emitting nibble pairs
// ((v+8) | (v2+8)<<4, values clamped to [-8, 7]) plus the |v| > 7
// exception list (indices into the i8 slab; values are the *slab* values —
// entries beyond the i8 clamp get patched from the workers' exact lists by
// the caller).  Replaces the numpy clip/view/pair/flatnonzero chain that
// dominated the main-thread chunk assembly (pack_s).  `count` must be
// even.  Returns the exception count or -1 when it exceeds exc_cap.
J40T_API int64_t j40t_pack_i4_chunk(
    const int8_t* J40T_RESTRICT src, int64_t count,
    uint8_t* J40T_RESTRICT dst,
    int32_t* J40T_RESTRICT exc_idx, int32_t* J40T_RESTRICT exc_val,
    int64_t exc_cap)
{
  int64_t nexc = 0;
  for (int64_t i = 0; i < count; i += 2) {
    int32_t a = src[i], b = src[i + 1];
    int32_t ca = a < -8 ? -8 : (a > 7 ? 7 : a);
    int32_t cb = b < -8 ? -8 : (b > 7 ? 7 : b);
    dst[i >> 1] = (uint8_t)((ca + 8) | ((cb + 8) << 4));
    if (__builtin_expect(a < -7 || a > 7, 0)) {
      if (nexc >= exc_cap) return -1;
      exc_idx[nexc] = (int32_t)i;
      exc_val[nexc] = a;
      ++nexc;
    }
    if (__builtin_expect(b < -7 || b > 7, 0)) {
      if (nexc >= exc_cap) return -1;
      exc_idx[nexc] = (int32_t)(i + 1);
      exc_val[nexc] = b;
      ++nexc;
    }
  }
  return nexc;
}
