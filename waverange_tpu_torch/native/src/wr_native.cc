// wr_native.cc — host-side native core of waverange_tpu.
//
// A from-scratch C++17 implementation of the WaveRange codec's host
// components, designed for the TPU-hybrid pipeline:
//
//   * a carry-counting byte range coder (Schindler rngcod13 bitstream
//     semantics; see the reference's src/rangecod/rangecod.c:170-373 for the
//     behavior contract this reproduces — implementation is original),
//   * per-layer block framing (60000-symbol blocks, raw 16-bit histogram
//     models, block marker bits; contract: reference wrappers.cpp:68-224),
//   * the f64 CDF 9/7 separable 3-D lifting wavelet (contract:
//     reference waveletcdf97_3d.c:38-468) used for the bit-exact CPU path
//     (TPUs execute the JAX/Pallas version; this one is the oracle-parity
//     reference and the f64 fast path on hosts),
//   * full field encode/decode pipelines (contract: wrappers.cpp:228-541),
//   * thread-parallel batch entry points: independent layers/fields/blocks
//     are encoded/decoded concurrently (the bitstream is sequential only
//     *within* one layer stream).
//
// Exported C ABI at the bottom; loaded from Python via ctypes.

#include <algorithm>
#include <atomic>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <mutex>
#include <condition_variable>
#if defined(__x86_64__)
#include <immintrin.h>
#endif
#include <chrono>
#include <cstdlib>
#include <cassert>
#include <cstdio>
#include <memory>
#include <stdexcept>

namespace wr {

using u8 = uint8_t;
using u16 = uint16_t;
using u32 = uint32_t;
using u64 = uint64_t;
using i64 = int64_t;

// ----------------------------------------------------------------------------
// Range coder constants (32-bit code value, byte-wise renormalization).
// ----------------------------------------------------------------------------
constexpr u32 kTopValue = 1u << 31;     // 2^31
constexpr u32 kBottomValue = kTopValue >> 8;  // 2^23
constexpr int kShiftBits = 23;          // bits dropped when emitting a byte
constexpr int kExtraBits = 7;           // (32-2) % 8 + 1

constexpr u64 kBlockSymbols = 60000;    // symbols per framed block

// Exact unsigned division by a runtime-constant divisor via multiply-high
// (ceil-magic variant). The per-symbol hot loops divide by the block's
// total frequency, constant across a 60000-symbol block — precomputing
// the magic replaces a 20+-cycle udiv with a mulhi+shift.
// Exactness for all n < 2^32, 1 <= d < 2^31 is covered by
// wrn_selftest_magicdiv (exhaustive in d over the coder's domain).
struct MagicDiv {
  u64 m;
  u32 sh;
  static MagicDiv make(u32 d) {
    u32 l = 32 - __builtin_clz(d);  // floor(log2(d)) + 1
    unsigned __int128 one = 1;
    u64 mm = (u64)(((one << (32 + l)) + d - 1) / d);
    return {mm, 32 + l};
  }
  inline u32 div(u32 n) const {
    return (u32)(((unsigned __int128)n * m) >> sh);
  }
};
constexpr int kLayersMax = 8;           // max byte layers (NLAYMAX)
constexpr int kWavLevels = 4;           // wavelet depth (WAV_LVL)
constexpr double kWavAccCoef = 1.75;    // tolerance derating (WAV_ACC_COEF)

// ----------------------------------------------------------------------------
// Encoder: writes through a raw pointer into a caller-sized buffer (the
// caller bounds the worst case; no per-byte capacity checks).
// ----------------------------------------------------------------------------
class RangeEncoder {
 public:
  explicit RangeEncoder(u8* out, u8 first_byte = 0)
      : out_(out), pos_(0), low_(0), range_(kTopValue), pending_ff_(0),
        cache_(first_byte), nbytes_(0) {}

  u64 bytes_written() const { return pos_; }

  // Encode symbol occupying [lt, lt+sy) of a total-frequency-tot model,
  // with the division done by precomputed magic (tot constant per block).
  inline void encode_m(u32 sy, u32 lt, u32 tot, const MagicDiv& md) {
    normalize();
    u32 r = md.div(range_);
    u32 d = r * lt;
    low_ += d;
    range_ -= d;
    if (lt + sy < tot) range_ = r * sy;
  }

  // Encode symbol occupying [lt, lt+sy) of a total-frequency-tot model.
  inline void encode(u32 sy, u32 lt, u32 tot) {
    normalize();
    u32 r = range_ / tot;
    u32 d = r * lt;
    low_ += d;
    // Last symbol of the model absorbs division slack (range_ -= d);
    // interior symbols take exactly r*sy.
    range_ -= d;
    if (lt + sy < tot) range_ = r * sy;
  }

  // Encode with power-of-two total frequency 1<<shift.
  inline void encode_shift(u32 sy, u32 lt, u32 shift) {
    normalize();
    u32 r = range_ >> shift;
    u32 d = r * lt;
    low_ += d;
    if ((lt + sy) >> shift)
      range_ -= d;
    else
      range_ = r * sy;
  }

  // Raw 16-bit value under a flat model.
  inline void put_u16(u32 v) { encode_shift(1, v, 16); }

  // Flush: emits the cache, pending bytes, a rounding byte and a 24-bit
  // running byte count (the classic 5-byte rngcod tail used for recovery).
  // Move written bytes out of the scratch window (coder state continues;
  // mirrors the reference's per-block databuf drain, wrappers.cpp:119-124).
  u64 drain() {
    u64 w = pos_;
    pos_ = 0;
    return w;
  }

  u64 finish() {
    normalize();
    nbytes_ += 5;
    u32 t;
    if ((low_ & (kBottomValue - 1)) < ((nbytes_ & 0xffffffu) >> 1))
      t = low_ >> kShiftBits;
    else
      t = (low_ >> kShiftBits) + 1;
    if (t > 0xff) {
      emit(cache_ + 1);
      flush_pending(0x00);
    } else {
      emit(cache_);
      flush_pending(0xff);
    }
    emit(t & 0xff);
    emit((nbytes_ >> 16) & 0xff);
    emit((nbytes_ >> 8) & 0xff);
    emit(nbytes_ & 0xff);
    return nbytes_;
  }

 private:
  inline void emit(u8 b) { out_[pos_++] = b; }
  inline void flush_pending(u8 b) {
    for (; pending_ff_; --pending_ff_) emit(b);
  }
  inline void normalize() {
    while (range_ <= kBottomValue) {
      if (low_ < (u32(0xff) << kShiftBits)) {      // no carry possible
        emit(cache_);
        flush_pending(0xff);
        cache_ = u8(low_ >> kShiftBits);
      } else if (low_ & kTopValue) {               // carry resolved now
        emit(cache_ + 1);
        flush_pending(0x00);
        cache_ = u8(low_ >> kShiftBits);
      } else {                                     // carry still possible
        ++pending_ff_;
      }
      range_ <<= 8;
      low_ = (low_ << 8) & (kTopValue - 1);
      ++nbytes_;
    }
  }

  u8* out_;
  u64 pos_;
  u32 low_, range_;
  u64 pending_ff_;
  u8 cache_;
  u64 nbytes_;
};

// ----------------------------------------------------------------------------
// Decoder: reads from a caller-provided byte span.
// ----------------------------------------------------------------------------
class RangeDecoder {
 public:
  RangeDecoder(const u8* data, u64 len) : data_(data), len_(len), pos_(0) {
    first_byte_ = next();            // byte written at start_encoding
    cache_ = next();
    low_ = cache_ >> (8 - kExtraBits);
    range_ = u32(1) << kExtraBits;
  }

  u8 first_byte() const { return first_byte_; }

  // Cumulative frequency of the next symbol under a total-tot model.
  // step_ is clamped to >= 1: a CORRUPT stream can present a block
  // "total" larger than the normalized range (counts are read raw from
  // the wire), which would make step_ 0 and SIGFPE on the next divide.
  // Valid streams never hit the clamp (tot <= 65536 < 2^23 < range_),
  // so decoded bytes are unchanged; corrupt streams produce garbage
  // output without crashing (the decoder's no-integrity contract).
  inline u32 cul_freq(u32 tot) {
    normalize();
    step_ = range_ / tot;
    if (step_ == 0) step_ = 1;
    u32 t = low_ / step_;
    return t >= tot ? tot - 1 : t;
  }

  // Magic-division variant for block-constant totals.
  inline u32 cul_freq_m(u32 tot, const MagicDiv& md) {
    normalize();
    step_ = md.div(range_);
    if (step_ == 0) step_ = 1;
    u32 t = low_ / step_;
    return t >= tot ? tot - 1 : t;
  }

  inline u32 cul_shift(u32 shift) {
    normalize();
    step_ = range_ >> shift;
    u32 t = low_ / step_;
    return (t >> shift) ? (u32(1) << shift) - 1 : t;
  }

  inline void update(u32 sy, u32 lt, u32 tot) {
    u32 d = step_ * lt;
    low_ -= d;
    if (lt + sy < tot)
      range_ = step_ * sy;
    else
      range_ -= d;
  }

  inline u16 get_u16() {
    u32 t = cul_shift(16);
    update(1, t, u32(1) << 16);
    return u16(t);
  }

  void finish() { normalize(); }

 private:
  inline u8 next() { return pos_ < len_ ? data_[pos_++] : 0; }
  inline void normalize() {
    while (range_ <= kBottomValue) {
      low_ = (low_ << 8) | ((u32(cache_) << kExtraBits) & 0xff);
      cache_ = next();
      low_ |= cache_ >> (8 - kExtraBits);
      range_ <<= 8;
    }
  }

  const u8* data_;
  u64 len_, pos_;
  u32 low_, range_, step_;
  u8 cache_, first_byte_;
};

// ----------------------------------------------------------------------------
// Layer framing: one independent range-coded stream per byte layer.
//
// Stream layout (contract: reference wrappers.cpp:85-139 + survey App.1-2):
//   leading literal 0x00 (encoder start byte), then per block:
//     marker bit "another block follows" (freq model {0,1}/2),
//     256 x raw u16 symbol counts,
//     `blocksize` symbols under the block's cumulative-count model;
//   a final 0-bit end marker, then the 5-byte coder tail.
//   When n % 60000 == 0 an empty block (256 zero counts) is emitted before
//   the end marker — part of the bitstream contract.
// ----------------------------------------------------------------------------
// Per-block 256-bin histogram. Four sub-histograms break the
// store-to-load forwarding chain on runs of equal symbols (the common
// case in low-entropy residual layers); summed at the end.
static inline void hist256(const u8* p, u64 n, u32* counts /* >=256 */) {
  u32 h[4][256] = {{0}};
  u64 i = 0;
  for (; i + 4 <= n; i += 4) {
    h[0][p[i]]++;
    h[1][p[i + 1]]++;
    h[2][p[i + 2]]++;
    h[3][p[i + 3]]++;
  }
  for (; i < n; ++i) h[0][p[i]]++;
  for (int s = 0; s < 256; ++s)
    counts[s] = h[0][s] + h[1][s] + h[2][s] + h[3][s];
}

// Appends the plane's stream to `out`. The coder writes through a small
// per-block scratch (worst case < 2 bytes/symbol + 514 bytes of model
// data) that stays cache-hot; `out` grows to the actual stream size only.
void encode_plane(const u8* syms, u64 n, std::vector<u8>& out) {
  // Reserve the worst case up front: reserve() maps without touching
  // pages, so only bytes actually written fault in — and append never
  // reallocates (repeated grow/copy of ~100MB streams caused mmap churn
  // that collapsed under CPU-steal).
  u64 nblocks = n / kBlockSymbols + 2;
  out.reserve(out.size() + 2 * n + nblocks * 1100 + 64);
  std::vector<u8> scratch(2 * kBlockSymbols + 4096);
  RangeEncoder enc(scratch.data(), 0);
  u32 counts[257];
  u64 pos = 0;
  for (;;) {
    u64 bs = std::min<u64>(kBlockSymbols, n - pos);
    enc.encode(1, 1, 2);  // block-present marker
    const u8* p = syms + pos;
    hist256(p, bs, counts);
    counts[256] = 0;
    for (int i = 0; i < 256; ++i) enc.put_u16(counts[i]);
    // Exclusive cumulative sums: counts[i] = #symbols < i, counts[256] = bs.
    u32 cum = 0;
    for (int i = 0; i < 257; ++i) {
      u32 c = counts[i];
      counts[i] = cum;
      cum += c;
    }
    if (bs) {
      MagicDiv md = MagicDiv::make(u32(bs));
      for (u64 i = 0; i < bs; ++i) {
        u8 ch = p[i];
        enc.encode_m(counts[ch + 1] - counts[ch], counts[ch], u32(bs), md);
      }
    }
    u64 w = enc.drain();
    out.insert(out.end(), scratch.data(), scratch.data() + w);
    pos += bs;
    if (bs < kBlockSymbols) break;  // short (or empty) block terminates
  }
  enc.encode(1, 0, 2);  // end marker
  enc.finish();
  u64 w = enc.drain();
  out.insert(out.end(), scratch.data(), scratch.data() + w);
}

// Returns number of symbols decoded (should equal expected n).
u64 decode_plane(const u8* data, u64 len, u8* syms, u64 n_expected) {
  RangeDecoder dec(data, len);
  u32 counts[257];
  u64 pos = 0;
  // corrupt-stream bound: no valid stream has more blocks than this
  // (a zero-padded tail can otherwise keep yielding marker bits)
  const u64 max_blocks = n_expected / kBlockSymbols + 2;
  u64 nb = 0;
  std::vector<u8> inv;  // cumulative-frequency -> symbol lookup
  while (dec.cul_freq(2) == 1) {
    if (++nb > max_blocks) break;
    dec.update(1, 1, 2);
    u32 cum = 0;
    for (int i = 0; i < 256; ++i) {
      u32 c = dec.get_u16();
      counts[i] = cum;
      cum += c;
    }
    counts[256] = cum;
    u32 bs = cum;
    inv.assign(bs, 0);
    for (int s = 0; s < 256; ++s)
      for (u32 i = counts[s]; i < counts[s + 1]; ++i) inv[i] = u8(s);
    if (bs) {
      MagicDiv md = MagicDiv::make(bs);
      for (u32 i = 0; i < bs; ++i) {
        u32 cf = dec.cul_freq_m(bs, md);
        u32 s = inv[cf];
        dec.update(counts[s + 1] - counts[s], counts[s], bs);
        if (pos < n_expected) syms[pos] = u8(s);
        ++pos;
      }
    }
  }
  dec.finish();
  return pos;
}

// ----------------------------------------------------------------------------
// K-way interleaved plane coding.
//
// All byte layers of one field carry exactly n symbols, so their block
// framing (block count, per-block sizes, the empty trailing block at
// n % 60000 == 0) is structurally identical. Encoding/decoding K such
// streams in lockstep keeps K independent coder dependency chains
// (normalize -> divide -> range update) in flight per core; the emitted
// bytes of each stream are bit-identical to a solo encode_plane /
// decode_plane call — the states never interact.
// ----------------------------------------------------------------------------
template <int K>
static void encode_planes_il(const u8* const* syms, u64 n,
                             std::vector<u8>* outs) {
  const u64 span = 2 * kBlockSymbols + 4096;
  u64 nblocks = n / kBlockSymbols + 2;
  for (int k = 0; k < K; ++k)
    outs[k].reserve(outs[k].size() + 2 * n + nblocks * 1100 + 64);
  std::vector<u8> scratch(span * K);
  std::vector<RangeEncoder> encs;
  encs.reserve(K);
  for (int k = 0; k < K; ++k)
    encs.emplace_back(scratch.data() + u64(k) * span, 0);
  u32 counts[K][257];
  u64 pos = 0;
  for (;;) {
    const u64 bs = std::min<u64>(kBlockSymbols, n - pos);
    for (int k = 0; k < K; ++k) encs[k].encode(1, 1, 2);
    for (int k = 0; k < K; ++k) {
      hist256(syms[k] + pos, bs, counts[k]);
      counts[k][256] = 0;
    }
    for (int i = 0; i < 256; ++i)
      for (int k = 0; k < K; ++k) encs[k].put_u16(counts[k][i]);
    for (int k = 0; k < K; ++k) {
      u32 cum = 0;
      for (int i = 0; i < 257; ++i) {
        u32 c = counts[k][i];
        counts[k][i] = cum;
        cum += c;
      }
    }
    if (bs) {
      const MagicDiv md = MagicDiv::make(u32(bs));
      const u8* p[K];
      for (int k = 0; k < K; ++k) p[k] = syms[k] + pos;
      for (u64 i = 0; i < bs; ++i) {
        for (int k = 0; k < K; ++k) {
          u8 ch = p[k][i];
          encs[k].encode_m(counts[k][ch + 1] - counts[k][ch], counts[k][ch],
                           u32(bs), md);
        }
      }
    }
    for (int k = 0; k < K; ++k) {
      u64 w = encs[k].drain();
      const u8* s = scratch.data() + u64(k) * span;
      outs[k].insert(outs[k].end(), s, s + w);
    }
    pos += bs;
    if (bs < kBlockSymbols) break;
  }
  for (int k = 0; k < K; ++k) {
    encs[k].encode(1, 0, 2);
    encs[k].finish();
    u64 w = encs[k].drain();
    const u8* s = scratch.data() + u64(k) * span;
    outs[k].insert(outs[k].end(), s, s + w);
  }
}

// Decode K equal-length streams in lockstep. Conforming streams of the
// same n have identical framing; for corrupt input the output is garbage
// (matching decode_plane's no-integrity-check contract) but never reads
// out of bounds (inv tables are padded to the lockstep block size).
// Returns the shared symbol count written per stream (== n for
// conforming streams), clamped to n.
template <int K>
static u64 decode_planes_il(const u8* const* data, const u64* lens,
                            u8* const* syms, u64 n) {
  std::vector<RangeDecoder> decs;
  decs.reserve(K);
  for (int k = 0; k < K; ++k) decs.emplace_back(data[k], lens[k]);
  u32 counts[K][257];
  std::vector<u8> inv[K];
  u64 pos = 0;
  const u64 max_blocks = n / kBlockSymbols + 2;   // corrupt-stream bound
  u64 nb = 0;
  for (;;) {
    u32 marker = decs[0].cul_freq(2);
    for (int k = 1; k < K; ++k) (void)decs[k].cul_freq(2);
    if (marker != 1 || ++nb > max_blocks) break;
    for (int k = 0; k < K; ++k) decs[k].update(1, 1, 2);
    u32 bs = 0;
    for (int k = 0; k < K; ++k) {
      u32 cum = 0;
      for (int i = 0; i < 256; ++i) {
        u32 c = decs[k].get_u16();
        counts[k][i] = cum;
        cum += c;
      }
      counts[k][256] = cum;
      bs = std::max(bs, cum);
    }
    for (int k = 0; k < K; ++k) {
      inv[k].assign(bs, 0);
      for (int s = 0; s < 256; ++s)
        for (u32 i = counts[k][s]; i < counts[k][s + 1]; ++i)
          inv[k][i] = u8(s);
    }
    if (bs) {
      const MagicDiv md = MagicDiv::make(bs);
      for (u32 i = 0; i < bs; ++i) {
        for (int k = 0; k < K; ++k) {
          u32 cf = decs[k].cul_freq_m(bs, md);
          u32 s = inv[k][cf];
          decs[k].update(counts[k][s + 1] - counts[k][s], counts[k][s], bs);
          if (pos + i < n) syms[k][pos + i] = u8(s);
        }
      }
    }
    pos += bs;
    if (bs < kBlockSymbols) {
      // short/empty block terminates; consume the end markers
      for (int k = 0; k < K; ++k) (void)decs[k].cul_freq(2);
      break;
    }
  }
  for (int k = 0; k < K; ++k) decs[k].finish();
  return std::min(pos, n);
}

// ----------------------------------------------------------------------------
// Turbo entropy coder (format v2, opt-in — NOT the reference bitstream).
//
// 8-lane interleaved rANS with a static per-block model: 65536-symbol
// blocks, 14-bit normalized frequencies transmitted raw (256 x u16),
// multiply/shift state updates (no division in either direction thanks
// to per-symbol magic reciprocals on encode and a slot->symbol table on
// decode), and four independent states round-robining over symbols so
// the state-update chains overlap per core. Compression is within ~1%
// of the range coder (14-bit probability quantization vs exact counts);
// throughput is several times higher. Selected by coder=1 in the field
// and batch entry points and by CODER_VERSION_TURBO in file headers —
// the default everywhere remains the bit-exact reference coder.
//
// Per-plane stream layout, given symbol count n (known from context):
//   for each 65536-symbol block (last may be short), a 1-byte tag:
//     tag 0 (modeled): u16 freqs[256] (LE, sum = 16384),
//                      u32 payload_len (LE),
//                      u8 payload[payload_len] (8 LE u32 lane states first)
//     tag 1 (raw):     bs verbatim bytes (near-incompressible blocks:
//                      rANS + model header would cost >= bs)
//     tag 2 (const):   u8 symbol (single-symbol block)
// The raw escape is chosen iff payload_len + 516 >= bs — the decision is
// part of the format (the JAX coder applies the identical rule so
// streams stay byte-identical).
// ----------------------------------------------------------------------------
namespace turbo {

constexpr u32 kProbBits = 14;
constexpr u32 kProbScale = 1u << kProbBits;
constexpr u64 kTBlock = 1u << 16;
constexpr u32 kRansL = 1u << 16;  // state lower bound (16-bit-word renorm)
constexpr int kLanes = 8;
// With kRansL = 2^16, word renorm, and per-symbol growth <= kProbBits
// < 16 bits, renormalization is a single branch on both sides: the
// encoder emits at most one u16 per symbol (after which the state is
// guaranteed below threshold again) and the decoder refills at most
// once. 8 interleaved lane states keep the multiply chains saturated.

// Deterministically normalize block counts to sum exactly kProbScale,
// every present symbol keeping frequency >= 1.
static void normalize_freqs(const u32* counts, u64 bs, u16* freqs) {
  u64 sum = 0;
  int maxs = -1;
  for (int i = 0; i < 256; ++i) {
    if (!counts[i]) {
      freqs[i] = 0;
      continue;
    }
    u32 f = u32(((u64)counts[i] * kProbScale) / bs);
    if (!f) f = 1;
    freqs[i] = u16(f);
    sum += f;
    if (maxs < 0 || counts[i] > counts[maxs]) maxs = i;
  }
  if (sum < kProbScale) {
    freqs[maxs] = u16(freqs[maxs] + (kProbScale - sum));
  } else {
    while (sum > kProbScale) {
      int b = -1;
      for (int i = 0; i < 256; ++i)
        if (freqs[i] > 1 && (b < 0 || freqs[i] > freqs[b])) b = i;
      u32 take = u32(std::min<u64>(freqs[b] - 1, sum - kProbScale));
      freqs[b] = u16(freqs[b] - take);
      sum -= take;
    }
  }
}

// ----------------------------------------------------------------------------
// AVX-512 lane engine for the 8-lane interleaved rANS (bit-identical
// streams; runtime-dispatched, scalar loops remain the portable path and
// the oracle for the A/B tests). The format's 8 interleaved lane states
// map onto one 8 x u32 vector; the only cross-lane coupling is the shared
// stream pointer, which VBMI2's masked compress-store (encode) and
// expand-load (decode) reproduce exactly: the scalar loops touch lanes in
// ascending-memory order within each group of 8 symbols.
// ----------------------------------------------------------------------------
#if defined(__x86_64__)
#define WR_HAVE_X86_SIMD 1

static bool rans_simd_ok() {
  static int ok = -1;
  if (ok < 0)
    ok = __builtin_cpu_supports("avx512f") &&
         __builtin_cpu_supports("avx512vl") &&
         __builtin_cpu_supports("avx512bw") &&
         __builtin_cpu_supports("avx512dq") &&
         __builtin_cpu_supports("avx512vbmi2") &&
         getenv("WR_NO_SIMD") == nullptr;
  return ok != 0;
}

// Encode groups of 8 symbols p[g..g+8) for g = hi-8 down to lo (hi-lo a
// multiple of 8), updating the 8 lane states in x and writing renormalized
// u16 words backwards from w. etab32[s] = freq | cum<<16.
//
// Exact floor(x/f): IEEE double division is correctly rounded, and with
// f <= 2^14 the true quotient is at least 1/f >= 2^-14 away from the
// integer on the wrong side, while the rounding error is < 2^-35
// (x/f < 2^18 quotient, 0.5 ulp relative 2^-53) — so truncating the
// rounded quotient always gives the exact integer quotient.
__attribute__((target("avx2,popcnt,avx512f,avx512vl,avx512bw,avx512dq,avx512vbmi2")))
static u16* rans_encode_simd(const u8* p, u64 lo, u64 hi, const u32* etab32,
                             u32* x, u16* w) {
  __m256i xv = _mm256_loadu_si256((const __m256i*)x);
  const __m256i m16 = _mm256_set1_epi32(0xFFFF);
  const __m256i scale = _mm256_set1_epi32(1 << kProbBits);
  for (u64 g = hi; g > lo;) {
    g -= 8;
    __m256i idx = _mm256_cvtepu8_epi32(
        _mm_loadl_epi64((const __m128i*)(p + g)));
    __m256i e = _mm256_i32gather_epi32((const int*)etab32, idx, 4);
    __m256i freq = _mm256_and_si256(e, m16);
    __m256i cum = _mm256_srli_epi32(e, 16);
    __m256i xmax = _mm256_slli_epi32(freq, 18);  // f << (16 + 18 - 16)
    __mmask8 k = _mm256_cmp_epu32_mask(xv, xmax, _MM_CMPINT_NLT);
    w -= _mm_popcnt_u32(k);
    _mm_mask_compressstoreu_epi16(w, k, _mm256_cvtepi32_epi16(xv));
    xv = _mm256_mask_srli_epi32(xv, k, xv, 16);
    __m512d xd = _mm512_cvtepu32_pd(xv);
    __m512d fd = _mm512_cvtepu32_pd(freq);
    __m256i q = _mm512_cvttpd_epu32(_mm512_div_pd(xd, fd));
    // x += q*(2^14 - f) + cum  ==  (q<<14) + (x - q*f) + cum (mod 2^32)
    xv = _mm256_add_epi32(
        xv, _mm256_add_epi32(
                _mm256_mullo_epi32(q, _mm256_sub_epi32(scale, freq)), cum));
  }
  _mm256_storeu_si256((__m256i*)x, xv);
  return w;
}

// Decode full groups of 8 symbols starting at *pi while at least 16 bytes
// of stream remain (each group consumes at most 8 u16 refills), updating
// lane states and the stream cursor. dtab[slot] = sym | freq<<16 |
// (slot - cum[sym])<<32.
__attribute__((target("avx2,popcnt,avx512f,avx512vl,avx512bw,avx512dq,avx512vbmi2")))
static void rans_decode_simd(u8* o, u64 bs, const u64* dtab, u32* x,
                             const u8** pw, const u8* wend, u64* pi) {
  __m256i xv = _mm256_loadu_si256((const __m256i*)x);
  const __m256i slotmask = _mm256_set1_epi32(kProbScale - 1);
  const __m256i m16 = _mm256_set1_epi32(0xFFFF);
  const __m256i lbound = _mm256_set1_epi32(kRansL);
  const u8* w = *pw;
  u64 i = *pi;
  for (; i + 8 <= bs && w + 16 <= wend; i += 8) {
    __m256i slot = _mm256_and_si256(xv, slotmask);
    __m512i e = _mm512_i32gather_epi64(slot, (const long long*)dtab, 8);
    _mm_storel_epi64((__m128i*)(o + i), _mm512_cvtepi64_epi8(e));
    __m256i freq =
        _mm256_and_si256(_mm512_cvtepi64_epi32(_mm512_srli_epi64(e, 16)), m16);
    __m256i off = _mm512_cvtepi64_epi32(_mm512_srli_epi64(e, 32));
    xv = _mm256_add_epi32(
        _mm256_mullo_epi32(freq, _mm256_srli_epi32(xv, kProbBits)), off);
    __mmask8 k = _mm256_cmp_epu32_mask(xv, lbound, _MM_CMPINT_LT);
    __m256i bits =
        _mm256_cvtepu16_epi32(_mm_maskz_expandloadu_epi16(k, w));
    xv = _mm256_mask_blend_epi32(
        k, xv, _mm256_or_si256(_mm256_slli_epi32(xv, 16), bits));
    w += 2 * _mm_popcnt_u32(k);
  }
  _mm256_storeu_si256((__m256i*)x, xv);
  *pw = w;
  *pi = i;
}
#else
#define WR_HAVE_X86_SIMD 0
static bool rans_simd_ok() { return false; }
#endif

static inline void put_le16(std::vector<u8>& out, u32 v) {
  out.push_back(u8(v));
  out.push_back(u8(v >> 8));
}
static inline void put_le32(std::vector<u8>& out, u32 v) {
  out.push_back(u8(v));
  out.push_back(u8(v >> 8));
  out.push_back(u8(v >> 16));
  out.push_back(u8(v >> 24));
}

void encode_plane_t(const u8* syms, u64 n, std::vector<u8>& out) {
  const u64 nblocks = (n + kTBlock - 1) / kTBlock;
  out.reserve(out.size() + n + nblocks * 600 + 64);
  // Backwards-filled scratch: worst case ~2 bytes/symbol + lane states.
  std::vector<u8> scratch(2 * kTBlock + 64);
  u32 counts[256];
  u16 freqs[256];
  u32 cum[257];
  MagicDiv md[256];
  for (u64 pos = 0; pos < n; pos += kTBlock) {
    const u64 bs = std::min<u64>(kTBlock, n - pos);
    const u8* p = syms + pos;
    hist256(p, bs, counts);
    normalize_freqs(counts, bs, freqs);
    // single-symbol fast path: tag 2 + the symbol
    int nsym = 0, only = 0;
    for (int i = 0; i < 256; ++i)
      if (counts[i]) {
        ++nsym;
        only = i;
      }
    if (nsym <= 1) {
      out.push_back(2);
      out.push_back(u8(only));
      continue;
    }
    const u64 tagpos = out.size();
    out.push_back(0);
    for (int i = 0; i < 256; ++i) put_le16(out, freqs[i]);
    cum[0] = 0;
    for (int i = 0; i < 256; ++i) cum[i + 1] = cum[i] + freqs[i];
    // SIMD engine takes the full groups of 8; the scalar loop takes the
    // top partial group (processed first — rANS encodes in reverse) and
    // the whole block on non-AVX-512 hosts.
    const u64 cut = rans_simd_ok() ? (bs & ~u64(7)) : 0;
    if (cut < bs)
      for (int i = 0; i < 256; ++i)
        if (freqs[i]) md[i] = MagicDiv::make(freqs[i]);
    // rANS encodes in reverse symbol order; u16 words are emitted
    // backwards so the stream reads forward on decode.
    u16* end16 = reinterpret_cast<u16*>(scratch.data()) + scratch.size() / 2;
    u16* w = end16;
    u32 x[kLanes];
    for (int k = 0; k < kLanes; ++k) x[k] = kRansL;
    for (u64 i = bs; i-- > cut;) {
      const int lane = int(i & (kLanes - 1));
      const u8 s = p[i];
      const u32 f = freqs[s];
      const u32 x_max = f * ((kRansL >> kProbBits) << 16);  // = f << 18
      u32 xv = x[lane];
      if (xv >= x_max) {
        *--w = u16(xv);
        xv >>= 16;
      }
      const u32 q = md[s].div(xv);
      x[lane] = (q << kProbBits) + (xv - q * f) + cum[s];
    }
#if WR_HAVE_X86_SIMD
    if (cut) {
      u32 etab32[256];
      for (int i = 0; i < 256; ++i)
        etab32[i] = u32(freqs[i]) | (cum[i] << 16);
      w = rans_encode_simd(p, 0, cut, etab32, x, w);
    }
#endif
    for (int k = kLanes; k-- > 0;) {
      *--w = u16(x[k] >> 16);
      *--w = u16(x[k]);
    }
    const u64 plen = u64(reinterpret_cast<u8*>(end16) -
                         reinterpret_cast<u8*>(w));
    if (plen + 516 >= bs) {
      // raw escape: the model header + payload can't beat verbatim bytes
      out.resize(tagpos);
      out.push_back(1);
      out.insert(out.end(), p, p + bs);
      continue;
    }
    put_le32(out, u32(plen));
    out.insert(out.end(), reinterpret_cast<u8*>(w),
               reinterpret_cast<u8*>(end16));
  }
}

u64 decode_plane_t(const u8* data, u64 len, u8* syms, u64 n) {
  const u8* r = data;
  const u8* rend = data + len;
  u16 freqs[256];
  u32 cum[257];
  std::vector<u8> symtab(kProbScale);
  std::vector<u64> dtab;  // slot -> sym | freq<<16 | (slot-cum)<<32
  u64 pos = 0;
  while (pos < n) {
    const u64 bs = std::min<u64>(kTBlock, n - pos);
    if (r >= rend) return pos;  // truncated
    const u8 tag = *r++;
    if (tag == 2) {  // constant block
      if (r >= rend) return pos;
      std::memset(syms + pos, *r++, bs);
      pos += bs;
      continue;
    }
    if (tag == 1) {  // raw block
      if (u64(rend - r) < bs) return pos;
      std::memcpy(syms + pos, r, bs);
      r += bs;
      pos += bs;
      continue;
    }
    if (tag != 0 || u64(rend - r) < 516) return pos;  // truncated/corrupt
    for (int i = 0; i < 256; ++i) {
      freqs[i] = u16(r[0] | (r[1] << 8));
      r += 2;
    }
    u32 plen = u32(r[0] | (r[1] << 8) | (r[2] << 16) | (u32(r[3]) << 24));
    r += 4;
    if (u64(rend - r) < plen || plen < u32(4 * kLanes)) return pos;
    cum[0] = 0;
    for (int i = 0; i < 256; ++i) cum[i + 1] = cum[i] + freqs[i];
    // model validity: every conforming block's frequencies sum to
    // exactly kProbScale; a corrupt model would otherwise index the
    // symtab/dtab heap out of bounds below
    if (cum[256] != kProbScale) return pos;
    for (int s = 0; s < 256; ++s)
      if (freqs[s]) std::memset(symtab.data() + cum[s], s, freqs[s]);
    const u8* w = r;
    u32 x[kLanes];
    for (int k = 0; k < kLanes; ++k) {
      x[k] = u32(w[0]) | (u32(w[1]) << 8) | (u32(w[2]) << 16) |
             (u32(w[3]) << 24);
      w += 4;
    }
    const u8* wend = r + plen;
    u8* o = syms + pos;
    u64 i = 0;
#if WR_HAVE_X86_SIMD
    if (rans_simd_ok() && bs >= 8) {
      if (dtab.empty()) dtab.resize(kProbScale);
      for (int s = 0; s < 256; ++s) {
        const u64 base = u64(u8(s)) | (u64(freqs[s]) << 16);
        u64* d = dtab.data() + cum[s];
        for (u32 j = 0; j < freqs[s]; ++j) d[j] = base | (u64(j) << 32);
      }
      // Takes full groups of 8 while >= 16 stream bytes remain (a group
      // refills at most 8 u16s), so the scalar tail's per-refill bounds
      // check can never have fired inside the SIMD region.
      rans_decode_simd(o, bs, dtab.data(), x, &w, wend, &i);
    }
#endif
    for (; i < bs; ++i) {
      const int lane = int(i & (kLanes - 1));
      u32 xv = x[lane];
      const u32 slot = xv & (kProbScale - 1);
      const u8 s = symtab[slot];
      o[i] = s;
      xv = u32(freqs[s]) * (xv >> kProbBits) + slot - cum[s];
      if (xv < kRansL && w + 1 < wend) {
        xv = (xv << 16) | (u32(w[0]) | (u32(w[1]) << 8));
        w += 2;
      }
      x[lane] = xv;
    }
    r = wend;
    pos += bs;
  }
  return pos;
}

}  // namespace turbo

// Coder selector: 0 = reference range coder (bit-exact format),
// 1 = turbo rANS (format v2).
static void encode_plane_c(int coder, const u8* syms, u64 n,
                           std::vector<u8>& out) {
  if (coder == 1)
    turbo::encode_plane_t(syms, n, out);
  else
    encode_plane(syms, n, out);
}

static u64 decode_plane_c(int coder, const u8* data, u64 len, u8* syms,
                          u64 n) {
  if (coder == 1) return turbo::decode_plane_t(data, len, syms, n);
  return decode_plane(data, len, syms, n);
}

// ----------------------------------------------------------------------------
// CDF 9/7 lifting wavelet, f64, in place, separable over x (fastest axis),
// y, z. Data layout: fld[ix + nx*iy + nx*ny*iz].
//
// Per 1-D line of length N (N > 1): split even/odd, extrapolate the missing
// odd tail sample when N is odd, four lifting updates with edge-replicated
// symmetric boundaries, then scale & pack [lo*s | hi/s].
// ----------------------------------------------------------------------------
constexpr double kLift[4] = {-1.5861343420693648, -0.0529801185718856,
                             0.8829110755411875, 0.4435068520511142};
constexpr double kScale = 1.1496043988602418;
constexpr double kScaleInv = 1.0 / 1.1496043988602418;

struct ExtCoef {
  double a, b, c;
};
static ExtCoef ext_coeffs() {
  double den = 1 + 2 * kLift[1] * kLift[2];
  return {-2 * kLift[0] * kLift[1] * kLift[2] / den,
          -2 * kLift[1] * kLift[2] / den,
          -2 * (kLift[0] + kLift[2] + 3 * kLift[0] * kLift[1] * kLift[2]) / den};
}

// The pipelines are templated over the element type: T=double is the
// bit-exact reference path; T=float is the opt-in f32-native mode
// (half the memory bandwidth; lifting constants rounded to f32, same
// stream format with f64 metadata).

// Forward-lift one gathered line of length n into out (same length).
template <typename T>
static void lift_line_fwd(const T* v, u64 n, T* lo, T* hi,
                          T* out) {
  const u64 m = n / 2 + (n % 2);
  for (u64 i = 0; i < m; ++i) lo[i] = v[2 * i];
  for (u64 i = 0; 2 * i + 1 < n; ++i) hi[i] = v[2 * i + 1];
  const T l0 = T(kLift[0]), l1 = T(kLift[1]), l2 = T(kLift[2]),
          l3 = T(kLift[3]), sc = T(kScale), si = T(kScaleInv);
  if (n % 2) {
    ExtCoef e = ext_coeffs();
    hi[m - 1] = lo[m - 2] * T(e.a) + hi[m - 2] * T(e.b) + lo[m - 1] * T(e.c);
  }
  for (u64 i = 0; i + 1 < m; ++i) hi[i] += l0 * (lo[i + 1] + lo[i]);
  hi[m - 1] += l0 * 2 * lo[m - 1];
  lo[0] += l1 * 2 * hi[0];
  for (u64 i = 1; i < m; ++i) lo[i] += l1 * (hi[i] + hi[i - 1]);
  for (u64 i = 0; i + 1 < m; ++i) hi[i] += l2 * (lo[i + 1] + lo[i]);
  hi[m - 1] += l2 * 2 * lo[m - 1];
  lo[0] += l3 * 2 * hi[0];
  for (u64 i = 1; i < m; ++i) lo[i] += l3 * (hi[i] + hi[i - 1]);
  for (u64 i = 0; i < m; ++i) {
    out[i] = lo[i] * sc;
    if (2 * i + 1 < n) out[i + m] = hi[i] * si;
  }
}

// Inverse-lift one gathered line of length m into out (same length).
template <typename T>
static void lift_line_inv(const T* v, u64 m, T* lo, T* hi,
                          T* out) {
  const u64 q = m / 2 + (m % 2);
  for (u64 i = 0; i < q; ++i) lo[i] = v[i] * T(kScaleInv);
  for (u64 i = 0; i < m - q; ++i) hi[i] = v[i + q] * T(kScale);
  if (m % 2) hi[q - 1] = 0;
  lo[0] -= T(kLift[3]) * 2 * hi[0];
  for (u64 i = 1; i < q; ++i) lo[i] -= T(kLift[3]) * (hi[i] + hi[i - 1]);
  for (u64 i = 0; i + 1 < q; ++i) hi[i] -= T(kLift[2]) * (lo[i + 1] + lo[i]);
  hi[q - 1] -= T(kLift[2]) * 2 * lo[q - 1];
  lo[0] -= T(kLift[1]) * 2 * hi[0];
  for (u64 i = 1; i < q; ++i) lo[i] -= T(kLift[1]) * (hi[i] + hi[i - 1]);
  for (u64 i = 0; i + 1 < q; ++i) hi[i] -= T(kLift[0]) * (lo[i + 1] + lo[i]);
  hi[q - 1] -= T(kLift[0]) * 2 * lo[q - 1];
  for (u64 i = 0; i < q; ++i) {
    out[2 * i] = lo[i];
    if (2 * i + 1 < m) out[2 * i + 1] = hi[i];
  }
}

struct Dim3 {
  u64 nx, ny, nz;
};

// Split [0, n) across worker threads (elements are disjoint, so any
// elementwise-parallel use preserves bit-exactness).
template <class F>
static void parallel_for(u64 n, const F& body, int nthreads = 0) {
  if (nthreads <= 0) {
    if (const char* e = getenv("WR_NUM_THREADS")) nthreads = atoi(e);
    if (nthreads <= 0)
      nthreads = (int)std::thread::hardware_concurrency();
    if (nthreads <= 0) nthreads = 1;
  }
  if (nthreads == 1 || n < 2) {
    for (u64 i = 0; i < n; ++i) body(i);
    return;
  }
  std::atomic<u64> next{0};
  auto work = [&]() {
    for (;;) {
      u64 i = next.fetch_add(1);
      if (i >= n) return;
      body(i);
    }
  };
  int nt = (int)std::min<u64>(nthreads, n);
  std::vector<std::thread> ths;
  for (int t = 1; t < nt; ++t) ths.emplace_back(work);
  work();
  for (auto& th : ths) th.join();
}

// ---------------------------------------------------------------------------
// Slab-vectorized sweeps for the y and z axes.
//
// Per-line gathers with power-of-two strides (e.g. 256^3) alias into a
// single cache set and collapse throughput ~50x. Instead, a sweep along a
// non-contiguous axis processes a whole 2-D slab at once: rows of `w`
// contiguous doubles are gathered with memcpy, the four lifting stages run
// elementwise across each row (auto-vectorized over x), and rows scatter
// back with the scale factors. Per-element operation ORDER is identical to
// the per-line code — every lifting op is elementwise along the line
// direction, so vectorizing across x preserves bit-exactness.
// ---------------------------------------------------------------------------

// Forward-lift along the row axis of a slab: n rows at base + i*rs, each
// w contiguous elements. lo/hi are (m x w) scratch buffers.
template <typename T>
static void lift_slab_fwd(T* base, u64 n, u64 w, u64 rs, T* lo,
                          T* hi) {
  const u64 m = n / 2 + (n % 2);
  for (u64 i = 0; i < m; ++i)
    std::memcpy(lo + i * w, base + (2 * i) * rs, w * sizeof(T));
  for (u64 i = 0; 2 * i + 1 < n; ++i)
    std::memcpy(hi + i * w, base + (2 * i + 1) * rs, w * sizeof(T));
  if (n % 2) {
    ExtCoef e = ext_coeffs();
    T* hm1 = hi + (m - 1) * w;
    const T* lm2 = lo + (m - 2) * w;
    const T* hm2 = hi + (m - 2) * w;
    const T* lm1 = lo + (m - 1) * w;
    const T ea = T(e.a), eb = T(e.b), ec = T(e.c);
    for (u64 x = 0; x < w; ++x)
      hm1[x] = lm2[x] * ea + hm2[x] * eb + lm1[x] * ec;
  }
  // stage 1: hi += l0*(lo_next + lo), tail doubled
  for (u64 i = 0; i + 1 < m; ++i) {
    T* h = hi + i * w;
    const T* l0p = lo + i * w;
    const T* l1p = lo + (i + 1) * w;
    for (u64 x = 0; x < w; ++x) h[x] += T(kLift[0]) * (l1p[x] + l0p[x]);
  }
  {
    T* h = hi + (m - 1) * w;
    const T* l = lo + (m - 1) * w;
    for (u64 x = 0; x < w; ++x) h[x] += T(kLift[0]) * 2 * l[x];
  }
  // stage 2: lo += l1*(hi + hi_prev), head doubled
  {
    T* l = lo;
    const T* h = hi;
    for (u64 x = 0; x < w; ++x) l[x] += T(kLift[1]) * 2 * h[x];
  }
  for (u64 i = 1; i < m; ++i) {
    T* l = lo + i * w;
    const T* h0 = hi + i * w;
    const T* hm = hi + (i - 1) * w;
    for (u64 x = 0; x < w; ++x) l[x] += T(kLift[1]) * (h0[x] + hm[x]);
  }
  // stage 3
  for (u64 i = 0; i + 1 < m; ++i) {
    T* h = hi + i * w;
    const T* l0p = lo + i * w;
    const T* l1p = lo + (i + 1) * w;
    for (u64 x = 0; x < w; ++x) h[x] += T(kLift[2]) * (l1p[x] + l0p[x]);
  }
  {
    T* h = hi + (m - 1) * w;
    const T* l = lo + (m - 1) * w;
    for (u64 x = 0; x < w; ++x) h[x] += T(kLift[2]) * 2 * l[x];
  }
  // stage 4
  {
    T* l = lo;
    const T* h = hi;
    for (u64 x = 0; x < w; ++x) l[x] += T(kLift[3]) * 2 * h[x];
  }
  for (u64 i = 1; i < m; ++i) {
    T* l = lo + i * w;
    const T* h0 = hi + i * w;
    const T* hm = hi + (i - 1) * w;
    for (u64 x = 0; x < w; ++x) l[x] += T(kLift[3]) * (h0[x] + hm[x]);
  }
  // scatter with scaling: [lo*s | hi/s]
  for (u64 i = 0; i < m; ++i) {
    T* dst = base + i * rs;
    const T* l = lo + i * w;
    for (u64 x = 0; x < w; ++x) dst[x] = l[x] * T(kScale);
  }
  for (u64 i = 0; 2 * i + 1 < n; ++i) {
    T* dst = base + (i + m) * rs;
    const T* h = hi + i * w;
    for (u64 x = 0; x < w; ++x) dst[x] = h[x] * T(kScaleInv);
  }
}

// Inverse-lift along the row axis of a slab (n rows).
template <typename T>
static void lift_slab_inv(T* base, u64 n, u64 w, u64 rs, T* lo,
                          T* hi) {
  const u64 q = n / 2 + (n % 2);
  for (u64 i = 0; i < q; ++i) {
    T* l = lo + i * w;
    const T* src = base + i * rs;
    for (u64 x = 0; x < w; ++x) l[x] = src[x] * T(kScaleInv);
  }
  for (u64 i = 0; i < n - q; ++i) {
    T* h = hi + i * w;
    const T* src = base + (i + q) * rs;
    for (u64 x = 0; x < w; ++x) h[x] = src[x] * T(kScale);
  }
  if (n % 2)
    std::memset(hi + (q - 1) * w, 0, w * sizeof(T));
  // stage 1: lo -= l3*(hi + hi_prev), head doubled
  {
    T* l = lo;
    const T* h = hi;
    for (u64 x = 0; x < w; ++x) l[x] -= T(kLift[3]) * 2 * h[x];
  }
  for (u64 i = 1; i < q; ++i) {
    T* l = lo + i * w;
    const T* h0 = hi + i * w;
    const T* hm = hi + (i - 1) * w;
    for (u64 x = 0; x < w; ++x) l[x] -= T(kLift[3]) * (h0[x] + hm[x]);
  }
  // stage 2: hi -= l2*(lo_next + lo), tail doubled
  for (u64 i = 0; i + 1 < q; ++i) {
    T* h = hi + i * w;
    const T* l0p = lo + i * w;
    const T* l1p = lo + (i + 1) * w;
    for (u64 x = 0; x < w; ++x) h[x] -= T(kLift[2]) * (l1p[x] + l0p[x]);
  }
  {
    T* h = hi + (q - 1) * w;
    const T* l = lo + (q - 1) * w;
    for (u64 x = 0; x < w; ++x) h[x] -= T(kLift[2]) * 2 * l[x];
  }
  // stage 3
  {
    T* l = lo;
    const T* h = hi;
    for (u64 x = 0; x < w; ++x) l[x] -= T(kLift[1]) * 2 * h[x];
  }
  for (u64 i = 1; i < q; ++i) {
    T* l = lo + i * w;
    const T* h0 = hi + i * w;
    const T* hm = hi + (i - 1) * w;
    for (u64 x = 0; x < w; ++x) l[x] -= T(kLift[1]) * (h0[x] + hm[x]);
  }
  // stage 4
  for (u64 i = 0; i + 1 < q; ++i) {
    T* h = hi + i * w;
    const T* l0p = lo + i * w;
    const T* l1p = lo + (i + 1) * w;
    for (u64 x = 0; x < w; ++x) h[x] -= T(kLift[0]) * (l1p[x] + l0p[x]);
  }
  {
    T* h = hi + (q - 1) * w;
    const T* l = lo + (q - 1) * w;
    for (u64 x = 0; x < w; ++x) h[x] -= T(kLift[0]) * 2 * l[x];
  }
  // re-interleave
  for (u64 i = 0; i < q; ++i)
    std::memcpy(base + (2 * i) * rs, lo + i * w, w * sizeof(T));
  for (u64 i = 0; 2 * i + 1 < n; ++i)
    std::memcpy(base + (2 * i + 1) * rs, hi + i * w, w * sizeof(T));
}

// Apply forward lifting along one axis of the active sub-box (n1,n2,n3) of
// the full array (stride layout from full dims).
template <typename T>
static void sweep_axis_fwd(T* fld, Dim3 full, Dim3 act, int axis) {
  const u64 sy = full.nx, sz = full.nx * full.ny;
  if (axis == 0) {
    const u64 n = act.nx;
    if (n <= 1) return;
    const u64 m = n / 2 + (n % 2);
    thread_local std::vector<T> lo, hi, out;
    parallel_for(act.nz * act.ny, [&](u64 j) {
      if (out.size() < n) { lo.resize(m); hi.resize(m); out.resize(n); }
      u64 j2 = j / act.ny, j1 = j % act.ny;
      T* line = fld + j1 * sy + j2 * sz;
      lift_line_fwd(line, n, lo.data(), hi.data(), out.data());
      std::memcpy(line, out.data(), n * sizeof(T));
    });
    return;
  }
  const u64 n = (axis == 1) ? act.ny : act.nz;
  if (n <= 1) return;
  const u64 m = n / 2 + (n % 2);
  const u64 w = act.nx;
  const u64 rs = (axis == 1) ? sy : sz;
  const u64 c = (axis == 1) ? act.nz : act.ny;
  const u64 cstride = (axis == 1) ? sz : sy;
  thread_local std::vector<T> lo, hi;
  parallel_for(c, [&](u64 j) {
    if (lo.size() < m * w) { lo.resize(m * w); hi.resize(m * w); }
    lift_slab_fwd(fld + j * cstride, n, w, rs, lo.data(), hi.data());
  });
}

template <typename T>
static void sweep_axis_inv(T* fld, Dim3 full, Dim3 act, int axis) {
  const u64 sy = full.nx, sz = full.nx * full.ny;
  if (axis == 0) {
    const u64 n = act.nx;
    if (n <= 1) return;
    const u64 q = n / 2 + (n % 2);
    thread_local std::vector<T> lo, hi, out;
    parallel_for(act.nz * act.ny, [&](u64 j) {
      if (out.size() < n) { lo.resize(q); hi.resize(q); out.resize(n); }
      u64 j2 = j / act.ny, j1 = j % act.ny;
      T* line = fld + j1 * sy + j2 * sz;
      lift_line_inv(line, n, lo.data(), hi.data(), out.data());
      std::memcpy(line, out.data(), n * sizeof(T));
    });
    return;
  }
  const u64 n = (axis == 1) ? act.ny : act.nz;
  if (n <= 1) return;
  const u64 q = n / 2 + (n % 2);
  const u64 w = act.nx;
  const u64 rs = (axis == 1) ? sy : sz;
  const u64 c = (axis == 1) ? act.nz : act.ny;
  const u64 cstride = (axis == 1) ? sz : sy;
  thread_local std::vector<T> lo, hi;
  parallel_for(c, [&](u64 j) {
    if (lo.size() < q * w) { lo.resize(q * w); hi.resize(q * w); }
    lift_slab_inv(fld + j * cstride, n, w, rs, lo.data(), hi.data());
  });
}

static inline u64 halve_up(u64 n) { return n / 2 + (n % 2); }

template <typename T>
void wavelet3d_forward(T* fld, u64 nx, u64 ny, u64 nz, int levels) {
  Dim3 full{nx, ny, nz};
  Dim3 act{nx, ny, nz};
  for (int k = 0; k < levels; ++k) {
    sweep_axis_fwd(fld, full, act, 0);
    sweep_axis_fwd(fld, full, act, 1);
    sweep_axis_fwd(fld, full, act, 2);
    act = {halve_up(act.nx), halve_up(act.ny), halve_up(act.nz)};
  }
}

// Forward transform that reads `src` and leaves it untouched: the first
// X sweep lifts each source line directly into `dst` (identical per-
// element op order to the in-place sweep), then the remaining sweeps run
// in place on dst. Saves the caller a full-array defensive copy.
template <typename T>
void wavelet3d_forward_from(const T* src, T* dst, u64 nx, u64 ny, u64 nz,
                            int levels) {
  const u64 n = nx * ny * nz;
  if (levels <= 0 || nx <= 1) {
    std::memcpy(dst, src, n * sizeof(T));
    wavelet3d_forward(dst, nx, ny, nz, levels);
    return;
  }
  Dim3 full{nx, ny, nz};
  Dim3 act{nx, ny, nz};
  {
    const u64 sy = nx, sz = nx * ny;
    const u64 m = nx / 2 + (nx % 2);
    thread_local std::vector<T> lo, hi;
    parallel_for(act.nz * act.ny, [&](u64 j) {
      if (lo.size() < m) { lo.resize(m); hi.resize(m); }
      u64 j2 = j / act.ny, j1 = j % act.ny;
      const T* line = src + j1 * sy + j2 * sz;
      lift_line_fwd(line, nx, lo.data(), hi.data(),
                    dst + j1 * sy + j2 * sz);
    });
  }
  sweep_axis_fwd(dst, full, act, 1);
  sweep_axis_fwd(dst, full, act, 2);
  act = {halve_up(act.nx), halve_up(act.ny), halve_up(act.nz)};
  for (int k = 1; k < levels; ++k) {
    sweep_axis_fwd(dst, full, act, 0);
    sweep_axis_fwd(dst, full, act, 1);
    sweep_axis_fwd(dst, full, act, 2);
    act = {halve_up(act.nx), halve_up(act.ny), halve_up(act.nz)};
  }
}

template <typename T>
void wavelet3d_inverse(T* fld, u64 nx, u64 ny, u64 nz, int levels) {
  Dim3 full{nx, ny, nz};
  for (int k = levels; k >= 1; --k) {
    // Active sub-box extent at depth k-1 is ceil(n / 2^(k-1)).
    u64 p = u64(1) << (k - 1);
    auto cdivp = [p](u64 n) { return n / p + (n % p ? 1 : 0); };
    Dim3 act{cdivp(nx), cdivp(ny), cdivp(nz)};
    // Note: a dimension participates iff its *active* extent > 1 here,
    // mirroring the reference's M>1 guards (waveletcdf97_3d.c:292,351,410).
    sweep_axis_inv(fld, full, act, 2);
    sweep_axis_inv(fld, full, act, 1);
    sweep_axis_inv(fld, full, act, 0);
  }
}

// ----------------------------------------------------------------------------
// Interleave-width selection + grouped dispatch helpers.
// ----------------------------------------------------------------------------
// Defaults from measurement (see PERFORMANCE.md): 4-wide lockstep on
// both sides — the decoder's per-symbol udiv chain is latency-bound and
// keeps gaining through 4 streams, and the encoder was re-measured
// faster at 4 as well (numbers below).
static int il_width(bool decode) {
  if (const char* e = getenv("WR_IL_STREAMS")) {
    int v = atoi(e);
    if (v == 1 || v == 2 || v == 4) return v;
  }
  // 4-wide keeps four independent normalize->divide->update chains in
  // flight per core: measured 0.092/0.105/0.123 GB/s/core for 1/2/4 on
  // the AVX-512 host (encode); decode gains similarly.
  (void)decode;
  return 4;
}

// Encode `cnt` (1..4) equal-length planes with the widest interleave.
static void encode_planes_group(const u8* const* syms, int cnt, u64 n,
                                std::vector<u8>* outs) {
  switch (cnt) {
    case 4:
      encode_planes_il<4>(syms, n, outs);
      break;
    case 3: {
      encode_planes_il<2>(syms, n, outs);
      encode_plane(syms[2], n, outs[2]);
      break;
    }
    case 2:
      encode_planes_il<2>(syms, n, outs);
      break;
    default:
      encode_plane(syms[0], n, outs[0]);
  }
}

// `ndec[k]` receives each stream's decoded symbol count clamped to n
// (== n for conforming streams; shorter for truncated/corrupt input so
// callers can zero the stale tail of a pooled plane buffer).
static void decode_planes_group(const u8* const* data, const u64* lens,
                                int cnt, u8* const* syms, u64 n,
                                u64* ndec) {
  switch (cnt) {
    case 4:
      ndec[0] = ndec[1] = ndec[2] = ndec[3] =
          decode_planes_il<4>(data, lens, syms, n);
      break;
    case 3: {
      ndec[0] = ndec[1] = decode_planes_il<2>(data, lens, syms, n);
      ndec[2] = std::min(decode_plane(data[2], lens[2], syms[2], n), n);
      break;
    }
    case 2:
      ndec[0] = ndec[1] = decode_planes_il<2>(data, lens, syms, n);
      break;
    default:
      ndec[0] = std::min(decode_plane(data[0], lens[0], syms[0], n), n);
  }
}

// ----------------------------------------------------------------------------
// Physical->wavelet index map (contract: waveletcdf97_3d.c:473-553, including
// the observed quirk that the returned level equals `levels` for any point
// once it has moved at least once — chlvl latches and the level counter then
// increments every iteration).
// ----------------------------------------------------------------------------
void index_phys_to_wav(int levels, int n1, int n2, int n3, int i1, int i2,
                       int i3, int* lvl, int* o1, int* o2, int* o3) {
  *lvl = 0;
  *o1 = i1;
  *o2 = i2;
  *o3 = i3;
  bool moved = false;
  for (int k = 1; k <= levels; ++k) {
    int m1 = n1 / 2 + (n1 % 2);
    int m2 = n2 / 2 + (n2 % 2);
    int m3 = n3 / 2 + (n3 % 2);
    if (n1 > 1 && *o3 < n3 && *o2 < n2 && *o1 < n1) {
      *o1 = (*o1 % 2) ? *o1 / 2 + m1 : *o1 / 2;
      moved = true;
    }
    if (n2 > 1 && *o3 < n3 && *o2 < n2 && *o1 < n1) {
      *o2 = (*o2 % 2) ? *o2 / 2 + m2 : *o2 / 2;
      moved = true;
    }
    if (n3 > 1 && *o3 < n3 && *o2 < n2 && *o1 < n1) {
      *o3 = (*o3 % 2) ? *o3 / 2 + m3 : *o3 / 2;
      moved = true;
    }
    n1 = m1;
    n2 = m2;
    n3 = m3;
    if (moved) *lvl += 1;
  }
}

// ----------------------------------------------------------------------------
// Quantization layers.
// ----------------------------------------------------------------------------

// Vectorizable min/max scan. Uses compare-select (maps to vminpd/vmaxpd),
// which equals the reference's sequential fmin/fmax for NaN-free data —
// the codec's domain (CFD fields; NaN inputs are out of contract).
template <typename T>
static inline void minmax_scan(const T* p, u64 n, T* mn_out,
                               T* mx_out) {
  T mn0 = p[0], mx0 = p[0], mn1 = p[0], mx1 = p[0];
  T mn2 = p[0], mx2 = p[0], mn3 = p[0], mx3 = p[0];
  u64 j = 0;
  for (; j + 4 <= n; j += 4) {
    T a = p[j], b = p[j + 1], c = p[j + 2], d = p[j + 3];
    mn0 = a < mn0 ? a : mn0; mx0 = a > mx0 ? a : mx0;
    mn1 = b < mn1 ? b : mn1; mx1 = b > mx1 ? b : mx1;
    mn2 = c < mn2 ? c : mn2; mx2 = c > mx2 ? c : mx2;
    mn3 = d < mn3 ? d : mn3; mx3 = d > mx3 ? d : mx3;
  }
  for (; j < n; ++j) {
    T a = p[j];
    mn0 = a < mn0 ? a : mn0;
    mx0 = a > mx0 ? a : mx0;
  }
  mn0 = mn1 < mn0 ? mn1 : mn0; mx0 = mx1 > mx0 ? mx1 : mx0;
  mn2 = mn3 < mn2 ? mn3 : mn2; mx2 = mx3 > mx2 ? mx3 : mx2;
  *mn_out = mn2 < mn0 ? mn2 : mn0;
  *mx_out = mx2 > mx0 ? mx2 : mx0;
}

struct LayerResult {
  double deps;
  double minval;
  bool last;
};

// Quantize the current residual field into syms, update the residual in
// place; uniform-cutoff fast path.
// Threads for the quantize passes: whatever the machine has beyond the
// coder workers (min/max is order-free; quantize/residual are
// elementwise, so chunked parallelism is bit-exact).
static int quant_threads() {
  if (const char* e = getenv("WR_QUANT_THREADS")) {
    int v = atoi(e);
    return v < 1 ? 1 : v;
  }
  int hw = (int)std::thread::hardware_concurrency();
  int coder = hw < kLayersMax ? hw : kLayersMax;
  int extra = hw - coder;
  return extra < 1 ? 1 : extra;
}

// Fused quantize pass: one sweep computes the symbols, updates the
// residual in place, AND tracks the residual's min/max (= next layer's
// model bounds). Cuts the quantize stage from 3 memory passes per layer
// (scan, quantize, residual) to 1 (+ one initial scan of the wavelet
// field). The residual VALUES are identical to the unfused reference
// sequence, and chunk-local compare-select min/max equals sequential
// fmin/fmax on NaN-free data, so layer schedules stay bit-exact.
template <typename T, bool kWriteResid = true>
static void quantize_residual_fused(T* fld, u8* syms, u64 j0, u64 j1,
                                    T a, T b, T deps,
                                    T mn, T* out_mn,
                                    T* out_mx) {
  if constexpr (!kWriteResid) {
    // Final layer: nothing reads the residual or its bounds — emit
    // symbols only (saves a full-array store per encode).
    for (u64 j = j0; j < j1; ++j) syms[j] = u8(a * fld[j] + b);
    *out_mn = *out_mx = 0;
    return;
  }
  T rmn = 0, rmx = 0;
  bool first = true;
  for (u64 j = j0; j < j1; ++j) {
    T fq = a * fld[j] + b;
    u8 s = u8(fq);  // truncation == floor for non-negative fq
    syms[j] = s;
    T r = fld[j] - (s * deps + mn);
    fld[j] = r;
    if (first) {
      rmn = rmx = r;
      first = false;
    }
    rmn = r < rmn ? r : rmn;
    rmx = r > rmx ? r : rmx;
  }
  *out_mn = rmn;
  *out_mx = rmx;
}

// Chunk-parallel min/max of fld[0..n) (compare-select; equals the
// reference's sequential fmin/fmax for NaN-free data).
template <typename T>
static void minmax_parallel(const T* fld, u64 n, int qt, T* mn_out,
                            T* mx_out) {
  const u64 chunk = 1u << 21;
  const u64 nchunks = (n + chunk - 1) / chunk;
  if (qt == 1 || nchunks < 2) {
    minmax_scan(fld, n, mn_out, mx_out);
    return;
  }
  std::vector<T> mns(nchunks), mxs(nchunks);
  parallel_for(nchunks, [&](u64 ci) {
    u64 j0 = ci * chunk, j1 = std::min(n, j0 + chunk);
    minmax_scan(fld + j0, j1 - j0, &mns[ci], &mxs[ci]);
  }, qt);
  T mn = mns[0], mx = mxs[0];
  for (u64 ci = 1; ci < nchunks; ++ci) {
    mn = mns[ci] < mn ? mns[ci] : mn;
    mx = mxs[ci] > mx ? mxs[ci] : mx;
  }
  *mn_out = mn;
  *mx_out = mx;
}

// Layer schedule step: given the current field bounds, derive the model
// (deps/min) and whether this is the final layer, then run the fused
// quantize+residual+next-bounds pass.
template <typename T>
static LayerResult quantize_layer_fused(T* fld, u8* syms, u64 n,
                                        T tolabs, int ilay, T mn,
                                        T mx, T* next_mn,
                                        T* next_mx) {
  const int qt = quant_threads();
  T deps = (mx - mn) / T(255.0);
  bool last = false;
  if (deps < tolabs) {
    deps = tolabs;
    last = true;
  }
  if (ilay >= kLayersMax - 1) last = true;
  const T a = T(1.0) / deps;
  const T b = -mn * a + T(0.5);
  const u64 chunk = 1u << 21;
  const u64 nchunks = (n + chunk - 1) / chunk;
  if (qt == 1 || nchunks < 2) {
    if (last)
      quantize_residual_fused<T, false>(fld, syms, 0, n, a, b, deps, mn,
                                        next_mn, next_mx);
    else
      quantize_residual_fused(fld, syms, 0, n, a, b, deps, mn, next_mn,
                              next_mx);
  } else {
    std::vector<T> mns(nchunks), mxs(nchunks);
    parallel_for(nchunks, [&](u64 ci) {
      u64 j0 = ci * chunk, j1 = std::min(n, j0 + chunk);
      if (last)
        quantize_residual_fused<T, false>(fld, syms, j0, j1, a, b, deps,
                                          mn, &mns[ci], &mxs[ci]);
      else
        quantize_residual_fused(fld, syms, j0, j1, a, b, deps, mn,
                                &mns[ci], &mxs[ci]);
    }, qt);
    T rmn = mns[0], rmx = mxs[0];
    for (u64 ci = 1; ci < nchunks; ++ci) {
      rmn = mns[ci] < rmn ? mns[ci] : rmn;
      rmx = mxs[ci] > rmx ? mxs[ci] : rmx;
    }
    *next_mn = rmn;
    *next_mx = rmx;
  }
  return {deps, mn, last};
}

// Local-cutoff variant (mtot > 1): per-element precision mask driven by the
// physical->wavelet index map (contract: wrappers.cpp:343-379). Templated
// over the pipeline dtype like the rest of the quantizer; the f32
// instantiation follows the f32 pipeline's convention of running the
// layer arithmetic in T (parity with quantize_layer_fused<float>).
template <typename T>
static LayerResult quantize_layer_masked(T* fld, u8* syms, u64 nx, u64 ny,
                                         u64 nz, double tolabs, double tolrel,
                                         int wlev, int mx, int my, int mz,
                                         const double* cutoffvec, int ilay) {
  const u64 n = nx * ny * nz;
  T mn, mxv;
  minmax_scan(fld, n, &mn, &mxv);
  T deps = (mxv - mn) / T(255.0);
  bool last = false;
  if (deps < T(tolabs)) {
    deps = T(tolabs);
    last = true;
  }
  if (ilay >= kLayersMax - 1) last = true;
  const T a = T(1.0) / deps;
  const T b = -mn * a + T(0.5);
  for (u64 jp = 0; jp < n; ++jp) {
    int px = int(jp % nx), py = int((jp / nx) % ny), pz = int(jp / nx / ny);
    int l, wx, wy, wz;
    index_phys_to_wav(wlev, int(nx), int(ny), int(nz), px, py, pz, &l, &wx,
                      &wy, &wz);
    double precmask = tolabs;
    if (l <= 1 /* LOC_CUTOFF_LVL */) {
      int kx = int(double(px) / double(nx) * double(mx));
      int ky = int(double(py) / double(ny) * double(my));
      int kz = int(double(pz) / double(nz) * double(mz));
      precmask = tolabs / tolrel * cutoffvec[kx + mx * ky + mx * my * kz];
    }
    u64 jw = u64(wx) + nx * u64(wy) + nx * ny * u64(wz);
    if (double(mxv) - double(mn) < precmask) {
      syms[jw] = 0;
      fld[jw] = mn;
    } else {
      T fq = a * fld[jw] + b;
      syms[jw] = u8(fq);
    }
  }
  for (u64 j = 0; j < n; ++j) fld[j] = fld[j] - (syms[j] * deps + mn);
  return {double(deps), double(mn), last};
}

// ----------------------------------------------------------------------------
// Full-field encode/decode (contract: wrappers.cpp:228-527).
// ----------------------------------------------------------------------------
struct EncodeOut {
  double tolabs, midval, halfspanval;
  u8 wlev, nlay;
  u64 ntot_enc;
  double deps_vec[kLayersMax];
  double minval_vec[kLayersMax];
  u64 len_enc_vec[kLayersMax];
};

static bool wr_prof_enabled() {
  static const bool prof = [] {
    const char* e = getenv("WR_PROF");
    return e && *e == '1';
  }();
  return prof;
}

// Process-wide recycler for the codec's large flat buffers. First-touch
// page faults cost ~27 us/page on the virtualized hosts this runs on
// (184K faults for a 753 MB stream buffer = ~5 s of kernel time per
// encode), while writes into a recycled arena re-fault at ~0.6 us. The
// pool keeps a handful of big vectors alive across calls; capacity is
// retained through clear()/resize() so their pages stay mapped.
class BufPool {
 public:
  // A vector with capacity >= cap, resized to `size` (pages retained).
  static std::vector<u8> get(u64 cap, u64 size) {
    {
      std::lock_guard<std::mutex> lk(mu());
      auto& p = pool();
      int best = -1;
      for (int i = 0; i < (int)p.size(); ++i)
        if (p[i].capacity() >= cap &&
            (best < 0 || p[i].capacity() < p[best].capacity()))
          best = i;  // smallest sufficient buffer
      if (best >= 0) {
        std::vector<u8> v = std::move(p[best]);
        p.erase(p.begin() + best);
        v.resize(size);
        return v;
      }
    }
    std::vector<u8> v;
    v.reserve(cap);
    v.resize(size);
    return v;
  }
  static void put(std::vector<u8>&& v) {
    if (v.capacity() < (u64(1) << 20)) return;  // not worth pooling
    // deliberately NOT cleared: keeping size() == high-water mark means
    // the next get()'s resize() only shrinks or value-inits the grown
    // tail — re-zeroing a pooled 8 GB plane buffer on every call would
    // cost ~0.5 s by itself
    std::lock_guard<std::mutex> lk(mu());
    auto& p = pool();
    if (p.size() >= 24) {  // bound resident pool; drop the smallest
      int mi = 0;
      for (int i = 1; i < (int)p.size(); ++i)
        if (p[i].capacity() < p[mi].capacity()) mi = i;
      p.erase(p.begin() + mi);
    }
    p.push_back(std::move(v));
    // Total-bytes budget (WR_POOL_BYTES, default 48 GiB — comfortably
    // above the ~32 GB a 1024^3 encode recycles, but a bound for
    // long-lived mixed-size workloads). Evict smallest-first: the large
    // buffers are the expensive ones to re-fault.
    u64 total = 0;
    for (auto& b : p) total += b.capacity();
    while (total > budget() && !p.empty()) {
      // smallest-first keeps the most expensive-to-refault buffers,
      // but the budget is strict: a single over-budget buffer is
      // dropped too (callers with WR_POOL_BYTES set want the bound)
      int mi = 0;
      for (int i = 1; i < (int)p.size(); ++i)
        if (p[i].capacity() < p[mi].capacity()) mi = i;
      total -= p[mi].capacity();
      p.erase(p.begin() + mi);
    }
  }
  // Release every pooled buffer (exposed through the C ABI as
  // wrn_pool_trim for callers that just finished a large batch).
  static void trim() {
    std::lock_guard<std::mutex> lk(mu());
    pool().clear();
  }
 private:
  static u64 budget() {
    static const u64 b = [] {
      if (const char* e = getenv("WR_POOL_BYTES")) {
        double v = atof(e);
        if (v > 0) return (u64)v;
      }
      return u64(48) << 30;
    }();
    return b;
  }
  static std::mutex& mu() {
    static std::mutex m;
    return m;
  }
  static std::vector<std::vector<u8>>& pool() {
    static std::vector<std::vector<u8>>* p =
        new std::vector<std::vector<u8>>();
    return *p;
  }
};

// Shared layer pipeline: quantize `fld` (already in wavelet space, or
// physical space when wlev==0) into byte layers and entropy-code them
// directly into `sink` (capacity contract: 8 * max(n, 1024), the
// setup_wr allocation rule — wrappers.cpp:531-541).
template <typename T>
static void encode_layers(T* fld, u64 nx, u64 ny, u64 nz, int mx, int my,
                          int mz, const double* cutoffvec, double tolrel,
                          EncodeOut* out, u8* sink, int coder) {
  const u64 n = nx * ny * nz;
  const u64 mtot = u64(mx) * u64(my) * u64(mz);
  const bool prof = wr_prof_enabled();
  auto now = [] { return std::chrono::steady_clock::now(); };
  auto secs = [](auto a, auto b) {
    return std::chrono::duration<double>(b - a).count();
  };
  auto t_wav = now();

  // Bounded layer pipeline: quantization is sequential through the
  // residual field, the per-layer entropy streams are independent. A
  // small slot pool (threads + 2 planes) keeps coder workers busy while
  // bounding resident memory — the full 8-plane matrix at 512^3 is
  // >1 GiB, which this host's paging punishes.
  // Coder concurrency: the quantizer (main thread) runs concurrently with
  // the coder workers, so spawning hw workers oversubscribes small hosts
  // (measured 15% SLOWER on 2 vCPUs). Spawn hw-1 workers and let the main
  // thread join the coder pool once every layer is quantized — all cores
  // stay busy in both phases without oversubscription.
  int nthreads = (int)std::thread::hardware_concurrency();
  if (const char* e = getenv("WR_NUM_THREADS")) nthreads = atoi(e);
  if (nthreads < 1) nthreads = 1;
  if (nthreads > kLayersMax) nthreads = kLayersMax;
  // nthreads==1 means strictly serial: 0 workers, the main thread's
  // trailing work() call does all coding after quantization.
  const int nworkers = nthreads > 1 ? nthreads - 1 : 0;
  // All 8 slots by default: the fused quantizer produces layers ~10x
  // faster than the coder consumes them, so slot waits would serialize
  // the machine's only spare core behind the coder (measured on the
  // 2-vCPU host). Memory cost is n bytes/layer — one-eighth of the f64
  // input per slot; WR_CODER_SLOTS trims it for memory-tight hosts.
  int slots = kLayersMax;
  if (const char* e = getenv("WR_CODER_SLOTS")) {
    int v = atoi(e);
    if (v >= 3 && v <= kLayersMax) slots = v;
  }
  slots = std::min(slots, kLayersMax);
  // planebuf and the per-layer stream buffers come from the process
  // pool: their pages stay mapped across calls (see BufPool).
  std::vector<u8> planebuf = BufPool::get(u64(slots) * n, u64(slots) * n);
  const u64 scap = 2 * n + (n / kBlockSymbols + 2) * 1100 + 64;
  std::vector<u8> streams[kLayersMax];
  for (int l = 0; l < kLayersMax; ++l) streams[l] = BufPool::get(scap, 0);

  std::mutex mu;
  std::condition_variable cv;
  int n_queued = 0;                 // layers quantized so far
  int next_claim = 0;               // next layer a worker may claim
  bool all_queued = false;
  bool layer_done[kLayersMax] = {false};

  const int gw = std::min(4, il_width(false));
  auto code_claimed = [&](int l, int cnt) {
    if (coder == 0 && cnt > 1) {
      const u8* p[4];
      for (int k = 0; k < cnt; ++k)
        p[k] = planebuf.data() + u64((l + k) % slots) * n;
      encode_planes_group(p, cnt, n, &streams[l]);
    } else {
      for (int k = 0; k < cnt; ++k)
        encode_plane_c(coder, planebuf.data() + u64((l + k) % slots) * n,
                       n, streams[l + k]);
    }
    {
      std::lock_guard<std::mutex> lk(mu);
      for (int k = 0; k < cnt; ++k) layer_done[l + k] = true;
    }
    cv.notify_all();
  };
  auto work = [&]() {
    int l, cnt;
    for (;;) {
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] {
          // next unclaimed layer == count of claimed ones; claim via
          // a shared cursor guarded by the same mutex
          return next_claim < n_queued || all_queued;
        });
        if (next_claim >= n_queued) {
          if (all_queued) return;
          continue;
        }
        // opportunistic pairing: grab a second already-queued layer to
        // interleave both coder streams on this core
        l = next_claim;
        cnt = std::min(gw, n_queued - next_claim);
        next_claim += cnt;
      }
      code_claimed(l, cnt);
    }
  };
  // While waiting for a slot, the main thread joins the coder pool
  // instead of blocking: the oldest unclaimed layer is usually the slot
  // blocker itself, and on small hosts (2 vCPUs) a blocked quantizer
  // would leave half the machine idle during the coder-bound bulk of
  // the encode. Also the only drain mechanism when nworkers == 0.
  auto help_until_done = [&](int need_layer) {
    for (;;) {
      int l = 0, cnt = 0;
      {
        std::unique_lock<std::mutex> lk(mu);
        if (layer_done[need_layer]) return;
        if (next_claim < n_queued) {
          l = next_claim;
          cnt = std::min(gw, n_queued - next_claim);
          next_claim += cnt;
        } else {
          cv.wait(lk, [&] { return layer_done[need_layer]; });
          return;
        }
      }
      code_claimed(l, cnt);
    }
  };
  std::vector<std::thread> ths;
  for (int t = 0; t < nworkers; ++t) ths.emplace_back(work);

  // Layer-0 model bounds from one scan of the wavelet field; each fused
  // quantize pass then yields the next layer's bounds for free.
  T lmn = 0, lmx = 0;
  if (mtot <= 1) minmax_parallel(fld, n, quant_threads(), &lmn, &lmx);

  int ilay = 0;
  for (;;) {
    if (ilay >= slots) {
      // slot reuse: the specific layer that used this slot must be done
      help_until_done(ilay - slots);
    }
    u8* syms = planebuf.data() + u64(ilay % slots) * n;
    LayerResult lr;
    if (mtot > 1) {
      // Local-cutoff (reference wrappers.cpp:343-379) templated over the
      // pipeline dtype; effectively uniform in practice (SURVEY §2
      // ind_p2w_3d quirk) but the masked sweep is honored in both
      // precisions.
      lr = quantize_layer_masked(fld, syms, nx, ny, nz, out->tolabs,
                                 tolrel, out->wlev, mx, my, mz, cutoffvec,
                                 ilay);
    } else {
      lr = quantize_layer_fused(fld, syms, n, T(out->tolabs), ilay, lmn,
                                lmx, &lmn, &lmx);
    }
    out->deps_vec[ilay] = lr.deps;
    out->minval_vec[ilay] = lr.minval;
    ++ilay;
    {
      std::lock_guard<std::mutex> lk(mu);
      n_queued = ilay;
    }
    cv.notify_all();
    if (lr.last) break;
  }
  {
    std::lock_guard<std::mutex> lk(mu);
    all_queued = true;
  }
  cv.notify_all();
  auto t_q = now();
  work();  // main thread codes remaining layers alongside the workers
  for (auto& th : ths) th.join();
  if (prof)
    fprintf(stderr,
            "[wr prof] quantize(+slot waits) %.3fs coder-drain %.3fs "
            "nlay %d\n",
            secs(t_wav, t_q), secs(t_q, now()), ilay);

  auto t_cc = now();
  u64 total = 0;
  for (int l = 0; l < ilay; ++l) total += streams[l].size();
  // Safety-buffer contract (wrappers.cpp:415-427): the caller allocated
  // SAFETY_BUFFER_FACTOR * NLAYMAX * max(n, 1024) bytes. Reachable for
  // near-incompressible 8-layer fields (block-model overhead); these
  // frames sit under an extern "C" ABI (ctypes / Fortran) where an
  // escaping exception is std::terminate, so signal via the
  // ntot_enc == ~0 sentinel instead of throwing (the Python layer
  // raises ValueError; Fortran callers see ntot_enc_sg == -1).
  const u64 cap = u64(kLayersMax) * std::max<u64>(n, 1024);
  if (total > cap) {
    out->nlay = u8(ilay);
    out->ntot_enc = ~u64(0);
    BufPool::put(std::move(planebuf));
    for (int l = 0; l < kLayersMax; ++l)
      BufPool::put(std::move(streams[l]));
    return;
  }
  u64 off = 0;
  for (int l = 0; l < ilay; ++l) {
    out->len_enc_vec[l] = streams[l].size();
    std::memcpy(sink + off, streams[l].data(), streams[l].size());
    off += streams[l].size();
  }
  out->nlay = u8(ilay);
  out->ntot_enc = total;
  BufPool::put(std::move(planebuf));
  for (int l = 0; l < kLayersMax; ++l) BufPool::put(std::move(streams[l]));
  if (prof)
    fprintf(stderr, "[wr prof] sink concat %.3fs (%zu bytes)\n",
            secs(t_cc, now()), size_t(total));
}

// Field-encode entry, clobbering: `fld` is transformed + consumed in
// place (reference contract — encoding_wrap clobbers its input,
// README §IV NOTE / wrappers.cpp:228-452).
template <typename T>
void encode_field(T* fld, u64 nx, u64 ny, u64 nz, int wtflag, int mx,
                  int my, int mz, const double* cutoffvec, EncodeOut* out,
                  u8* sink, int coder = 0) {
  const u64 n = nx * ny * nz;
  const u64 mtot = u64(mx) * u64(my) * u64(mz);
  out->wlev = wtflag ? kWavLevels : 0;
  std::memset(out->deps_vec, 0, sizeof(out->deps_vec));
  std::memset(out->minval_vec, 0, sizeof(out->minval_vec));
  std::memset(out->len_enc_vec, 0, sizeof(out->len_enc_vec));
  const bool prof = wr_prof_enabled();
  auto now = [] { return std::chrono::steady_clock::now(); };
  auto secs = [](auto a, auto b) {
    return std::chrono::duration<double>(b - a).count();
  };
  auto t_start = now();

  T mn, mx_;
  minmax_scan(fld, n, &mn, &mx_);
  out->halfspanval = (double(mx_) - double(mn)) / 2;
  out->midval = double(mn) + out->halfspanval;
  const double tiny = std::is_same<T, double>::value
                          ? 2 * DBL_MIN : 2 * double(FLT_MIN);
  if (out->halfspanval <= tiny) {
    out->ntot_enc = 0;
    out->nlay = 0;
    out->tolabs = 0;
    return;
  }
  auto t_mm = now();
  wavelet3d_forward(fld, nx, ny, nz, int(out->wlev));
  if (prof)
    fprintf(stderr, "[wr prof] minmax %.3fs wavelet %.3fs\n",
            secs(t_start, t_mm), secs(t_mm, now()));
  double tolrel = cutoffvec[0];
  for (u64 k = 1; k < mtot; ++k) tolrel = std::min(tolrel, cutoffvec[k]);
  out->tolabs = tolrel *
                std::fmax(std::fabs(double(mn)), std::fabs(double(mx_))) /
                kWavAccCoef;
  encode_layers(fld, nx, ny, nz, mx, my, mz, cutoffvec, tolrel, out, sink,
                coder);
}

// Non-clobbering entry: `src` stays untouched; the first wavelet sweep
// lifts it into an internal scratch (no defensive full-array copy).
template <typename T>
void encode_field_nc(const T* src, u64 nx, u64 ny, u64 nz, int wtflag,
                     int mx, int my, int mz, const double* cutoffvec,
                     EncodeOut* out, u8* sink, int coder = 0) {
  const u64 n = nx * ny * nz;
  const u64 mtot = u64(mx) * u64(my) * u64(mz);
  out->wlev = wtflag ? kWavLevels : 0;
  std::memset(out->deps_vec, 0, sizeof(out->deps_vec));
  std::memset(out->minval_vec, 0, sizeof(out->minval_vec));
  std::memset(out->len_enc_vec, 0, sizeof(out->len_enc_vec));
  const bool prof = wr_prof_enabled();
  auto now = [] { return std::chrono::steady_clock::now(); };
  auto secs = [](auto a, auto b) {
    return std::chrono::duration<double>(b - a).count();
  };
  auto t_start = now();

  T mn, mx_;
  minmax_parallel(src, n, quant_threads(), &mn, &mx_);
  out->halfspanval = (double(mx_) - double(mn)) / 2;
  out->midval = double(mn) + out->halfspanval;
  const double tiny = std::is_same<T, double>::value
                          ? 2 * DBL_MIN : 2 * double(FLT_MIN);
  if (out->halfspanval <= tiny) {
    out->ntot_enc = 0;
    out->nlay = 0;
    out->tolabs = 0;
    return;
  }
  auto t_mm = now();
  // pooled (pages stay mapped across calls — an 8 GB fresh allocation
  // at 1024^3 pays ~60 s of first-touch faults on this VM class); the
  // first sweep writes every element before anything reads it
  std::vector<u8> scratch_b =
      BufPool::get(n * sizeof(T), n * sizeof(T));
  T* scratch = reinterpret_cast<T*>(scratch_b.data());
  if (out->wlev > 0)
    wavelet3d_forward_from(src, scratch, nx, ny, nz, int(out->wlev));
  else
    std::memcpy(scratch, src, n * sizeof(T));
  if (prof)
    fprintf(stderr, "[wr prof] minmax %.3fs wavelet(oop) %.3fs\n",
            secs(t_start, t_mm), secs(t_mm, now()));
  double tolrel = cutoffvec[0];
  for (u64 k = 1; k < mtot; ++k) tolrel = std::min(tolrel, cutoffvec[k]);
  out->tolabs = tolrel *
                std::fmax(std::fabs(double(mn)), std::fabs(double(mx_))) /
                kWavAccCoef;
  encode_layers(scratch, nx, ny, nz, mx, my, mz, cutoffvec, tolrel,
                out, sink, coder);
  BufPool::put(std::move(scratch_b));
  if (prof)
    fprintf(stderr, "[wr prof] encode_field_nc total %.3fs\n",
            secs(t_start, now()));
}

template <typename T>
void decode_field(T* fld, u64 nx, u64 ny, u64 nz, double midval, u8 wlev,
                  u8 nlay, u64 ntot_enc, const double* deps_vec,
                  const double* minval_vec, const u64* len_enc_vec,
                  const u8* data_enc, int coder = 0) {
  const u64 n = nx * ny * nz;
  if (ntot_enc == 0) {
    for (u64 j = 0; j < n; ++j) fld[j] = T(midval);
    return;
  }
  for (u64 j = 0; j < n; ++j) fld[j] = 0;
  int nthreads = (int)std::thread::hardware_concurrency();
  if (const char* e = getenv("WR_NUM_THREADS")) nthreads = atoi(e);
  if (nthreads < 1) nthreads = 1;
  if (nthreads > kLayersMax) nthreads = kLayersMax;
  // Bounded pipeline: workers entropy-decode the (independent) layer
  // streams into a small slot pool; the main thread accumulates them in
  // exact layer order (per-element sequence preserved => bit-exact),
  // freeing slots as it goes. Bounds resident memory to slots*n.
  // All 8 slots by default (same rationale + env knob as the encoder's
  // pool); pooled pages stay mapped across calls.
  int slots = kLayersMax;
  if (const char* e = getenv("WR_CODER_SLOTS")) {
    int v = atoi(e);
    if (v >= 3 && v <= kLayersMax) slots = v;
  }
  std::vector<u8> planebuf = BufPool::get(u64(slots) * n, u64(slots) * n);
  std::vector<u64> offs(nlay + 1, 0);
  for (int l = 0; l < nlay; ++l) offs[l + 1] = offs[l] + len_enc_vec[l];

  std::mutex mu;
  std::condition_variable cv;
  int next_claim = 0;
  int accumulated = 0;
  bool layer_ready[kLayersMax] = {false};

  const int gw = std::min(4, il_width(true));
  auto work = [&]() {
    for (;;) {
      int l, cnt;
      {
        std::lock_guard<std::mutex> lk(mu);
        if (next_claim >= int(nlay)) return;
        l = next_claim;
        cnt = std::min(gw, int(nlay) - l);
        next_claim += cnt;
      }
      if (l + cnt - 1 >= slots) {
        // slot reuse: previous occupants (layers l.. minus slots) must
        // be accumulated before we overwrite their planes
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return accumulated > l + cnt - 1 - slots; });
      }
      // Plane slots come from the pool un-zeroed; a corrupt/truncated
      // stream that decodes fewer than n symbols must not leak stale
      // bytes from prior encodes into the field — zero the tail.
      if (coder == 0 && cnt > 1) {
        const u8* d[4];
        u64 ln[4];
        u8* s[4];
        u64 nd[4];
        for (int k = 0; k < cnt; ++k) {
          d[k] = data_enc + offs[l + k];
          ln[k] = len_enc_vec[l + k];
          s[k] = planebuf.data() + u64((l + k) % slots) * n;
        }
        decode_planes_group(d, ln, cnt, s, n, nd);
        for (int k = 0; k < cnt; ++k)
          if (nd[k] < n) std::memset(s[k] + nd[k], 0, n - nd[k]);
      } else {
        for (int k = 0; k < cnt; ++k) {
          u8* s = planebuf.data() + u64((l + k) % slots) * n;
          u64 nd = std::min(
              decode_plane_c(coder, data_enc + offs[l + k],
                             len_enc_vec[l + k], s, n), n);
          if (nd < n) std::memset(s + nd, 0, n - nd);
        }
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        for (int k = 0; k < cnt; ++k) layer_ready[l + k] = true;
      }
      cv.notify_all();
    }
  };
  std::vector<std::thread> ths;
  int nt = std::min(nthreads, int(nlay));
  for (int t = 0; t < nt; ++t) ths.emplace_back(work);

  for (int l = 0; l < int(nlay); ++l) {
    {
      std::unique_lock<std::mutex> lk(mu);
      cv.wait(lk, [&] { return layer_ready[l]; });
    }
    const u8* syms = planebuf.data() + u64(l % slots) * n;
    const T deps = T(deps_vec[l]);
    const T mnv = T(minval_vec[l]);
    for (u64 j = 0; j < n; ++j) fld[j] = fld[j] + (syms[j] * deps + mnv);
    {
      std::lock_guard<std::mutex> lk(mu);
      accumulated = l + 1;
    }
    cv.notify_all();
  }
  for (auto& th : ths) th.join();
  BufPool::put(std::move(planebuf));
  wavelet3d_inverse(fld, nx, ny, nz, int(wlev));
}

}  // namespace wr

// ----------------------------------------------------------------------------
// C ABI
// ----------------------------------------------------------------------------
extern "C" {

// --- range coder / framing primitives -------------------------------------

// Encode one symbol plane. Returns encoded length; writes at most out_cap
// bytes into out (if the stream would exceed out_cap, returns the required
// length and writes nothing — caller retries with a larger buffer).
uint64_t wrn_encode_plane(const uint8_t* syms, uint64_t n, uint8_t* out,
                          uint64_t out_cap, int coder) {
  std::vector<wr::u8> buf;
  buf.reserve(n / 2 + 4096);
  wr::encode_plane_c(coder, syms, n, buf);
  if (buf.size() <= out_cap) std::memcpy(out, buf.data(), buf.size());
  return buf.size();
}

uint64_t wrn_decode_plane(const uint8_t* data, uint64_t len, uint8_t* syms,
                          uint64_t n, int coder) {
  return wr::decode_plane_c(coder, data, len, syms, n);
}

// Encode many independent planes in parallel with `nthreads` workers.
// lens[i] receives each plane's encoded length; output is written
// back-to-back into `out` in plane order (caller sizes out via out_cap;
// returns total bytes or required size if it didn't fit).
uint64_t wrn_encode_planes_batch(const uint8_t* syms, uint64_t nplanes,
                                 uint64_t n, uint8_t* out, uint64_t out_cap,
                                 uint64_t* lens, int nthreads, int coder) {
  std::vector<std::vector<wr::u8>> bufs(nplanes);
  const uint64_t gw = (uint64_t)wr::il_width(false);
  std::atomic<uint64_t> next{0};
  auto work = [&]() {
    for (;;) {
      uint64_t i = next.fetch_add(gw);
      if (i >= nplanes) return;
      int cnt = (int)std::min<uint64_t>(gw, nplanes - i);
      const wr::u8* ptrs[4];
      for (int k = 0; k < cnt; ++k) {
        ptrs[k] = syms + (i + k) * n;
        bufs[i + k].reserve(n / 2 + 4096);
      }
      if (coder == 0) {
        wr::encode_planes_group(ptrs, cnt, n, &bufs[i]);
      } else {
        for (int k = 0; k < cnt; ++k)
          wr::encode_plane_c(coder, ptrs[k], n, bufs[i + k]);
      }
    }
  };
  int nt = std::max(1, nthreads);
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(work);
  work();
  for (auto& th : threads) th.join();
  uint64_t total = 0;
  for (uint64_t i = 0; i < nplanes; ++i) {
    lens[i] = bufs[i].size();
    total += bufs[i].size();
  }
  if (total <= out_cap) {
    uint64_t off = 0;
    for (uint64_t i = 0; i < nplanes; ++i) {
      std::memcpy(out + off, bufs[i].data(), bufs[i].size());
      off += bufs[i].size();
    }
  }
  return total;
}

void wrn_decode_planes_batch(const uint8_t* data, const uint64_t* lens,
                             uint64_t nplanes, uint8_t* syms, uint64_t n,
                             int nthreads, int coder) {
  std::vector<uint64_t> offs(nplanes);
  uint64_t off = 0;
  for (uint64_t i = 0; i < nplanes; ++i) {
    offs[i] = off;
    off += lens[i];
  }
  const uint64_t gw = (uint64_t)wr::il_width(true);
  std::atomic<uint64_t> next{0};
  auto work = [&]() {
    for (;;) {
      uint64_t i = next.fetch_add(gw);
      if (i >= nplanes) return;
      int cnt = (int)std::min<uint64_t>(gw, nplanes - i);
      const wr::u8* dptrs[4];
      wr::u8* sptrs[4];
      uint64_t glens[4];
      for (int k = 0; k < cnt; ++k) {
        dptrs[k] = data + offs[i + k];
        glens[k] = lens[i + k];
        sptrs[k] = syms + (i + k) * n;
      }
      uint64_t nd[4];
      if (coder == 0) {
        wr::decode_planes_group(dptrs, glens, cnt, sptrs, n, nd);
      } else {
        for (int k = 0; k < cnt; ++k)
          nd[k] = std::min<uint64_t>(
              wr::decode_plane_c(coder, dptrs[k], glens[k], sptrs[k], n),
              n);
      }
      for (int k = 0; k < cnt; ++k)
        if (nd[k] < n) std::memset(sptrs[k] + nd[k], 0, n - nd[k]);
    }
  };
  int nt = std::max(1, nthreads);
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(work);
  work();
  for (auto& th : threads) th.join();
}

// --- wavelet --------------------------------------------------------------

void wrn_wavelet3d(double* fld, uint64_t nx, uint64_t ny, uint64_t nz,
                   int levels) {
  if (levels >= 0)
    wr::wavelet3d_forward(fld, nx, ny, nz, levels);
  else
    wr::wavelet3d_inverse(fld, nx, ny, nz, -levels);
}

void wrn_wavelet3d_f32(float* fld, uint64_t nx, uint64_t ny, uint64_t nz,
                       int levels) {
  if (levels >= 0)
    wr::wavelet3d_forward(fld, nx, ny, nz, levels);
  else
    wr::wavelet3d_inverse(fld, nx, ny, nz, -levels);
}

void wrn_index_p2w(int levels, int n1, int n2, int n3, int i1, int i2, int i3,
                   int* lvl, int* o1, int* o2, int* o3) {
  wr::index_phys_to_wav(levels, n1, n2, n3, i1, i2, i3, lvl, o1, o2, o3);
}

// --- full field codec -----------------------------------------------------

// fld is clobbered (wavelet + residuals), matching the reference contract.
// data_enc must have capacity >= 8 * max(n, 1024) bytes.
// Returns ntot_enc.
uint64_t wrn_encode_field(double* fld, uint64_t nx, uint64_t ny, uint64_t nz,
                          int wtflag, int mx, int my, int mz,
                          const double* cutoffvec, double* tolabs,
                          double* midval, double* halfspanval, uint8_t* wlev,
                          uint8_t* nlay, double* deps_vec, double* minval_vec,
                          uint64_t* len_enc_vec, uint8_t* data_enc,
                          int coder) {
  wr::EncodeOut eo;
  wr::encode_field(fld, nx, ny, nz, wtflag, mx, my, mz, cutoffvec, &eo,
                   data_enc, coder);
  *tolabs = eo.tolabs;
  *midval = eo.midval;
  *halfspanval = eo.halfspanval;
  *wlev = eo.wlev;
  *nlay = eo.nlay;
  std::memcpy(deps_vec, eo.deps_vec, sizeof(eo.deps_vec));
  std::memcpy(minval_vec, eo.minval_vec, sizeof(eo.minval_vec));
  std::memcpy(len_enc_vec, eo.len_enc_vec, sizeof(eo.len_enc_vec));
  return eo.ntot_enc;
}

// Non-clobbering variant: `fld` is read-only (no defensive copy needed
// on the Python side; the first wavelet sweep lifts into an internal
// scratch).
uint64_t wrn_encode_field_nc(const double* fld, uint64_t nx, uint64_t ny,
                             uint64_t nz, int wtflag, int mx, int my,
                             int mz, const double* cutoffvec,
                             double* tolabs, double* midval,
                             double* halfspanval, uint8_t* wlev,
                             uint8_t* nlay, double* deps_vec,
                             double* minval_vec, uint64_t* len_enc_vec,
                             uint8_t* data_enc, int coder) {
  wr::EncodeOut eo;
  wr::encode_field_nc(fld, nx, ny, nz, wtflag, mx, my, mz, cutoffvec, &eo,
                      data_enc, coder);
  *tolabs = eo.tolabs;
  *midval = eo.midval;
  *halfspanval = eo.halfspanval;
  *wlev = eo.wlev;
  *nlay = eo.nlay;
  std::memcpy(deps_vec, eo.deps_vec, sizeof(eo.deps_vec));
  std::memcpy(minval_vec, eo.minval_vec, sizeof(eo.minval_vec));
  std::memcpy(len_enc_vec, eo.len_enc_vec, sizeof(eo.len_enc_vec));
  return eo.ntot_enc;
}

void wrn_decode_field(double* fld, uint64_t nx, uint64_t ny, uint64_t nz,
                      double midval, uint8_t wlev, uint8_t nlay,
                      uint64_t ntot_enc, const double* deps_vec,
                      const double* minval_vec, const uint64_t* len_enc_vec,
                      const uint8_t* data_enc, int coder) {
  wr::decode_field(fld, nx, ny, nz, midval, wlev, nlay, ntot_enc, deps_vec,
                   minval_vec, len_enc_vec, data_enc, coder);
}

// --- f32-native pipeline (opt-in; half the host memory bandwidth of the
// widened path; stream format identical, metadata stored as f64; NOT the
// bit-exact reference path) -------------------------------------------------

uint64_t wrn_encode_field_f32(float* fld, uint64_t nx, uint64_t ny,
                              uint64_t nz, int wtflag, int mx, int my,
                              int mz, const double* cutoffvec,
                              double* tolabs, double* midval,
                              double* halfspanval, uint8_t* wlev,
                              uint8_t* nlay, double* deps_vec,
                              double* minval_vec, uint64_t* len_enc_vec,
                              uint8_t* data_enc, int coder) {
  wr::EncodeOut eo;
  wr::encode_field(fld, nx, ny, nz, wtflag, mx, my, mz, cutoffvec, &eo,
                   data_enc, coder);
  *tolabs = eo.tolabs;
  *midval = eo.midval;
  *halfspanval = eo.halfspanval;
  *wlev = eo.wlev;
  *nlay = eo.nlay;
  std::memcpy(deps_vec, eo.deps_vec, sizeof(eo.deps_vec));
  std::memcpy(minval_vec, eo.minval_vec, sizeof(eo.minval_vec));
  std::memcpy(len_enc_vec, eo.len_enc_vec, sizeof(eo.len_enc_vec));
  return eo.ntot_enc;
}

void wrn_decode_field_f32(float* fld, uint64_t nx, uint64_t ny, uint64_t nz,
                          double midval, uint8_t wlev, uint8_t nlay,
                          uint64_t ntot_enc, const double* deps_vec,
                          const double* minval_vec,
                          const uint64_t* len_enc_vec,
                          const uint8_t* data_enc, int coder) {
  wr::decode_field(fld, nx, ny, nz, midval, wlev, nlay, ntot_enc, deps_vec,
                   minval_vec, len_enc_vec, data_enc, coder);
}

// --- misc -----------------------------------------------------------------

// MSSG mask separation (contract: mssg_enc.cpp:323-348): pad masked
// elements (< thresh) with the left-to-right sequential mean of unmasked
// elements and emit the mask field {0, minval}. The sequential sum order
// matters for bit-exactness. Returns the pad value.
double wrn_mask_separate(double* fld, double* mask, uint64_t n,
                         double thresh, double minval) {
  double acc = 0;
  int64_t cnt = 0;
  for (uint64_t j = 0; j < n; ++j) {
    if (fld[j] >= thresh) {
      acc += fld[j];
      ++cnt;
    }
  }
  double pad = acc / double(cnt);
  for (uint64_t j = 0; j < n; ++j) {
    if (fld[j] < thresh) {
      fld[j] = pad;
      mask[j] = minval;
    } else {
      mask[j] = 0;
    }
  }
  return pad;
}

int wrn_version() { return 10000; }  // waverange_tpu native ABI version

// Release every buffer held by the process-wide pool (callers that just
// finished a large batch and want the ~GBs of recycled pages back).
void wrn_pool_trim() { wr::BufPool::trim(); }

// Pre-fault the pool buffers a size-n encode/decode will use, so the
// first timed call runs at steady state (first-touch faults cost
// ~27 us/page on virtualized hosts — ~60 s of kernel time for the
// ~34 GB working set of a 1024^3 encode). Touches the same
// allocations encode_field_nc/encode_layers/decode_field request.
void wrn_pool_warm(uint64_t n, int slots) {
  using wr::u64;
  if (slots < 1 || slots > (int)wr::kLayersMax) slots = wr::kLayersMax;
  std::vector<wr::u8> bufs[2 + wr::kLayersMax];
  bufs[0] = wr::BufPool::get(u64(slots) * n, u64(slots) * n);  // planes
  bufs[1] = wr::BufPool::get(n * 8, n * 8);                    // scratch
  const u64 scap = 2 * n + (n / wr::kBlockSymbols + 2) * 1100 + 64;
  for (int l = 0; l < (int)wr::kLayersMax; ++l)
    bufs[2 + l] = wr::BufPool::get(scap, scap);
  for (auto& b : bufs)
    if (!b.empty()) std::memset(b.data(), 0, b.size());
  for (auto& b : bufs) wr::BufPool::put(std::move(b));
}

// Exactness self-test for MagicDiv over the coder's divisor domain
// (1..2^17) with boundary-adversarial dividends. Returns 0 on success.
int wrn_selftest_magicdiv() {
  for (uint32_t d = 1; d <= (1u << 17); ++d) {
    wr::MagicDiv md = wr::MagicDiv::make(d);
    uint64_t probes[8] = {1, d - 1, d, d + 1, 0x7fffffffu, 0x80000000u,
                          0xffffffffu, (0xffffffffu / d) * (uint64_t)d};
    for (uint64_t p : probes) {
      uint32_t n = (uint32_t)p;
      if (md.div(n) != n / d) return 1;
    }
    // stride through the full range
    for (uint64_t n = 0; n <= 0xffffffffull; n += 0x10000019ull) {
      uint32_t v = (uint32_t)n;
      if (md.div(v) != v / d) return 1;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Drop-in library ABI compatible with the reference libwaverange
// (wrappers.h:53-119): C entry points encoding_wrap/decoding_wrap/setup_wr
// and the Fortran shims. Existing C/C++/Fortran users of the reference
// library can relink against libwaverange.so built from this file.
// ---------------------------------------------------------------------------

void encoding_wrap(int nx, int ny, int nz, double* fld_1d, int wtflag,
                   int mx, int my, int mz, double* cutoffvec, double& tolabs,
                   double& midval, double& halfspanval, unsigned char& wlev,
                   unsigned char& nlay, unsigned long& ntot_enc,
                   double* deps_vec, double* minval_vec,
                   unsigned long* len_enc_vec, unsigned char* data_enc) {
  wr::EncodeOut eo;
  wr::encode_field(fld_1d, nx, ny, nz, wtflag, mx, my, mz, cutoffvec, &eo,
                   data_enc);
  tolabs = eo.tolabs;
  midval = eo.midval;
  halfspanval = eo.halfspanval;
  wlev = eo.wlev;
  nlay = eo.nlay;
  ntot_enc = eo.ntot_enc;
  for (int j = 0; j < wr::kLayersMax; ++j) {
    deps_vec[j] = eo.deps_vec[j];
    minval_vec[j] = eo.minval_vec[j];
    len_enc_vec[j] = eo.len_enc_vec[j];
  }
}

void decoding_wrap(int nx, int ny, int nz, double* fld_1d, double& tolabs,
                   double& midval, double& halfspanval, unsigned char& wlev,
                   unsigned char& nlay, unsigned long& ntot_enc,
                   double* deps_vec, double* minval_vec,
                   unsigned long* len_enc_vec, unsigned char* data_enc) {
  (void)tolabs;
  (void)halfspanval;
  std::vector<uint64_t> lens(wr::kLayersMax);
  for (int j = 0; j < wr::kLayersMax; ++j) lens[j] = len_enc_vec[j];
  wr::decode_field(fld_1d, nx, ny, nz, midval, wlev, nlay, ntot_enc,
                   deps_vec, minval_vec, lens.data(), data_enc);
}

void setup_wr(int nx, int ny, int nz, unsigned char& nlaymax,
              unsigned long& ntot_enc_max) {
  nlaymax = wr::kLayersMax;
  unsigned long ntot =
      (unsigned long)nx * (unsigned long)ny * (unsigned long)nz;
  ntot_enc_max = (unsigned long)wr::kLayersMax *
                 (ntot < 1024ul ? 1024ul : ntot);
}

void encoding_wrap_f(int* nx, int* ny, int* nz, double* fld, int* wtflag,
                     double* tolrel, double& tolabs, double& midval,
                     double& halfspanval, unsigned char& wlev,
                     unsigned char& nlay, long& ntot_enc_sg,
                     double* deps_vec, double* minval_vec,
                     long* len_enc_vec_sg, unsigned char* data_enc) {
  unsigned long ntot_enc;
  unsigned long len_enc_vec[wr::kLayersMax];
  double cutoff[1] = {*tolrel};
  encoding_wrap(*nx, *ny, *nz, fld, *wtflag, 1, 1, 1, cutoff, tolabs,
                midval, halfspanval, wlev, nlay, ntot_enc, deps_vec,
                minval_vec, len_enc_vec, data_enc);
  ntot_enc_sg = (long)ntot_enc;
  for (int j = 0; j < wr::kLayersMax; ++j)
    len_enc_vec_sg[j] = (long)len_enc_vec[j];
}

void decoding_wrap_f(int* nx, int* ny, int* nz, double* fld, double& midval,
                     double& halfspanval, unsigned char& wlev,
                     unsigned char& nlay, long& ntot_enc_sg,
                     double* deps_vec, double* minval_vec,
                     long* len_enc_vec_sg, unsigned char* data_enc) {
  double tolabs = 0;
  unsigned long ntot_enc = (unsigned long)ntot_enc_sg;
  unsigned long len_enc_vec[wr::kLayersMax];
  for (int j = 0; j < wr::kLayersMax; ++j)
    len_enc_vec[j] = (unsigned long)len_enc_vec_sg[j];
  decoding_wrap(*nx, *ny, *nz, fld, tolabs, midval, halfspanval, wlev,
                nlay, ntot_enc, deps_vec, minval_vec, len_enc_vec,
                data_enc);
}

void setup_wr_f(int* nx, int* ny, int* nz, int& nlaymax,
                long& ntot_enc_max) {
  nlaymax = wr::kLayersMax;
  long ntot = (long)(*nx) * (long)(*ny) * (long)(*nz);
  ntot_enc_max = (long)wr::kLayersMax * (ntot < 1024l ? 1024l : ntot);
}
}
