// Format-v2 interleaved-rANS entropy stage (kernels E, F, G, H and I).
//
// Byte-format oracle: turbo::encode_plane_t / decode_plane_t in
// waverange_tpu/native/src/wr_native.cc. The planes are (L, n) u8, row
// major; each plane is cut into blocks of kTBlock symbols (the last one
// shorter when n % kTBlock != 0), numbered b = plane*nb + block, and every
// block is coded on its own with its own model and 8 interleaved lane
// states (symbol i of a block on lane i % 8).
//
// E `rans_hist_kernel` replaces hist_blocks (waverange_tpu/ops/
//   rans_kernels.py:112) and the XLA normalization and cum glue around it
//   (rans.py:392-399). One CUDA block of 8 warps per rANS block counts the
//   symbols straight from the planes into shared-memory bins (no blockify
//   copy, no padding in bin 0) and writes freq | cum<<16 per symbol.
//   Redesigned for Hopper: an ablation of the first design (PERF.md) put
//   its time in the one-byte loads (one in flight per thread) and in thread
//   0's serial normalization, and none in the same-address atomics of
//   equal symbols (constant planes counted at the rate of the loads). So:
//   - the block's bytes are read as 16-byte pieces, kHistUnroll in flight
//     per thread; the bytes before its first 16-byte boundary and after
//     its last are counted one by one, so any row start works and no byte
//     outside the block is read (rans.py `hist_reads` mirrors the cut);
//   - the normalization keeps the order of wr_native.cc:563-589, each of
//     its serial scans a block reduction: the first index among the maxima
//     is the maximum of the key (value << 8) | (255 - bin), the steal loop
//     repeats it while the sum is above 16384, and cum is a shuffle scan
//     (rans.py `normalize_keyed` mirrors it).
//   Per-warp bins and one atomic for a 16-byte run of one symbol were
//   measured and gained nothing. What bounds it now: the read (16-byte
//   loads alone run at the card's `copy_` rate) and, on scattered
//   symbols, the bank conflicts of the shared-memory atomics.
// F `rans_chain_kernel` replaces pregather (rans_kernels.py:163) and chain
//   (rans_kernels.py:277). Redesigned for Hopper: its step is the C++
//   encoder's (emit when x >= f<<18, then x = (x/f)<<14 + x%f + cum), and
//   an ablation of the first design (PERF.md) put the time in the global
//   symbol load on the chain, the scattered 2-byte slab stores and the
//   u32 division, in that order. So:
//   - the block's symbols are staged into a 512-byte shared ring, 128
//     bytes (16 groups) a round, by cp.async with 16-byte pieces from the
//     16-byte aligned address below the block (block starts are aligned
//     only when n % 16 == 0), one round ahead, walking from the block's
//     end; the chain reads them with shared loads;
//   - the division is a multiply by the reciprocal of the symbol's
//     frequency: q = (x + umulhi(x, m)) >> l with l = ceil(log2 f) and
//     m = ceil(2^(32+l) / f) - 2^32, exact for every x < 2^32 and
//     1 <= f <= 16384 (rans.py `div_magic` mirrors and tests it). The
//     prologue turns the block's freq|cum<<16 model into 8-byte entries
//     {m, cum | (16384 - f)<<14 | l<<28}, and x' = x + cum + q*(16384 - f);
//   - a ballot over the block's 8 lanes ranks the emitted words, which go
//     to a 256-word shared ring at their slab position; after each round
//     the complete 16-byte pieces are stored to the slab with 16-byte
//     stores.
//   All 32 lanes of a warp run its longest block and ballot with the full
//   mask: with 8-lane masks the four blocks of a warp ran apart and the
//   kernel took twice as long (PERF.md). Shared memory is 3 KB per
//   rANS block (2 KB of entries): all 16,384 blocks at once would need
//   48 MB, the card has 30 MB, so the segments run in two waves of 64 per
//   SM (4 CUDA blocks of 48 KB). ptxas (sm_90a): 86 registers, 49,152
//   bytes of shared memory, no spills. What bounds it now: instruction
//   issue and the latency of the state chain at 4 warps per scheduler
//   (about 40 instructions a step, none waiting on device memory).
// G `rans_compact_kernel` replaces compact (rans_kernels.py:417): per
//   modeled block, the 16 LE state half-words and then the block's kept
//   words, copied from the tail of its slab to a host-computed offset of
//   one u16 buffer, so a single D2H copy brings back every payload. Bound
//   by bytes.
// H `rans_decode_kernel` replaces dchain (rans_kernels.py:700) and the
//   compose glue (rans.py:808-913). Redesigned for Hopper: the ablation
//   put the time in the 8-probe binary search and the refill from global
//   memory, and half the blocks of a near-lossless field are raw, which
//   the first design copied a byte per lane-step. Per modeled block:
//   - the cum | (cum+freq)<<16 table and a 1,024-bucket table (1 KB: the
//     symbol that owns the first slot of each 16-slot bucket) sit in
//     shared memory; a slot resolves to lut[slot >> 4], then forward
//     while the symbol's range ends at or below the slot. The owner's next
//     entry is loaded beside it, so the common one step forward costs no
//     second dependent load. A full 16,384-entry table (16 KB a block)
//     would leave room for 13 blocks per SM; coarser buckets (128 of 128
//     slots) made the scans long enough to double the time (PERF.md);
//   - the payload (it starts at an odd offset after the 517-byte header,
//     so words are composed from two bytes, LE, as wr_native.cc:860) is
//     staged into a 512-byte shared ring by cp.async in 128-byte chunks
//     from the 16-byte aligned address below it, two chunks ahead of the
//     read position (a round of 8 groups reads at most 128 bytes); the
//     guard widx < wlen equals the C++ `w + 1 < wend` (wr_native.cc:859);
//   - decoded symbols go to a 256-byte shared ring and leave in aligned
//     16-byte stores after every other round.
//   Constant and raw blocks are filled and copied with 16-byte stores
//   (raw sources are read as aligned words and funnel-shifted). The warp
//   runs its longest modeled block with full-mask ballots, as F; other
//   lanes step through a one-symbol model, and every lane loads its
//   refill word, so that the step has no branch but the rare scan. ptxas
//   (sm_90a): 59 registers, 45,120 bytes of shared memory (4 CUDA blocks
//   per SM), no spills. What bounds it now: the dependent chain of each
//   step (bucket load, table load, ballot, refill load); the modeled
//   blocks, 6,910 of 16,384 at 1e-16, give an SM only about 13 warps.
// I `rans_frame_kernel` has no TPU counterpart: it replaces the host's
//   framing (waverange_tpu/ops/rans.py `_assemble_blocks`, this package's
//   `rans.frame`) and the gather of the raw blocks' bytes. One CUDA block
//   per rANS block writes the block's whole frame at the byte offset the
//   host computed from the layout sync: the tag; for a constant block its
//   symbol (the block's first); for a raw block its bs bytes, straight
//   from the planes; for a modeled block the 256 LE u16 frequencies of
//   E's model, the LE u32 payload length and G's payload bytes. The L
//   streams thus leave the card back to back in one buffer, one copy.
//   The frames start at any byte (the 1-byte tags shift the parity), so
//   the copies store 16 bytes at a time between the destination's aligned
//   ends, each piece from aligned 4-byte loads of the source,
//   funnel-shifted, and bytes outside them one by one. Bound by bytes:
//   the stream is written once and read about once.
//
// All arithmetic is u32 with C++ wrap-around (f << 18 wraps to 0 for
// f = 16384: constant blocks, whose chain output is never used).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kProbBits = 14;
constexpr uint32_t kProbScale = 1u << kProbBits;
constexpr uint32_t kRansL = 1u << 16;
constexpr long long kTBlock = 1 << 16;
constexpr int kLanes = 8;
// A block is modeled only while 2*(nwords + 16) + 516 < bs <= 65536, so a
// modeled block's words always fit; a raw block's slab may be truncated.
constexpr int kSlabWords = 1 << 15;
constexpr int kHistThreads = 256;  // thread t owns symbol bin t
constexpr int kHistWarps = kHistThreads / 32;
constexpr int kHistUnroll = 4;  // E's 16-byte loads in flight per thread
constexpr int kChainThreads = 128;
constexpr int kSegs = kChainThreads / kLanes;  // rANS blocks per CUDA block
constexpr int kCompactThreads = 256;
constexpr int kFrameThreads = 256;  // thread t writes frequency t
constexpr int kHeader = 516;    // u16 freqs[256] + u32 payload_len
constexpr int kStateBytes = 32;  // 8 LE u32 lane states
// F's symbols and H's payload are staged in chunks of kChunk bytes (a
// 16-byte piece per lane), in a ring of 4 chunks per rANS block.
constexpr int kChunk = 16 * kLanes;
constexpr int kRing = 4 * kChunk;
// F: a round of kRound groups reads one chunk of symbols; the words go
// to a ring of kWordRing u16.
constexpr int kRound = kChunk / kLanes;
constexpr int kWordRing = 256;  // > kRound * 8 + 7 words pending at most
// H: a round of kDRound groups reads at most kDRound * 8 words, a chunk.
constexpr int kDRound = kChunk / (2 * kLanes);
constexpr int kOutRing = 256;  // > 2 * kDRound * 8 + 15 bytes pending
constexpr int kBucketBits = 10;  // 1024 buckets of 16 slots
constexpr int kBuckets = 1 << kBucketBits;
constexpr int kBucketShift = kProbBits - kBucketBits;

struct Block {
  long long start;  // flat position of the block's first symbol
  int bs;           // symbols in the block
};

__device__ __forceinline__ Block block_of(long long b, long long n,
                                          long long nb) {
  const long long ib = b % nb;
  const long long rem = n - ib * kTBlock;
  return {(b / nb) * n + ib * kTBlock, int(rem < kTBlock ? rem : kTBlock)};
}

// The 8 threads of one rANS block: lanes 0..7 of an aligned 8-thread
// segment of the warp; `mask` and `below` are its warp bits and those of
// its lanes below this one.
struct Segment {
  int seg, lane;
  unsigned mask, below;
  __device__ Segment() {
    seg = threadIdx.x / kLanes;
    lane = threadIdx.x % kLanes;
    const unsigned shift = (threadIdx.x & 31u) & ~7u;
    mask = 0xFFu << shift;
    below = ((1u << lane) - 1u) << shift;
  }
};

// 16 bytes from global `src` (16-byte aligned) to shared `dst`, of which
// only the first `bytes` (1..16) are read; the rest are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = unsigned(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Lane `lane` stages piece `lane` of chunk j (16 bytes at base + j*128 +
// 16*lane, base 16-byte aligned) into its ring; nothing at or past `end`
// is read.
__device__ __forceinline__ void stage_chunk(uint8_t* ring,
                                            const uint8_t* base,
                                            const uint8_t* end, int j,
                                            int lane) {
  const int p = j * kChunk + 16 * lane;
  const long long left = end - (base + p);
  if (left > 0)
    cp_async16(ring + (p & (kRing - 1)), base + p,
               left < 16 ? int(left) : 16);
}

__device__ __forceinline__ const uint8_t* align16(const uint8_t* p) {
  return reinterpret_cast<const uint8_t*>(uintptr_t(p) & ~uintptr_t(15));
}

// The segment fills dst[0:len) with v: 16-byte stores between the aligned
// ends, byte stores outside them.
__device__ void fill_seg(uint8_t* dst, int len, uint8_t v,
                         const Segment& sg) {
  const int head = min(len, int((16 - (uintptr_t(dst) & 15)) & 15));
  const int body = head + ((len - head) & ~15);
  const uint32_t w = v * 0x01010101u;
  for (int i = sg.lane; i < head; i += kLanes) dst[i] = v;
  for (int i = head + 16 * sg.lane; i < body; i += 16 * kLanes)
    *reinterpret_cast<uint4*>(dst + i) = make_uint4(w, w, w, w);
  for (int i = body + sg.lane; i < len; i += kLanes) dst[i] = v;
}

// The segment copies src[0:len) to dst[0:len) with 16-byte stores between
// dst's aligned ends; each 16 bytes come from 4-5 aligned 4-byte loads,
// funnel-shifted. No byte at or past `src_end` is read.
__device__ void copy_seg(uint8_t* dst, const uint8_t* src, int len,
                         const uint8_t* src_end, const Segment& sg) {
  const int head = min(len, int((16 - (uintptr_t(dst) & 15)) & 15));
  // a piece at i reads up to src + i + 20 (the 5th word)
  const long long avail = (src_end - src) - 20;
  const int pieces = int(min((long long)(len - head) / 16,
                             avail >= head ? (avail - head) / 16 + 1 : 0));
  const int body = head + 16 * pieces;
  for (int i = sg.lane; i < head; i += kLanes) dst[i] = src[i];
  for (int i = head + 16 * sg.lane; i < body; i += 16 * kLanes) {
    const uintptr_t a = uintptr_t(src + i);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
    const unsigned r = unsigned(a & 3) * 8;
    const uint32_t w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3];
    const uint32_t w4 = r ? w[4] : 0u;
    *reinterpret_cast<uint4*>(dst + i) = make_uint4(
        __funnelshift_r(w0, w1, r), __funnelshift_r(w1, w2, r),
        __funnelshift_r(w2, w3, r), __funnelshift_r(w3, w4, r));
  }
  for (int i = body + sg.lane; i < len; i += kLanes) dst[i] = src[i];
}

// The 8-warp block's sum and maximum of one u32 per thread (`v` summed,
// `k` maximized): each warp reduces its 32, lane 0 leaves the result in
// `buf` (2 * kHistWarps words), and every thread reads all of them after
// the barrier. A barrier separates a call's reads from the writes of the
// call after next, so consecutive calls alternate between two buffers.
__device__ __forceinline__ uint2 block_sum_max(uint32_t v, uint32_t k,
                                               uint32_t* buf) {
  v = __reduce_add_sync(0xFFFFFFFFu, v);
  k = __reduce_max_sync(0xFFFFFFFFu, k);
  if (threadIdx.x % 32 == 0) {
    buf[threadIdx.x / 32] = v;
    buf[kHistWarps + threadIdx.x / 32] = k;
  }
  __syncthreads();
  uint2 r = make_uint2(0u, 0u);
  for (int w = 0; w < kHistWarps; ++w) {
    r.x += buf[w];
    r.y = max(r.y, buf[kHistWarps + w]);
  }
  return r;
}

__device__ __forceinline__ void count_word(uint32_t* cnt, uint32_t w) {
  atomicAdd(&cnt[w & 0xFFu], 1u);
  atomicAdd(&cnt[(w >> 8) & 0xFFu], 1u);
  atomicAdd(&cnt[(w >> 16) & 0xFFu], 1u);
  atomicAdd(&cnt[w >> 24], 1u);
}

__global__ void __launch_bounds__(kHistThreads)
    rans_hist_kernel(const uint8_t* __restrict__ planes, long long n,
                     long long nb, uint32_t* __restrict__ etab,
                     int32_t* __restrict__ nsym) {
  __shared__ uint32_t cnt[256];
  __shared__ uint32_t red[2][2 * kHistWarps];
  const long long b = blockIdx.x;
  const Block blk = block_of(b, n, nb);
  const int t = threadIdx.x;
  cnt[t] = 0;
  __syncthreads();
  // The bytes before the block's first 16-byte boundary (head) and after
  // its last (tail) are counted one by one, the pieces between them from
  // 16-byte loads, kHistUnroll in flight per thread: no byte outside the
  // block is read.
  const uint8_t* p = planes + blk.start;
  const int head = min(blk.bs, int((16 - (uintptr_t(p) & 15)) & 15));
  const int pieces = (blk.bs - head) / 16;
  const int tail = head + 16 * pieces;
  if (t < head) atomicAdd(&cnt[p[t]], 1u);
  if (tail + t < blk.bs) atomicAdd(&cnt[p[tail + t]], 1u);
  const uint4* q = reinterpret_cast<const uint4*>(p + head);
  for (int k0 = t; k0 < pieces; k0 += kHistThreads * kHistUnroll) {
    uint4 v[kHistUnroll];
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u)
      if (k0 + u * kHistThreads < pieces)
        v[u] = __ldg(q + k0 + u * kHistThreads);
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      if (k0 + u * kHistThreads >= pieces) break;
      count_word(cnt, v[u].x);
      count_word(cnt, v[u].y);
      count_word(cnt, v[u].z);
      count_word(cnt, v[u].w);
    }
  }
  __syncthreads();
  // Thread t owns bin t. Normalization in the order of wr_native.cc:563-589,
  // with each of its serial scans a block reduction: "the first index among
  // the maxima" is the maximum of the key (value << 8) | (255 - t).
  const uint32_t c = cnt[t];
  // c * 16384 <= 2^30: exact in u32
  uint32_t f = c ? max((c * kProbScale) / uint32_t(blk.bs), 1u) : 0u;
  const uint2 sk = block_sum_max(f, c ? (c << 8) | (255 - t) : 0u, red[0]);
  uint32_t sum = sk.x;
  if (sum < kProbScale) {  // the deficit goes to the first max count
    if (t == 255 - int(sk.y & 255)) f += kProbScale - sum;
  }
  int r = 1;
  while (sum > kProbScale) {  // steal from the first max frequency > 1
    const uint32_t m =
        block_sum_max(0u, f > 1 ? (f << 8) | (255 - t) : 0u, red[r++ & 1]).y;
    const uint32_t take = min((m >> 8) - 1u, sum - kProbScale);
    if (t == 255 - int(m & 255)) f -= take;
    sum -= take;
  }
  // cum: exclusive scan, by warp (shuffles) and over the warps' totals
  const int lane = t % 32;
  uint32_t incl = f;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += y;
  }
  uint32_t* tot = red[r & 1];
  if (lane == 31) tot[t / 32] = incl;
  const int present = __syncthreads_count(c != 0);
  uint32_t cum = incl - f;
  for (int w = 0; w < t / 32; ++w) cum += tot[w];
  etab[b * 256 + t] = f | (cum << 16);
  if (t == 0) nsym[b] = present;
}

__global__ void __launch_bounds__(kChainThreads)
    rans_chain_kernel(const uint8_t* __restrict__ planes, long long n,
                      long long nb, long long nblocks,
                      const uint32_t* __restrict__ etab,
                      uint16_t* __restrict__ slab, uint32_t* __restrict__ x_fin,
                      int32_t* __restrict__ nwords) {
  __shared__ uint2 tab[kSegs][256];  // {m, cum | (16384-f)<<14 | l<<28}
  __shared__ __align__(16) uint8_t syms[kSegs][kRing];
  __shared__ __align__(16) uint16_t words[kSegs][kWordRing];
  const Segment sg;
  const long long b = (long long)blockIdx.x * kSegs + sg.seg;
  const bool live = b < nblocks;  // idle segments keep the warp whole
  const Block blk = live ? block_of(b, n, nb) : Block{0, 0};
  for (int i = sg.lane; live && i < 256; i += kLanes) {
    const uint32_t e = etab[b * 256 + i];
    const uint32_t f = e & 0xFFFFu;
    uint2 t = make_uint2(0u, 0u);
    if (f) {  // absent symbols are never looked up
      const uint32_t l = 32 - __clz(f - 1);  // ceil(log2 f), 0 for f = 1
      const uint64_t m = ((1ull << (32 + l)) + f - 1) / f - (1ull << 32);
      t = make_uint2(uint32_t(m), (e >> 16) | ((kProbScale - f) << 14) |
                                      (l << 28));
    }
    tab[sg.seg][i] = t;
  }
  const uint8_t* p = planes + blk.start;
  const uint8_t* base = align16(p);
  const uint8_t* end = live ? planes + (nblocks / nb) * n : base;
  const int o = int(p - base);  // symbol i sits at ring byte (o + i) & 511
  uint8_t* ring = syms[sg.seg];
  // All 32 lanes run the warp's longest block (the others' extra steps
  // are inactive), so that the ballots and barriers take the full warp:
  // with 8-lane masks the warp's four blocks run apart and the kernel
  // took twice as long (PERF.md).
  const int J = __reduce_max_sync(
      0xFFFFFFFFu, (blk.bs + kRound * kLanes - 1) / (kRound * kLanes));
  if (J > 0) {  // round j reads chunks j and j + 1
    stage_chunk(ring, base, end, J, sg.lane);
    cp_commit();
    stage_chunk(ring, base, end, J - 1, sg.lane);
    cp_commit();
  }
  uint16_t* w = slab + b * kSlabWords;
  uint16_t* wring = words[sg.seg];
  const uint2* tb = tab[sg.seg];
  uint32_t x = kRansL;
  int wpos = kSlabWords;  // slab words [wpos, kSlabWords) hold the stream
  int flushed = kSlabWords;  // slab words [flushed, kSlabWords) are stored
  for (int j = J - 1; j >= 0; --j) {
    if (j > 0) stage_chunk(ring, base, end, j - 1, sg.lane);
    cp_commit();
    cp_wait<1>();  // chunks j and j + 1 have landed
    __syncwarp();
    const int i0 = j * kRound * kLanes + sg.lane;
    // the entry of the next step is loaded one step ahead
    uint2 next = tb[ring[(o + i0 + (kRound - 1) * kLanes) & (kRing - 1)]];
#pragma unroll
    for (int t = kRound - 1; t >= 0; --t) {
      const int i = i0 + t * kLanes;
      const uint2 e = next;
      if (t) next = tb[ring[(o + i - kLanes) & (kRing - 1)]];
      const bool active = i < blk.bs;
      const uint32_t c = e.y & 0x3FFFu, cmpl = (e.y >> 14) & 0x3FFFu;
      // f << 18 = (16384 - cmpl) << 18 mod 2^32, 0 for f = 16384
      const bool emit = active && x >= cmpl * (0u - (1u << 18));
      const unsigned m = __ballot_sync(0xFFFFFFFFu, emit) & sg.mask;
      const int cnt = __popc(m);
      // words that would land before the slab (raw blocks only) wrap in
      // the ring and are never stored
      const int k = (wpos - cnt + __popc(m & sg.below)) & (kWordRing - 1);
      if (emit) wring[k] = uint16_t(x);
      wpos -= cnt;
      if (emit) x >>= 16;
      if (active) {
        const uint32_t q =
            uint32_t((uint64_t(x) + __umulhi(x, e.x)) >> (e.y >> 28));
        x += c + q * cmpl;  // (q << 14) + (x - q*f) + c
      }
    }
    __syncwarp();
    // store the complete 16-byte pieces of the slab
    const int lo = j ? max((wpos + 7) & ~7, 0) : max(wpos & ~7, 0);
    for (int q = lo + 8 * sg.lane; q < flushed; q += 8 * kLanes)
      *reinterpret_cast<uint4*>(w + q) =
          *reinterpret_cast<const uint4*>(wring + (q & (kWordRing - 1)));
    flushed = lo;
    __syncwarp();
  }
  if (!live) return;
  x_fin[b * kLanes + sg.lane] = x;
  if (sg.lane == 0) nwords[b] = kSlabWords - wpos;
}

__global__ void __launch_bounds__(kCompactThreads)
    rans_compact_kernel(const uint32_t* __restrict__ x_fin,
                        const uint16_t* __restrict__ slab,
                        const int32_t* __restrict__ nwords,
                        const long long* __restrict__ dest,
                        uint16_t* __restrict__ out) {
  const long long b = blockIdx.x;
  const long long o = dest[b];
  const int nw = nwords[b];
  if (o < 0 || nw < 0 || nw > kSlabWords) return;
  const int t = threadIdx.x;
  if (t < 2 * kLanes) {
    const uint32_t x = x_fin[b * kLanes + t / 2];
    out[o + t] = uint16_t((t & 1) ? x >> 16 : x);
  }
  const uint16_t* src = slab + b * kSlabWords + (kSlabWords - nw);
  for (int i = t; i < nw; i += kCompactThreads) out[o + 2 * kLanes + i] = src[i];
}

__global__ void __launch_bounds__(kChainThreads)
    rans_decode_kernel(const uint8_t* __restrict__ data, long long data_len,
                       const long long* __restrict__ table, long long n,
                       long long nb, long long nblocks,
                       uint8_t* __restrict__ out) {
  __shared__ uint32_t tab[kSegs][257];  // cum | (cum + freq)<<16
  __shared__ __align__(16) uint8_t lut[kSegs][kBuckets];  // owner of 16k
  __shared__ __align__(16) uint8_t pay[kSegs][kRing];
  __shared__ __align__(16) uint8_t obuf[kSegs][kOutRing];
  const Segment sg;
  const long long b = (long long)blockIdx.x * kSegs + sg.seg;
  const bool live = b < nblocks;  // idle segments keep the warp whole
  const long long tag = live ? table[3 * b] : -1;
  const long long off = live ? table[3 * b + 1] : 0;
  const long long plen = live ? table[3 * b + 2] : 0;
  const Block blk = live ? block_of(b, n, nb) : Block{0, 0};
  uint8_t* o = out + blk.start;
  const uint8_t* data_end = data + data_len;
  if (tag == 2)  // constant block: the symbol at off
    fill_seg(o, blk.bs, data[off], sg);
  if (tag == 1)  // raw block: bs verbatim bytes at off
    copy_seg(o, data + off, blk.bs, data_end, sg);
  // modeled block: u16 LE freqs at off, then the payload after the header
  const bool modeled = tag == 0;
  const int bs = modeled ? blk.bs : 0;
  // all 32 lanes run the warp's longest modeled block, as in F
  const int G = __reduce_max_sync(0xFFFFFFFFu, (bs + kLanes - 1) / kLanes);
  if (!G) return;
  const uint8_t* wbytes = data + off + kHeader + kStateBytes;
  const uint8_t* wbase = align16(wbytes);
  const uint8_t* wend = modeled ? data_end : wbase;
  const int wo = int(wbytes - wbase);  // word k at ring byte wo + 2k
  uint8_t* ring = pay[sg.seg];
  for (int j = 0; j < 4; ++j) {  // chunks 0-3; chunk k + 3 enters as the
    stage_chunk(ring, wbase, wend, j, sg.lane);  // read position reaches
    cp_commit();                                 // chunk k
  }
  uint32_t* t = tab[sg.seg];
  uint8_t* lt = lut[sg.seg];
  uint32_t x = kRansL;
  int wlen = 0;
  if (modeled) {
    for (int i = sg.lane; i < 256; i += kLanes)
      t[i] = data[off + 2 * i] | (uint32_t(data[off + 2 * i + 1]) << 8);
    __syncwarp(sg.mask);
    if (sg.lane == 0) {
      uint32_t acc = 0;
      for (int i = 0; i < 256; ++i) {
        const uint32_t f = t[i];
        t[i] = acc | ((acc + f) << 16);
        acc += f;
      }
    }
    __syncwarp(sg.mask);
    // bucket k's first slot 16k belongs to the symbol with cum <= 16k <
    // cum + f; each symbol writes its buckets
    for (int i = sg.lane; i < 256; i += kLanes) {
      const uint32_t c = t[i] & 0xFFFFu, e = t[i] >> 16;
      const uint32_t step = 1u << kBucketShift;
      for (uint32_t k = (c + step - 1) >> kBucketShift;
           k < ((e + step - 1) >> kBucketShift); ++k)
        lt[k] = uint8_t(i);
    }
    if (plen > 0) {
      const uint8_t* s = data + off + kHeader + 4 * sg.lane;
      x = s[0] | (uint32_t(s[1]) << 8) | (uint32_t(s[2]) << 16) |
          (uint32_t(s[3]) << 24);
      wlen = int((plen - kStateBytes) / 2);
    }
  } else {  // the other blocks' lanes step through a one-symbol model
    t[0] = kProbScale << 16;
    for (int k = 16 * sg.lane; k < kBuckets; k += 16 * kLanes)
      *reinterpret_cast<uint4*>(lt + k) = make_uint4(0u, 0u, 0u, 0u);
  }
  uint8_t* obase = reinterpret_cast<uint8_t*>(uintptr_t(o) & ~uintptr_t(15));
  const int oo = int(o - obase);  // symbol i at ring byte (oo + i) & 255
  uint8_t* oring = obuf[sg.seg];
  int cur = 0, chunk = 0, flushed = oo;  // ring bytes [oo, flushed) stored
  for (int g0 = 0; g0 < G; g0 += kDRound) {
    const int k = (wo + 2 * cur) / kChunk;  // at most chunk + 1
    if (k > chunk) {
      stage_chunk(ring, wbase, wend, k + 3, sg.lane);
      chunk = k;
    }
    cp_commit();
    cp_wait<2>();  // chunks k and k + 1 have landed
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kDRound; ++u) {
      const int i = (g0 + u) * kLanes + sg.lane;
      const bool active = i < bs;
      const uint32_t slot = x & (kProbScale - 1);
      // the bucket's owner, and forward while its range ends at or below
      // the slot (only in buckets that hold a symbol boundary); the first
      // step forward is loaded beside the owner
      uint32_t s = lt[slot >> kBucketShift], e = t[s];
      const uint32_t e1 = t[s + 1];
      if ((e >> 16) <= slot) {
        e = e1;
        ++s;
        while ((e >> 16) <= slot) e = t[++s];
      }
      const uint32_t c = e & 0xFFFFu;
      uint32_t xn = ((e >> 16) - c) * (x >> kProbBits) + slot - c;
      const bool need = active && xn < kRansL;
      const unsigned m = __ballot_sync(0xFFFFFFFFu, need) & sg.mask;
      const int widx = cur + __popc(m & sg.below);
      const int q = wo + 2 * widx;  // loaded by every lane: no branch
      const uint32_t word = ring[q & (kRing - 1)] |
                            (uint32_t(ring[(q + 1) & (kRing - 1)]) << 8);
      if (need && widx < wlen) xn = (xn << 16) | word;
      if (active) {
        oring[(oo + i) & (kOutRing - 1)] = uint8_t(s);
        x = xn;
      }
      cur += min(__popc(m), max(wlen - cur, 0));
    }
    __syncwarp();
    // every other round and at the end, store the complete 16-byte pieces
    // of the output; a piece shared with the next or previous block takes
    // byte stores
    if (!(g0 & kDRound) && g0 + kDRound < G) continue;
    const int done = oo + min((g0 + kDRound) * kLanes, bs);
    const int hi = done == oo + bs ? done : done & ~15;
    for (int q = (flushed & ~15) + 16 * sg.lane; q < hi; q += 16 * kLanes) {
      if (q >= flushed && q + 16 <= hi) {
        *reinterpret_cast<uint4*>(obase + q) =
            *reinterpret_cast<const uint4*>(oring + (q & (kOutRing - 1)));
      } else {
        for (int r = max(q, flushed); r < min(q + 16, hi); ++r)
          obase[r] = oring[r & (kOutRing - 1)];
      }
    }
    flushed = hi;
    __syncwarp();
  }
}

// The CUDA block copies src[0:len) to dst[0:len) with 16-byte stores
// between dst's aligned ends; each 16 bytes come from 4-5 aligned 4-byte
// loads, funnel-shifted. No byte at or past `src_end` is read, and none
// before the aligned word that holds src[0].
__device__ void copy_block(uint8_t* dst, const uint8_t* src, long long len,
                           const uint8_t* src_end) {
  const int t = threadIdx.x, nt = blockDim.x;
  const long long head =
      min(len, (long long)((16 - (uintptr_t(dst) & 15)) & 15));
  // a piece at i reads up to src + i + 20 (the 5th word)
  const long long avail = (src_end - src) - 20;
  const long long pieces = min((len - head) / 16,
                               avail >= head ? (avail - head) / 16 + 1 : 0);
  const long long body = head + 16 * pieces;
  for (long long i = t; i < head; i += nt) dst[i] = src[i];
  for (long long i = head + 16 * t; i < body; i += 16 * nt) {
    const uintptr_t a = uintptr_t(src + i);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
    const unsigned r = unsigned(a & 3) * 8;
    const uint32_t w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3];
    const uint32_t w4 = r ? w[4] : 0u;
    *reinterpret_cast<uint4*>(dst + i) = make_uint4(
        __funnelshift_r(w0, w1, r), __funnelshift_r(w1, w2, r),
        __funnelshift_r(w2, w3, r), __funnelshift_r(w3, w4, r));
  }
  for (long long i = body + t; i < len; i += nt) dst[i] = src[i];
}

// table (nblocks, 4) i64 = (tag, byte offset of the frame in out, payload
// offset in words, payload length in words).
__global__ void __launch_bounds__(kFrameThreads)
    rans_frame_kernel(const uint8_t* __restrict__ planes, long long n,
                      long long nb, long long planes_len,
                      const uint32_t* __restrict__ etab,
                      const uint8_t* __restrict__ payload, long long pay_len,
                      const long long* __restrict__ table,
                      uint8_t* __restrict__ out) {
  const long long b = blockIdx.x;
  const long long tag = table[4 * b], boff = table[4 * b + 1];
  const long long dest = table[4 * b + 2], wl = table[4 * b + 3];
  const Block blk = block_of(b, n, nb);
  const int t = threadIdx.x;
  uint8_t* o = out + boff;
  if (t == 0) o[0] = uint8_t(tag);
  if (tag == 2) {  // constant block: its one symbol
    if (t == 0) o[1] = planes[blk.start];
  } else if (tag == 1) {  // raw block: bs verbatim bytes
    copy_block(o + 1, planes + blk.start, blk.bs, planes + planes_len);
  } else {  // modeled block: u16 freqs, u32 payload length, payload
    const uint32_t f = etab[b * 256 + t] & 0xFFFFu;
    o[1 + 2 * t] = uint8_t(f);
    o[2 + 2 * t] = uint8_t(f >> 8);
    if (t < 4) o[1 + 2 * 256 + t] = uint8_t(uint32_t(2 * wl) >> (8 * t));
    copy_block(o + 1 + kHeader, payload + 2 * dest, 2 * wl,
               payload + pay_len);
  }
}

int prologue(int device) {
  return int(cudaSetDevice(device));
}

unsigned grid_of(long long nblocks, int per_block) {
  return unsigned((nblocks + per_block - 1) / per_block);
}

}  // namespace

// C interface (ctypes); each returns the CUDA error code of its launch.
// `nblocks` = L * ceil(n / 65536) rANS blocks of the (L, n) planes.
extern "C" {

// E: planes (L, n) u8 -> etab (nblocks, 256) u32 = freq | cum<<16,
// nsym (nblocks,) i32.
int wr_rans_hist(const void* planes, long long n, long long nblocks,
                 void* etab, void* nsym, int device, void* stream) {
  if (n < 1 || nblocks < 1) return int(cudaErrorInvalidValue);
  if (int err = prologue(device)) return err;
  rans_hist_kernel<<<grid_of(nblocks, 1), kHistThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(planes), n, (n + kTBlock - 1) / kTBlock,
      static_cast<uint32_t*>(etab), static_cast<int32_t*>(nsym));
  return int(cudaGetLastError());
}

// F: planes (16-byte aligned), etab -> slab (nblocks, 32768) u16 (each
// block's words right-aligned, in stream order), x_fin (nblocks, 8) u32,
// nwords (nblocks,) i32.
int wr_rans_chain(const void* planes, long long n, long long nblocks,
                  const void* etab, void* slab, void* x_fin, void* nwords,
                  int device, void* stream) {
  if (n < 1 || nblocks < 1) return int(cudaErrorInvalidValue);
  if (int err = prologue(device)) return err;
  rans_chain_kernel<<<grid_of(nblocks, kSegs), kChainThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(planes), n, (n + kTBlock - 1) / kTBlock,
      nblocks, static_cast<const uint32_t*>(etab),
      static_cast<uint16_t*>(slab), static_cast<uint32_t*>(x_fin),
      static_cast<int32_t*>(nwords));
  return int(cudaGetLastError());
}

// G: every block b with dest[b] >= 0 writes 16 + nwords[b] u16 to
// out[dest[b]:].
int wr_rans_compact(const void* x_fin, const void* slab, const void* nwords,
                    const void* dest, long long nblocks, void* out,
                    int device, void* stream) {
  if (nblocks < 1) return int(cudaErrorInvalidValue);
  if (int err = prologue(device)) return err;
  rans_compact_kernel<<<grid_of(nblocks, 1), kCompactThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x_fin), static_cast<const uint16_t*>(slab),
      static_cast<const int32_t*>(nwords),
      static_cast<const long long*>(dest), static_cast<uint16_t*>(out));
  return int(cudaGetLastError());
}

// H: stream bytes `data` (data_len of them) and the (nblocks, 3) i64
// table (tag, body offset, payload length) -> out (L, n) u8. `data` and
// `out` are 16-byte aligned.
int wr_rans_decode(const void* data, long long data_len, const void* table,
                   long long n, long long nblocks, void* out, int device,
                   void* stream) {
  if (n < 1 || nblocks < 1 || data_len < 1) return int(cudaErrorInvalidValue);
  if (int err = prologue(device)) return err;
  rans_decode_kernel<<<grid_of(nblocks, kSegs), kChainThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), data_len,
      static_cast<const long long*>(table), n, (n + kTBlock - 1) / kTBlock,
      nblocks, static_cast<uint8_t*>(out));
  return int(cudaGetLastError());
}

// I: every block's frame, tag first, at out[table[b][1]:]; `planes`
// (16-byte aligned) holds planes_len = L * n bytes, `payload` pay_len
// bytes of G's output.
int wr_rans_frame(const void* planes, long long n, long long nblocks,
                  const void* etab, const void* payload, long long pay_len,
                  const void* table, void* out, int device, void* stream) {
  if (n < 1 || nblocks < 1) return int(cudaErrorInvalidValue);
  if (int err = prologue(device)) return err;
  const long long nb = (n + kTBlock - 1) / kTBlock;
  rans_frame_kernel<<<grid_of(nblocks, 1), kFrameThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(planes), n, nb, (nblocks / nb) * n,
      static_cast<const uint32_t*>(etab),
      static_cast<const uint8_t*>(payload), pay_len,
      static_cast<const long long*>(table), static_cast<uint8_t*>(out));
  return int(cudaGetLastError());
}

}  // extern "C"
