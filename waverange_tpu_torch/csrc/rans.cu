// Format-v2 interleaved-rANS entropy stage (kernels E, F, G and H).
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
//   (rans.py:392-399). One CUDA block per rANS block counts the symbols
//   straight from the planes into shared-memory bins (no blockify copy, no
//   padding in bin 0), then normalizes serially in thread 0, in the exact
//   order of wr_native.cc:563-589, and writes freq | cum<<16 per symbol.
//   Bound by bytes (one read of the planes) and, on skewed blocks, by the
//   shared-memory atomics of equal symbols.
// F `rans_chain_kernel` replaces pregather (rans_kernels.py:163) and chain
//   (rans_kernels.py:277). The block's 256-entry freq|cum<<16 table sits in
//   shared memory, so the 4 B per symbol pre-gathered array of the TPU
//   version is never written. The 8 lane states of a block run in 8
//   adjacent threads (4 blocks per warp), from the last group of 8 symbols
//   to the first; division is the exact u32 `/`. A segment ballot ranks
//   the lanes that emit a word: the stream holds groups ascending and lanes
//   ascending within a group (wr_native.cc:747-759), so the words are
//   written backwards into a per-block slab of kSlabWords u16. Bound by
//   the latency of each lane's dependent chain (8192 steps of a table
//   load, a compare and a division); many independent segments per SM hide
//   it.
// G `rans_compact_kernel` replaces compact (rans_kernels.py:417): per
//   modeled block, the 16 LE state half-words and then the block's kept
//   words, copied from the tail of its slab to a host-computed offset of
//   one u16 buffer, so a single D2H copy brings back every payload. Bound
//   by bytes.
// H `rans_decode_kernel` replaces dchain (rans_kernels.py:700) and the
//   compose glue (rans.py:808-913). It reads the uploaded compressed bytes
//   at byte offsets (payloads follow a 517-byte header, so words are not
//   2-byte aligned and are composed from two bytes, LE, as
//   wr_native.cc:860 does). Per modeled block the freq|cum<<16 table sits
//   in shared memory; a slot resolves to its symbol by an 8-step binary
//   search over the cumulative table (the largest s with cum[s] <= slot,
//   which for a model summing to 16384 is a symbol of nonzero frequency).
//   The 8 lanes run in adjacent threads; a segment ballot ranks the
//   refills; the guard widx < wlen equals the C++ `w + 1 < wend`
//   (wr_native.cc:859). Constant and raw blocks are written by the same
//   kernel. Bound by the latency of the dependent chain, as F.
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
constexpr int kChainThreads = 128;
constexpr int kSegs = kChainThreads / kLanes;  // rANS blocks per CUDA block
constexpr int kCompactThreads = 256;
constexpr int kHeader = 516;    // u16 freqs[256] + u32 payload_len
constexpr int kStateBytes = 32;  // 8 LE u32 lane states

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
// segment of the warp.
struct Segment {
  int seg, lane;
  unsigned shift, mask, below;
  __device__ Segment() {
    seg = threadIdx.x / kLanes;
    lane = threadIdx.x % kLanes;
    shift = (threadIdx.x & 31u) & ~7u;
    mask = 0xFFu << shift;
    below = (1u << lane) - 1u;
  }
  // Lanes of this segment for which `pred` holds, as bits 0..7.
  __device__ __forceinline__ unsigned ballot(bool pred) const {
    return (__ballot_sync(mask, pred) >> shift) & 0xFFu;
  }
};

__global__ void __launch_bounds__(kHistThreads)
    rans_hist_kernel(const uint8_t* __restrict__ planes, long long n,
                     long long nb, uint32_t* __restrict__ etab,
                     int32_t* __restrict__ nsym) {
  __shared__ uint32_t cnt[256], freq[256], cum[256];
  const long long b = blockIdx.x;
  const Block blk = block_of(b, n, nb);
  const int t = threadIdx.x;
  cnt[t] = 0;
  __syncthreads();
  const uint8_t* p = planes + blk.start;
  for (int i = t; i < blk.bs; i += kHistThreads) atomicAdd(&cnt[p[i]], 1u);
  __syncthreads();
  const uint32_t c = cnt[t];
  // c * 16384 <= 2^30: exact in u32
  uint32_t f = c ? (c * kProbScale) / uint32_t(blk.bs) : 0u;
  if (c && !f) f = 1;
  freq[t] = f;
  const int present = __syncthreads_count(c != 0);
  if (t == 0) {
    uint32_t sum = 0;
    int maxs = -1;
    for (int i = 0; i < 256; ++i) {
      if (!cnt[i]) continue;
      sum += freq[i];
      if (maxs < 0 || cnt[i] > cnt[maxs]) maxs = i;
    }
    if (sum < kProbScale) {
      freq[maxs] += kProbScale - sum;
    } else {
      while (sum > kProbScale) {
        int m = -1;
        for (int i = 0; i < 256; ++i)
          if (freq[i] > 1 && (m < 0 || freq[i] > freq[m])) m = i;
        const uint32_t take = min(freq[m] - 1u, sum - kProbScale);
        freq[m] -= take;
        sum -= take;
      }
    }
    uint32_t acc = 0;
    for (int i = 0; i < 256; ++i) {
      cum[i] = acc;
      acc += freq[i];
    }
    nsym[b] = present;
  }
  __syncthreads();
  etab[b * 256 + t] = freq[t] | (cum[t] << 16);
}

__global__ void __launch_bounds__(kChainThreads)
    rans_chain_kernel(const uint8_t* __restrict__ planes, long long n,
                      long long nb, long long nblocks,
                      const uint32_t* __restrict__ etab,
                      uint16_t* __restrict__ slab, uint32_t* __restrict__ x_fin,
                      int32_t* __restrict__ nwords) {
  __shared__ uint32_t tab[kSegs][256];
  const Segment sg;
  const long long b = (long long)blockIdx.x * kSegs + sg.seg;
  if (b >= nblocks) return;  // the whole segment leaves together
  for (int i = sg.lane; i < 256; i += kLanes) tab[sg.seg][i] = etab[b * 256 + i];
  __syncwarp(sg.mask);
  const Block blk = block_of(b, n, nb);
  const uint8_t* p = planes + blk.start;
  uint16_t* w = slab + b * kSlabWords;
  uint32_t x = kRansL;
  int wpos = kSlabWords;  // slab words [wpos, kSlabWords) hold the stream
  for (int g = (blk.bs + kLanes - 1) / kLanes - 1; g >= 0; --g) {
    const int i = g * kLanes + sg.lane;
    const bool active = i < blk.bs;
    uint32_t f = 1, c = 0;
    if (active) {
      const uint32_t e = tab[sg.seg][p[i]];
      f = e & 0xFFFFu;
      c = e >> 16;
    }
    const bool emit = active && x >= (f << 18);
    const unsigned m = sg.ballot(emit);
    if (emit) {
      const int dst = wpos - __popc(m) + __popc(m & sg.below);
      if (dst >= 0) w[dst] = uint16_t(x);
      x >>= 16;
    }
    wpos -= __popc(m);
    if (active) {
      const uint32_t q = x / f;
      x = (q << kProbBits) + (x - q * f) + c;
    }
  }
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
    rans_decode_kernel(const uint8_t* __restrict__ data,
                       const long long* __restrict__ table, long long n,
                       long long nb, long long nblocks,
                       uint8_t* __restrict__ out) {
  __shared__ uint32_t tab[kSegs][256];
  const Segment sg;
  const long long b = (long long)blockIdx.x * kSegs + sg.seg;
  if (b >= nblocks) return;
  const long long tag = table[3 * b], off = table[3 * b + 1],
                  plen = table[3 * b + 2];
  const Block blk = block_of(b, n, nb);
  uint8_t* o = out + blk.start;
  if (tag == 2) {  // constant block: the symbol at off
    const uint8_t s = data[off];
    for (int i = sg.lane; i < blk.bs; i += kLanes) o[i] = s;
    return;
  }
  if (tag == 1) {  // raw block: bs verbatim bytes at off
    for (int i = sg.lane; i < blk.bs; i += kLanes) o[i] = data[off + i];
    return;
  }
  // modeled block: u16 LE freqs at off, then the payload after the header
  for (int i = sg.lane; i < 256; i += kLanes)
    tab[sg.seg][i] = data[off + 2 * i] | (uint32_t(data[off + 2 * i + 1]) << 8);
  __syncwarp(sg.mask);
  if (sg.lane == 0) {
    uint32_t acc = 0;
    for (int i = 0; i < 256; ++i) {
      const uint32_t f = tab[sg.seg][i];
      tab[sg.seg][i] = f | (acc << 16);
      acc += f;
    }
  }
  __syncwarp(sg.mask);
  const uint8_t* pay = data + off + kHeader;
  uint32_t x = kRansL;
  long long wlen = 0;
  if (plen > 0) {
    const uint8_t* s = pay + 4 * sg.lane;
    x = s[0] | (uint32_t(s[1]) << 8) | (uint32_t(s[2]) << 16) |
        (uint32_t(s[3]) << 24);
    wlen = (plen - kStateBytes) / 2;
  }
  const uint8_t* words = pay + kStateBytes;
  long long cur = 0;
  for (int g = 0; g * kLanes < blk.bs; ++g) {
    const int i = g * kLanes + sg.lane;
    const bool active = i < blk.bs;
    const uint32_t slot = x & (kProbScale - 1);
    int s = 0;
    for (int step = 128; step; step >>= 1)
      if ((tab[sg.seg][s + step] >> 16) <= slot) s += step;
    const uint32_t e = tab[sg.seg][s];
    uint32_t xn = (e & 0xFFFFu) * (x >> kProbBits) + slot - (e >> 16);
    const bool need = active && xn < kRansL;
    const unsigned m = sg.ballot(need);
    const long long widx = cur + __popc(m & sg.below);
    if (need && widx < wlen)
      xn = (xn << 16) | words[2 * widx] |
           (uint32_t(words[2 * widx + 1]) << 8);
    if (active) {
      o[i] = uint8_t(s);
      x = xn;
    }
    const long long left = wlen - cur;
    cur += min((long long)__popc(m), left > 0 ? left : 0);
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

// F: planes, etab -> slab (nblocks, 32768) u16 (each block's words
// right-aligned, in stream order), x_fin (nblocks, 8) u32, nwords
// (nblocks,) i32.
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

// H: stream bytes `data` and the (nblocks, 3) i64 table (tag, body offset,
// payload length) -> out (L, n) u8.
int wr_rans_decode(const void* data, const void* table, long long n,
                   long long nblocks, void* out, int device, void* stream) {
  if (n < 1 || nblocks < 1) return int(cudaErrorInvalidValue);
  if (int err = prologue(device)) return err;
  rans_decode_kernel<<<grid_of(nblocks, kSegs), kChainThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data),
      static_cast<const long long*>(table), n, (n + kTBlock - 1) / kTBlock,
      nblocks, static_cast<uint8_t*>(out));
  return int(cudaGetLastError());
}

}  // extern "C"
