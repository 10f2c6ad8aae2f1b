// CDF 9/7 lifting passes over the active sub-box of a 3-D field (kernels A
// and B), tiled with a halo, x and y fused in one pass.
//
// A (`lift_fwd_pass`) replaces the forward Pallas sweeps of
// waverange_tpu/ops/wavelet_pallas.py: `lift_xy_pallas` (_lift_xy_kernel,
// TPU kernel 1: x and y of a z-slab in one round trip to device memory)
// and `lift_x_pallas` (_lift_x_kernel, TPU kernel 2), plus the z sweep and
// the odd extents that the JAX path left to XLA (`_lift_fwd_axis` in
// waverange_tpu/ops/wavelet.py).
// B (`lift_inv_pass`) replaces `inv_lift_yx_pallas` (_inv_yx_kernel, TPU
// kernel 3: y and x in one round trip) and the XLA inverse z sweep
// (`_lift_inv_axis`).
//
// What bounded the first port of these kernels (one axis per launch, whole
// lines in shared memory, in place), measured on an H100 at 512^3 f64 by
// switching parts off: not bytes but instructions and latency. Of 5.82 ms
// per 4-level transform, 1.65 ms were 64-bit divisions by run-time values
// in the index arithmetic, 1.5 ms the four barrier-separated stages (most
// of it their own divisions), and the scalar loads took twice as long as
// the stores, with nothing in flight while a block lifted. Even
// `copy_` of the twelve sub-boxes took 2.5 ms: three round trips a level
// cannot be fast.
//
// What this design does about it:
//  - A pass works on tiles of 2*PY rows by 2*PX columns of samples. The
//    lifted pair j depends on input pairs j-2..j+2 only, so a tile loads
//    a halo of two pairs on each side and one thread computes one output
//    pair straight from its window of five input pairs, in registers, with
//    no barrier between the four stages. Shared memory no longer grows
//    with the line, so a line may have any length.
//  - The lifting's edge replication equals the whole-sample symmetric
//    extension of the line (the stages keep that symmetry, and a + b ==
//    b + a bit for bit), so the loader mirrors out-of-range positions into
//    the line and the arithmetic has no edge case. For an odd extent the
//    forward line is first extended by its extrapolated tail sample; the
//    inverse reads a zero in its slot.
//  - x and y are fused: the forward pass lifts the tile's rows along x
//    (halo rows too) into a second tile, then its columns along y, and
//    stores the four quadrants; the inverse lifts y, then x. A level is
//    two round trips to device memory instead of three. Neighbouring
//    tiles read each other's input, so every pass reads one buffer and
//    writes another.
//  - The z sweep is a pass of its own through the same kernel with the
//    row stride set to a plane: (z, x) tiles with a halo in z. A thread
//    walking a z column with a register window would read no halo, but a
//    second kernel family was not worth it: the halo rows are re-read from
//    L2, not from device memory.
//  - No division or remainder by a run-time value anywhere; tile extents
//    are compile-time constants, offsets inside a tile are 32-bit, and
//    64-bit products appear only in row addresses.
//  - The interior of a tile is staged with 16-byte cp.async where the
//    address allows it (else element by element, mirrored or
//    extrapolated); a tile is at most 44 KB, so several blocks share an SM
//    and one block's loads are in flight while another lifts and stores.
//    Every instantiation compiles to 29-38 registers a thread with no
//    spill (nvcc 12.9, -Xptxas -v), so shared memory, five blocks an SM in
//    f64, sets the occupancy.
//
// What bounds it now (H100, 700 W, 512^3 f64): bytes. A 4-level transform
// takes 1.80 ms forward and 1.86 ms inverse; a variant build with the four
// stages switched off took 1.73 and 1.84 ms. Level 0 moves the field four
// times (two passes, each a read and a write) in 1.53 ms, 2.8 TB/s,
// against the 2.97 TB/s of a `copy_` on the same card. Only fewer round
// trips (z fused into the same pass) would be faster. Tiles of 8 to 32 row
// pairs and 16 to 64 column pairs were measured: 16 x 32 is within 2 % of
// the best and twice as large is 15 % slower.
//
// Bit-exactness: every lifting update is one add, one multiply and one
// add or subtract per element in the order of
// waverange_tpu/ops/wavelet.py:77-83 (inverse :100-103), the tail is
// L[m-2]*e0 + H[m-2]*e1 + L[m-1]*e2 left to right, scaling comes last in
// the forward and first in the inverse, and the library is built with
// --fmad=false, so no FMA contraction changes a rounding. A halo value is
// computed by two blocks from the same inputs with the same operations.
// The f64 result equals waverange_tpu.native.wavelet3d bit for bit. The
// lifting constants come from Python as doubles (the values of
// waverange_tpu/ops/wavelet.py:26-38) and are rounded to T once, as torch
// rounds a Python scalar to the tensor's type. The plain mirror of the
// tiling is `lift_fwd_axis_tiled_plain` in ops/wavelet.py.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

struct LiftConsts {
  double l0, l1, l2, l3, scale, scale_inv, ext0, ext1, ext2;
};

template <typename T>
struct Coef {
  T l0, l1, l2, l3, sc, si, e0, e1, e2;
  __device__ explicit Coef(const LiftConsts& c)
      : l0(T(c.l0)), l1(T(c.l1)), l2(T(c.l2)), l3(T(c.l3)), sc(T(c.scale)),
        si(T(c.scale_inv)), e0(T(c.ext0)), e1(T(c.ext1)), e2(T(c.ext2)) {}
};

// One pass over the active sub-box, seen as `no` planes of `nr` rows of
// `nc` contiguous elements. Lifting "along y" means along the rows of a
// plane: for the z pass a row is a z index and a plane a y index.
struct PassGeom {
  int nc, nr, no;
  long long srs, sos;  // source: element strides of a row and of a plane
  long long drs, dos;  // destination
};

// Tile extents; ops/wavelet_cuda.py mirrors PX, PY and HALO.
constexpr int kThreads = 256;
constexpr int PX = 32;   // output pairs of a tile along x
constexpr int PY = 16;   // output pairs of a tile along the rows
constexpr int HALO = 2;  // pairs of halo on each side of a lifted axis
constexpr int MC = 2 * PX;

// Whole-sample symmetric extension: position p mirrored into [0, last].
__device__ __forceinline__ int reflect(int p, int last) {
  while (p < 0 || p > last) p = p < 0 ? -p : 2 * last - p;
  return p;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = unsigned(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void load2(const double* p, double& a, double& b) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  a = v.x;
  b = v.y;
}

__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}

__device__ __forceinline__ void store2(double* p, double a, double b) {
  *reinterpret_cast<double2*>(p) = make_double2(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Forward lifting of pair j from the window lo[k], hi[k] = pair j-2+k
// (hi[4] is not read): the four stages and the scaling.
template <typename T>
__device__ __forceinline__ void fwd_pair(const T* lo, const T* hi,
                                         const Coef<T>& c, T& out_lo,
                                         T& out_hi) {
  T h1[4], l1[3], h2[2];
#pragma unroll
  for (int k = 0; k < 4; ++k) h1[k] = hi[k] + c.l0 * (lo[k + 1] + lo[k]);
#pragma unroll
  for (int k = 0; k < 3; ++k) l1[k] = lo[k + 1] + c.l1 * (h1[k + 1] + h1[k]);
#pragma unroll
  for (int k = 0; k < 2; ++k) h2[k] = h1[k + 1] + c.l2 * (l1[k + 1] + l1[k]);
  const T l2 = l1[1] + c.l3 * (h2[1] + h2[0]);
  out_lo = l2 * c.sc;
  out_hi = h2[1] * c.si;
}

// Inverse lifting of pair j from the unscaled window lo[k], hi[k] = pair
// j-2+k (lo[0] is not read).
template <typename T>
__device__ __forceinline__ void inv_pair(const T* lo, const T* hi,
                                         const Coef<T>& c, T& out_lo,
                                         T& out_hi) {
  T l1[4], h1[3], l2[2];
#pragma unroll
  for (int k = 0; k < 4; ++k) l1[k] = lo[k + 1] - c.l3 * (hi[k + 1] + hi[k]);
#pragma unroll
  for (int k = 0; k < 3; ++k) h1[k] = hi[k + 1] - c.l2 * (l1[k + 1] + l1[k]);
#pragma unroll
  for (int k = 0; k < 2; ++k) l2[k] = l1[k + 1] - c.l1 * (h1[k + 1] + h1[k]);
  out_lo = l2[0];
  out_hi = h1[1] - c.l0 * (l2[1] + l2[0]);
}

template <typename T, bool LX, bool LY>
struct FwdTile {
  static constexpr int NR = LY ? 2 * PY + 4 * HALO : 2 * PY;
  static constexpr int NC = LX ? 2 * PX + 4 * HALO : 2 * PX;
  static constexpr size_t kSmem =
      sizeof(T) * (size_t(NR) * NC + (LX && LY ? size_t(NR) * MC : 0));
};

// Forward pass: x (LX) and/or the rows (LY) of every tile, x first.
// Input tile `in`[NR][NC] holds the samples as they lie in memory, with
// the halo; `mid`[NR][MC] the x-lifted rows as [lo | hi]; the output goes
// to the [lo | hi] halves of the sub-box along each lifted axis.
template <typename T, bool LX, bool LY>
__global__ void __launch_bounds__(kThreads)
    lift_fwd_pass(const T* __restrict__ src, T* __restrict__ dst, PassGeom g,
                  LiftConsts cd) {
  using Tile = FwdTile<T, LX, LY>;
  constexpr int NR = Tile::NR, NC = Tile::NC;
  constexpr int V = 16 / int(sizeof(T));
  constexpr int CH = NC / V;  // 16-byte chunks of an input row
  extern __shared__ __align__(16) unsigned char smem[];
  T* in = reinterpret_cast<T*>(smem);
  T* mid = LX && LY ? in + NR * NC : in;

  const Coef<T> c(cd);
  const int tid = threadIdx.x;
  const int mc = (g.nc + 1) >> 1, mr = (g.nr + 1) >> 1;
  const int lastc = 2 * mc - 1, lastr = 2 * mr - 1;
  const int jx0 = blockIdx.x * PX;
  const int col0 = 2 * jx0 - (LX ? 2 * HALO : 0);  // sample of column 0

  for (int o = blockIdx.z; o < g.no; o += gridDim.z) {
    const T* sp = src + (long long)o * g.sos;
    T* dp = dst + (long long)o * g.dos;
    for (int jr0 = blockIdx.y * PY; jr0 < mr; jr0 += gridDim.y * PY) {
      const int row0 = 2 * jr0 - (LY ? 2 * HALO : 0);  // sample of row 0

      // 1. Stage the tile. A row outside the line is its mirror image; the
      // tail row of an odd extent is made in step 3.
      for (int idx = tid; idx < NR * CH; idx += kThreads) {
        const int r = idx / CH, ch = idx - r * CH;
        int row = row0 + r;
        if (LY) row = reflect(row, lastr);
        if (row >= g.nr) continue;
        const T* gp = sp + (long long)row * g.srs;
        T* sm = in + r * NC + ch * V;
        const int pc = col0 + ch * V;
        if (pc >= 0 && pc + V <= g.nc &&
            (reinterpret_cast<uintptr_t>(gp + pc) & 15) == 0) {
          cp_async16(sm, gp + pc);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            T v = T(0);
            if (LX) {
              const int col = reflect(pc + e, lastc);
              if (col < g.nc)
                v = gp[col];
              else  // the extrapolated tail sample of an odd line
                v = gp[g.nc - 3] * c.e0 + gp[g.nc - 2] * c.e1 +
                    gp[g.nc - 1] * c.e2;
            } else if (pc + e < g.nc) {
              v = gp[pc + e];
            }
            sm[e] = v;
          }
        }
      }
      cp_async_wait_all();
      __syncthreads();

      // 2. Lift every row along x, halo rows too.
      if (LX) {
        for (int idx = tid; idx < NR * PX; idx += kThreads) {
          const int r = idx / PX, j = idx % PX;
          const T* p = in + r * NC + 2 * j;
          T lo[5], hi[5];
#pragma unroll
          for (int k = 0; k < 5; ++k) load2(p + 2 * k, lo[k], hi[k]);
          T ol, oh;
          fwd_pair(lo, hi, c, ol, oh);
          if (LY) {
            mid[r * MC + j] = ol;
            mid[r * MC + PX + j] = oh;
          } else if (row0 + r < g.nr) {
            T* q = dp + (long long)(row0 + r) * g.drs + jx0 + j;
            if (jx0 + j < mc) q[0] = ol;
            if (jx0 + j < g.nc - mc) q[mc] = oh;
          }
        }
        if (LY) __syncthreads();
      }

      if (LY) {
        // 3. Odd row extent: the tail row from the three rows before it.
        if ((g.nr & 1) && (row0 < 0 || row0 + NR > g.nr)) {
          const T* a = mid + (g.nr - 3 - row0) * MC;
          for (int idx = tid; idx < NR * MC; idx += kThreads) {
            const int r = idx / MC, col = idx % MC;
            if (reflect(row0 + r, lastr) == g.nr)
              mid[idx] = a[col] * c.e0 + a[MC + col] * c.e1 +
                         a[2 * MC + col] * c.e2;
          }
          __syncthreads();
        }

        // 4. Lift every column along the rows and store the quadrants.
        for (int idx = tid; idx < PY * MC; idx += kThreads) {
          const int jy = idx / MC, col = idx % MC;
          const T* p = mid + 2 * jy * MC + col;
          T lo[5], hi[5];
#pragma unroll
          for (int k = 0; k < 5; ++k) lo[k] = p[2 * k * MC];
#pragma unroll
          for (int k = 0; k < 4; ++k) hi[k] = p[(2 * k + 1) * MC];
          T ol, oh;
          fwd_pair(lo, hi, c, ol, oh);
          int x;
          bool ok;
          if (LX) {
            const bool h = col >= PX;
            const int j = jx0 + (h ? col - PX : col);
            ok = j < (h ? g.nc - mc : mc);
            x = h ? mc + j : j;
          } else {
            x = 2 * jx0 + col;
            ok = x < g.nc;
          }
          const int jr = jr0 + jy;
          if (ok && jr < mr) dp[(long long)jr * g.drs + x] = ol;
          if (ok && jr < g.nr - mr) dp[(long long)(mr + jr) * g.drs + x] = oh;
        }
      }
      __syncthreads();  // the next tile overwrites this one
    }
  }
}

template <typename T, bool LX, bool LY>
struct InvTile {
  static constexpr int HX = 16 / int(sizeof(T));  // halo along x: a vector
  static constexpr int KW = PX + 2 * HX;          // pairs of a row's plane
  static constexpr int KH = PY + 2 * HALO;        // pair rows of a plane
  static constexpr int NR = LY ? 2 * KH : 2 * PY;
  static constexpr int NC = LX ? 2 * KW : 2 * PX;
  static constexpr size_t kSmem =
      sizeof(T) * (size_t(NR) * NC + (LX && LY ? size_t(2 * PY) * NC : 0));
};

// Inverse pass: the rows (LY) and/or x (LX) of every tile, rows first.
// Input tile `in`[NR][NC] holds the coefficients by plane, [lo | hi]
// along each lifted axis, with the halo; `mid`[2*PY][NC] the row-lifted,
// re-interleaved rows; the output is interleaved along each lifted axis.
template <typename T, bool LX, bool LY>
__global__ void __launch_bounds__(kThreads)
    lift_inv_pass(const T* __restrict__ src, T* __restrict__ dst, PassGeom g,
                  LiftConsts cd) {
  using Tile = InvTile<T, LX, LY>;
  constexpr int NR = Tile::NR, NC = Tile::NC, KW = Tile::KW, KH = Tile::KH;
  constexpr int HX = Tile::HX;
  constexpr int V = 16 / int(sizeof(T));
  constexpr int CH = NC / V;
  extern __shared__ __align__(16) unsigned char smem[];
  T* in = reinterpret_cast<T*>(smem);
  T* mid = LX && LY ? in + NR * NC : in;

  const Coef<T> c(cd);
  const int tid = threadIdx.x;
  const int qc = (g.nc + 1) >> 1, qr = (g.nr + 1) >> 1;
  const int lastc = 2 * qc - 1, lastr = 2 * qr - 1;
  const int jx0 = blockIdx.x * PX;

  for (int o = blockIdx.z; o < g.no; o += gridDim.z) {
    const T* sp = src + (long long)o * g.sos;
    T* dp = dst + (long long)o * g.dos;
    for (int jr0 = blockIdx.y * PY; jr0 < qr; jr0 += gridDim.y * PY) {
      // 1. Stage the tile. A pair outside the line is its mirror image;
      // the missing tail of an odd line reads as zero.
      for (int idx = tid; idx < NR * CH; idx += kThreads) {
        const int r = idx / CH, ch = idx - r * CH;
        T* sm = in + r * NC + ch * V;
        int row;
        if (LY) {
          const int h = r >= KH;
          const int s = reflect(2 * (jr0 - HALO + r - h * KH) + h, lastr);
          row = (h ? qr : 0) + (s >> 1);
        } else {
          row = 2 * jr0 + r;
          if (row >= g.nr) continue;
        }
        if (row >= g.nr) {
#pragma unroll
          for (int e = 0; e < V; ++e) sm[e] = T(0);
          continue;
        }
        const T* gp = sp + (long long)row * g.srs;
        if (LX) {
          const int h = ch * V >= KW;
          const int j = jx0 - HX + ch * V - h * KW;  // first pair
          const int base = h ? qc : 0, len = h ? g.nc - qc : qc;
          if (j >= 0 && j + V <= len &&
              (reinterpret_cast<uintptr_t>(gp + base + j) & 15) == 0) {
            cp_async16(sm, gp + base + j);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) {
              const int jj = reflect(2 * (j + e) + h, lastc) >> 1;
              sm[e] = jj < len ? gp[base + jj] : T(0);
            }
          }
        } else {
          const int x = 2 * jx0 + ch * V;
          if (x + V <= g.nc &&
              (reinterpret_cast<uintptr_t>(gp + x) & 15) == 0) {
            cp_async16(sm, gp + x);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e)
              sm[e] = x + e < g.nc ? gp[x + e] : T(0);
          }
        }
      }
      cp_async_wait_all();
      __syncthreads();

      // 2. Lift every column along the rows, halo columns too.
      if (LY) {
        for (int idx = tid; idx < PY * NC; idx += kThreads) {
          const int jy = idx / NC, col = idx - jy * NC;
          const T* p = in + jy * NC + col;
          T lo[5], hi[5];
#pragma unroll
          for (int k = 1; k < 5; ++k) lo[k] = p[k * NC] * c.si;
#pragma unroll
          for (int k = 0; k < 5; ++k) hi[k] = p[(KH + k) * NC] * c.sc;
          T ol, oh;
          inv_pair(lo, hi, c, ol, oh);
          if (LX) {
            mid[2 * jy * NC + col] = ol;
            mid[(2 * jy + 1) * NC + col] = oh;
          } else {
            const int x = 2 * jx0 + col, row = 2 * (jr0 + jy);
            T* q = dp + (long long)row * g.drs + x;
            if (x < g.nc && row < g.nr) q[0] = ol;
            if (x < g.nc && row + 1 < g.nr) q[g.drs] = oh;
          }
        }
        if (LX) __syncthreads();
      }

      // 3. Lift every row along x and store it interleaved.
      if (LX) {
        for (int idx = tid; idx < 2 * PY * PX; idx += kThreads) {
          const int r = idx / PX, j = idx % PX;
          const T* p = mid + r * NC + (HX - HALO) + j;
          T lo[5], hi[5];
#pragma unroll
          for (int k = 1; k < 5; ++k) lo[k] = p[k] * c.si;
#pragma unroll
          for (int k = 0; k < 5; ++k) hi[k] = p[KW + k] * c.sc;
          T ol, oh;
          inv_pair(lo, hi, c, ol, oh);
          const int row = 2 * jr0 + r, x = 2 * (jx0 + j);
          if (row < g.nr && x < g.nc) {
            T* q = dp + (long long)row * g.drs + x;
            if (x + 1 < g.nc && (reinterpret_cast<uintptr_t>(q) & 15) == 0) {
              store2(q, ol, oh);
            } else {
              q[0] = ol;
              if (x + 1 < g.nc) q[1] = oh;
            }
          }
        }
      }
      __syncthreads();  // the next tile overwrites this one
    }
  }
}

template <typename T, bool LX, bool LY>
int launch(bool inverse, const T* src, T* dst, const PassGeom& g,
           const LiftConsts& c, cudaStream_t stream) {
  const size_t smem =
      inverse ? InvTile<T, LX, LY>::kSmem : FwdTile<T, LX, LY>::kSmem;
  auto kern = inverse ? lift_inv_pass<T, LX, LY> : lift_fwd_pass<T, LX, LY>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const int mc = (g.nc + 1) / 2, mr = (g.nr + 1) / 2;
  const int ty = (mr + PY - 1) / PY;
  const dim3 grid(unsigned((mc + PX - 1) / PX),
                  unsigned(ty < 65535 ? ty : 65535),
                  unsigned(g.no < 65535 ? g.no : 65535));
  kern<<<grid, kThreads, smem, stream>>>(src, dst, g, c);
  return int(cudaGetLastError());
}

template <typename T>
int launch_pass(int inverse, const void* src, void* dst, long long s_sz,
                long long s_sy, long long d_sz, long long d_sy, long long az,
                long long ay, long long ax, int axes, const double* consts,
                int device, void* stream) {
  constexpr long long kMax = 1LL << 30;  // sample positions stay 32-bit
  if (az < 1 || ay < 1 || ax < 1 || az > kMax || ay > kMax || ax > kMax ||
      src == dst)
    return int(cudaErrorInvalidValue);
  const LiftConsts c{consts[0], consts[1], consts[2], consts[3], consts[4],
                     consts[5], consts[6], consts[7], consts[8]};
  // rows are y and planes z, except in the z pass: rows z and planes y
  PassGeom g{int(ax), int(ay), int(az), s_sy, s_sz, d_sy, d_sz};
  if (axes == 0) g = {int(ax), int(az), int(ay), s_sz, s_sy, d_sz, d_sy};
  const bool lx = axes == 2 || axes == 3, ly = axes != 2;
  if (axes < 0 || axes > 3 || (lx && g.nc < 2) || (ly && g.nr < 2))
    return int(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const T* s = static_cast<const T*>(src);
  T* d = static_cast<T*>(dst);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (axes == 3) return launch<T, true, true>(inverse, s, d, g, c, st);
  if (axes == 2) return launch<T, true, false>(inverse, s, d, g, c, st);
  return launch<T, false, true>(inverse, s, d, g, c, st);
}

}  // namespace

// C interface (ctypes). One pass reads the active sub-box (az, ay, ax) of
// `src` and writes the lifted sub-box to `dst`, a different buffer; both
// are (nz, ny, nx) arrays with x contiguous and the element strides
// (s_sz, s_sy) and (d_sz, d_sy) of z and y. `axes` names what is lifted:
// 0 = z, 1 = y, 2 = x, 3 = x and y fused (forward: x then y; inverse: y
// then x). `consts` holds L0..L3, SCALE, SCALE_INV, EXT0..EXT2. Returns
// the CUDA error code of the launch (0 = success).
extern "C" {

int wr_lift_pass_f64(int inverse, const void* src, void* dst, long long s_sz,
                     long long s_sy, long long d_sz, long long d_sy,
                     long long az, long long ay, long long ax, int axes,
                     const double* consts, int device, void* stream) {
  return launch_pass<double>(inverse, src, dst, s_sz, s_sy, d_sz, d_sy, az, ay,
                             ax, axes, consts, device, stream);
}

int wr_lift_pass_f32(int inverse, const void* src, void* dst, long long s_sz,
                     long long s_sy, long long d_sz, long long d_sy,
                     long long az, long long ay, long long ax, int axes,
                     const double* consts, int device, void* stream) {
  return launch_pass<float>(inverse, src, dst, s_sz, s_sy, d_sz, d_sy, az, ay,
                            ax, axes, consts, device, stream);
}

}  // extern "C"
