// CDF 9/7 lifting sweeps along one axis of a 3-D field (kernels A and B).
//
// A (`lift_fwd_kernel`) replaces the forward Pallas sweeps of
// waverange_tpu/ops/wavelet_pallas.py: `lift_xy_pallas` (_lift_xy_kernel)
// and `lift_x_pallas` (_lift_x_kernel), plus the z sweep and the odd
// extents that the JAX path left to XLA (`_lift_fwd_axis` in
// waverange_tpu/ops/wavelet.py).
// B (`lift_inv_kernel`) replaces `inv_lift_yx_pallas` (_inv_yx_kernel)
// and the XLA inverse z sweep (`_lift_inv_axis`).
//
// What bounds it on the H100: bytes. Each sweep reads and writes every
// element of the active sub-box once and does about 7 flops per element,
// far below the card's f64 rate per byte of HBM traffic. The design keeps
// the whole line in shared memory, so one sweep costs exactly one read and
// one write of the sub-box: a block loads a tile of up to 32 lines, splits
// even/odd on the way in (strided loads, no unzip matmul), runs the four
// lifting stages in shared memory with a barrier between stages, and
// writes [lo*SCALE | hi*SCALE_INV] back in place. For the y and z axes
// the tile's lines are neighbouring x positions, so every global load and
// store of a warp touches consecutive addresses; for x the lines are
// contiguous already. Fusing several axes or levels into one pass is
// later work.
//
// Bit-exactness: every lifting update is one multiply and one add per
// element in the order of waverange_tpu/ops/wavelet.py:77-83 (inverse
// :100-103), and the library is built with --fmad=false, so no FMA
// contraction changes a rounding. The f64 result equals
// waverange_tpu.native.wavelet3d bit for bit. The lifting constants come
// from Python as doubles (the values of waverange_tpu/ops/wavelet.py:26-38)
// and are rounded to T once, as torch rounds a Python scalar to the
// tensor's type.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

struct LiftConsts {
  double l0, l1, l2, l3, scale, scale_inv, ext0, ext1, ext2;
};

// One axis sweep over the active sub-box: `no` x `ni` lines of length n.
struct LineGeom {
  long long n;   // line length (the sub-box extent along the axis)
  long long ls;  // element stride along a line
  long long ni;  // lines along the tiled (inner) index
  long long is;  // element stride of the inner index
  long long no;  // lines along the outer index
  long long os;  // element stride of the outer index
  int tx;        // lines per block
  int ntiles;    // ceil(ni / tx)
};

constexpr int kThreads = 256;
constexpr int kMaxLines = 32;
constexpr size_t kSmemBudget = 96 * 1024;  // tile size target per block
constexpr size_t kSmemMax = 227 * 1024;    // Hopper's per-block maximum

// Element k of a tile of nt lines -> (line t, position i). Consecutive k
// map to consecutive addresses: along the line when it is contiguous,
// across lines (neighbouring x) otherwise.
__device__ __forceinline__ void tile_index(const LineGeom& g, int nt,
                                           long long k, long long& t,
                                           long long& i) {
  if (g.ls == 1) {
    t = k / g.n;
    i = k % g.n;
  } else {
    t = k % nt;
    i = k / nt;
  }
}

// dst[j] = dst[j] -/+ c * (src[j+1] + src[j]), edge-replicated at j=m-1.
template <typename T, bool kSub>
__device__ __forceinline__ void stage_next(T* dst, const T* src, long long m,
                                           long long ms, int nt, T c) {
  for (long long k = threadIdx.x; k < nt * m; k += blockDim.x) {
    const long long t = k / m, j = k % m;
    const T* s = src + t * ms;
    const T u = s[j + 1 < m ? j + 1 : m - 1] + s[j];
    const T p = c * u;
    T* d = dst + t * ms + j;
    *d = kSub ? *d - p : *d + p;
  }
  __syncthreads();
}

// dst[j] = dst[j] -/+ c * (src[j] + src[j-1]), edge-replicated at j=0.
template <typename T, bool kSub>
__device__ __forceinline__ void stage_prev(T* dst, const T* src, long long m,
                                           long long ms, int nt, T c) {
  for (long long k = threadIdx.x; k < nt * m; k += blockDim.x) {
    const long long t = k / m, j = k % m;
    const T* s = src + t * ms;
    const T u = s[j] + s[j > 0 ? j - 1 : 0];
    const T p = c * u;
    T* d = dst + t * ms + j;
    *d = kSub ? *d - p : *d + p;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lift_fwd_kernel(T* __restrict__ x, LineGeom g, LiftConsts c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long m = (g.n + 1) / 2;
  const long long ms = m + 1;  // padded row: fewer bank conflicts
  const long long tile = blockIdx.x % g.ntiles;
  const long long o = blockIdx.x / g.ntiles;
  const long long t0 = tile * g.tx;
  const int nt = int(g.ni - t0 < g.tx ? g.ni - t0 : g.tx);
  T* lo = reinterpret_cast<T*>(smem);
  T* hi = lo + g.tx * ms;
  T* base = x + o * g.os + t0 * g.is;

  // Load and split even/odd.
  for (long long k = threadIdx.x; k < nt * g.n; k += blockDim.x) {
    long long t, i;
    tile_index(g, nt, k, t, i);
    const T v = base[t * g.is + i * g.ls];
    (i & 1 ? hi : lo)[t * ms + (i >> 1)] = v;
  }
  __syncthreads();

  // Odd length: extrapolate the missing odd tail sample.
  if (g.n & 1) {
    const T e0 = T(c.ext0), e1 = T(c.ext1), e2 = T(c.ext2);
    for (int t = threadIdx.x; t < nt; t += blockDim.x) {
      const T* L = lo + t * ms;
      T* H = hi + t * ms;
      H[m - 1] = L[m - 2] * e0 + H[m - 2] * e1 + L[m - 1] * e2;
    }
    __syncthreads();
  }

  stage_next<T, false>(hi, lo, m, ms, nt, T(c.l0));
  stage_prev<T, false>(lo, hi, m, ms, nt, T(c.l1));
  stage_next<T, false>(hi, lo, m, ms, nt, T(c.l2));
  stage_prev<T, false>(lo, hi, m, ms, nt, T(c.l3));

  // Scale and write [lo | hi] back in place (the extrapolated sample of an
  // odd line is not stored).
  const T sc = T(c.scale), si = T(c.scale_inv);
  for (long long k = threadIdx.x; k < nt * g.n; k += blockDim.x) {
    long long t, i;
    tile_index(g, nt, k, t, i);
    base[t * g.is + i * g.ls] =
        i < m ? lo[t * ms + i] * sc : hi[t * ms + (i - m)] * si;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lift_inv_kernel(T* __restrict__ x, LineGeom g, LiftConsts c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long q = (g.n + 1) / 2;
  const long long ms = q + 1;
  const long long tile = blockIdx.x % g.ntiles;
  const long long o = blockIdx.x / g.ntiles;
  const long long t0 = tile * g.tx;
  const int nt = int(g.ni - t0 < g.tx ? g.ni - t0 : g.tx);
  T* lo = reinterpret_cast<T*>(smem);
  T* hi = lo + g.tx * ms;
  T* base = x + o * g.os + t0 * g.is;

  // Load and unscale; an odd line gets a zeroed slot for the tail sample.
  const T sc = T(c.scale), si = T(c.scale_inv);
  for (long long k = threadIdx.x; k < nt * g.n; k += blockDim.x) {
    long long t, i;
    tile_index(g, nt, k, t, i);
    const T v = base[t * g.is + i * g.ls];
    if (i < q)
      lo[t * ms + i] = v * si;
    else
      hi[t * ms + (i - q)] = v * sc;
  }
  if (g.n & 1)
    for (int t = threadIdx.x; t < nt; t += blockDim.x) hi[t * ms + q - 1] = 0;
  __syncthreads();

  stage_prev<T, true>(lo, hi, q, ms, nt, T(c.l3));
  stage_next<T, true>(hi, lo, q, ms, nt, T(c.l2));
  stage_prev<T, true>(lo, hi, q, ms, nt, T(c.l1));
  stage_next<T, true>(hi, lo, q, ms, nt, T(c.l0));

  // Re-interleave; the slot of an odd line is dropped.
  for (long long k = threadIdx.x; k < nt * g.n; k += blockDim.x) {
    long long t, i;
    tile_index(g, nt, k, t, i);
    base[t * g.is + i * g.ls] = (i & 1 ? hi : lo)[t * ms + (i >> 1)];
  }
}

template <typename T>
int launch_lift(bool inverse, void* x, long long nz, long long ny,
                long long nx, long long az, long long ay, long long ax,
                int axis, const double* consts, int device, void* stream) {
  if (az < 1 || ay < 1 || ax < 1 || az > nz || ay > ny || ax > nx)
    return int(cudaErrorInvalidValue);
  const long long sy = nx, sz = nx * ny;
  LineGeom g{};
  switch (axis) {
    case 2:
      g = {ax, 1, ay, sy, az, sz, 0, 0};
      break;
    case 1:
      g = {ay, sy, ax, 1, az, sz, 0, 0};
      break;
    case 0:
      g = {az, sz, ax, 1, ay, sy, 0, 0};
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  if (g.n < 2) return int(cudaErrorInvalidValue);
  const size_t per_line = 2 * size_t((g.n + 1) / 2 + 1) * sizeof(T);
  if (per_line > kSmemMax) return int(cudaErrorInvalidValue);
  long long tx = 1;
  while (2 * tx <= kMaxLines && 2 * tx * per_line <= kSmemBudget) tx *= 2;
  if (tx > g.ni) tx = g.ni;
  g.tx = int(tx);
  const long long ntiles = (g.ni + tx - 1) / tx;
  const long long blocks = g.no * ntiles;
  if (blocks > INT_MAX) return int(cudaErrorInvalidValue);
  g.ntiles = int(ntiles);
  const LiftConsts c{consts[0], consts[1], consts[2], consts[3], consts[4],
                     consts[5], consts[6], consts[7], consts[8]};
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const size_t smem = size_t(tx) * per_line;
  auto kern = inverse ? lift_inv_kernel<T> : lift_fwd_kernel<T>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  kern<<<unsigned(blocks), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(static_cast<T*>(x), g, c);
  return int(cudaGetLastError());
}

}  // namespace

// C interface (ctypes). `x` is a contiguous (nz, ny, nx) buffer; the sweep
// lifts, in place, every line of the active sub-box (az, ay, ax) along
// `axis` (0 = z, 1 = y, 2 = x). `consts` holds L0..L3, SCALE, SCALE_INV,
// EXT0..EXT2. Returns the CUDA error code of the launch (0 = success).
extern "C" {

int wr_lift_fwd_f64(void* x, long long nz, long long ny, long long nx,
                    long long az, long long ay, long long ax, int axis,
                    const double* consts, int device, void* stream) {
  return launch_lift<double>(false, x, nz, ny, nx, az, ay, ax, axis, consts,
                             device, stream);
}

int wr_lift_fwd_f32(void* x, long long nz, long long ny, long long nx,
                    long long az, long long ay, long long ax, int axis,
                    const double* consts, int device, void* stream) {
  return launch_lift<float>(false, x, nz, ny, nx, az, ay, ax, axis, consts,
                            device, stream);
}

int wr_lift_inv_f64(void* x, long long nz, long long ny, long long nx,
                    long long az, long long ay, long long ax, int axis,
                    const double* consts, int device, void* stream) {
  return launch_lift<double>(true, x, nz, ny, nx, az, ay, ax, axis, consts,
                             device, stream);
}

int wr_lift_inv_f32(void* x, long long nz, long long ny, long long nx,
                    long long az, long long ay, long long ax, int axis,
                    const double* consts, int device, void* stream) {
  return launch_lift<float>(true, x, nz, ny, nx, az, ay, ax, axis, consts,
                            device, stream);
}

}  // extern "C"
