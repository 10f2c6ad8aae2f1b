// Byte-layer quantizer (kernel C) and decode accumulate (kernel D).
//
// C (`quant_layer_kernel`) replaces the Pallas kernel `_quant_kernel` of
// waverange_tpu/ops/quant_pallas.py (`_quant_layer_call`): one byte layer
// of the flat wavelet field, q = trunc(a*v + b) -> u8, the residual
// v - (q*deps + mn) written in place, and each block's residual min/max
// (the next layer's bounds). The layer schedule (a, b, deps, mn, done)
// lives in a small device buffer that torch ops between launches fill, so
// the host never waits on the device between layers.
// D (`accumulate_kernel`) replaces `_accum_kernel` of
// `accumulate_layers_pallas`: sum_i (plane_i*deps_i + minv_i) in layer
// order.
//
// What bounds them on the H100: bytes. C reads the field and writes the
// field and one byte plane per element (17 B per f64 element per layer);
// D reads nlay bytes and writes one value per element. Both are one pass
// with no intermediate in device memory: C fuses the quantize, residual
// and min/max passes, D reads every plane once and writes once instead of
// a read-modify-write per layer. The grid-stride loop keeps a warp's
// accesses on consecutive addresses; the min/max partials are a few
// thousand values that torch reduces.
//
// Bit-exactness: the per-element operation order is that of the native
// codec (wr_native.cc:1471-1474 and :2128) and of ops/quant.py, with no FMA
// contraction (--fmad=false). min/max are exact in any order for NaN-free
// data.
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ void block_minmax(T& mn, T& mx, T* out_mn,
                                             T* out_mx) {
  __shared__ T smn[kThreads / 32], smx[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    const T a = __shfl_down_sync(0xffffffffu, mn, off);
    const T b = __shfl_down_sync(0xffffffffu, mx, off);
    mn = a < mn ? a : mn;
    mx = b > mx ? b : mx;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    smn[warp] = mn;
    smx[warp] = mx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
      mn = smn[w] < mn ? smn[w] : mn;
      mx = smx[w] > mx ? smx[w] : mx;
    }
    *out_mn = mn;
    *out_mx = mx;
  }
}

// params = (a, b, deps, mn, done). Once `done` is set the field is frozen
// (reference semantics: layers after the tolerance break are discarded),
// so the kernel returns at once; its plane and partials are then left
// unwritten and the caller ignores them.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    quant_layer_kernel(const T* __restrict__ params, T* __restrict__ fld,
                       uint8_t* __restrict__ plane, T* __restrict__ pmin,
                       T* __restrict__ pmax, long long n) {
  if (params[4] != T(0)) return;
  const T a = params[0], b = params[1], deps = params[2], mn = params[3];
  T rmn = T(INFINITY), rmx = -T(INFINITY);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const T v = fld[i];
    const T fq = a * v + b;
    const uint8_t q = uint8_t(fq);  // truncation == floor: fq >= 0
    const T r = v - (T(q) * deps + mn);
    plane[i] = q;
    fld[i] = r;
    rmn = r < rmn ? r : rmn;
    rmx = r > rmx ? r : rmx;
  }
  block_minmax(rmn, rmx, pmin + blockIdx.x, pmax + blockIdx.x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    accumulate_kernel(const uint8_t* __restrict__ planes,
                      const T* __restrict__ deps, const T* __restrict__ minv,
                      int nlay, long long n, T* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    T acc = T(0);
    for (int l = 0; l < nlay; ++l)
      acc = acc + (T(planes[l * n + i]) * deps[l] + minv[l]);
    out[i] = acc;
  }
}

template <typename T>
int launch_quant_layer(const void* params, void* fld, void* plane, void* pmin,
                       void* pmax, long long n, int nblocks, int device,
                       void* stream) {
  // Every block must own at least one element, so that its partials are
  // values of the residual.
  if (n < 1 || nblocks < 1 || (long long)nblocks * kThreads - kThreads >= n)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  quant_layer_kernel<T><<<nblocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(params), static_cast<T*>(fld),
      static_cast<uint8_t*>(plane), static_cast<T*>(pmin),
      static_cast<T*>(pmax), n);
  return int(cudaGetLastError());
}

template <typename T>
int launch_accumulate(const void* planes, const void* deps, const void* minv,
                      int nlay, long long n, void* out, int device,
                      void* stream) {
  if (n < 1 || nlay < 1) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 65536) blocks = 65536;
  accumulate_kernel<T><<<unsigned(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(planes), static_cast<const T*>(deps),
      static_cast<const T*>(minv), nlay, n, static_cast<T*>(out));
  return int(cudaGetLastError());
}

}  // namespace

// C interface (ctypes); each returns the CUDA error code of its launch.
extern "C" {

// One layer over the flat field `fld` (n values, updated in place) into
// `plane` (n bytes); block b writes its residual min/max to pmin[b] and
// pmax[b], for b < nblocks.
int wr_quant_layer_f64(const void* params, void* fld, void* plane, void* pmin,
                       void* pmax, long long n, int nblocks, int device,
                       void* stream) {
  return launch_quant_layer<double>(params, fld, plane, pmin, pmax, n, nblocks,
                                    device, stream);
}

int wr_quant_layer_f32(const void* params, void* fld, void* plane, void* pmin,
                       void* pmax, long long n, int nblocks, int device,
                       void* stream) {
  return launch_quant_layer<float>(params, fld, plane, pmin, pmax, n, nblocks,
                                   device, stream);
}

// out[i] = sum over l < nlay of (planes[l*n + i]*deps[l] + minv[l]).
int wr_accumulate_f64(const void* planes, const void* deps, const void* minv,
                      int nlay, long long n, void* out, int device,
                      void* stream) {
  return launch_accumulate<double>(planes, deps, minv, nlay, n, out, device,
                                   stream);
}

int wr_accumulate_f32(const void* planes, const void* deps, const void* minv,
                      int nlay, long long n, void* out, int device,
                      void* stream) {
  return launch_accumulate<float>(planes, deps, minv, nlay, n, out, device,
                                  stream);
}

}  // extern "C"
