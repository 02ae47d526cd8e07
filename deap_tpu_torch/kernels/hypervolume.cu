// 3-D hypervolume sweep for Hopper (sm_90a): the CUDA counterpart of the
// Pallas kernel of deap_tpu/ops/hypervolume.py.
//
//   hv3d_sweep  (K5) replaces _hv3d_pallas_call: over the x-sorted view of
//                    the clipped points (heights ys, z-ranks zr, strip widths
//                    width) and the z-sorted strip depths dz, every prefix
//                    k = 1..n has the 2-D staircase area
//                      A_k = sum_j max(ref_y - min_{i<=j, zr[i]<k} ys[i], 0)
//                                  * width[j],
//                    and the kernel writes, per block of prefixes,
//                      out[g] = sum_k A_k * dz[k-1].
//                    The caller adds the block partials (torch.sum), as the
//                    TPU form leaves jnp.sum(out) outside its kernel.
//
// The TPU body builds the (blk, n_pad) masked matrix and takes its prefix
// minimum in log2(n_pad) shift-and-min passes, because Pallas has no scan
// and the vector unit wants whole rows.  Here a thread owns one prefix k
// and walks j once, carrying the running minimum and the area in
// registers: n * n pair steps, no (blk, n) intermediate, no log factor and
// no padding (any n; the +inf / INT32_MAX / zero-width lane padding of the
// TPU form is not needed).
//
// Bound on the card: operations.  The four input arrays are 16 n bytes
// (1.6 MB at n = 1e5); the work is n * n pair steps of one integer
// compare, one select, one minimum, one subtract, one maximum, one
// multiply and one add.  Design: the block stages tiles of (ys, width, zr)
// in shared memory as one 16-byte (float) or 24-byte (double) record, so
// every thread of a warp reads the same record at once (a broadcast, no
// bank conflict); the running minimum, the tile's area and the total live
// in registers.  The area is summed per tile and the tile sums are added
// up afterwards, so a thread's float32 sum over 1e5 strips does not run
// sequentially through one accumulator; the block's A_k * dz products are
// added by a fixed tree in shared memory.  No atomics: two launches on the
// same input are bitwise equal.  The build sets --fmad=false, so h * width
// is rounded before it is added, as in the plain PyTorch version
// ((h * width).sum(), deap_tpu_torch/ops/hypervolume.py); the orders of
// the sums differ, which is where kernel and plain version may part: the
// running minima are exact, the sums are not.
//
// float32 and float64 instantiations.  A plain C interface (no PyTorch
// headers), built into one library with the other kernels by
// deap_tpu_torch/kernels/build.py.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;         // x-slots staged per tile
constexpr int kMaxThreads = 1024;

template <typename T>
struct Slot {                       // one x-slot of the sorted view
  T y;
  T w;
  int zr;
  int pad;
};

template <typename T> __device__ __forceinline__ T pos_inf();
template <> __device__ __forceinline__ float pos_inf<float>() {
  return CUDART_INF_F;
}
template <> __device__ __forceinline__ double pos_inf<double>() {
  return CUDART_INF;
}

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
// one min/max instruction each in float32; the heights are never NaN
__device__ __forceinline__ float min_(float a, float b) {
  return fminf(a, b);
}
__device__ __forceinline__ double min_(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float max_(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double max_(double a, double b) {
  return fmax(a, b);
}

template <typename T>
__global__ void hv3d_sweep_kernel(const T* __restrict__ ys,
                                  const int* __restrict__ zr,
                                  const T* __restrict__ width,
                                  const T* __restrict__ dz, T ref_y,
                                  T* __restrict__ out, int n) {
  __shared__ Slot<T> tile[kTile];
  __shared__ T partial[kMaxThreads];
  const int k0 = blockIdx.x * blockDim.x + threadIdx.x;   // prefix k0 + 1
  const int k = k0 + 1;            // x-slot j is in the prefix iff zr[j] < k
  T m = pos_inf<T>();              // running minimum of the prefix's heights
  T area = T(0);
  for (int j0 = 0; j0 < n; j0 += kTile) {
    const int here = n - j0 < kTile ? n - j0 : kTile;
    __syncthreads();               // the previous tile is consumed
    for (int t = threadIdx.x; t < here; t += blockDim.x) {
      Slot<T> s;
      s.y = ys[j0 + t];
      s.w = width[j0 + t];
      s.zr = zr[j0 + t];
      s.pad = 0;
      tile[t] = s;
    }
    __syncthreads();
    T tile_area = T(0);
#pragma unroll 8
    for (int t = 0; t < here; ++t) {
      const Slot<T> s = tile[t];
      m = min_(m, s.zr < k ? s.y : pos_inf<T>());
      const T h = max_(ref_y - m, T(0));
      tile_area = add_rn(tile_area, mul_rn(h, s.w));
    }
    area = add_rn(area, tile_area);
  }
  // A_k * dz[k - 1]; threads past n carry zero
  partial[threadIdx.x] = k0 < n ? mul_rn(area, dz[k0]) : T(0);
  __syncthreads();
  // fixed tree over the next power of two of blockDim.x
  int span = 1;
  while (span < (int)blockDim.x) span <<= 1;
  for (int s = span >> 1; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s && (int)threadIdx.x + s < (int)blockDim.x)
      partial[threadIdx.x] =
          add_rn(partial[threadIdx.x], partial[threadIdx.x + s]);
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = partial[0];
}

template <typename T>
int launch(const void* ys, const void* zr, const void* width, const void* dz,
           double ref_y, void* out, int n, int threads, cudaStream_t st) {
  const int blocks = (n + threads - 1) / threads;
  hv3d_sweep_kernel<T><<<blocks, threads, 0, st>>>(
      (const T*)ys, (const int*)zr, (const T*)width, (const T*)dz, (T)ref_y,
      (T*)out, n);
  return (int)cudaGetLastError();
}

}  // namespace

// ys, width, dz (n,) float32 (is_double = 0) or float64 (1); zr (n,) int32;
// out (ceil(n / threads),) of the same type.  threads: a multiple of 32 in
// [32, 1024].
extern "C" int hv3d_sweep(const void* ys, const void* zr, const void* width,
                          const void* dz, double ref_y, void* out, int n,
                          int threads, int is_double, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return 0;
  if (threads < 32 || threads > kMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  if (is_double)
    return launch<double>(ys, zr, width, dz, ref_y, out, n, threads, st);
  return launch<float>(ys, zr, width, dz, ref_y, out, n, threads, st);
}
