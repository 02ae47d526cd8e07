// 3-D hypervolume sweep for Hopper (sm_90a): the CUDA counterpart of the
// Pallas kernel of deap_tpu/ops/hypervolume.py.
//
//   hv3d_sweep  (K5) replaces _hv3d_pallas_call: over the x-sorted view of
//                    the clipped points (heights ys, z-ranks zr, strip widths
//                    width) and the z-sorted strip depths dz, every prefix
//                    k = 1..n has the 2-D staircase area
//                      A_k = sum_j max(ref_y - min_{i<=j, zr[i]<k} ys[i], 0)
//                                  * width[j],
//                    and the kernel writes, per block of `threads` prefixes,
//                      out[g] = sum_k A_k * dz[k-1],
//                    over the prefixes k_begin < k <= k_begin + count (a
//                    rank's range of slabs in the sharded hypervolume; the
//                    whole sweep is k_begin = 0, count = n).
//                    The caller adds the block partials (torch.sum), as the
//                    TPU form leaves jnp.sum(out) outside its kernel.
//
// The TPU body builds the (blk, n_pad) masked matrix and takes its prefix
// minimum in log2(n_pad) shift-and-min passes, because Pallas has no scan
// and the vector unit wants whole rows.  Here the same blocked O(n^2) sweep
// walks j once per prefix, carrying the running height and the area in
// registers: n * n pair steps, no (blk, n) intermediate, no log factor and
// no padding (any n).
//
// Heights instead of minima.  The points are clipped to ref, so every
// height ref_y - ys[j] is >= 0, and rounded subtraction is monotone:
// ref_y - min(ys) = max(ref_y - ys) exactly.  The running height of prefix
// k is therefore a running maximum of the staged heights ref_y - ys[j]
// (subtracted once per slot, not once per pair), started at 0, which is
// exactly max(ref_y - m, 0) of the running minimum m started at +inf: no
// subtract and no clamp per pair step.
//
// Bound on the card: operations.  The four input arrays are 16 n bytes
// (1.6 MB at n = 1e5); the work is n * n pair steps.  A pair step here is
// one integer compare, one maximum predicated on it and one fused multiply-
// add: the area's product and sum contract to an FMA (a choice: the plain
// version rounds h * width before its sum, and its sum runs in another
// order anyway, so the stated tolerance covers both).  Design:
//   * register tiling: a lane owns kR = 8 consecutive prefixes, so one
//     staged slot, read from shared memory as one broadcast record, serves
//     eight independent max/FMA chains (float64 latency is hidden by work of
//     the same lane, not only by other warps; 8 measured 12% faster than 4
//     at n = 1e5 in float64 and float32);
//   * a warp owns 256 prefixes and a block is one warp, so blocks balance
//     over the SMs in units of one warp;
//   * the j range is split into `chunks` (chosen by the wrapper from n and
//     the SM count so that about 12 warps run per SM: at n = 8192 there are
//     only 32 prefix groups, at n = 1e5 391).  Chunk c starts each prefix k
//     at its height after slots [0, c * chunk_len): the largest height of
//     the z-ranks below k whose x-slot lies before the chunk.  Over the
//     z-sorted view that is an O(n) prefix maximum: per-group maxima
//     (hv3d_groupmax_kernel), then in the sweep's warp the groups before
//     its own and a warp scan inside it (maxima are exact, so their order
//     does not matter).
//   * hv3d_finalize_kernel adds each prefix's chunk areas in chunk order,
//     multiplies by dz and adds a block's products by a fixed tree in shared
//     memory.
// Within a chunk a lane sums each tile's areas first and adds the tile sums
// afterwards, so a float32 sum over 1e5 strips does not run sequentially
// through one accumulator.  No atomics and a fixed order everywhere: two
// launches on the same input are bitwise equal.  The running maxima are
// exact; the sums are not, which is where kernel and plain version may part.
//
// float32 and float64 instantiations.  A plain C interface (no PyTorch
// headers), built into one library with the other kernels by
// deap_tpu_torch/kernels/build.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 8;               // prefixes a lane
constexpr int kGroup = 32 * kR;     // prefixes a warp (one block)
constexpr int kTile = 256;          // x-slots staged at a time
constexpr int kMaxThreads = 1024;

template <typename T>
struct Slot {                       // one x-slot of the sorted view
  T h;                              // ref_y - ys[j]
  T w;                              // width[j]
  int zr;
  int pad;
};

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
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
// h = max(h, x) where `in` holds; the heights are never NaN.  float32: a
// maximum predicated on `in` (FMNMX).  float64: fmax compiles to DSETP.MAX
// and selects of both halves, which with the predication came to ~14
// instructions a pair step in SASS (kernels/sass.py); one compare folded
// into `in` and a select of the two halves do it in four.
__device__ __forceinline__ void raise_if(bool in, float x, float& h) {
  if (in) h = fmaxf(h, x);
}
__device__ __forceinline__ void raise_if(bool in, double x, double& h) {
  h = (in & (x > h)) ? x : h;
}
__device__ __forceinline__ float max_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_(double a, double b) {
  return a > b ? a : b;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max_(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

// The z-sorted view of the heights: hz[zr[j]] = ref_y - ys[j] and the
// chunk of its x-slot, cz[zr[j]] = j / chunk_len (zr is a permutation of
// 0..n-1).
template <typename T>
__global__ void hv3d_zview_kernel(const T* __restrict__ ys,
                                  const int* __restrict__ zr, T ref_y,
                                  T* __restrict__ hz, int* __restrict__ cz,
                                  int n, int chunk_len) {
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += gridDim.x * blockDim.x) {
    const int k = zr[j];
    hz[k] = sub_rn(ref_y, ys[j]);
    cz[k] = j / chunk_len;
  }
}

// gm[c][g] (one warp a prefix group g, chunks c = 1..chunks-1): the
// largest height among the group's z-ranks q (256 g <= q < 256 g + 256)
// whose x-slot lies before chunk c, 0 where there is none.
template <typename T>
__global__ void hv3d_groupmax_kernel(const T* __restrict__ hz,
                                     const int* __restrict__ cz,
                                     T* __restrict__ gm, int n, int groups,
                                     int chunks) {
  const int g = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (g >= groups) return;                    // the whole warp
  const int lane = threadIdx.x & 31;
  T h[kR];
  int cq[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int q = g * kGroup + lane * kR + r;
    h[r] = q < n ? hz[q] : T(0);
    cq[r] = q < n ? cz[q] : chunks;
  }
  for (int c = 1; c < chunks; ++c) {
    T m = T(0);
#pragma unroll
    for (int r = 0; r < kR; ++r)
      if (cq[r] < c) m = max_(m, h[r]);
    m = warp_max(m);
    if (lane == 0) gm[(size_t)c * groups + g] = m;
  }
}

// area[c][k - 1 - k_begin]: the strip sum of prefix k over chunk c's
// slots, for the prefixes k_begin < k <= k_begin + count
template <typename T>
__global__ void __launch_bounds__(32)
hv3d_sweep_kernel(const T* __restrict__ ys, const int* __restrict__ zr,
                  const T* __restrict__ width, T ref_y,
                  const T* __restrict__ gm, const T* __restrict__ hz,
                  const int* __restrict__ cz, T* __restrict__ area, int n,
                  int chunk_len, int k_begin, int count, int gm_groups) {
  __shared__ Slot<T> tile[kTile];
  const int lane = threadIdx.x;
  const int g = blockIdx.x, c = blockIdx.y;
  const int p0 = k_begin + g * kGroup;          // the warp's first z-rank
  const int k1 = p0 + lane * kR + 1;           // prefixes k1 + r
  const int j0 = c * chunk_len;
  const int j1 = min(n, j0 + chunk_len);
  T h[kR], acc[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    h[r] = T(0);
    acc[r] = T(0);
  }
  if (c > 0) {
    // the heights when chunk c begins, over the z-ranks below k with an
    // x-slot before the chunk: the whole groups of 256 z-ranks before p0
    // (gm), the z-ranks from the last of them up to p0 one by one (none
    // when k_begin is a multiple of 256), then a running maximum over the
    // lane's ranks and a warp scan over lanes
    T base = T(0);
    const int whole = p0 / kGroup;
    for (int q = lane; q < whole; q += 32)
      base = max_(base, gm[(size_t)c * gm_groups + q]);
    for (int q = whole * kGroup + lane; q < p0; q += 32)
      if (cz[q] < c) base = max_(base, hz[q]);
    base = warp_max(base);
    T run = T(0);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int q = k1 - 1 + r;                  // z-rank of prefix k1 + r
      if (q < n && cz[q] < c) run = max_(run, hz[q]);
      h[r] = run;
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {          // inclusive scan over lanes
      const T up = __shfl_up_sync(~0u, run, o);
      if (lane >= o) run = max_(run, up);
    }
    T before = __shfl_up_sync(~0u, run, 1);
    before = max_(base, lane ? before : T(0));
#pragma unroll
    for (int r = 0; r < kR; ++r) h[r] = max_(before, h[r]);
  }
  for (int t0 = j0; t0 < j1; t0 += kTile) {
    const int here = min(kTile, j1 - t0);
    __syncwarp();                  // the previous tile is consumed
    for (int t = lane; t < here; t += 32) {
      Slot<T> s;
      s.h = sub_rn(ref_y, ys[t0 + t]);
      s.w = width[t0 + t];
      s.zr = zr[t0 + t];
      s.pad = 0;
      tile[t] = s;
    }
    __syncwarp();
    T part[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) part[r] = T(0);
#pragma unroll 4
    for (int t = 0; t < here; ++t) {
      const Slot<T> s = tile[t];
      const int d = s.zr - k1;     // slot t is in prefix k1 + r iff d < r
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        raise_if(d < r, s.h, h[r]);
        part[r] = fma_rn(h[r], s.w, part[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) acc[r] = add_rn(acc[r], part[r]);
  }
  const int k_end = min(n, k_begin + count);
#pragma unroll
  for (int r = 0; r < kR; ++r)
    if (k1 + r <= k_end)
      area[(size_t)c * count + k1 + r - 1 - k_begin] = acc[r];
}

// out[g] = sum over the block's prefixes k of (sum_c area[c][k - 1 -
// k_begin]) * dz[k - 1], the products added by a fixed tree
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
hv3d_finalize_kernel(const T* __restrict__ area, const T* __restrict__ dz,
                     T* __restrict__ out, int n, int chunks, int k_begin,
                     int count) {
  __shared__ T partial[kMaxThreads];
  const int k0 = blockIdx.x * blockDim.x + threadIdx.x;   // k_begin + k0 + 1
  T p = T(0);
  if (k0 < count && k_begin + k0 < n) {
    T a = area[k0];
    for (int c = 1; c < chunks; ++c)
      a = add_rn(a, area[(size_t)c * count + k0]);
    p = mul_rn(a, dz[k_begin + k0]);
  }
  partial[threadIdx.x] = p;
  __syncthreads();
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
           double ref_y, void* out, int n, int k_begin, int count,
           int threads, int chunks, void* area, void* gm, void* hz, void* cz,
           cudaStream_t st) {
  const int chunk_len = (n + chunks - 1) / chunks;
  const int gm_groups = (n + kGroup - 1) / kGroup;
  const int groups = (count + kGroup - 1) / kGroup;
  if (chunks > 1) {
    hv3d_zview_kernel<T><<<(n + 255) / 256, 256, 0, st>>>(
        (const T*)ys, (const int*)zr, (T)ref_y, (T*)hz, (int*)cz, n,
        chunk_len);
    hv3d_groupmax_kernel<T><<<(gm_groups + 7) / 8, 256, 0, st>>>(
        (const T*)hz, (const int*)cz, (T*)gm, n, gm_groups, chunks);
  }
  hv3d_sweep_kernel<T><<<dim3(groups, chunks), 32, 0, st>>>(
      (const T*)ys, (const int*)zr, (const T*)width, (T)ref_y,
      (const T*)gm, (const T*)hz, (const int*)cz, (T*)area, n, chunk_len,
      k_begin, count, gm_groups);
  hv3d_finalize_kernel<T><<<(count + threads - 1) / threads, threads, 0,
                            st>>>((const T*)area, (const T*)dz, (T*)out, n,
                                  chunks, k_begin, count);
  return (int)cudaGetLastError();
}

}  // namespace

// ys, width, dz (n,) float32 (is_double = 0) or float64 (1); zr (n,) int32.
// The prefixes k_begin < k <= k_begin + count (0 <= k_begin < n, count >=
// 1; prefixes past n add nothing): out (ceil(count / threads),) of the same
// type, partial g over the prefixes k_begin + g * threads + 1 ... .
// threads: a multiple of 32 in [32, 1024].  chunks: the j range's split,
// 1 <= chunks <= n.  Scratch of the same float type: area (chunks, count)
// and, when chunks > 1, gm (chunks, ceil(n / 256)), hz (n,) and int32 cz
// (n,).  k_begin = 0 and count = n is the whole sweep.
extern "C" int hv3d_sweep(const void* ys, const void* zr, const void* width,
                          const void* dz, double ref_y, void* out, int n,
                          int k_begin, int count, int threads, int chunks,
                          void* area, void* gm, void* hz, void* cz,
                          int is_double, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return 0;
  if (threads < 32 || threads > kMaxThreads || threads % 32 || chunks < 1 ||
      chunks > n || chunks > 65535 || k_begin < 0 || k_begin >= n ||
      count < 1 || count > (1 << 30))
    return (int)cudaErrorInvalidValue;
  if (is_double)
    return launch<double>(ys, zr, width, dz, ref_y, out, n, k_begin, count,
                          threads, chunks, area, gm, hz, cz, st);
  return launch<float>(ys, zr, width, dz, ref_y, out, n, k_begin, count,
                       threads, chunks, area, gm, hz, cz, st);
}
