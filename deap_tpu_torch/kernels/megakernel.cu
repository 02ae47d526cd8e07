// Fused GA generation kernels for Hopper (sm_90a): the CUDA counterparts of
// the two Pallas kernels of deap_tpu/ops/generation_pallas.py.
//
//   megakernel_vary         (K1) replaces _megakernel_host: variation of
//                                parents already gathered.
//   megakernel_gather_vary  (K2) replaces _megakernel_dma: per output row the
//                                winner order[pos[r]], the gather of its
//                                genome row, then K1's variation.
//
// Both run one __device__ function per output element (r, c) of the
// unpadded (n, dim) layout: own row r and partner row r ^ 16 (the 32-row
// mating quantum), the pair draw hashed at the a-row min(r, r ^ 16), the
// row gate and the gene draw hashed at (r, c), swap, mutate, narrow, store.
// Every draw is the JAX package's counter hash of (seed, draw, row, lane), so
// the kernel computes what _vary_tile computes, not its tile structure.
//
// Bound on the card: bytes.  Each element is read once from the parents (K1)
// or the winner row (K2) and written once; K2 adds the order/pos/widx words.
// At pop 1e6 x dim 100 in float32 that is about 0.8 GB a generation, against
// a handful of integer ops per element for the hash.  This first version
// keeps one thread per element with coalesced row reads (the partner row is
// the neighbour block's and is served from cache); TMA row gathers, 16-byte
// vector accesses and a block-level hash are later work.
//
// Arithmetic: uint32 wrap-around hashing, (bits >> 8) * 2^-24 uniforms,
// floor(u * dim) cut points, and XLA's float32 erf_inv (Giles' polynomial
// over XLA's Cephes log1p/log), with __fmaf_rn exactly where XLA's CPU
// backend fuses a multiply into an add and explicitly rounded operations
// everywhere else.  Built with --fmad=false, the kernel equals the plain
// PyTorch version bit for bit (deap_tpu_torch/ops/generation.py).
//
// A plain C interface (no PyTorch headers): the wrapper in
// deap_tpu_torch/kernels/__init__.py passes device pointers and the stream,
// and raises on a non-zero return (cudaGetLastError after the launch).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// ---- counter hash --------------------------------------------------------

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x21F0AAADu;
  x ^= x >> 15;
  x *= 0x735A2D97u;
  x ^= x >> 15;
  return x;
}

__device__ __forceinline__ float uniform_at(uint32_t seed, uint32_t draw,
                                            uint32_t row, uint32_t lane) {
  uint32_t ctr = row * 0x9E3779B9u + lane * 0x85EBCA6Bu + draw * 0xC2B2AE35u;
  return __fmul_rn((float)(mix32(ctr ^ seed) >> 8), 5.9604644775390625e-08f);
}

// ---- XLA's float32 log, log1p and erf_inv ---------------------------------
// Constants are float32 values; the operation order is XLA CPU's.

__device__ float xla_log(float v) {
  const float kMin = 1.1754943508222875e-38f;
  float x = v > kMin ? v : kMin;
  int b = __float_as_int(x);
  float e = __fadd_rn((float)((b >> 23) - 127), 1.0f);
  float m = __int_as_float((b & 0x7FFFFF) | 0x3F000000);
  bool small = m < 0.7071067690849304f;
  x = __fadd_rn(__fadd_rn(m, -1.0f), small ? m : 0.0f);
  e = __fsub_rn(e, small ? 1.0f : 0.0f);
  float x2 = __fmul_rn(x, x);
  float x3 = __fmul_rn(x2, x);
  float y1 = __fmaf_rn(__fmaf_rn(x, 0.07037683576345444f, -0.11514610052108765f),
                       x, 0.11676998436450958f);
  float y2 = __fmaf_rn(__fmaf_rn(x, -0.12420140951871872f, 0.14249323308467865f),
                       x, -0.16668057441711426f);
  float y3 = __fmaf_rn(__fmaf_rn(x, 0.2000071406364441f, -0.24999994039535522f),
                       x, 0.3333333134651184f);
  float y = __fmaf_rn(y1, x3, y2);
  y = __fmaf_rn(y, x3, y3);
  y = __fmaf_rn(y, x3, __fmul_rn(e, -0.00021219444170128554f));
  x = __fsub_rn(x, __fmul_rn(x2, 0.5f));
  x = __fmaf_rn(e, 0.693359375f, __fadd_rn(x, y));
  if (v == 0.0f) return -__int_as_float(0x7F800000);
  if (v == __int_as_float(0x7F800000)) return v;
  if (!(v > 0.0f)) return __int_as_float(0x7FC00000);
  return x;
}

__device__ float xla_log1p(float x) {
  float large = xla_log(__fadd_rn(x, 1.0f));
  float num = 4.527000055531971e-05f;
  num = __fmaf_rn(num, x, 0.4985410273075104f);
  num = __fmaf_rn(num, x, 6.578732490539551f);
  num = __fmaf_rn(num, x, 29.91191864013672f);
  num = __fmaf_rn(num, x, 60.949668884277344f);
  num = __fmaf_rn(num, x, 57.11296463012695f);
  num = __fmaf_rn(num, x, 20.039552688598633f);
  float den = 1.0f;
  den = __fmaf_rn(den, x, 15.062909126281738f);
  den = __fmaf_rn(den, x, 83.04756927490234f);
  den = __fmaf_rn(den, x, 221.7624053955078f);
  den = __fmaf_rn(den, x, 309.0987243652344f);
  den = __fmaf_rn(den, x, 216.42788696289062f);
  den = __fmaf_rn(den, x, 60.11865997314453f);
  float x2 = __fmul_rn(x, x);
  float r = __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(num, den));
  float small = __fadd_rn(x, __fadd_rn(__fmul_rn(x2, -0.5f), r));
  return fabsf(x) < 0.4142135679721832f ? small : large;
}

__device__ float xla_erf_inv(float x) {
  const float lt_c[9] = {
      2.810226362726098e-08f, 3.432739390518691e-07f, -3.523387704262859e-06f,
      -4.391506536194356e-06f, 0.00021858086984138936f, -0.001253725029528141f,
      -0.004177681636065245f, 0.24664072692394257f, 1.5014094114303589f};
  const float ge_c[9] = {
      -0.0002002142573473975f, 0.0001009505576803349f, 0.0013493432197719812f,
      -0.003673428436741233f, 0.005739507731050253f, -0.007622461300343275f,
      0.00943887047469616f, 1.0016740560531616f, 2.832976818084717f};
  float lg = xla_log1p(__fmul_rn(x, -x));
  bool lt = lg > -5.0f;
  float w = lt ? __fsub_rn(-2.5f, lg) : __fadd_rn(__fsqrt_rn(-lg), -3.0f);
  float p = lt ? lt_c[0] : ge_c[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fmaf_rn(p, w, lt ? lt_c[i] : ge_c[i]);
  if (fabsf(x) == 1.0f) p = __int_as_float(0x7F800000);
  return __fmul_rn(x, p);
}

// ---- storage widen / narrow ------------------------------------------------

struct Storage {
  float scale;      // int8: float32(bound / 127)
  float inv_scale;  // int8: float32(127 / bound)
};

__device__ __forceinline__ float widen(float v, const Storage&) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v, const Storage&) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(int8_t v, const Storage& s) {
  return __fmul_rn((float)v, s.scale);
}

template <typename T> __device__ T narrow(float v, const Storage& s);
template <> __device__ __forceinline__ float narrow<float>(float v,
                                                           const Storage&) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
narrow<__nv_bfloat16>(float v, const Storage&) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ int8_t narrow<int8_t>(float v,
                                                             const Storage& s) {
  float q = rintf(__fmul_rn(v, s.inv_scale));      // round half to even
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return (int8_t)q;
}

// ---- the tile function, one element ----------------------------------------
// own / partner: widened values of rows r and r ^ 16 at column c.
// knobs: [cxpb, mutpb, mu, sigma, indpb].

__device__ __forceinline__ float vary_element(float own, float partner,
                                              long long r, int c, int dim,
                                              uint32_t seed,
                                              const float* knobs,
                                              long long row_base0) {
  const float cxpb = knobs[0], mutpb = knobs[1], mu = knobs[2],
              sigma = knobs[3], indpb = knobs[4];
  // two-point crossover: pair draw 1 at the a-row, lanes 0..2
  uint32_t a_row = (uint32_t)((r & ~16LL) + row_base0);
  float u0 = uniform_at(seed, 1u, a_row, 0u);
  float u1 = uniform_at(seed, 1u, a_row, 1u);
  float u2 = uniform_at(seed, 1u, a_row, 2u);
  int c1 = 1 + (int)floorf(__fmul_rn(u1, (float)dim));
  c1 = c1 < dim ? c1 : dim;
  int c2 = 1 + (int)floorf(__fmul_rn(u2, (float)(dim - 1)));
  c2 = c2 < dim - 1 ? c2 : dim - 1;
  if (c2 >= c1) c2 += 1;
  int lo = c1 < c2 ? c1 : c2, hi = c1 < c2 ? c2 : c1;
  float v = (u0 < cxpb && c >= lo && c < hi) ? partner : own;
  // Gaussian mutation: row gate (draw 2, lane 0), mask and noise (draw 3)
  uint32_t row = (uint32_t)(r + row_base0);
  if (uniform_at(seed, 2u, row, 0u) < mutpb) {
    float u = uniform_at(seed, 3u, row, (uint32_t)c);
    if (u < indpb) {
      float un = __fmul_rn(u, __fdiv_rn(1.0f, indpb));
      un = fminf(fmaxf(un, 2.9802322387695312e-08f), 1.0f);
      // mu + sigma * sqrt(2) * erf_inv(2un - 1), with XLA's association:
      // the two scalars multiply first, the rest is one FMA
      float e = xla_erf_inv(__fadd_rn(__fmul_rn(2.0f, un), -1.0f));
      v = __fadd_rn(v, __fmaf_rn(e, __fmul_rn(sigma, 1.4142135381698608f), mu));
    }
  }
  return v;
}

template <typename T>
__global__ void vary_kernel(const T* __restrict__ parents, T* __restrict__ out,
                            long long n, int dim, Storage st,
                            const int* __restrict__ seed,
                            const float* __restrict__ knobs,
                            long long row_base0) {
  const uint32_t s = (uint32_t)seed[0];
  const long long total = n * (long long)dim;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    long long r = i / dim;
    int c = (int)(i - r * dim);
    float own = widen(parents[i], st);
    float partner = widen(parents[(r ^ 16) * dim + c], st);
    out[i] = narrow<T>(vary_element(own, partner, r, c, dim, s, knobs,
                                    row_base0), st);
  }
}

template <typename T>
__global__ void gather_vary_kernel(const int* __restrict__ order,
                                   const int* __restrict__ pos,
                                   const T* __restrict__ genome,
                                   T* __restrict__ out, int* __restrict__ widx,
                                   long long out_n, int dim, Storage st,
                                   const int* __restrict__ seed,
                                   const float* __restrict__ knobs,
                                   long long row_base0) {
  const uint32_t s = (uint32_t)seed[0];
  const long long total = out_n * (long long)dim;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    long long r = i / dim;
    int c = (int)(i - r * dim);
    long long w = order[pos[r]];
    long long wp = order[pos[r ^ 16]];
    if (c == 0) widx[r] = (int)w;
    float own = widen(genome[w * dim + c], st);
    float partner = widen(genome[wp * dim + c], st);
    out[i] = narrow<T>(vary_element(own, partner, r, c, dim, s, knobs,
                                    row_base0), st);
  }
}

constexpr int kThreads = 256;

int grid_for(long long total) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (total + kThreads - 1) / kThreads;
  long long cap = (long long)sms * 32;     // grid-stride beyond 32 blocks/SM
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 int8
extern "C" int megakernel_vary(const void* parents, void* out, long long n,
                               int dim, int dtype, float scale,
                               float inv_scale, const int* seed,
                               const float* knobs, long long row_base0,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Storage s{scale, inv_scale};
  long long total = n * (long long)dim;
  if (total == 0) return 0;
  int grid = grid_for(total);
  switch (dtype) {
    case 0:
      vary_kernel<float><<<grid, kThreads, 0, st>>>(
          (const float*)parents, (float*)out, n, dim, s, seed, knobs,
          row_base0);
      break;
    case 1:
      vary_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
          (const __nv_bfloat16*)parents, (__nv_bfloat16*)out, n, dim, s, seed,
          knobs, row_base0);
      break;
    case 2:
      vary_kernel<int8_t><<<grid, kThreads, 0, st>>>(
          (const int8_t*)parents, (int8_t*)out, n, dim, s, seed, knobs,
          row_base0);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int megakernel_gather_vary(const int* order, const int* pos,
                                      const void* genome, void* out, int* widx,
                                      long long out_n, int dim, int dtype,
                                      float scale, float inv_scale,
                                      const int* seed, const float* knobs,
                                      long long row_base0, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Storage s{scale, inv_scale};
  long long total = out_n * (long long)dim;
  if (total == 0) return 0;
  int grid = grid_for(total);
  switch (dtype) {
    case 0:
      gather_vary_kernel<float><<<grid, kThreads, 0, st>>>(
          order, pos, (const float*)genome, (float*)out, widx, out_n, dim, s,
          seed, knobs, row_base0);
      break;
    case 1:
      gather_vary_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
          order, pos, (const __nv_bfloat16*)genome, (__nv_bfloat16*)out, widx,
          out_n, dim, s, seed, knobs, row_base0);
      break;
    case 2:
      gather_vary_kernel<int8_t><<<grid, kThreads, 0, st>>>(
          order, pos, (const int8_t*)genome, (int8_t*)out, widx, out_n, dim, s,
          seed, knobs, row_base0);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* megakernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
