// Fused generation kernels for Hopper (sm_90a): the CUDA counterparts of
// the three Pallas kernels of deap_tpu/ops/generation_pallas.py.
//
//   megakernel_vary         (K1) replaces _megakernel_host: variation of
//                                parents already gathered.
//   megakernel_gather_vary  (K2) replaces _megakernel_dma: per output row the
//                                winner order[pos[r]], the gather of its
//                                genome row, then K1's variation.
//   megakernel_var_or       (K3) replaces _var_or_pallas: per output row the
//                                OR choice of var_or (crossover with a
//                                partner, first child; Gaussian mutation; or
//                                a copy) over parent rows gathered in-kernel.
//
// Every draw is the JAX package's counter hash of (seed, draw, row, lane),
// so the kernels compute what _vary_tile and _var_or_tile compute, not
// their tile structure.  K3 is laid out by row as K1 and K2 are by pair
// (below, at its kernel).
//
// K1 and K2 are one kernel body (pair_vary_kernel), laid out by mating
// pair; a template flag says where row r's source comes from (K2: genome
// row order[pos[r]], written to widx; K1: parent row r).  A block owns 256
// rows (eight 32-row quanta): first one thread a row resolves its gate
// (draw 2) and, for K2, its winner, and one thread a pair draw 1 at lanes
// 0..2 and the cut points, into shared memory, so the block's index loads
// are in flight together and every hash runs once per pair or row; then
// the warps vary the pairs (a, a + 16).  A pair is read once, with the
// widest vector access that the row pitch and the base addresses allow (16
// bytes for float32 rows of 100 genes; 8 and 4 bytes for the 200-byte
// bfloat16 and 100-byte int8 rows, whose odd rows are not 16-byte aligned),
// over 1 << lane_bits lanes: 32 lanes for rows of more than 16 vectors (a
// compile-time constant there), else the fewest powers of two that cover
// the row, so that one warp takes several pairs (eight pairs of four lanes
// at the NSGA-II head's 12 genes).  A warp issues its next item's two row
// loads before it varies this one, swaps in registers and writes both
// children from registers; the items are walked by counters, without a
// division.  Draw 3 runs only in gated rows; erf_inv runs only for masked
// genes, one masked gene of each lane per pass of the warp.
//
// Bound on the card: bytes.  Each element is read once from the parents (K1)
// or the parent row (K2, K3) and written once; K2 adds the order/pos/widx
// words, K3 the ia/i2/code words and, in crossover rows, the partner's
// swapped genes.  At 1e6 x 100 in float32 that is about 0.8 GB a call.
// The index loads and the cut hashes are paid once per pair or row, so what
// is left per gene is the load, the swap select, the widening and narrowing
// and, in gated (K1, K2) or mutation (K3) rows, the gene draw.
// On an H100 at 1e6 x 100: one thread an element, K1 took 0.74 ms in each
// type (four hashes and a division a gene, every gene read twice); in the
// pair layout 0.30 / 0.26 / 0.29 ms (float32 / bfloat16 / int8).  K2's
// block pass and one-pair-ahead row loads took 12% off float32 and 4-9% off
// the narrow types against a first form that walked three dependent loads a
// pair (pos, order, the rows).  A runtime lane count with a division a work
// item added 10% to the narrow types, which are bound by per-gene
// instructions: the full-warp layout is a compile-time case and the items
// are counted.  float32 runs at ~3/4 of its byte bound, with or without
// mutation; bfloat16 and int8 do not (draw 3 in gated rows, the widening
// and narrowing, erf_inv passes in which most lanes idle).  Queueing the
// masked genes in shared memory to fill erf_inv's passes took 5% off the
// narrow types and added 8% to float32, the flagship's storage: not kept.
// The reads are not staged through shared memory (no cp.async or TMA):
// each row is used once, straight from registers.
//
// Arithmetic: uint32 wrap-around hashing, (bits >> 8) * 2^-24 uniforms,
// floor(u * dim) cut points, and XLA's float32 erf_inv (Giles' polynomial
// over XLA's Cephes log1p/log), with __fmaf_rn exactly where XLA's CPU
// backend fuses a multiply into an add and explicitly rounded operations
// everywhere else.  Built with --fmad=false, the kernels equal their plain
// PyTorch versions bit for bit (deap_tpu_torch/ops/generation.py).
//
// A plain C interface (no PyTorch headers): the wrapper in
// deap_tpu_torch/kernels/__init__.py passes device pointers and the stream,
// and raises on a non-zero return (cudaGetLastError after the launch).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "device_math.cuh"

namespace {

// ---- XLA's float32 log1p and erf_inv ---------------------------------------
// Constants are float32 values; the operation order is XLA CPU's.

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

// ---- the tile function -----------------------------------------------------
// knobs: [cxpb, mutpb, mu, sigma, indpb].

// the two-point crossover's swapped columns [lo, hi) from draw 1, lanes 1, 2
__device__ __forceinline__ void cut_range(float u1, float u2, int dim,
                                          int* lo, int* hi) {
  int c1 = 1 + (int)floorf(__fmul_rn(u1, (float)dim));
  c1 = c1 < dim ? c1 : dim;
  int c2 = 1 + (int)floorf(__fmul_rn(u2, (float)(dim - 1)));
  c2 = c2 < dim - 1 ? c2 : dim - 1;
  if (c2 >= c1) c2 += 1;
  *lo = c1 < c2 ? c1 : c2;
  *hi = c1 < c2 ? c2 : c1;
}

// v plus the Gaussian noise of a masked gene whose draw is u < indpb:
// mu + sigma * sqrt(2) * erf_inv(2un - 1), with XLA's association (the two
// scalars multiply first, the rest is one FMA)
__device__ __forceinline__ float add_noise(float v, float u, float mu,
                                           float sigma, float indpb) {
  float un = __fmul_rn(u, __fdiv_rn(1.0f, indpb));
  un = fminf(fmaxf(un, 2.9802322387695312e-08f), 1.0f);
  float e = xla_erf_inv(__fadd_rn(__fmul_rn(2.0f, un), -1.0f));
  return __fadd_rn(v, __fmaf_rn(e, __fmul_rn(sigma, 1.4142135381698608f), mu));
}

// ---- K1 and K2: mating pairs over the lanes of a warp ----------------------

template <int V> struct VecOf;
template <> struct VecOf<16> { using type = uint4; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<4> { using type = unsigned int; };
template <> struct VecOf<2> { using type = unsigned short; };
template <> struct VecOf<1> { using type = unsigned char; };

// an element's stored bits
template <typename T> struct RawOf { using type = T; };
template <> struct RawOf<__nv_bfloat16> { using type = unsigned short; };

// V bytes of a row: one vector access, or its V / sizeof(T) elements
template <typename T, int V>
union Pack {
  typename VecOf<V>::type v;
  typename RawOf<T>::type e[V / sizeof(T)];
};

__device__ __forceinline__ float widen_raw(float v, const Storage&) {
  return v;
}
__device__ __forceinline__ float widen_raw(unsigned short v,
                                           const Storage&) {
  return __bfloat162float(__ushort_as_bfloat16(v));
}
__device__ __forceinline__ float widen_raw(int8_t v, const Storage& s) {
  return __fmul_rn((float)v, s.scale);
}
template <typename T>
__device__ __forceinline__ typename RawOf<T>::type narrow_raw(
    float v, const Storage& s) {
  return narrow<T>(v, s);
}
template <>
__device__ __forceinline__ unsigned short narrow_raw<__nv_bfloat16>(
    float v, const Storage& s) {
  return __bfloat16_as_ushort(narrow<__nv_bfloat16>(v, s));
}

constexpr int kPairWarps = 8;                 // warps a block
constexpr int kBatchRows = 256;               // rows a block: 8 quanta
constexpr int kBatchPairs = kBatchRows / 2;

// K1 (kGather false: output row r varies parent row r) and K2 (kGather
// true: output row r varies genome row order[pos[r]], written to widx[r])
// share this body.  A warp takes 32 >> lane_bits mating pairs at a time,
// 1 << lane_bits lanes each; a lane moves one V-byte vector of both rows of
// its pair.  kFull: one pair a warp (lane_bits 5, a compile-time constant:
// rows of more than 16 vectors, the flagship's).
template <typename T, int V, bool kGather, bool kFull>
__global__ void __launch_bounds__(kPairWarps * 32)
pair_vary_kernel(const int* __restrict__ order, const int* __restrict__ pos,
                 const T* __restrict__ genome, T* __restrict__ out,
                 int* __restrict__ widx, long long out_n, int dim,
                 Storage st, const int* __restrict__ seed,
                 const float* __restrict__ knobs, long long row_base0,
                 int lane_bits_arg) {
  using Vec = typename VecOf<V>::type;
  constexpr int E = V / (int)sizeof(T);       // elements a vector access
  __shared__ int s_w[kGather ? kBatchRows : 1];   // winner of each row
  __shared__ unsigned char s_gate[kBatchRows];
  __shared__ int s_lo[kBatchPairs], s_hi[kBatchPairs];   // swapped columns
  const uint32_t s = (uint32_t)seed[0];
  const float cxpb = knobs[0], mutpb = knobs[1], mu = knobs[2],
              sigma = knobs[3], indpb = knobs[4];
  const long long row0 = (long long)blockIdx.x * kBatchRows;
  const int t = threadIdx.x;
  // 1. per row, one thread: the winner (K2), the gate (draw 2) and, in
  //    a-rows, draw 1 at lanes 0..2 and the cut points; all rows' index
  //    loads are in flight together
  if (row0 + t < out_n) {
    const long long r = row0 + t;
    if (kGather) {
      const int w = order[pos[r]];
      widx[r] = w;
      s_w[t] = w;
    }
    const uint32_t row = (uint32_t)(r + row_base0);
    s_gate[t] = uniform_at(s, 2u, row, 0u) < mutpb;
    if (!(t & 16)) {
      int lo, hi;
      cut_range(uniform_at(s, 1u, row, 1u), uniform_at(s, 1u, row, 2u), dim,
                &lo, &hi);
      if (!(uniform_at(s, 1u, row, 0u) < cxpb)) hi = lo;   // no mating
      const int pi = ((t >> 5) << 4) | (t & 15);
      s_lo[pi] = lo;
      s_hi[pi] = hi;
    }
  }
  __syncthreads();
  // 2. warp w varies the pair groups w, w + 8, ... of the block: item
  //    (group, chunk of 1 << lane_bits vectors), lane (pair of the group,
  //    vector of the chunk), walked without a division; the next item's
  //    two row loads are issued before this item is varied
  const int lane_bits = kFull ? 5 : lane_bits_arg;
  const int lane = t & 31, warp = t >> 5;
  const int sub = lane >> lane_bits, vl = lane & ((1 << lane_bits) - 1);
  const int per_group = 32 >> lane_bits;
  const long long left = out_n - row0;
  const int pairs_here = (left < kBatchRows ? (int)left : kBatchRows) / 2;
  const int groups = (pairs_here + per_group - 1) / per_group;
  const int nvec = dim / E;
  const int nch = ((nvec - 1) >> lane_bits) + 1;
  const int my_groups = (groups - warp + kPairWarps - 1) / kPairWarps;
  const int items = my_groups > 0 ? my_groups * nch : 0;
  auto src = [&](int local) -> const T* {
    if constexpr (kGather) return genome + (long long)s_w[local] * dim;
    else return genome + (row0 + local) * dim;
  };
  // the lane's pair and vector in the item to vary (pi, vi) and in the
  // next one to fetch (npi, nvi), and the next one's chunk
  int pi = warp * per_group + sub, vi = vl;
  int npi = pi, nvi = vi, nch_at = 0;
  Vec na{}, nb{};
  auto fetch = [&]() {
    if (npi < pairs_here && nvi < nvec) {
      const int al = ((npi >> 4) << 5) | (npi & 15);
      na = __ldg(reinterpret_cast<const Vec*>(src(al)) + nvi);
      nb = __ldg(reinterpret_cast<const Vec*>(src(al + 16)) + nvi);
    }
  };
  if (items) fetch();
  for (int it = 0; it < items; ++it, pi = npi, vi = nvi) {
    Pack<T, V> pa, pb;
    pa.v = na;
    pb.v = nb;
    if (++nch_at == nch) {
      nch_at = 0;
      npi += kPairWarps * per_group;
      nvi = vl;
    } else {
      nvi += 1 << lane_bits;
    }
    if (it + 1 < items) fetch();
    if (pi >= pairs_here || vi >= nvec) continue;
    const int al = ((pi >> 4) << 5) | (pi & 15);
    const int lo = s_lo[pi], hi = s_hi[pi];
    const bool gate_a = s_gate[al], gate_b = s_gate[al + 16];
    const long long a = row0 + al;
    const uint32_t ra = (uint32_t)(a + row_base0), rb = ra + 16u;
    const int c0 = vi * E;
    float xa[E], xb[E];
    unsigned m = 0;           // masked genes: bit e of row a, E + e of row b
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float own = widen_raw(pa.e[e], st);
      const float par = widen_raw(pb.e[e], st);
      const bool swap = c0 + e >= lo && c0 + e < hi;
      xa[e] = swap ? par : own;
      xb[e] = swap ? own : par;
      if (gate_a && uniform_at(s, 3u, ra, (uint32_t)(c0 + e)) < indpb)
        m |= 1u << e;
      if (gate_b && uniform_at(s, 3u, rb, (uint32_t)(c0 + e)) < indpb)
        m |= 1u << (E + e);
    }
    // one masked gene of each lane per pass: the warp runs erf_inv as many
    // times as its busiest lane has masked genes
    while (m) {
      const int bit = __ffs(m) - 1;
      m &= m - 1;
      const bool in_b = bit >= E;
      const int e = in_b ? bit - E : bit;
      float v = 0.0f;
#pragma unroll
      for (int q = 0; q < E; ++q)
        if (q == e) v = in_b ? xb[q] : xa[q];
      v = add_noise(v, uniform_at(s, 3u, in_b ? rb : ra, (uint32_t)(c0 + e)),
                    mu, sigma, indpb);
#pragma unroll
      for (int q = 0; q < E; ++q)
        if (q == e) {
          if (in_b) xb[q] = v;
          else xa[q] = v;
        }
    }
    Pack<T, V> oa, ob;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      oa.e[e] = narrow_raw<T>(xa[e], st);
      ob.e[e] = narrow_raw<T>(xb[e], st);
    }
    reinterpret_cast<Vec*>(out + a * dim)[vi] = oa.v;
    reinterpret_cast<Vec*>(out + (a + 16) * dim)[vi] = ob.v;
  }
}

// the widest access (bytes) that divides the row pitch and both base
// addresses; at most 8 elements, so the row buffers stay in registers
int pair_vector_bytes(int elt, int dim, const void* genome, const void* out) {
  int v = elt == 1 ? 8 : 16;
  while (v > elt && ((dim * elt) % v || (uintptr_t)genome % v ||
                     (uintptr_t)out % v))
    v >>= 1;
  return v;
}

// log2 of the lanes a pair takes: the fewest powers of two that cover the
// row's nvec vectors, at most 32 (a wider row is walked in chunks of 32)
int pair_lane_bits(int nvec) {
  int b = 0;
  while (b < 5 && (1 << b) < nvec) ++b;
  return b;
}

template <typename T, int V, bool kGather>
void launch_pairs(const int* order, const int* pos, const void* genome,
                  void* out, int* widx, long long out_n, int dim, Storage s,
                  const int* seed, const float* knobs, long long row_base0,
                  cudaStream_t st) {
  const long long blocks = (out_n + kBatchRows - 1) / kBatchRows;
  const int lane_bits = pair_lane_bits(dim / (V / (int)sizeof(T)));
  auto kernel = lane_bits == 5 ? pair_vary_kernel<T, V, kGather, true>
                               : pair_vary_kernel<T, V, kGather, false>;
  kernel<<<(unsigned)blocks, kPairWarps * 32, 0, st>>>(
      order, pos, (const T*)genome, (T*)out, widx, out_n, dim, s, seed,
      knobs, row_base0, lane_bits);
}

// K1 and K2's launch: the storage type and the vector width from the row
// pitch and the base addresses
template <bool kGather>
int launch_pair_kernel(const int* order, const int* pos, const void* genome,
                       void* out, int* widx, long long out_n, int dim,
                       int dtype, Storage s, const int* seed,
                       const float* knobs, long long row_base0,
                       cudaStream_t st) {
  if (out_n <= 0 || dim <= 0) return 0;
  if (out_n % 32 || (out_n + kBatchRows - 1) / kBatchRows > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  const int elt = dtype == 0 ? 4 : (dtype == 1 ? 2 : 1);
  const int v = pair_vector_bytes(elt, dim, genome, out);
#define PAIR_ARGS order, pos, genome, out, widx, out_n, dim, s, seed, knobs, \
                  row_base0, st
  switch (dtype * 32 + v) {
    case 0 * 32 + 16: launch_pairs<float, 16, kGather>(PAIR_ARGS); break;
    case 0 * 32 + 8: launch_pairs<float, 8, kGather>(PAIR_ARGS); break;
    case 0 * 32 + 4: launch_pairs<float, 4, kGather>(PAIR_ARGS); break;
    case 1 * 32 + 16: launch_pairs<__nv_bfloat16, 16, kGather>(PAIR_ARGS); break;
    case 1 * 32 + 8: launch_pairs<__nv_bfloat16, 8, kGather>(PAIR_ARGS); break;
    case 1 * 32 + 4: launch_pairs<__nv_bfloat16, 4, kGather>(PAIR_ARGS); break;
    case 1 * 32 + 2: launch_pairs<__nv_bfloat16, 2, kGather>(PAIR_ARGS); break;
    case 2 * 32 + 8: launch_pairs<int8_t, 8, kGather>(PAIR_ARGS); break;
    case 2 * 32 + 4: launch_pairs<int8_t, 4, kGather>(PAIR_ARGS); break;
    case 2 * 32 + 2: launch_pairs<int8_t, 2, kGather>(PAIR_ARGS); break;
    case 2 * 32 + 1: launch_pairs<int8_t, 1, kGather>(PAIR_ARGS); break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PAIR_ARGS
  return (int)cudaGetLastError();
}

// ---- K3: the OR-choice variation of var_or ---------------------------------
// Per output row r: code[r] 0 = crossover (first child of genome[ia[r]] with
// partner genome[i2[r]]), 1 = Gaussian mutation of genome[ia[r]], 2 = copy.
// The parent rows are gathered here, so no (lambda, dim) copy of either
// parent is materialised.  The cut pair is draw 4 at lanes 0 and 1 of the
// row, the gene grid draw 5, both at absolute row coordinates.  knobs: [mu,
// sigma, indpb].  The narrowing is GenomeStorage.to_storage's (int8:
// rint of the rounded quotient v / scale), not K1's rint(v * (1 / scale));
// the two differ where v * (1 / scale) lies near a half-integer, so K3
// takes the product and falls back to the division only there.
//
// K1/K2's one-pass layout in a kernel of its own (K3 does not share their
// body: a runtime layout there costs K2 10%): a block owns 256 rows; first
// one thread a row reads code, ia and, in crossover rows, i2, and hashes
// the cut pair, into one shared int4; then the block's rows are walked as
// one run of V-byte vectors, consecutive threads on consecutive vectors
// (no lane idles at any dim; a vector's row is a float estimate of the
// quotient, corrected by one, not a division).  The partner's vector is
// read only where it meets the cut, draw 5 runs only in mutation rows,
// erf_inv one masked gene of each lane per pass; the next vector's loads
// are issued before this one is varied.  On an H100 at 1e6 x 100 (float32 /
// bfloat16 / int8): one thread a gene took 0.58 / 0.53 / 0.60 ms; a lane
// group a row, as K1/K2, 0.39 / 0.35 / 0.42 (idle lanes: 25 vectors on 32);
// this walk 0.36 / 0.31 / 0.37, and 0.35 for int8 by the product.  Loading
// a group of vectors (32 bytes a thread) before varying them was slower in
// every type (0.45 / 0.40 / 0.71).

template <typename T>
__device__ __forceinline__ T store_narrow(float v, const Storage& s);
template <> __device__ __forceinline__ float store_narrow<float>(
    float v, const Storage&) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
store_narrow<__nv_bfloat16>(float v, const Storage&) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ int8_t store_narrow<int8_t>(
    float v, const Storage& s) {
  // rint(v / scale) from v * (1 / scale) where that is more than 1e-4 from
  // a half-integer (the two quotients differ by < 5e-5 below 256)
  float p = __fmul_rn(v, s.inv_scale);
  const float f = __fsub_rn(p, floorf(p));
  if (!(fabsf(p) < 256.0f) || fabsf(__fsub_rn(f, 0.5f)) < 1e-4f)
    p = __fdiv_rn(v, s.scale);
  float q = rintf(p);                              // round half to even
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return (int8_t)q;
}
template <typename T>
__device__ __forceinline__ typename RawOf<T>::type store_narrow_raw(
    float v, const Storage& s) {
  return store_narrow<T>(v, s);
}
template <>
__device__ __forceinline__ unsigned short store_narrow_raw<__nv_bfloat16>(
    float v, const Storage& s) {
  return __bfloat16_as_ushort(store_narrow<__nv_bfloat16>(v, s));
}

constexpr int kOrRows = 256;                  // rows a block, a thread each

template <typename T, int V>
__global__ void __launch_bounds__(kOrRows)
var_or_kernel(const T* __restrict__ genome, const int* __restrict__ ia,
              const int* __restrict__ i2, const int* __restrict__ code,
              T* __restrict__ out, long long lam, int dim, Storage st,
              const int* __restrict__ seed, const float* __restrict__ knobs,
              float inv_nvec) {
  using Vec = typename VecOf<V>::type;
  constexpr int E = V / (int)sizeof(T);       // elements a vector access
  // per row: parent, partner (-1 in a mutation row), taken columns [lo, hi)
  __shared__ int4 s_row[kOrRows];
  const uint32_t s = (uint32_t)seed[0];
  const float mu = knobs[0], sigma = knobs[1], indpb = knobs[2];
  const long long row0 = (long long)blockIdx.x * kOrRows;
  const int t = threadIdx.x;
  // 1. per row, one thread: the choice, the parent and, in crossover rows,
  //    the partner and the cut pair (draw 4, lanes 0 and 1)
  if (row0 + t < lam) {
    const long long r = row0 + t;
    const int cr = code[r];
    const int a = ia[r];
    int lo = 0, hi = 0, b = cr == 1 ? -1 : a;
    if (cr == 0) {
      cut_range(uniform_at(s, 4u, (uint32_t)r, 0u),
                uniform_at(s, 4u, (uint32_t)r, 1u), dim, &lo, &hi);
      b = i2[r];
    }
    s_row[t] = make_int4(a, b, lo, hi);
  }
  __syncthreads();
  // 2. the block's rows as one run of V-byte vectors, a thread every
  //    kOrRows-th: consecutive threads take consecutive vectors (a row's
  //    vectors, then the next row's), no lane idles; a vector's row is a
  //    float estimate of v / nvec, corrected by one; the next vector's
  //    loads are issued before this one is varied
  const long long left = lam - row0;
  const int rows_here = left < kOrRows ? (int)left : kOrRows;
  const int nvec = dim / E;
  const int total = rows_here * nvec;
  int nv = t, nrl = 0, nc0 = 0;
  int4 nm = make_int4(0, 0, 0, 0);
  Vec na{}, nb{};
  auto fetch = [&]() {
    if (nv >= total) return;
    int q = __float2int_rz(__int2float_rn(nv) * inv_nvec);
    if (q * nvec > nv) --q;
    else if ((q + 1) * nvec <= nv) ++q;
    nrl = q;
    nc0 = (nv - q * nvec) * E;
    nm = s_row[q];
    na = __ldg(reinterpret_cast<const Vec*>(genome + (long long)nm.x * dim +
                                            nc0));
    if (nc0 < nm.w && nc0 + E > nm.z)
      nb = __ldg(reinterpret_cast<const Vec*>(genome + (long long)nm.y * dim +
                                              nc0));
  };
  fetch();
  while (nv < total) {
    Pack<T, V> pa, pb;
    pa.v = na;
    pb.v = nb;
    const int rl = nrl, c0 = nc0;
    const int4 m = nm;
    nv += kOrRows;
    fetch();
    const long long r = row0 + rl;
    const bool mut = m.y < 0;
    float x[E], u[E];
    unsigned mask = 0;                        // masked genes
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const bool take = c0 + e >= m.z && c0 + e < m.w;
      x[e] = widen_raw(take ? pb.e[e] : pa.e[e], st);
      u[e] = 1.0f;
      if (mut) {
        u[e] = uniform_at(s, 5u, (uint32_t)r, (uint32_t)(c0 + e));
        if (u[e] < indpb) mask |= 1u << e;
      }
    }
    // one masked gene of each lane per pass
    while (mask) {
      const int e = __ffs(mask) - 1;
      mask &= mask - 1;
#pragma unroll
      for (int q = 0; q < E; ++q)
        if (q == e) x[q] = add_noise(x[q], u[q], mu, sigma, indpb);
    }
    Pack<T, V> o;
#pragma unroll
    for (int e = 0; e < E; ++e) o.e[e] = store_narrow_raw<T>(x[e], st);
    *reinterpret_cast<Vec*>(out + r * dim + c0) = o.v;
  }
}

template <typename T, int V>
void launch_var_or_kernel(const void* genome, const int* ia, const int* i2,
                          const int* code, void* out, long long lam, int dim,
                          Storage s, const int* seed, const float* knobs,
                          cudaStream_t st) {
  const long long blocks = (lam + kOrRows - 1) / kOrRows;
  const float inv_nvec = 1.0f / (float)(dim / (V / (int)sizeof(T)));
  var_or_kernel<T, V><<<(unsigned)blocks, kOrRows, 0, st>>>(
      (const T*)genome, ia, i2, code, (T*)out, lam, dim, s, seed, knobs,
      inv_nvec);
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 int8; n a multiple of 32
extern "C" int megakernel_vary(const void* parents, void* out, long long n,
                               int dim, int dtype, float scale,
                               float inv_scale, const int* seed,
                               const float* knobs, long long row_base0,
                               void* stream) {
  return launch_pair_kernel<false>(nullptr, nullptr, parents, out, nullptr, n,
                                   dim, dtype, Storage{scale, inv_scale},
                                   seed, knobs, row_base0,
                                   (cudaStream_t)stream);
}

extern "C" int megakernel_gather_vary(const int* order, const int* pos,
                                      const void* genome, void* out, int* widx,
                                      long long out_n, int dim, int dtype,
                                      float scale, float inv_scale,
                                      const int* seed, const float* knobs,
                                      long long row_base0, void* stream) {
  return launch_pair_kernel<true>(order, pos, genome, out, widx, out_n, dim,
                                  dtype, Storage{scale, inv_scale}, seed,
                                  knobs, row_base0, (cudaStream_t)stream);
}

extern "C" int megakernel_var_or(const void* genome, const int* ia,
                                 const int* i2, const int* code, void* out,
                                 long long lam, int dim, int dtype,
                                 float scale, const int* seed,
                                 const float* knobs, void* stream) {
  if (lam <= 0 || dim <= 0) return 0;
  // a block's vectors, kOrRows rows of them, are counted in an int, which
  // runs up to a stride past the last (one element a vector at worst)
  if ((lam + kOrRows - 1) / kOrRows > 0x7FFFFFFF ||
      (long long)dim * kOrRows + kOrRows >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int elt = dtype == 0 ? 4 : (dtype == 1 ? 2 : 1);
  const int v = pair_vector_bytes(elt, dim, genome, out);
  const Storage s{scale, 1.0f / scale};
#define OR_ARGS genome, ia, i2, code, out, lam, dim, s, seed, knobs, \
                (cudaStream_t)stream
  switch (dtype * 32 + v) {
    case 0 * 32 + 16: launch_var_or_kernel<float, 16>(OR_ARGS); break;
    case 0 * 32 + 8: launch_var_or_kernel<float, 8>(OR_ARGS); break;
    case 0 * 32 + 4: launch_var_or_kernel<float, 4>(OR_ARGS); break;
    case 1 * 32 + 16:
      launch_var_or_kernel<__nv_bfloat16, 16>(OR_ARGS);
      break;
    case 1 * 32 + 8: launch_var_or_kernel<__nv_bfloat16, 8>(OR_ARGS); break;
    case 1 * 32 + 4: launch_var_or_kernel<__nv_bfloat16, 4>(OR_ARGS); break;
    case 1 * 32 + 2: launch_var_or_kernel<__nv_bfloat16, 2>(OR_ARGS); break;
    case 2 * 32 + 8: launch_var_or_kernel<int8_t, 8>(OR_ARGS); break;
    case 2 * 32 + 4: launch_var_or_kernel<int8_t, 4>(OR_ARGS); break;
    case 2 * 32 + 2: launch_var_or_kernel<int8_t, 2>(OR_ARGS); break;
    case 2 * 32 + 1: launch_var_or_kernel<int8_t, 1>(OR_ARGS); break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef OR_ARGS
  return (int)cudaGetLastError();
}

extern "C" const char* megakernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
