// Device functions shared by the port's kernels, with their plain PyTorch
// twins named beside each:
//
//   mix32 / uniform_at  the JAX package's counter hash of (seed, draw, row,
//                       lane) and its 2^-24 uniform (deap_tpu_torch/ops/
//                       generation.py: _mix32, _uniform_at);
//   xla_log             XLA CPU's float32 natural logarithm, the Cephes
//                       polynomial (deap_tpu_torch/_xla_math.py: log);
//   xla_sincos          glibc's sinf/cosf (ARM's optimized routines), which
//                       XLA's CPU backend calls: the argument reduction and
//                       the polynomial in double, one rounding
//                       (deap_tpu_torch/_xla_math.py: sin, cos);
//   cos_reduced         xla_sincos(y, true) for |y| < 120 without a branch
//                       (the same bits; P1's rastrigin reduce and P2's law
//                       in kernels/probes.cu).
//
// Float32 constants are float32 values and the operation order is XLA's,
// with __fmaf_rn exactly where XLA's CPU backend fuses a multiply into an
// add and explicitly rounded operations everywhere else: the sources are
// built with --fmad=false, so nothing else is contracted.  Everything is in
// an anonymous namespace: each source that includes this file gets its own
// copy.

#pragma once

#include <cuda_runtime.h>
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

// ---- XLA's float32 log (Cephes) -------------------------------------------

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

// ---- glibc's sinf/cosf (ARM optimized routines), in double ----------------

constexpr uint32_t kTopTiny = 0x398, kTopPoly = 0x3F4, kTopFast = 0x42F,
                   kTopInf = 0x7F8;
constexpr double kHpiInv = 0x1.45F306DC9C883p+23;   // 2/pi * 2^24
constexpr double kHpi = 0x1.921FB54442D18p0;        // pi/2
constexpr double kPi63 = 0x1.921FB54442D18p-62;     // 2pi * 2^-64
constexpr double kC0 = 0x1p0, kC1 = -0x1.ffffffd0c621cp-2,
                 kC2 = 0x1.55553e1068f19p-5, kC3 = -0x1.6c087e89a359dp-10,
                 kC4 = 0x1.99343027bf8c3p-16;
constexpr double kS1 = -0x1.555545995a603p-3, kS2 = 0x1.1107605230bc4p-7,
                 kS3 = -0x1.994eb3774cf24p-13;

__constant__ uint32_t kInvPio4[24] = {
    0xa2,       0xa2f9,     0xa2f983,   0xa2f9836e, 0xf9836e4e, 0x836e4e44,
    0x6e4e4415, 0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1,
    0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62,
    0xc0db6295, 0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041};

__device__ __forceinline__ double dmul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double dadd(double a, double b) {
  return __dadd_rn(a, b);
}

// |y| >= 120: y's bits times 4/pi in a 32 x 96 -> 128-bit product.
__device__ double reduce_large(uint32_t xi, int* np) {
  const uint32_t* arr = &kInvPio4[(xi >> 26) & 15];
  const int shift = (xi >> 23) & 7;
  xi = (xi & 0xffffff) | 0x800000;
  xi <<= shift;
  uint64_t res0 = xi * arr[0];              // a 32-bit product, as in glibc
  const uint64_t res1 = (uint64_t)xi * arr[4];
  const uint64_t res2 = (uint64_t)xi * arr[8];
  res0 = (res2 >> 32) | (res0 << 32);
  res0 += res1;
  const uint64_t n = (res0 + (1ULL << 61)) >> 62;
  res0 -= n << 62;
  *np = (int)n;
  return dmul(__ll2double_rn((long long)res0), kPi63);
}

__device__ float xla_sincos(float y, bool want_cos) {
  const uint32_t bits = __float_as_uint(y);
  const uint32_t top = (bits >> 20) & 0x7ff;
  if (top >= kTopInf) return __int_as_float(0x7FC00000);
  if (top < kTopTiny) return want_cos ? 1.0f : y;
  const double x = (double)y;
  double xs, x2;
  int n = 0;
  bool neg_cos = false;
  if (top < kTopPoly) {                     // |y| < 0.75: no reduction
    xs = x;
    x2 = dmul(x, x);
  } else {
    double xr;
    int quadrant;
    if (top < kTopFast) {                   // |y| < 120
      const double r = dmul(x, kHpiInv);
      n = (__double2int_rz(r) + 0x800000) >> 24;
      xr = dadd(x, -dmul((double)n, kHpi));
      quadrant = n;
    } else {
      xr = reduce_large(bits, &n);
      quadrant = n + (int)(bits >> 31);
    }
    const int q = quadrant & 3;
    xs = dmul(xr, (q == 1 || q == 2) ? -1.0 : 1.0);
    x2 = dmul(xr, xr);
    neg_cos = (quadrant & 2) != 0;
  }
  if (want_cos) n ^= 1;
  double v;
  if ((n & 1) == 0) {
    const double x3 = dmul(xs, x2);
    const double s1 = dadd(kS2, dmul(x2, kS3));
    const double x7 = dmul(x3, x2);
    const double s = dadd(xs, dmul(x3, kS1));
    v = dadd(s, dmul(x7, s1));
  } else {
    const double c = neg_cos ? -1.0 : 1.0;
    const double x4 = dmul(x2, x2);
    const double c2 = dadd(c * kC3, dmul(x2, c * kC4));
    const double c1 = dadd(c * kC0, dmul(x2, c * kC1));
    const double x6 = dmul(x4, x2);
    const double cc = dadd(c1, dmul(x4, c * kC2));
    v = dadd(cc, dmul(x6, c2));
  }
  return __double2float_rn(v);
}

// cos_reduced's float64 constants in constant memory, where an operation
// reads them as operands (as immediates each costs two register moves)
struct CosConsts {
  double hpi_inv, hpi, s1, s2, s3, c0, c1, c2, c3, c4;
};
__constant__ CosConsts kCosReduced = {kHpiInv, kHpi, kS1, kS2, kS3,
                                      kC0,     kC1,  kC2, kC3, kC4};

// |y| < 120 (no inf, no NaN): the inputs cos_reduced takes; 120.0f is
// abstop12 0x42F, the bound of xla_sincos's one-step reduction
__device__ __forceinline__ bool cos_reduced_takes(float y) {
  return fabsf(y) < 120.0f;
}

// xla_sincos(y, true) for |y| < 120, the same bits without branches.  Below
// 0.75 xla_sincos skips the reduction, but the reduction gives n = 0 there,
// hence xr = x and the same polynomial; below 2^-12 (abstop12 0x398) it
// returns 1, which the cosine's polynomial rounds to there too (1 - x^2 / 2
// lies above 1 - 2^-25).  Both polynomials are evaluated on xr and one is
// selected by n's parity (a warp holds both parities).  The signs that xla_sincos
// applies first (the sine's argument in quadrants n & 3 = 1 and 2, the
// cosine's coefficients in quadrant 2) are applied to the result: the
// rounding is symmetric and both sequences odd in the flipped operand, so
// each step's result flips with it.  n is the same signed quadrant as in
// xla_sincos (negative y included): n & 3 is 1 or 2 exactly when (n + 1) & 2.
__device__ __forceinline__ float cos_reduced(float y) {
  const double x = (double)y;
  const int n =
      (__double2int_rz(dmul(x, kCosReduced.hpi_inv)) + 0x800000) >> 24;
  const double xr = dadd(x, -dmul((double)n, kCosReduced.hpi));
  const double x2 = dmul(xr, xr);
  const double x3 = dmul(xr, x2);                  // the sine (n odd)
  const double s1 = dadd(kCosReduced.s2, dmul(x2, kCosReduced.s3));
  const double x7 = dmul(x3, x2);
  const double vs =
      dadd(dadd(xr, dmul(x3, kCosReduced.s1)), dmul(x7, s1));
  const double x4 = dmul(x2, x2);                  // the cosine (n even)
  const double c2 = dadd(kCosReduced.c3, dmul(x2, kCosReduced.c4));
  const double c1 = dadd(kCosReduced.c0, dmul(x2, kCosReduced.c1));
  const double x6 = dmul(x4, x2);
  const double vc =
      dadd(dadd(c1, dmul(x4, kCosReduced.c2)), dmul(x6, c2));
  const float v = __double2float_rn((n & 1) ? vs : vc);
  return ((n + 1) & 2) ? -v : v;
}

}  // namespace
