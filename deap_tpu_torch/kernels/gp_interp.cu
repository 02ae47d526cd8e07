// GP stack-machine interpreter for Hopper (sm_90a): the CUDA counterpart of
// the Pallas kernel of deap_tpu/gp/interp_pallas.py.
//
//   gp_interp  (K6) replaces the inner `kernel` of
//                   make_population_evaluator_pallas: pop prefix programs
//                   (codes int32, consts float32 (pop, cap), lengths int32
//                   (pop,)) evaluated on X float32 (n_args, n_points) ->
//                   float32 (pop, n_points).
//
// Each program is walked right to left over its `length` tokens; terminals
// push, a primitive of arity a replaces the a values on top of the stack
// (its leftmost child on top) by its result.  A program's opcode at a step
// is the same for all of its points, so one block takes one tree and a tile
// of kThreads points, one point per thread: the block stages the tree's
// tokens (opcode, and the constant or the X row) in shared memory once,
// every thread then reads the same token and the switch never diverges.
// The top of the stack stays in a register (as the Pallas kernel carries
// it); the rows below it live in shared memory laid out [depth][thread]
// (cap x kThreads x 4 bytes: 32 KB at cap 64), so a binary op reads one
// row, a unary op none and a push writes one.  The stack pointer is bounded
// to [0, cap]: a malformed program cannot write outside its stack (its
// result is unspecified).  A row of length 0 writes zeros and returns; the
// evaluator zeroes the lengths of rows whose fitness is still valid.
//
// Bound on the card: the tokens executed, sum of length over the rows run,
// times n_points, each charged at its opcode's instruction count (sin and
// cos are double-precision polynomials); the bytes (codes, consts, lengths
// and X in, the output out) are small beside them at the bench's shapes
// except for the output's 16 MB.
//
// Arithmetic: float32 add/sub/mul and the protected division (a true
// division, __fdiv_rn, where |b| > 1e-9) are IEEE operations; sin and cos
// are glibc's sinf/cosf (the argument reduction and the polynomial in
// double precision, one rounding), which XLA's CPU backend calls; log is
// XLA's Cephes float32 log and logistic 1 / (1 + exp(-x)) with XLA's Cephes
// exp, with __fmaf_rn where XLA contracts.  Built with --fmad=false, the
// kernel equals the plain interpreter (deap_tpu_torch/gp/interp.py, with
// deap_tpu_torch/_xla_math.py) bit for bit.
//
// A plain C interface (no PyTorch headers), built into one library with the
// other kernels by deap_tpu_torch/kernels/build.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// deap_tpu_torch/gp/interp_cuda.py's OPCODES
enum Op : int {
  kArg = 0, kConst, kAdd, kSub, kMul, kDiv, kNeg, kSin, kCos, kLog, kSqrt,
  kLf, kAnd, kOr, kXor, kNot, kIf
};

constexpr int kThreads = 128;
constexpr int kMaxDefaultSmem = 48 * 1024;

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

// ---- XLA's float32 log and exp (Cephes) ----------------------------------

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

__device__ float xla_exp(float x) {
  x = x < -87.80000305175781f ? -87.80000305175781f : x;   // NaN stays NaN
  x = x > 88.80000305175781f ? 88.80000305175781f : x;
  float fx = floorf(__fmaf_rn(x, 1.4426950216293335f, 0.5f));
  fx = fx < -127.0f ? -127.0f : fx;
  fx = fx > 127.0f ? 127.0f : fx;
  float r = __fmaf_rn(fx, -0.693359375f, x);
  r = __fmaf_rn(fx, 0.00021219444170128554f, r);
  float y = __fmaf_rn(r, 0.00019875691214110702f, 0.001398199936375022f);
  y = __fmaf_rn(y, r, 0.008333452045917511f);
  y = __fmaf_rn(y, r, 0.04166579619050026f);
  y = __fmaf_rn(y, r, 0.1666666567325592f);
  y = __fmaf_rn(y, r, 0.5f);
  y = __fmaf_rn(y, __fmul_rn(r, r), r);
  y = __fadd_rn(y, 1.0f);
  const float scale = __int_as_float((__float2int_rz(fx) + 127) << 23);
  return __fmul_rn(y, scale);
}

__device__ __forceinline__ float truth(bool b) { return b ? 1.0f : 0.0f; }

__global__ void gp_interp_kernel(const int* __restrict__ codes,
                                 const float* __restrict__ consts,
                                 const int* __restrict__ lengths,
                                 const float* __restrict__ X,
                                 const int* __restrict__ op_kind,
                                 const int* __restrict__ arg_index,
                                 int n_nodes, float* __restrict__ out,
                                 int cap, int n_args, int n_points) {
  extern __shared__ float smem[];
  float* stack = smem;                                  // [cap][kThreads]
  int* tok_op = (int*)(smem + cap * kThreads);          // [cap]
  float* tok_val = (float*)(tok_op + cap);              // [cap]
  const long long tree = blockIdx.x;
  const int tid = threadIdx.x;
  const int p = blockIdx.y * kThreads + tid;
  const bool live = p < n_points;
  float* dst = out + tree * (long long)n_points;
  int len = lengths[tree];
  len = len < 0 ? 0 : (len > cap ? cap : len);
  if (len == 0) {                                       // a skipped row
    if (live) dst[p] = 0.0f;
    return;
  }
  const long long base = tree * (long long)cap;
  for (int t = tid; t < len; t += kThreads) {
    int c = codes[base + t];
    c = c < 0 ? 0 : (c >= n_nodes ? n_nodes - 1 : c);
    const int op = op_kind[c];
    tok_op[t] = op;
    if (op == kArg) {
      int a = arg_index[c];
      a = a < 0 ? 0 : (a >= n_args ? n_args - 1 : a);
      tok_val[t] = __int_as_float(a);
    } else {
      tok_val[t] = consts[base + t];
    }
  }
  __syncthreads();
  if (!live) return;

  float top = 0.0f;
  int sp = 0;
  for (int t = len - 1; t >= 0; --t) {
    const int op = tok_op[t];
    if (op == kArg || op == kConst) {                   // push
      const float v = op == kArg
          ? X[(long long)__float_as_int(tok_val[t]) * n_points + p]
          : tok_val[t];
      if (sp >= 1) stack[(sp - 1 < cap ? sp - 1 : cap - 1) * kThreads + tid] = top;
      top = v;
      sp = sp < cap ? sp + 1 : cap;
      continue;
    }
    const int r1 = sp >= 2 ? (sp - 2 < cap ? sp - 2 : cap - 1) : 0;
    switch (op) {
      case kAdd: top = __fadd_rn(top, stack[r1 * kThreads + tid]); break;
      case kSub: top = __fsub_rn(top, stack[r1 * kThreads + tid]); break;
      case kMul: top = __fmul_rn(top, stack[r1 * kThreads + tid]); break;
      case kDiv: {
        const float b = stack[r1 * kThreads + tid];
        top = fabsf(b) > 1e-9f ? __fdiv_rn(top, b) : 1.0f;
        break;
      }
      case kNeg: top = -top; break;
      case kSin: top = xla_sincos(top, false); break;
      case kCos: top = xla_sincos(top, true); break;
      case kLog: {
        float a = fabsf(top);
        top = xla_log(a < 1e-9f ? 1e-9f : a);           // NaN stays NaN
        break;
      }
      case kSqrt: top = __fsqrt_rn(fabsf(top)); break;
      case kLf:
        top = __fdiv_rn(1.0f, __fadd_rn(1.0f, xla_exp(-top)));
        break;
      case kAnd: top = truth(top != 0.0f && stack[r1 * kThreads + tid] != 0.0f); break;
      case kOr: top = truth(top != 0.0f || stack[r1 * kThreads + tid] != 0.0f); break;
      case kXor: top = truth((top != 0.0f) != (stack[r1 * kThreads + tid] != 0.0f)); break;
      case kNot: top = truth(top == 0.0f); break;
      case kIf: {
        const int r2 = sp >= 3 ? (sp - 3 < cap ? sp - 3 : cap - 1) : 0;
        top = top != 0.0f ? stack[r1 * kThreads + tid]
                          : stack[r2 * kThreads + tid];
        break;
      }
      default: break;
    }
    const int arity = op == kIf ? 3 : (op == kNeg || op == kSin || op == kCos ||
                                       op == kLog || op == kSqrt || op == kLf ||
                                       op == kNot) ? 1 : 2;
    sp = sp - arity + 1;
    sp = sp < 0 ? 0 : sp;
  }
  dst[p] = top;
}

}  // namespace

// codes/consts (pop, cap), lengths (pop,), X (n_args, n_points), op_kind and
// arg_index (n_nodes,) int32; out (pop, n_points) float32.
extern "C" int gp_interp(const int* codes, const float* consts,
                         const int* lengths, const float* X,
                         const int* op_kind, const int* arg_index, int n_nodes,
                         float* out, long long pop, int cap, int n_args,
                         int n_points, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (pop == 0 || n_points == 0) return 0;
  if (cap < 1 || n_nodes < 1 || pop > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const long long tiles = (n_points + kThreads - 1) / kThreads;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)cap * kThreads * sizeof(float) + (size_t)cap * 8;
  if (smem > kMaxDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        gp_interp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)pop, (unsigned)tiles);
  gp_interp_kernel<<<grid, kThreads, smem, st>>>(codes, consts, lengths, X,
                                                op_kind, arg_index, n_nodes,
                                                out, cap, n_args, n_points);
  return (int)cudaGetLastError();
}
