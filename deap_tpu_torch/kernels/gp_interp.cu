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

#include "device_math.cuh"

namespace {

// deap_tpu_torch/gp/interp_cuda.py's OPCODES
enum Op : int {
  kArg = 0, kConst, kAdd, kSub, kMul, kDiv, kNeg, kSin, kCos, kLog, kSqrt,
  kLf, kAnd, kOr, kXor, kNot, kIf
};

constexpr int kThreads = 128;
constexpr int kMaxDefaultSmem = 48 * 1024;

// ---- XLA's float32 exp (Cephes) ------------------------------------------

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
