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
// (its leftmost child on top) by its result.  A row of length 0 gives zeros
// (the evaluator zeroes the lengths of rows whose fitness is still valid).
//
// Design.  A work item is one tree and one part of 256 of its points; the
// warps of a persistent grid take items in turn (a counter hands out the
// next one), so the parts of a long tree (up to cap tokens against a mean
// of ~14) run on several warps at once and a skipped row costs its zero
// stores.  A block has up to 8 warps, fewer when a large cap's stack slabs
// would not fit its shared memory.  The block stages X in shared memory
// once (zero-padded to whole parts) when it is small and an SM still holds
// as many blocks; otherwise an argument reads X through L1 (on an H100,
// staging took 8% off the bench's one-argument input and added 18% to
// comb trees over two arguments, whose 4 KB more took an SM from 3 blocks
// to 2).
//
// Staging, once per item: the lanes load the tree's length, codes and
// constants together and look up each code's opcode and argument row; then
// one lane walks the tokens once to decode them.  The stack depth before
// each token depends on the program alone: a running sum of 1 - arity over
// the walk, clamped to [0, cap] after every token as the walk always was, so a
// malformed program still writes nowhere outside its stack (its result is
// unspecified).  Each token becomes one word: its opcode, and the stack row
// it spills the old top into (a push) or reads its operands from (an
// operator: rows sp - 2 and, for `if`, sp - 3), with the constant or the X
// row beside it.  A binary operator whose first operand is a terminal (the
// token right after it in prefix order) is folded with it into one word,
// op(terminal, top): the push, its spill and the operator's stack read go
// (same operands, same operation: the result is the same bits).  The walk
// then has no stack-pointer arithmetic and no clamps.  Staging also gives
// the tree's real number of stack rows.
//
// The walk: each lane takes K points (1, 2, 4 or 8; a compile-time case,
// the largest whose stack and one scratch row fit the warp's slab, and no
// more than the part's points need), so each
// token's dispatch (one shared load of its word, loaded a word ahead, and a
// branch, the same for every lane) is paid once for 32 K points and the K
// chains overlap.  The top of the stack for the K points lives in
// registers, the rows below it in the warp's shared slab laid out
// [row][point] (lane-consecutive: no bank conflicts); sin, cos, log and the
// logistic take the K points through the scratch row one at a time, so
// their long bodies are compiled once, not K times.  A deep tree walks its
// part in passes of 32 K points with the decoded words kept.
//
// What bounds it on the card is latency, not bytes or operations: a warp
// waits some 500 cycles on each dispatch at K = 8 and a few thousand on
// each item's staging, and 24 warps an SM (shared memory: the slabs) hide
// only part of it.  Measured on an H100 (kernels/kernel_times.py): one warp
// a whole tree made the longest tree the kernel's critical path; parts of
// 256 points took the bench's evolved population from 0.083 to 0.059 ms;
// parts of 512 points were slower again.
// The jump table compiles to uniform branches (one BRX in the kernel): a
// tree of bit tests in its place gained nothing.

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

#include <atomic>

#include "device_math.cuh"

namespace {

// deap_tpu_torch/gp/interp_cuda.py's OPCODES, then the staged forms: kFold
// + 2 * (binary operator's index: add sub mul div and or xor) + (the folded
// terminal is a constant); kNop stands for a code outside the table (it
// pops one value and leaves the top, as the walk always treated it)
enum Op : int {
  kArg = 0, kConst, kAdd, kSub, kMul, kDiv, kNeg, kSin, kCos, kLog, kSqrt,
  kLf, kAnd, kOr, kXor, kNot, kIf, kFold, kNop = 31
};

constexpr int kWarps = 8;               // warps a block at most, an item each
constexpr int kMinBlocks = 3;           // blocks of 8 warps an SM: 85 regs
constexpr int kMaxK = 8;                // points a lane, at most
constexpr int kPart = 32 * kMaxK;       // points an item; X staged by parts
constexpr int kXStageMax = 32 * 1024;   // stage X when it takes at most this

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

// binary operator kBi (add sub mul div and or xor) of a (the top, the
// leftmost child) and b
template <int kBi>
__device__ __forceinline__ float binary(float a, float b) {
  if constexpr (kBi == 0) return __fadd_rn(a, b);
  else if constexpr (kBi == 1) return __fsub_rn(a, b);
  else if constexpr (kBi == 2) return __fmul_rn(a, b);
  else if constexpr (kBi == 3) return fabsf(b) > 1e-9f ? __fdiv_rn(a, b) : 1.0f;
  else if constexpr (kBi == 4) return truth(a != 0.0f && b != 0.0f);
  else if constexpr (kBi == 5) return truth(a != 0.0f || b != 0.0f);
  else return truth((a != 0.0f) != (b != 0.0f));
}

// sin, cos, log or logistic of x
__device__ __forceinline__ float long_unary(int op, float x) {
  if (op == kLog) {
    const float a = fabsf(x);
    return xla_log(a < 1e-9f ? 1e-9f : a);             // NaN stays NaN
  }
  if (op == kLf) return __fdiv_rn(1.0f, __fadd_rn(1.0f, xla_exp(-x)));
  return xla_sincos(x, op == kCos);
}

__device__ __forceinline__ int binary_index(int op) {
  return op >= kAdd && op <= kDiv ? op - kAdd
       : (op >= kAnd && op <= kXor ? 4 + op - kAnd : -1);
}

__device__ __forceinline__ int arity(int op) {
  switch (op) {
    case kNeg: case kSin: case kCos: case kLog: case kSqrt: case kLf:
    case kNot: return 1;
    case kIf: return 3;
    default: return 2;                  // binary operators and kNop
  }
}

// Decode the tree of `len` tokens that the lanes left in buf[i] (walk order
// i = len - 1 - t: opcode, and the X offset or the constant's bits) into the
// executed words, in place; returns their count and the stack rows used.
__device__ int decode_tree(int2* buf, int len, int cap, int* rows_out) {
  int sp = 0, w = 0, rows = 1;
  bool after_push = false;
  for (int i = 0; i < len; ++i) {
    const int2 e = buf[i];
    const int op = e.x;
    if (op == kArg || op == kConst) {
      const int row = sp >= 1 ? sp - 1 : 0;      // sp < cap: row <= cap - 2
      buf[w++] = make_int2(op | row << 5, e.y);
      rows = row + 1 > rows ? row + 1 : rows;
      sp = sp < cap ? sp + 1 : cap;
      after_push = true;
      continue;
    }
    const int bi = binary_index(op);
    if (after_push && bi >= 0) {                 // op(terminal, top)
      const int2 p = buf[w - 1];
      buf[w - 1] = make_int2(kFold + 2 * bi + ((p.x & 31) == kConst), p.y);
      sp -= 1;                                   // sp >= 1 after a push
      after_push = false;
      continue;
    }
    const int a = arity(op);
    const int r1 = sp >= 2 ? sp - 2 : 0;
    const int r2 = sp >= 3 ? sp - 3 : 0;
    if (a >= 2) rows = r1 + 1 > rows ? r1 + 1 : rows;
    buf[w++] = make_int2(op | r1 << 5, r2);
    sp = sp - a + 1 > 0 ? sp - a + 1 : 0;
    after_push = false;
  }
  *rows_out = rows;
  return w;
}

// one case of the walk: K points of this lane
#define FOR_K _Pragma("unroll") for (int j = 0; j < K; ++j)
#define BIN_CASES(BI, OP)                                                   \
  case OP: FOR_K top[j] = binary<BI>(top[j], sr[32 * j]); break;            \
  case kFold + 2 * BI: {                                                    \
    const float* xr = xl + tk.y;                                            \
    FOR_K top[j] = binary<BI>(X_AT(xr, j), top[j]);                         \
    break;                                                                  \
  }                                                                         \
  case kFold + 2 * BI + 1: {                                                \
    const float v = __int_as_float(tk.y);                                   \
    FOR_K top[j] = binary<BI>(v, top[j]);                                   \
    break;                                                                  \
  }

// Walk the n_tok decoded words over the tree's points, 32 K points a pass;
// X is xs (staged, pitch a multiple of 32 K, zero-padded) or the global X.
template <int K, bool kXs>
__device__ void walk_tree(const int2* buf, int n_tok, int rows, float* slab,
                          const float* X, const float* xs, float* dst,
                          int p_begin, int p_end, int n_points, int lane) {
  constexpr int kShift = K == 8 ? 8 : (K == 4 ? 7 : (K == 2 ? 6 : 5));
  float* sl = slab + lane;
  float* sc = sl + (rows << kShift);    // the scratch row above the stack
  for (int p0 = p_begin; p0 < p_end; p0 += 32 * K) {
    const float* xl;
    int xo[K];
    if (kXs) {
      xl = xs + p0 + lane;
      FOR_K xo[j] = 0;                  // unused
    } else {                            // clamped points: no read past X
      xl = X;
      FOR_K {
        const int p = p0 + lane + 32 * j;
        xo[j] = p < n_points ? p : n_points - 1;
      }
    }
#define X_AT(xr, j) (kXs ? (xr)[32 * (j)] : __ldg((xr) + xo[j]))
    float top[K];
    FOR_K top[j] = 0.0f;
    int2 nxt = buf[0];                  // the next word, loaded ahead
#pragma unroll 1
    for (int w = 0; w < n_tok; ++w) {
      const int2 tk = nxt;
      nxt = buf[w + 1];
      float* sr = sl + ((tk.x >> 5) << kShift);
      switch (tk.x & 31) {
        case kArg: {
          const float* xr = xl + tk.y;
          FOR_K {
            sr[32 * j] = top[j];
            top[j] = X_AT(xr, j);
          }
          break;
        }
        case kConst: {
          const float v = __int_as_float(tk.y);
          FOR_K {
            sr[32 * j] = top[j];
            top[j] = v;
          }
          break;
        }
        BIN_CASES(0, kAdd)
        BIN_CASES(1, kSub)
        BIN_CASES(2, kMul)
        BIN_CASES(3, kDiv)
        BIN_CASES(4, kAnd)
        BIN_CASES(5, kOr)
        BIN_CASES(6, kXor)
        case kNeg: FOR_K top[j] = -top[j]; break;
        case kSin: case kCos: case kLog: case kLf: {
          // one copy of the long bodies: the K points go through the
          // scratch row, one at a time
          const int op = tk.x & 31;
          FOR_K sc[32 * j] = top[j];
#pragma unroll 1
          for (int j = 0; j < K; ++j) sc[32 * j] = long_unary(op, sc[32 * j]);
          FOR_K top[j] = sc[32 * j];
          break;
        }
        case kSqrt: FOR_K top[j] = __fsqrt_rn(fabsf(top[j])); break;
        case kNot: FOR_K top[j] = truth(top[j] == 0.0f); break;
        case kIf: {
          const float* s2 = sl + (tk.y << kShift);
          FOR_K top[j] = top[j] != 0.0f ? sr[32 * j] : s2[32 * j];
          break;
        }
        default: break;                 // kNop
      }
    }
#undef X_AT
    FOR_K {
      const int p = p0 + lane + 32 * j;
      if (p < p_end) dst[p] = top[j];
    }
  }
}

#undef BIN_CASES

template <bool kXs>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
gp_interp_kernel(const int* __restrict__ codes,
                 const float* __restrict__ consts,
                 const int* __restrict__ lengths,
                 const float* __restrict__ X,
                 const int* __restrict__ op_kind,
                 const int* __restrict__ arg_index, int n_nodes,
                 float* __restrict__ out, int pop, int cap, int n_args,
                 int n_points, int xpitch, int slab_floats,
                 int* __restrict__ next_item) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int xfloats = kXs ? n_args * xpitch : 0;
  float* xs = smem;                                       // [n_args][xpitch]
  int2* buf = reinterpret_cast<int2*>(smem + xfloats) + warp * (cap + 1);
  float* slab = smem + xfloats + 2 * warps * (cap + 1) + warp * slab_floats;
  if (kXs) {
    for (int a = 0; a < n_args; ++a)
      for (int p = threadIdx.x; p < xpitch; p += blockDim.x)
        xs[a * xpitch + p] = p < n_points ? X[(long long)a * n_points + p]
                                          : 0.0f;
    __syncthreads();
  }
  const int xrow = kXs ? xpitch : n_points;   // an argument's offset unit
  // a work item is one tree and one part of kPart of its points
  const int parts = (n_points + kPart - 1) / kPart;
  const int items = pop * parts;
  const int warps_total = gridDim.x * warps;
  int item = blockIdx.x * warps + warp;
  while (item < items) {
    int next = 0;                       // in flight while this item runs
    if (lane == 0) next = warps_total + atomicAdd(next_item, 1);
    const int tree = item / parts;
    const int p_begin = (item - tree * parts) * kPart;
    const int p_end = n_points - p_begin < kPart ? n_points
                                                 : p_begin + kPart;
    float* dst = out + (long long)tree * n_points;
    const long long base = (long long)tree * cap;
    int c0 = 0, c1 = 0, k0 = 0, k1 = 0;   // loaded beside the length
    if (lane < cap) {
      c0 = codes[base + lane];
      k0 = __float_as_int(consts[base + lane]);
    }
    if (lane + 32 < cap) {
      c1 = codes[base + lane + 32];
      k1 = __float_as_int(consts[base + lane + 32]);
    }
    int len = __ldg(lengths + tree);
    len = len < 0 ? 0 : (len > cap ? cap : len);
    if (len == 0) {                     // a skipped row
      for (int p = p_begin + lane; p < p_end; p += 32) dst[p] = 0.0f;
    } else {
      for (int t = lane; t < len; t += 32) {
        int c = t == lane ? c0 : (t == lane + 32 ? c1 : codes[base + t]);
        c = c < 0 ? 0 : (c >= n_nodes ? n_nodes - 1 : c);
        int op = __ldg(op_kind + c);
        op = op < 0 || op > kIf ? kNop : op;
        int v = 0;
        if (op == kArg) {
          int a = __ldg(arg_index + c);
          a = a < 0 ? 0 : (a >= n_args ? n_args - 1 : a);
          v = a * xrow;
        } else if (op == kConst) {
          v = t == lane ? k0 : (t == lane + 32 ? k1
                                : __float_as_int(consts[base + t]));
        }
        buf[len - 1 - t] = make_int2(op, v);
      }
      __syncwarp();
      int n_tok = 0, rows = 1;
      if (lane == 0) n_tok = decode_tree(buf, len, cap, &rows);
      n_tok = __shfl_sync(0xffffffffu, n_tok, 0);
      rows = __shfl_sync(0xffffffffu, rows, 0);
      __syncwarp();
      // the most points a lane whose stack and scratch row fit the slab,
      // no more passes' worth than the points need
      int k = kMaxK;
      while (k > 1 && ((rows + 1) * 32 * k > slab_floats ||
                       16 * k >= p_end - p_begin))
        k >>= 1;
#define WALK(K) walk_tree<K, kXs>(buf, n_tok, rows, slab, X, xs, dst, \
                                  p_begin, p_end, n_points, lane)
      switch (k) {
        case 8: WALK(8); break;
        case 4: WALK(4); break;
        case 2: WALK(2); break;
        default: WALK(1); break;
      }
#undef WALK
      __syncwarp();                     // buf and the slab are reused
    }
    item = __shfl_sync(0xffffffffu, next, 0);
  }
}

// Per device: the SM count and the shared memory a block may opt in to, read
// once, the kernels' dynamic shared memory limit raised to it, and per X form
// the last (warps, shared memory) the occupancy calculator was asked and its
// answer.  Racing first calls do the same idempotent work.
constexpr int kMaxDevices = 64;
std::atomic<int> g_sms[kMaxDevices], g_max_smem[kMaxDevices];
std::atomic<long long> g_occupancy[kMaxDevices][2];

cudaError_t device_limits(int dev, int* sms, int* max_smem) {
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  *sms = g_sms[dev].load(std::memory_order_acquire);
  *max_smem = g_max_smem[dev].load(std::memory_order_relaxed);
  if (*sms > 0) return cudaSuccess;
  cudaError_t e = cudaDeviceGetAttribute(max_smem,
      cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gp_interp_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, *max_smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gp_interp_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, *max_smem);
  if (e != cudaSuccess) return e;
  g_max_smem[dev].store(*max_smem, std::memory_order_relaxed);
  g_sms[dev].store(*sms, std::memory_order_release);
  return cudaSuccess;
}

// blocks of `warps` warps and `smem` bytes an SM holds
cudaError_t blocks_per_sm(int dev, bool xs, int warps, size_t smem,
                          int* per_sm) {
  const long long key = (long long)smem << 4 | warps;     // smem < 2^32
  const long long got = g_occupancy[dev][xs].load(std::memory_order_relaxed);
  if (got >> 8 == key) {
    *per_sm = (int)(got & 255);
    return cudaSuccess;
  }
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, xs ? gp_interp_kernel<true> : gp_interp_kernel<false>,
      warps * 32, smem);
  if (e != cudaSuccess) return e;
  if (*per_sm < 1) *per_sm = 1;
  if (*per_sm < 256)
    g_occupancy[dev][xs].store(key << 8 | *per_sm, std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace

// codes/consts (pop, cap), lengths (pop,), X (n_args, n_points), op_kind and
// arg_index (n_nodes,) int32; out (pop, n_points) float32; next_item one
// int32 of scratch (zeroed here), the item counter.  An argument's offset in
// X is an int: n_args * n_points must stay below 2^31.  A block's shared
// memory holds, for each of its warps, the decoded tokens and a stack slab
// of at least cap rows of a 32-point pass: a cap up to 1709 fits one warp.
extern "C" int gp_interp(const int* codes, const float* consts,
                         const int* lengths, const float* X,
                         const int* op_kind, const int* arg_index, int n_nodes,
                         float* out, long long pop, int cap, int n_args,
                         int n_points, int* next_item, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (pop == 0 || n_points == 0) return 0;
  if (cap < 1 || n_nodes < 1 || n_args < 1 || pop > 0x7FFFFFFFLL ||
      n_points > (1 << 30) || (long long)n_args * n_points >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = device_limits(dev, &sms, &max_smem);
  if (e != cudaSuccess) return (int)e;
  // a warp's slab holds 7 stack rows and the scratch row of a 256-point
  // pass, and at least cap rows of a 32-point pass: a tree uses at most
  // cap - 1 stack rows, so every tree fits at some points a lane
  const size_t slab_rows = cap > 64 ? (size_t)cap : 64;
  const size_t per_warp = (2 * ((size_t)cap + 1) + 32 * slab_rows) * 4;
  int warps = (int)((size_t)max_smem / per_warp);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  if (warps > kWarps) warps = kWarps;
  const int slab_floats = 32 * (int)slab_rows;     // cap fits one warp
  const int xpitch = (n_points + kPart - 1) / kPart * kPart;
  const size_t x_bytes = (size_t)n_args * xpitch * 4;
  size_t smem = warps * per_warp;
  int per_sm = 1;
  e = blocks_per_sm(dev, false, warps, smem, &per_sm);
  if (e != cudaSuccess) return (int)e;
  // X is staged only where the block keeps its warps and the SM its blocks
  bool xs = false;
  if (x_bytes <= (size_t)kXStageMax && smem + x_bytes <= (size_t)max_smem) {
    int staged = 1;
    e = blocks_per_sm(dev, true, warps, smem + x_bytes, &staged);
    if (e != cudaSuccess) return (int)e;
    xs = staged >= per_sm;
  }
  if (xs) smem += x_bytes;
  const long long items = pop * (long long)(xpitch / kPart);
  if (items > 0x7FFFFFFFLL - (1LL << 24)) return (int)cudaErrorInvalidValue;
  long long blocks = (items + warps - 1) / warps;
  const long long resident = (long long)sms * per_sm;
  if (blocks > resident) blocks = resident;
  e = cudaMemsetAsync(next_item, 0, sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  auto kernel = xs ? gp_interp_kernel<true> : gp_interp_kernel<false>;
  kernel<<<(unsigned)blocks, warps * 32, smem, st>>>(
      codes, consts, lengths, X, op_kind, arg_index, n_nodes, out, (int)pop,
      cap, n_args, n_points, xpitch, slab_floats, next_item);
  return (int)cudaGetLastError();
}
