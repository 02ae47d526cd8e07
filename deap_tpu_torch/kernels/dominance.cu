// Dominance counts for Hopper (sm_90a): the CUDA counterpart of the Pallas
// kernel of deap_tpu/ops/dominance_pallas.py.
//
//   rows_dominate_counts  (K4) replaces _counts_pallas: for every column
//                              point w[j], out[j] = #{r : rows[r] dominates
//                              w[j]} in maximisation order (all >= and any >).
//
// The front peel of NSGA-II subtracts a front's contribution with it (C is
// front_chunk rows), and the peel's initial dominator counts run through it
// with C = n (rows where(active, w, -inf) against every column).  A -inf
// sentinel row dominates nothing, and a point never dominates itself, so
// padded chunks and self-pairs need no special case.
//
// Bound on the card: operations.  C x n pair tests, each 2m float compares
// (the >= chain and the > chain fold through the compare's predicate input)
// and at least one instruction to count, at the compare rate of 64 per SM
// and clock: 16.7 ms at C = n = 2e5, m = 3, and 0.086 ms at C = 1024, on an
// H100 SXM (700 W); the 3.2 MB of input are noise.  The compiled loop
// spends 11 instructions a pair at m = 3 (python -m
// deap_tpu_torch.kernels.sass): 6 compares, one PLOP3 joining the chains,
// two to count, and shared loads and loop control.  Design: one thread per column j holds w[j]'s m values in
// registers (w is the natural (n, m) row-major layout; the TPU's transposed
// lanes layout is not needed); the block stages the rows through shared
// memory in tiles, every thread reading the same row at once (a broadcast,
// no bank conflict), and keeps its count in one int32 register written
// once.  m is a template parameter for 2..8 (compares fully unrolled); a
// runtime loop over global w covers larger m.  Any C and any n: no padding
// of rows or columns.  Counting is exact integer work, so the kernel equals
// the plain PyTorch version (deap_tpu_torch/ops/dominance.py) exactly.
//
// A plain C interface (no PyTorch headers), built into one library with
// megakernel.cu by deap_tpu_torch/kernels/build.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileFloats = 3072;   // 12 KB of rows per tile

template <int M>
__global__ void rows_dominate_counts_kernel(const float* __restrict__ rows,
                                            const float* __restrict__ w,
                                            int* __restrict__ out,
                                            long long C, long long n, int m,
                                            int tile_rows) {
  extern __shared__ float tile[];
  const int mm = M > 0 ? M : m;
  const long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const bool live = j < n;
  float wj[M > 0 ? M : 1];
  if (M > 0 && live) {
#pragma unroll
    for (int k = 0; k < (M > 0 ? M : 1); ++k) wj[k] = w[j * M + k];
  }
  int acc = 0;
  for (long long r0 = 0; r0 < C; r0 += tile_rows) {
    const int here = (int)(C - r0 < tile_rows ? C - r0 : tile_rows);
    __syncthreads();                       // the previous tile is consumed
    for (int t = threadIdx.x; t < here * mm; t += blockDim.x)
      tile[t] = rows[r0 * mm + t];
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < here; ++i) {
      const float* r = tile + i * mm;
      bool ge = true, gt = false;
      if (M > 0) {
#pragma unroll
        for (int k = 0; k < (M > 0 ? M : 1); ++k) {
          ge &= r[k] >= wj[k];
          gt |= r[k] > wj[k];
        }
      } else {
        for (int k = 0; k < m; ++k) {
          const float b = w[j * m + k];
          ge &= r[k] >= b;
          gt |= r[k] > b;
        }
      }
      acc += (ge && gt) ? 1 : 0;
    }
  }
  if (live) out[j] = acc;
}

template <int M>
void launch(const float* rows, const float* w, int* out, long long C,
            long long n, int m, cudaStream_t st) {
  int tile_rows = kTileFloats / m;
  if (tile_rows < 1) tile_rows = 1;
  const size_t smem = (size_t)tile_rows * m * sizeof(float);
  const long long blocks = (n + kThreads - 1) / kThreads;
  rows_dominate_counts_kernel<M><<<(unsigned)blocks, kThreads, smem, st>>>(
      rows, w, out, C, n, m, tile_rows);
}

}  // namespace

// rows (C, m) and w (n, m) float32 row-major; out (n,) int32.
extern "C" int rows_dominate_counts(const float* rows, const float* w,
                                    int* out, long long C, long long n, int m,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n == 0) return 0;
  if (m < 1 || m > kTileFloats) return (int)cudaErrorInvalidValue;
  if (C == 0) return (int)cudaMemsetAsync(out, 0, n * sizeof(int), st);
  switch (m) {
    case 2: launch<2>(rows, w, out, C, n, m, st); break;
    case 3: launch<3>(rows, w, out, C, n, m, st); break;
    case 4: launch<4>(rows, w, out, C, n, m, st); break;
    case 5: launch<5>(rows, w, out, C, n, m, st); break;
    case 6: launch<6>(rows, w, out, C, n, m, st); break;
    case 7: launch<7>(rows, w, out, C, n, m, st); break;
    case 8: launch<8>(rows, w, out, C, n, m, st); break;
    default: launch<0>(rows, w, out, C, n, m, st); break;
  }
  return (int)cudaGetLastError();
}
