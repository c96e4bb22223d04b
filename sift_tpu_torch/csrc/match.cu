// Streaming masked top-2 nearest descriptors (sm_90a).
//
// Replaces the TPU kernel sift_tpu/kernels/pallas/match.py (streaming_top2,
// _top2_call, body _top2_kernel). For every row i of A, over the columns j
// of B, with the masking penalty already folded into the norms
// (an[i] = |a_i|^2 + (valid ? 0 : 1e30), bn likewise):
//   d(i, j) = max(an[i] + bn[j] - 2 a_i.b_j, 0)
//   best[i] = min_j d, arg[i] = the first j attaining it,
//   second[i] = min over every other column (a duplicate of the best value
//   in another column counts, as the dense path's one-hot exclusion does).
// The (Na, Nb) distance matrix never leaves registers.
//
// Bound on the H100: operations, 2*Na*Nb*D f32 FLOP (17.2 GFLOP per pass at
// 8192 x 8192 x 128) against the f32 peak; the descriptors are a few MB.
// Design: an f32 FFMA tiled product with a top-2 epilogue. No TF32 mma: it
// keeps three digits, and the result must hold against f32.
// - A block owns BM = 128 rows of A and walks a contiguous range of BN = 128
//   column tiles of B. Both operands are staged through shared memory in
//   BK = 16 deep slices, stored k-major (transposed) so that each thread
//   reads its 8 rows and 8 columns as two float4 each.
// - 256 threads as 16 x 16; each accumulates an 8 x 8 micro-tile of dot
//   products in registers (rows ty*4 + {0..3, 64..67}, columns likewise
//   with tx), then folds it into a running (best, arg, second) per row.
// - Every merge compares (distance, column) lexicographically, so the lower
//   column wins ties and first-occurrence semantics survive any order: the
//   16 threads that share rows merge with warp shuffles, and the column
//   ranges of different blocks (blockIdx.y, used to fill the card when Na
//   alone gives too few blocks) merge in a second small kernel.
// - Rows and columns past Na and Nb are masked here: zeros are staged in
//   their place and their results are never kept.
// The Pallas design's write-once (nj, 1, Na) partials and transposed tile
// were workarounds for the TPU runtime and its sublane reductions; they are
// gone.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int PAD = 4;  // keeps float4 alignment, spreads the transposed stores
constexpr int THREADS = 256;

__device__ __forceinline__ bool before(float d1, int c1, float d2, int c2) {
  return d1 < d2 || (d1 == d2 && c1 < c2);
}

// Fold candidate (d, c) into the running (best, arg, second).
__device__ __forceinline__ void push(float d, int c, float& best, int& arg,
                                     float& second) {
  if (before(d, c, best, arg)) {
    second = best;  // the old best is <= the old second
    best = d;
    arg = c;
  } else {
    second = fminf(second, d);
  }
}

// Merge another running triple into (best, arg, second).
__device__ __forceinline__ void merge(float b2, int a2, float s2, float& best,
                                      int& arg, float& second) {
  if (before(b2, a2, best, arg)) {
    second = fminf(s2, best);
    best = b2;
    arg = a2;
  } else {
    second = fminf(second, b2);
  }
}

// Stage rows [r0, r0 + 128) x depth [k0, k0 + 16) of a row-major (N, D)
// matrix into dst[k][row], zeros past row N.
__device__ __forceinline__ void stage(const float* __restrict__ src, int N,
                                      int D, int r0, int k0,
                                      float (*dst)[BM + PAD]) {
#pragma unroll
  for (int p = 0; p < (BM * BK / 4) / THREADS; ++p) {
    const int idx = p * THREADS + threadIdx.x;
    const int row = idx >> 2;
    const int kq = (idx & 3) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r0 + row < N) {
      v = *reinterpret_cast<const float4*>(
          src + static_cast<long long>(r0 + row) * D + k0 + kq);
    }
    dst[kq + 0][row] = v.x;
    dst[kq + 1][row] = v.y;
    dst[kq + 2][row] = v.z;
    dst[kq + 3][row] = v.w;
  }
}

__device__ __forceinline__ int offset_of(int t, int i) {
  return i < 4 ? t * 4 + i : 64 + t * 4 + (i - 4);
}

__global__ void __launch_bounds__(THREADS, 2)
top2_kernel(const float* __restrict__ a, const float* __restrict__ an,
            const float* __restrict__ b, const float* __restrict__ bn,
            int Na, int Nb, int D, int tiles_per_split,
            float* __restrict__ best_out, float* __restrict__ second_out,
            int* __restrict__ arg_out) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];
  __shared__ float an_s[BM];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int row0 = blockIdx.x * BM;
  const int ntiles = (Nb + BN - 1) / BN;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, ntiles);

  if (threadIdx.x < BM) {
    const int r = row0 + threadIdx.x;
    an_s[threadIdx.x] = r < Na ? an[r] : 0.0f;
  }  // read after the first __syncthreads below
  float best[8], second[8];
  int arg[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best[i] = INFINITY;
    second[i] = INFINITY;
    arg[i] = INT_MAX;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int col0 = t * BN;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    }
    for (int k0 = 0; k0 < D; k0 += BK) {
      stage(a, Na, D, row0, k0, As);
      stage(b, Nb, D, col0, k0, Bs);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + offset_of(tx, j);
      if (c < Nb) {
        const float bnc = bn[c];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float d =
              fmaxf(an_s[offset_of(ty, i)] + bnc - 2.0f * acc[i][j], 0.0f);
          push(d, c, best[i], arg[i], second[i]);
        }
      }
    }
  }

  // The 16 threads of one ty (lanes 16*(ty&1) + 0..15) share rows.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float b2 = __shfl_xor_sync(0xffffffffu, best[i], off);
      const float s2 = __shfl_xor_sync(0xffffffffu, second[i], off);
      const int a2 = __shfl_xor_sync(0xffffffffu, arg[i], off);
      merge(b2, a2, s2, best[i], arg[i], second[i]);
    }
  }
  if (tx == 0) {
    const long long base = static_cast<long long>(blockIdx.y) * Na;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row0 + offset_of(ty, i);
      if (r < Na) {
        best_out[base + r] = best[i];
        second_out[base + r] = second[i];
        arg_out[base + r] = min(arg[i], Nb - 1);
      }
    }
  }
}

// Merge the per-split partials (splits, Na) in split order.
__global__ void merge_kernel(const float* __restrict__ pbest,
                             const float* __restrict__ psecond,
                             const int* __restrict__ parg, int splits, int Na,
                             float* __restrict__ best_out,
                             float* __restrict__ second_out,
                             int* __restrict__ arg_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= Na) return;
  float best = pbest[r], second = psecond[r];
  int arg = parg[r];
  for (int s = 1; s < splits; ++s) {
    const long long i = static_cast<long long>(s) * Na + r;
    merge(pbest[i], parg[i], psecond[i], best, arg, second);
  }
  best_out[r] = best;
  second_out[r] = second;
  arg_out[r] = arg;
}

}  // namespace

// a: (Na, D) f32, an: (Na,) f32 masked norms, b: (Nb, D), bn: (Nb,); D a
// multiple of 16, pointers 16-byte aligned, Na, Nb >= 1. The column tiles
// are cut into `splits` ranges (one grid row each); with splits > 1 the
// partials go to the (splits, Na) scratch buffers and a second kernel
// merges them. Outputs: best, second (Na,) f32, arg (Na,) int32.
// Returns the first non-zero cudaGetLastError() of the launches.
extern "C" int sift_streaming_top2(const float* a, const float* an,
                                   const float* b, const float* bn, int Na,
                                   int Nb, int D, int splits, float* pbest,
                                   float* psecond, int* parg, float* best,
                                   float* second, int* arg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ntiles = (Nb + BN - 1) / BN;
  const int per = (ntiles + splits - 1) / splits;
  const int used = (ntiles + per - 1) / per;
  const dim3 grid((Na + BM - 1) / BM, used);
  if (used == 1) {
    top2_kernel<<<grid, THREADS, 0, s>>>(a, an, b, bn, Na, Nb, D, per, best,
                                         second, arg);
    return static_cast<int>(cudaGetLastError());
  }
  top2_kernel<<<grid, THREADS, 0, s>>>(a, an, b, bn, Na, Nb, D, per, pbest,
                                       psecond, parg);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  merge_kernel<<<(Na + 255) / 256, 256, 0, s>>>(pbest, psecond, parg, used,
                                                Na, best, second, arg);
  return static_cast<int>(cudaGetLastError());
}
