// Keypoint refinement walk read straight from the DoG stack (sm_90a).
//
// Replaces the TPU kernel sift_tpu/kernels/pallas/refine.py
// (refine_walk_pallas, body _refine_kernel), and absorbs the refine use of
// sift_tpu/kernels/pallas/windows.py (gather_windows_pallas at d = 16),
// which first copied every keypoint's (L, 16, 16) DoG patch to device
// memory for the walk to read back. Per keypoint: the patch corner
// (x0, y0) = clamp(position - 8, 0, size - 16), five steps of the Lowe
// Taylor walk on the patch — 27 stencil taps, gradient and Hessian,
// adjugate 3x3 solve, step = clip(rint(off), -1, 1) unless |off| < 0.5 on
// every axis, positions clipped to the image interior, the level to
// [1, L-2] — then the final 27-value cube and the walk state.
//
// The arithmetic is the plain walk's (kernels/cuda/refine.py) term for
// term, in the same order, and this file is compiled with -fmad=false so
// that no product is fused into a sum: a different rounding moves a
// keypoint. rintf rounds half to even as the plain walk does; the
// division is IEEE.
//
// A tap is the patch's flat cell c = y*16 + x: outside [0, 256) it reads
// 0, inside it reads cell (c >> 4, c & 15), so a step to column -1 or 16
// wraps to the neighbouring row, as the JAX walk's flat one-hot lookup
// does. The padding slots of the candidate buffer (level 1, image row 0)
// reach it. Staging the whole 16x16 patch keeps that rule for free.
//
// Bound on the H100: bytes — the DoG cells the walks read, read once, and
// 12 B in and 124 B out per keypoint; the walk is a few hundred flops per
// keypoint. What holds it back is latency: the walk is six dependent
// rounds of 27 reads and a solve with IEEE divisions, and a block has few
// keypoints to overlap. So a block of 128 threads stages the whole
// patches of G keypoints in shared memory first, and one warp then walks
// them there: the dependent rounds wait on shared memory, not on device
// memory. Staging is latency-bound too, so each thread issues the loads
// of one level for all G keypoints (2G 4-byte loads, 16 neighbouring
// threads on one 64-byte patch row; rows are not 16-byte aligned) before
// it stores any; a pixel past the image's bottom or right edge is stored
// as 0. The layout is keypoint-minor with a stride of G + 1 words per
// patch cell, so that the two rows of a warp's stores fall in 32 distinct
// banks; the walk's reads hit distinct banks where the warp's keypoints
// sit on the same cell, and spread over the banks otherwise. 4-byte
// cp.async copies into this layout, and loads issued 8 keypoints at a
// time, were slower on the H100 (PERF.md).
//
// A walk moves at most one level a step, so it reads only the 13 levels
// around its start (REACH = 6 on either side); a block stages
// S = min(L, 13) levels per keypoint, from lo = clamp(level - 6, 0,
// L - S). G = 32 keypoints a block while S * 33 KB fits a block's shared
// memory (L <= 6), else G = 16 (S * 17 KB, at most 221 KB): every L runs.

#include <cuda_runtime.h>

namespace {

constexpr int D = 16;
constexpr int R = D / 2;
constexpr int CELLS = D * D;
constexpr int N_ITERS = 5;
constexpr int REACH = N_ITERS + 1;         // levels a walk reads each side
constexpr int MAX_STAGED = 2 * REACH + 1;  // levels staged per keypoint
constexpr int THREADS = 128;
constexpr int RSTEP = THREADS / D;   // patch rows staged at once
constexpr int SMEM_LIMIT = 227 * 1024;     // shared memory of a block

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The 27 taps around patch-local (li, ly, lx) in (s, dy, dx) order, li
// counted from the first staged level. `patch` is the keypoint's column:
// staged level l, cell c at patch[(l*CELLS + c) * GP].
template <int GP>
__device__ __forceinline__ void taps(const float* patch, int li, int ly,
                                     int lx, float v[27]) {
  for (int s = 0; s < 3; ++s) {
    const float* lvl = patch + (li - 1 + s) * CELLS * GP;
    for (int dy = 0; dy < 3; ++dy) {
      for (int dx = 0; dx < 3; ++dx) {
        const int cell = (ly + dy - 1) * D + (lx + dx - 1);
        v[s * 9 + dy * 3 + dx] =
            (cell >= 0 && cell < CELLS) ? lvl[cell * GP] : 0.0f;
      }
    }
  }
}

__device__ __forceinline__ float p(const float v[27], int s, int y, int x) {
  return v[s * 9 + y * 3 + x];
}

// off = H^-1 (-g) via the adjugate; returns whether |det| > 1e-12.
__device__ __forceinline__ bool solve_step(const float v[27], float off[3]) {
  const float c = p(v, 1, 1, 1);
  const float gx = (p(v, 1, 1, 2) - p(v, 1, 1, 0)) / 2.0f;
  const float gy = (p(v, 1, 2, 1) - p(v, 1, 0, 1)) / 2.0f;
  const float gs = (p(v, 2, 1, 1) - p(v, 0, 1, 1)) / 2.0f;
  const float dxx = p(v, 1, 1, 2) + p(v, 1, 1, 0) - 2.0f * c;
  const float dyy = p(v, 1, 2, 1) + p(v, 1, 0, 1) - 2.0f * c;
  const float dss = p(v, 2, 1, 1) + p(v, 0, 1, 1) - 2.0f * c;
  const float dxy = (p(v, 1, 2, 2) - p(v, 1, 2, 0) - p(v, 1, 0, 2) + p(v, 1, 0, 0)) / 4.0f;
  const float dxs = (p(v, 2, 1, 2) - p(v, 2, 1, 0) - p(v, 0, 1, 2) + p(v, 0, 1, 0)) / 4.0f;
  const float dys = (p(v, 2, 2, 1) - p(v, 2, 0, 1) - p(v, 0, 2, 1) + p(v, 0, 0, 1)) / 4.0f;
  // H = [[dxx, dxy, dxs], [dxy, dyy, dys], [dxs, dys, dss]]
  const float h00 = dxx, h01 = dxy, h02 = dxs;
  const float h10 = dxy, h11 = dyy, h12 = dys;
  const float h20 = dxs, h21 = dys, h22 = dss;
  const float det = h00 * (h11 * h22 - h12 * h21)
                  - h01 * (h10 * h22 - h12 * h20)
                  + h02 * (h10 * h21 - h11 * h20);
  const float a00 = h11 * h22 - h12 * h21;
  const float a01 = h02 * h21 - h01 * h22;
  const float a02 = h01 * h12 - h02 * h11;
  const float a10 = h12 * h20 - h10 * h22;
  const float a11 = h00 * h22 - h02 * h20;
  const float a12 = h02 * h10 - h00 * h12;
  const float a20 = h10 * h21 - h11 * h20;
  const float a21 = h01 * h20 - h00 * h21;
  const float a22 = h00 * h11 - h01 * h10;
  const float b0 = -gx, b1 = -gy, b2 = -gs;
  const bool ok = fabsf(det) > 1e-12f;
  const float sd = ok ? det : 1.0f;
  off[0] = (a00 * b0 + a01 * b1 + a02 * b2) / sd;
  off[1] = (a10 * b0 + a11 * b1 + a12 * b2) / sd;
  off[2] = (a20 * b0 + a21 * b1 + a22 * b2) / sd;
  return ok;
}

__device__ __forceinline__ int step_of(float o) {
  return static_cast<int>(fminf(fmaxf(rintf(o), -1.0f), 1.0f));
}

// G keypoints a block, warp 0 walks them; S staged levels per keypoint.
template <int G>
__global__ void __launch_bounds__(THREADS)
refine_walk_kernel(const float* __restrict__ dogs,
                   const float* __restrict__ xs, const float* __restrict__ ys,
                   const int* __restrict__ level, int N, int K, int L, int S,
                   int H, int W, float* __restrict__ cube,
                   int* __restrict__ walk) {
  constexpr int GP = G + 1;             // shared-memory words per patch cell
  extern __shared__ float patch[];      // [S][CELLS][GP]
  __shared__ long long src_off[G];      // dogs offset of (b, lo, y0, x0)
  __shared__ int src_rows[G];           // patch rows inside the image
  __shared__ int src_cols[G];           // patch columns inside the image

  const int t = threadIdx.x;
  const int n = blockIdx.x * G + t;     // this thread's keypoint, if t < G
  int x0 = 0, y0 = 0, lx = 0, ly = 0, li = 1, lo = 0;
  if (t < G) {
    long long off = 0;
    int rows = 0, cols = 0;             // 0: no keypoint, nothing staged
    if (n < N) {
      const int xi0 = static_cast<int>(xs[n]);
      const int yi0 = static_cast<int>(ys[n]);
      x0 = clampi(xi0 - R, 0, max(W - D, 0));
      y0 = clampi(yi0 - R, 0, max(H - D, 0));
      lx = xi0 - x0;
      ly = yi0 - y0;
      li = level[n];
      lo = clampi(li - REACH, 0, L - S);
      const long long b = n / K;
      off = ((b * L + lo) * H + y0) * W + x0;
      rows = min(D, H - y0);
      cols = min(D, W - x0);
    }
    src_off[t] = off;
    src_rows[t] = rows;
    src_cols[t] = cols;
  }
  __syncthreads();

  // Stage: thread t copies column t % 16 of patch rows t / 16 + k * RSTEP.
  const int col = t % D;
  const long long plane = static_cast<long long>(H) * W;
  for (int l = 0; l < S; ++l) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float* src = dogs + src_off[g] + l * plane + col;
      const bool col_in = col < src_cols[g];
      const int rows = src_rows[g];
#pragma unroll
      for (int k = 0; k < D / RSTEP; ++k) {
        const int r = t / D + k * RSTEP;
        patch[(l * CELLS + r * D + col) * GP + g] =
            (col_in && r < rows) ? src[static_cast<long long>(r) * W] : 0.0f;
      }
    }
  }
  __syncthreads();
  if (t >= G || n >= N) return;

  // Walk: one thread per keypoint, from shared memory.
  const float* mine = patch + t;
  const int lxmin = 1 - x0, lxmax = (W - 2) - x0;
  const int lymin = 1 - y0, lymax = (H - 2) - y0;
  bool converged = false;
  float v[27];
  float off[3];
  for (int it = 0; it < N_ITERS; ++it) {
    taps<GP>(mine, li - lo, ly, lx, v);
    const bool ok = solve_step(v, off);
    if (!ok) { off[0] = 0.0f; off[1] = 0.0f; off[2] = 0.0f; }
    const bool small = fabsf(off[0]) < 0.5f && fabsf(off[1]) < 0.5f &&
                       fabsf(off[2]) < 0.5f;
    const bool move = !converged && !small;
    lx = clampi(lx + (move ? step_of(off[0]) : 0), lxmin, lxmax);
    ly = clampi(ly + (move ? step_of(off[1]) : 0), lymin, lymax);
    li = clampi(li + (move ? step_of(off[2]) : 0), 1, L - 2);
    converged = converged || small;
  }
  taps<GP>(mine, li - lo, ly, lx, v);
  float* out = cube + static_cast<long long>(n) * 27;
  for (int i = 0; i < 27; ++i) out[i] = v[i];
  int* w = walk + static_cast<long long>(n) * 4;
  w[0] = x0 + lx; w[1] = y0 + ly; w[2] = li; w[3] = converged ? 1 : 0;
}

template <int G>
int smem_of(int S) {
  return S * CELLS * (G + 1) * static_cast<int>(sizeof(float));
}

template <int G>
int launch(const float* dogs, const float* xs, const float* ys,
           const int* level, int N, int K, int L, int S, int H, int W,
           float* cube, int* walk, cudaStream_t stream) {
  const int smem = smem_of<G>(S);
  cudaError_t err = cudaFuncSetAttribute(
      refine_walk_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (N + G - 1) / G;
  refine_walk_kernel<G><<<blocks, THREADS, smem, stream>>>(
      dogs, xs, ys, level, N, K, L, S, H, W, cube, walk);
  return static_cast<int>(cudaGetLastError());
}

// At G = 16, 16 x 16 B of static and 13 x 17 KB of dynamic shared memory
// fit a block.
static_assert(MAX_STAGED * CELLS * 17 * 4 + 16 * 16 <= SMEM_LIMIT,
              "G = 16 must fit every L");

}  // namespace

// dogs: (B, L, H, W) f32, contiguous, L >= 3. xs, ys: (B, K) f32 pixel
// positions (>= 0); level: (B, K) int32 in [1, L-2]; N = B*K. cube: (B, K,
// 27) f32 in (s, dy, dx) order. walk: (B, K, 4) int32 rows (x, y, level,
// converged) in image coordinates. A block takes S * 33 KB (G = 32) or
// S * 17 KB (G = 16) of dynamic shared memory, S = min(L, 13). Returns the
// first CUDA error of the set-up or the launch.
extern "C" int sift_refine_walk(const float* dogs, const float* xs,
                                const float* ys, const int* level, int N,
                                int K, int L, int H, int W, float* cube,
                                int* walk, void* stream) {
  const int S = min(L, MAX_STAGED);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (smem_of<32>(S) + 32 * 16 <= SMEM_LIMIT)
    return launch<32>(dogs, xs, ys, level, N, K, L, S, H, W, cube, walk, st);
  return launch<16>(dogs, xs, ys, level, N, K, L, S, H, W, cube, walk, st);
}
