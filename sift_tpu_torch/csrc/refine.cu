// Keypoint refinement walk over pre-gathered DoG patches (sm_90a).
//
// Replaces the TPU kernel sift_tpu/kernels/pallas/refine.py
// (refine_walk_pallas, body _refine_kernel). Per keypoint: five steps of
// the Lowe Taylor walk on its (L, 16, 16) patch — 27 stencil taps,
// gradient and Hessian, adjugate 3x3 solve, step = clip(rint(off), -1, 1)
// unless |off| < 0.5 on every axis, positions clipped to the image
// interior — then the final 27-value cube and the walk state.
//
// The arithmetic is the plain walk's (frontend/refine.py) term for term,
// in the same order, and this file is compiled with -fmad=false so that
// no product is fused into a sum: a different rounding moves a keypoint.
// rintf rounds half to even as the plain walk does; the division is IEEE.
//
// Bound on the H100: bytes, and far below either bound in practice —
// the work is a few hundred flops per keypoint. One thread per keypoint;
// the taps are read straight from the patch in device memory (cached in
// L1), so only the final cube and state are written.

#include <cuda_runtime.h>

namespace {

constexpr int D = 16;
constexpr int CELLS = D * D;
constexpr int N_ITERS = 5;

// A tap is addressed by its flat in-level index (y*16 + x); one outside
// [0, 256) reads 0, as the plain walk's lookup does (only the padding
// slots of the candidate buffer, at pixel (0, 0), reach it).
__device__ __forceinline__ void taps(const float* __restrict__ patch, int li,
                                     int ly, int lx, float v[27]) {
  for (int s = 0; s < 3; ++s) {
    const float* lvl = patch + (li - 1 + s) * CELLS;
    for (int dy = 0; dy < 3; ++dy) {
      for (int dx = 0; dx < 3; ++dx) {
        const int cell = (ly + dy - 1) * D + (lx + dx - 1);
        v[s * 9 + dy * 3 + dx] = (cell >= 0 && cell < CELLS) ? lvl[cell] : 0.0f;
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

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void refine_walk_kernel(const float* __restrict__ patches,
                                   const int* __restrict__ start, int K, int L,
                                   float* __restrict__ cube,
                                   int* __restrict__ walk) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const float* patch = patches + static_cast<long long>(k) * L * CELLS;
  const int* st = start + k * 8;
  int lx = st[0], ly = st[1], li = st[2];
  const int lxmin = st[3], lxmax = st[4], lymin = st[5], lymax = st[6];
  bool converged = false;
  float v[27];
  float off[3];
  for (int it = 0; it < N_ITERS; ++it) {
    taps(patch, li, ly, lx, v);
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
  taps(patch, li, ly, lx, v);
  float* out = cube + static_cast<long long>(k) * 27;
  for (int t = 0; t < 27; ++t) out[t] = v[t];
  int* w = walk + k * 4;
  w[0] = lx; w[1] = ly; w[2] = li; w[3] = converged ? 1 : 0;
}

}  // namespace

// patches: (K, L, 16, 16) f32. start: (K, 8) int32 rows
// (lx, ly, li, lxmin, lxmax, lymin, lymax, unused), patch-local.
// cube: (K, 27) f32 in (s, dy, dx) order. walk: (K, 4) int32
// (lx, ly, li, converged). Returns cudaGetLastError() after the launch.
extern "C" int sift_refine_walk(const float* patches, const int* start, int K,
                                int L, float* cube, int* walk, void* stream) {
  const int threads = 128;
  const int blocks = (K + threads - 1) / threads;
  refine_walk_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      patches, start, K, L, cube, walk);
  return static_cast<int>(cudaGetLastError());
}
