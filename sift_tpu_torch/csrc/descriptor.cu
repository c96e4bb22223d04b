// SIFT descriptor accumulation for both orientation peaks (sm_90a).
//
// Replaces the TPU kernel sift_tpu/kernels/pallas/descriptor.py
// (descriptor_accumulate_pallas, body _desc_kernel). Per keypoint, from
// its (2, d, d) gradient window (gx, gy): magnitude and angle per pixel
// (on the TPU these ran outside the kernel, which had no atan2), then for
// each of the two peaks the rotated cell-frame coordinates (u, v), the
// Gaussian weight exp(-(u^2+v^2)/8) times magnitude, and a trilinear vote
// into 4x4 cells x 8 orientation bins. Output is the raw (2, 128)
// histogram, bin a*32 + b*8 + o for row cell a (v), column cell b (u).
//
// Bound on the H100 by bytes on the roofline (the window is read once),
// but in practice by CUDA-core instructions: about 100 a pixel for each
// peak and 60 for magnitude and angle, with 12 warps an SM. The design
// spends none on contention:
// - One block of THREADS threads per keypoint. Thread t owns pixels
//   t, t + THREADS, ...; it issues all its gx, gy loads at once
//   (coalesced) and keeps magnitude and angle in registers for both peaks.
// - The non-zero votes of a pixel come straight from floor(): rows a0 and
//   a0 + 1 with a0 = floor(v + 1.5) and weights 1 - f, f (likewise the
//   columns and the two orientation bins); votes outside the 4x4 grid are
//   predicated off. No tent is tested with a branch.
// - Votes go into the thread's own column of a shared histogram laid out
//   [bin][thread]: plain load-add-store, no atomics, and the 32 lanes of a
//   warp always hit 32 distinct banks, whatever bins they vote in.
// - The THREADS columns of each bin are then summed by the thread that
//   owns the bin, in an order fixed by the code (column c of chunk j0 read
//   as j0 + ((lane + c) & 31), so the lanes again hit distinct banks).
// The result is bit-identical from run to run. It differs from the plain
// PyTorch version by summation order and by CUDA's atan2f, sqrtf and expf,
// which the build takes in their approximate forms (-use_fast_math).
//
// The two peaks run one after the other through one 128-bin buffer of
// 128 x THREADS floats, 64 KB: above the 48 KB of static shared memory, so
// it is dynamic and the C entry raises the kernel's limit. (64 threads, and
// the peaks side by side in a 256-bin buffer, were measured slower; see
// PERF.md.)

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int D_MAX = 48;                       // 2 * R_DESC of the frontend
constexpr int NSCAL = 9;
constexpr int NBIN = 128;                       // bins of one peak
constexpr int SMEM_BYTES = NBIN * THREADS * static_cast<int>(sizeof(float));
constexpr int MAXPIX = (D_MAX * D_MAX + THREADS - 1) / THREADS;
// Blocks an SM holds by shared memory (228 KB, 1 KB of it reserved per
// block); registers are capped to match.
constexpr int MIN_BLOCKS = (228 * 1024) / (SMEM_BYTES + 1024);
static_assert(NBIN == THREADS, "one bin per thread in the reduction");

// One pixel's eight votes for one peak: 2 cell rows x 2 cell columns x 2
// orientation bins, as (bin, value, inside the grid). The bins are
// distinct, so their load-add-stores may be issued together.
__device__ __forceinline__ void pixel_votes(float ox, float oy, float mag,
                                            float a45, float inv_hw,
                                            float cos_t, float sin_t,
                                            float ori45, int* bin, float* val,
                                            bool* in) {
  const float u = (ox * cos_t + oy * sin_t) * inv_hw;
  const float v = (oy * cos_t - ox * sin_t) * inv_hw;
  const float w = mag * expf((u * u + v * v) * -0.125f);
  const float dd = a45 - ori45;
  const float rel = dd - 8.0f * floorf(dd * 0.125f);
  const float ob = rel - 0.5f;
  const float b0f = floorf(ob);
  const float frac = ob - b0f;
  const float b0m = b0f < 0.0f ? b0f + 8.0f : b0f;
  const float b1m = b0m >= 7.0f ? b0m - 7.0f : b0m + 1.0f;
  const float wf = w * frac;
  const float wo[2] = {w - wf, wf};
  const int o[2] = {static_cast<int>(b0m), static_cast<int>(b1m)};
  // Cell a has its centre at v = a - 1.5: the tent 1 - |v - (a - 1.5)| is
  // 1 - f at a0 = floor(v + 1.5) and f at a0 + 1, zero elsewhere. Clamped
  // before the int conversion; -2 and 4 are outside the grid either way.
  const float vc = v + 1.5f;
  const float uc = u + 1.5f;
  const float a0f = floorf(vc);
  const float c0f = floorf(uc);
  const float fv = vc - a0f;
  const float fu = uc - c0f;
  const int a0 = static_cast<int>(fminf(fmaxf(a0f, -2.0f), 4.0f));
  const int c0 = static_cast<int>(fminf(fmaxf(c0f, -2.0f), 4.0f));
  const float tv[2] = {1.0f - fv, fv};
  const float tu[2] = {1.0f - fu, fu};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int a = a0 + r;
      const int b = c0 + c;
      const bool inside = static_cast<unsigned>(a) < 4u &&
                          static_cast<unsigned>(b) < 4u;
      const float sab = tv[r] * tu[c];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = (r * 2 + c) * 2 + q;
        bin[j] = a * 32 + b * 8 + o[q];
        val[j] = sab * wo[q];
        in[j] = inside;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
descriptor_kernel(const float* __restrict__ wins,
                  const float* __restrict__ scal, int d,
                  float* __restrict__ out) {
  extern __shared__ float4 smem[];
  float* hist = reinterpret_cast<float*>(smem);   // [NBIN][THREADS]
  float* col = hist + threadIdx.x;                // this thread's column
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int k = blockIdx.x;
  const int n = d * d;
  const float* gxw = wins + static_cast<long long>(k) * 2 * n;
  const float* gyw = gxw + n;
  float s[NSCAL];
#pragma unroll
  for (int i = 0; i < NSCAL; ++i) s[i] = __ldg(scal + k * NSCAL + i);

  // All of the thread's loads are issued before any is used (a branch
  // around each would make them wait one after the other); a pixel past n
  // reads pixel n - 1 and is then zeroed.
  float gx[MAXPIX], gy[MAXPIX];
#pragma unroll
  for (int j = 0; j < MAXPIX; ++j) {
    const int i = min(t + j * THREADS, n - 1);
    gx[j] = __ldg(gxw + i);
    gy[j] = __ldg(gyw + i);
  }
  float mag[MAXPIX], a45[MAXPIX];
#pragma unroll
  for (int j = 0; j < MAXPIX; ++j) {
    if (t + j * THREADS >= n) gx[j] = gy[j] = 0.0f;
    mag[j] = sqrtf(gx[j] * gx[j] + gy[j] * gy[j]);
    a45[j] = atan2f(gy[j], gx[j]) * 57.295779513082320876f * (1.0f / 45.0f);
  }

  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int drow = THREADS / d;
  const int dcol = THREADS - drow * d;
#pragma unroll 1
  for (int pk = 0; pk < 2; ++pk) {
    for (int i = t; i < NBIN * THREADS / 4; i += THREADS) smem[i] = zero;
    __syncthreads();

    int row = t / d;
    int cl = t - row * d;
    // Pixels past n (when d * d is not a multiple of THREADS) have zero
    // magnitude and add +0.0 wherever they vote, so no branch skips them.
#pragma unroll
    for (int j = 0; j < MAXPIX; ++j) {
      const float oy = s[0] + static_cast<float>(row);
      const float ox = s[1] + static_cast<float>(cl);
      int bin[8];
      float val[8];
      bool in[8];
      pixel_votes(ox, oy, mag[j], a45[j], s[2], pk ? s[6] : s[3],
                  pk ? s[7] : s[4], pk ? s[8] : s[5], bin, val, in);
      float h[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (in[q]) h[q] = col[bin[q] * THREADS];
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (in[q]) col[bin[q] * THREADS] = h[q] + val[q];
      }
      cl += dcol;
      row += drow;
      if (cl >= d) {
        cl -= d;
        ++row;
      }
    }
    __syncthreads();

    // Bin t is summed by thread t over the THREADS columns, chunk by chunk
    // of 32, in a fixed order.
    const float* hrow = hist + t * THREADS;
    float acc[THREADS / 32];
#pragma unroll
    for (int j0 = 0; j0 < THREADS / 32; ++j0) {
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 32; ++c) sum += hrow[j0 * 32 + ((lane + c) & 31)];
      acc[j0] = sum;
    }
    float total = acc[0];
#pragma unroll
    for (int j0 = 1; j0 < THREADS / 32; ++j0) total += acc[j0];
    out[static_cast<long long>(k) * 2 * NBIN + pk * NBIN + t] = total;
    if (pk == 0) __syncthreads();
  }
}

}  // namespace

// wins: (K, 2, d, d) f32 gradient windows (gx, gy), 1 <= d <= 48. scal:
// (K, 9) f32 rows (oy0, ox0, 1/hist_width, cos0, sin0, ori0/45, cos1, sin1,
// ori1/45). out: (K, 2, 128) f32 raw histograms. Returns a cudaError_t.
extern "C" int sift_descriptor_accumulate(const float* wins,
                                          const float* scal, int K, int d,
                                          float* out, void* stream) {
  if (d < 1 || d > D_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      descriptor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(descriptor_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  descriptor_kernel<<<K, THREADS, SMEM_BYTES,
                      static_cast<cudaStream_t>(stream)>>>(wins, scal, d,
                                                           out);
  return static_cast<int>(cudaGetLastError());
}
