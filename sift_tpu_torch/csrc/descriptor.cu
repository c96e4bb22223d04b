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
// Bound on the H100: bytes (the window is read once; about 150 f32 ops
// per pixel for both peaks). One block per keypoint; threads stride over
// the window pixels and add only the non-zero votes (at most 2x2 cells x
// 2 bins per peak) into a per-warp copy of the histogram in shared
// memory, with shared atomics; the copies are summed in warp order at the
// end. Atomic order within a warp varies from run to run, so results
// agree with the plain version to a tolerance, not bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NBINS = 2 * 128;
constexpr int NSCAL = 9;

__global__ void __launch_bounds__(THREADS)
descriptor_kernel(const float* __restrict__ wins,
                  const float* __restrict__ scal, int d,
                  float* __restrict__ out) {
  __shared__ float hist[WARPS][NBINS];
  const int k = blockIdx.x;
  const int warp = threadIdx.x / 32;
  for (int t = threadIdx.x; t < WARPS * NBINS; t += THREADS) {
    (&hist[0][0])[t] = 0.0f;
  }
  __syncthreads();

  const int n = d * d;
  const float* gxw = wins + static_cast<long long>(k) * 2 * n;
  const float* gyw = gxw + n;
  const float* sc = scal + k * NSCAL;
  const float oy0 = sc[0], ox0 = sc[1], inv_hw = sc[2];
  const float cc[4] = {-1.5f, -0.5f, 0.5f, 1.5f};

  for (int i = threadIdx.x; i < n; i += THREADS) {
    const float gx = gxw[i];
    const float gy = gyw[i];
    const float mag = sqrtf(gx * gx + gy * gy);
    const float a45 = atan2f(gy, gx) * 57.295779513082320876f * (1.0f / 45.0f);
    const int row = i / d;
    const float oy = oy0 + static_cast<float>(row);
    const float ox = ox0 + static_cast<float>(i - row * d);
#pragma unroll
    for (int pk = 0; pk < 2; ++pk) {
      const float cos_t = sc[3 + 3 * pk];
      const float sin_t = sc[4 + 3 * pk];
      const float ori45 = sc[5 + 3 * pk];
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
      const float w1f = w - wf;
      const int b0 = static_cast<int>(b0m);
      const int b1 = static_cast<int>(b1m);
      float* h = hist[warp] + pk * 128;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float tva = fmaxf(0.0f, 1.0f - fabsf(v - cc[a]));
        if (tva == 0.0f) continue;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const float tub = fmaxf(0.0f, 1.0f - fabsf(u - cc[b]));
          if (tub == 0.0f) continue;
          const float sab = tva * tub;
          atomicAdd(h + a * 32 + b * 8 + b0, sab * w1f);
          atomicAdd(h + a * 32 + b * 8 + b1, sab * wf);
        }
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < NBINS; t += THREADS) {
    float s = 0.0f;
    for (int w = 0; w < WARPS; ++w) s += hist[w][t];
    out[static_cast<long long>(k) * NBINS + t] = s;
  }
}

}  // namespace

// wins: (K, 2, d, d) f32 gradient windows (gx, gy). scal: (K, 9) f32 rows
// (oy0, ox0, 1/hist_width, cos0, sin0, ori0/45, cos1, sin1, ori1/45).
// out: (K, 2, 128) f32 raw histograms. Returns cudaGetLastError().
extern "C" int sift_descriptor_accumulate(const float* wins,
                                          const float* scal, int K, int d,
                                          float* out, void* stream) {
  descriptor_kernel<<<K, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      wins, scal, d, out);
  return static_cast<int>(cudaGetLastError());
}
