// Separable, mirror-bordered Gaussian blur of an f32 stack (sm_90a).
//
// Replaces no TPU kernel: sift_tpu/kernels/gaussian.py blurs with XLA's
// conv_general_dilated or an einsum. It is here because the port's blur
// must round the same way at every batch size and on every device. Two
// matrix products with the mirror border folded into a banded operator
// (what the port did before) sum in an order that cuBLAS picks from the
// batch size, so the extraction of one image depended on how many others
// shared its batch. This kernel repeats the plain version's shifted-add
// stencil (kernels/cuda/blur.py, `stencil_1d`) term for term.
//
// Each pass takes one axis of a (N, H, W) stack: along W into a scratch
// stack, then along H into the output. For output pixel i of a line of
// length n, with r = (ntaps - 1) / 2,
//
//   acc = p[0] * t[0];  acc = acc + p[k] * t[k]  for k = 1 .. 2r,
//
// where p[k] is the input at mirror(i + k - r): scipy's "mirror" border
// (the edge is not repeated), folded by the period 2n - 2 so that any
// radius works, and 0 for n == 1. Every product and every sum rounds on
// its own, in tap order, as the stencil's elementwise multiply and add
// do: this file is compiled with -fmad=false, so no product is fused
// into a sum. The result is then bit-identical to the plain version on
// the CPU and on the card, whatever the batch.
//
// Bound on the H100: bytes. The stack is read once and written once by
// each pass (the scratch stack in between), at 2(2r + 1) flops a pixel a
// pass, far under the card's f32 rate. One thread computes one output
// pixel of one pass; neighbouring threads take neighbouring x, so the
// reads of a warp's taps are coalesced on both passes and the 2r + 1
// re-reads of a pixel hit L1/L2. Only outputs within r of the border fold
// the index (two integer divisions a tap); the others read their taps in
// a straight line. The taps are a small device array (any radius). A
// fused two-pass tile in shared memory would save the scratch round
// trip; that is later work.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ int mirror(int j, int n) {
  if (n == 1) return 0;
  const int period = 2 * n - 2;
  j %= period;
  if (j < 0) j += period;
  return j < n ? j : period - j;
}

// One pass over a (N, H, W) stack. along_h == 0: out[l, x] from in[l, *]
// along W, for line l of N * H. along_h == 1: out[n, y, x] from
// in[n, *, x] along H. Blocks tile x in THREADS and walk the N * H rows
// in a grid-stride loop over blockIdx.y.
__global__ void __launch_bounds__(THREADS)
    blur_pass_kernel(const float* __restrict__ in, float* __restrict__ out,
                     const float* __restrict__ taps, int ntaps,
                     long long rows, int H, int W, int along_h) {
  const int x = blockIdx.x * THREADS + threadIdx.x;
  if (x >= W) return;
  const int r = (ntaps - 1) / 2;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    float acc;
    if (along_h) {
      const int y = static_cast<int>(row % H);
      const float* plane = in + (row - y) * W + x;
      if (y >= r && y + r < H) {       // every tap inside: no fold
        const float* p = plane + static_cast<long long>(y - r) * W;
        acc = p[0] * taps[0];
        for (int k = 1; k < ntaps; ++k)
          acc = acc + p[static_cast<long long>(k) * W] * taps[k];
      } else {
        acc = plane[static_cast<long long>(mirror(y - r, H)) * W] * taps[0];
        for (int k = 1; k < ntaps; ++k)
          acc = acc +
                plane[static_cast<long long>(mirror(y + k - r, H)) * W] *
                    taps[k];
      }
    } else {
      const float* line = in + row * W;
      if (x >= r && x + r < W) {
        const float* p = line + x - r;
        acc = p[0] * taps[0];
        for (int k = 1; k < ntaps; ++k) acc = acc + p[k] * taps[k];
      } else {
        acc = line[mirror(x - r, W)] * taps[0];
        for (int k = 1; k < ntaps; ++k)
          acc = acc + line[mirror(x + k - r, W)] * taps[k];
      }
    }
    out[row * W + x] = acc;
  }
}

}  // namespace

extern "C" int sift_blur(const float* in, float* scratch, float* out,
                         const float* taps, int ntaps, long long planes,
                         int H, int W, cudaStream_t stream) {
  const long long rows = planes * H;
  const dim3 grid((W + THREADS - 1) / THREADS,
                  static_cast<unsigned>(rows < MAX_GRID_Y ? rows
                                                          : MAX_GRID_Y));
  blur_pass_kernel<<<grid, THREADS, 0, stream>>>(in, scratch, taps, ntaps,
                                                 rows, H, W, 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  blur_pass_kernel<<<grid, THREADS, 0, stream>>>(scratch, out, taps, ntaps,
                                                 rows, H, W, 1);
  return static_cast<int>(cudaGetLastError());
}
