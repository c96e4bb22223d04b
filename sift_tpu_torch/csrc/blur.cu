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
// The stencil runs along W, then along H. For output pixel i of a line of
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
// Bound on the H100: bytes (each pixel read once and written once), but
// at r = 10 the 4(2r + 1) unfused f32 operations a pixel come close to
// it, so the design keeps the arithmetic free of overhead:
// - One launch a call, both passes fused. A block owns a TH x TW output
//   tile of one plane. It stages the tile's input with an r-wide halo on
//   every side in shared memory by asynchronous copies (cp.async, every
//   copy of a thread in flight at once), folding the mirror index once
//   per staged element (the inner loops never fold), runs the W pass over
//   the TH + 2r staged rows into a second shared buffer, and the H pass
//   from there into the output. A halo row's W pass equals the W pass of
//   the row it mirrors, so neighbouring tiles recompute their shared halo
//   rows with the same bits. No scratch stack.
// - Register reuse. A thread computes P outputs of a line: P consecutive
//   columns of a row in the W pass, P consecutive rows of a column in the
//   H pass. Each value read from shared memory feeds every output whose
//   window holds it (a window of P values slides along the line), and
//   each output keeps its own accumulator and its own tap order.
// - Bank-conflict-free shared memory: in the W pass a warp's lanes take
//   consecutive rows (odd row pitches), in the H pass consecutive columns.
// - Taps by value (a __grid_constant__ kernel parameter in the constant
//   bank): no device array, no copy before the launch.
// - The grid is one dimension over (tiles in x, tiles in y, planes), so
//   no axis is capped at 65,535. The tile shape and a strip height S come
//   from the wrapper's `tile_plan` (kernels/cuda/blur.py): the largest of
//   64 x 64, 32 x 64 and 32 x 32 tiles that gives the call a thousand
//   blocks (enough to overlap one's staging with another's arithmetic), and
//   large radii stage their input S rows at a time so that the staged
//   rows and the (TH + 2r) x TW W-pass buffer fit in shared memory.
// Measured designs that lost (PERF.md): plain staged loads, and register
// staging 8 loads deep, both slower than cp.async; P = 4; a persistent
// grid that double-buffers the next tile's staging.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int P = 8;            // outputs a thread computes along a line
constexpr int MAX_TAPS = 1001;  // 4,004 bytes of taps: r <= 500

struct Taps {
  float v[MAX_TAPS];
};

__device__ __forceinline__ int mirror(int j, int n) {
  if (j >= 0 && j < n) return j;
  if (n == 1) return 0;
  const int period = 2 * n - 2;
  j %= period;
  if (j < 0) j += period;
  return j < n ? j : period - j;
}

// acc[i] = sum_k s[(i + k) * step] * t[k] in tap order, i < P: the
// stencil along a line of shared memory. The window w holds the P values
// s[(k + i) * step] of tap k; w[(m) % P] holds offset m, so every index
// below is a compile-time constant once the loops are unrolled (taps go
// in blocks of P, starting at k = 1).
__device__ __forceinline__ void stencil_line(const float* s, int step,
                                             const Taps& t, int ntaps,
                                             float (&acc)[P]) {
  float w[P];
#pragma unroll
  for (int i = 0; i < P; ++i) w[i] = s[i * step];
  const float t0 = t.v[0];
#pragma unroll
  for (int i = 0; i < P; ++i) acc[i] = w[i] * t0;
  for (int k0 = 1; k0 < ntaps; k0 += P) {
    const bool full = k0 + P <= ntaps;
#pragma unroll
    for (int u = 0; u < P; ++u) {
      if (full || k0 + u < ntaps) {
        const int k = k0 + u;
        // offset k + P - 1 replaces offset k - 1, in slot (u + P) % P = u
        w[u] = s[(k + P - 1) * step];
        const float tk = t.v[k];
#pragma unroll
        for (int i = 0; i < P; ++i)
          acc[i] = acc[i] + w[(u + 1 + i) % P] * tk;
      }
    }
  }
}

// One block: output tile (ty0, tx0) of one plane, TH x TW (TH and TW
// multiples of P), staged S rows at a time. Shared memory: the W-pass
// buffer, (TH + 2r) rows of pitch TW + 1, then the staged input, S rows
// of TW + 2r columns at an odd pitch. A warp stages a row at a time, its
// lanes on consecutive columns, so the reads of the input are coalesced.
__global__ void __launch_bounds__(THREADS)
    blur_fused_kernel(const float* __restrict__ in, float* __restrict__ out,
                      const __grid_constant__ Taps taps, int ntaps, int H,
                      int W, int TH, int TW, int S, int tiles_x,
                      int tiles_y) {
  extern __shared__ float smem[];
  const int r = (ntaps - 1) / 2;
  const int rows = TH + 2 * r;             // staged rows
  const int cols = TW + 2 * r;             // staged columns
  const int pmid = TW + 1;
  const int pin = cols | 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* mid = smem;
  float* stage = smem + rows * pmid;

  long long b = blockIdx.x;
  const int tx = static_cast<int>(b % tiles_x);
  b /= tiles_x;
  const int ty = static_cast<int>(b % tiles_y);
  const long long plane = b / tiles_y;
  const int tx0 = tx * TW, ty0 = ty * TH;
  const float* src = in + plane * H * W;
  float* dst = out + plane * H * W;

  // the W pass, strip by strip of staged rows
  const int groups = TW / P;
  for (int s0 = 0; s0 < rows; s0 += S) {
    const int n = min(S, rows - s0);
    for (int row = warp; row < n; row += WARPS) {
      const float* line =
          src + static_cast<long long>(mirror(ty0 - r + s0 + row, H)) * W;
      for (int col = lane; col < cols; col += 32)
        __pipeline_memcpy_async(stage + row * pin + col,
                                line + mirror(tx0 - r + col, W), 4);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int e = threadIdx.x; e < n * groups; e += THREADS) {
      const int g = e / n, row = e - g * n;  // a warp's lanes: rows
      float acc[P];
      stencil_line(stage + row * pin + g * P, 1, taps, ntaps, acc);
      float* m = mid + (s0 + row) * pmid + g * P;
#pragma unroll
      for (int i = 0; i < P; ++i) m[i] = acc[i];
    }
    __syncthreads();
  }

  // the H pass: P rows of one column a thread, a warp's lanes: columns
  for (int e = threadIdx.x; e < TW * (TH / P); e += THREADS) {
    const int g = e / TW, col = e - g * TW;
    float acc[P];
    stencil_line(mid + g * P * pmid + col, pmid, taps, ntaps, acc);
    const int x = tx0 + col;
    if (x < W) {
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int y = ty0 + g * P + i;
        if (y < H) dst[static_cast<long long>(y) * W + x] = acc[i];
      }
    }
  }
}

}  // namespace

// Blur `planes` (H, W) planes of `in` into `out` with `ntaps` taps read
// from the host array `taps`, on `stream`, in tiles of TH x TW staged S
// rows at a time with `smem` bytes of dynamic shared memory (all from
// `tile_plan`). Returns the launch's cudaError_t; 1 (invalid value) for
// a plan or a tap count the kernel cannot take.
extern "C" int sift_blur(const float* in, float* out, const float* taps,
                         int ntaps, long long planes, int H, int W, int TH,
                         int TW, int S, int smem, cudaStream_t stream) {
  if (ntaps < 1 || ntaps > MAX_TAPS || ntaps % 2 == 0 || TH % P ||
      TW % P || S < 1 || TH < P || TW < P)
    return static_cast<int>(cudaErrorInvalidValue);
  Taps t;
  for (int k = 0; k < ntaps; ++k) t.v[k] = taps[k];
  const long long tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const long long blocks = tiles_x * tiles_y * planes;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        blur_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  blur_fused_kernel<<<static_cast<unsigned>(blocks), THREADS, smem,
                      stream>>>(in, out, t, ntaps, H, W, TH, TW, S,
                                static_cast<int>(tiles_x),
                                static_cast<int>(tiles_y));
  return static_cast<int>(cudaGetLastError());
}
