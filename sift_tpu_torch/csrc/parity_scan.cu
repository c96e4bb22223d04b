// The ordered descriptor-stage walk of parity mode (sm_90a).
//
// Replaces no TPU kernel: the JAX package carries this walk as the
// pyramids of a lax.scan over the keypoints (sift_tpu/frontend/parity.py,
// `descriptor_scan_parity`). The plain version is
// kernels/cuda/parity_scan.py::parity_scan_plain.
//
// Each slot s with `ok`, in canonical order, adds to the 16x16 window at
// (y0, x0) of its plane (b, gauss_o, gauss_l), in both maps: the plane's
// weight_tl to the magnitude map, the slot's orientation to the
// orientation map; it then sees the window after its own add, seen[s].
// Later slots read those writes where their windows overlap.
//
// Two planes never share memory, so only the order within a plane
// matters. The wrapper stable-sorts the ok slots by plane (`order`) and
// finds each plane's segment (`starts`). One block walks one plane, 512
// threads, one per (map, dy, dx): it stages up to 512 of the plane's slots
// at a time in shared memory (slot, window offset, orientation), then
// steps through them; a step is one load, one f32 add, one store to the
// map and one to seen, and a barrier, which makes the block's global
// writes visible to the next step, whose window may map the same pixel to
// another thread. Each pixel so gets its adds in the plain loop's order,
// and the file is compiled with -fmad=false: the bits equal the plain
// version's (the orientation map is NaN after its first add).
//
// The walk is a chain of dependent steps: its time is about the longest
// plane's slot count times one global round trip, not its bytes.

#include <cuda_runtime.h>

namespace {

constexpr int WIN = 16;
constexpr int WIN2 = WIN * WIN;
constexpr int THREADS = 2 * WIN2;  // one per (map, dy, dx)

__global__ void __launch_bounds__(THREADS)
    parity_scan_kernel(float* maps, const float* __restrict__ weight_tl,
                       const float* __restrict__ orientation,
                       const int* __restrict__ table,
                       const long long* __restrict__ order,
                       const long long* __restrict__ starts, float* seen,
                       int H, int W) {
  __shared__ long long slot[THREADS];
  __shared__ int offset[THREADS];
  __shared__ float ori[THREADS];

  const long long plane = blockIdx.x;  // (b * O + gauss_o) * Lg + gauss_l
  const long long begin = starts[plane], end = starts[plane + 1];
  if (begin == end) return;
  const int t = threadIdx.x;
  const int m = t / WIN2, dy = (t / WIN) % WIN, dx = t % WIN;
  float* map = maps + (plane * 2 + m) * static_cast<long long>(H) * W +
               static_cast<long long>(dy) * W + dx;
  const float w = weight_tl[plane * WIN2 + dy * WIN + dx];

  for (long long c0 = begin; c0 < end; c0 += THREADS) {
    const int n = static_cast<int>(min(static_cast<long long>(THREADS),
                                       end - c0));
    __syncthreads();  // the previous chunk's staging is no longer read
    if (t < n) {
      const long long s = order[c0 + t];
      const int* row = table + s * 5;
      slot[t] = s;
      offset[t] = row[2] * W + row[3];
      ori[t] = orientation[s];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      float* p = map + offset[j];
      const float v = *p + (m == 0 ? w : ori[j]);
      *p = v;
      seen[slot[j] * THREADS + t] = v;
      __syncthreads();
    }
  }
}

}  // namespace

// Walk the `planes` planes of `maps` (planes x 2 maps of H x W) in one
// launch on `stream`: block p the slots order[starts[p]:starts[p + 1]]
// of the `slots` rows of `table` (gauss_o, gauss_l, y0, x0, ok; int32),
// writing `seen` (slots x 2 x 16 x 16). Returns the launch's
// cudaError_t; 1 (invalid value) for a shape the kernel cannot take.
extern "C" int sift_parity_scan(float* maps, const float* weight_tl,
                                const float* orientation, const int* table,
                                const long long* order,
                                const long long* starts, float* seen,
                                long long planes, long long slots, int H,
                                int W, cudaStream_t stream) {
  if (planes < 1 || planes > 0x7fffffffLL || slots < 1 || H < WIN ||
      W < WIN || static_cast<long long>(H) * W > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  parity_scan_kernel<<<static_cast<unsigned>(planes), THREADS, 0, stream>>>(
      maps, weight_tl, orientation, table, order, starts, seen, H, W);
  return static_cast<int>(cudaGetLastError());
}
