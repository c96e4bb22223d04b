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
// Two pixels never interact: the value a slot sees at pixel p is p's
// first value plus the adds of the earlier slots whose windows cover p,
// in canonical order. So a thread that owns p can hold it in registers
// and walk only those slots. The wrapper (`tile_order`) cuts each plane
// into tiles and gives every tile a list of the slots whose windows
// overlap it, in canonical order (1, 2 or 4 tiles a window), the lists
// laid out one after another (`order`, int32 `keys`, `starts`) with their
// count on the device. A fixed grid of 256-thread blocks takes lists by
// stride up to that count: each thread loads its pixel of both maps once
// (a 16x16 tile, a pixel a thread), the block stages the list in shared
// memory a chunk of 256 entries at a time (slot, corner, orientation; a
// barrier only between chunks), and each thread steps through the
// entries, adding for those that cover its pixel and writing the sum to
// seen; at the end it writes its pixel back. Each pixel and each seen element is written by one
// thread, so there are no atomics and no races. Each pixel gets its adds
// in the plain loop's order, and the file is compiled with -fmad=false:
// the bits equal the plain version's (the orientation map is NaN after
// its first add).
//
// What bounds it: latency, not bytes. A list's head is a chain of
// dependent global loads (start, key; then the pixels and the entries;
// then the entries' table rows) before its walk, which is a few
// instructions an entry; a block takes its lists one after another, 8
// blocks an SM side by side. Its time is about the lists a block takes
// times that chain, plus the longest list.

#include <cuda_runtime.h>

namespace {

constexpr int WIN = 16;      // the window's side
constexpr int TILE = 16;     // the tiles' side, as tile_order cuts them
constexpr int THREADS = TILE * TILE;  // a pixel a thread, row-major
constexpr int CHUNK = THREADS;  // list entries staged at a time

__global__ void __launch_bounds__(THREADS)
    parity_scan_kernel(float* maps, const float* __restrict__ weight_tl,
                       const float* __restrict__ orientation,
                       const int* __restrict__ table,
                       const long long* __restrict__ order,
                       const int* __restrict__ keys,
                       const long long* __restrict__ starts,
                       const long long* __restrict__ count, float* seen,
                       int H, int W, int TY, int TX) {
  __shared__ float wtl[WIN * WIN];
  __shared__ int slot[CHUNK];
  __shared__ int y0s[CHUNK];
  __shared__ int x0s[CHUNK];
  __shared__ float ori[CHUNK];

  const int t = threadIdx.x;
  const long long plane_px = static_cast<long long>(H) * W;
  const long long lists = *count;
  for (long long k = blockIdx.x; k < lists; k += gridDim.x) {
    const long long begin = starts[k], end = starts[k + 1];
    const int key = keys[begin];  // (plane * TY + ty) * TX + tx
    const long long plane = key / (TY * TX);
    const int tile = key % (TY * TX);
    float* plane_p = maps + plane * 2 * plane_px;
    const int py = (tile / TX) * TILE + t / TILE;
    const int px = (tile % TX) * TILE + t % TILE;
    // A window lies inside the maps, so it never covers a pixel past
    // them: this test only guards the pixel's own load and store.
    const bool inside = py < H && px < W;
    const long long at = static_cast<long long>(py) * W + px;
    float mag = inside ? plane_p[at] : 0.f;
    float dir = inside ? plane_p[plane_px + at] : 0.f;
    for (long long c0 = begin; c0 < end; c0 += CHUNK) {
      const int n = static_cast<int>(min(static_cast<long long>(CHUNK),
                                         end - c0));
      __syncthreads();  // the previous chunk's (or list's) staging is read
      if (c0 == begin) wtl[t] = weight_tl[plane * (WIN * WIN) + t];
      if (t < n) {
        const int s = static_cast<int>(order[c0 + t] >> 2);  // 4 a slot
        const int* row = table + static_cast<long long>(s) * 5;
        slot[t] = s;
        y0s[t] = row[2];
        x0s[t] = row[3];
        ori[t] = orientation[s];
      }
      __syncthreads();
      for (int j = 0; j < n; ++j) {
        const unsigned dy = static_cast<unsigned>(py - y0s[j]);
        const unsigned dx = static_cast<unsigned>(px - x0s[j]);
        if (dy < WIN && dx < WIN) {
          mag += wtl[dy * WIN + dx];
          dir += ori[j];
          float* out = seen +
                       static_cast<long long>(slot[j]) * (2 * WIN * WIN) +
                       dy * WIN + dx;
          out[0] = mag;
          out[WIN * WIN] = dir;
        }
      }
    }
    if (inside) {
      plane_p[at] = mag;
      plane_p[plane_px + at] = dir;
    }
  }
}

}  // namespace

// Walk the tile lists of `maps` (planes x 2 maps of H x W, cut into 16x16
// tiles) in one launch of `blocks` blocks on `stream`: list k is
// order[starts[k]:starts[k + 1]], all of tile keys[starts[k]], for k <
// *count (read on the device); an entry is 4 * slot + i, a slot a row of
// `table` (gauss_o, gauss_l, y0, x0, ok; int32) among `slots`. Writes `seen` (slots x 2 x 16 x 16). Returns the launch's
// cudaError_t; 1 (invalid value) for a shape the kernel cannot take.
extern "C" int sift_parity_scan(float* maps, const float* weight_tl,
                                const float* orientation, const int* table,
                                const long long* order, const int* keys,
                                const long long* starts,
                                const long long* count, float* seen,
                                long long slots, int H, int W,
                                int blocks, cudaStream_t stream) {
  if (slots < 1 || slots > 0x7fffffffLL || H < WIN || W < WIN ||
      static_cast<long long>(H) * W > 0x7fffffffLL || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int TY = (H + TILE - 1) / TILE, TX = (W + TILE - 1) / TILE;
  parity_scan_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      maps, weight_tl, orientation, table, order, keys, starts, count, seen,
      H, W, TY, TX);
  return static_cast<int>(cudaGetLastError());
}
