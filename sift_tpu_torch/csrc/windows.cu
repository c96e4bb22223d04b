// Per-keypoint window gather from channel-stacked maps (sm_90a).
//
// Replaces the TPU kernel sift_tpu/kernels/pallas/windows.py
// (gather_windows_pallas, body _window_kernel). One (C, d, d) window per
// keypoint k, cut from level gl[k] of every channel at top-left
// (y0[k], x0[k]), written as float32. The copy is exact: a bf16 map value
// is widened to f32 without rounding. Pixels outside the map read 0.
//
// Bound on the H100: bytes. Each window pixel is read once and written
// once; there is no arithmetic. One block per (keypoint, channel): the
// threads walk the window in row-major order, so neighbouring threads
// read neighbouring addresses of one map row and write neighbouring
// output addresses. The TPU kernel's band DMAs, lane rolls and one-hot
// row selection were workarounds for its (8, 128) tiling and are gone.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

template <typename T>
__device__ __forceinline__ float widen(T v);

template <>
__device__ __forceinline__ float widen<float>(float v) { return v; }

template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void gather_windows_kernel(const T* __restrict__ maps,
                                      long long c_stride, long long l_stride,
                                      int L, int H, int W,
                                      const int* __restrict__ gl,
                                      const int* __restrict__ y0,
                                      const int* __restrict__ x0,
                                      int d, float* __restrict__ out) {
  const int k = blockIdx.x;
  const int c = blockIdx.y;
  const int C = gridDim.y;
  const int lvl = gl[k];
  const int ys = y0[k];
  const int xs = x0[k];
  const bool lvl_ok = lvl >= 0 && lvl < L;
  const T* src = maps + c * c_stride + (long long)lvl * l_stride;
  float* dst = out + ((long long)k * C + c) * d * d;
  const int n = d * d;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / d;
    const int y = ys + r;
    const int x = xs + (i - r * d);
    float v = 0.0f;
    if (lvl_ok && y >= 0 && y < H && x >= 0 && x < W) {
      v = widen<T>(src[(long long)y * W + x]);
    }
    dst[i] = v;
  }
}

// maps: element (c, l, y, x) at c*c_stride + l*l_stride + y*W + x.
// gl, y0, x0: (K,) int32 on the device. out: (K, C, d, d) float32.
// Returns cudaGetLastError() after the launch.
extern "C" int sift_gather_windows(const void* maps, int is_bf16,
                                   long long c_stride, long long l_stride,
                                   int C, int L, int H, int W,
                                   const int* gl, const int* y0,
                                   const int* x0, int K, int d, float* out,
                                   void* stream) {
  const dim3 grid(K, C);
  const int threads = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    gather_windows_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(maps), c_stride, l_stride, L, H, W,
        gl, y0, x0, d, out);
  } else {
    gather_windows_kernel<float><<<grid, threads, 0, s>>>(
        static_cast<const float*>(maps), c_stride, l_stride, L, H, W,
        gl, y0, x0, d, out);
  }
  return static_cast<int>(cudaGetLastError());
}
