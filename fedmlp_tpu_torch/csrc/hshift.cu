// Per-row fractional shift with zero fill for Hopper (sm_90a).
//
// Replaces fedmlp_tpu/ops/pallas_warp.py::hshift_rows_pallas (kernel body
// _hshift_kernel), batched where the JAX package vmaps it over images. One
// shear pass of the Paeth three-shear warp and of the RandAugment geometric
// ops:
//
//   axis 1 (rows shifted along x, shifts [B, H]):
//     out[b][c][y][x] = (1 - w) * in[b][c][y][x + k] + w * in[b][c][y][x + k + 1]
//     s = shifts[b][y]
//   axis 0 (columns shifted along y, shifts [B, W]):
//     out[b][c][y][x] = (1 - w) * in[b][c][y + k][x] + w * in[b][c][y + k + 1][x]
//     s = shifts[b][x]
//   k = floor(s), w = s - k, a tap outside the plane reads 0.
//
// The TPU kernel pads the row to a multiple of 128 lanes, rotates it and
// takes an aligned slice, which bounds |s| by its margin; its vertical pass
// runs on a transposed copy. Here every output element computes its two tap
// addresses, so any shift is exact (a shift beyond the plane gives zeros),
// and the vertical pass indexes the same layout: no padded or transposed
// copy is written.
//
// Bound: device-memory bytes, the plane read once and written once (8 bytes
// an element against 4 flops). Design: one block per row of one (image,
// channel) plane, threads along x, so stores are coalesced and the shifted
// loads are coalesced but for their alignment (axis 1) or follow the row
// that each column's shift selects (axis 0, where neighbouring columns
// mostly share k). Loads are per element: a shifted row starts at any
// alignment and W need not be a multiple of a vector width.
//
// Every product and sum is rounded on its own (__fmul_rn/__fadd_rn) in the
// order of the plain PyTorch version (fedmlp_tpu_torch/ops/warp.py::
// hshift_rows_ref), so an integer shift is an exact copy and the two agree
// to the last bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float lerp_rn(float lo, float hi, float w) {
  return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, w), lo), __fmul_rn(w, hi));
}

// k = floor(s) clamped to [-(n + 1), n + 1] (beyond that every tap is
// outside anyway, and the clamp keeps the float-to-int conversion defined),
// w = s - floor(s).
__device__ __forceinline__ void split_shift(float s, int n, int* k, float* w) {
  float kf = floorf(s);
  *w = __fsub_rn(s, kf);
  *k = (int)fminf(fmaxf(kf, -(float)(n + 1)), (float)(n + 1));
}

template <int AXIS>
__global__ void hshift_kernel(const float* __restrict__ in,
                              const float* __restrict__ shifts,
                              float* __restrict__ out, int C, int H, int W) {
  const int plane = blockIdx.x;  // b * C + c
  const int y = blockIdx.y;
  const int b = plane / C;
  const float* src = in + (size_t)plane * H * W;
  float* dst = out + ((size_t)plane * H + y) * W;
  if (AXIS == 1) {
    int k;
    float w;
    split_shift(shifts[(size_t)b * H + y], W, &k, &w);
    const float* row = src + (size_t)y * W;
    for (int x = threadIdx.x; x < W; x += blockDim.x) {
      int x0 = x + k;
      float lo = (x0 >= 0 && x0 < W) ? row[x0] : 0.0f;
      float hi = (x0 + 1 >= 0 && x0 + 1 < W) ? row[x0 + 1] : 0.0f;
      dst[x] = lerp_rn(lo, hi, w);
    }
  } else {
    const float* sh = shifts + (size_t)b * W;
    for (int x = threadIdx.x; x < W; x += blockDim.x) {
      int k;
      float w;
      split_shift(sh[x], H, &k, &w);
      int y0 = y + k;
      float lo = (y0 >= 0 && y0 < H) ? src[(size_t)y0 * W + x] : 0.0f;
      float hi = (y0 + 1 >= 0 && y0 + 1 < H) ? src[(size_t)(y0 + 1) * W + x]
                                             : 0.0f;
      dst[x] = lerp_rn(lo, hi, w);
    }
  }
}

}  // namespace

extern "C" {

// in, out f32 [B, C, H, W] contiguous; shifts f32 [B, H] (axis 1) or [B, W]
// (axis 0). Launches on `stream` and returns cudaGetLastError(); -1 for an
// axis or a shape that the launch grid cannot hold.
int hshift_rows_f32(const void* in, const void* shifts, void* out, int B,
                    int C, int H, int W, int axis, void* stream) {
  if ((axis != 0 && axis != 1) || H > 65535 ||
      (long long)B * C > 2147483647LL)
    return -1;
  dim3 grid(B * C, H);
  int threads = W < kThreads ? ((W + 31) / 32) * 32 : kThreads;
  if (axis == 1)
    hshift_kernel<1><<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const float*)in, (const float*)shifts, (float*)out, C, H, W);
  else
    hshift_kernel<0><<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const float*)in, (const float*)shifts, (float*)out, C, H, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
