// u8 -> f32 normalize with a per-image horizontal flip and cutout box, for
// Hopper (sm_90a).
//
// Replaces fedmlp_tpu/ops/pallas_ops.py::fused_normalize_flip_cutout (kernel
// body _norm_kernel). Per image, NHWC in and out:
//
//   v = src[b][y][flip_b ? W - 1 - x : x][c]
//   if (x0 <= x < x1 and y0 <= y < y1)  v = 127     (box in OUTPUT coordinates,
//                                                    filled before normalizing)
//   out[b][y][x][c] = (v - 255 * mean_c) / (255 * std_c)
//
// A zero box (x0 = y0 = x1 = y1 = 0) disables the cutout. Null `flips` or
// `boxes` mean no flip and no box for every image.
//
// Bound: device-memory bytes, 3 bytes read and 12 written a pixel; the
// arithmetic is a subtract and a divide. Design: one thread per pixel (all
// three channels), a block per run of pixels of one image row, so the flip
// and the box test are per thread and the three f32 stores of neighbouring
// threads fill whole lines. The TPU kernel reverses the lane dimension of a
// whole image held in VMEM; here the flip is only the address of the load.
//
// The division is __fdiv_rn in the plain version's order (fedmlp_tpu_torch/
// ops/pallas_ops.py::normalize_flip_cutout_ref), so the two agree to the
// last bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kFillGray = 127.0f;

__global__ void normalize_flip_cutout_kernel(
    const uint8_t* __restrict__ src, const int* __restrict__ flips,
    const int* __restrict__ boxes, float* __restrict__ out, int H, int W,
    float m0, float m1, float m2, float sd0, float sd1, float sd2) {
  const int b = blockIdx.z;
  const int y = blockIdx.y;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= W) return;
  const bool flipped = flips != nullptr && flips[b] > 0;
  bool inside = false;
  if (boxes != nullptr) {
    const int* bx = boxes + 4 * b;
    inside = x >= bx[0] && x < bx[2] && y >= bx[1] && y < bx[3];
  }
  const size_t row = ((size_t)b * H + y) * W;
  const uint8_t* p = src + (row + (flipped ? W - 1 - x : x)) * 3;
  float v0 = inside ? kFillGray : (float)p[0];
  float v1 = inside ? kFillGray : (float)p[1];
  float v2 = inside ? kFillGray : (float)p[2];
  float* q = out + (row + x) * 3;
  q[0] = __fdiv_rn(__fsub_rn(v0, m0), sd0);
  q[1] = __fdiv_rn(__fsub_rn(v1, m1), sd1);
  q[2] = __fdiv_rn(__fsub_rn(v2, m2), sd2);
}

}  // namespace

extern "C" {

// src u8 [B, H, W, 3], flips i32 [B] or null, boxes i32 [B, 4] rows of
// (x0, y0, x1, y1) or null -> out f32 [B, H, W, 3]. mean255/std255 are
// 255 * mean_c and 255 * std_c. Launches on `stream` and returns
// cudaGetLastError(); -1 for a shape that the launch grid cannot hold.
int normalize_flip_cutout_u8(const void* src, const void* flips,
                             const void* boxes, void* out, int B, int H, int W,
                             float m0, float m1, float m2, float sd0,
                             float sd1, float sd2, void* stream) {
  if (H > 65535 || B > 65535) return -1;
  dim3 grid((W + kThreads - 1) / kThreads, H, B);
  normalize_flip_cutout_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)src, (const int*)flips, (const int*)boxes, (float*)out,
      H, W, m0, m1, m2, sd0, sd1, sd2);
  return (int)cudaGetLastError();
}

}  // extern "C"
