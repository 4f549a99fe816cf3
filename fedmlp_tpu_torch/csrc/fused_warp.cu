// Weak-view warp + normalize for Hopper (sm_90a).
//
// Replaces fedmlp_tpu/ops/pallas_warp.py::fused_warp_normalize (kernel body
// _fused_warp_kernel). Per image and channel it applies three fractional
// row shears (horizontal, vertical, horizontal) with zero fill outside the
// image, then normalizes:
//
//   pass p: out[y][x] = (1 - w) * in[y][x + k] + w * in[y][x + k + 1]
//           s = slope_p * (i - center_p) + offset_p, k = floor(s), w = s - k
//           (i is the row y for passes 1 and 3, the column x for pass 2,
//            which shifts along y)
//   result: (v - 255 * mean_c) / (255 * std_c)
//
// Bound: device-memory bytes. Each 224^2 image reads 150,528 B of u8 and
// writes 602,112 B of f32; the arithmetic (8 taps and 7 lerps a pixel) is
// far below the card's rate. Design: one block per (row tile, channel,
// image) stages that channel's u8 plane in shared memory (50,176 B at
// S = 224), applying the horizontal flip while it reads, and every output
// pixel composes its three lerps directly from the staged plane: two
// pass-3 taps, each built from two pass-2 taps, each built from two pass-1
// taps. No f32 intermediate touches device memory, so the kernel reads the
// u8 source and writes the f32 result once each (the row tiles re-read the
// plane from L2). The f32 image that the TPU kernel kept resident (602 KB)
// would not fit in a block's 227 KB.
//
// Every product and sum is rounded on its own (__fmul_rn/__fadd_rn), in the
// order of the plain PyTorch version (fedmlp_tpu_torch/ops/warp.py::
// fused_warp_normalize_ref), so the compiler cannot contract them into
// FMAs and the two agree to the last bit on the same inputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerTile = 64;

__device__ __forceinline__ float lerp_rn(float lo, float hi, float w) {
  return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, w), lo), __fmul_rn(w, hi));
}

__device__ __forceinline__ void shear_row(const float* p, int i, int* k,
                                          float* w) {
  // s = slope * (i - center) + offset
  float s = __fadd_rn(__fmul_rn(p[0], __fsub_rn((float)i, p[2])), p[1]);
  float kf = floorf(s);
  *k = (int)kf;
  *w = __fsub_rn(s, kf);
}

__global__ void fused_warp_kernel(const uint8_t* __restrict__ src,
                                  const float* __restrict__ params,
                                  const uint8_t* __restrict__ flip,
                                  float* __restrict__ out, int S,
                                  float m0, float m1, float m2,
                                  float sd0, float sd1, float sd2) {
  extern __shared__ unsigned char smem[];
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * ((S + gridDim.x - 1) / gridDim.x);
  const int row1 = min(S, row0 + (S + gridDim.x - 1) / gridDim.x);

  // shared layout: u8 plane [S*S] | k1,k2,k3 int[S] | w1,w2,w3 float[S]
  uint8_t* plane = smem;
  int* ks = reinterpret_cast<int*>(smem + ((S * S + 15) & ~15));
  float* ws = reinterpret_cast<float*>(ks + 3 * S);

  const float* p = params + b * 9;
  const bool flipped = flip[b] != 0;
  const uint8_t* img = src + (size_t)b * S * S * 3;
  for (int i = threadIdx.x; i < S * S; i += blockDim.x) {
    int y = i / S;
    int x = i - y * S;
    int xs = flipped ? S - 1 - x : x;
    plane[i] = img[((size_t)y * S + xs) * 3 + c];
  }
  for (int i = threadIdx.x; i < 3 * S; i += blockDim.x) {
    int pass = i / S;
    shear_row(p + pass * 3, i - pass * S, &ks[i], &ws[i]);
  }
  __syncthreads();

  const int* k1 = ks;
  const int* k2 = ks + S;
  const int* k3 = ks + 2 * S;
  const float* w1 = ws;
  const float* w2 = ws + S;
  const float* w3 = ws + 2 * S;
  const float m = c == 0 ? m0 : (c == 1 ? m1 : m2);
  const float sd = c == 0 ? sd0 : (c == 1 ? sd1 : sd2);

  // pass 1 at (yy, xx): horizontal shear of row yy of the source plane
  auto pass1 = [&](int yy, int xx) -> float {
    if (yy < 0 || yy >= S) return 0.0f;
    int x0 = xx + k1[yy];
    float lo = (x0 >= 0 && x0 < S) ? (float)plane[yy * S + x0] : 0.0f;
    float hi = (x0 + 1 >= 0 && x0 + 1 < S) ? (float)plane[yy * S + x0 + 1]
                                           : 0.0f;
    return lerp_rn(lo, hi, w1[yy]);
  };
  // pass 2 at (yy, xx): vertical shear of column xx of pass 1
  auto pass2 = [&](int yy, int xx) -> float {
    if (xx < 0 || xx >= S) return 0.0f;
    int y0 = yy + k2[xx];
    return lerp_rn(pass1(y0, xx), pass1(y0 + 1, xx), w2[xx]);
  };

  float* dst = out + ((size_t)b * 3 + c) * S * S;
  const int n = (row1 - row0) * S;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int y = row0 + i / S;
    int x = i - (y - row0) * S;
    int x0 = x + k3[y];
    float v = lerp_rn(pass2(y, x0), pass2(y, x0 + 1), w3[y]);
    dst[(size_t)y * S + x] = __fdiv_rn(__fsub_rn(v, m), sd);
  }
}

size_t smem_bytes(int S) {
  return (size_t)((S * S + 15) & ~15) + (size_t)6 * S * 4;
}

}  // namespace

extern "C" {

// Largest image side the kernel takes (its shared memory must fit a block).
int fused_warp_max_side(void) {
  int S = 1;
  while (smem_bytes(S + 1) <= 232448) ++S;
  return S;
}

// src u8 [B, S, S, 3] (NHWC), params f32 [B, 3, 3] rows of
// (slope, offset, center) for the three passes, flip u8 [B] (nonzero:
// mirror the source horizontally before the warp) -> out f32 [B, 3, S, S].
// mean255/std255 are 255 * mean_c and 255 * std_c. Launches on `stream`
// and returns cudaGetLastError().
int fused_warp_normalize_u8(const void* src, const void* params,
                            const void* flip, void* out, int B, int S,
                            float m0, float m1, float m2, float sd0,
                            float sd1, float sd2, void* stream) {
  size_t smem = smem_bytes(S);
  cudaError_t err = cudaFuncSetAttribute(
      fused_warp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kRowsPerTile - 1) / kRowsPerTile, 3, B);
  fused_warp_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)src, (const float*)params, (const uint8_t*)flip,
      (float*)out, S, m0, m1, m2, sd0, sd1, sd2);
  return (int)cudaGetLastError();
}

}  // extern "C"
