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
// Bound: device-memory bytes, 3 bytes read and 12 written a pixel (at B=32,
// 224 px: 24.09 MB, 0.00719 ms at 3.35 TB/s); writing the 19.27 MB of output
// is the floor. Design:
//
// * A gray-level table. An output value depends only on the channel and the
//   level v in 0..255 (the fill, 127, is one of them), so each block first
//   builds lut[c][v] = (v - m_c) / s_c in shared memory, three correctly
//   rounded divisions a thread, in the plain version's order
//   (fedmlp_tpu_torch/ops/pallas_ops.py::normalize_flip_cutout_ref). Every
//   output value is then one table read, equal to the plain version's bits
//   by construction; no division is left per element.
// * Four pixels a thread (W % 4 == 0 and 16-byte aligned bases, checked by
//   the wrapper): three 4-byte loads of the 12 source bytes, 48 output
//   bytes. A flipped image reads the mirrored run W-4-x .. W-1-x,
//   contiguous too, and reverses the four pixels in registers. A row that
//   the box does not cross skips the per-pixel box test. Any other shape
//   runs one pixel a thread, through the same table.
// * The stores set the pace. Each warp stages its 1536 output bytes in
//   shared memory and writes them as three fully coalesced 512-byte float4
//   stores; a lane storing its own 48 bytes ran about twice as long as a
//   zero_ of the same bytes on an H100. Plain arithmetic instead of the
//   table, eight pixels a thread, and whole rows a block staged in shared
//   memory (with or without cp.async double buffering) were no faster.
// * A grid-stride loop over the groups, at most one wave of blocks, so each
//   block builds its table once. Stores keep the default cache policy: the
//   model reads the output right away.
//
// The TPU kernel reverses the lane dimension of a whole image held in VMEM;
// here the flip is only the address of the load and a register shuffle.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // == levels: thread t fills level t
constexpr int kFillGray = 127;
constexpr int kBlocksPerSm = 2048 / kThreads;

struct Norm {
  float m0, m1, m2, s0, s1, s2;
};

// lut[c][v] for the 3 x 256 levels; ends with the block's one barrier.
__device__ __forceinline__ void build_lut(float (*lut)[256], const Norm& n) {
  const float v = (float)threadIdx.x;
  lut[0][threadIdx.x] = __fdiv_rn(__fsub_rn(v, n.m0), n.s0);
  lut[1][threadIdx.x] = __fdiv_rn(__fsub_rn(v, n.m1), n.s1);
  lut[2][threadIdx.x] = __fdiv_rn(__fsub_rn(v, n.m2), n.s2);
  __syncthreads();
}

__device__ __forceinline__ int byte_of(uint32_t w, int k) {
  return (int)((w >> (8 * k)) & 0xffu);
}

// Four pixels a thread: group t covers output pixels 4t .. 4t+3 of the
// flat [B*H*W] order, which lie in one row since W % 4 == 0. A warp's 32
// groups are consecutive, so its output is 1536 contiguous bytes: each lane
// puts its three float4 in the warp's shared staging run, and the warp
// stores the run as three 512-byte coalesced float4 stores (a lane storing
// its own 48 bytes would spread each store instruction over 1536 bytes).
__global__ void __launch_bounds__(kThreads)
    normalize_flip_cutout_vec4_kernel(const uint32_t* __restrict__ src,
                                      const int* __restrict__ flips,
                                      const int* __restrict__ boxes,
                                      float4* __restrict__ out, unsigned H,
                                      unsigned groups_per_row, unsigned groups,
                                      Norm n) {
  __shared__ float lut[3][256];
  __shared__ float4 stage[kThreads / 32][32 * 3];
  build_lut(lut, n);
  const int lane = threadIdx.x & 31;
  float4* run = stage[threadIdx.x >> 5];
  const unsigned stride = gridDim.x * blockDim.x;
  // the loop runs per warp, so that all 32 lanes reach the __syncwarp()s
  for (unsigned first = blockIdx.x * blockDim.x + threadIdx.x - lane;
       first < groups; first += stride) {
    const unsigned t = first + lane;
    if (t < groups) {
      const unsigned row = t / groups_per_row;  // b * H + y
      const unsigned gx = t - row * groups_per_row;
      const unsigned b = row / H;
      const int y = (int)(row - b * H);
      const bool flipped = flips != nullptr && __ldg(flips + b) > 0;
      const unsigned sg =
          row * groups_per_row + (flipped ? groups_per_row - 1 - gx : gx);
      const uint32_t w[3] = {__ldg(src + 3 * sg), __ldg(src + 3 * sg + 1),
                             __ldg(src + 3 * sg + 2)};
      // level of (output pixel j, channel c): byte 3 * p + c of the 12,
      // with source pixel p = j, or 3 - j when flipped (both byte indices
      // are compile-time constants, so w stays in registers)
      int lv[12];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int kf = 3 * j + c, kb = 3 * (3 - j) + c;
          lv[3 * j + c] = flipped ? byte_of(w[kb >> 2], kb & 3)
                                  : byte_of(w[kf >> 2], kf & 3);
        }
      }
      if (boxes != nullptr) {
        const int* bx = boxes + 4 * b;
        if (y >= __ldg(bx + 1) && y < __ldg(bx + 3)) {  // the box crosses the row
          const int x0 = __ldg(bx), x1 = __ldg(bx + 2);
          const int x = 4 * (int)gx;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (x + j >= x0 && x + j < x1) {
              lv[3 * j] = lv[3 * j + 1] = lv[3 * j + 2] = kFillGray;
            }
          }
        }
      }
      run[3 * lane] =
          make_float4(lut[0][lv[0]], lut[1][lv[1]], lut[2][lv[2]], lut[0][lv[3]]);
      run[3 * lane + 1] =
          make_float4(lut[1][lv[4]], lut[2][lv[5]], lut[0][lv[6]], lut[1][lv[7]]);
      run[3 * lane + 2] =
          make_float4(lut[2][lv[8]], lut[0][lv[9]], lut[1][lv[10]], lut[2][lv[11]]);
    }
    __syncwarp();
    // float4 q of the run belongs to group first + q / 3
    const unsigned live = groups - first < 32 ? groups - first : 32;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const unsigned q = 32 * k + lane;
      if (q < 3 * live) out[3 * (size_t)first + q] = run[q];
    }
    __syncwarp();
  }
}

// One pixel a thread, any W and any alignment.
__global__ void __launch_bounds__(kThreads)
    normalize_flip_cutout_px_kernel(const uint8_t* __restrict__ src,
                                    const int* __restrict__ flips,
                                    const int* __restrict__ boxes,
                                    float* __restrict__ out, unsigned H,
                                    unsigned W, unsigned pixels, Norm n) {
  __shared__ float lut[3][256];
  build_lut(lut, n);
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < pixels;
       i += stride) {
    const unsigned row = i / W;
    const unsigned x = i - row * W;
    const unsigned b = row / H;
    const int y = (int)(row - b * H);
    const bool flipped = flips != nullptr && __ldg(flips + b) > 0;
    const uint8_t* p = src + 3 * (size_t)(row * W + (flipped ? W - 1 - x : x));
    int l0 = __ldg(p), l1 = __ldg(p + 1), l2 = __ldg(p + 2);
    if (boxes != nullptr) {
      const int* bx = boxes + 4 * b;
      if ((int)x >= __ldg(bx) && (int)x < __ldg(bx + 2) && y >= __ldg(bx + 1) &&
          y < __ldg(bx + 3)) {
        l0 = l1 = l2 = kFillGray;
      }
    }
    float* q = out + 3 * (size_t)i;
    q[0] = lut[0][l0];
    q[1] = lut[1][l1];
    q[2] = lut[2][l2];
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

unsigned grid_for(unsigned items) {
  const unsigned want = (items + kThreads - 1) / kThreads;
  const unsigned cap = (unsigned)(sm_count() * kBlocksPerSm);
  return want < cap ? want : cap;
}

}  // namespace

extern "C" {

// src u8 [B, H, W, 3], flips i32 [B] or null, boxes i32 [B, 4] rows of
// (x0, y0, x1, y1) or null -> out f32 [B, H, W, 3]. m_c and s_c are the
// f32 products 255 * mean_c and 255 * std_c. vec4 != 0 takes four pixels a
// thread and needs W % 4 == 0 and src and out 16-byte aligned. Launches on
// `stream` and returns cudaGetLastError(); -1 for a shape whose pixel count
// does not fit 32 bits or a vec4 request that the shape does not allow.
int normalize_flip_cutout_u8(const void* src, const void* flips,
                             const void* boxes, void* out, int B, int H, int W,
                             float m0, float m1, float m2, float s0, float s1,
                             float s2, int vec4, void* stream) {
  const long long pixels = (long long)B * H * W;
  if (pixels <= 0 || pixels >= (1LL << 31)) return -1;
  const Norm n{m0, m1, m2, s0, s1, s2};
  cudaStream_t s = (cudaStream_t)stream;
  if (vec4) {
    if (W % 4 != 0 || ((uintptr_t)src | (uintptr_t)out) % 16 != 0) return -1;
    const unsigned groups = (unsigned)(pixels / 4);
    normalize_flip_cutout_vec4_kernel<<<grid_for(groups), kThreads, 0, s>>>(
        (const uint32_t*)src, (const int*)flips, (const int*)boxes,
        (float4*)out, (unsigned)H, (unsigned)(W / 4), groups, n);
  } else {
    normalize_flip_cutout_px_kernel<<<grid_for((unsigned)pixels), kThreads, 0,
                                      s>>>(
        (const uint8_t*)src, (const int*)flips, (const int*)boxes, (float*)out,
        (unsigned)H, (unsigned)W, (unsigned)pixels, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
