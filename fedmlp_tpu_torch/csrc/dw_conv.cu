// Depthwise-convolution backward for Hopper (sm_90a): two kernels.
//
// dw_conv_s1 replaces fedmlp_tpu/ops/dw_pallas.py::dw_conv_flat_s1 (kernel
// body _conv_kernel): the stride-1 depthwise correlation
//
//   out[b,c,y,x] = sum_{ky,kx} x_pad[b,c,y+ky,x+kx] * w[c,ky,kx]
//
// with zero padding pt rows above and pl columns left (pt+pb = pl+pr = k-1),
// f32 accumulation, output in x's type. In the VJP it computes dx from the
// zero-dilated cotangent and the flipped filter.
//
// dw_wgrad_s1 replaces fedmlp_tpu/ops/dw_pallas.py::dw_wgrad_flat_s1 (kernel
// body _wgrad_kernel): the weight gradient
//
//   dw[c,ky,kx] = sum_b sum_{y,x} x_pad[b,c,y+ky,x+kx] * dy[b,c,y,x]
//
// as f32 [C,1,k,k].
//
// Layout: NCHW, contiguous, so a (b, c) plane is H*W consecutive values and
// the filter of channel c is k*k consecutive values of the [C,1,k,k] weight.
// The TPU kernels' (H, W*C) flat buffer, lane-tiled filter rows and halving
// tree over lane groups were Mosaic workarounds and have no counterpart.
//
// Bound: device-memory bytes. Each kernel reads its two operands once and
// writes its result once; the arithmetic is 2*k*k flops a pixel, far below
// the card's f32 rate. Design: a block stages one row tile of a plane plus
// its k-1 halo in shared memory as f32, zeros where the padding is, so every
// tap is an in-bounds shared-memory read and the k*k re-reads of x never
// reach device memory; the ragged edges (7x7 planes under a 5x5 filter have
// more padding than data) are masked while staging, nothing assumes
// divisibility.
//
// The reduction of dw_wgrad_s1: TPU grid steps run in order and carry the
// sum over b in the output block; CUDA blocks run in no order. Here block
// (c, split) loops over its share of the (image, row tile) items of channel
// c in a fixed order, each thread keeps k*k partial sums in registers,
// warps reduce them with shuffles, the block adds the warps' sums in warp
// order through shared memory and writes partial[split, c, tap]; a second
// kernel, dw_wgrad_finalize, adds the splits in split order. No atomics:
// the same inputs give the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Stage rows [r0 - pt, r0 - pt + sh) x columns [-pl, -pl + sw) of one H x W
// plane into xs [sh][sw] as f32, zero outside the plane.
template <typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ plane,
                                           float* xs, int H, int W, int r0,
                                           int pt, int pl, int sh, int sw) {
  for (int i = threadIdx.x; i < sh * sw; i += blockDim.x) {
    int sy = i / sw;
    int sx = i - sy * sw;
    int y = r0 + sy - pt;
    int x = sx - pl;
    bool inside = y >= 0 && y < H && x >= 0 && x < W;
    xs[i] = inside ? to_f32<T>(plane[(size_t)y * W + x]) : 0.0f;
  }
}

// grid.x = B*C*n_tiles; block = one row tile (th rows) of one plane.
template <typename T, int K>
__global__ void dw_conv_s1_kernel(const T* __restrict__ x,
                                  const T* __restrict__ w,
                                  T* __restrict__ out, int C, int H, int W,
                                  int pt, int pl, int th, int n_tiles) {
  extern __shared__ float xs[];
  const int plane = blockIdx.x / n_tiles;
  const int tile = blockIdx.x - plane * n_tiles;
  const int c = plane % C;
  const int r0 = tile * th;
  const int rows = min(th, H - r0);
  const int sw = W + K - 1;
  stage_tile<T>(x + (size_t)plane * H * W, xs, H, W, r0, pt, pl, rows + K - 1,
                sw);
  float wr[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) wr[t] = to_f32<T>(w[(size_t)c * K * K + t]);
  __syncthreads();

  T* dst = out + (size_t)plane * H * W + (size_t)r0 * W;
  for (int i = threadIdx.x; i < rows * W; i += blockDim.x) {
    int y = i / W;
    int xx = i - y * W;
    const float* win = xs + y * sw + xx;
    float acc = 0.0f;
#pragma unroll
    for (int ky = 0; ky < K; ++ky) {
#pragma unroll
      for (int kx = 0; kx < K; ++kx) {
        acc = fmaf(win[ky * sw + kx], wr[ky * K + kx], acc);
      }
    }
    dst[i] = from_f32<T>(acc);
  }
}

// grid = (C, splits); block (c, split) takes the item groups split,
// split + splits, ... of channel c. An item is one (image b, row tile) pair,
// item = b * n_tiles + tile; a group is `group` consecutive items staged
// together (group > 1 only when a tile is the whole plane, so that small
// planes still give every thread a pixel).
template <typename T, int K>
__global__ void dw_wgrad_s1_kernel(const T* __restrict__ x,
                                   const T* __restrict__ dy,
                                   float* __restrict__ partial, int B, int C,
                                   int H, int W, int pt, int pl, int th,
                                   int n_tiles, int group) {
  extern __shared__ float xs[];
  __shared__ float red[kMaxWarps * K * K];
  const int c = blockIdx.x;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int n_items = B * n_tiles;
  const int n_groups = (n_items + group - 1) / group;
  const int sw = W + K - 1;
  const int slab = (th + K - 1) * sw;  // shared floats of one staged item

  float acc[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) acc[t] = 0.0f;

  for (int g = split; g < n_groups; g += splits) {
    const int item0 = g * group;
    const int n_here = min(group, n_items - item0);
    __syncthreads();  // the previous group's reads of xs are done
    for (int j = 0; j < n_here; ++j) {
      int item = item0 + j;
      int b = item / n_tiles;
      int r0 = (item - b * n_tiles) * th;
      int rows = min(th, H - r0);
      stage_tile<T>(x + ((size_t)b * C + c) * H * W, xs + j * slab, H, W, r0,
                    pt, pl, rows + K - 1, sw);
    }
    __syncthreads();
    for (int j = 0; j < n_here; ++j) {
      int item = item0 + j;
      int b = item / n_tiles;
      int r0 = (item - b * n_tiles) * th;
      int rows = min(th, H - r0);
      const T* g_rows = dy + ((size_t)b * C + c) * H * W + (size_t)r0 * W;
      const float* slab_j = xs + j * slab;
      for (int i = threadIdx.x; i < rows * W; i += blockDim.x) {
        int y = i / W;
        int xx = i - y * W;
        float gv = to_f32<T>(g_rows[i]);
        const float* win = slab_j + y * sw + xx;
#pragma unroll
        for (int ky = 0; ky < K; ++ky) {
#pragma unroll
          for (int kx = 0; kx < K; ++kx) {
            acc[ky * K + kx] = fmaf(win[ky * sw + kx], gv, acc[ky * K + kx]);
          }
        }
      }
    }
  }

  // threads -> warp (shuffles, fixed tree) -> block (warp order)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < K * K; ++t) {
    float v = acc[t];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (lane == 0) red[warp * K * K + t] = v;
  }
  __syncthreads();
  if (threadIdx.x < K * K) {
    float s = 0.0f;
    const int n_warps = blockDim.x >> 5;
    for (int wi = 0; wi < n_warps; ++wi) s += red[wi * K * K + threadIdx.x];
    partial[((size_t)split * C + c) * K * K + threadIdx.x] = s;
  }
}

// out[i] = partial[0][i] + partial[1][i] + ... in split order, i < n.
__global__ void dw_wgrad_finalize(const float* __restrict__ partial,
                                  float* __restrict__ out, int splits, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int sp = 0; sp < splits; ++sp) s += partial[(size_t)sp * n + i];
  out[i] = s;
}

template <typename T, int K>
cudaError_t launch_conv(const void* x, const void* w, void* out, int B, int C,
                        int H, int W, int pt, int pl, int th, int threads,
                        cudaStream_t stream) {
  const int n_tiles = (H + th - 1) / th;
  const size_t smem = (size_t)(th + K - 1) * (W + K - 1) * sizeof(float);
  const long long blocks = (long long)B * C * n_tiles;
  if (blocks > 2147483647LL || smem > 48 * 1024) return cudaErrorInvalidValue;
  dw_conv_s1_kernel<T, K><<<(unsigned)blocks, threads, smem, stream>>>(
      (const T*)x, (const T*)w, (T*)out, C, H, W, pt, pl, th, n_tiles);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t launch_wgrad(const void* x, const void* dy, void* partial,
                         void* out, int B, int C, int H, int W, int pt, int pl,
                         int th, int group, int splits, cudaStream_t stream) {
  const int n_tiles = (H + th - 1) / th;
  const size_t smem =
      (size_t)group * (th + K - 1) * (W + K - 1) * sizeof(float);
  if (splits < 1 || splits > 65535 || smem > 40 * 1024 ||
      (group > 1 && n_tiles != 1)) {
    return cudaErrorInvalidValue;
  }
  dim3 grid(C, splits);
  dw_wgrad_s1_kernel<T, K><<<grid, kMaxThreads, smem, stream>>>(
      (const T*)x, (const T*)dy, (float*)partial, B, C, H, W, pt, pl, th,
      n_tiles, group);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = C * K * K;
  dw_wgrad_finalize<<<(n + 255) / 256, 256, 0, stream>>>(
      (const float*)partial, (float*)out, splits, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B,C,H,W], w [C,1,k,k], out [B,C,H,W], all f32 or all bf16 (is_bf16),
// contiguous. pt/pl: zero rows above / columns left of x (the rest of the
// k-1 goes below / right). th: rows a block computes; threads: a multiple of
// 32 up to 256. k must be 3 or 5. Launches on `stream`; returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape it does not take).
int dw_conv_s1(const void* x, const void* w, void* out, int B, int C, int H,
               int W, int k, int pt, int pl, int th, int threads, int is_bf16,
               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 || th < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaErrorInvalidValue;
  if (k == 3 && is_bf16) {
    err = launch_conv<__nv_bfloat16, 3>(x, w, out, B, C, H, W, pt, pl, th,
                                        threads, s);
  } else if (k == 3) {
    err = launch_conv<float, 3>(x, w, out, B, C, H, W, pt, pl, th, threads, s);
  } else if (k == 5 && is_bf16) {
    err = launch_conv<__nv_bfloat16, 5>(x, w, out, B, C, H, W, pt, pl, th,
                                        threads, s);
  } else if (k == 5) {
    err = launch_conv<float, 5>(x, w, out, B, C, H, W, pt, pl, th, threads, s);
  }
  return (int)err;
}

// x, dy [B,C,H,W] f32 or bf16 (is_bf16), contiguous; partial f32
// [splits, C, k*k] scratch; out f32 [C,1,k,k]. th rows a staged tile, `group`
// tiles staged together (> 1 only with th >= H), `splits` blocks a channel.
// Two launches on `stream` (partial sums, then their sum in split order);
// returns cudaGetLastError().
int dw_wgrad_s1(const void* x, const void* dy, void* partial, void* out, int B,
                int C, int H, int W, int k, int pt, int pl, int th, int group,
                int splits, int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (th < 1 || group < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  if (k == 3 && is_bf16) {
    err = launch_wgrad<__nv_bfloat16, 3>(x, dy, partial, out, B, C, H, W, pt,
                                         pl, th, group, splits, s);
  } else if (k == 3) {
    err = launch_wgrad<float, 3>(x, dy, partial, out, B, C, H, W, pt, pl, th,
                                 group, splits, s);
  } else if (k == 5 && is_bf16) {
    err = launch_wgrad<__nv_bfloat16, 5>(x, dy, partial, out, B, C, H, W, pt,
                                         pl, th, group, splits, s);
  } else if (k == 5) {
    err = launch_wgrad<float, 5>(x, dy, partial, out, B, C, H, W, pt, pl, th,
                                 group, splits, s);
  }
  return (int)err;
}

}  // extern "C"
