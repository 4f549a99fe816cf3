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
// runs on a transposed copy. Here every output computes its tap addresses,
// so any shift is exact (a shift beyond the plane gives zeros), and the
// vertical pass indexes the same layout: no padded or transposed copy.
//
// Bound: device-memory bytes, the plane read once and written once (8 bytes
// an element against 4 flops; 38.6 MB at B = 32, 3 x 224 x 224: 11.5 us at
// 3.35 TB/s). The first design held it at 38% of that: a block per row
// (21,504 blocks of one load, lerp and store each), two unaligned 4-byte
// loads an element with every source element loaded twice, and, on the
// vertical axis, the column's (k, w) recomputed for every row.
//
// Design: a block takes a tile of kTileRows rows by kTileCols columns of one
// plane, and a thread a run of four neighbouring outputs of one row, which
// leaves as one 16-byte store.
// - Horizontal: the run taps x + k .. x + k + 4; two aligned 16-byte loads
//   at x + (k & ~3) hold them, and the row's k & 3 (the same for every run
//   of the row) picks the five. Each load lies wholly inside or outside the
//   row, so the zero fill is one test a load.
// - Vertical: the tile's columns' (k, w) are computed once a block into
//   shared memory. Where the run's four columns' k lie within one of each
//   other (the rule for a shear, whose k steps by at most one every few
//   columns), the taps are 16-byte loads of the rows y + kmin .. y + kmin + 1
//   (+ 2 where k steps inside the run), each column picking its pair;
//   otherwise each column loads its own.
// - W % 4 != 0 or an unaligned plane takes the same tiles with 4-byte
//   accesses.
//
// Every product and sum is rounded on its own (__fmul_rn/__fadd_rn) in the
// order of the plain PyTorch version (fedmlp_tpu_torch/ops/warp.py::
// hshift_rows_ref), so an integer shift is an exact copy and the two agree
// to the last bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 16;
constexpr int kTileCols = 256;

__device__ __forceinline__ float lerp_rn(float lo, float hi, float w) {
  return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, w), lo), __fmul_rn(w, hi));
}

// k = floor(s) clamped to [-(n + 1), n + 1] (beyond that every tap is
// outside anyway, and the clamp keeps the float-to-int conversion defined),
// w = s - floor(s).
__device__ __forceinline__ void split_shift(float s, int n, int* k, float* w) {
  const float kf = floorf(s);
  *w = __fsub_rn(s, kf);
  *k = (int)fminf(fmaxf(kf, -(float)(n + 1)), (float)(n + 1));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// one tap of a vertical shift, zero outside the plane
__device__ __forceinline__ float tap(const float* src, int y, int x, int H, int W) {
  return (unsigned)y < (unsigned)H ? __ldg(src + (size_t)y * W + x) : 0.0f;
}

template <int AXIS, bool VEC>
__global__ void __launch_bounds__(kThreads)
    hshift_kernel(const float* __restrict__ in, const float* __restrict__ shifts,
                  float* __restrict__ out, int C, int H, int W, int row_tiles,
                  int col_tiles) {
  __shared__ __align__(16) int ks[kTileCols];
  __shared__ __align__(16) float ws[kTileCols];
  int blk = blockIdx.x;
  const int ct = blk % col_tiles;
  blk /= col_tiles;
  const int rt = blk % row_tiles;
  const int plane = blk / row_tiles;
  const int b = plane / C;
  const int x0 = ct * kTileCols;
  const int y0 = rt * kTileRows;
  const int ncols = min(kTileCols, W - x0);
  const int nrows = min(kTileRows, H - y0);
  const float* src = in + (size_t)plane * H * W;
  float* dst = out + (size_t)plane * H * W;

  if (AXIS == 0) {
    for (int i = threadIdx.x; i < ncols; i += blockDim.x)
      split_shift(shifts[(size_t)b * W + x0 + i], H, &ks[i], &ws[i]);
    __syncthreads();
  }

  // items (row, run) with the run fastest, advanced without dividing
  const int runs = (ncols + 3) >> 2;
  const int items = nrows * runs;
  const int step_run = blockDim.x % runs;
  const int step_row = blockDim.x / runs;
  int g = threadIdx.x % runs;
  int r = threadIdx.x / runs;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int y = y0 + r;
    const int l = g << 2;  // column in the tile
    const int x = x0 + l;
    float* o = dst + (size_t)y * W + x;
    if (AXIS == 1) {
      int k;
      float w;
      split_shift(shifts[(size_t)b * H + y], W, &k, &w);
      const float* row = src + (size_t)y * W;
      if (VEC) {
        const int a = x + (k & ~3);
        const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const float4 v0 = (a >= 0 && a < W) ? load4(row + a) : z;
        const float4 v1 = (a + 4 >= 0 && a + 4 < W) ? load4(row + a + 4) : z;
        float t0, t1, t2, t3, t4;
        switch (k & 3) {
          case 0: t0 = v0.x; t1 = v0.y; t2 = v0.z; t3 = v0.w; t4 = v1.x; break;
          case 1: t0 = v0.y; t1 = v0.z; t2 = v0.w; t3 = v1.x; t4 = v1.y; break;
          case 2: t0 = v0.z; t1 = v0.w; t2 = v1.x; t3 = v1.y; t4 = v1.z; break;
          default: t0 = v0.w; t1 = v1.x; t2 = v1.y; t3 = v1.z; t4 = v1.w; break;
        }
        *reinterpret_cast<float4*>(o) =
            make_float4(lerp_rn(t0, t1, w), lerp_rn(t1, t2, w),
                        lerp_rn(t2, t3, w), lerp_rn(t3, t4, w));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (x + e >= W) break;
          const int xa = x + e + k;
          const float lo = (unsigned)xa < (unsigned)W ? __ldg(row + xa) : 0.0f;
          const float hi =
              (unsigned)(xa + 1) < (unsigned)W ? __ldg(row + xa + 1) : 0.0f;
          o[e] = lerp_rn(lo, hi, w);
        }
      }
    } else {
      if (VEC) {
        const int4 k4 = *reinterpret_cast<const int4*>(ks + l);
        const float4 w4 = *reinterpret_cast<const float4*>(ws + l);
        const int kmin = min(min(k4.x, k4.y), min(k4.z, k4.w));
        const int kmax = max(max(k4.x, k4.y), max(k4.z, k4.w));
        float4 res;
        if (kmax - kmin <= 1) {
          // rows y + kmin .. y + kmin + 2 hold every tap of the four columns
          const int yy = y + kmin;
          const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          const float4 r0 =
              (unsigned)yy < (unsigned)H ? load4(src + (size_t)yy * W + x) : z;
          const float4 r1 = (unsigned)(yy + 1) < (unsigned)H
                                ? load4(src + (size_t)(yy + 1) * W + x)
                                : z;
          float4 r2 = z;
          if (kmax != kmin && (unsigned)(yy + 2) < (unsigned)H)
            r2 = load4(src + (size_t)(yy + 2) * W + x);
          res = make_float4(
              k4.x == kmin ? lerp_rn(r0.x, r1.x, w4.x) : lerp_rn(r1.x, r2.x, w4.x),
              k4.y == kmin ? lerp_rn(r0.y, r1.y, w4.y) : lerp_rn(r1.y, r2.y, w4.y),
              k4.z == kmin ? lerp_rn(r0.z, r1.z, w4.z) : lerp_rn(r1.z, r2.z, w4.z),
              k4.w == kmin ? lerp_rn(r0.w, r1.w, w4.w) : lerp_rn(r1.w, r2.w, w4.w));
        } else {
          res = make_float4(
              lerp_rn(tap(src, y + k4.x, x, H, W), tap(src, y + k4.x + 1, x, H, W), w4.x),
              lerp_rn(tap(src, y + k4.y, x + 1, H, W),
                      tap(src, y + k4.y + 1, x + 1, H, W), w4.y),
              lerp_rn(tap(src, y + k4.z, x + 2, H, W),
                      tap(src, y + k4.z + 1, x + 2, H, W), w4.z),
              lerp_rn(tap(src, y + k4.w, x + 3, H, W),
                      tap(src, y + k4.w + 1, x + 3, H, W), w4.w));
        }
        *reinterpret_cast<float4*>(o) = res;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (x + e >= W) break;
          const int k = ks[l + e];
          o[e] = lerp_rn(tap(src, y + k, x + e, H, W),
                         tap(src, y + k + 1, x + e, H, W), ws[l + e]);
        }
      }
    }
    g += step_run;
    r += step_row;
    if (g >= runs) {
      g -= runs;
      ++r;
    }
  }
}

template <int AXIS>
void launch(const float* in, const float* shifts, float* out, int C, int H,
            int W, int row_tiles, int col_tiles, int blocks, bool vec,
            cudaStream_t stream) {
  if (vec)
    hshift_kernel<AXIS, true><<<blocks, kThreads, 0, stream>>>(
        in, shifts, out, C, H, W, row_tiles, col_tiles);
  else
    hshift_kernel<AXIS, false><<<blocks, kThreads, 0, stream>>>(
        in, shifts, out, C, H, W, row_tiles, col_tiles);
}

}  // namespace

extern "C" {

// in, out f32 [B, C, H, W] contiguous; shifts f32 [B, H] (axis 1) or [B, W]
// (axis 0). Launches on `stream` and returns cudaGetLastError(); -1 for an
// axis or a shape that the launch grid cannot hold.
int hshift_rows_f32(const void* in, const void* shifts, void* out, int B,
                    int C, int H, int W, int axis, void* stream) {
  if (axis != 0 && axis != 1) return -1;
  const long long row_tiles = (H + kTileRows - 1) / kTileRows;
  const long long col_tiles = (W + kTileCols - 1) / kTileCols;
  const long long blocks = (long long)B * C * row_tiles * col_tiles;
  if (blocks > 2147483647LL) return -1;
  const bool vec = W % 4 == 0 && (uintptr_t)in % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  if (axis == 1)
    launch<1>((const float*)in, (const float*)shifts, (float*)out, C, H, W,
              (int)row_tiles, (int)col_tiles, (int)blocks, vec,
              (cudaStream_t)stream);
  else
    launch<0>((const float*)in, (const float*)shifts, (float*)out, C, H, W,
              (int)row_tiles, (int)col_tiles, (int)blocks, vec,
              (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
