// Depthwise-convolution backward for Hopper (sm_90a): dx and dw of a
// depthwise convolution with stride S in {1, 2} and TF-SAME pads, read
// straight from the strided cotangent.
//
// dw_dgrad replaces fedmlp_tpu/ops/dw_pallas.py::dw_conv_flat_s1 (kernel
// body _conv_kernel), which the JAX VJP runs on the cotangent zero-dilated
// to input resolution with the flipped filter. Here
//
//   dx[b,c,y,x] = sum over (ky, kx) with S | (y+pt-ky) and S | (x+pl-kx) of
//                 dy[b,c,(y+pt-ky)/S,(x+pl-kx)/S] * w[c,ky,kx]
//
// i.e. the s*s output parity classes are each a stride-1 correlation of dy
// with a sub-filter of about k*k/(S*S) taps: no implied zero of a dilated
// cotangent is read or multiplied, and the filter is read with its own
// (unflipped) indices.
//
// dw_wgrad replaces fedmlp_tpu/ops/dw_pallas.py::dw_wgrad_flat_s1 (kernel
// body _wgrad_kernel):
//
//   dw[c,ky,kx] = sum_b sum_{yo,xo} x_pad[b,c,S*yo+ky,S*xo+kx] * dy[b,c,yo,xo]
//
// with x read once at input resolution and dy once at output resolution.
//
// Layout: NCHW, contiguous; a (b, c) plane is H*W consecutive values, and
// the planes of one image and consecutive channels are one contiguous run.
// Types: f32 or bf16 operands, f32 accumulation; dx in dy's type, dw (the
// finalize pass) in f32 or bf16.
//
// Bound: device-memory bytes (2*k*k flops a pixel is far below the card's
// f32 rate; there is no reduction across channels, so tensor cores have
// nothing to do). The design keeps the bytes at what the inputs need and
// keeps them in flight:
//
// * Large planes (a row of >= 56 values, whole 16-byte vectors): a block
//   walks one plane (dgrad) or one channel's (image, row tile) items (wgrad)
//   and stages each row tile into a ring of kStages shared-memory buffers
//   with cp.async 16-byte copies, so the next tile's copy runs while this
//   one is computed. Rows outside the plane come from the copy's zero-fill;
//   the halo columns are zeroed once. cp.async rather than TMA: a tensor
//   map would have to be encoded on the host for every tensor of every
//   call (the host, not the card, binds the 'pallas' step), and a ring of
//   three slots measured no faster than two: the tiles in flight already
//   cover the latency.
// * Small planes (28x28 and below): a block takes G consecutive whole
//   planes, one contiguous run, loads it with 16-byte vector loads and
//   scatters it into zero-padded slabs; G is sized so that the block's
//   threads each get about one column strip. For dw a block walks its
//   channel group over a share of the images; each thread keeps to one
//   channel.
// * Both: a thread computes a column strip, NX rows of two neighbouring
//   columns, from register copies of the staged values it needs, each read
//   once: about (NX + k)/S rows of k/S + 1 values for 2*NX outputs (dgrad),
//   (S*NX + k) rows of (S + k) values for 2*NX cotangent values (wgrad),
//   where one read a tap would be 2*NX*k*k. Neighbouring threads take
//   neighbouring pairs, so a warp's reads are 2 to 8 bytes apart (a row
//   strip of 8 outputs put them 16 bytes apart and replayed each read 4 to
//   8 times) and a row of dx goes out as 4- or 8-byte stores; no alignment
//   rule falls on the filter's pads. Staging is in the operands' own type,
//   so bf16 takes half the shared memory of f32.
//
// The reduction of dw: block (channel group, split) accumulates its items
// in a fixed order, each thread in registers; the threads of a channel are
// summed by a fixed shuffle tree and then in warp order, into
// partial[split, c, tap]; dw_wgrad_finalize adds the splits in split order.
// No atomics: the same inputs give the same bits on every run.
//
// The launch plan (path, tile rows, group size, slab shapes, shared bytes)
// is computed by ops/dw_pallas.py::dgrad_plan / wgrad_plan and handed over
// as an int array in the order of the enums below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroup = 64;  // wgrad: at least 4 threads a channel (red)
constexpr int kColNX = 8;      // rows of a thread's column strip
constexpr int kStages = 2;     // ring slots of a row-tile block

// Plan fields (ops/dw_pallas.py::DGRAD_FIELDS, WGRAD_FIELDS).
enum DgradField {
  DG_B, DG_C, DG_H, DG_W, DG_HO, DG_WO, DG_K, DG_S, DG_PT, DG_PL, DG_BF16,
  DG_ROWS, DG_TH, DG_GROUP, DG_R, DG_SW, DG_P, DG_SMEM, DG_DENSE, DG_N
};
enum WgradField {
  WG_B, WG_C, WG_H, WG_W, WG_HO, WG_WO, WG_K, WG_S, WG_PT, WG_PL, WG_BF16,
  WG_ROWS, WG_TH, WG_GROUP, WG_SPLITS, WG_RG, WG_RX, WG_SWX, WG_SWG, WG_P,
  WG_SMEM, WG_OUT_BF16, WG_N
};

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__device__ __forceinline__ void zero_smem(T* buf, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) buf[i] = from_f32<T>(0.0f);
}

// Rows [r_lo, r_lo + R) of an Hs x Ws plane into slab[R][SW] at column P,
// with cp.async 16-byte copies (Ws*sizeof(T), P*sizeof(T), SW*sizeof(T)
// multiples of 16). Rows outside the plane are zero-filled by the copy.
template <typename T>
__device__ __forceinline__ void stage_rows_async(T* slab, const T* plane,
                                                 int Hs, int Ws, int r_lo,
                                                 int R, int P, int SW) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = Ws / V;
  for (int i = threadIdx.x; i < R * vpr; i += blockDim.x) {
    const int r = i / vpr;
    const int v = i - r * vpr;
    const int y = r_lo + r;
    const bool in = y >= 0 && y < Hs;
    const T* src = plane + (size_t)(in ? y : 0) * Ws + v * V;
    cp_async16(slab + r * SW + P + v * V, src, in ? 16 : 0);
  }
}

// n consecutive values src[0, n), planes of Hs x Ws one after the other,
// into slabs of `slab` values: value e of plane g, row r, column q goes to
// dst[g*slab + (r+PT)*SW + q+P]. 16-byte vector loads (single values at a
// head before the first 16-byte boundary and at the tail); the plane, row
// and column of a vector's first value are divided out once, the rest
// stepped.
template <typename T>
__device__ __forceinline__ void stage_planes(T* dst, const T* src, int n,
                                             int Hs, int Ws, int PT, int P,
                                             int SW, int slab) {
  constexpr int V = 16 / sizeof(T);
  const int plane = Hs * Ws;
  auto put = [&](int e, T v) {
    const int g = e / plane;
    const int rem = e - g * plane;
    const int r = rem / Ws;
    dst[g * slab + (r + PT) * SW + rem - r * Ws + P] = v;
  };
  const int head =
      min(n, (int)(((16 - ((uintptr_t)src & 15)) & 15) / sizeof(T)));
  for (int e = threadIdx.x; e < head; e += blockDim.x) put(e, src[e]);
  const int nv = (n - head) / V;
  const uint4* vsrc = reinterpret_cast<const uint4*>(src + head);
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    uint4 raw = __ldg(vsrc + i);
    const T* vals = reinterpret_cast<const T*>(&raw);
    const int e = head + i * V;
    int g = e / plane;
    int r = (e - g * plane) / Ws;
    int q = e - g * plane - r * Ws;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      dst[g * slab + (r + PT) * SW + q + P] = vals[j];
      if (++q == Ws) {
        q = 0;
        if (++r == Hs) {
          r = 0;
          ++g;
        }
      }
    }
  }
  for (int e = head + nv * V + threadIdx.x; e < n; e += blockDim.x) {
    put(e, src[e]);
  }
}

// A thread computes a column strip: NX rows of a pair of neighbouring
// columns (x, x+1), from register copies of the staged values they need,
// each read once; the pair shares most of them. Neighbouring threads take
// neighbouring pairs, so a warp's shared reads fall 2 to 8 bytes apart (no
// or two-way bank conflicts) and its stores of a row are one run of 128 or
// 256 bytes; no alignment is asked of any column.

// dx[y0 + m, x + d], m < NX, d < 2 (x even) of one plane. slab: the
// cotangent row (y0+pt-PY)/S - (K-1)/S, the strip's first; col: the slab
// column of cotangent column (x+pl-PL)/S - (K-1)/S, the first the pair
// reads. PY = (y0+pt) mod S, PL = pl mod S: output (y, x+d) takes tap
// (ky, kx) from cotangent (j, u) only where S divides both offsets, so no
// implied zero of a dilated cotangent is read or multiplied.
template <typename T, int K, int S, int PY, int PL, int NX>
__device__ __forceinline__ void dgrad_col(const T* slab, int SW, int col,
                                          const float (&wr)[K * K],
                                          float (&out)[NX][2]) {
  constexpr int ROWS = (NX + PY + K - 2) / S + 1;  // cotangent rows read
  constexpr int NV = (PL + K) / S + 1;             // cotangent columns read
#pragma unroll
  for (int m = 0; m < NX; ++m) out[m][0] = out[m][1] = 0.0f;
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    float v[NV];
#pragma unroll
    for (int u = 0; u < NV; ++u) v[u] = to_f32<T>(slab[j * SW + col + u]);
#pragma unroll
    for (int m = 0; m < NX; ++m) {
      const int ky = m + PY + K - 1 - S * j;
      if (ky >= 0 && ky < K) {
#pragma unroll
        for (int d = 0; d < 2; ++d) {
#pragma unroll
          for (int kx = 0; kx < K; ++kx) {
            if ((d + PL - kx + K - 1) % S == 0) {
              out[m][d] = fmaf(v[(d + PL - kx + K - 1) / S], wr[ky * K + kx],
                               out[m][d]);
            }
          }
        }
      }
    }
  }
}

// Two values of a row at p, p+1: one 4- or 8-byte store where both are in
// the row and p is aligned for it, single stores otherwise.
template <typename T>
__device__ __forceinline__ void store_pair(T* p, bool both, float a, float b) {
  if (both && ((uintptr_t)p & (2 * sizeof(T) - 1)) == 0) {
    if constexpr (sizeof(T) == 2) {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
    } else {
      *reinterpret_cast<float2*>(p) = make_float2(a, b);
    }
  } else {
    p[0] = from_f32<T>(a);
    if (both) p[1] = from_f32<T>(b);
  }
}

// One column strip of dx (rows y0.., columns x, x+1), stored below H and
// left of W.
template <typename T, int K, int S, int PY, int PL>
__device__ __forceinline__ void dgrad_strip(const T* slab, int SW, int P,
                                            const float (&wr)[K * K], int x,
                                            int y0, int pl, int H, int W,
                                            T* __restrict__ dst) {
  constexpr int NX = kColNX;
  float out[NX][2];
  dgrad_col<T, K, S, PY, PL, NX>(slab, SW, (x + pl - PL) / S - (K - 1) / S + P,
                                 wr, out);
  T* d = dst + (size_t)y0 * W + x;
  const bool both = x + 1 < W;
#pragma unroll
  for (int m = 0; m < NX; ++m) {
    if (y0 + m < H) store_pair<T>(d + m * W, both, out[m][0], out[m][1]);
  }
}

// acc[ky*K+kx] += sum over the strip's NX rows (yo0 + m) and two columns
// (xo + d, xo even) of x_pad[S*(yo0+m)+ky, S*(xo+d)+kx] * dy. xs: the x
// slab at the strip's row S*yo0 (tap ky = 0) and column S*xo - pl (tap
// kx = 0); g: the dy slab at (yo0, xo), zero below and right of the plane.
template <typename T, int K, int S, int NX>
__device__ __forceinline__ void wgrad_col(const T* xs, int SWx, const T* g,
                                          int SWg, float (&acc)[K * K]) {
  constexpr int XR = S * (NX - 1) + K;  // x rows read
  constexpr int NV = S + K;             // x columns read
  float gv[NX][2];
#pragma unroll
  for (int m = 0; m < NX; ++m) {
    gv[m][0] = to_f32<T>(g[m * SWg]);
    gv[m][1] = to_f32<T>(g[m * SWg + 1]);
  }
#pragma unroll
  for (int j = 0; j < XR; ++j) {
    float v[NV];
#pragma unroll
    for (int u = 0; u < NV; ++u) v[u] = to_f32<T>(xs[j * SWx + u]);
#pragma unroll
    for (int m = 0; m < NX; ++m) {
      const int ky = j - S * m;
      if (ky >= 0 && ky < K) {
#pragma unroll
        for (int d = 0; d < 2; ++d) {
#pragma unroll
          for (int kx = 0; kx < K; ++kx) {
            acc[ky * K + kx] = fmaf(v[S * d + kx], gv[m][d], acc[ky * K + kx]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------- dgrad

// Large planes: block = one (b, c) plane of dx, walked in row tiles of th
// output rows (a multiple of NX); the cotangent rows each tile needs go
// through a ring of kStages slabs [R][SW], kStages - 1 tiles ahead of the
// one computed. PY = pt mod S, PL = pl mod S.
template <typename T, int K, int S, int PY, int PL>
__global__ void __launch_bounds__(kThreads)
    dw_dgrad_rows(const T* __restrict__ dy, const T* __restrict__ w,
                  T* __restrict__ dx, int C, int H, int W, int Ho, int Wo,
                  int pt, int pl, int th, int R, int SW, int P) {
  constexpr int NX = kColNX;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);
  const int slab = R * SW;
  const int plane = blockIdx.x;
  const int c = plane % C;
  float wr[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) wr[t] = to_f32<T>(w[(size_t)c * K * K + t]);
  zero_smem(buf, kStages * slab);
  __syncthreads();

  const T* src = dy + (size_t)plane * Ho * Wo;
  T* dst = dx + (size_t)plane * H * W;
  const int n_tiles = (H + th - 1) / th;
  const int pairs = (W + 1) / 2;
  // tile t: output rows from t*th; its first cotangent row; its ring slot
  auto fetch = [&](int t) {
    if (t < n_tiles) {
      stage_rows_async(buf + (t % kStages) * slab, src, Ho, Wo,
                       (t * th + pt - PY) / S - (K - 1) / S, R, P, SW);
    }
    cp_async_commit();  // an empty group past the last tile keeps the count
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) fetch(t);
  for (int t = 0; t < n_tiles; ++t) {
    fetch(t + kStages - 1);
    cp_async_wait<kStages - 1>();  // tile t's group is done
    __syncthreads();
    const int y0t = t * th;
    const int n_strips = ((min(th, H - y0t) + NX - 1) / NX) * pairs;
    const T* sl = buf + (t % kStages) * slab;
    for (int i = threadIdx.x; i < n_strips; i += blockDim.x) {
      const int rs = i / pairs;
      const int x = 2 * (i - rs * pairs);
      dgrad_strip<T, K, S, PY, PL>(sl + (rs * NX / S) * SW, SW, P, wr, x,
                                   y0t + rs * NX, pl, H, W, dst);
    }
    __syncthreads();  // this slot's reads are done before it is refilled
  }
}

// n values from shared memory to device memory, src[0, n) -> dst[0, n):
// 16-byte stores (single values at a head before dst's first 16-byte
// boundary and at the tail).
template <typename T>
__device__ __forceinline__ void store_run(T* __restrict__ dst, const T* src,
                                          int n) {
  constexpr int V = 16 / sizeof(T);
  const int head =
      min(n, (int)(((16 - ((uintptr_t)dst & 15)) & 15) / sizeof(T)));
  for (int e = threadIdx.x; e < head; e += blockDim.x) dst[e] = src[e];
  const int nv = (n - head) / V;
  uint4* vdst = reinterpret_cast<uint4*>(dst + head);
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    alignas(16) T v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = src[head + i * V + j];
    vdst[i] = *reinterpret_cast<const uint4*>(v);
  }
  for (int e = head + nv * V + threadIdx.x; e < n; e += blockDim.x) {
    dst[e] = src[e];
  }
}

// Small planes: block = `group` consecutive (b, c) planes, one contiguous
// run of the cotangent, staged whole into slabs [R][SW] (data at row
// (K-1)/S, column P); thread (g, j) computes column strips j, j + tpp, ...
// of plane g. With `dense` (odd W, where a row's pairs cannot all be
// stored as one word) the group's dx is first written to a dense copy in
// shared memory, which then goes out as one run of 16-byte stores.
template <typename T, int K, int S, int PY, int PL>
__global__ void __launch_bounds__(kThreads)
    dw_dgrad_planes(const T* __restrict__ dy, const T* __restrict__ w,
                    T* __restrict__ dx, int n_planes, int C, int H, int W,
                    int Ho, int Wo, int pt, int pl, int group, int R, int SW,
                    int P, int dense) {
  constexpr int NX = kColNX;
  constexpr int PT = (K - 1) / S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);
  const int slab = R * SW;
  // the dense dx of the group, after the slabs, on a 16-byte boundary
  T* ob = reinterpret_cast<T*>(smem_raw +
                               ((group * slab * sizeof(T) + 15) & ~(size_t)15));
  const int p0 = blockIdx.x * group;
  const int np = min(group, n_planes - p0);
  zero_smem(buf, np * slab);
  __syncthreads();
  stage_planes(buf, dy + (size_t)p0 * Ho * Wo, np * Ho * Wo, Ho, Wo, PT, P,
               SW, slab);
  __syncthreads();

  const int tpp = blockDim.x / group;
  const int g = threadIdx.x / tpp;
  if (g < np) {
    const int c = (p0 + g) % C;
    float wr[K * K];
#pragma unroll
    for (int t = 0; t < K * K; ++t) {
      wr[t] = to_f32<T>(w[(size_t)c * K * K + t]);
    }
    // slab row of the strip starting at output row 0: (pt-PY)/S - (K-1)/S + PT
    const T* sl = buf + g * slab + ((pt - PY) / S) * SW;
    T* dst = (dense ? ob : dx + (size_t)p0 * H * W) + g * H * W;
    const int pairs = (W + 1) / 2;
    const int n_strips = ((H + NX - 1) / NX) * pairs;
    for (int i = threadIdx.x - g * tpp; i < n_strips; i += tpp) {
      const int rs = i / pairs;
      const int x = 2 * (i - rs * pairs);
      dgrad_strip<T, K, S, PY, PL>(sl + (rs * NX / S) * SW, SW, P, wr, x,
                                   rs * NX, pl, H, W, dst);
    }
  }
  if (dense) {
    __syncthreads();
    store_run(dx + (size_t)p0 * H * W, ob, np * H * W);
  }
}

// ---------------------------------------------------------------- wgrad

// The threads' acc[K*K] summed per channel in a fixed order: `tpp`
// consecutive threads a channel (a power of two), a shuffle tree within
// min(tpp, 32) lanes, then the sub-sums in order; writes
// partial[split, c0 + g, tap] for the n_ch channels of the block.
template <int K>
__device__ __forceinline__ void reduce_partials(const float (&acc)[K * K],
                                                float* red, int tpp, int n_ch,
                                                int c0, int C, int split,
                                                float* __restrict__ partial) {
  const int width = min(tpp, 32);
#pragma unroll
  for (int t = 0; t < K * K; ++t) {
    float v = acc[t];
    for (int off = width >> 1; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off, width);
    }
    if ((threadIdx.x & (width - 1)) == 0) {
      red[(threadIdx.x / width) * K * K + t] = v;
    }
  }
  __syncthreads();
  const int subs = tpp / width;
  for (int i = threadIdx.x; i < n_ch * K * K; i += blockDim.x) {
    const int g = i / (K * K);
    const int t = i - g * K * K;
    float s = 0.0f;
    for (int q = 0; q < subs; ++q) s += red[(g * subs + q) * K * K + t];
    partial[((size_t)split * C + c0 + g) * K * K + t] = s;
  }
}

// Large planes: block (c, split) takes the items split, split + splits, ...
// of channel c, item = b * n_tiles + tile, a tile being th rows of dy (a
// multiple of NX) and the S*(th-1)+K rows of x under them; both go through
// a ring of kStages slots [x slab RX x SWx | dy slab th x SWg].
template <typename T, int K, int S>
__global__ void __launch_bounds__(kThreads)
    dw_wgrad_rows(const T* __restrict__ x, const T* __restrict__ dy,
                  float* __restrict__ partial, int B, int C, int H, int W,
                  int Ho, int Wo, int pt, int pl, int th, int RX, int SWx,
                  int SWg, int P) {
  constexpr int NX = kColNX;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[(kThreads / 32) * K * K];
  T* buf = reinterpret_cast<T*>(smem_raw);
  const int xslab = RX * SWx;
  const int stage = xslab + th * SWg;
  const int c = blockIdx.x;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int n_tiles = (Ho + th - 1) / th;
  const int n_items = B * n_tiles;
  const int pairs = (Wo + 1) / 2;
  zero_smem(buf, kStages * stage);
  __syncthreads();

  // the q-th item of this block, item = split + q * splits, into ring slot
  // q mod kStages
  auto fetch = [&](int q) {
    const int item = split + q * splits;
    if (item < n_items) {
      T* st = buf + (q % kStages) * stage;
      const int b = item / n_tiles;
      const int yo0 = (item - b * n_tiles) * th;
      const size_t pl_id = (size_t)b * C + c;
      stage_rows_async(st, x + pl_id * H * W, H, W, S * yo0 - pt, RX, P, SWx);
      stage_rows_async(st + xslab, dy + pl_id * Ho * Wo, Ho, Wo, yo0, th, 0,
                       SWg);
    }
    cp_async_commit();  // an empty group past the last item keeps the count
  };

  float acc[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) acc[t] = 0.0f;
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) fetch(q);
  for (int q = 0; split + q * splits < n_items; ++q) {
    fetch(q + kStages - 1);
    cp_async_wait<kStages - 1>();  // item q's group is done
    __syncthreads();
    const int item = split + q * splits;
    const int b = item / n_tiles;
    const int yo0 = (item - b * n_tiles) * th;
    const int n_strips = ((min(th, Ho - yo0) + NX - 1) / NX) * pairs;
    const T* st = buf + (q % kStages) * stage;
    for (int i = threadIdx.x; i < n_strips; i += blockDim.x) {
      const int rs = i / pairs;
      const int xo = 2 * (i - rs * pairs);
      wgrad_col<T, K, S, NX>(st + (S * rs * NX) * SWx + S * xo - pl + P, SWx,
                             st + xslab + rs * NX * SWg + xo, SWg, acc);
    }
    __syncthreads();  // this slot's reads are done before it is refilled
  }
  reduce_partials<K>(acc, red, blockDim.x, 1, c, C, split, partial);
}

// Small planes: block (channel group cg, split) takes the images split,
// split + splits, ...; for each it stages the group's x planes and dy
// planes (two contiguous runs) whole, x at row pt, column P of its slab,
// dy at row 0, column 0 of a slab of Rg rows (a multiple of NX, zero below
// the plane). Thread (g, j) keeps to channel cg*group + g.
template <typename T, int K, int S>
__global__ void __launch_bounds__(kThreads)
    dw_wgrad_planes(const T* __restrict__ x, const T* __restrict__ dy,
                    float* __restrict__ partial, int B, int C, int H, int W,
                    int Ho, int Wo, int pt, int pl, int group, int Rg,
                    int RX, int SWx, int SWg, int P) {
  constexpr int NX = kColNX;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[(kThreads / 4) * K * K];
  T* xs = reinterpret_cast<T*>(smem_raw);
  const int xslab = RX * SWx;
  const int gslab = Rg * SWg;
  T* gs = xs + group * xslab;
  const int c0 = blockIdx.x * group;
  const int n_ch = min(group, C - c0);
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  zero_smem(xs, group * (xslab + gslab));

  const int tpp = blockDim.x / group;
  const int g = threadIdx.x / tpp;
  const int pairs = (Wo + 1) / 2;
  const int n_strips = (Rg / NX) * pairs;
  float acc[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) acc[t] = 0.0f;
  for (int b = split; b < B; b += splits) {
    __syncthreads();  // zeroing, or the previous image's reads, are done
    const size_t p0 = (size_t)b * C + c0;
    stage_planes(xs, x + p0 * H * W, n_ch * H * W, H, W, pt, P, SWx, xslab);
    stage_planes(gs, dy + p0 * Ho * Wo, n_ch * Ho * Wo, Ho, Wo, 0, 0, SWg,
                 gslab);
    __syncthreads();
    if (g < n_ch) {
      const T* xg = xs + g * xslab;
      const T* gg = gs + g * gslab;
      for (int i = threadIdx.x - g * tpp; i < n_strips; i += tpp) {
        const int rs = i / pairs;
        const int xo = 2 * (i - rs * pairs);
        wgrad_col<T, K, S, NX>(xg + (S * rs * NX) * SWx + S * xo - pl + P,
                               SWx, gg + rs * NX * SWg + xo, SWg, acc);
      }
    }
  }
  reduce_partials<K>(acc, red, tpp, n_ch, c0, C, split, partial);
}

// out[i] = partial[0][i] + partial[1][i] + ... in split order, i < n.
template <typename TO>
__global__ void dw_wgrad_finalize(const float* __restrict__ partial,
                                  TO* __restrict__ out, int splits, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int sp = 0; sp < splits; ++sp) s += partial[(size_t)sp * n + i];
  out[i] = from_f32<TO>(s);
}

// ---------------------------------------------------------------- launch

template <typename F>
cudaError_t set_smem(F* kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <typename T, int K, int S, int PY, int PL>
cudaError_t launch_dgrad(const void* dy, const void* w, void* dx, const int* p,
                         cudaStream_t stream) {
  const int n_planes = p[DG_B] * p[DG_C];
  const int smem = p[DG_SMEM];
  cudaError_t err;
  if (p[DG_ROWS]) {
    auto kern = dw_dgrad_rows<T, K, S, PY, PL>;
    if ((err = set_smem(kern, smem)) != cudaSuccess) return err;
    kern<<<n_planes, kThreads, smem, stream>>>(
        (const T*)dy, (const T*)w, (T*)dx, p[DG_C], p[DG_H], p[DG_W], p[DG_HO],
        p[DG_WO], p[DG_PT], p[DG_PL], p[DG_TH], p[DG_R], p[DG_SW], p[DG_P]);
  } else {
    const int group = p[DG_GROUP];
    if (group < 1 || group > kThreads || kThreads % group != 0) {
      return cudaErrorInvalidValue;
    }
    auto kern = dw_dgrad_planes<T, K, S, PY, PL>;
    if ((err = set_smem(kern, smem)) != cudaSuccess) return err;
    kern<<<(n_planes + group - 1) / group, kThreads, smem, stream>>>(
        (const T*)dy, (const T*)w, (T*)dx, n_planes, p[DG_C], p[DG_H], p[DG_W],
        p[DG_HO], p[DG_WO], p[DG_PT], p[DG_PL], group, p[DG_R], p[DG_SW],
        p[DG_P], p[DG_DENSE]);
  }
  return cudaGetLastError();
}

template <typename T, int K, int S>
cudaError_t launch_wgrad(const void* x, const void* dy, void* partial,
                         void* out, const int* p, cudaStream_t stream) {
  const int C = p[WG_C];
  const int splits = p[WG_SPLITS];
  const int smem = p[WG_SMEM];
  if (splits < 1 || splits > 65535) return cudaErrorInvalidValue;
  cudaError_t err;
  if (p[WG_ROWS]) {
    auto kern = dw_wgrad_rows<T, K, S>;
    if ((err = set_smem(kern, smem)) != cudaSuccess) return err;
    kern<<<dim3(C, splits), kThreads, smem, stream>>>(
        (const T*)x, (const T*)dy, (float*)partial, p[WG_B], C, p[WG_H],
        p[WG_W], p[WG_HO], p[WG_WO], p[WG_PT], p[WG_PL], p[WG_TH], p[WG_RX],
        p[WG_SWX], p[WG_SWG], p[WG_P]);
  } else {
    const int group = p[WG_GROUP];
    if (group < 1 || group > kMaxGroup || kThreads % group != 0) {
      return cudaErrorInvalidValue;
    }
    auto kern = dw_wgrad_planes<T, K, S>;
    if ((err = set_smem(kern, smem)) != cudaSuccess) return err;
    kern<<<dim3((C + group - 1) / group, splits), kThreads, smem, stream>>>(
        (const T*)x, (const T*)dy, (float*)partial, p[WG_B], C, p[WG_H],
        p[WG_W], p[WG_HO], p[WG_WO], p[WG_PT], p[WG_PL], group, p[WG_RG],
        p[WG_RX], p[WG_SWX], p[WG_SWG], p[WG_P]);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int n = C * K * K;
  if (p[WG_OUT_BF16]) {
    dw_wgrad_finalize<__nv_bfloat16><<<(n + 255) / 256, 256, 0, stream>>>(
        (const float*)partial, (__nv_bfloat16*)out, splits, n);
  } else {
    dw_wgrad_finalize<float><<<(n + 255) / 256, 256, 0, stream>>>(
        (const float*)partial, (float*)out, splits, n);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dgrad_by_shape(const void* dy, const void* w, void* dx,
                           const int* p, cudaStream_t s) {
  const int k = p[DG_K], st = p[DG_S];
  const int ph = st == 2 ? 2 * (p[DG_PT] & 1) + (p[DG_PL] & 1) : 0;
  if (k == 3 && st == 1) return launch_dgrad<T, 3, 1, 0, 0>(dy, w, dx, p, s);
  if (k == 5 && st == 1) return launch_dgrad<T, 5, 1, 0, 0>(dy, w, dx, p, s);
  if (k == 3 && st == 2) {
    if (ph == 0) return launch_dgrad<T, 3, 2, 0, 0>(dy, w, dx, p, s);
    if (ph == 1) return launch_dgrad<T, 3, 2, 0, 1>(dy, w, dx, p, s);
    if (ph == 2) return launch_dgrad<T, 3, 2, 1, 0>(dy, w, dx, p, s);
    return launch_dgrad<T, 3, 2, 1, 1>(dy, w, dx, p, s);
  }
  if (k == 5 && st == 2) {
    if (ph == 0) return launch_dgrad<T, 5, 2, 0, 0>(dy, w, dx, p, s);
    if (ph == 1) return launch_dgrad<T, 5, 2, 0, 1>(dy, w, dx, p, s);
    if (ph == 2) return launch_dgrad<T, 5, 2, 1, 0>(dy, w, dx, p, s);
    return launch_dgrad<T, 5, 2, 1, 1>(dy, w, dx, p, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t wgrad_by_shape(const void* x, const void* dy, void* partial,
                           void* out, const int* p, cudaStream_t s) {
  const int k = p[WG_K], st = p[WG_S];
  if (k == 3 && st == 1) return launch_wgrad<T, 3, 1>(x, dy, partial, out, p, s);
  if (k == 5 && st == 1) return launch_wgrad<T, 5, 1>(x, dy, partial, out, p, s);
  if (k == 3 && st == 2) return launch_wgrad<T, 3, 2>(x, dy, partial, out, p, s);
  if (k == 5 && st == 2) return launch_wgrad<T, 5, 2>(x, dy, partial, out, p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dy [B,C,Ho,Wo], w [C,1,k,k], dx [B,C,H,W], all f32 or all bf16,
// contiguous, 16-byte aligned. p: the plan, DG_N ints in DgradField order.
// Launches on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue
// for a plan it does not take).
int dw_dgrad(const void* dy, const void* w, void* dx, const int* p,
             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (p[DG_BF16]) return (int)dgrad_by_shape<__nv_bfloat16>(dy, w, dx, p, s);
  return (int)dgrad_by_shape<float>(dy, w, dx, p, s);
}

// x [B,C,H,W], dy [B,C,Ho,Wo] f32 or bf16, contiguous, 16-byte aligned;
// partial f32 [splits, C, k*k] scratch; out [C,1,k,k] f32 or bf16
// (WG_OUT_BF16). p: the plan, WG_N ints in WgradField order. Two launches on
// `stream` (partial sums, then their sum in split order); returns
// cudaGetLastError().
int dw_wgrad(const void* x, const void* dy, void* partial, void* out,
             const int* p, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (p[WG_BF16]) {
    return (int)wgrad_by_shape<__nv_bfloat16>(x, dy, partial, out, p, s);
  }
  return (int)wgrad_by_shape<float>(x, dy, partial, out, p, s);
}

}  // extern "C"
