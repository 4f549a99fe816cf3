// Fused 1x1 convolution with batch-norm statistics, and the two-pass 1x1
// convolution + batch norm + swish, for Hopper (sm_90a).
//
// Replaces tools/fused_conv_bn.py:
//   conv1x1_bn_stats      (:125, kernel body _kernel :27):
//       y = x . w  [M, Co] in x's type, plus per-channel sum(y) and
//       sum(y*y) [Co] f32, both taken from the f32 product before y is cast;
//   conv1x1_bn_act_2pass  (:66, kernel bodies _stats_kernel :44 and
//   _norm_kernel :57): the same sums without writing y, then a second pass
//       out = act((x . w) * mul + add), act = swish or identity,
//   where mul and add fold mean, variance, scale and bias (plain tensor ops
//   between the passes, in the wrapper).
//
// x [M, Ci] and w [Ci, Co] are f32 or bf16, row-major; products and sums
// are f32. Each output element is summed over k = 0 .. Ci-1 in order, every
// product and every sum rounded on its own (__fmul_rn, __fadd_rn: no
// contraction into FMAs), which is the order of the plain PyTorch version
// (fedmlp_tpu_torch/ops/fused_conv_bn.py::_product_ref): the two give the
// same f32 product bit for bit. The product is written here, not handed to
// a library GEMM.
//
// Bound: device-memory bytes. At the probe's shapes (Ci 16/24/80, Co
// 96/144/480) a row of y is 4-20x the bytes of a row of x, and the 2*Ci
// operations an output element needs sit far below the bf16 tensor-core
// rate. Design: a block stages its 96 columns of w in shared memory as f32
// once, then walks 64-row tiles of x (staged as f32); a warp owns 8 rows,
// a lane 3 columns (lane, lane+32, lane+64), so a warp's stores of a row
// are 32 consecutive elements. The TPU kernel carries sum/sumsq across its
// sequential grid in one output block; here each block sums its rows in a
// fixed order (per thread, then across the 8 warps in warp order) into
// partial[block, Co], and a finalize kernel adds the blocks' partial sums
// in index order (8 fixed strided runs, then those 8 in order). No
// atomics: equal inputs give equal bits. w above 48 KB of shared memory
// (Ci = 80: 30 KB of w and 20 KB of x) takes the dynamic opt-in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;
constexpr int kTileM = kWarps * kRowsPerWarp;  // 64 rows a tile
constexpr int kColsPerLane = 3;
constexpr int kTileN = 32 * kColsPerLane;      // 96 columns a block
constexpr int kMaxRowBlocks = 1056;            // 8 a streaming multiprocessor
constexpr int kMaxCi = 256;

enum Mode { kStatsAndY = 0, kStatsOnly = 1, kNorm = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
    conv1x1_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ mul, const float* __restrict__ add,
                   T* __restrict__ out, float* __restrict__ psum,
                   float* __restrict__ pssq, long long M, int Ci, int Co,
                   int swish) {
  extern __shared__ float smem[];
  float* ws = smem;                // [Ci][kTileN]
  float* xs = smem + Ci * kTileN;  // [kTileM][Ci]
  __shared__ float red[2][kWarps][kTileN];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.y * kTileN;
  for (int i = threadIdx.x; i < Ci * kTileN; i += kThreads) {
    const int k = i / kTileN;
    const int c = n0 + i - k * kTileN;
    ws[i] = c < Co ? to_f32(w[(long long)k * Co + c]) : 0.0f;
  }
  int col[kColsPerLane];
  float cmul[kColsPerLane], cadd[kColsPerLane];
  float s[kColsPerLane], q[kColsPerLane];
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) {
    col[j] = n0 + lane + 32 * j;
    const bool ok = col[j] < Co;
    cmul[j] = (kMode == kNorm && ok) ? mul[col[j]] : 0.0f;
    cadd[j] = (kMode == kNorm && ok) ? add[col[j]] : 0.0f;
    s[j] = 0.0f;
    q[j] = 0.0f;
  }

  const long long n_tiles = (M + kTileM - 1) / kTileM;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long m0 = t * kTileM;
    const int rows = (int)(M - m0 < kTileM ? M - m0 : kTileM);
    const T* xt = x + m0 * Ci;
    __syncthreads();  // the previous tile's reads of xs are done
    for (int i = threadIdx.x; i < kTileM * Ci; i += kThreads)
      xs[i] = i < rows * Ci ? to_f32(xt[i]) : 0.0f;
    __syncthreads();

    float acc[kRowsPerWarp][kColsPerLane];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) acc[r][j] = 0.0f;
    const float* xw = xs + warp * kRowsPerWarp * Ci;
#pragma unroll 4
    for (int k = 0; k < Ci; ++k) {
      float b[kColsPerLane];
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) b[j] = ws[k * kTileN + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float a = xw[r * Ci + k];  // one address a warp: a broadcast
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j)
          acc[r][j] = __fadd_rn(acc[r][j], __fmul_rn(a, b[j]));
      }
    }

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r;
      if (row >= rows) continue;
      T* orow = out + (m0 + row) * Co;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        if (col[j] >= Co) continue;
        const float y = acc[r][j];
        if constexpr (kMode == kNorm) {
          float z = __fadd_rn(__fmul_rn(y, cmul[j]), cadd[j]);
          if (swish)
            z = __fmul_rn(z, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z))));
          store(orow + col[j], z);
        } else {
          s[j] = __fadd_rn(s[j], y);
          q[j] = __fadd_rn(q[j], __fmul_rn(y, y));
          if constexpr (kMode == kStatsAndY) store(orow + col[j], y);
        }
      }
    }
  }

  if constexpr (kMode != kNorm) {
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      red[0][warp][lane + 32 * j] = s[j];
      red[1][warp][lane + 32 * j] = q[j];
    }
    __syncthreads();
    if (threadIdx.x < kTileN && n0 + threadIdx.x < Co) {
      float a = 0.0f, b = 0.0f;
      for (int i = 0; i < kWarps; ++i) {
        a += red[0][i][threadIdx.x];
        b += red[1][i][threadIdx.x];
      }
      psum[(long long)blockIdx.x * Co + n0 + threadIdx.x] = a;
      pssq[(long long)blockIdx.x * Co + n0 + threadIdx.x] = b;
    }
  }
}

// sum[c] = sum over b of psum[b, c] in a fixed order: warp i adds rows
// i, i+8, i+16, ... of its 32 columns, then thread c adds the 8 warps' sums
// in warp order. The same for pssq.
__global__ void __launch_bounds__(kThreads)
    stats_finalize_kernel(const float* __restrict__ psum,
                          const float* __restrict__ pssq,
                          float* __restrict__ sum, float* __restrict__ ssq,
                          int nb, int Co) {
  __shared__ float red[2][kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float a = 0.0f, b = 0.0f;
  if (c < Co) {
    for (int i = warp; i < nb; i += kWarps) {
      a += psum[(long long)i * Co + c];
      b += pssq[(long long)i * Co + c];
    }
  }
  red[0][warp][lane] = a;
  red[1][warp][lane] = b;
  __syncthreads();
  if (threadIdx.x < 32 && c < Co) {
    float ta = 0.0f, tb = 0.0f;
    for (int i = 0; i < kWarps; ++i) {
      ta += red[0][i][lane];
      tb += red[1][i][lane];
    }
    sum[c] = ta;
    ssq[c] = tb;
  }
}

int row_blocks(long long M) {
  const long long tiles = (M + kTileM - 1) / kTileM;
  if (tiles < 1) return 1;
  return (int)(tiles > kMaxRowBlocks ? kMaxRowBlocks : tiles);
}

template <typename T, int kMode>
cudaError_t launch(const void* x, const void* w, const void* mul,
                   const void* add, void* out, void* psum, void* pssq,
                   long long M, int Ci, int Co, int swish, cudaStream_t s) {
  const size_t smem = (size_t)(Ci * kTileN + kTileM * Ci) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      conv1x1_kernel<T, kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(row_blocks(M), (Co + kTileN - 1) / kTileN);
  conv1x1_kernel<T, kMode><<<grid, kThreads, smem, s>>>(
      (const T*)x, (const T*)w, (const float*)mul, (const float*)add, (T*)out,
      (float*)psum, (float*)pssq, M, Ci, Co, swish);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t dispatch(int bf16, const void* x, const void* w, const void* mul,
                     const void* add, void* out, void* psum, void* pssq,
                     long long M, int Ci, int Co, int swish, cudaStream_t s) {
  if (bf16)
    return launch<__nv_bfloat16, kMode>(x, w, mul, add, out, psum, pssq, M, Ci,
                                        Co, swish, s);
  return launch<float, kMode>(x, w, mul, add, out, psum, pssq, M, Ci, Co,
                              swish, s);
}

}  // namespace

extern "C" {

// Rows of the partial-sum buffers for M rows: the caller allocates psum and
// pssq as f32 [conv1x1_row_blocks(M), Co] each.
int conv1x1_row_blocks(long long M) { return row_blocks(M); }

// Largest Ci the kernels take (x's tile and w's columns in shared memory).
int conv1x1_max_ci() { return kMaxCi; }

// x [M, Ci], w [Ci, Co] (bf16 when `bf16`, else f32), contiguous; y [M, Co]
// in x's type, written only when `write_y`; sum, ssq f32 [Co]; psum, pssq
// f32 [conv1x1_row_blocks(M), Co] scratch. M >= 1, 1 <= Ci <= kMaxCi.
// Launches on `stream` and returns the first CUDA error (0: none).
int conv1x1_bn_stats_run(const void* x, const void* w, void* y, void* sum,
                         void* ssq, void* psum, void* pssq, long long M, int Ci,
                         int Co, int bf16, int write_y, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      write_y ? dispatch<kStatsAndY>(bf16, x, w, nullptr, nullptr, y, psum,
                                     pssq, M, Ci, Co, 0, s)
              : dispatch<kStatsOnly>(bf16, x, w, nullptr, nullptr, nullptr,
                                     psum, pssq, M, Ci, Co, 0, s);
  if (err != cudaSuccess) return (int)err;
  stats_finalize_kernel<<<(Co + 31) / 32, kThreads, 0, s>>>(
      (const float*)psum, (const float*)pssq, (float*)sum, (float*)ssq,
      row_blocks(M), Co);
  return (int)cudaGetLastError();
}

// out [M, Co] in x's type = act((x . w) * mul + add); mul, add f32 [Co];
// act is swish when `swish`, else the identity.
int conv1x1_bn_norm_run(const void* x, const void* w, const void* mul,
                        const void* add, void* out, long long M, int Ci, int Co,
                        int bf16, int swish, void* stream) {
  return (int)dispatch<kNorm>(bf16, x, w, mul, add, out, nullptr, nullptr, M,
                              Ci, Co, swish, (cudaStream_t)stream);
}

}  // extern "C"
