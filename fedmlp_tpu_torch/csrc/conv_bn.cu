// Fused 1x1 convolution with batch-norm statistics, and the two-pass 1x1
// convolution + batch norm + swish, for Hopper (sm_90a).
//
// Replaces tools/fused_conv_bn.py:
//   conv1x1_bn_stats      (:125, kernel body _kernel :27):
//       y = x . w  [M, Co] in x's type, plus per-channel sum(y) and
//       sum(y*y) [Co] f32, both taken from the f32 product before y is cast;
//   conv1x1_bn_act_2pass  (:66, kernel bodies _stats_kernel :44 and
//   _norm_kernel :57): the same sums without writing y, the fold of mean,
//   variance, scale and bias into mul and add, then a second pass
//       out = act((x . w) * mul + add), act = swish or identity.
//
// x [M, Ci] and w [Ci, Co] are f32 or bf16, row-major; products and sums
// are f32. Two routes, chosen by the type alone:
//
// * bf16: the tensor cores, mma.sync.m16n8k16 (bf16 in, f32 sums) issued
//   here. The TPU kernel's MXU sums in its own order, and so does this one:
//   y lies within the rounding of a reordered Ci-term f32 sum of the plain
//   version's (2*Ci*2^-24 * sum_k |x_k*w_k|) before the cast. Bound: device
//   memory (14-69 operations a byte at the probe's shapes, against the
//   card's ~295), so the design is about bytes in flight and few
//   instructions an element. A persistent block of 4 warps stages its
//   slab of w once (at most 160 columns: all of Co where it fits, so the
//   block owns whole rows; bf16, Ci zero-padded to a multiple of 16, rows
//   16 bytes longer than a multiple of 128 so that ldmatrix.trans reads
//   them without bank conflicts) and walks 64-row tiles of x, the next
//   tiles in flight through cp.async in a ring of 2-8 tiles (16-byte
//   copies; plain loads where a row of x is not a multiple of 16 bytes;
//   rows past M and columns past Ci are zeros). A warp owns 16 rows and sweeps
//   the slab 32 columns at a time. A thread keeps its columns' sum and sum
//   of squares in registers across the tiles (the slab's chunk count is a
//   template argument); the 8 lanes of a column meet by shuffles in a fixed
//   order once, at the end. y (or out) is staged as bf16 in shared memory:
//   where the block owns whole rows a tile is one span of device memory and
//   leaves in one cp.async.bulk store (no tensor map), otherwise in 16-byte
//   stores. Swish shares its work between the special-function unit and
//   the FMA pipe (swish_fast).
// * f32: the CUDA cores. Each output element is summed over k = 0 .. Ci-1
//   in order, every product and sum rounded on its own (__fmul_rn,
//   __fadd_rn), the plain version's order (fedmlp_tpu_torch/ops/
//   fused_conv_bn.py::_product_ref): bit for bit the same f32 product
//   (TF32 would round the inputs to 10 bits). A block stages 96 columns of
//   w as f32 once and walks 64-row tiles; a warp owns 8 rows, a lane 3
//   columns.
//
// The TPU kernel carries sum/sumsq across its sequential grid in one output
// block; here each block sums its rows in a fixed order into partial[block,
// Co], and a finalize kernel adds the blocks' partial sums in index order.
// For the two-pass function the finalize kernel also folds the batch-norm
// statistics into mul and add, in the op order of the plain version
// (fold_batch_norm): a call is three launches. No atomics: equal inputs
// give equal bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <mutex>

namespace {

constexpr int kMaxCi = 256;

enum Mode { kStatsAndY = 0, kStatsOnly = 1, kNorm = 2 };

// ---------------------------------------------------------------------
// f32: CUDA cores, the plain version's order
// ---------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;
constexpr int kTileM = kWarps * kRowsPerWarp;  // 64 rows a tile
constexpr int kColsPerLane = 3;
constexpr int kTileN = 32 * kColsPerLane;      // 96 columns a block
constexpr int kMaxRowBlocks = 1056;            // 8 a streaming multiprocessor

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    conv1x1_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ mul, const float* __restrict__ add,
                       float* __restrict__ out, float* __restrict__ psum,
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
    ws[i] = c < Co ? w[(long long)k * Co + c] : 0.0f;
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
    const float* xt = x + m0 * Ci;
    __syncthreads();  // the previous tile's reads of xs are done
    for (int i = threadIdx.x; i < kTileM * Ci; i += kThreads)
      xs[i] = i < rows * Ci ? xt[i] : 0.0f;
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
      float* orow = out + (m0 + row) * Co;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        if (col[j] >= Co) continue;
        const float y = acc[r][j];
        if constexpr (kMode == kNorm) {
          float z = __fadd_rn(__fmul_rn(y, cmul[j]), cadd[j]);
          if (swish)
            z = __fmul_rn(z, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z))));
          orow[col[j]] = z;
        } else {
          s[j] = __fadd_rn(s[j], y);
          q[j] = __fadd_rn(q[j], __fmul_rn(y, y));
          if constexpr (kMode == kStatsAndY) orow[col[j]] = y;
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

// ---------------------------------------------------------------------
// bf16: tensor cores (mma.sync.m16n8k16)
// ---------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaTileM = 16 * kMmaWarps;  // 64 rows a tile, 16 a warp
constexpr int kChunkN = 32;                // columns a warp sums at once
constexpr int kMaxChunks = 5;              // a slab: at most 160 columns
constexpr unsigned kSmemBudget = 200 * 1024;

// Shared memory of a block whose slab is `ns` columns wide, in bytes from
// the start: w [ci_pad][wstride], x [stages][64][xstride] (at the end, the
// per-warp column sums [2][warps][nsp]: at most 5 KB, and the ring holds at
// least 6 KB), the staged output tile [64][ns], mul and add [2][nsp]
// (the normalize pass). Strides of an odd number of 16-byte units keep the
// eight rows an ldmatrix reads on distinct banks.
struct Layout {
  int ci_pad, xstride, nsp, wstride;
  unsigned x_off, y_off, ma_off, bytes;
};

__host__ __device__ inline Layout layout(int Ci, int ns, int stages) {
  Layout L;
  L.ci_pad = (Ci + 15) / 16 * 16;
  L.xstride = L.ci_pad + 8;
  L.nsp = (ns + kChunkN - 1) / kChunkN * kChunkN;
  L.wstride = L.nsp + 8;
  L.x_off = (unsigned)L.ci_pad * L.wstride * 2;
  L.y_off = L.x_off + (unsigned)stages * kMmaTileM * L.xstride * 2;
  L.ma_off = (L.y_off + (unsigned)kMmaTileM * ns * 2 + 15) / 16 * 16;
  L.bytes = L.ma_off + 2u * L.nsp * 4;
  return L;
}

// The block's slab: all Co columns up to kMaxChunks * kChunkN = 160 (the
// block then owns whole rows), else even slabs of at most 160, multiples of
// kChunkN. A thread keeps its columns' sums in registers across the tiles,
// so the slab's chunk count is a template argument. Where the row tiles are
// too few to fill the card twice over (M = 6272: 98 tiles on 132 SMs), the
// columns split into as many even slabs as that takes.
int slab_width(int Co, long long tiles, int sms) {
  const int max_ns = kMaxChunks * kChunkN;
  long long slabs = (Co + max_ns - 1) / max_ns;
  const long long want = (2LL * sms + tiles - 1) / tiles;
  if (want > slabs) slabs = want;
  if (slabs == 1) return Co;
  const int even = (int)(((Co + slabs - 1) / slabs + kChunkN - 1) / kChunkN * kChunkN);
  return even < Co ? even : Co;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// All but the newest stages - 1 groups have landed (stages: 2, 4 or 8).
__device__ __forceinline__ void cp_async_wait_ring(int stages) {
  if (stages == 8) cp_async_wait<7>();
  else if (stages == 4) cp_async_wait<3>();
  else cp_async_wait<1>();
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a . b for a 16x16 bf16 tile of x and a 16x8 tile of w, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Make this thread's writes to shared memory visible to the bulk copy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}
// The bulk stores issued so far have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}
// Store 8x8 matrices of 16-bit values from mma accumulator fragments (lane
// l gives the address of row l % 8 of matrix l / 8).
__device__ __forceinline__ void stsm_x4(unsigned addr, unsigned a, unsigned b, unsigned c,
                                        unsigned d) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}
__device__ __forceinline__ void stsm_x2(unsigned addr, unsigned a, unsigned b) {
  asm volatile("stmatrix.sync.aligned.m8n8.x2.shared.b16 [%0], {%1, %2};\n" ::"r"(addr), "r"(a),
               "r"(b)
               : "memory");
}

// Stage the values of columns c, c + 1 (c even) of row r of the tile.
__device__ __forceinline__ void stage_pair(bf16* ys, int ns, int nsl, int r, int c,
                                           float v0, float v1) {
  if ((nsl & 1) == 0) {
    if (c < nsl)
      *reinterpret_cast<__nv_bfloat162*>(ys + r * ns + c) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (c < nsl) ys[r * ns + c] = __float2bfloat16_rn(v0);
    if (c + 1 < nsl) ys[r * ns + c + 1] = __float2bfloat16_rn(v1);
  }
}

// z * sigmoid(z), with sigmoid(z) = 1 / (1 + t) for z >= 0 and t / (1 + t)
// below, t = e^-|z| in (0, 1]. The exp is one special-function op; the unit
// issues 16 a clock an SM, so two an element (exp and reciprocal) would
// cost ~21 us at M = 401408 x 96, and so would the ~16 issue slots of an
// element whose reciprocal is computed on the FMA pipe. Half the elements
// take each way (`unit`): the reciprocal from the unit (rcp.approx, ~1
// f32 ulp), or a linear first guess (error <= 1/17 on (1, 2]) and three
// Newton steps (~1 f32 ulp). No branch: below z = -87 the result is -0 or
// within 2^-126 |z| of it.
__device__ __forceinline__ float swish_fast(float z, bool unit) {
  const float t = __expf(-fabsf(z));
  const float d = __fadd_rn(1.0f, t);
  float r;
  if (unit) {
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  } else {
    r = __fmaf_rn(-8.0f / 17.0f, d, 24.0f / 17.0f);
#pragma unroll
    for (int i = 0; i < 3; ++i) r = __fmaf_rn(r, __fmaf_rn(-d, r, 1.0f), r);
  }
  return __fmul_rn(z, z >= 0.0f ? r : __fmul_rn(t, r));
}

// flags: bit 0, x's rows are 16-byte units at a 16-byte aligned address
// (cp.async); bit 1, out is 16-byte aligned (whole-row tiles leave in one
// bulk store, and where Co is a multiple of 8 other tiles in 16-byte
// stores); bit 2, the same for w's rows (cp.async).
template <int kMode, int kNch>
__global__ void __launch_bounds__(kMmaThreads, kNch <= 3 ? 5 : 3)
    conv1x1_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       const float* __restrict__ mul, const float* __restrict__ add,
                       bf16* __restrict__ out, float* __restrict__ psum,
                       float* __restrict__ pssq, long long M, int Ci, int Co, int ns,
                       int stages, int swish, int flags) {
  extern __shared__ __align__(128) unsigned char sbuf[];
  const Layout L = layout(Ci, ns, stages);
  bf16* ws = reinterpret_cast<bf16*>(sbuf);
  bf16* xs = reinterpret_cast<bf16*>(sbuf + L.x_off);
  bf16* ys = reinterpret_cast<bf16*>(sbuf + L.y_off);
  float* red = reinterpret_cast<float*>(sbuf + L.x_off);  // after the tiles
  float* ma = reinterpret_cast<float*>(sbuf + L.ma_off);   // [2][nsp]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.y * ns;
  const int nsl = Co - n0 < ns ? Co - n0 : ns;  // this slab's columns
  const bool vec_x = flags & 1;
  const bool vec_y = (flags & 2) && (Co & 7) == 0 && (nsl & 7) == 0;
  const bool whole_rows = (flags & 2) && nsl == Co;
  const bool stsm = (nsl & 7) == 0;  // staged rows are 16-byte units: stmatrix
  const bf16 zero = __float2bfloat16_rn(0.0f);

  // w's slab: 16-byte copies in flight with x's first tile (the same
  // group), zeros in the columns past the slab and the rows past Ci
  if (flags & 4) {
    const int cpr = nsl / 8;
    for (int i = tid; i < Ci * cpr; i += kMmaThreads) {
      const int k = i / cpr;
      const int c = (i - k * cpr) * 8;
      cp_async16(ws + k * L.wstride + c, w + (long long)k * Co + n0 + c, 16);
    }
    const int pad = L.wstride - nsl;
    for (int i = tid; i < Ci * pad; i += kMmaThreads) {
      const int k = i / pad;
      ws[k * L.wstride + nsl + i - k * pad] = zero;
    }
    for (int i = Ci * L.wstride + tid; i < L.ci_pad * L.wstride; i += kMmaThreads)
      ws[i] = zero;
  } else {
    for (int i = tid; i < L.ci_pad * L.wstride; i += kMmaThreads) {
      const int k = i / L.wstride;
      const int c = i - k * L.wstride;
      ws[i] = (k < Ci && c < nsl) ? w[(long long)k * Co + n0 + c] : zero;
    }
  }
  if (vec_x) {  // the copies leave columns Ci .. ci_pad-1 alone: zeros
    const int pad = L.ci_pad - Ci;
    for (int i = tid; i < stages * kMmaTileM * pad; i += kMmaThreads) {
      const int r = i / pad;
      xs[r * L.xstride + Ci + i - r * pad] = zero;
    }
  }
  if constexpr (kMode == kNorm) {
    for (int c = tid; c < L.nsp; c += kMmaThreads) {
      ma[c] = c < nsl ? mul[n0 + c] : 0.0f;
      ma[L.nsp + c] = c < nsl ? add[n0 + c] : 0.0f;
    }
  }
  // this thread's running column sums: chunk, n-tile, column of the pair
  float ps[kNch][4][2], pq[kNch][4][2];
#pragma unroll
  for (int ch = 0; ch < kNch; ++ch)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) ps[ch][j][e] = pq[ch][j][e] = 0.0f;
  __syncthreads();

  // x rows m0 .. m0+63 into stage `st`: rows past M and columns past Ci
  // are zeros, which add exactly nothing to a product or a sum.
  auto load = [&](int st, long long t) {
    bf16* dst = xs + st * kMmaTileM * L.xstride;
    const long long m0 = t * kMmaTileM;
    if (vec_x) {
      const int cpr = Ci / 8;
      for (int i = tid; i < kMmaTileM * cpr; i += kMmaThreads) {
        const int r = i / cpr;
        const int c = i - r * cpr;
        const bool ok = m0 + r < M;
        cp_async16(dst + r * L.xstride + c * 8, ok ? x + (m0 + r) * Ci + c * 8 : x,
                   ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kMmaTileM * L.ci_pad; i += kMmaThreads) {
        const int r = i / L.ci_pad;
        const int k = i - r * L.ci_pad;
        dst[r * L.xstride + k] = (m0 + r < M && k < Ci) ? x[(m0 + r) * Ci + k] : zero;
      }
    }
    cp_async_commit();
  };

  // ldmatrix lanes: lane l gives the address of row l % 8 of matrix l / 8
  const int q = lane >> 3, r8 = lane & 7;
  const int g = lane >> 2, tc = 2 * (lane & 3);  // a fragment's row, column pair
  const unsigned w_lane = smem_addr(ws + (r8 + (q & 1) * 8) * L.wstride + (q >> 1) * 8);
  const unsigned y_lane = smem_addr(ys + (warp * 16 + r8 + (q & 1) * 8) * ns + (q >> 1) * 8);
  const int ksteps = L.ci_pad / 16;
  const long long n_tiles = (M + kMmaTileM - 1) / kMmaTileM;

  // a ring of `stages` x tiles: stages - 1 in flight while one is used;
  // one copy group a tile (empty past the block's last tile)
  for (int i = 0; i < stages - 1; ++i) {
    const long long tn = blockIdx.x + (long long)i * gridDim.x;
    if (tn < n_tiles) load(i, tn);
    else cp_async_commit();
  }
  int st = 0;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long tn = t + (long long)(stages - 1) * gridDim.x;
    const int sn = st == 0 ? stages - 1 : st - 1;  // the stage used last
    if (tn < n_tiles) load(sn, tn);
    else cp_async_commit();
    cp_async_wait_ring(stages);  // tile t has landed
    if (kMode != kStatsOnly && tid == 0) bulk_wait_read();  // ys is free
    __syncthreads();

    const bf16* xw = xs + st * kMmaTileM * L.xstride + warp * 16 * L.xstride;
    const unsigned x_lane = smem_addr(xw + (r8 + (q & 1) * 8) * L.xstride + (q >> 1) * 8);
    const int r0 = warp * 16 + g;
#pragma unroll
    for (int ch = 0; ch < kNch; ++ch) {
      const int cb = ch * kChunkN;
      if (cb >= nsl) break;  // the last slab may be narrower
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
      for (int ks = 0; ks < ksteps; ++ks) {
        unsigned a[4];
        ldsm_x4(a, x_lane + ks * 32);
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          unsigned b[4];
          ldsm_x4_trans(b, w_lane + (ks * 16 * L.wstride + cb + j * 8) * 2);
          mma_bf16(acc[j], a, b[0], b[1]);
          mma_bf16(acc[j + 1], a, b[2], b[3]);
        }
      }
      float o[4][4];  // what the tile stages: y, or out
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float(&v)[4] = acc[j];  // rows r0, r0 + 8; a column pair
        if constexpr (kMode == kNorm) {
          const int c = cb + j * 8 + tc;
          const float2 cm = *reinterpret_cast<const float2*>(ma + c);
          const float2 ca = *reinterpret_cast<const float2*>(ma + L.nsp + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // z = y*mul + add as the plain version rounds it
            const float z = __fadd_rn(__fmul_rn(v[e], e & 1 ? cm.y : cm.x), e & 1 ? ca.y : ca.x);
            o[j][e] = swish ? swish_fast(z, e >= 2) : z;  // rows r0 + 8: the unit
          }
        } else {
          // this thread's two rows of the tile, added to its running sums
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            ps[ch][j][e] = __fadd_rn(__fadd_rn(ps[ch][j][e], v[e]), v[e + 2]);
            pq[ch][j][e] = __fmaf_rn(v[e + 2], v[e + 2], __fmaf_rn(v[e], v[e], pq[ch][j][e]));
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) o[j][e] = v[e];
        }
      }
      if constexpr (kMode != kStatsOnly) {
        if (stsm) {  // two n-tiles (four 8x8 matrices) a stmatrix
#pragma unroll
          for (int j = 0; j < 4; j += 2) {
            const int c0 = cb + j * 8;
            const unsigned a = y_lane + c0 * 2;
            if (c0 + 16 <= nsl)
              stsm_x4(a, pack_bf16(o[j][0], o[j][1]), pack_bf16(o[j][2], o[j][3]),
                      pack_bf16(o[j + 1][0], o[j + 1][1]), pack_bf16(o[j + 1][2], o[j + 1][3]));
            else if (c0 + 8 <= nsl)
              stsm_x2(a, pack_bf16(o[j][0], o[j][1]), pack_bf16(o[j][2], o[j][3]));
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            stage_pair(ys, ns, nsl, r0, cb + j * 8 + tc, o[j][0], o[j][1]);
            stage_pair(ys, ns, nsl, r0 + 8, cb + j * 8 + tc, o[j][2], o[j][3]);
          }
        }
      }
    }
    if constexpr (kMode != kStatsOnly) fence_proxy_async();
    __syncthreads();  // the tile is staged; its x stage may be refilled

    if constexpr (kMode != kStatsOnly) {
      const long long m0 = t * kMmaTileM;
      const int rows = (int)(M - m0 < kMmaTileM ? M - m0 : kMmaTileM);
      bf16* dst = out + m0 * Co + n0;
      if (whole_rows && rows == kMmaTileM) {
        if (tid == 0) bulk_store(dst, ys, (unsigned)kMmaTileM * Co * 2);
      } else if (vec_y) {
        const int per = nsl / 8;
        for (int i = tid; i < rows * per; i += kMmaThreads) {
          const int r = i / per;
          const int c = (i - r * per) * 8;
          *reinterpret_cast<uint4*>(dst + (long long)r * Co + c) =
              *reinterpret_cast<const uint4*>(ys + r * ns + c);
        }
      } else {
        for (int i = tid; i < rows * nsl; i += kMmaThreads) {
          const int r = i / nsl;
          const int c = i - r * nsl;
          dst[(long long)r * Co + c] = ys[r * ns + c];
        }
      }
    }
    st = st + 1 == stages ? 0 : st + 1;
  }
  cp_async_wait<0>();  // the empty groups
  if constexpr (kMode != kStatsOnly) {
    if (tid == 0) bulk_wait();
  }

  if constexpr (kMode != kNorm) {
    // a column's 8 lanes (the fragment's row groups) by shuffles in a fixed
    // order, then the block's 4 warps in warp order
#pragma unroll
    for (int ch = 0; ch < kNch; ++ch)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float a = ps[ch][j][e], b = pq[ch][j][e];
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, off));
            b = __fadd_rn(b, __shfl_xor_sync(0xffffffffu, b, off));
          }
          const int c = ch * kChunkN + j * 8 + tc + e;
          if (g == 0) {
            red[warp * L.nsp + c] = a;
            red[(kMmaWarps + warp) * L.nsp + c] = b;
          }
        }
    __syncthreads();
    for (int c = tid; c < nsl; c += kMmaThreads) {
      float a = 0.0f, b = 0.0f;
      for (int i = 0; i < kMmaWarps; ++i) {
        a = __fadd_rn(a, red[i * L.nsp + c]);
        b = __fadd_rn(b, red[(kMmaWarps + i) * L.nsp + c]);
      }
      psum[(long long)blockIdx.x * Co + n0 + c] = a;
      pssq[(long long)blockIdx.x * Co + n0 + c] = b;
    }
  }
}

// ---------------------------------------------------------------------
// Cross-block sums and the batch-norm fold
// ---------------------------------------------------------------------

struct Fold {
  const float* scale;
  const float* bias;
  float* mean;
  float* var;
  float* mul;
  float* add;
  float inv_m;  // 1.0f / (float)M, as PyTorch divides a tensor by a scalar
  float eps;
};

constexpr int kFinWarps = 16;  // a block of the finalize kernel: 512 threads
constexpr int kFinCols = 8;    // columns a block

// sum[c] = sum over b of psum[b, c] in a fixed order. Lane l of warp w
// reads column l % 8 of row lane r = 4w + l / 8, which adds rows r, r+64,
// r+128, ... (loads four ahead: the adds wait on device memory, not on
// each other); the warp's 4 row lanes meet by shuffles, then thread c adds
// the 16 warps' sums in warp order. A warp's load is 4 rows of 32 bytes.
// The same for pssq. With `fold`, the sums become mean, var, mul and add in
// fold_batch_norm's op order (mean = s/M, var = max(ss/M - mean^2, 0),
// rsig = rsqrt(var + eps), mul = rsig*scale, add = bias - mean*rsig*scale),
// and sum, ssq are not written.
template <bool kFold>
__global__ void __launch_bounds__(32 * kFinWarps)
    stats_finalize_kernel(const float* __restrict__ psum,
                          const float* __restrict__ pssq, float* __restrict__ sum,
                          float* __restrict__ ssq, int nb, int Co, Fold f) {
  __shared__ float red[2][kFinWarps][kFinCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * kFinCols + (lane & 7);
  float a = 0.0f, b = 0.0f;
  if (c < Co) {
#pragma unroll 4
    for (int i = warp * 4 + (lane >> 3); i < nb; i += 4 * kFinWarps) {
      a += psum[(long long)i * Co + c];
      b += pssq[(long long)i * Co + c];
    }
  }
  for (int off = 8; off < 32; off <<= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  if (lane < kFinCols) {
    red[0][warp][lane] = a;
    red[1][warp][lane] = b;
  }
  __syncthreads();
  if (threadIdx.x < kFinCols && c < Co) {
    float ta = 0.0f, tb = 0.0f;
    for (int i = 0; i < kFinWarps; ++i) {
      ta += red[0][i][threadIdx.x];
      tb += red[1][i][threadIdx.x];
    }
    if constexpr (kFold) {
      const float mean = __fmul_rn(ta, f.inv_m);
      float var = __fsub_rn(__fmul_rn(tb, f.inv_m), __fmul_rn(mean, mean));
      var = var < 0.0f ? 0.0f : var;
      const float rsig = rsqrtf(__fadd_rn(var, f.eps));
      const float scale = f.scale[c];
      f.mean[c] = mean;
      f.var[c] = var;
      f.mul[c] = __fmul_rn(rsig, scale);
      f.add[c] = __fsub_rn(f.bias[c], __fmul_rn(__fmul_rn(mean, rsig), scale));
    } else {
      sum[c] = ta;
      ssq[c] = tb;
    }
  }
}

// ---------------------------------------------------------------------
// Launch plans
// ---------------------------------------------------------------------

struct Plan {
  int is_bf16, ns, nch, stages;  // bf16: the slab's columns and 32-column
                                 // chunks, x tiles in the ring
  unsigned smem;
  dim3 grid;
};

using MmaKernel = void (*)(const bf16*, const bf16*, const float*, const float*, bf16*,
                           float*, float*, long long, int, int, int, int, int, int);

template <int kMode>
MmaKernel mma_kernel(int nch) {
  switch (nch) {
    case 1: return conv1x1_mma_kernel<kMode, 1>;
    case 2: return conv1x1_mma_kernel<kMode, 2>;
    case 3: return conv1x1_mma_kernel<kMode, 3>;
    case 4: return conv1x1_mma_kernel<kMode, 4>;
    default: return conv1x1_mma_kernel<kMode, kMaxChunks>;
  }
}

// The grid and shared memory of a launch for M rows. bf16: one block a
// resident slot on every SM (the least occupancy of the three passes at this
// shared memory and chunk count), at most one a 64-row tile; f32: as before,
// at most kMaxRowBlocks. The grid's row count is the partial buffers' row count.
// Let `fn` take all the dynamic shared memory a block can opt into beside
// its static shared memory.
template <typename F>
cudaError_t allow_all_smem(F fn, int optin) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)a.sharedSizeBytes);
  return err;
}

cudaError_t make_plan(int dev, long long M, int Ci, int Co, int is_bf16, Plan* p) {
  const long long tiles = (M + 63) / 64 < 1 ? 1 : (M + 63) / 64;
  int sms = 0, optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  // each kernel may take all the shared memory a block can opt into: a plan
  // made later with less never lowers the limit an earlier one launches with
  p->is_bf16 = is_bf16;
  if (!is_bf16) {
    p->ns = kTileN;
    p->smem = (unsigned)((Ci * kTileN + kTileM * Ci) * sizeof(float));
    p->grid = dim3((unsigned)(tiles > kMaxRowBlocks ? kMaxRowBlocks : tiles),
                   (Co + kTileN - 1) / kTileN);
    for (auto fn : {conv1x1_f32_kernel<kStatsAndY>, conv1x1_f32_kernel<kStatsOnly>,
                    conv1x1_f32_kernel<kNorm>})
      if (err == cudaSuccess) err = allow_all_smem(fn, optin);
    return err;
  }
  p->ns = slab_width(Co, tiles, sms);
  p->nch = (p->ns + kChunkN - 1) / kChunkN;
  // x tiles in flight: a block keeps about 16 KB of x on the way (8 tiles
  // at Ci <= 32, 4 at Ci <= 80), fewer where shared memory runs out
  // (Ci = 256: 2) or where a block walks a tile or two (M = 6272)
  p->stages = tiles < 2LL * sms ? 2 : Ci <= 32 ? 8 : 4;
  while (p->stages > 2 && layout(Ci, p->ns, p->stages).bytes > kSmemBudget) p->stages /= 2;
  p->smem = layout(Ci, p->ns, p->stages).bytes;
  // the fewest blocks an SM of the three passes, so that every pass runs
  // its grid in one wave
  int per_sm = 1 << 30;
  for (MmaKernel fn : {mma_kernel<kStatsAndY>(p->nch), mma_kernel<kStatsOnly>(p->nch),
                       mma_kernel<kNorm>(p->nch)}) {
    int n = 0;
    if (err == cudaSuccess) err = allow_all_smem(fn, optin);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kMmaThreads, p->smem);
    per_sm = n < per_sm ? n : per_sm;
  }
  if (err != cudaSuccess) return err;
  const long long slots = (long long)(per_sm < 1 ? 1 : per_sm) * sms;
  p->grid = dim3((unsigned)(tiles < slots ? tiles : slots), (Co + p->ns - 1) / p->ns);
  return cudaSuccess;
}

// The last plans made, by device and shape: a call of a shape seen before
// spends no CUDA call on its plan (the probe calls each shape hundreds of
// times, and the host's time is the step's).
struct PlanKey {
  int dev;
  long long M;
  int Ci, Co, is_bf16;
};
constexpr int kPlanCache = 16;
PlanKey g_keys[kPlanCache];
Plan g_plans[kPlanCache];
int g_cached = 0, g_next = 0;
std::mutex g_plan_mu;

cudaError_t plan(long long M, int Ci, int Co, int is_bf16, Plan* p) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(g_plan_mu);
  for (int i = 0; i < g_cached; ++i) {
    const PlanKey& k = g_keys[i];
    if (k.dev == dev && k.M == M && k.Ci == Ci && k.Co == Co && k.is_bf16 == is_bf16) {
      *p = g_plans[i];
      return cudaSuccess;
    }
  }
  err = make_plan(dev, M, Ci, Co, is_bf16, p);
  if (err != cudaSuccess) return err;
  g_keys[g_next] = PlanKey{dev, M, Ci, Co, is_bf16};
  g_plans[g_next] = *p;
  g_next = (g_next + 1) % kPlanCache;
  if (g_cached < kPlanCache) ++g_cached;
  return cudaSuccess;
}

template <int kMode>
cudaError_t launch(const Plan& p, const void* x, const void* w, const void* mul,
                   const void* add, void* out, void* psum, void* pssq, long long M,
                   int Ci, int Co, int swish, cudaStream_t s) {
  if (p.is_bf16) {
    int flags = 0;
    if (Ci % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) flags |= 1;
    if ((reinterpret_cast<uintptr_t>(out) & 15) == 0) flags |= 2;
    if (Co % 8 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0) flags |= 4;
    mma_kernel<kMode>(p.nch)<<<p.grid, kMmaThreads, p.smem, s>>>(
        (const bf16*)x, (const bf16*)w, (const float*)mul, (const float*)add, (bf16*)out,
        (float*)psum, (float*)pssq, M, Ci, Co, p.ns, p.stages, swish, flags);
  } else {
    conv1x1_f32_kernel<kMode><<<p.grid, kThreads, p.smem, s>>>(
        (const float*)x, (const float*)w, (const float*)mul, (const float*)add,
        (float*)out, (float*)psum, (float*)pssq, M, Ci, Co, swish);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of the partial-sum buffers for M rows: the caller allocates psum and
// pssq as f32 [conv1x1_row_blocks(M, Ci, Co, is_bf16), Co] each. Returns -1
// on a CUDA error.
int conv1x1_row_blocks(long long M, int Ci, int Co, int is_bf16) {
  Plan p;
  return plan(M, Ci, Co, is_bf16, &p) == cudaSuccess ? (int)p.grid.x : -1;
}

// Largest Ci the kernels take (x's tile and w's slab in shared memory).
int conv1x1_max_ci() { return kMaxCi; }

// x [M, Ci], w [Ci, Co] (bf16 when `is_bf16`, else f32), contiguous; y [M, Co]
// in x's type; sum, ssq f32 [Co]; psum, pssq f32 [conv1x1_row_blocks(...),
// Co] scratch. M >= 1, 1 <= Ci <= kMaxCi. Two launches on `stream`;
// returns the first CUDA error (0: none).
int conv1x1_bn_stats_run(const void* x, const void* w, void* y, void* sum, void* ssq,
                         void* psum, void* pssq, long long M, int Ci, int Co, int is_bf16,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Plan p;
  cudaError_t err = plan(M, Ci, Co, is_bf16, &p);
  if (err == cudaSuccess)
    err = launch<kStatsAndY>(p, x, w, nullptr, nullptr, y, psum, pssq, M, Ci, Co, 0, s);
  if (err != cudaSuccess) return (int)err;
  stats_finalize_kernel<false><<<(Co + kFinCols - 1) / kFinCols, 32 * kFinWarps, 0, s>>>(
      (const float*)psum, (const float*)pssq, (float*)sum, (float*)ssq, (int)p.grid.x, Co,
      Fold{});
  return (int)cudaGetLastError();
}

// out [M, Co] in x's type = act((x . w) * mul + add), act swish when
// `swish`, else the identity; mean, var, mul, add f32 [Co] (written);
// scale, bias f32 [Co]; inv_m = 1.0f / (float)M; psum, pssq as above.
// Three launches: the statistics pass (no y), the finalize with the fold,
// the normalize pass.
int conv1x1_bn_act_run(const void* x, const void* w, const void* scale, const void* bias,
                       void* out, void* mean, void* var, void* mul, void* add, void* psum,
                       void* pssq, long long M, int Ci, int Co, int is_bf16, int swish,
                       float inv_m, float eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Plan p;
  cudaError_t err = plan(M, Ci, Co, is_bf16, &p);
  if (err == cudaSuccess)
    err = launch<kStatsOnly>(p, x, w, nullptr, nullptr, nullptr, psum, pssq, M, Ci, Co,
                             0, s);
  if (err != cudaSuccess) return (int)err;
  const Fold f{(const float*)scale, (const float*)bias, (float*)mean, (float*)var,
               (float*)mul, (float*)add, inv_m, eps};
  stats_finalize_kernel<true><<<(Co + kFinCols - 1) / kFinCols, 32 * kFinWarps, 0, s>>>(
      (const float*)psum, (const float*)pssq, nullptr, nullptr, (int)p.grid.x, Co, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch<kNorm>(p, x, w, mul, add, out, nullptr, nullptr, M, Ci, Co, swish, s);
}

}  // extern "C"
