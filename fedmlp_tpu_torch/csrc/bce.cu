// Masked sum of weighted BCE-with-logits, and its gradient, for Hopper
// (sm_90a).
//
// Replaces fedmlp_tpu/ops/pallas_ops.py::fused_bce_with_logits_masked: the
// forward (kernel body _bce_fwd_kernel, reached through _bce_sum)
//
//   out = sum_{b,c} mask[b][c] * -(pw[b][c] * y * log sigmoid(x)
//                                  + (1 - y) * log sigmoid(-x))
//
// with log sigmoid(x) = min(x, 0) - log1p(exp(-|x|)), finite for any finite
// logit. pos_weight and mask come with element strides, so a [C] or [B, 1]
// operand is read in place (stride 0 on the broadcast axis); and the
// gradient in the logits (the VJP _fused_bce_bwd, plain jnp there, a kernel
// of its own here):
//
//   dx[b][c] = g * ((-pw * y * (1 - p) + (1 - y) * p) * mask),  p = sigmoid(x)
//
// Bound: device-memory bytes (the forward reads four f32 an element and
// writes one scalar; the gradient reads three and writes one). At the
// training shape [32, 8] that is 3-4 KB, so the time is a launch's: each
// pass is exactly one launch. The forward writes `out` on every path, so
// the wrapper needs no fill before it. Design of the forward: the TPU kernel
// reduces the whole block in one grid step. Here each block sums a
// grid-strided share of the elements in a fixed order (per thread, then by
// warp shuffles, then across warps in warp order, one barrier) and, when
// there are several blocks (n > 1024), writes its partial sum; a second
// one-block kernel adds the partials in index order. No atomics: equal
// inputs give equal bits. The gradient is elementwise, grid-strided, with
// every product and sum rounded on its own in the plain version's order
// (no contraction into FMAs) and p = 1 / (1 + expf(-x)) as torch's sigmoid
// forms it on the card; g is read through its device pointer, so the
// backward never waits on the host.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

// Sum of `v` over the block, in a fixed order; valid in thread 0.
__device__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0)
    for (int i = 0; i < kThreads / 32; ++i) total += warp_sums[i];
  return total;
}

__global__ void bce_partial_kernel(const float* __restrict__ logits,
                                   const float* __restrict__ labels,
                                   const float* __restrict__ posw,
                                   const float* __restrict__ mask,
                                   float* __restrict__ partial, long long n,
                                   int C, long long pw_sb, long long pw_sc,
                                   long long m_sb, long long m_sc) {
  float acc = 0.0f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long b = i / C;
    const long long c = i - b * C;
    const float x = logits[i];
    const float y = labels[i];
    const float pw = posw[b * pw_sb + c * pw_sc];
    const float m = mask[b * m_sb + c * m_sc];
    const float elem =
        -(pw * y * log_sigmoid(x) + (1.0f - y) * log_sigmoid(-x));
    acc += elem * m;
  }
  const float total = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

__global__ void bce_finalize_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int n) {
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += partial[i];
  const float total = block_sum(acc);
  if (threadIdx.x == 0) out[0] = total;
}

// n < 2^31 (checked by the wrapper), so the row and column come from one
// 32-bit division; g is loaded beside the operands, so that every load of
// an element is in flight at once
__global__ void bce_grad_kernel(const float* __restrict__ g,
                                const float* __restrict__ logits,
                                const float* __restrict__ labels,
                                const float* __restrict__ posw,
                                const float* __restrict__ mask,
                                float* __restrict__ dx, unsigned n, unsigned C,
                                long long pw_sb, long long pw_sc,
                                long long m_sb, long long m_sc) {
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const unsigned b = i / C;
    const unsigned c = i - b * C;
    const float x = logits[i];
    const float y = labels[i];
    const float pw = posw[b * pw_sb + c * pw_sc];
    const float m = mask[b * m_sb + c * m_sc];
    const float gv = __ldg(g);
    const float p = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
    // (-pw * y) * (1 - p) + (1 - y) * p, then * m, then g *
    const float pos = __fmul_rn(__fmul_rn(-pw, y), __fsub_rn(1.0f, p));
    const float neg = __fmul_rn(__fsub_rn(1.0f, y), p);
    dx[i] = __fmul_rn(gv, __fmul_rn(__fadd_rn(pos, neg), m));
  }
}

}  // namespace

extern "C" {

// Blocks the forward uses for n elements; the caller allocates `partial`
// with that many floats when it is more than one.
int bce_masked_sum_blocks(long long n) {
  long long blocks = (n + 4LL * kThreads - 1) / (4LL * kThreads);
  if (blocks < 1) blocks = 1;
  return (int)(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

// logits, labels f32 [B, C] contiguous; posw, mask f32 read at
// [b * sb + c * sc]; out f32 [1]; partial f32 [bce_masked_sum_blocks(B * C)]
// (unused with one block). Launches on `stream` and returns
// cudaGetLastError().
int bce_masked_sum_f32(const void* logits, const void* labels,
                       const void* posw, const void* mask, void* out,
                       void* partial, long long B, int C, long long pw_sb,
                       long long pw_sc, long long m_sb, long long m_sc,
                       void* stream) {
  const long long n = B * C;
  const int blocks = bce_masked_sum_blocks(n);
  cudaStream_t s = (cudaStream_t)stream;
  float* first = blocks == 1 ? (float*)out : (float*)partial;
  bce_partial_kernel<<<blocks, kThreads, 0, s>>>(
      (const float*)logits, (const float*)labels, (const float*)posw,
      (const float*)mask, first, n, C, pw_sb, pw_sc, m_sb, m_sc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || blocks == 1) return (int)err;
  bce_finalize_kernel<<<1, kThreads, 0, s>>>((const float*)partial,
                                             (float*)out, blocks);
  return (int)cudaGetLastError();
}

// g f32 [1] on the device (the cotangent of the sum); logits, labels f32
// [B, C] contiguous; posw, mask as for bce_masked_sum_f32; dx f32 [B, C].
// One launch on `stream`; returns cudaGetLastError(), or -1 when B * C does
// not fit 31 bits.
int bce_masked_grad_f32(const void* g, const void* logits, const void* labels,
                        const void* posw, const void* mask, void* dx,
                        long long B, int C, long long pw_sb, long long pw_sc,
                        long long m_sb, long long m_sc, void* stream) {
  const long long n = B * C;
  if (n <= 0 || n >= (1LL << 31)) return -1;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 4LL * kMaxBlocks) blocks = 4LL * kMaxBlocks;
  bce_grad_kernel<<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)logits, (const float*)labels,
      (const float*)posw, (const float*)mask, (float*)dx, (unsigned)n,
      (unsigned)C, pw_sb, pw_sc, m_sb, m_sc);
  return (int)cudaGetLastError();
}

}  // extern "C"
