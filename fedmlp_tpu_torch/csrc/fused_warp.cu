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
// Bound: device-memory bytes. A 224^2 image reads 150,528 B of u8 and
// writes 602,112 B of f32 (24.1 MB at B = 32: 7.2 us at 3.35 TB/s); the
// lerps are far below the card's f32 rate. The first design (one block per
// channel and quarter of an image) ran at 8% of that bound: each block copied
// a whole channel plane with single-byte loads three bytes apart and a
// division a byte (cut down to its staging alone, 58% of its time), each
// image was read twelve times, every output recomputed the eight taps and
// seven lerps its neighbours shared, and stores went out four bytes at a
// time. With staging fixed, the integer work of the taps (band and edge
// tests, addresses) bound the kernel, more than the taps' loads or bank
// conflicts.
//
// Design:
// - A block computes kTileRows output rows of one image, all three channels
//   (B * ceil(S / 8) blocks: 896 at B = 32, S = 224; five resident an SM).
// - It stages only the pass-1 rows its rows read. Pass 3 reads pass 2 on its
//   own rows; pass 2 at column j reads pass-1 rows y + k2(j) and
//   y + k2(j) + 1; k2 is the floor of a rounded linear function of j, so it
//   is monotone and its extremes lie at j = 0 and j = S - 1:
//       rows [r0 + min k2, r1 + max k2] for output rows [r0, r1)
//   (fedmlp_tpu_torch/ops/warp.py::warp_source_band writes the same rule).
//   Rows outside the plane are staged as zeros, and each staged row carries
//   kPad zero bytes on either side, so the staged pass 1 tests nothing: a tap
//   past an edge reads a zero. At the weak range (10 degrees, 2%
//   translation) an 8-row tile reads at most 48 rows, and pass-1 shifts stay
//   within 13 pixels.
// - Staging reads the band's NHWC bytes (one contiguous run) 48 bytes a
//   thread with 16-byte loads, de-interleaves them into three u8 planes with
//   byte permutes, applies the horizontal flip on the way (reversed words)
//   and stores 16 bytes a channel. Sides that are not a multiple of 16 stage
//   byte by byte.
// - A band taller than the staged planes hold (kTileRows + S / 5 + 2 rows),
//   or a pass-1 shift beyond the pads (shears far beyond the weak range), is
//   read from device memory (L2) with every tap tested: no plain fallback,
//   the same bits.
// - A thread computes a run of four neighbouring outputs of one row: they
//   share the five pass-2 values they tap (eight without sharing), and the
//   run leaves as one 16-byte store where S % 4 == 0.
// - Taps become floats by an integer or and a float subtract, not by the
//   quarter-rate conversion unit.
// - The shift tables (pass 1 for the staged rows, pass 2 for every column,
//   pass 3 for the tile's rows) are computed once a block in shared memory.
// - The dynamic shared-memory limit is raised once per device and size, not
//   at every launch.
//
// Every product and sum is rounded on its own (__fmul_rn/__fadd_rn), in the
// order of the plain PyTorch version (fedmlp_tpu_torch/ops/warp.py::
// fused_warp_normalize_ref), so the compiler cannot contract them into
// FMAs and the two agree to the last bit on the same inputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 8;  // ops/warp.py::WARP_TILE_ROWS
constexpr int kPad = 16;  // zero bytes on each side of a staged row
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 64;

struct Shear {
  int k;
  float w;
};

__device__ __forceinline__ float lerp_rn(float lo, float hi, float w) {
  return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, w), lo), __fmul_rn(w, hi));
}

// s = slope * (i - center) + offset for p = (slope, offset, center);
// k = floor(s) clamped to [-(n + 1), n + 1] (beyond that every tap is
// outside, and the clamp keeps the conversion defined), w = s - floor(s)
__device__ __forceinline__ Shear shear_at(const float* p, int i, int n) {
  const float s = __fadd_rn(__fmul_rn(p[0], __fsub_rn((float)i, p[2])), p[1]);
  const float kf = floorf(s);
  Shear r;
  r.w = __fsub_rn(s, kf);
  r.k = (int)fminf(fmaxf(kf, -(float)(n + 1)), (float)(n + 1));
  return r;
}

// u8 to f32 without a conversion instruction: 2^23 + v as a float, less
// 2^23, exact.
__device__ __forceinline__ float u8_to_f32(uint32_t v) {
  return __fsub_rn(__uint_as_float(0x4B000000u | v), 8388608.0f);
}

// Pass 1 from the staged band: planes [3][cap][P] hold the image's
// (flipped) rows from vlo on, rows outside the plane as zeros, each row
// between kPad zero bytes on either side. The block stages
// only when every row's shift keeps both taps inside the padded row, so a
// tap needs no test: a tap past the edge reads a zero.
struct StagedBand {
  const uint8_t* p;  // column 0 of row vlo of channel 0
  const Shear* t1;   // pass-1 shift of each staged row
  int cs;            // channel stride: cap * P
  int P;
  int vlo;
  __device__ __forceinline__ float pass1(int c, int yy, int j) const {
    const int r = yy - vlo;
    const Shear s = t1[r];
    const uint8_t* q = p + c * cs + r * P + j + s.k;
    return lerp_rn(u8_to_f32(q[0]), u8_to_f32(q[1]), s.w);
  }
};

// Pass 1 read from the NHWC image in device memory (a band taller than the
// staged planes hold, or shifts beyond the pads): rows lo .. hi, the flip
// folded into the sign of the column stride, every tap tested.
struct DeviceBand {
  const uint8_t* p;  // row lo, column 0 (S - 1 when flipped), channel 0
  const Shear* t1;   // pass-1 shift of rows lo .. hi
  int rs;            // 3 * S
  int xs;            // 3, or -3 when flipped
  int lo, hi, S;
  __device__ __forceinline__ float tap(int c, int r, int x) const {
    return (unsigned)x < (unsigned)S ? u8_to_f32(__ldg(p + c + r * rs + x * xs))
                                     : 0.0f;
  }
  __device__ __forceinline__ float pass1(int c, int yy, int j) const {
    if (yy < lo || yy > hi) return 0.0f;
    const Shear s = t1[yy - lo];
    const int xa = j + s.k;
    return lerp_rn(tap(c, yy - lo, xa), tap(c, yy - lo, xa + 1), s.w);
  }
};

// pass 2 at (row y, column j): the vertical shear of column j of pass 1
template <class Band>
__device__ __forceinline__ float pass2(const Band& band, const Shear* t2, int S,
                                       int c, int y, int j) {
  if ((unsigned)j >= (unsigned)S) return 0.0f;
  const Shear s = t2[j];
  const int yy = y + s.k;
  return lerp_rn(band.pass1(c, yy, j), band.pass1(c, yy + 1, j), s.w);
}

// Every output of the tile: runs of four neighbouring columns of one row,
// items ordered (channel, row, run) with the run fastest, so a warp's
// stores cover contiguous bytes.
template <class Band>
__device__ __forceinline__ void warp_tile(const Band band, const Shear* t2,
                                          const Shear* t3, int S, int r0,
                                          int rows, float* outb, bool vec_out,
                                          float m0, float m1, float m2,
                                          float sd0, float sd1, float sd2) {
  const int nruns = (S + 3) >> 2;
  const int total = 3 * rows * nruns;
  const int step_run = blockDim.x % nruns;
  const int step_row = blockDim.x / nruns;
  int run = threadIdx.x % nruns;
  int yl = threadIdx.x / nruns;
  int c = 0;
  while (yl >= rows) {
    yl -= rows;
    ++c;
  }
  for (int it = threadIdx.x; it < total; it += blockDim.x) {
    const int y = r0 + yl;
    const Shear s3 = t3[yl];
    const int x = run << 2;
    const int j0 = x + s3.k;
    const float m = c == 0 ? m0 : (c == 1 ? m1 : m2);
    const float sd = c == 0 ? sd0 : (c == 1 ? sd1 : sd2);
    float q[5];
#pragma unroll
    for (int t = 0; t < 5; ++t) q[t] = pass2(band, t2, S, c, y, j0 + t);
    float v[4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
      v[t] = __fdiv_rn(__fsub_rn(lerp_rn(q[t], q[t + 1], s3.w), m), sd);
    float* dst = outb + ((size_t)c * S + y) * S + x;
    if (vec_out) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (x + t < S) dst[t] = v[t];
    }
    run += step_run;
    yl += step_row;
    if (run >= nruns) {
      run -= nruns;
      ++yl;
    }
    while (yl >= rows) {
      yl -= rows;
      ++c;
    }
  }
}

// Four pixels' interleaved bytes (RGBRGBRGBRGB in three words) into one word
// a channel, pixel 0 in the low byte.
__device__ __forceinline__ void deinterleave4(uint32_t x, uint32_t y,
                                              uint32_t z, uint32_t* r,
                                              uint32_t* g, uint32_t* b) {
  *r = __byte_perm(__byte_perm(x, y, 0x0630), z, 0x5210);
  *g = __byte_perm(__byte_perm(x, y, 0x0741), z, 0x6210);
  *b = __byte_perm(__byte_perm(x, y, 0x0052), z, 0x7410);
}

__device__ __forceinline__ uint32_t reverse_bytes(uint32_t w) {
  return __byte_perm(w, 0, 0x0123);
}

// In-plane source rows lo .. lo + nin - 1 of image img into staged rows
// r0s .. r0s + nin - 1 of planes [3][cap][P] (planes at column 0, after the
// left pad): 16 pixels (48 bytes, three 16-byte loads) a thread, 16 bytes
// stored a channel. Needs S % 16 == 0 and img 16-byte aligned.
__device__ __forceinline__ void stage_vec(const uint8_t* img, uint8_t* planes,
                                          int cs, int P, int S, int lo, int nin,
                                          int r0s, bool flipped) {
  const int gpr = S >> 4;
  const int n = nin * gpr;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / gpr;
    const int gx = i - r * gpr;
    const uint4* s4 =
        reinterpret_cast<const uint4*>(img + ((size_t)(lo + r) * S + gx * 16) * 3);
    const uint4 a = __ldg(s4), b = __ldg(s4 + 1), d = __ldg(s4 + 2);
    const uint32_t w[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                            b.z, b.w, d.x, d.y, d.z, d.w};
    uint32_t ch[3][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      deinterleave4(w[3 * q], w[3 * q + 1], w[3 * q + 2], &ch[0][q], &ch[1][q],
                    &ch[2][q]);
    uint8_t* row = planes + (r0s + r) * P;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      uint4 o;
      if (flipped) {
        o = make_uint4(reverse_bytes(ch[c][3]), reverse_bytes(ch[c][2]),
                       reverse_bytes(ch[c][1]), reverse_bytes(ch[c][0]));
        *reinterpret_cast<uint4*>(row + c * cs + S - 16 - gx * 16) = o;
      } else {
        o = make_uint4(ch[c][0], ch[c][1], ch[c][2], ch[c][3]);
        *reinterpret_cast<uint4*>(row + c * cs + gx * 16) = o;
      }
    }
  }
}

// The same, a pixel a thread, for any S and alignment.
__device__ __forceinline__ void stage_bytes(const uint8_t* img, uint8_t* planes,
                                            int cs, int P, int S, int lo, int nin,
                                            int r0s, bool flipped) {
  const int n = nin * S;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / S;
    const int x = i - r * S;
    const uint8_t* px = img + ((size_t)(lo + r) * S + x) * 3;
    const int col = (r0s + r) * P + (flipped ? S - 1 - x : x);
    planes[col] = px[0];
    planes[cs + col] = px[1];
    planes[2 * cs + col] = px[2];
  }
}

// Zeros where no source byte lands: both pads of the in-plane staged rows
// [rin0, rin0 + nin), every byte of the other rows of [0, nv). T is the store
// unit (uint4 where S and P are multiples of 16, else a byte); rows start
// at pad (planes at the left pad).
template <class T>
__device__ __forceinline__ void zero_fill(uint8_t* pad, int cs, int P, int S,
                                          int nv, int rin0, int nin) {
  constexpr int u = sizeof(T);
  const int per_pad = kPad / u;
  const int per_row = P / u;
  const T zero{};
  for (int i = threadIdx.x; i < nin * 6 * per_pad; i += blockDim.x) {
    const int e = i % per_pad;
    const int q = i / per_pad;  // (row, channel, side)
    const int side = q & 1;
    const int c = (q >> 1) % 3;
    const int r = rin0 + (q >> 1) / 3;
    T* d = reinterpret_cast<T*>(pad + c * cs + r * P) + e;
    d[side ? per_pad + S / u : 0] = zero;
  }
  const int nout = nv - nin;
  for (int i = threadIdx.x; i < nout * 3 * per_row; i += blockDim.x) {
    const int e = i % per_row;
    const int q = i / per_row;  // (row, channel)
    const int c = q % 3;
    const int ro = q / 3;
    const int r = ro < rin0 ? ro : ro + nin;
    reinterpret_cast<T*>(pad + c * cs + r * P)[e] = zero;
  }
}

__global__ void __launch_bounds__(kThreads)
    fused_warp_kernel(const uint8_t* __restrict__ src,
                      const float* __restrict__ params,
                      const uint8_t* __restrict__ flip, float* __restrict__ out,
                      int S, int cap, int vec_in, int vec_out, float m0,
                      float m1, float m2, float sd0, float sd1, float sd2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kTileRows;
  const int rows = min(kTileRows, S - r0);
  const float* p = params + b * 9;
  const int P = S + 2 * kPad;

  // pass-1 rows that output rows [r0, r0 + rows) reach through pass 2
  // (vlo .. vhi), and the part of them inside the plane (lo .. hi)
  const Shear ka = shear_at(p + 3, 0, S);
  const Shear kb = shear_at(p + 3, S - 1, S);
  const int vlo = r0 + min(ka.k, kb.k);
  const int vhi = r0 + rows + max(ka.k, kb.k);
  const int nv = vhi - vlo + 1;
  const int lo = max(0, vlo);
  const int hi = min(S - 1, vhi);
  const int nin = max(0, hi - lo + 1);
  // stage when the rows fit and every in-plane row's pass-1 shift (monotone
  // in the row, so its ends bound it) keeps both taps within the pads
  bool staged = nv <= cap;
  if (staged && nin > 0) {
    const int k1a = shear_at(p, lo, S).k, k1b = shear_at(p, hi, S).k;
    staged = min(k1a, k1b) >= -kPad && max(k1a, k1b) <= kPad - 1;
  }

  // shared layout: t1 [S] | t2 [S] | t3 [kTileRows] | planes [3][cap][P]
  Shear* t1 = reinterpret_cast<Shear*>(smem);
  Shear* t2 = t1 + S;
  Shear* t3 = t2 + S;
  uint8_t* planes = smem + (((size_t)(2 * S + kTileRows) * sizeof(Shear) + 15) & ~(size_t)15);
  const int cs = cap * P;

  // t1 by staged row (zero rows outside the plane), or by in-plane row
  if (staged) {
    for (int i = threadIdx.x; i < nv; i += blockDim.x) {
      const int yy = vlo + i;
      t1[i] = (unsigned)yy < (unsigned)S ? shear_at(p, yy, S) : Shear{0, 0.0f};
    }
  } else {
    for (int i = threadIdx.x; i < nin; i += blockDim.x) t1[i] = shear_at(p, lo + i, S);
  }
  for (int i = threadIdx.x; i < S; i += blockDim.x) t2[i] = shear_at(p + 3, i, S);
  for (int i = threadIdx.x; i < rows; i += blockDim.x) t3[i] = shear_at(p + 6, r0 + i, S);

  const uint8_t* img = src + (size_t)b * S * S * 3;
  const bool flipped = flip[b] != 0;
  if (staged) {
    if (vec_in) {
      zero_fill<uint4>(planes, cs, P, S, nv, lo - vlo, nin);
      stage_vec(img, planes + kPad, cs, P, S, lo, nin, lo - vlo, flipped);
    } else {
      zero_fill<uint8_t>(planes, cs, P, S, nv, lo - vlo, nin);
      stage_bytes(img, planes + kPad, cs, P, S, lo, nin, lo - vlo, flipped);
    }
  }
  __syncthreads();

  float* outb = out + (size_t)b * 3 * S * S;
  if (staged) {
    warp_tile(StagedBand{planes + kPad, t1, cs, P, vlo}, t2, t3, S, r0, rows,
              outb, vec_out != 0, m0, m1, m2, sd0, sd1, sd2);
  } else {
    const DeviceBand band{img + (size_t)lo * 3 * S + (flipped ? 3 * (S - 1) : 0),
                          t1, 3 * S, flipped ? -3 : 3, lo, hi, S};
    warp_tile(band, t2, t3, S, r0, rows, outb, vec_out != 0, m0, m1, m2, sd0,
              sd1, sd2);
  }
}

size_t table_bytes(int S) {
  return ((size_t)(2 * S + kTileRows) * sizeof(Shear) + 15) & ~(size_t)15;
}

// rows of the three staged planes: a tile and a fifth of the side (the
// weak range's pass 2 spreads a tile's rows by at most sin(10 deg) of the
// side), as far as shared memory holds them
int band_capacity(int S) {
  const long want = S < kTileRows + S / 5 + 2 ? S : kTileRows + S / 5 + 2;
  const long room = ((long)kMaxSmem - (long)table_bytes(S)) / (3L * (S + 2 * kPad));
  const long cap = want < room ? want : room;
  return cap > 0 ? (int)cap : 0;
}

// the largest dynamic shared memory each device's launches were allowed
int g_smem_allowed[kMaxDevices];

}  // namespace

extern "C" {

// Largest image side the kernel takes (its shift tables must fit a block's
// shared memory).
int fused_warp_max_side(void) {
  int S = 1;
  while (table_bytes(S + 1) <= (size_t)kMaxSmem) ++S;
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
  const int cap = band_capacity(S);
  const size_t smem = table_bytes(S) + (size_t)3 * cap * (S + 2 * kPad);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || (int)smem > g_smem_allowed[dev]) {
    err = cudaFuncSetAttribute(fused_warp_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) g_smem_allowed[dev] = (int)smem;
  }
  const int vec_in = S % 16 == 0 && (uintptr_t)src % 16 == 0;
  const int vec_out = S % 4 == 0 && (uintptr_t)out % 16 == 0;
  dim3 grid((S + kTileRows - 1) / kTileRows, B);
  fused_warp_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)src, (const float*)params, (const uint8_t*)flip,
      (float*)out, S, cap, vec_in, vec_out, m0, m1, m2, sd0, sd1, sd2);
  return (int)cudaGetLastError();
}

}  // extern "C"
