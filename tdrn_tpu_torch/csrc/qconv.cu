// K5: int8 convolution with its dequantizing epilogue,
// out = float(conv(xq, wq)) * fac + bias, rounded to bf16 or fp32.
//
// Replaces the s8 convolution inside tdrn_tpu/models/layers.py::QConv (XLA's
// conv_general_dilated(s8, s8, preferred_element_type=s32) and the dequantize
// behind it); the JAX package has no Pallas kernel for it. Every conv of the
// int8 serving profile runs here: 3x3 (stride 1 or 2, dilation 1 or 3), 1x1
// (stride 1 or 2) and 7x7/2, SAME padding d*(k-1)/2.
//
// Operands, both k-contiguous: xq int8 NHWC (B, H, W, C) and wq int8
// (Cout, KH, KW, C), C a multiple of 16 (the wrapper zero-pads channels;
// the zero point is 0, so that is exact). fac = wscale * (xscale / 127) and
// bias are fp32 (Cout). Products accumulate exactly in int32 (|acc| <=
// 127^2 * KH*KW*C, 7.4e7 on every shape of the profile). The epilogue rounds
// as the plain version does, one operation at a time: __int2float_rn, then
// __fmul_rn, __fadd_rn and round-to-nearest-even to bf16, so the output is
// bit-equal to ops/qconv.py::qconv_plain.
//
// Bound on the H100: operations on most shapes (2*M*N*K int8 ops at 1,979
// TOP/s dense), bytes on the wide early layers (conv1_2 at 320x320 reads and
// writes ~315 MB). Design, simple first: an implicit GEMM over M = B*Ho*Wo
// pixels, N = Cout and K = KH*KW*C, one block a 128 x 128 output tile, 8
// warps of 64 x 32, mma.sync.m16n8k32 (s8 in, s32 out).
// - The k loop walks tap by tap in 32-channel steps; a step is one 16-byte
//   cp.async a thread for A (thread t: pixel row t/2, bytes 16*(t%2)) and one
//   for B (channel row t/2), zero-filled outside the image, past M or Cout
//   and past C (the half step where C % 32 == 16). Four stages in flight.
// - Tiles are 128 rows of 32 bytes; the two 16-byte halves of a row swap
//   place on every other group of 4 rows, so the 8 rows an ldmatrix phase
//   reads fall on 32 distinct banks.
// - A and B fragments come by ldmatrix.x4 without .trans: both operands are
//   k-contiguous and the 8-bit fragments of m16n8k32 have the byte layout of
//   the 16-bit ones of m16n8k16.
// - The epilogue writes pairs of channels (bf16x2 or float2) straight from
//   the accumulators.
// Known waste: stems with C = 16 run half-empty k steps; nothing is shared
// between neighbouring taps (each step re-reads its pixels from L2); stores
// are 4 or 8 bytes a thread. wgmma/TMA, a persistent schedule and
// quantize-on-load are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int BM = 128;  // pixels of a block tile
constexpr int BN = 128;  // output channels of a block tile
constexpr int BK = 32;   // bytes (int8 channels) of a k step
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr int TILE = BM * BK;  // bytes of one operand tile (BN == BM)

// Byte offset of 16-byte half `half` of tile row `row`.
__device__ __forceinline__ int swz(int row, int half) {
  return row * BK + ((half ^ ((row >> 2) & 1)) << 4);
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <bool OUT_BF16>
__global__ void __launch_bounds__(THREADS)
qconv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
             const float* __restrict__ fac, const float* __restrict__ bias,
             void* __restrict__ out, int H, int W, int C, int Ho, int Wo, int Cout,
             int KH, int KW, int stride, int dil, int padh, int padw, int M) {
  __shared__ __align__(128) uint8_t smem[STAGES][2][TILE];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows 64*wm, channels 32*wn
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // This thread's copies: pixel row r of A and channel row r of B, half h.
  const int r = tid >> 1, h = tid & 1;
  const int m = m0 + r;
  const bool m_ok = m < M;
  int b = 0, oy = 0, ox = 0;
  if (m_ok) {
    b = m / (Ho * Wo);
    const int rem = m - b * Ho * Wo;
    oy = rem / Wo;
    ox = rem - oy * Wo;
  }
  const int iy0 = oy * stride - padh, ix0 = ox * stride - padw;
  const int8_t* xb = x + (size_t)b * H * W * C;
  const bool n_ok = n0 + r < Cout;
  const int8_t* wr = w + (size_t)(n_ok ? n0 + r : 0) * KH * KW * C;
  const int csteps = (C + BK - 1) / BK, nsteps = KH * KW * csteps;
  const int soff = swz(r, h);

  auto load = [&](int s, int stage) {
    const int tap = s / csteps;
    const int c = (s - tap * csteps) * BK + 16 * h;
    const int ky = tap / KW, kx = tap - ky * KW;
    const int iy = iy0 + ky * dil, ix = ix0 + kx * dil;
    const bool c_ok = c < C;
    const bool a_in = m_ok && c_ok && iy >= 0 && iy < H && ix >= 0 && ix < W;
    cp16(&smem[stage][0][soff], a_in ? xb + ((size_t)iy * W + ix) * C + c : x, a_in);
    const bool b_in = n_ok && c_ok;
    cp16(&smem[stage][1][soff], b_in ? wr + (size_t)tap * C + c : w, b_in);
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) load(s, s);
    cp_async_commit();
  }
  // Fragment rows of this lane (ldmatrix.x4 row addresses).
  const int a_row = wm * 64 + (lane & 7) + ((lane >> 3) & 1) * 8, a_half = lane >> 4;
  const int b_row = wn * 32 + (lane & 7) + (lane >> 4) * 8, b_half = (lane >> 3) & 1;
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step s has landed; every warp is done with step s - 1's stage
    const int next = s + STAGES - 1;
    if (next < nsteps) load(next, next % STAGES);
    cp_async_commit();
    const uint8_t* as = smem[s % STAGES][0];
    const uint8_t* bs = smem[s % STAGES][1];
    uint32_t af[4][4], bf[2][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ldsm_x4(af[i], as + swz(a_row + 16 * i, a_half));
#pragma unroll
    for (int j = 0; j < 2; ++j) ldsm_x4(bf[j], bs + swz(b_row + 16 * j, b_half));
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma16832_s8(acc[i][j], af[i], bf[j >> 1][(j & 1) * 2], bf[j >> 1][(j & 1) * 2 + 1]);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn * 32 + j * 8 + (lane & 3) * 2;
    if (col >= Cout) continue;  // Cout is even, so col + 1 < Cout as well
    const float f0 = fac[col], f1 = fac[col + 1], c0 = bias[col], c1 = bias[col + 1];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + wm * 64 + i * 16 + (lane >> 2) + hh * 8;
        if (row >= M) continue;
        const float v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * hh]), f0), c0);
        const float v1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * hh + 1]), f1), c1);
        const size_t o = (size_t)row * Cout + col;
        if (OUT_BF16) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + o) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(v0, v1);
        }
      }
  }
}

}  // namespace

// x (B, H, W, C) int8, w (Cout, KH, KW, C) int8, fac and bias (Cout) fp32,
// out (B, Ho, Wo, Cout) bf16 (out_bf16) or fp32. C % 16 == 0, Cout even.
extern "C" int tdrn_qconv(const void* x, const void* w, const void* fac, const void* bias,
                          void* out, int B, int H, int W, int C, int Cout, int KH, int KW,
                          int stride, int dil, int out_bf16, void* stream) {
  const int padh = dil * (KH - 1) / 2, padw = dil * (KW - 1) / 2;
  const int Ho = (H + 2 * padh - dil * (KH - 1) - 1) / stride + 1;
  const int Wo = (W + 2 * padw - dil * (KW - 1) - 1) / stride + 1;
  const int M = B * Ho * Wo;
  const dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto xi = static_cast<const int8_t*>(x);
  auto wi = static_cast<const int8_t*>(w);
  auto fi = static_cast<const float*>(fac);
  auto bi = static_cast<const float*>(bias);
  if (out_bf16) {
    qconv_kernel<true><<<grid, THREADS, 0, s>>>(xi, wi, fi, bi, out, H, W, C, Ho, Wo, Cout,
                                                KH, KW, stride, dil, padh, padw, M);
  } else {
    qconv_kernel<false><<<grid, THREADS, 0, s>>>(xi, wi, fi, bi, out, H, W, C, Ho, Wo, Cout,
                                                 KH, KW, stride, dil, padh, padw, M);
  }
  return static_cast<int>(cudaGetLastError());
}
