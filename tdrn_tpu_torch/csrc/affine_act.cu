// K6: a conv output's bias, the FrozenBN that follows, the residual add and
// the ReLU, in one pass over the output, in place.
//
// Replaces the separate PyTorch passes of a ResNet bottleneck's tail on
// the card (models/resnet.py): cuDNN's in-place bias add, FrozenBN's
// multiply and add, the residual add and the ReLU, each a pass over the
// whole bf16 tensor. A (C,) operand broadcast over a channels_last 4-D
// tensor sends PyTorch's bias and norm passes to its generic, offset-
// computing elementwise kernel; here each element is read and written once.
// The tensor is channels_last, viewed as (N*H*W, C) rows, C % 8 == 0.
//
// Per element, in the order of the PyTorch ops it replaces, each op in fp32
// from bf16 operands and rounded to bf16 (round to nearest even), so the
// result is bit-equal to them:
//   t = c
//   t = bf16(t + conv_bias)           if the conv has a bias
//   t = bf16(t * scale)               FrozenBN
//   t = bf16(t + bias)
//   t = bf16(t + s)                   shortcut: s = the identity's value, or
//                                     the proj output under its own chain
//   t = max(t, 0), NaN kept           ReLU, always: every site ends in one
// The products of two bf16 values are exact in fp32, so each multiply rounds
// once; the sums round in fp32 and then to bf16, as PyTorch's do.
//
// Bound on the H100: memory (a few flops a byte). Design, so that each byte
// moves once: a thread takes 8 channels (one 16-byte vector) of a row,
// kUnroll vectors an iteration of a grid-stride loop, their loads issued
// before any arithmetic; the per-channel vectors (conv bias, scale, bias,
// and the proj's three) are C long and come from cache. The result
// overwrites the conv output, which nothing else reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;    // vectors a thread loads before it computes
constexpr int kBlocksPerSm = 8;

enum Shortcut { kNone = 0, kIdentity = 1, kProj = 2 };

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// Every value packed here already holds a bf16 value: the conversion is exact.
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

__device__ __forceinline__ float to_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// t <- bf16(bf16(bf16(t + conv_bias) * scale) + bias), the conv bias if kBias.
template <bool kBias>
__device__ __forceinline__ void affine(float (&t)[8], const uint4* __restrict__ conv_bias,
                                       const uint4* __restrict__ scale,
                                       const uint4* __restrict__ bias, unsigned g) {
  float s[8], b[8];
  if (kBias) {
    float cb[8];
    unpack(__ldg(conv_bias + g), cb);
#pragma unroll
    for (int i = 0; i < 8; ++i) t[i] = to_bf16(__fadd_rn(t[i], cb[i]));
  }
  unpack(__ldg(scale + g), s);
  unpack(__ldg(bias + g), b);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    t[i] = to_bf16(__fmul_rn(t[i], s[i]));
    t[i] = to_bf16(__fadd_rn(t[i], b[i]));
  }
}

template <bool kBias, int kShortcut>
__global__ void __launch_bounds__(kThreads) affine_act_kernel(
    uint4* __restrict__ x, const uint4* __restrict__ conv_bias,
    const uint4* __restrict__ scale, const uint4* __restrict__ bias,
    const uint4* __restrict__ res, const uint4* __restrict__ res_conv_bias,
    const uint4* __restrict__ res_scale, const uint4* __restrict__ res_bias,
    unsigned n, unsigned groups) {
  const unsigned stride = gridDim.x * kThreads;
  for (unsigned base = blockIdx.x * kThreads * kUnroll + threadIdx.x; base < n;
       base += stride * kUnroll) {
    uint4 xv[kUnroll], rv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned i = base + u * kThreads;
      if (i < n) {
        xv[u] = x[i];
        if (kShortcut != kNone) rv[u] = res[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned i = base + u * kThreads;
      if (i >= n) break;
      const unsigned g = i % groups;
      float t[8];
      unpack(xv[u], t);
      affine<kBias>(t, conv_bias, scale, bias, g);
      if (kShortcut != kNone) {
        float s[8];
        unpack(rv[u], s);
        if (kShortcut == kProj) affine<kBias>(s, res_conv_bias, res_scale, res_bias, g);
#pragma unroll
        for (int k = 0; k < 8; ++k) t[k] = to_bf16(__fadd_rn(t[k], s[k]));
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) t[k] = t[k] != t[k] ? t[k] : fmaxf(t[k], 0.f);
      x[i] = pack(t);
    }
  }
}

int blocks_for(unsigned n) {
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return -1;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  const unsigned per_block = (unsigned)kThreads * kUnroll;
  const unsigned want = (n + per_block - 1) / per_block;
  const unsigned most = (unsigned)sms[dev] * kBlocksPerSm;
  return (int)(want < most ? want : most);
}

template <bool kBias, int kShortcut>
int launch(void* x, const void* cb, const void* sc, const void* bi, const void* res,
           const void* rcb, const void* rsc, const void* rbi, unsigned n, unsigned groups,
           cudaStream_t stream) {
  const int blocks = blocks_for(n);
  if (blocks < 0) return (int)cudaErrorInvalidDevice;
  affine_act_kernel<kBias, kShortcut><<<blocks, kThreads, 0, stream>>>(
      (uint4*)x, (const uint4*)cb, (const uint4*)sc, (const uint4*)bi, (const uint4*)res,
      (const uint4*)rcb, (const uint4*)rsc, (const uint4*)rbi, n, groups);
  return (int)cudaGetLastError();
}

template <bool kBias>
int launch_shortcut(int shortcut, void* x, const void* cb, const void* sc, const void* bi,
                    const void* res, const void* rcb, const void* rsc, const void* rbi,
                    unsigned n, unsigned groups, cudaStream_t st) {
  switch (shortcut) {
    case kNone: return launch<kBias, kNone>(x, cb, sc, bi, res, rcb, rsc, rbi, n, groups, st);
    case kIdentity:
      return launch<kBias, kIdentity>(x, cb, sc, bi, res, rcb, rsc, rbi, n, groups, st);
    default: return launch<kBias, kProj>(x, cb, sc, bi, res, rcb, rsc, rbi, n, groups, st);
  }
}

}  // namespace

// x: (rows, C) bf16, overwritten with the result; conv_bias (or null), scale,
// bias: (C,) bf16; shortcut 0 (none), 1 (identity: res, (rows, C)) or 2
// (proj: res under res_conv_bias (null exactly where conv_bias is), res_scale
// and res_bias). Every pointer 16-byte aligned, C % 8 == 0, rows * C / 8
// below 2^31.
extern "C" int tdrn_affine_act(void* x, const void* conv_bias, const void* scale,
                               const void* bias, const void* res, const void* res_conv_bias,
                               const void* res_scale, const void* res_bias, int rows, int C,
                               int shortcut, void* stream) {
  if (rows < 1 || C < 8 || C % 8 != 0 || shortcut < 0 || shortcut > 2) {
    return (int)cudaErrorInvalidValue;
  }
  if (shortcut != kNone && res == nullptr) return (int)cudaErrorInvalidValue;
  if (shortcut == kProj && (res_scale == nullptr || res_bias == nullptr ||
                            (res_conv_bias == nullptr) != (conv_bias == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n = (long long)rows * (C / 8);
  if (n >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const unsigned groups = (unsigned)(C / 8);
  const cudaStream_t st = (cudaStream_t)stream;
  return conv_bias != nullptr
             ? launch_shortcut<true>(shortcut, x, conv_bias, scale, bias, res, res_conv_bias,
                                     res_scale, res_bias, (unsigned)n, groups, st)
             : launch_shortcut<false>(shortcut, x, conv_bias, scale, bias, res, res_conv_bias,
                                      res_scale, res_bias, (unsigned)n, groups, st);
}
