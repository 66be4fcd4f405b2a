// K3: fused VGG stage 1, maxpool2(relu(conv3x3(relu(conv3x3(x, k1) + b1), k2) + b2)).
//
// Replaces tdrn_tpu/ops/stem_pallas.py::fused_stem_stage1 (Pallas kernel
// _stem_kernel). Rounding points follow the TPU kernel: with round_bf16 the
// input and both kernels are rounded to bf16, biases stay fp32, conv1's
// output gets bias + ReLU, is zeroed outside the image (conv2's SAME padding)
// and is rounded to bf16; conv2 accumulates in fp32, then bias + ReLU + the
// 2x2 max-pool, and the result is stored as fp32 or bf16 (out_bf16).
//
// Bound on the H100: operations. At 320x320x64 a frame is 7.9 GFLOP against
// about 8 MB in and out, so the 320^2 x 64 conv1 activations must never reach
// device memory. Design: one block per 8x8 tile of pooled outputs (16x16 conv2
// outputs) and 64 output channels. The mid channels run in chunks of 16: per
// chunk the block computes conv1 for its 18x18 halo tile into shared memory
// and stages that chunk of k2, then every thread accumulates a 2x2 pooling
// window x 16 output channels in registers (64 fp32 FMAs per pair of loads of
// conv1 values and weights). The conv1 tile's rows are padded to 24 floats so
// a half-warp's float2 loads hit 32 distinct banks; the weights are read as
// broadcast float4s. The output is written NHWC (channels_last for the
// following cuDNN conv). This is the simple CUDA-core version: Hopper's tensor
// cores (wgmma on bf16) are the way to the operation bound and are later work.
//
// x, k1 and k2 are all fp32 or all bf16 (the input type is a template
// parameter), so the resident-bf16 profile feeds its bf16 frames and weights
// in without an up-cast pass; rounding a bf16 value to bf16 is the identity.
// The kernel is generic in Cin, Cmid (multiple of 16) and Cout (multiple of
// 64); VGG stage 2 (K4) has its own tensor-core kernel in conv_stage.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TP = 8;            // pooled outputs per tile side
constexpr int TC = 2 * TP;       // conv2 outputs per tile side
constexpr int TO = TC + 2;       // conv1 outputs per tile side (1-pixel halo)
constexpr int TX = TC + 4;       // input pixels per tile side (2-pixel halo)
constexpr int RS = 24;           // padded conv1 row stride in floats
constexpr int CK = 16;           // mid channels per chunk
constexpr int GC = 16;           // output channels per thread
constexpr int NSLICE = 64;       // output channels per block
constexpr int THREADS = TP * TP * (NSLICE / GC);  // 256

__host__ __device__ constexpr size_t smem_floats(int cin) {
  return (size_t)9 * CK * NSLICE + (size_t)CK * TO * RS + (size_t)cin * TX * TX +
         (size_t)9 * cin * CK;
}

__device__ __forceinline__ float round_to(float v, int round_bf16) {
  return round_bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}
__device__ __forceinline__ float round_to(__nv_bfloat16 v, int) { return __bfloat162float(v); }

template <typename T, bool OUT_BF16>
__global__ void __launch_bounds__(THREADS, 2)
stem_kernel(const T* __restrict__ x, const T* __restrict__ k1,
            const float* __restrict__ b1, const T* __restrict__ k2,
            const float* __restrict__ b2, void* __restrict__ out, int H, int W,
            int Cin, int Cmid, int Cout, int round_bf16) {
  extern __shared__ float4 smem4[];
  float* w2s = reinterpret_cast<float*>(smem4);  // [9][CK][NSLICE]
  float* o1s = w2s + 9 * CK * NSLICE;            // [CK][TO][RS]
  float* xs = o1s + CK * TO * RS;                // [Cin][TX][TX]
  float* w1s = xs + Cin * TX * TX;               // [9][Cin][CK]

  const int tid = threadIdx.x;
  const int px = tid & 7, py = (tid >> 3) & 7, g = tid >> 6;
  const int nslices = Cout / NSLICE;
  const int b = blockIdx.z / nslices;
  const int n0 = (blockIdx.z % nslices) * NSLICE;
  const int y0 = blockIdx.y * TC, x0 = blockIdx.x * TC;  // conv2 tile origin

  // Input tile, rows y0-2 .. y0+TC+1, zero outside the image (conv1 padding).
  for (int t = tid; t < Cin * TX * TX; t += THREADS) {
    const int ci = t % Cin, c = (t / Cin) % TX, r = t / (Cin * TX);
    const int gy = y0 - 2 + r, gx = x0 - 2 + c;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = round_to(x[(((long)b * H + gy) * W + gx) * Cin + ci], round_bf16);
    xs[(ci * TX + r) * TX + c] = v;
  }

  float acc[4][GC];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int n = 0; n < GC; ++n) acc[q][n] = 0.f;

  for (int m0 = 0; m0 < Cmid; m0 += CK) {
    __syncthreads();  // the previous chunk's readers are done
    for (int t = tid; t < 9 * CK * NSLICE; t += THREADS) {
      const int n = t % NSLICE, mm = (t / NSLICE) % CK, tap = t / (NSLICE * CK);
      w2s[t] = round_to(k2[((long)tap * Cmid + m0 + mm) * Cout + n0 + n], round_bf16);
    }
    for (int t = tid; t < 9 * Cin * CK; t += THREADS) {
      const int mm = t % CK, ci = (t / CK) % Cin, tap = t / (CK * Cin);
      w1s[t] = round_to(k1[((long)tap * Cin + ci) * Cmid + m0 + mm], round_bf16);
    }
    __syncthreads();

    // conv1 for this chunk over the TO x TO halo tile.
    for (int t = tid; t < CK * TO * TO; t += THREADS) {
      const int c = t % TO, r = (t / TO) % TO, mm = t / (TO * TO);
      const int gy = y0 - 1 + r, gx = x0 - 1 + c;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        float s = 0.f;
        for (int dy = 0; dy < 3; ++dy)
          for (int dx = 0; dx < 3; ++dx)
            for (int ci = 0; ci < Cin; ++ci)
              s += xs[(ci * TX + r + dy) * TX + c + dx] *
                   w1s[((dy * 3 + dx) * Cin + ci) * CK + mm];
        v = round_to(fmaxf(s + b1[m0 + mm], 0.f), round_bf16);
      }
      o1s[(mm * TO + r) * RS + c] = v;
    }
    __syncthreads();

    // conv2: this thread's 2x2 pooling window x GC output channels.
    for (int mm = 0; mm < CK; ++mm) {
      float p[4][4];
      const float* base = o1s + (mm * TO + 2 * py) * RS + 2 * px;
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const float2 u = *reinterpret_cast<const float2*>(base + rr * RS);
        const float2 v = *reinterpret_cast<const float2*>(base + rr * RS + 2);
        p[rr][0] = u.x; p[rr][1] = u.y; p[rr][2] = v.x; p[rr][3] = v.y;
      }
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4* wp = reinterpret_cast<const float4*>(
              w2s + ((dy * 3 + dx) * CK + mm) * NSLICE + g * GC);
          float wv[GC];
#pragma unroll
          for (int q = 0; q < GC / 4; ++q) {
            const float4 w4 = wp[q];
            wv[4 * q] = w4.x; wv[4 * q + 1] = w4.y;
            wv[4 * q + 2] = w4.z; wv[4 * q + 3] = w4.w;
          }
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int bb = 0; bb < 2; ++bb) {
              const float o = p[a + dy][bb + dx];
#pragma unroll
              for (int n = 0; n < GC; ++n)
                acc[a * 2 + bb][n] = fmaf(o, wv[n], acc[a * 2 + bb][n]);
            }
        }
    }
  }

  const int oy = blockIdx.y * TP + py, ox = blockIdx.x * TP + px;
  if (oy >= H / 2 || ox >= W / 2) return;
  const long o = (((long)b * (H / 2) + oy) * (W / 2) + ox) * Cout + n0 + g * GC;
  float res[GC];
#pragma unroll
  for (int n = 0; n < GC; ++n) {
    const float bias = b2[n0 + g * GC + n];
    float v = fmaxf(acc[0][n] + bias, 0.f);
    v = fmaxf(v, fmaxf(acc[1][n] + bias, 0.f));
    v = fmaxf(v, fmaxf(acc[2][n] + bias, 0.f));
    res[n] = fmaxf(v, fmaxf(acc[3][n] + bias, 0.f));
  }
  if (OUT_BF16) {
    __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(out) + o;
#pragma unroll
    for (int n = 0; n < GC; ++n) dst[n] = __float2bfloat16_rn(res[n]);
  } else {
    float4* dst = reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + o);
#pragma unroll
    for (int q = 0; q < GC / 4; ++q)
      dst[q] = make_float4(res[4 * q], res[4 * q + 1], res[4 * q + 2], res[4 * q + 3]);
  }
}

template <typename T, bool OUT_BF16>
cudaError_t launch(const void* x, const void* k1, const float* b1,
                   const void* k2, const float* b2, void* out, int B, int H,
                   int W, int Cin, int Cmid, int Cout, int round_bf16,
                   cudaStream_t stream) {
  const size_t smem = smem_floats(Cin) * sizeof(float);
  static size_t configured = 0;  // the largest size already allowed
  if (smem > 48 * 1024 && smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        stem_kernel<T, OUT_BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  dim3 grid((W / 2 + TP - 1) / TP, (H / 2 + TP - 1) / TP, B * (Cout / NSLICE));
  stem_kernel<T, OUT_BF16><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(k1), b1,
      static_cast<const T*>(k2), b2, out, H, W, Cin, Cmid, Cout, round_bf16);
  return cudaGetLastError();
}

}  // namespace

// x (B,H,W,Cin) NHWC, k1 (3,3,Cin,Cmid), k2 (3,3,Cmid,Cout) HWIO, all fp32
// (in_bf16=0) or all bf16 (in_bf16=1); b1, b2 fp32.
extern "C" int tdrn_stem(const void* x, const void* k1, const float* b1,
                         const void* k2, const float* b2, void* out, int B,
                         int H, int W, int Cin, int Cmid, int Cout, int in_bf16,
                         int round_bf16, int out_bf16, void* stream) {
  if (B < 1 || H < 2 || W < 2 || H % 2 || W % 2 || Cin < 1 || Cmid % CK ||
      Cmid < CK || Cout % NSLICE || Cout < NSLICE ||
      smem_floats(Cin) * sizeof(float) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  typedef __nv_bfloat16 bf16;
  if (in_bf16)
    return (int)(out_bf16 ? launch<bf16, true>(x, k1, b1, k2, b2, out, B, H, W, Cin,
                                               Cmid, Cout, round_bf16, s)
                          : launch<bf16, false>(x, k1, b1, k2, b2, out, B, H, W, Cin,
                                                Cmid, Cout, round_bf16, s));
  return (int)(out_bf16 ? launch<float, true>(x, k1, b1, k2, b2, out, B, H, W, Cin,
                                              Cmid, Cout, round_bf16, s)
                        : launch<float, false>(x, k1, b1, k2, b2, out, B, H, W, Cin,
                                               Cmid, Cout, round_bf16, s));
}
