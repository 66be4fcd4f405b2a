// K4: fused VGG conv stage, maxpool2(relu(conv3x3(relu(conv3x3(x, k1) + b1), k2) + b2)).
//
// Replaces tdrn_tpu/ops/stem_pallas.py::fused_conv_stage (Pallas kernel
// _stage_kernel), which runs VGG stage 2 (conv2_1 + conv2_2 + pool2, 64 ->
// 128 -> 128 at 160x160) under stem="fused2". Rounding points follow the TPU
// kernel: x, k1 and k2 are rounded to bf16, products accumulate in fp32,
// biases are fp32; conv1's output gets bias + ReLU, is zeroed outside the
// image (conv2's SAME padding) and is rounded to bf16; conv2 then gets bias +
// ReLU and the 2x2 max-pool, and the result is stored as fp32 or bf16.
//
// Bound on the H100: operations. At B=16 a launch is 181 GFLOP of bf16
// products against 79 MB in and out (bf16), 0.183 ms at 989 TFLOP/s, so the
// 160^2 x 128 conv1 activations must never reach device memory and the
// products must run on the tensor cores. Design: one block per 8x8 tile of
// pooled outputs (16x16 conv2 outputs) and 128 output channels, 8 warps,
// bf16 mma.sync.m16n8k16 with fp32 accumulators (an implicit GEMM: each of
// the nine taps is a shifted (pixels, Cin) @ (Cin, N) product, as in the TPU
// kernel). The block stages its 20x20 input tile once; conv1 runs over the
// 18x18 halo tile in passes of 32 mid channels (all nine taps of that k1
// slice staged), writing bias + ReLU + ring-masked bf16 into shared memory;
// conv2 then stages k2 one tap at a time. Every shared-memory row is padded
// by 8 bf16 so the 8 rows x 4 column pairs that a warp's fragment loads touch
// 32 distinct banks. The 2x2 pool is done on the accumulators: vertical pairs
// are two m-tiles of the same thread, horizontal pairs are lanes 4 apart.
// Known waste of this first version: conv1 is computed over the 18x18 halo
// (1.27x its useful work), weights are re-read from L2 by every block, and
// staging does not overlap the products (one block of 8 warps per SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TC = 16;            // conv2 outputs per tile side
constexpr int TP = TC / 2;        // pooled outputs per tile side
constexpr int TO = TC + 2;        // conv1 outputs per tile side (1-pixel halo)
constexpr int TX = TC + 4;        // input pixels per tile side (2-pixel halo)
constexpr int NO1 = TO * TO;      // conv1 positions of a tile (324)
constexpr int MT1 = (NO1 + 15) / 16;  // conv1 m-tiles of 16 positions (21)
constexpr int NQ = 32;            // mid channels per conv1 pass
constexpr int NB = 128;           // output channels per block
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int PAD = 8;            // bf16 padding of each shared-memory row

typedef __nv_bfloat16 bf16;

// Shared memory in bf16 elements: input tile, conv1 tile, weight stage.
__host__ __device__ constexpr size_t xs_elems(int cin) { return (size_t)TX * TX * (cin + PAD); }
__host__ __device__ constexpr size_t o1_elems(int cmid) { return (size_t)NO1 * (cmid + PAD); }
__host__ __device__ constexpr size_t ws_elems(int cin, int cmid) {
  return (size_t)9 * NQ * (cin + PAD) > (size_t)NB * (cmid + PAD)
             ? (size_t)9 * NQ * (cin + PAD)
             : (size_t)NB * (cmid + PAD);
}
__host__ __device__ constexpr size_t smem_bytes(int cin, int cmid) {
  return 2 * (xs_elems(cin) + o1_elems(cmid) + ws_elems(cin, cmid));
}

__device__ __forceinline__ bf16 to_bf16(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ bf16 to_bf16(bf16 v) { return v; }

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16x16, row) * b (16x8, col); bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T, bool OUT_BF16>
__global__ void __launch_bounds__(THREADS, 1)
conv_stage_kernel(const T* __restrict__ x, const T* __restrict__ k1,
                  const float* __restrict__ b1, const T* __restrict__ k2,
                  const float* __restrict__ b2, void* __restrict__ out, int H,
                  int W, int Cin, int Cmid, int Cout) {
  extern __shared__ float4 smem4[];
  bf16* xs = reinterpret_cast<bf16*>(smem4);  // [TX*TX][Cin+PAD]
  bf16* o1s = xs + xs_elems(Cin);             // [NO1][Cmid+PAD]
  bf16* ws = o1s + o1_elems(Cmid);            // conv1: [9][NQ][Cin+PAD]; conv2: [NB][Cmid+PAD]
  const int xst = Cin + PAD, ost = Cmid + PAD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;  // mma groupID, thread in group
  const int nslices = Cout / NB;
  const int b = blockIdx.z / nslices;
  const int nb0 = (blockIdx.z % nslices) * NB;
  const int y0 = blockIdx.y * TC, x0 = blockIdx.x * TC;  // conv2 tile origin

  // Input tile, rows y0-2 .. y0+TC+1, zero outside the image (conv1 padding).
  for (int t = tid; t < TX * TX * Cin; t += THREADS) {
    const int ci = t % Cin, pos = t / Cin;
    const int gy = y0 - 2 + pos / TX, gx = x0 - 2 + pos % TX;
    bf16 v = __float2bfloat16_rn(0.f);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = to_bf16(x[(((long)b * H + gy) * W + gx) * Cin + ci]);
    xs[pos * xst + ci] = v;
  }

  // ---- conv1 over the TO x TO halo tile, NQ mid channels a pass ----------
  // Warp w owns m-tiles w, w+8, w+16; the third exists for w < MT1-16 and is
  // otherwise a repeat of the last tile whose results are dropped.
  int xoff[3][2];  // input-tile position of rows g and g+8 of each m-tile (tap 0)
  bool own3 = warp + 16 < MT1;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int mt = i < 2 ? warp + 8 * i : (own3 ? warp + 16 : MT1 - 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = min(mt * 16 + g + 8 * h, NO1 - 1);
      xoff[i][h] = ((p / TO) * TX + p % TO) * xst + 2 * tig;
    }
  }
  for (int q0 = 0; q0 < Cmid; q0 += NQ) {
    __syncthreads();  // the input tile is stored; the previous pass's readers are done
    for (int t = tid; t < 9 * Cin * NQ; t += THREADS) {
      const int n = t % NQ, ci = (t / NQ) % Cin, tap = t / (NQ * Cin);
      ws[(tap * NQ + n) * xst + ci] = to_bf16(k1[((long)tap * Cin + ci) * Cmid + q0 + n]);
    }
    __syncthreads();

    float acc[3][NQ / 8][4];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int nt = 0; nt < NQ / 8; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][nt][r] = 0.f;

    for (int tap = 0; tap < 9; ++tap) {
      const int shift = ((tap / 3) * TX + tap % 3) * xst;
      const bf16* wb = ws + (tap * NQ + g) * xst + 2 * tig;
      for (int kk = 0; kk < Cin; kk += 16) {
        uint32_t a[3][4];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const bf16* p0 = xs + xoff[i][0] + shift + kk;
          const bf16* p1 = xs + xoff[i][1] + shift + kk;
          a[i][0] = ld32(p0);
          a[i][1] = ld32(p1);
          a[i][2] = ld32(p0 + 8);
          a[i][3] = ld32(p1 + 8);
        }
#pragma unroll
        for (int nt = 0; nt < NQ / 8; ++nt) {
          const uint32_t w0 = ld32(wb + nt * 8 * xst + kk);
          const uint32_t w1 = ld32(wb + nt * 8 * xst + kk + 8);
#pragma unroll
          for (int i = 0; i < 3; ++i) mma16816(acc[i][nt], a[i], w0, w1);
        }
      }
    }

    // Bias + ReLU, zero outside the image, round to bf16, store.
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (i == 2 && !own3) break;
      const int mt = warp + 8 * i;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = mt * 16 + g + 8 * h;
        if (p >= NO1) continue;
        const int gy = y0 - 1 + p / TO, gx = x0 - 1 + p % TO;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int nt = 0; nt < NQ / 8; ++nt) {
          const int n = q0 + nt * 8 + 2 * tig;
          float v0 = 0.f, v1 = 0.f;
          if (inside) {
            v0 = fmaxf(acc[i][nt][2 * h] + b1[n], 0.f);
            v1 = fmaxf(acc[i][nt][2 * h + 1] + b1[n + 1], 0.f);
          }
          *reinterpret_cast<__nv_bfloat162*>(o1s + p * ost + n) =
              __halves2bfloat162(to_bf16(v0), to_bf16(v1));
        }
      }
    }
  }

  // ---- conv2 over the TC x TC tile: warp (wm, wn) owns conv2 rows
  // 4*wm .. 4*wm+3 (one m-tile of 16 pixels each) and channels 64*wn .. +63.
  const int wm = warp & 3, wn = warp >> 2;
  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][nt][r] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();  // conv1 is stored; the previous tap's readers are done
    for (int t = tid; t < Cmid * NB; t += THREADS) {
      const int n = t % NB, m = t / NB;
      ws[n * ost + m] = to_bf16(k2[((long)tap * Cmid + m) * Cout + nb0 + n]);
    }
    __syncthreads();
    const int dy = tap / 3, dx = tap % 3;
    const bf16* ab = o1s + ((4 * wm + dy) * TO + g + dx) * ost + 2 * tig;
    const bf16* wb = ws + (64 * wn + g) * ost + 2 * tig;
    for (int kk = 0; kk < Cmid; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bf16* p0 = ab + i * TO * ost + kk;
        a[i][0] = ld32(p0);
        a[i][1] = ld32(p0 + 8 * ost);
        a[i][2] = ld32(p0 + 8);
        a[i][3] = ld32(p0 + 8 * ost + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const uint32_t w0 = ld32(wb + nt * 8 * ost + kk);
        const uint32_t w1 = ld32(wb + nt * 8 * ost + kk + 8);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma16816(acc[i][nt], a[i], w0, w1);
      }
    }
  }

  // 2x2 max-pool, then bias + ReLU (both monotone, so the order is exact).
  // Row pair: m-tiles 2*ip and 2*ip+1 of this thread; column pair: groupIDs
  // g and g^1, lanes 4 apart.
  const int Ho = H / 2, Wo = W / 2;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int n = nb0 + 64 * wn + nt * 8 + 2 * tig;
    const float bias0 = b2[n], bias1 = b2[n + 1];
#pragma unroll
    for (int ip = 0; ip < 2; ++ip) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = fmaxf(acc[2 * ip][nt][2 * h], acc[2 * ip + 1][nt][2 * h]);
        float v1 = fmaxf(acc[2 * ip][nt][2 * h + 1], acc[2 * ip + 1][nt][2 * h + 1]);
        v0 = fmaxf(v0, __shfl_xor_sync(0xffffffffu, v0, 4));
        v1 = fmaxf(v1, __shfl_xor_sync(0xffffffffu, v1, 4));
        const int oy = blockIdx.y * TP + 2 * wm + ip;
        const int ox = blockIdx.x * TP + (g + 8 * h) / 2;
        if ((g & 1) || oy >= Ho || ox >= Wo) continue;
        v0 = fmaxf(v0 + bias0, 0.f);
        v1 = fmaxf(v1 + bias1, 0.f);
        const long o = (((long)b * Ho + oy) * Wo + ox) * Cout + n;
        if (OUT_BF16)
          *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<bf16*>(out) + o) =
              __halves2bfloat162(to_bf16(v0), to_bf16(v1));
        else
          *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + o) = make_float2(v0, v1);
      }
    }
  }
}

template <typename T, bool OUT_BF16>
cudaError_t launch(const void* x, const void* k1, const float* b1, const void* k2,
                   const float* b2, void* out, int B, int H, int W, int Cin,
                   int Cmid, int Cout, cudaStream_t stream) {
  const size_t smem = smem_bytes(Cin, Cmid);
  static size_t configured = 0;  // the largest size already allowed
  if (smem > 48 * 1024 && smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(conv_stage_kernel<T, OUT_BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  dim3 grid((W / 2 + TP - 1) / TP, (H / 2 + TP - 1) / TP, B * (Cout / NB));
  conv_stage_kernel<T, OUT_BF16><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(k1), b1,
      static_cast<const T*>(k2), b2, out, H, W, Cin, Cmid, Cout);
  return cudaGetLastError();
}

}  // namespace

// x (B,H,W,Cin) NHWC, k1 (3,3,Cin,Cmid), k2 (3,3,Cmid,Cout) HWIO, all fp32
// (in_bf16=0) or all bf16 (in_bf16=1); b1, b2 fp32; out (B,H/2,W/2,Cout)
// fp32 or bf16 (out_bf16). Cin a multiple of 16, Cmid of 32, Cout of 128.
extern "C" int tdrn_conv_stage(const void* x, const void* k1, const float* b1,
                               const void* k2, const float* b2, void* out, int B,
                               int H, int W, int Cin, int Cmid, int Cout,
                               int in_bf16, int out_bf16, void* stream) {
  if (B < 1 || H < 2 || W < 2 || H % 2 || W % 2 || Cin < 16 || Cin % 16 ||
      Cmid < NQ || Cmid % NQ || Cout < NB || Cout % NB ||
      smem_bytes(Cin, Cmid) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_bf16)
    return (int)(out_bf16 ? launch<bf16, true>(x, k1, b1, k2, b2, out, B, H, W, Cin, Cmid, Cout, s)
                          : launch<bf16, false>(x, k1, b1, k2, b2, out, B, H, W, Cin, Cmid, Cout, s));
  return (int)(out_bf16 ? launch<float, true>(x, k1, b1, k2, b2, out, B, H, W, Cin, Cmid, Cout, s)
                        : launch<float, false>(x, k1, b1, k2, b2, out, B, H, W, Cin, Cmid, Cout, s));
}
