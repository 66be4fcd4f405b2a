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
// products run on the tensor cores. Design: one block per 8x8 tile of pooled
// outputs (16x16 conv2 outputs) and 128 output channels, 8 warps, bf16
// mma.sync.m16n8k16 with fp32 accumulators: an implicit GEMM, each of the
// nine taps a shifted (pixels, Cin) @ (Cin, N) product, as in the TPU kernel.
// - The block copies its 20x20xCin input tile once. conv1 runs over the
//   18x18 halo tile (21 m-tiles; warp w owns w, w+8 and w+16 < 21) in passes
//   of 64 mid channels, writing bias + ReLU + ring-masked bf16 into a
//   (324, Cmid + 8) o1 tile. conv2 then runs one tap at a time: warp (wm, wn)
//   owns conv2 rows 4wm..4wm+3 (one m-tile of 16 pixels each) and channels
//   64wn..64wn+63, 128 fp32 accumulators a thread.
// - Weights stream through shared memory in slices, double-buffered: conv1
//   in slices of 3 taps x Cin rows x 64 mid channels (27,648 B at Cin=64),
//   conv2 in slices of one tap, Cmid rows x 128 channels (34,816 B). Slice
//   s+1 is in flight while slice s is multiplied: one cp.async group and one
//   __syncthreads a slice. With bf16 weights (the served case) each slice is
//   a set of 16-byte cp.async copies straight from the HWIO rows, whose n
//   is contiguous; the input tile is copied the same way, zero-filled
//   outside the image. fp32 input and weights are converted on the way in,
//   by plain loads and stores.
// - Fragments come from shared memory by ldmatrix.x4: A plain, B transposed
//   (.trans) from the k-major weight rows. A step of 32 (conv2) or 24
//   (conv1) mma costs 8 or 7 ldmatrix.
// - Every shared row is padded by 8 bf16 (rows of 144 or 272 B), so the 8
//   rows of an ldmatrix phase touch 32 distinct banks.
// - Shared memory at 64 -> 128 -> 128: input tile 57,600 B, o1 88,128 B,
//   weight buffers 27,648 + 34,816 B; the second conv2 buffer reuses the
//   input tile, dead once conv1 is done. 208,192 B, one block an SM.
// - The 2x2 pool is done on the accumulators: vertical pairs are two m-tiles
//   of the same thread, horizontal pairs are lanes 4 apart. Bias and ReLU
//   come after the max (both monotone, so the order is exact).
// Known waste: conv1 covers the 18x18 halo (1.27x its useful work), the
// 1,600 blocks at B=16 run in 12.1 waves of 132, and each block re-reads the
// weights from L2.

#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

constexpr int TC = 16;            // conv2 outputs per tile side
constexpr int TP = TC / 2;        // pooled outputs per tile side
constexpr int TO = TC + 2;        // conv1 outputs per tile side (1-pixel halo)
constexpr int TX = TC + 4;        // input pixels per tile side (2-pixel halo)
constexpr int NO1 = TO * TO;      // conv1 positions of a tile (324)
constexpr int MT1 = (NO1 + 15) / 16;  // conv1 m-tiles of 16 positions (21)
constexpr int NQ = 64;            // mid channels per conv1 pass
constexpr int TAPS1 = 3;          // taps per conv1 weight slice
constexpr int NB = 128;           // output channels per block
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int PAD = 8;            // bf16 padding of each shared-memory row

// Byte offsets into dynamic shared memory. The last conv1 slice always goes
// to s1a, so the first conv2 slice (s2a) can load while it is multiplied;
// s2b reuses the input tile when it fits.
struct Layout {
  int o1, s1a, s1b, s2a, s2b, total;
};

__host__ __device__ inline Layout layout(int cin, int cmid) {
  const int xs = TX * TX * (cin + PAD) * 2, o1 = NO1 * (cmid + PAD) * 2;
  const int s1 = TAPS1 * cin * (NQ + PAD) * 2, s2 = cmid * (NB + PAD) * 2;
  const int w = xs + o1;
  Layout l;
  l.o1 = xs;
  l.s1a = w;
  l.s1b = l.s2a = w + s1;
  l.total = w + s1 + (s1 > s2 ? s1 : s2);
  if (s2 <= xs) {
    l.s2b = 0;
  } else {
    l.s2b = l.total;
    l.total += s2;
  }
  return l;
}

// 16 bytes (8 bf16) into shared memory, zeros where !in. bf16 source: an
// asynchronous copy; fp32 source: eight floats converted to bf16.
__device__ __forceinline__ void copy16(bf16* dst, const bf16* src, bool in = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void copy16(bf16* dst, const float* src, bool in = true) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (in) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(src));
    const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
    v = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                   pack_bf16(b.z, b.w));
  }
  *reinterpret_cast<uint4*>(dst) = v;
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename T, bool OUT_BF16>
__global__ void __launch_bounds__(THREADS, 1)
conv_stage_kernel(const T* __restrict__ x, const T* __restrict__ k1,
                  const float* __restrict__ b1, const T* __restrict__ k2,
                  const float* __restrict__ b2, void* __restrict__ out, int H,
                  int W, int Cin, int Cmid, int Cout) {
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  const Layout L = layout(Cin, Cmid);
  bf16* xs = reinterpret_cast<bf16*>(sm);  // [TX*TX][Cin+PAD]
  bf16* o1s = reinterpret_cast<bf16*>(sm + L.o1);  // [NO1][Cmid+PAD]
  const int xst = Cin + PAD, ost = Cmid + PAD;
  constexpr int S1ST = NQ + PAD, S2ST = NB + PAD;  // weight slice row strides

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;  // mma groupID, thread in group
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 8;  // ldmatrix row, col
  const int nslices = Cout / NB;
  const int b = blockIdx.z / nslices;
  const int nb0 = (blockIdx.z % nslices) * NB;
  const int y0 = blockIdx.y * TC, x0 = blockIdx.x * TC;  // conv2 tile origin
  const int S1 = TAPS1 * (Cmid / NQ);  // conv1 weight slices; conv2's follow

  // Weight slice s: conv1 pass s / 3, taps 3*(s % 3) .. +2 (rows of k1 as
  // (9*Cin, Cmid)); then conv2 tap s - S1 (rows of k2 as (9*Cmid, Cout)).
  auto slice = [&](int s) -> bf16* {
    if (s < S1) return reinterpret_cast<bf16*>(sm + ((S1 - 1 - s) & 1 ? L.s1b : L.s1a));
    return reinterpret_cast<bf16*>(sm + ((s - S1) & 1 ? L.s2b : L.s2a));
  };
  auto stage = [&](int s) {
    bf16* dst = slice(s);
    if (s < S1) {
      const int row0 = (s % 3) * TAPS1 * Cin, q0 = (s / 3) * NQ;
      for (int c = tid; c < TAPS1 * Cin * (NQ / 8); c += THREADS) {
        const int r = c / (NQ / 8), col = (c % (NQ / 8)) * 8;
        copy16(dst + r * S1ST + col, k1 + (long)(row0 + r) * Cmid + q0 + col);
      }
    } else {
      const long row0 = (long)(s - S1) * Cmid;
      for (int c = tid; c < Cmid * (NB / 8); c += THREADS) {
        const int r = c / (NB / 8), col = (c % (NB / 8)) * 8;
        copy16(dst + r * S2ST + col, k2 + (row0 + r) * Cout + nb0 + col);
      }
    }
  };

  // Input tile, rows y0-2 .. y0+TC+1, zero outside the image (conv1 padding),
  // with the first weight slice in the same group.
  for (int c = tid; c < TX * TX * (Cin / 8); c += THREADS) {
    const int pos = c / (Cin / 8), ch = (c % (Cin / 8)) * 8;
    const int gy = y0 - 2 + pos / TX, gx = x0 - 2 + pos % TX;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    copy16(xs + pos * xst + ch, x + (in ? (((long)b * H + gy) * W + gx) * Cin + ch : 0), in);
  }
  stage(0);
  cp_async_commit();

  // ---- conv1 over the TO x TO halo tile, NQ mid channels a pass ----------
  const bool own3 = warp + 16 < MT1;
  int xoff[3];  // input-tile offset of this lane's ldmatrix row of each m-tile (tap 0)
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int p = min((warp + 8 * i) * 16 + lr, NO1 - 1);
    xoff[i] = ((p / TO) * TX + p % TO) * xst + lc;
  }
  float acc1[3][NQ / 8][4];
  for (int s = 0; s < S1; ++s) {
    cp_async_wait_all();
    __syncthreads();  // slice s has landed; every reader of slice s-1 is done
    stage(s + 1);     // the next conv1 slice, or conv2's first
    cp_async_commit();
    const int part = s % 3;
    if (part == 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int nt = 0; nt < NQ / 8; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc1[i][nt][r] = 0.f;
    }
    const bf16* wb = slice(s) + lr * S1ST + lc;
#pragma unroll
    for (int tl = 0; tl < TAPS1; ++tl) {
      const int shift = (part * TX + tl) * xst;  // tap (dy, dx) = (part, tl)
#pragma unroll 2
      for (int kk = 0; kk < Cin; kk += 16) {
        uint32_t bq[NQ / 16][4];
#pragma unroll
        for (int np = 0; np < NQ / 16; ++np)
          ldsm_x4_t(bq[np], wb + (tl * Cin + kk) * S1ST + 16 * np);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          if (i == 2 && !own3) break;
          uint32_t a[4];
          ldsm_x4(a, xs + xoff[i] + shift + kk);
#pragma unroll
          for (int np = 0; np < NQ / 16; ++np) {
            mma16816(acc1[i][2 * np], a, bq[np][0], bq[np][1]);
            mma16816(acc1[i][2 * np + 1], a, bq[np][2], bq[np][3]);
          }
        }
      }
    }
    if (part != 2) continue;

    // Bias + ReLU, zero outside the image, round to bf16, store.
    const int q0 = (s / 3) * NQ;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (i == 2 && !own3) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (warp + 8 * i) * 16 + g + 8 * h;
        if (p >= NO1) continue;
        const int gy = y0 - 1 + p / TO, gx = x0 - 1 + p % TO;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int nt = 0; nt < NQ / 8; ++nt) {
          const int n = q0 + nt * 8 + 2 * tig;
          float v0 = 0.f, v1 = 0.f;
          if (inside) {
            v0 = fmaxf(acc1[i][nt][2 * h] + b1[n], 0.f);
            v1 = fmaxf(acc1[i][nt][2 * h + 1] + b1[n + 1], 0.f);
          }
          *reinterpret_cast<uint32_t*>(o1s + p * ost + n) = pack_bf16(v0, v1);
        }
      }
    }
  }

  // ---- conv2 over the TC x TC tile, one tap a slice ------------------------
  const int wm = warp & 3, wn = warp >> 2;
  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][nt][r] = 0.f;

  const bf16* ab = o1s + (4 * wm * TO + lr) * ost + lc;
  for (int tap = 0; tap < 9; ++tap) {
    cp_async_wait_all();
    __syncthreads();  // this tap's slice (and, at tap 0, conv1's output) is in place
    if (tap < 8) {
      stage(S1 + tap + 1);
      cp_async_commit();
    }
    const bf16* at = ab + ((tap / 3) * TO + tap % 3) * ost;
    const bf16* wb = slice(S1 + tap) + lr * S2ST + 64 * wn + lc;
#pragma unroll 2
    for (int kk = 0; kk < Cmid; kk += 16) {
      uint32_t bq[4][4];
#pragma unroll
      for (int np = 0; np < 4; ++np) ldsm_x4_t(bq[np], wb + kk * S2ST + 16 * np);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t a[4];
        ldsm_x4(a, at + i * TO * ost + kk);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          mma16816(acc[i][2 * np], a, bq[np][0], bq[np][1]);
          mma16816(acc[i][2 * np + 1], a, bq[np][2], bq[np][3]);
        }
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
          *reinterpret_cast<uint32_t*>(reinterpret_cast<bf16*>(out) + o) = pack_bf16(v0, v1);
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
  const int smem = layout(Cin, Cmid).total;
  static int configured = 0;  // the largest size already allowed
  if (smem > 48 * 1024 && smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(conv_stage_kernel<T, OUT_BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
// (in_bf16=0) or all bf16 (in_bf16=1), each 16-byte aligned; b1, b2 fp32;
// out (B,H/2,W/2,Cout) fp32 or bf16 (out_bf16). Cin a multiple of 16, Cmid
// of 64, Cout of 128.
extern "C" int tdrn_conv_stage(const void* x, const void* k1, const float* b1,
                               const void* k2, const float* b2, void* out, int B,
                               int H, int W, int Cin, int Cmid, int Cout,
                               int in_bf16, int out_bf16, void* stream) {
  if (B < 1 || H < 2 || W < 2 || H % 2 || W % 2 || Cin < 16 || Cin % 16 ||
      Cmid < NQ || Cmid % NQ || Cout < NB || Cout % NB ||
      layout(Cin, Cmid).total > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_bf16)
    return (int)(out_bf16 ? launch<bf16, true>(x, k1, b1, k2, b2, out, B, H, W, Cin, Cmid, Cout, s)
                          : launch<bf16, false>(x, k1, b1, k2, b2, out, B, H, W, Cin, Cmid, Cout, s));
  return (int)(out_bf16 ? launch<float, true>(x, k1, b1, k2, b2, out, B, H, W, Cin, Cmid, Cout, s)
                        : launch<float, false>(x, k1, b1, k2, b2, out, B, H, W, Cin, Cmid, Cout, s));
}
