// K3: fused VGG stage 1, maxpool2(relu(conv3x3(relu(conv3x3(x, k1) + b1), k2) + b2)).
//
// Replaces tdrn_tpu/ops/stem_pallas.py::fused_stem_stage1 (Pallas kernel
// _stem_kernel). This file holds two kernels behind one entry point,
// tdrn_stem, which picks one by round_bf16:
// - stem_tc_kernel (round_bf16=1, compute_dtype=bfloat16: the default, and
//   what every model path runs) computes on the bf16 tensor cores;
// - stem_kernel (round_bf16=0, compute_dtype=float32) computes in fp32 on the
//   CUDA cores. It is the first version of K3, kept for that route only.
// Neither stands in for the other: a shape one of them does not take is an
// error.
//
// Rounding points follow the TPU kernel. With round_bf16, x, k1 and k2 are
// rounded to bf16 and the biases stay fp32; conv1 accumulates in fp32, gets
// bias + ReLU, is zeroed outside the image (conv2's SAME padding) and is
// rounded to bf16; conv2 accumulates in fp32, then gets bias + ReLU + the 2x2
// max-pool, and the result is stored as fp32 or bf16 (out_bf16). Without
// round_bf16 nothing is rounded before the output. x, k1 and k2 are all fp32
// or all bf16 (a template parameter); rounding a bf16 value to bf16 is the
// identity, so bf16 input gives the same result as its values in fp32.
//
// stem_tc_kernel. Bound on the H100: operations. At B=16, 320x320, 3 -> 64 ->
// 64, a launch is 126.5 GFLOP, 0.128 ms at the 989 TFLOP/s bf16 rate, against
// 62 MB in and out in bf16 (0.019 ms), so the 320^2 x 64 conv1 activations
// never reach device memory and the products run on the tensor cores.
// Design: a persistent grid of min(tiles, SMs x blocks an SM), one block of 8
// warps on each SM, each block walking 16x16 conv2 output tiles (8x8 pooled)
// with stride gridDim.x. A block loads the weights once, rounded to bf16:
// k2 as (tap*64 + m, n) rows of 64 padded to 72, and k1 as a (9*Cin -> 32
// zero-padded, 64) matrix whose row order tap*Cin + ci is the TPU kernel's
// patch order. Then, per tile:
// 1. im2col: the 20x20xCin bf16 input tile becomes a (324 -> 336, 32) patch
//    matrix.
// 2. conv1_1: (336 x 32) @ (32 x 64) on mma.sync.m16n8k16 (bf16 in, fp32
//    accumulators); bias, ReLU, the ring mask and the bf16 round go to a
//    (324, 64 + 8) o1 tile. Warp w owns m-tiles w, w+8 and w+16 (< 21).
// 3. The next tile's raw input is loaded into registers (5 values a thread)
//    and stored after step 4, so its latency hides behind the products.
// 4. conv1_2: a 9-tap implicit GEMM over o1, M = 256 (16 conv2 rows of 16
//    pixels, one m-tile a row), N = 64, K = 9 x 64. Warp (wm, wn) owns conv2
//    rows 4wm..4wm+3 and channels 32wn..32wn+31: 64 fp32 accumulators a
//    thread. For each dx and 16-channel step the warp loads the six o1 rows
//    it needs once (ldmatrix.x4) and uses them for all three dy; B comes from
//    the k-major weight rows by ldmatrix.x4.trans. A step of 16 mma thus
//    costs 4 ldmatrix.
// 5. The 2x2 max-pool runs on the accumulators: vertical pairs are two
//    m-tiles of one thread, horizontal pairs lanes 4 apart. Bias and ReLU
//    come after the max (both monotone, so the order is exact).
// Rows of 72 bf16 (144 B) and 40 bf16 (80 B) put the 8 rows of every
// ldmatrix phase on 32 distinct banks. Shared memory: 82,944 B (k2) + 4,608
// (k1) + 46,656 (o1) + 26,880 (im2col) + 2,400 (input tile) + 512 (biases) =
// 164,000 B, so one block an SM. Ragged edges: input outside the image reads
// as zero, the ring mask zeroes conv1 there, and pooled outputs past H/2 or
// W/2 are not stored. It takes Cin <= 3 (9*Cin <= 32) and Cmid = Cout = 64,
// VGG's stage 1.
//
// stem_kernel (fp32 compute). One block per 8x8 tile of pooled outputs and 64
// output channels; mid channels in chunks of 16: per chunk the block computes
// conv1 for its 18x18 halo tile into shared memory and stages that chunk of
// k2, then every thread accumulates a 2x2 pooling window x 16 output channels
// in fp32 FMAs. It is generic in Cin, Cmid (multiple of 16) and Cout
// (multiple of 64). Both kernels write NHWC.

#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

__device__ __forceinline__ bf16 to_bf16(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ bf16 to_bf16(bf16 v) { return v; }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// Eight consecutive elements as eight bf16 (16-byte aligned source).
__device__ __forceinline__ uint4 load8(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ uint4 load8(const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                    pack_bf16(b.z, b.w));
}

// ---- stem_tc_kernel: bf16 tensor cores ---------------------------------------

namespace tc {

constexpr int TC = 16;                // conv2 outputs per tile side
constexpr int TO = TC + 2;            // conv1 outputs per tile side (1-pixel halo)
constexpr int TX = TC + 4;            // input pixels per tile side (2-pixel halo)
constexpr int NO1 = TO * TO;          // conv1 positions of a tile (324)
constexpr int MT1 = (NO1 + 15) / 16;  // conv1 m-tiles (21)
constexpr int N = 64;                 // Cmid = Cout
constexpr int K1P = 32;               // im2col depth: 9*Cin zero-padded
constexpr int CIN_MAX = K1P / 9;      // 3
constexpr int WS = N + 8;             // row stride of k2, k1 and o1 (bf16)
constexpr int AS = K1P + 8;           // row stride of the im2col tile (bf16)
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int PF = (TX * TX * CIN_MAX + THREADS - 1) / THREADS;  // input values a thread

// Shared-memory layout in bytes; every offset is a multiple of 16.
constexpr int W2_OFF = 0;                              // [9*N][WS] bf16
constexpr int W1_OFF = W2_OFF + 9 * N * WS * 2;        // [K1P][WS] bf16
constexpr int O1_OFF = W1_OFF + K1P * WS * 2;          // [NO1][WS] bf16
constexpr int A1_OFF = O1_OFF + NO1 * WS * 2;          // [MT1*16][AS] bf16
constexpr int XS_OFF = A1_OFF + MT1 * 16 * AS * 2;     // [TX*TX*Cin] bf16
constexpr int BS_OFF = XS_OFF + TX * TX * CIN_MAX * 2; // [2][N] fp32
constexpr int SMEM = BS_OFF + 2 * N * 4;               // 164,000

struct Tile {
  int b, y0, x0;  // image, conv2 origin
};

__device__ __forceinline__ Tile tile_at(int t, int tiles_x, int per_img) {
  const int b = t / per_img, r = t - b * per_img;
  const int ty = r / tiles_x;
  return {b, ty * TC, (r - ty * tiles_x) * TC};
}

// This thread's PF values of the tile's 20x20xCin input window, x[...] or
// (outside the image) anything, with bit q of `live` set where value q is
// inside. The loads are unconditional so they issue at once.
template <typename T>
__device__ __forceinline__ void fetch(T (&raw)[PF], uint32_t& live, const T* __restrict__ x,
                                      Tile tl, int H, int W, int Cin, int tid) {
  const int rowlen = TX * Cin;
  live = 0;
#pragma unroll
  for (int q = 0; q < PF; ++q) {
    const int e = tid + q * THREADS;
    const int r = e / rowlen, c = e - r * rowlen;
    const int px = c / Cin, ci = c - px * Cin;
    const int gy = tl.y0 - 2 + r, gx = tl.x0 - 2 + px;
    const bool in = e < TX * rowlen && gy >= 0 && gy < H && gx >= 0 && gx < W;
    raw[q] = x[in ? (((long)tl.b * H + gy) * W + gx) * Cin + ci : 0];
    live |= (uint32_t)in << q;
  }
}

template <typename T>
__device__ __forceinline__ void stash(const T (&raw)[PF], uint32_t live, bf16* xs, int Cin,
                                      int tid) {
#pragma unroll
  for (int q = 0; q < PF; ++q) {
    const int e = tid + q * THREADS;
    if (e < TX * TX * Cin) xs[e] = (live >> q) & 1 ? to_bf16(raw[q]) : __float2bfloat16_rn(0.f);
  }
}

template <typename T, bool OUT_BF16>
__global__ void __launch_bounds__(THREADS, 1)
stem_tc_kernel(const T* __restrict__ x, const T* __restrict__ k1,
               const float* __restrict__ b1, const T* __restrict__ k2,
               const float* __restrict__ b2, void* __restrict__ out, int B, int H,
               int W, int Cin) {
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  bf16* w2s = reinterpret_cast<bf16*>(sm + W2_OFF);
  bf16* w1s = reinterpret_cast<bf16*>(sm + W1_OFF);
  bf16* o1s = reinterpret_cast<bf16*>(sm + O1_OFF);
  bf16* a1s = reinterpret_cast<bf16*>(sm + A1_OFF);
  bf16* xs = reinterpret_cast<bf16*>(sm + XS_OFF);
  float* b1s = reinterpret_cast<float*>(sm + BS_OFF);
  float* b2s = b1s + N;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;                   // mma groupID, thread in group
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 8;  // ldmatrix row, col
  const int tiles_x = (W + TC - 1) / TC, per_img = tiles_x * ((H + TC - 1) / TC);
  const int ntiles = B * per_img;
  const int Ho = H / 2, Wo = W / 2;

  // Weights and biases, once a block.
  for (int c = tid; c < 9 * N * N / 8; c += THREADS) {
    const int row = c / (N / 8), col = (c % (N / 8)) * 8;
    *reinterpret_cast<uint4*>(w2s + row * WS + col) = load8(k2 + row * N + col);
  }
  for (int c = tid; c < K1P * N / 8; c += THREADS) {
    const int row = c / (N / 8), col = (c % (N / 8)) * 8;
    *reinterpret_cast<uint4*>(w1s + row * WS + col) =
        row < 9 * Cin ? load8(k1 + row * N + col) : make_uint4(0, 0, 0, 0);
  }
  for (int t = tid; t < 2 * N; t += THREADS) b1s[t] = t < N ? b1[t] : b2[t - N];
  // im2col rows past the 18x18 tile stay zero.
  for (int t = tid; t < (MT1 * 16 - NO1) * AS / 2; t += THREADS)
    reinterpret_cast<uint32_t*>(a1s + NO1 * AS)[t] = 0u;

  // The im2col columns 2jp, 2jp+1 this thread builds: offsets into the input
  // tile, or -1 past 9*Cin.
  const int jp = tid & 15, prow = tid >> 4;
  int off[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = 2 * jp + u, tap = j / Cin, ci = j - tap * Cin;
    off[u] = j < 9 * Cin ? ((tap / 3) * TX + tap % 3) * Cin + ci : -1;
  }

  int tile = blockIdx.x;
  T raw[PF];
  uint32_t live;
  fetch(raw, live, x, tile_at(tile, tiles_x, per_img), H, W, Cin, tid);
  stash(raw, live, xs, Cin, tid);
  __syncthreads();

  for (; tile < ntiles; tile += gridDim.x) {
    const Tile tl = tile_at(tile, tiles_x, per_img);

    // 1. im2col.
    for (int p = prow; p < NO1; p += THREADS / 16) {
      const int r = p / TO, c = p - r * TO;
      const bf16* src = xs + (r * TX + c) * Cin;
      const bf16 zero = __float2bfloat16_rn(0.f);
      *reinterpret_cast<__nv_bfloat162*>(a1s + p * AS + 2 * jp) = __halves2bfloat162(
          off[0] >= 0 ? src[off[0]] : zero, off[1] >= 0 ? src[off[1]] : zero);
    }
    __syncthreads();

    // 2. conv1_1 on the tensor cores, then bias, ReLU, ring mask, bf16.
    {
      const bool own3 = warp + 16 < MT1;
      float acc[3][N / 8][4];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][nt][r] = 0.f;
      const bf16* a_lane = a1s + lr * AS + lc;
      const bf16* b_lane = w1s + lr * WS + lc;
#pragma unroll
      for (int kk = 0; kk < K1P; kk += 16) {
        uint32_t bq[N / 16][4];
#pragma unroll
        for (int np = 0; np < N / 16; ++np) ldsm_x4_t(bq[np], b_lane + kk * WS + 16 * np);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          if (i == 2 && !own3) break;
          uint32_t a[4];
          ldsm_x4(a, a_lane + (warp + 8 * i) * 16 * AS + kk);
#pragma unroll
          for (int np = 0; np < N / 16; ++np) {
            mma16816(acc[i][2 * np], a, bq[np][0], bq[np][1]);
            mma16816(acc[i][2 * np + 1], a, bq[np][2], bq[np][3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        if (i == 2 && !own3) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = (warp + 8 * i) * 16 + g + 8 * h;
          if (p >= NO1) continue;
          const int gy = tl.y0 - 1 + p / TO, gx = tl.x0 - 1 + p % TO;
          const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
          for (int nt = 0; nt < N / 8; ++nt) {
            const int n = nt * 8 + 2 * tig;
            float v0 = 0.f, v1 = 0.f;
            if (inside) {
              v0 = fmaxf(acc[i][nt][2 * h] + b1s[n], 0.f);
              v1 = fmaxf(acc[i][nt][2 * h + 1] + b1s[n + 1], 0.f);
            }
            *reinterpret_cast<uint32_t*>(o1s + p * WS + n) = pack_bf16(v0, v1);
          }
        }
      }
    }
    __syncthreads();

    // 3. The next tile's input, into registers.
    const int next = tile + gridDim.x;
    if (next < ntiles) fetch(raw, live, x, tile_at(next, tiles_x, per_img), H, W, Cin, tid);

    // 4. conv1_2: warp (wm, wn) owns conv2 rows 4wm..4wm+3, channels 32wn..+31.
    const int wm = warp & 3, wn = warp >> 2;
    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][nt][r] = 0.f;
    const bf16* a_lane = o1s + (4 * wm * TO + lr) * WS + lc;
    const bf16* b_lane = w2s + lr * WS + 32 * wn + lc;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
      for (int kk = 0; kk < N; kk += 16) {
        uint32_t a[6][4];  // o1 rows 4wm+r, shifted by dx: A of m-tile i at tap dy is a[i+dy]
#pragma unroll
        for (int r = 0; r < 6; ++r) ldsm_x4(a[r], a_lane + (r * TO + dx) * WS + kk);
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          uint32_t bq[2][4];
          const bf16* bp = b_lane + ((dy * 3 + dx) * N + kk) * WS;
          ldsm_x4_t(bq[0], bp);
          ldsm_x4_t(bq[1], bp + 16);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            mma16816(acc[i][0], a[i + dy], bq[0][0], bq[0][1]);
            mma16816(acc[i][1], a[i + dy], bq[0][2], bq[0][3]);
            mma16816(acc[i][2], a[i + dy], bq[1][0], bq[1][1]);
            mma16816(acc[i][3], a[i + dy], bq[1][2], bq[1][3]);
          }
        }
      }
    }

    // 5. 2x2 max-pool on the accumulators, then bias + ReLU, store. Row pair:
    // m-tiles 2ip and 2ip+1 of this thread; column pair: groupIDs g and g^1.
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = 32 * wn + nt * 8 + 2 * tig;
      const float bias0 = b2s[n], bias1 = b2s[n + 1];
#pragma unroll
      for (int ip = 0; ip < 2; ++ip) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = fmaxf(acc[2 * ip][nt][2 * h], acc[2 * ip + 1][nt][2 * h]);
          float v1 = fmaxf(acc[2 * ip][nt][2 * h + 1], acc[2 * ip + 1][nt][2 * h + 1]);
          v0 = fmaxf(v0, __shfl_xor_sync(0xffffffffu, v0, 4));
          v1 = fmaxf(v1, __shfl_xor_sync(0xffffffffu, v1, 4));
          const int oy = tl.y0 / 2 + 2 * wm + ip, ox = tl.x0 / 2 + (g + 8 * h) / 2;
          if ((g & 1) || oy >= Ho || ox >= Wo) continue;
          v0 = fmaxf(v0 + bias0, 0.f);
          v1 = fmaxf(v1 + bias1, 0.f);
          const long o = (((long)tl.b * Ho + oy) * Wo + ox) * N + n;
          if (OUT_BF16)
            *reinterpret_cast<uint32_t*>(reinterpret_cast<bf16*>(out) + o) = pack_bf16(v0, v1);
          else
            *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + o) = make_float2(v0, v1);
        }
      }
    }

    // The input tile was last read by step 1: store the next one.
    if (next < ntiles) stash(raw, live, xs, Cin, tid);
    __syncthreads();
  }
}

template <typename T, bool OUT_BF16>
cudaError_t launch(const void* x, const void* k1, const float* b1, const void* k2,
                   const float* b2, void* out, int B, int H, int W, int Cin,
                   cudaStream_t stream) {
  static int max_grid = 0;  // SMs x resident blocks an SM, set on the first launch
  if (max_grid == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaFuncSetAttribute(stem_tc_kernel<T, OUT_BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_tc_kernel<T, OUT_BF16>,
                                                        THREADS, SMEM);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    max_grid = sms * per_sm;
  }
  const long tiles = (long)B * ((H + TC - 1) / TC) * ((W + TC - 1) / TC);
  const int grid = (int)(tiles < max_grid ? tiles : max_grid);
  stem_tc_kernel<T, OUT_BF16><<<grid, THREADS, SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(k1), b1, static_cast<const T*>(k2),
      b2, out, B, H, W, Cin);
  return cudaGetLastError();
}

}  // namespace tc

// ---- stem_kernel: fp32 on the CUDA cores ----------------------------------------

namespace fp32 {

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

template <typename T, bool OUT_BF16>
__global__ void __launch_bounds__(THREADS, 2)
stem_kernel(const T* __restrict__ x, const T* __restrict__ k1,
            const float* __restrict__ b1, const T* __restrict__ k2,
            const float* __restrict__ b2, void* __restrict__ out, int H, int W,
            int Cin, int Cmid, int Cout) {
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
      v = to_f32(x[(((long)b * H + gy) * W + gx) * Cin + ci]);
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
      w2s[t] = to_f32(k2[((long)tap * Cmid + m0 + mm) * Cout + n0 + n]);
    }
    for (int t = tid; t < 9 * Cin * CK; t += THREADS) {
      const int mm = t % CK, ci = (t / CK) % Cin, tap = t / (CK * Cin);
      w1s[t] = to_f32(k1[((long)tap * Cin + ci) * Cmid + m0 + mm]);
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
        v = fmaxf(s + b1[m0 + mm], 0.f);
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
    bf16* dst = reinterpret_cast<bf16*>(out) + o;
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
                   int W, int Cin, int Cmid, int Cout, cudaStream_t stream) {
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
      static_cast<const T*>(k2), b2, out, H, W, Cin, Cmid, Cout);
  return cudaGetLastError();
}

}  // namespace fp32

template <typename T>
cudaError_t dispatch(const void* x, const void* k1, const float* b1, const void* k2,
                     const float* b2, void* out, int B, int H, int W, int Cin, int Cmid,
                     int Cout, int round_bf16, int out_bf16, cudaStream_t s) {
  if (round_bf16)
    return out_bf16 ? tc::launch<T, true>(x, k1, b1, k2, b2, out, B, H, W, Cin, s)
                    : tc::launch<T, false>(x, k1, b1, k2, b2, out, B, H, W, Cin, s);
  return out_bf16 ? fp32::launch<T, true>(x, k1, b1, k2, b2, out, B, H, W, Cin, Cmid, Cout, s)
                  : fp32::launch<T, false>(x, k1, b1, k2, b2, out, B, H, W, Cin, Cmid, Cout, s);
}

}  // namespace

// x (B,H,W,Cin) NHWC, k1 (3,3,Cin,Cmid), k2 (3,3,Cmid,Cout) HWIO, all fp32
// (in_bf16=0) or all bf16 (in_bf16=1), k1 and k2 16-byte aligned; b1, b2
// fp32. round_bf16=1 (bf16 compute) takes Cin <= 3 and Cmid = Cout = 64;
// round_bf16=0 (fp32 compute) takes Cmid % 16 == 0 and Cout % 64 == 0.
extern "C" int tdrn_stem(const void* x, const void* k1, const float* b1,
                         const void* k2, const float* b2, void* out, int B,
                         int H, int W, int Cin, int Cmid, int Cout, int in_bf16,
                         int round_bf16, int out_bf16, void* stream) {
  if (B < 1 || H < 2 || W < 2 || H % 2 || W % 2 || Cin < 1)
    return (int)cudaErrorInvalidValue;
  if (round_bf16 ? (Cin > tc::CIN_MAX || Cmid != tc::N || Cout != tc::N)
                 : (Cmid % fp32::CK || Cmid < fp32::CK || Cout % fp32::NSLICE ||
                    Cout < fp32::NSLICE ||
                    fp32::smem_floats(Cin) * sizeof(float) > 227 * 1024))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(in_bf16 ? dispatch<bf16>(x, k1, b1, k2, b2, out, B, H, W, Cin, Cmid, Cout,
                                        round_bf16, out_bf16, s)
                       : dispatch<float>(x, k1, b1, k2, b2, out, B, H, W, Cin, Cmid, Cout,
                                         round_bf16, out_bf16, s));
}
