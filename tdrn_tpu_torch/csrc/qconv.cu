// K5: the whole int8 QConv in one launch. It quantizes the bf16 or fp32
// activations while loading them, runs the s8 convolution on Hopper's
// tensor cores and applies the dequantizing epilogue:
//   out = float(conv_s32(q(x), w)) * fac + bias, rounded to bf16 or fp32,
//   q(x) = clamp(rint(float(x) * s), -127, 127), s = fp32(127 / xscale).
//
// Replaces tdrn_tpu/models/layers.py::QConv (XLA's fused quantize pass, its
// conv_general_dilated(s8, s8, preferred_element_type=s32) and the dequantize
// behind it); the JAX package has no Pallas kernel for it. Every conv of the
// int8 serving profile runs here: 3x3 (stride 1 or 2, dilation 1 or 3), 1x1
// (stride 1 or 2) and 7x7/2, SAME padding d*(k-1)/2.
//
// Operands. x: (B, C, H, W) bf16 or fp32 with any strides (elements); the
// vector loader below needs channels_last (C stride 1) and C % 16 == 0, the
// small-C loader takes any layout. w: the packed weights, a (Cout, Kp) int8
// matrix, row k = (ky * KW + kx) * C + c, zero past K = KH*KW*C (Kp is K, or
// K rounded up to 32 where C % 16 != 0). s, fac = wscale * (xscale / 127) and
// bias are fp32 device arrays, so nothing is read on the host and the launch
// can be captured in a CUDA graph. The int32 sums are exact (|acc| <= 127^2 *
// K, 7.4e7 on every shape of the profile) in any order, and the epilogue
// rounds as the plain version does, one operation at a time
// (__int2float_rn, __fmul_rn, __fadd_rn, round-to-nearest-even to bf16), so
// the output is bit-equal to ops/qconv.py::qconv_plain, split-k included.
//
// Bound on the H100: operations on the deep layers (2*M*N*K int8 ops at
// 1,979 TOP/s dense), bytes on the wide early ones (conv1_2 at 320x320 reads
// 210 MB of bf16 and writes as much). What bounds this kernel in practice
// is its producers: a K step's loads, quantization and proxy fence run in
// order, about 2 us a step at 40x40 against 0.85 us of wgmma, and every
// input value is loaded and quantized once for every tap and N tile that
// reads it (9x on a 3x3; PERF.md section 6). Design:
// - An implicit GEMM, M = B*Ho*Wo pixels, N = Cout, K = KH*KW*C, one output
//   tile of 128 x BN (BN = 64, 128 or 256 by Cout and M: the plan in
//   ops/qconv.py) a work unit, K in steps of 128 bytes.
// - Warp-specialized and persistent: a block an SM walks work units grid
//   apart. Two consumer warpgroups of 64 rows run wgmma.m64nBNk32 (s8 in,
//   s32 out), four a step, and the epilogue; one producer warpgroup at BN
//   256 (the consumers then hold 128 accumulators a thread), two below, fill
//   a ring of 4-8 stages. Full and empty mbarriers hand the stages over,
//   across unit boundaries, so a unit's epilogue runs while the next unit's
//   stages fill.
// - B (weights) comes by TMA, one 128-byte-swizzled BN x 128 tile a step.
// - A cannot come by TMA, since it changes type on the way: the producers
//   load it with 16-byte loads (8 bf16 or 4 fp32), scale, clamp and round it
//   (no float-to-int conversion: see qbits) and store 16 bytes into the same
//   128-byte swizzle, zeros outside the image, past M and past K (the zero
//   point is 0, so that is exact), then fence to the async proxy.
// - Small C (the stems' 3 and 12 channels): K runs over (tap, channel)
//   flattened and is padded once to 32 (27 -> 32, 108 -> 128), so conv1_1
//   takes one k32 step instead of nine half-empty ones. Its steps are short
//   and latency-bound, so each producer warp prepares whole steps in turn,
//   gathering values along the input's own strides (no layout copy).
// - Split-k for small M: where the tiles would not fill the card, the plan
//   splits the K steps of a tile over up to four work units. Each split
//   stores its int32 partial into its own slice of a workspace
//   (wrapper-allocated, never read before written); the last block to take
//   the tile's ticket (an atomic counter in device memory) adds the other
//   slices to its own accumulators, runs the epilogue and resets the ticket
//   to 0, so the next launch or graph replay finds it zero. One launch a
//   QConv either way.
// Known waste: the producers' serial step and the 9x re-quantization above
// (a halo patch quantized once a channel block and gathered per tap was
// tried and was slower: its builds stall the ring; PERF.md section 6); the
// epilogue stores 4 or 8 bytes a thread straight from the accumulators;
// ReLU stays a separate pass.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;          // pixels of a block tile
constexpr int BK = 128;          // bytes (int8 values of K) of a K step
constexpr int CONSUMERS = 256;   // two warpgroups run the wgmmas
constexpr int A_TILE = BM * BK;  // bytes of one A stage
constexpr int MAX_TILES = 4096;  // tickets: tiles of a split launch

__device__ unsigned int g_tickets[MAX_TILES];

struct Params {
  const void* x;
  const float* s;
  const float* fac;
  const float* bias;
  void* out;
  int* ws;
  int sb, sh, sw, sc;  // strides of x in elements
  int H, W, C, Ho, Wo, Cout, KW, stride, dil, padh, padw, M, K, ksteps, kblocks, splits,
      stages, flat, out_bf16;
};

// The int8 value of an already scaled input, clamp(rint(v), -127, 127), as
// the low byte of a float's bits: clamp first (exact; rint is monotone and
// keeps the integer bounds), then add 1.5 * 2^23, whose ulp is 1, so the one
// rounding of the addition is rint's, half to even (the constant is even),
// and the low byte of the sum's bits is the value in two's complement. No
// float-to-int conversion, which runs at a quarter of the FP32 rate.
__device__ __forceinline__ uint32_t qbits(float v) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(v, -127.f), 127.f), 12582912.f));
}
// Four scaled inputs as four int8 bytes.
__device__ __forceinline__ uint32_t pack4(float a, float b, float c, float d) {
  return __byte_perm(__byte_perm(qbits(a), qbits(b), 0x0040),
                     __byte_perm(qbits(c), qbits(d), 0x0040), 0x5410);
}

__device__ __forceinline__ float lo_bf16(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// 16 values (one 16-byte chunk of A) from the raw words of 16 inputs.
__device__ __forceinline__ uint4 quant16(const uint4* v, float s, bf16*) {
  uint4 q;
  uint32_t* o = reinterpret_cast<uint32_t*>(&q);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&v[h]);
#pragma unroll
    for (int p = 0; p < 2; ++p)
      o[2 * h + p] = pack4(__fmul_rn(lo_bf16(w[2 * p]), s), __fmul_rn(hi_bf16(w[2 * p]), s),
                           __fmul_rn(lo_bf16(w[2 * p + 1]), s), __fmul_rn(hi_bf16(w[2 * p + 1]), s));
  }
  return q;
}
__device__ __forceinline__ uint4 quant16(const uint4* v, float s, float*) {
  uint4 q;
  uint32_t* o = reinterpret_cast<uint32_t*>(&q);
#pragma unroll
  for (int h = 0; h < 4; ++h)
    o[h] = pack4(__fmul_rn(__uint_as_float(v[h].x), s), __fmul_rn(__uint_as_float(v[h].y), s),
                 __fmul_rn(__uint_as_float(v[h].z), s), __fmul_rn(__uint_as_float(v[h].w), s));
  return q;
}

// Barrier 1 among the two consumer warpgroups only (the producers never
// take it).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

// Byte offset of 16-byte chunk `chunk` of row `row` in a 128-byte-swizzled
// tile (the TMA's SWIZZLE_128B and wgmma's 128B layout on a 1024-aligned
// tile).
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * BK + ((chunk ^ (row & 7)) << 4);
}

// Producer warpgroups of a block: one beside the 256-wide tiles (their
// consumers hold 128 accumulators a thread), two beside the narrower ones.
template <int BN>
struct Roles {
  static constexpr int PRODUCERS = BN == 256 ? 128 : 256;
  static constexpr int THREADS = CONSUMERS + PRODUCERS;
};

template <typename Tin, int BN>
__global__ void __launch_bounds__(Roles<BN>::THREADS, 1)
qconv_kernel(const __grid_constant__ CUtensorMap wmap, const Params p) {
  constexpr int VPC = sizeof(Tin);  // 16-byte loads per 16-value chunk
  constexpr int B_TILE = BN * BK;
  constexpr int NACC = BN / 2;
  constexpr int PRODUCERS = Roles<BN>::PRODUCERS;
  constexpr int RPT = BM * 8 / PRODUCERS;  // A rows a producer thread fills (one chunk each)
  constexpr int RSTEP = PRODUCERS / 8;     // between a thread's rows
  constexpr int RB = VPC == 2 ? 4 : 2;     // rows loaded at once
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int ST = p.stages;
  uint8_t* a_s = smem;
  uint8_t* b_s = a_s + ST * A_TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(b_s + ST * B_TILE);
  uint64_t* empty = full + ST;
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31;
  const float s = __ldg(p.s);
  const Tin* x = static_cast<const Tin*>(p.x);
  const int n_tiles = (p.Cout + BN - 1) / BN, m_tiles = (p.M + BM - 1) / BM;
  const int units = n_tiles * m_tiles * p.splits;
  const int HoWo = p.Ho * p.Wo;

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      // Every thread of the producers of a step, and the TMA's bytes.
      mbar_init(&full[i], (p.flat ? 32 : PRODUCERS) + 1);
      mbar_init(&empty[i], CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();  // the last block-wide barrier: the roles part here

  // A work unit: one output tile and one split of its K steps; unit u is
  // tile (u % n_tiles, (u / n_tiles) % m_tiles), split u / (n_tiles * m_tiles).
  // Every block walks units blockIdx.x, + gridDim.x, ... (persistent).
  struct Unit {
    int u, n0, m0, z, kb, kb_end;
  };
  auto unit_at = [&](int u) {
    Unit w;
    w.u = u;
    const int t = u % (n_tiles * m_tiles);
    w.z = u / (n_tiles * m_tiles);
    w.n0 = (t % n_tiles) * BN;
    w.m0 = (t / n_tiles) * BM;
    w.kb = w.z * p.kblocks / p.splits;
    w.kb_end = (w.z + 1) * p.kblocks / p.splits;
    return w;
  };

  if (tid >= CONSUMERS) {
    // ---- Producers: weights by TMA, A by the quantizing loader. ----------
    const int pt = tid - CONSUMERS, pwarp = pt >> 5, chunk = pt & 7;
    int xoff[RPT], iy0[RPT], ix0[RPT];
    auto rows_for = [&](int m0) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int m = m0 + (pt >> 3) + RSTEP * i;
        xoff[i] = 0, iy0[i] = -(1 << 29), ix0[i] = 0;  // past M: outside the image
        if (m < p.M) {  // x has fewer than 2^31 elements (the wrapper checks)
          const int b = m / HoWo, rem = m - b * HoWo;
          const int oy = rem / p.Wo, ox = rem - oy * p.Wo;
          xoff[i] = b * p.sb, iy0[i] = oy * p.stride - p.padh, ix0[i] = ox * p.stride - p.padw;
        }
      }
    };
    // Vector loader (C % 16 == 0, channels_last): this thread's chunk (16
    // consecutive channels of one tap) of its RPT rows, RB rows at a time.
    auto build_vec = [&](int kb, uint8_t* a) {
      if (kb * (BK / 32) + chunk / 2 >= p.ksteps) return;  // not read by any k32 step
      const int k = kb * BK + 16 * chunk;
      const int tap = k / p.C, c = k - tap * p.C;
      const int ky = tap / p.KW, kx = tap - ky * p.KW;
      const int dy = ky * p.dil, dx = kx * p.dil;
      const bool k_ok = k < p.K;
#pragma unroll
      for (int r = 0; r < RPT; r += RB) {
        uint4 v[RB][VPC];
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          const int iy = iy0[r + i] + dy, ix = ix0[r + i] + dx;
          const bool in = k_ok && (unsigned)iy < (unsigned)p.H && (unsigned)ix < (unsigned)p.W;
          const uint4* src = reinterpret_cast<const uint4*>(
              x + (in ? xoff[r + i] + iy * p.sh + ix * p.sw + c : 0));
#pragma unroll
          for (int u = 0; u < VPC; ++u) v[i][u] = in ? __ldg(src + u) : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int i = 0; i < RB; ++i)
          *reinterpret_cast<uint4*>(a + swz((pt >> 3) + RSTEP * (r + i), chunk)) =
              quant16(v[i], s, (Tin*)nullptr);
      }
    };
    // Small-C loader: K over (tap, channel) flattened, value by value along
    // the input's own strides. Its steps are short and wait on load latency,
    // so each producer warp prepares whole steps on its own, one in every NW
    // (the plan never splits these convs: step g is K step g % kblocks of
    // the block's unit g / kblocks). Lane l takes byte 32*j + l of the K step
    // (one (tap, channel) decomposition) for all BM rows, 32 loads in flight.
    constexpr int NW = PRODUCERS / 32;
    if (p.flat) {
      const int steps = ((units - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * p.kblocks;
      for (int g = pwarp; g < steps; g += NW) {
        const Unit w = unit_at(blockIdx.x + (g / p.kblocks) * gridDim.x);
        const int kb = w.kb + g % p.kblocks, stage = g % ST;
        mbar_wait(&empty[stage], ((g / ST) & 1) ^ 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[stage], B_TILE);
          tma_load_2d(b_s + stage * B_TILE, &wmap, kb * BK, w.n0, &full[stage]);
        }
        uint8_t* a = a_s + stage * A_TILE;
        const int used = min(BK, p.ksteps * 32 - kb * BK);
        for (int j = 0; 32 * j < used; ++j) {
          const int kl = 32 * j + lane, k = kb * BK + kl;
          const int tap = k / p.C, c = k - tap * p.C;
          const int ky = tap / p.KW, kx = tap - ky * p.KW;
          const bool k_ok = k < p.K;
          const int dy = ky * p.dil - p.padh, dx = kx * p.dil - p.padw, coff = c * p.sc;
          int m = w.m0, b = m / HoWo, rem = m - b * HoWo, oy = rem / p.Wo, ox = rem - oy * p.Wo;
          for (int r0 = 0; r0 < BM; r0 += 32) {
            float f[32];
#pragma unroll
            for (int i = 0; i < 32; ++i) {  // row r0 + i: the pixel after the last
              const int iy = oy * p.stride + dy, ix = ox * p.stride + dx;
              const bool in = k_ok && m < p.M && (unsigned)iy < (unsigned)p.H &&
                              (unsigned)ix < (unsigned)p.W;
              f[i] = in ? to_float(x[b * p.sb + iy * p.sh + ix * p.sw + coff]) : 0.f;
              ++m;
              if (++ox == p.Wo) {
                ox = 0;
                if (++oy == p.Ho) oy = 0, ++b;
              }
            }
#pragma unroll
            for (int i = 0; i < 32; ++i)
              a[swz(r0 + i, kl >> 4) + (kl & 15)] = static_cast<uint8_t>(qbits(__fmul_rn(f[i], s)));
          }
        }
        fence_proxy_async();  // the stores reach the wgmma's (async) proxy
        mbar_arrive(&full[stage]);
      }
      return;
    }
    Unit w = unit_at(blockIdx.x);
    rows_for(w.m0);
    for (int g = 0; w.u < units; ++g) {
      const int stage = g % ST;
      mbar_wait(&empty[stage], ((g / ST) & 1) ^ 1);  // the consumers are done with it
      if (pt == 0) {
        mbar_arrive_expect_tx(&full[stage], B_TILE);
        tma_load_2d(b_s + stage * B_TILE, &wmap, w.kb * BK, w.n0, &full[stage]);
      }
      build_vec(w.kb, a_s + stage * A_TILE);
      fence_proxy_async();  // the stores reach the wgmma's (async) proxy
      mbar_arrive(&full[stage]);
      if (++w.kb == w.kb_end) {
        w = unit_at(w.u + gridDim.x);
        if (w.u < units) rows_for(w.m0);
      }
    }
    return;
  }

  // ---- Consumers: two warpgroups of 64 rows, wgmma and the epilogue. -----
  const int warp = tid >> 5, wg = warp >> 2;
  int acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0;
  // Accumulator fragment of m64nBNk32: register 4*j + 2*h + e holds row
  // 16*(warp%4) + lane/4 + 8*h of the warpgroup's 64, column 8*j + 2*(lane%4) + e.
  const int row_in_tile = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  Unit cw = unit_at(blockIdx.x);
  for (int g = 0; cw.u < units; ++g) {
    const int stage = g % ST;
    mbar_wait(&full[stage], (g / ST) & 1);
    const uint64_t da = desc_sw128(a_s + stage * A_TILE + wg * 64 * BK);
    const uint64_t db = desc_sw128(b_s + stage * B_TILE);
    // All four k32 steps, also on a last K step where fewer are needed: B is
    // zero there (packed zeros below Kp, TMA zero fill past it), so the
    // unbuilt A chunks add nothing, and no branch splits the wgmma batch.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) wgmma_s8<BN>(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<0>();
    mbar_arrive(&empty[stage]);
    if (++cw.kb < cw.kb_end) continue;

    // The unit's last step: its epilogue, while the producers fill the
    // next unit's first stages.
    fence_regs<NACC>(acc);
    const int row_base = cw.m0 + row_in_tile, col_base = cw.n0 + 2 * (lane & 3);
    bool write = true;
    // Split-k (BN <= 128 only; the plan never splits 256-wide tiles): publish
    // this split's partial and take the tile's ticket; the last block adds
    // the other partials and resets the ticket.
    if (BN <= 128 && p.splits > 1) {
      const int tile = cw.u % (n_tiles * m_tiles);
      int* mine = p.ws + (size_t)cw.z * p.M * p.Cout;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = col_base + 8 * j;
        if (col >= p.Cout) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row_base + 8 * h;
          if (row < p.M)
            *reinterpret_cast<int2*>(mine + (size_t)row * p.Cout + col) =
                make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
      __threadfence();
      consumer_sync();
      if (tid == 0) s_last = atomicAdd(&g_tickets[tile], 1u) == (unsigned)(p.splits - 1);
      consumer_sync();
      write = s_last;
      consumer_sync();  // everyone has read s_last before the next unit's ticket
      if (write) {
        __threadfence();
        // Eight loads in flight at a time, none behind a branch: outside the
        // output they read the slice's first pair and add nothing.
        for (int o = 0; o < p.splits; ++o) {
          if (o == cw.z) continue;
          const int* other = p.ws + (size_t)o * p.M * p.Cout;
#pragma unroll
          for (int j0 = 0; j0 < BN / 8; j0 += 4) {
            int2 t[4][2];
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int row = row_base + 8 * h, col = col_base + 8 * (j0 + j);
                const bool ok = row < p.M && col < p.Cout;
                t[j][h] = __ldcg(reinterpret_cast<const int2*>(
                    other + (ok ? (size_t)row * p.Cout + col : 0)));
                if (!ok) t[j][h] = make_int2(0, 0);
              }
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                acc[4 * (j0 + j) + 2 * h] += t[j][h].x;
                acc[4 * (j0 + j) + 2 * h + 1] += t[j][h].y;
              }
          }
        }
        if (tid == 0) g_tickets[tile] = 0;
      }
    }
    if (write) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = col_base + 8 * j;
        if (col >= p.Cout) continue;  // Cout is even, so col + 1 < Cout as well
        const float f0 = p.fac[col], f1 = p.fac[col + 1], c0 = p.bias[col], c1 = p.bias[col + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row_base + 8 * h;
          if (row >= p.M) continue;
          const float v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), f0), c0);
          const float v1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), f1), c1);
          const size_t o = (size_t)row * p.Cout + col;
          if (p.out_bf16) {
            *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out) + o) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o) = make_float2(v0, v1);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0;
    cw = unit_at(cw.u + gridDim.x);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

template <typename Tin, int BN>
int launch(const CUtensorMap& map, const Params& p, int grid, cudaStream_t stream) {
  const int smem = p.stages * (A_TILE + BN * BK) + p.stages * 16 + 1024;
  // Raised only when a launch asks for more than before: setting the
  // attribute on every call costs the host time.
  static int allowed = 0;
  if (smem > allowed) {
    cudaError_t e = cudaFuncSetAttribute(qconv_kernel<Tin, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = smem;
  }
  qconv_kernel<Tin, BN><<<grid, Roles<BN>::THREADS, smem, stream>>>(map, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, C, H, W) bf16 (x_bf16) or fp32 at strides (sb, sh, sw, sc) elements;
// w (Cout, kp) int8 packed; s (1), fac and bias (Cout) fp32; out (B, Ho, Wo,
// Cout) bf16 (out_bf16) or fp32; ws int32 (splits, M, Cout) or null when
// splits == 1. bn, splits, stages, flat, kp and grid (blocks, each walking
// work units grid apart) come from ops/qconv.py::plan.
// Returns a cudaError_t, or -1 when cuTensorMapEncodeTiled is missing and
// -(1000 + CUresult) when it refuses the weights' tensor map.
extern "C" int tdrn_qconv(const void* x, const void* w, const void* s, const void* fac,
                          const void* bias, void* out, void* ws, int B, int H, int W, int C,
                          int Cout, int KH, int KW, int stride, int dil, int sb, int sh, int sw,
                          int sc, int x_bf16, int out_bf16, int bn, int splits, int stages,
                          int flat, int kp, int grid, void* stream) {
  Params p;
  p.x = x;
  p.s = static_cast<const float*>(s);
  p.fac = static_cast<const float*>(fac);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.ws = static_cast<int*>(ws);
  p.sb = sb, p.sh = sh, p.sw = sw, p.sc = sc;
  p.H = H, p.W = W, p.C = C, p.Cout = Cout, p.KW = KW, p.stride = stride, p.dil = dil;
  p.padh = dil * (KH - 1) / 2;
  p.padw = dil * (KW - 1) / 2;
  p.Ho = (H + 2 * p.padh - dil * (KH - 1) - 1) / stride + 1;
  p.Wo = (W + 2 * p.padw - dil * (KW - 1) - 1) / stride + 1;
  p.M = B * p.Ho * p.Wo;
  p.K = KH * KW * C;
  p.ksteps = (kp + 31) / 32;
  p.kblocks = (kp + BK - 1) / BK;
  p.splits = splits, p.stages = stages, p.flat = flat, p.out_bf16 = out_bf16;
  const int tiles = ((Cout + bn - 1) / bn) * ((p.M + BM - 1) / BM);
  if (splits < 1 || splits > p.kblocks ||
      (splits > 1 && (ws == nullptr || tiles > MAX_TILES || bn > 128)) ||
      stages < 3 || (!flat && (C % 16 || sc != 1)) || (flat && splits > 1) || kp % 16 ||
      kp < p.K || grid < 1 ||
      grid > tiles * splits)
    return static_cast<int>(cudaErrorInvalidValue);

  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)kp, (cuuint64_t)Cout};
  const cuuint64_t strides[1] = {(cuuint64_t)kp};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)bn};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims,
                            strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return -(1000 + static_cast<int>(r));

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (bn == 64) return launch<bf16, 64>(map, p, grid, st);
    if (bn == 128) return launch<bf16, 128>(map, p, grid, st);
    if (bn == 256) return launch<bf16, 256>(map, p, grid, st);
  } else {
    if (bn == 64) return launch<float, 64>(map, p, grid, st);
    if (bn == 128) return launch<float, 128>(map, p, grid, st);
    if (bn == 256) return launch<float, 256>(map, p, grid, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
