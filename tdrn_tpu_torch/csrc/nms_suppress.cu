// K2: greedy NMS suppression over score-sorted candidates.
//
// Replaces tdrn_tpu/ops/nms_pallas.py::suppress_sorted (Pallas kernel
// _suppress_kernel). A row is one (image, class) list of K candidates sorted
// by descending score. Candidate j is suppressed when its IoU with a
// higher-ranked surviving candidate i is above the threshold; slots with
// score 0 are empty. Output: the scores with suppressed and empty slots zeroed.
//
// Bound on the H100: not the bytes (a row moves 24*K bytes) but the relation
// "i suppresses j" (IoU > thresh and j > i) over K(K-1)/2 pairs a row, and
// the sweep over it, which is sequential in rank: whether i survives depends
// on every survivor above it. Two specialisations, chosen by K:
//
// K <= 256: one block of 2W warps a row (W = ceil(K / 64) mask words), so a
// vid_320 step's 496 rows of 200 put about 30 warps on each SM, enough to
// hide the latency of the IoU's division. Thread t loads column t; lane l
// of every warp then holds the boxes of columns l, l + 32, ... in
// registers. The rows go in chunks of 32, in rank order, each built by all
// warps and then swept by one:
// - build: the warps take the chunk's rows in turn; for each 32-column half
//   that holds a live candidate after row i, one ballot gives that half of
//   i's mask row;
// - sweep: lane r of warp 0 holds row 32c + r's mask, and the chunk's greedy
//   keep mask is the fixpoint of keep = live & ~(OR of the kept rows'
//   masks), found with __reduce_or_sync in as many rounds as the longest
//   chain of suppressions; the kept rows' masks then mark the columns they
//   suppress.
// Only what can change the keep mask is built: rows and columns up to
// n_valid (one past the last candidate with score > 0), and within that
// only candidates with score > 0 that no earlier chunk has suppressed (a
// suppressed candidate's row is never used and its bit never changes);
// where the intersection is 0 and thresh >= 0 the bit is 0 without a
// division (0 / max(union, 1e-12) = +0 is not above the threshold).
//
// 256 < K <= 1024: one block of kThreads a row, the relation built by all
// its threads over (i, word) tasks into shared memory, then one warp sweeps
// it, lane l holding word l of the removed set.
//
// Every IoU that is computed repeats the plain version's operations one for
// one; this file is compiled with -fmad=false so no product and sum fuse
// into an FMA, keeping the keep mask bit-equal to the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsMaxK = 256;  // the largest K of nms_rows_kernel (W <= 4)
constexpr int kThreads = 256;   // nms_block_kernel

__device__ __forceinline__ float box_area(float4 b) {
  return fmaxf(b.z - b.x, 0.f) * fmaxf(b.w - b.y, 0.f);
}

// Whether i (box a, area_a) suppresses j (box b, area_b): the plain
// version's IoU > thresh. skip_disjoint: thresh >= 0, so inter == 0 never is.
__device__ __forceinline__ bool suppresses(float4 a, float area_a, float4 b,
                                           float area_b, float iou_thresh,
                                           bool skip_disjoint) {
  const float ix = fmaxf(fminf(a.z, b.z) - fmaxf(a.x, b.x), 0.f);
  const float iy = fmaxf(fminf(a.w, b.w) - fmaxf(a.y, b.y), 0.f);
  const float inter = ix * iy;
  if (skip_disjoint && inter == 0.f) return false;
  const float uni = (area_a + area_b) - inter;
  return inter / fmaxf(uni, 1e-12f) > iou_thresh;
}

// One block of 2W warps a row, K <= 64 * W: thread t holds column t. At
// most 64 registers a thread (16 / W blocks an SM), so the 496 blocks of a
// step are all resident at once on the 132 SMs: one wave, no tail.
template <int W>
__global__ void __launch_bounds__(64 * W, 16 / W)
nms_rows_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
                float* __restrict__ out, int K, float iou_thresh) {
  constexpr int H = 2 * W;  // 32-column halves, one a warp
  __shared__ float4 s_box[64 * W];
  __shared__ uint32_t s_mask[64 * W * H];  // row i: halves i * H .. i * H + H - 1
  __shared__ uint32_t s_valid[H];          // bit l of half h: score of 32h + l > 0
  __shared__ uint32_t s_removed[H];        // bit l of half h: 32h + l suppressed
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const long row = blockIdx.x;

  float score = 0.f;
  float4 box = make_float4(0.f, 0.f, 0.f, 0.f);
  if (t < K) {
    box = reinterpret_cast<const float4*>(boxes)[row * K + t];
    score = scores[row * K + t];
  }
  s_box[t] = box;
  const uint32_t v = __ballot_sync(kFull, score > 0.f);
  if (lane == 0) {
    s_valid[warp] = v;
    s_removed[warp] = 0;
  }
  __syncthreads();

  // Lane l of every warp: column 32h + l of each half h, in registers.
  uint32_t valid[H];
  float4 cb[H];
  float carea[H];
  int n_valid = 0;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    valid[h] = s_valid[h];
    cb[h] = s_box[32 * h + lane];
    carea[h] = box_area(cb[h]);
    if (valid[h]) n_valid = 32 * h + 32 - __clz(valid[h]);
  }

  const bool skip_disjoint = iou_thresh >= 0.f;
  uint32_t removed[H];  // warp 0's copy of s_removed
#pragma unroll
  for (int h = 0; h < H; ++h) removed[h] = 0;
  // Chunk c: rows 32c .. 32c + 31. The loop is unrolled, so every index into
  // the per-half arrays is a constant and they stay in registers.
#pragma unroll
  for (int c = 0; c < H; ++c) {
    if (32 * c >= n_valid) break;
    // Candidates that are still alive: only their rows and columns are built.
    uint32_t live[H];
#pragma unroll
    for (int h = c; h < H; ++h) live[h] = valid[h] & ~s_removed[h];
    // Bit j of row i: i suppresses j > i. Lane h stores half h of the row.
    for (int r = warp; r < 32; r += H) {
      if (!((live[c] >> r) & 1u)) continue;  // warp-uniform
      const int i = 32 * c + r;
      const float4 a = s_box[i];
      const float area_a = box_area(a);
      uint32_t mine = 0;
#pragma unroll
      for (int h = c; h < H; ++h) {
        const uint32_t cand = h > c ? live[h] : r == 31 ? 0u : live[h] & (kFull << (r + 1));
        if (cand == 0) continue;  // warp-uniform
        const bool hit = suppresses(a, area_a, cb[h], carea[h], iou_thresh, skip_disjoint);
        const uint32_t bits = __ballot_sync(kFull, hit) & cand;
        if (lane == h) mine = bits;
      }
      if (lane >= c && lane < H) s_mask[i * H + lane] = mine;
    }
    __syncthreads();

    if (warp == 0) {
      // The greedy sweep of the chunk as a fixpoint, lane r holding row
      // 32c + r: keep = live & ~(the kept rows' masks on the chunk's own
      // half), iterated from keep = live. Its masks are strictly upper
      // triangular, so after n rounds the first n rows are final and the
      // fixpoint is the sequential sweep's result, in as many rounds as
      // the longest chain of suppressions, not 32 steps.
      const uint32_t init = live[c];
      const bool built = (init >> lane) & 1u;
      uint32_t mask[H];
#pragma unroll
      for (int h = c; h < H; ++h) mask[h] = built ? s_mask[(32 * c + lane) * H + h] : 0u;
      uint32_t keep = init;
      for (;;) {
        const uint32_t sup = __reduce_or_sync(kFull, (keep >> lane) & 1u ? mask[c] : 0u);
        const uint32_t next = init & ~sup;
        if (next == keep) break;  // warp-uniform
        keep = next;
      }
      const bool kept = (keep >> lane) & 1u;
#pragma unroll
      for (int h = c; h < H; ++h) removed[h] |= __reduce_or_sync(kFull, kept ? mask[h] : 0u);
      if (lane == 0) {
#pragma unroll
        for (int h = c; h < H; ++h) s_removed[h] = removed[h];
      }
    }
    __syncthreads();
  }

  if (t < K) {
    const bool gone = (s_removed[t >> 5] >> (t & 31)) & 1u;
    out[row * K + t] = score > 0.f && !gone ? score : 0.f;
  }
}

// One block a row, 256 < K <= 1024: the relation in shared memory, built
// over (i, word) tasks by all threads, then a one-warp sweep.
__global__ void nms_block_kernel(const float* __restrict__ boxes,
                                 const float* __restrict__ scores,
                                 float* __restrict__ out, int K,
                                 float iou_thresh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = (K + 63) / 64;
  float4* s_box = reinterpret_cast<float4*>(smem);                  // K
  float* s_area = reinterpret_cast<float*>(s_box + K);              // K
  float* s_score = s_area + K;                                      // K
  uint64_t* s_mask = reinterpret_cast<uint64_t*>(
      smem + ((size_t)K * 24 + 7) / 8 * 8);                         // K * W
  __shared__ uint64_t s_removed[16];

  const long row = blockIdx.x;
  const float4* rb = reinterpret_cast<const float4*>(boxes) + row * K;
  const float* rs = scores + row * K;
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    const float4 bx = rb[i];
    s_box[i] = bx;
    s_area[i] = box_area(bx);
    s_score[i] = rs[i];
  }
  __syncthreads();

  for (int t = threadIdx.x; t < K * W; t += blockDim.x) {
    const int i = t / W, w = t - i * W;
    const float4 a = s_box[i];
    const float area_a = s_area[i];
    uint64_t bits = 0;
    const int j0 = max(w * 64, i + 1), j1 = min(w * 64 + 64, K);
    for (int j = j0; j < j1; ++j)
      if (suppresses(a, area_a, s_box[j], s_area[j], iou_thresh, false))
        bits |= 1ull << (j - w * 64);
    s_mask[t] = bits;
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    uint64_t removed = 0;
    for (int i = 0; i < K; ++i) {
      const uint64_t word = __shfl_sync(kFull, removed, i >> 6);
      const bool alive = s_score[i] > 0.f && !((word >> (i & 63)) & 1ull);
      if (alive && lane < W) removed |= s_mask[i * W + lane];
    }
    if (lane < W) s_removed[lane] = removed;
  }
  __syncthreads();

  float* ro = out + row * K;
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    const float s = s_score[j];
    const bool keep = s > 0.f && !((s_removed[j >> 6] >> (j & 63)) & 1ull);
    ro[j] = keep ? s : 0.f;
  }
}

}  // namespace

extern "C" int tdrn_nms_suppress(const float* boxes, const float* scores,
                                 float* out, int N, int K, float iou_thresh,
                                 void* stream) {
  if (K < 1 || K > 1024 || N < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int W = (K + 63) / 64;
  if (K <= kRowsMaxK) {
    switch (W) {
      case 1: nms_rows_kernel<1><<<N, 64, 0, st>>>(boxes, scores, out, K, iou_thresh); break;
      case 2: nms_rows_kernel<2><<<N, 128, 0, st>>>(boxes, scores, out, K, iou_thresh); break;
      case 3: nms_rows_kernel<3><<<N, 192, 0, st>>>(boxes, scores, out, K, iou_thresh); break;
      default: nms_rows_kernel<4><<<N, 256, 0, st>>>(boxes, scores, out, K, iou_thresh); break;
    }
    return (int)cudaGetLastError();
  }
  const size_t smem = ((size_t)K * 24 + 7) / 8 * 8 + (size_t)K * W * 8;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nms_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nms_block_kernel<<<N, kThreads, smem, st>>>(boxes, scores, out, K, iou_thresh);
  return (int)cudaGetLastError();
}
