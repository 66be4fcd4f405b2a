// K2: greedy NMS suppression over score-sorted candidates, one block per row.
//
// Replaces tdrn_tpu/ops/nms_pallas.py::suppress_sorted (Pallas kernel
// _suppress_kernel). A row is one (image, class) list of K candidates sorted
// by descending score. Candidate j is suppressed when its IoU with a
// higher-ranked surviving candidate i is above the threshold; slots with
// score 0 are empty. Output: the scores with suppressed and empty slots zeroed.
//
// Bound on the H100: not the bytes (a row moves 24*K bytes) but the sweep,
// which is sequential in rank: whether i survives depends on every survivor
// above it. Design: the block's threads first build the whole relation
// "i suppresses j" (IoU > thresh and j > i) as bitmask rows in shared memory,
// ceil(K/64) 64-bit words per row, in parallel over (i, word). One warp then
// runs the sweep: lane l holds word l of the "removed" set, candidate i's bit
// is read with one shuffle, and a surviving i ORs its mask row in, so each of
// the K steps costs a shuffle and one shared-memory load. The IoU repeats the
// plain version's operations one for one; this file is compiled with
// -fmad=false so no product and sum fuse into an FMA, keeping the keep mask
// bit-equal to the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void nms_suppress_kernel(const float* __restrict__ boxes,
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
    s_area[i] = fmaxf(bx.z - bx.x, 0.f) * fmaxf(bx.w - bx.y, 0.f);
    s_score[i] = rs[i];
  }
  __syncthreads();

  for (int t = threadIdx.x; t < K * W; t += blockDim.x) {
    const int i = t / W, w = t - i * W;
    const float4 a = s_box[i];
    const float area_a = s_area[i];
    uint64_t bits = 0;
    const int j0 = max(w * 64, i + 1), j1 = min(w * 64 + 64, K);
    for (int j = j0; j < j1; ++j) {
      const float4 b = s_box[j];
      const float ix = fmaxf(fminf(a.z, b.z) - fmaxf(a.x, b.x), 0.f);
      const float iy = fmaxf(fminf(a.w, b.w) - fmaxf(a.y, b.y), 0.f);
      const float inter = ix * iy;
      const float uni = (area_a + s_area[j]) - inter;
      const float iou = inter / fmaxf(uni, 1e-12f);
      if (iou > iou_thresh) bits |= 1ull << (j - w * 64);
    }
    s_mask[t] = bits;
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    uint64_t removed = 0;
    for (int i = 0; i < K; ++i) {
      const uint64_t word = __shfl_sync(0xffffffffu, removed, i >> 6);
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
  if (K < 1 || K > 1024) return (int)cudaErrorInvalidValue;
  const int W = (K + 63) / 64;
  const size_t smem = ((size_t)K * 24 + 7) / 8 * 8 + (size_t)K * W * 8;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nms_suppress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nms_suppress_kernel<<<N, kThreads, smem, (cudaStream_t)stream>>>(
      boxes, scores, out, K, iou_thresh);
  return (int)cudaGetLastError();
}
