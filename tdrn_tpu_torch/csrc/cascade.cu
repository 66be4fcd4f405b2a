// K1: the ARM->ODM refinement cascade, one thread per (image, anchor), the
// block's class logits staged in shared memory.
//
// Replaces tdrn_tpu/ops/cascade_pallas.py::fused_refine_cascade (Pallas
// kernel _cascade_kernel). For each anchor: ARM decode of the prior into the
// refined anchor (center form), ODM decode against it into an xyxy box, the
// max-subtracted softmax over the C classes, and the 2-way ARM softmax that
// silences the anchor where its background probability is above the
// threshold; class 0 is zeroed. Scores are written class-major (B, C, P), the
// layout the per-class NMS sorts. Optionally it also writes each anchor's max
// over the C scores it stored (background row included): the prefilter's
// per-anchor score, bit-equal to scores_cm.amax(dim=1), so the prefilter
// needs no second pass over scores_cm.
//
// Bound on the H100: memory. Per anchor it reads 41 floats of predictions and
// writes 35 (36 with the per-anchor max), with a few dozen flops, far below
// the card's ratio of flops to bytes. Design, so that each byte moves once:
// - A block takes kThreads anchors of one image. Their logits are one
//   contiguous span of the (B, P, C) tensor, which the block copies into
//   shared memory with coalesced 16-byte cp.async (the span is only 4-byte
//   aligned in general: the copy starts at the aligned-down address and the
//   ragged ends go by scalar loads). A thread then reads its own row there,
//   at a stride of C words, free of bank conflicts for the odd C of every
//   served configuration.
// - One pass of expf a class (expf, not __expf, for the plain version's
//   accuracy): the exponentials replace the logits in the thread's row.
// - The boxes go out as float4 and each class row of scores as a coalesced
//   run of kThreads floats.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // anchors a block

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Shared floats a block needs: the logits of kThreads anchors, and up to 3
// floats before them from the aligned-down start.
constexpr size_t smem_bytes(int C) { return ((size_t)kThreads * C + 4) * sizeof(float); }

__global__ void __launch_bounds__(kThreads) cascade_kernel(
    const float* __restrict__ arm_loc, const float* __restrict__ arm_conf,
    const float* __restrict__ odm_loc, const float* __restrict__ odm_conf,
    const float* __restrict__ priors, float* __restrict__ boxes,
    float* __restrict__ scores_cm, float* __restrict__ per_anchor, int P, int C,
    float v0, float v1, float arm_thresh) {
  extern __shared__ __align__(16) float s_conf[];
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kThreads;
  const int len = min(kThreads, P - p0) * C;  // logits of this tile
  const float* src = odm_conf + ((long)b * P + p0) * C;

  // Stage the tile: element x of the span goes to s_conf[lead + x], where
  // lead is src's offset in floats from its 16-byte chunk, so global and
  // shared chunks line up for cp.async.
  const int lead = (int)((reinterpret_cast<uintptr_t>(src) & 15) >> 2);
  const float* g = src - lead;  // 16-byte aligned
  const int end = lead + len;
  for (int x = 4 * threadIdx.x; x < end; x += 4 * kThreads) {
    if (x >= lead && x + 4 <= end) {
      cp_async16(s_conf + x, g + x);
    } else {  // a ragged end: only the floats of the span
      for (int e = max(x, lead); e < min(x + 4, end); ++e) s_conf[e] = g[e];
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int p = p0 + threadIdx.x;
  if (p >= P) return;
  const long bp = (long)b * P + p;

  const float4 pr = reinterpret_cast<const float4*>(priors)[p];
  const float4 al = reinterpret_cast<const float4*>(arm_loc)[bp];
  const float4 ol = reinterpret_cast<const float4*>(odm_loc)[bp];
  // Refined anchor, directly in center form.
  const float acx = pr.x + al.x * v0 * pr.z;
  const float acy = pr.y + al.y * v0 * pr.w;
  const float aw = pr.z * expf(al.z * v1);
  const float ah = pr.w * expf(al.w * v1);
  const float cx = acx + ol.x * v0 * aw;
  const float cy = acy + ol.y * v0 * ah;
  const float w = aw * expf(ol.z * v1);
  const float h = ah * expf(ol.w * v1);
  reinterpret_cast<float4*>(boxes)[bp] =
      make_float4(cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2);

  const float a0 = arm_conf[2 * bp], a1 = arm_conf[2 * bp + 1];
  const float mb = fmaxf(a0, a1);
  const float e0 = expf(a0 - mb), e1 = expf(a1 - mb);
  const float bg = e0 / (e0 + e1);
  const bool anchor_kept = bg <= arm_thresh;

  float* row = s_conf + lead + threadIdx.x * C;
  float m = row[0];
  for (int c = 1; c < C; ++c) m = fmaxf(m, row[c]);
  float s = 0.f;
  for (int c = 0; c < C; ++c) {
    const float e = expf(row[c] - m);
    row[c] = e;
    s += e;
  }
  float* out = scores_cm + (long)b * C * P + p;
  out[0] = 0.f;  // background row
  float top = 0.f;  // NaN propagates, as in amax
  for (int c = 1; c < C; ++c) {
    const float v = anchor_kept ? row[c] / s : 0.f;
    out[(long)c * P] = v;
    top = (v > top || v != v) ? v : top;
  }
  if (per_anchor != nullptr) per_anchor[bp] = top;
}

}  // namespace

extern "C" int tdrn_cascade(const float* arm_loc, const float* arm_conf,
                            const float* odm_loc, const float* odm_conf,
                            const float* priors, float* boxes, float* scores_cm,
                            float* per_anchor, int B, int P, int C, float v0,
                            float v1, float arm_thresh, void* stream) {
  if (B < 1 || P < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(C);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cascade_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((P + kThreads - 1) / kThreads, B);
  cascade_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      arm_loc, arm_conf, odm_loc, odm_conf, priors, boxes, scores_cm,
      per_anchor, P, C, v0, v1, arm_thresh);
  return (int)cudaGetLastError();
}
