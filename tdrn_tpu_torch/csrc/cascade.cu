// K1: the ARM->ODM refinement cascade, one thread per (image, anchor).
//
// Replaces tdrn_tpu/ops/cascade_pallas.py::fused_refine_cascade (Pallas
// kernel _cascade_kernel). For each anchor: ARM decode of the prior into the
// refined anchor (center form), ODM decode against it into an xyxy box, the
// max-subtracted softmax over the C classes, and the 2-way ARM softmax that
// silences the anchor where its background probability is above the
// threshold; class 0 is zeroed. Scores are written class-major (B, C, P), the
// layout the per-class NMS sorts.
//
// Bound on the H100: memory. Per anchor it reads 41 floats of predictions and
// writes 35, with a few dozen flops, far below the card's ratio of flops to
// bytes. Design: the four prediction tensors are read in place in the (B, P, .)
// layout the heads emit, so no transpose pass runs before the kernel; each
// thread re-reads its own C logits from L1 for the three softmax passes rather
// than holding them in registers; the class-major stores coalesce across the
// neighbouring anchors of a warp. expf (not __expf) keeps the plain version's
// accuracy.

#include <cuda_runtime.h>

namespace {

__global__ void cascade_kernel(
    const float* __restrict__ arm_loc, const float* __restrict__ arm_conf,
    const float* __restrict__ odm_loc, const float* __restrict__ odm_conf,
    const float* __restrict__ priors, float* __restrict__ boxes,
    float* __restrict__ scores_cm, int P, int C, float v0, float v1,
    float arm_thresh) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
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

  const float* oc = odm_conf + bp * C;
  float m = oc[0];
  for (int c = 1; c < C; ++c) m = fmaxf(m, oc[c]);
  float s = 0.f;
  for (int c = 0; c < C; ++c) s += expf(oc[c] - m);
  float* out = scores_cm + (long)b * C * P + p;
  out[0] = 0.f;  // background row
  for (int c = 1; c < C; ++c)
    out[(long)c * P] = anchor_kept ? expf(oc[c] - m) / s : 0.f;
}

}  // namespace

extern "C" int tdrn_cascade(const float* arm_loc, const float* arm_conf,
                            const float* odm_loc, const float* odm_conf,
                            const float* priors, float* boxes, float* scores_cm,
                            int B, int P, int C, float v0, float v1,
                            float arm_thresh, void* stream) {
  const int threads = 256;
  dim3 grid((P + threads - 1) / threads, B);
  cascade_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      arm_loc, arm_conf, odm_loc, odm_conf, priors, boxes, scores_cm, P, C, v0,
      v1, arm_thresh);
  return (int)cudaGetLastError();
}
