// K5: the photometric Gauss-Newton pass of B alignment lanes against one
// shared level image, as a whole GN level per launch.
//
// Replaces sdslam_tpu/ops/pallas/align_kernel.py::accumulate_gn (body
// _kernel), the per-iteration step of the non-fused aligner that
// sdslam_tpu/solvers/image_align.py:_align_level vmaps over the keyframe
// pool (relocalization, loop detection). The TPU kernel is one evaluation
// per launch, and the loop around it (transform, 6x6 solve, exponential,
// masked updates) costs more than the evaluation itself; here one launch
// runs the whole level for every lane (sd_align.cuh: design and bound):
//   sd_align_batched   the AL_CHOL mode: per lane a cluster of 8 CTAs
//                      stages the lane's invariants once, runs the lane's
//                      GN iterations with its own T, best T, best chi2 and
//                      stop flag, solves each step with the lane's damped
//                      Cholesky factor L, makes the final evaluation and
//                      rolls back, and writes T [B,4,4], chi2 [B], n_px [B]
//                      and the GN iterations [B] finished.
//   sd_accumulate_gn   the TPU kernel's own contract, the AL_TERMS mode:
//                      zero iterations at T = I on points already in the
//                      current camera (se3_apply with the identity is exact
//                      in float32); the final evaluation writes b [B,6],
//                      chi2_sum [B] and n [B].
// Threads per CTA: ALB_THREADS = 256, two CTAs per SM at N = 1024 (twice
// the clusters resident of 512 threads per CTA, and faster per level).
#include "sd_align.cuh"

#define ALB_THREADS 256

extern "C" int sd_align_batched(const void* img, int H, int W, const void* X, const void* patch,
                                const void* J, const void* okpx, int B, int N, const void* L,
                                const void* T0, float fx, float fy, float cx, float cy, int iters,
                                void* out, void* stream) {
  return al_run<AL_CHOL, ALB_THREADS>(img, H, W, X, patch, J, okpx, B, N, L, T0, fx, fy, cx, cy,
                                      iters, out, stream);
}

extern "C" int sd_accumulate_gn(const void* img, int H, int W, const void* Xc, const void* patch,
                                const void* J, const void* okpx, int B, int N, float fx, float fy,
                                float cx, float cy, void* out, void* stream) {
  return al_run<AL_TERMS, ALB_THREADS>(img, H, W, Xc, patch, J, okpx, B, N, nullptr, nullptr, fx,
                                       fy, cx, cy, 0, out, stream);
}

// clusters of sd_align_batched the card holds at once at these sizes, or
// minus the CUDA error
extern "C" int sd_align_batched_max_clusters(int N, int H, int W) {
  return al_max_clusters<AL_CHOL, ALB_THREADS>(N, H, W);
}
