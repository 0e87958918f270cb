// K1: one whole inverse-compositional Lucas-Kanade Gauss-Newton level of
// the sparse direct image alignment of one frame, in one launch.
//
// Replaces sdslam_tpu/ops/pallas/align_kernel.py::align_level (body
// _level_kernel): the AL_HINV mode of the level kernel in sd_align.cuh
// (design and bound there), on one 8-CTA cluster of 512 threads per CTA,
// with the damped Hessian inverse Hinv cached by the caller. Any N: up to
// 3872 points every invariant is staged in shared memory; past that each
// CTA stages AL_STAGE_MAX points of its share and reads the rest from
// global memory. Outputs, 19 words: T [4,4], chi2, n_px and the GN
// iterations (int32).
#include "sd_align.cuh"

#define AL_THREADS 512

// 1 when a launch at these sizes stages the level image in shared memory,
// 0 when it reads the image through the read-only cache
extern "C" int sd_align_level_image_staged(int N, int H, int W) {
  bool stage_img;
  al_smem(N, H, W, &stage_img);
  return stage_img;
}

extern "C" int sd_align_level(const void* img, int H, int W, const void* X, const void* patch,
                              const void* J, const void* okpx, int N, const void* Hinv,
                              const void* T0, float fx, float fy, float cx, float cy, int iters,
                              void* out, void* stream) {
  return al_run<AL_HINV, AL_THREADS>(img, H, W, X, patch, J, okpx, 1, N, Hinv, T0, fx, fy, cx, cy,
                                     iters, out, stream);
}
