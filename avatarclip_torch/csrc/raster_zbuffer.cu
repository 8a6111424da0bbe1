// Tiled hard z-buffer winner selection for Hopper (sm_90a).
//
// Replaces the Pallas kernel avatarclip_tpu/ops/raster_zbuffer.py
// `_zbuffer_kernel_tiled` (:266), launched by `zbuffer_select_tiled` (:304)
// with the winner rule of `_select_update` (:66) and the culling table of
// `overlap_table` (:205).
//
// For every pixel of an (H, W) image: the face whose three oriented
// barycentric edge values are all >= 0, whose screen-linear inverse depth iz
// is > 0 and which is valid, maximising (iz, face id) lexicographically in
// exact f32 (ties to the higher face id); -1 where no face covers the pixel.
//
// What bounds it on this card: the pair count (pixels x faces of the kept
// tile / face-block pairs), 4 K=3 dot products each, in f32 FMA-free
// arithmetic (no tensor cores: K = 3, and TF32 would break the inside test
// of thin faces). Design: one CTA per 32 x 32 screen tile, one thread per
// pixel; the CTA walks the face blocks the overlap table keeps for its tile,
// stages each block's coefficients and valid flags in shared memory (24 KB),
// and every thread keeps its running (iz, id) winner in registers. Faces are
// visited in increasing id order, so ">=" on iz implements the tie-break.
// Each edge value is evaluated as (px * c0 + py * c1) + c2 with separately
// rounded products and sums (__fmul_rn / __fadd_rn: no FMA contraction), the
// same order the plain PyTorch version uses, so the two agree bit for bit.
// At 256^2 there are 64 tiles for 132 SMs: the card is under-filled (later
// work: split face blocks across CTAs and merge).
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int FBLOCK = 512;

__device__ __forceinline__ float lin(float px, float py, float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(px, a), __fmul_rn(py, b)), c);
}

__global__ void __launch_bounds__(TILE * TILE) zbuffer_tiled_kernel(
    const float* __restrict__ coef,  // (n_fb * FBLOCK, 3, 4): [pixel term k][b0, b1, b2, iz]
    const int* __restrict__ valid,   // (n_fb * FBLOCK,)
    const int* __restrict__ tab,     // (n_tiles * n_fb,)
    int* __restrict__ face_id,       // (H * W,) row-major
    int H, int W, int n_tx, int n_fb) {
  __shared__ float s_coef[FBLOCK * 12];
  __shared__ int s_valid[FBLOCK];
  const int tile = blockIdx.x;
  const int ty = tile / n_tx, tx = tile % n_tx;
  const int py = ty * TILE + threadIdx.x / TILE;
  const int px = tx * TILE + threadIdx.x % TILE;
  const float fx = (float)px, fy = (float)py;
  float best_iz = -1.f;
  int best = -1;
  for (int j = 0; j < n_fb; ++j) {
    if (tab[tile * n_fb + j] == 0) continue;  // uniform across the CTA
    __syncthreads();
    const float* src = coef + (size_t)j * FBLOCK * 12;
    for (int e = threadIdx.x; e < FBLOCK * 12; e += blockDim.x) s_coef[e] = src[e];
    for (int e = threadIdx.x; e < FBLOCK; e += blockDim.x) s_valid[e] = valid[j * FBLOCK + e];
    __syncthreads();
    for (int f = 0; f < FBLOCK; ++f) {
      if (!s_valid[f]) continue;
      const float* c = s_coef + f * 12;
      const float b0 = lin(fx, fy, c[0], c[4], c[8]);
      const float b1 = lin(fx, fy, c[1], c[5], c[9]);
      const float b2 = lin(fx, fy, c[2], c[6], c[10]);
      const float iz = lin(fx, fy, c[3], c[7], c[11]);
      if (b0 >= 0.f && b1 >= 0.f && b2 >= 0.f && iz > 0.f && iz >= best_iz) {
        best_iz = iz;
        best = j * FBLOCK + f;
      }
    }
  }
  if (py < H && px < W) face_id[py * W + px] = best;
}

}  // namespace

extern "C" int zbuffer_tiled(const float* coef, const int* valid, const int* tab, int* face_id,
                             int H, int W, int n_tx, int n_ty, int n_fb, void* stream) {
  zbuffer_tiled_kernel<<<n_tx * n_ty, TILE * TILE, 0, (cudaStream_t)stream>>>(coef, valid, tab, face_id, H, W, n_tx, n_fb);
  return (int)cudaGetLastError();
}
