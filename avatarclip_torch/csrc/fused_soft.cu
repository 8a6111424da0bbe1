// SoftRas aggregation pair for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas kernels avatarclip_tpu/ops/fused_soft.py
// `_fwd_kernel` (:106) and `_bwd_kernel` (:132), the custom VJP that
// `soft_aggregate` (:321) builds around them, with the (tile, face-block)
// culling table of `_overlap_table_halfplane` (:408).
//
// Per view b and pixel p = (px, py), over the faces f of its packed rows
// [cs0 (3), cs1 (3), cs2 (3), ezf, colf (3), vmask, 0, 0]:
//   v_e = (px * a_e + py * b_e) + c_e,  d = min(min(v0, v1), v2),  x = d / sigma
//   sil_log += -softplus(x),  w = sigmoid(x) * ezf,  num += w * colf,  den += w
// for the valid faces (vmask != 0); and the VJP of that w.r.t. every face's
// cs, ezf and colf, min-over-edges ties splitting the gradient equally.
//
// What bounds it on this card: arithmetic, not bytes. Each kept (pixel,
// face) pair costs ~16 f32 operations for the three edge distances and, where
// the sigmoid is not exactly zero in f32, ~14 more plus three special-function
// operations (exp, reciprocal, log1p's log) in the forward, and ~34 plus two
// (exp, reciprocal) in the backward; the faces (64 B each) and the pixels
// (20 B each) are read a few times over. On the pose optimizer's 224^2 views
// of a 13,776-face body the culling table keeps ~95% of the pairs (the
// min-over-edge-lines distance stays within reach of sigma far beyond thin
// faces), so the design is for the dense case:
//  * forward: one CTA per (screen tile of 32 x 32, view), 256 threads with
//    4 pixels each (a warp is one row of 32 pixels); the CTA walks the face
//    blocks the table keeps, stages 256 faces at a time in shared memory
//    (16 KB, read as broadcasts), and accumulates sil_log, num and den in
//    registers; each pixel is written once, no atomics;
//  * backward: one CTA per (128 faces, view), one face per thread, so the
//    13 gradient sums of a face live in one thread's registers and are
//    written once (deterministic, no atomics; 4 sub-blocks per 512-face block
//    give 560 CTAs at 5 views x 14,336 faces, ~4 per SM); the CTA walks the
//    tiles the table keeps for its block and stages each tile's 1,024 pixel
//    cotangents (dsil, dnum, dden; 20 KB) in shared memory;
//  * both skip a face whose vmask is 0 (uniform across the CTA) and a pair
//    with x <= -110, where exp(x) is exactly 0 in f32 so that every term of
//    the pair is exactly 0: the result is that of the dense loop.
// The depth weights saturate at ezf = e^60 for nearly every face, so den
// reaches ~1e30 and the backward's cotangents ~1e-30: the product is formed
// in the JAX order dw * ezf * s * (1 - s), with IEEE division and no flush
// to zero (no fast math). The edge distances use separately rounded products
// and sums (__fmul_rn / __fadd_rn), the order of the plain PyTorch version,
// so ties of the min fall on the same pairs in both.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int TPIX = TILE * TILE;
constexpr int FBLOCK = 512;
constexpr int NF = 16;
constexpr int FWD_THREADS = 256;
constexpr int FWD_PPT = TPIX / FWD_THREADS;  // pixels per thread
constexpr int FWD_ROWS = FWD_THREADS / TILE;  // row stride between a thread's pixels
constexpr int FWD_STAGE = 256;  // faces per shared-memory stage
constexpr int BWD_FACES = 128;
constexpr float X_DEAD = -110.f;

__device__ __forceinline__ float lin(float px, float py, float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(px, a), __fmul_rn(py, b)), c);
}

__global__ void __launch_bounds__(FWD_THREADS) soft_fwd_kernel(
    const float4* __restrict__ faces,  // (B, Fp, NF) as float4
    const int* __restrict__ tab,       // (B, n_tiles, n_fb)
    float* __restrict__ sil_log,       // (B, H * W)
    float* __restrict__ num,           // (B, H * W, 3)
    float* __restrict__ den,           // (B, H * W)
    int H, int W, int n_tx, int n_tiles, int n_fb, float inv_sigma) {
  __shared__ float4 s_face[FWD_STAGE * NF / 4];
  const int tile = blockIdx.x, b = blockIdx.y;
  const int ty = tile / n_tx, tx = tile % n_tx;
  const int px = tx * TILE + threadIdx.x % TILE;
  const int py0 = ty * TILE + threadIdx.x / TILE;
  const float fx = (float)px;
  float fy[FWD_PPT], a_sil[FWD_PPT], a_r[FWD_PPT], a_g[FWD_PPT], a_b[FWD_PPT], a_den[FWD_PPT];
#pragma unroll
  for (int k = 0; k < FWD_PPT; ++k) {
    fy[k] = (float)(py0 + k * FWD_ROWS);
    a_sil[k] = a_r[k] = a_g[k] = a_b[k] = a_den[k] = 0.f;
  }
  const size_t Fp = (size_t)n_fb * FBLOCK;
  const float4* fv = faces + (size_t)b * Fp * (NF / 4);
  const int* tb = tab + ((size_t)b * n_tiles + tile) * n_fb;
  for (int j = 0; j < n_fb; ++j) {
    if (tb[j] == 0) continue;  // uniform across the CTA
    for (int s0 = 0; s0 < FBLOCK; s0 += FWD_STAGE) {
      __syncthreads();
      const float4* src = fv + ((size_t)j * FBLOCK + s0) * (NF / 4);
      for (int e = threadIdx.x; e < FWD_STAGE * NF / 4; e += FWD_THREADS) s_face[e] = src[e];
      __syncthreads();
      for (int f = 0; f < FWD_STAGE; ++f) {
        const float4 q3 = s_face[f * 4 + 3];  // b of colf, vmask, 0, 0
        if (q3.y == 0.f) continue;  // invalid or padding: exact zeros (uniform)
        const float4 q0 = s_face[f * 4], q1 = s_face[f * 4 + 1], q2 = s_face[f * 4 + 2];
#pragma unroll
        for (int k = 0; k < FWD_PPT; ++k) {
          const float v0 = lin(fx, fy[k], q0.x, q0.y, q0.z);
          const float v1 = lin(fx, fy[k], q0.w, q1.x, q1.y);
          const float v2 = lin(fx, fy[k], q1.z, q1.w, q2.x);
          const float x = fminf(fminf(v0, v1), v2) * inv_sigma;
          if (x > X_DEAD) {
            const float e = expf(-fabsf(x));
            const float r = 1.f / (1.f + e);
            const float s = x >= 0.f ? r : e * r;  // sigmoid(x), stable
            a_sil[k] -= fmaxf(x, 0.f) + log1pf(e);  // softplus(x), stable
            const float w = s * q2.y;
            a_r[k] += w * q2.z;
            a_g[k] += w * q2.w;
            a_b[k] += w * q3.x;
            a_den[k] += w;
          }
        }
      }
    }
  }
  if (px >= W) return;
#pragma unroll
  for (int k = 0; k < FWD_PPT; ++k) {
    const int py = py0 + k * FWD_ROWS;
    if (py >= H) continue;
    const size_t p = (size_t)b * H * W + (size_t)py * W + px;
    sil_log[p] = a_sil[k];
    num[3 * p] = a_r[k];
    num[3 * p + 1] = a_g[k];
    num[3 * p + 2] = a_b[k];
    den[p] = a_den[k];
  }
}

__global__ void __launch_bounds__(BWD_FACES) soft_bwd_kernel(
    const float4* __restrict__ faces,  // (B, Fp, NF) as float4
    const int* __restrict__ tab,       // (B, n_tiles, n_fb)
    const float* __restrict__ dsil,    // (B, H * W)
    const float* __restrict__ dnum,    // (B, H * W, 3)
    const float* __restrict__ dden,    // (B, H * W)
    float4* __restrict__ dfaces,       // (B, Fp, NF) as float4
    int H, int W, int n_tx, int n_tiles, int n_fb, float inv_sigma) {
  __shared__ float4 s_cot[TPIX];  // dsil, dnum r, g, b
  __shared__ float s_dden[TPIX];
  const int b = blockIdx.y;
  const size_t Fp = (size_t)n_fb * FBLOCK;
  const size_t f = (size_t)blockIdx.x * BWD_FACES + threadIdx.x;
  const int j = (int)(((size_t)blockIdx.x * BWD_FACES) / FBLOCK);
  const float4* q = faces + ((size_t)b * Fp + f) * (NF / 4);
  const float4 q0 = q[0], q1 = q[1], q2 = q[2], q3 = q[3];
  const bool live = q3.y != 0.f;
  const float ezf = q2.y, cr = q2.z, cg = q2.w, cb = q3.x;
  float g[13];
#pragma unroll
  for (int i = 0; i < 13; ++i) g[i] = 0.f;
  const size_t HW = (size_t)H * W;
  for (int t = 0; t < n_tiles; ++t) {
    if (tab[((size_t)b * n_tiles + t) * n_fb + j] == 0) continue;  // uniform
    const int ty = t / n_tx, tx = t % n_tx;
    const int h = min(TILE, H - ty * TILE), w = min(TILE, W - tx * TILE);
    __syncthreads();
    for (int e = threadIdx.x; e < TPIX; e += BWD_FACES) {
      const int r = e / TILE, c = e % TILE;
      float4 cv = make_float4(0.f, 0.f, 0.f, 0.f);
      float dd = 0.f;
      if (r < h && c < w) {
        const size_t p = b * HW + (size_t)(ty * TILE + r) * W + tx * TILE + c;
        cv = make_float4(dsil[p], dnum[3 * p], dnum[3 * p + 1], dnum[3 * p + 2]);
        dd = dden[p];
      }
      s_cot[e] = cv;
      s_dden[e] = dd;
    }
    __syncthreads();
    if (!live) continue;
    for (int r = 0; r < h; ++r) {
      const float fy = (float)(ty * TILE + r);
      for (int c = 0; c < w; ++c) {
        const float fx = (float)(tx * TILE + c);
        const float v0 = lin(fx, fy, q0.x, q0.y, q0.z);
        const float v1 = lin(fx, fy, q0.w, q1.x, q1.y);
        const float v2 = lin(fx, fy, q1.z, q1.w, q2.x);
        const float d = fminf(fminf(v0, v1), v2);
        const float x = d * inv_sigma;
        if (x <= X_DEAD) continue;
        const float e = expf(-fabsf(x));
        const float rr = 1.f / (1.f + e);
        const float s = x >= 0.f ? rr : e * rr;
        const float4 cv = s_cot[r * TILE + c];
        // num += w colf, den += w: dw = dnum . colf + dden
        const float dw = (cv.y * cr + cv.z * cg + cv.w * cb) + s_dden[r * TILE + c];
        // sil_log -= softplus(x): d/dd = -sigmoid(x) / sigma
        float dd = (dw * ezf * s * (1.f - s) + cv.x * (-s)) * inv_sigma;
        const bool m0 = v0 == d, m1 = v1 == d, m2 = v2 == d;
        const int n_tie = (int)m0 + (int)m1 + (int)m2;
        if (n_tie > 1) dd = dd / (float)n_tie;
        if (m0) { g[0] += fx * dd; g[1] += fy * dd; g[2] += dd; }
        if (m1) { g[3] += fx * dd; g[4] += fy * dd; g[5] += dd; }
        if (m2) { g[6] += fx * dd; g[7] += fy * dd; g[8] += dd; }
        g[9] += dw * s;  // w = s * ezf
        const float wv = s * ezf;
        g[10] += wv * cv.y;
        g[11] += wv * cv.z;
        g[12] += wv * cv.w;
      }
    }
  }
  float4* out = dfaces + ((size_t)b * Fp + f) * (NF / 4);
  out[0] = make_float4(g[0], g[1], g[2], g[3]);
  out[1] = make_float4(g[4], g[5], g[6], g[7]);
  out[2] = make_float4(g[8], g[9], g[10], g[11]);
  out[3] = make_float4(g[12], 0.f, 0.f, 0.f);
}

}  // namespace

extern "C" int soft_fwd(const float* faces, const int* tab, float* sil_log, float* num,
                        float* den, int B, int H, int W, int n_tx, int n_ty, int n_fb,
                        float inv_sigma, void* stream) {
  const dim3 grid(n_tx * n_ty, B);
  soft_fwd_kernel<<<grid, FWD_THREADS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(faces), tab, sil_log, num, den, H, W, n_tx, n_tx * n_ty,
      n_fb, inv_sigma);
  return (int)cudaGetLastError();
}

extern "C" int soft_bwd(const float* faces, const int* tab, const float* dsil,
                        const float* dnum, const float* dden, float* dfaces, int B, int H,
                        int W, int n_tx, int n_ty, int n_fb, float inv_sigma, void* stream) {
  const dim3 grid(n_fb * (FBLOCK / BWD_FACES), B);
  soft_bwd_kernel<<<grid, BWD_FACES, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(faces), tab, dsil, dnum, dden,
      reinterpret_cast<float4*>(dfaces), H, W, n_tx, n_tx * n_ty, n_fb, inv_sigma);
  return (int)cudaGetLastError();
}
