// Standalone SDF kernels for Hopper (sm_90a): the sdf+gradient pair (B6) and
// the sdf-only forward (B8's #12).
//
// Replaces the Pallas kernels avatarclip_tpu/ops/fused_sdf.py `_fwd_kernel`
// (:261) and `_bwd_kernel` (:403), launched by `_run_fwd` / `_run_bwd` under
// the custom VJP `_fused_core` (entry `sdf_with_gradient_fused`). Per point:
// the positional encoding, the SDF MLP (hidden softplus(100 z)/100 linears,
// the skip-producing layer, the [a, e] / sqrt(2) head) and the analytic
// spatial gradient of the sdf; out go sdf (P, 1), the geometry feature
// (P, F) and the gradient (P, 3). The backward takes cotangents on all three
// (the gradient's carries the eikonal term and the colour net's normal
// input, summed by autograd) and returns d(points) and every dense weight
// gradient by forward-over-reverse: the gradient cotangent is a tangent
// direction through the stack, so softplus'' = 100 p (1 - p) appears on the
// tangent path. The renderer runs it when the megakernel is declined: with
// the NeRF++ background on (render/neus.py).
//
// What bounds it on this card: f32 FMA throughput of the per-block GEMMs
// (64 rows x 256 wide; 918,016 FLOPs a point forward and 2,754,048 backward
// at 4 x 256), far above the bytes (about 1 KB a point, the feature). No
// tensor cores yet (f32 throughout, as B1 / B3).
//
// Design: B3's SDF half (neus_ray.cuh) with the points read from memory: a
// block of up to MAXS = 64 points is one GEMM row block, a ragged last block
// runs with fewer rows (no padding copy), per-layer states live in the CTA's
// slice of a global workspace, CTAs grid-stride over blocks. Weight
// gradients go to per-CTA partials and a fixed-order second pass:
// deterministic, no atomics (the TPU kernel accumulated into revisited
// blocks of a sequential grid, which CTAs running in parallel cannot).
//
// The sdf-only forward replaces avatarclip_tpu/ops/fused_sdf.py
// `_sdf_only_kernel` (:626, under `_sdf_only_core` :682, entry
// `sdf_value_fused` :731): per point the encoding, the hidden stack and the
// skip-producing layer and the head's sdf row alone, / scale; no feature, no
// gradient. It serves the sdf-only queries (the NeuS up-sample sweeps and the
// marching-cubes grid) behind fields/networks.py's `_SWEEP_KERNEL` hook. What
// bounds it: f32 FMA throughput of the stack (393,728 FLOPs a point at 4 x
// 256) against 16 bytes a point. Design: B6's forward with sdf_stack's
// value_only mode (no embedding derivatives, the 1-column head GEMM) and no
// reverse sweep; a ragged last block runs with fewer rows, nothing padded.
// No backward kernel: the TPU package differentiates its plain version
// (`_sdf_only_bwd`), and so does the port's autograd Function.
#include "neus_ray.cuh"

using namespace neus;

namespace {

__global__ void __launch_bounds__(NT) sdf_fwd_kernel(
    Dims d, const float* __restrict__ wts, const float* __restrict__ pts, int P,
    float* __restrict__ sdf_out, float* __restrict__ feat_out, float* __restrict__ g_out,
    float* __restrict__ ws_all, long long ws_stride) {
  __shared__ GemmSmem sm;
  const WeightOffsets wo = weight_offsets(d);
  const Workspace L = workspace_layout(d, false);
  float* ws = ws_all + (size_t)blockIdx.x * ws_stride;
  const int F1 = 1 + d.F, tid = threadIdx.x;
  const int n_blk = (P + MAXS - 1) / MAXS;
  for (int blk = blockIdx.x; blk < n_blk; blk += gridDim.x) {
    const size_t row0 = (size_t)blk * MAXS;
    Dims db = d;
    db.S = min(MAXS, P - (int)row0);
    const int S = db.S;
    for (int e = tid; e < S * 3; e += NT) ws[L.pts + e] = pts[row0 * 3 + e];
    __syncthreads();
    sdf_stack(sm, db, wts, wo, ws, L);
    sdf_gradient(sm, db, wts, wo, ws, L);
    for (int e = tid; e < S * F1; e += NT) {
      const int r = e / F1, j = e % F1;
      const float v = ws[L.out + e];
      if (j == 0) sdf_out[row0 + r] = v / d.scale;
      else feat_out[(row0 + r) * d.F + (j - 1)] = v;
    }
    for (int e = tid; e < S * 3; e += NT) g_out[row0 * 3 + e] = ws[L.g + e];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT) sdf_only_kernel(
    Dims d, const float* __restrict__ wts, const float* __restrict__ pts, int P,
    float* __restrict__ sdf_out, float* __restrict__ ws_all, long long ws_stride) {
  __shared__ GemmSmem sm;
  const WeightOffsets wo = weight_offsets(d);
  const Workspace L = workspace_layout(d, false);
  float* ws = ws_all + (size_t)blockIdx.x * ws_stride;
  const int F1 = 1 + d.F, tid = threadIdx.x;
  const int n_blk = (P + MAXS - 1) / MAXS;
  for (int blk = blockIdx.x; blk < n_blk; blk += gridDim.x) {
    const size_t row0 = (size_t)blk * MAXS;
    Dims db = d;
    db.S = min(MAXS, P - (int)row0);
    const int S = db.S;
    for (int e = tid; e < S * 3; e += NT) ws[L.pts + e] = pts[row0 * 3 + e];
    __syncthreads();
    sdf_stack(sm, db, wts, wo, ws, L, true);
    for (int r = tid; r < S; r += NT) sdf_out[row0 + r] = ws[L.out + r * F1] / d.scale;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT) sdf_bwd_kernel(
    Dims d, const float* __restrict__ wts, const float* __restrict__ pts, int P,
    const float* __restrict__ c_sdf, const float* __restrict__ c_feat,
    const float* __restrict__ c_grad, float* __restrict__ d_pts, float* __restrict__ gpart,
    float* __restrict__ ws_all, long long ws_stride) {
  __shared__ GemmSmem sm;
  const WeightOffsets wo = weight_offsets(d);
  const Workspace L = workspace_layout(d, true);
  float* ws = ws_all + (size_t)blockIdx.x * ws_stride;
  float* gp = gpart + (size_t)blockIdx.x * wo.total;
  const int tid = threadIdx.x;
  for (size_t e = tid; e < wo.total; e += NT) gp[e] = 0.f;
  __syncthreads();
  const int n_blk = (P + MAXS - 1) / MAXS;
  for (int blk = blockIdx.x; blk < n_blk; blk += gridDim.x) {
    const size_t row0 = (size_t)blk * MAXS;
    Dims db = d;
    db.S = min(MAXS, P - (int)row0);
    const int S = db.S;
    for (int e = tid; e < S * 3; e += NT) ws[L.pts + e] = pts[row0 * 3 + e];
    __syncthreads();
    sdf_stack(sm, db, wts, wo, ws, L);  // the primal states again
    // seeds of sdf_reverse: the gradient cotangent is the tangent direction;
    // the sdf cotangent in the net's output units; the feature cotangent in
    // the colour-input slot it reads (the point and normal slots stay 0)
    for (int e = tid; e < S * 3; e += NT) ws[L.cg + e] = c_grad[row0 * 3 + e];
    for (int r = tid; r < S; r += NT) ws[L.cs + r] = c_sdf[row0 + r] / d.scale;
    for (int e = tid; e < S * d.CW; e += NT) {
      const int r = e / d.CW, j = e % d.CW;
      ws[L.ccin + e] = j < 6 ? 0.f : c_feat[(row0 + r) * d.F + (j - 6)];
    }
    __syncthreads();
    sdf_reverse(sm, db, wts, wo, ws, L, gp);
    for (int e = tid; e < S * 3; e += NT) d_pts[row0 * 3 + e] = ws[L.dx + e];
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// The flat weight buffer holds the SDF layers only: Dims with HC = NHC =
// W = 0 (and CW = 6 + F, the slot layout of the feature cotangent).
long long sdf_weight_count(Dims d) { return (long long)weight_offsets(d).total; }

long long sdf_workspace_floats(Dims d, int backward) {
  return (long long)workspace_layout(d, backward != 0).total;
}

// Forward: sdf (P,), feature (P, F), gradient (P, 3) of P points (P, 3).
// ws is an (n_cta, ws_stride) scratch.
int sdf_fwd(Dims d, const float* wts, const float* pts, int P, float* sdf, float* feat,
            float* grad, float* ws, long long ws_stride, int n_cta, void* stream) {
  sdf_fwd_kernel<<<n_cta, NT, 0, (cudaStream_t)stream>>>(d, wts, pts, P, sdf, feat, grad, ws,
                                                          ws_stride);
  return (int)cudaGetLastError();
}

// sdf-only forward: sdf (P,) of P points (P, 3), the same weights and
// workspace as sdf_fwd.
int sdf_only_fwd(Dims d, const float* wts, const float* pts, int P, float* sdf, float* ws,
                 long long ws_stride, int n_cta, void* stream) {
  sdf_only_kernel<<<n_cta, NT, 0, (cudaStream_t)stream>>>(d, wts, pts, P, sdf, ws, ws_stride);
  return (int)cudaGetLastError();
}

// Backward: d(points) (P, 3) and the flat weight gradient d_w
// (weight_count floats). gpart is an (n_cta, weight_count) scratch.
int sdf_bwd(Dims d, const float* wts, const float* pts, int P, const float* c_sdf,
            const float* c_feat, const float* c_grad, float* d_pts, float* d_w, float* gpart,
            float* ws, long long ws_stride, int n_cta, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  sdf_bwd_kernel<<<n_cta, NT, 0, st>>>(d, wts, pts, P, c_sdf, c_feat, c_grad, d_pts, gpart, ws,
                                        ws_stride);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return reduce_partials(gpart, n_cta, (long long)weight_offsets(d).total, d_w, st);
}

}  // extern "C"
