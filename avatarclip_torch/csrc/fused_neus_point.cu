// Point-level NeuS megakernel pair for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas kernels avatarclip_tpu/ops/fused_neus.py `_fwd_kernel`
// (:258) and `_bwd_kernel` (:534), launched by `_run_fwd` / `_run_bwd` under
// the custom VJP `_fused_core` (entry `point_eval_fused`). Per sample point
// of each ray: points o + d * mid_z, the SDF MLP with its analytic spatial
// gradient, the colour MLP, the cos-annealed logistic-CDF alpha and its
// prev-CDF, the inside-sphere flag (|x|^2 < 1), and the eikonal partial sums
// inside |x|^2 < 1.44. Unlike the per-ray pair (fused_neus_ray.cu) there is
// no compositing here: every per-point quantity goes out to device memory
// and the compositing kernel (fused_composite.cu) reduces it per ray. The
// backward takes cotangents on sdf, alpha, cdf, grad and rgb per point (and
// the eikonal numerator), recomputes the primal stacks with (sdf, grad) from
// the forward as residuals, runs the alpha-chain VJP written by hand, the
// colour reverse, and forward-over-reverse through the SDF MLP.
//
// What bounds it on this card: f32 FMA throughput of the per-ray GEMMs
// (64 rows x 256 wide; about 1.37 MFLOP per point forward at 4x256 / 2x256,
// about 3.4 MFLOP backward) and the shared-memory traffic of the simple
// tiled GEMM of neus_mlp.cuh; no tensor cores yet (f32 throughout). The
// per-point outputs are 48 bytes a point (rgb 6 wide), small beside the
// arithmetic.
//
// Design: as the per-ray pair (the device functions are neus_ray.cuh's):
// one ray is one GEMM row block, per-layer states live in the CTA's slice
// of a global workspace, CTAs grid-stride over rays, and the cross-CTA sums
// (eikonal num / den, weight and inv_s gradients) go through per-CTA
// partials and a fixed-order second pass: deterministic, no atomics.
#include "neus_ray.cuh"

using namespace neus;

namespace {

__global__ void __launch_bounds__(NT) neus_point_fwd_kernel(
    Dims d, const float* __restrict__ wts, const float* __restrict__ rays_o,
    const float* __restrict__ rays_d, const float* __restrict__ mid_z,
    const float* __restrict__ dists, const float* __restrict__ inv_s_ptr, float cos_r,
    int R, float* __restrict__ sdf_out, float* __restrict__ alpha_out,
    float* __restrict__ cdf_out, float* __restrict__ g_out, float* __restrict__ inside_out,
    float* __restrict__ rgb_out, float* __restrict__ eik_part, float* __restrict__ ws_all,
    long long ws_stride) {
  __shared__ GemmSmem sm;
  __shared__ RayShared rs;
  __shared__ float red[NT];
  const WeightOffsets wo = weight_offsets(d);
  const Workspace L = workspace_layout(d, false);
  float* ws = ws_all + (size_t)blockIdx.x * ws_stride;
  const float inv_s = *inv_s_ptr;
  const int S = d.S, tid = threadIdx.x;
  float eik_num = 0.f, eik_den = 0.f;
  for (int ray = blockIdx.x; ray < R; ray += gridDim.x) {
    if (tid < 3) {
      rs.o[tid] = rays_o[ray * 3 + tid];
      rs.d[tid] = rays_d[ray * 3 + tid];
    }
    __syncthreads();
    sdf_primal(sm, d, wts, wo, ws, L, rs, mid_z + (size_t)ray * S);
    sdf_gradient(sm, d, wts, wo, ws, L);
    colour_primal(sm, d, wts, wo, ws, L);
    for (int r = tid; r < S; r += NT) {
      const float* g = ws + L.g + r * 3;
      const float* p = ws + L.pts + r * 3;
      const float s = ws[L.out + r * (1 + d.F)] / d.scale;
      const float tc = rs.d[0] * g[0] + rs.d[1] * g[1] + rs.d[2] * g[2];
      const Chain c = alpha_chain(s, tc, dists[(size_t)ray * S + r], inv_s, cos_r);
      const float r2 = p[0] * p[0] + p[1] * p[1] + p[2] * p[2];
      const float relax = r2 < 1.44f ? 1.f : 0.f;
      const float n = sqrtf(g[0] * g[0] + g[1] * g[1] + g[2] * g[2] + 1e-12f);
      eik_num += relax * (n - 1.f) * (n - 1.f);
      eik_den += relax;
      const size_t pt = (size_t)ray * S + r;
      sdf_out[pt] = s;
      alpha_out[pt] = c.alpha;
      cdf_out[pt] = c.P;
      inside_out[pt] = r2 < 1.f ? 1.f : 0.f;
      g_out[pt * 3 + 0] = g[0];
      g_out[pt * 3 + 1] = g[1];
      g_out[pt * 3 + 2] = g[2];
    }
    for (int e = tid; e < S * d.W; e += NT)
      rgb_out[(size_t)ray * S * d.W + e] = rgb_of(d, ws[L.head + e]);
    __syncthreads();
  }
  const float num = cta_sum(eik_num, red);
  const float den = cta_sum(eik_den, red);
  if (tid == 0) {
    eik_part[blockIdx.x * 2 + 0] = num;
    eik_part[blockIdx.x * 2 + 1] = den;
  }
}

__global__ void __launch_bounds__(NT) neus_point_bwd_kernel(
    Dims d, const float* __restrict__ wts, const float* __restrict__ rays_o,
    const float* __restrict__ rays_d, const float* __restrict__ mid_z,
    const float* __restrict__ dists, const float* __restrict__ inv_s_ptr, float cos_r,
    int R, const float* __restrict__ sdf_res, const float* __restrict__ g_res,
    const float* __restrict__ c_sdf, const float* __restrict__ c_alpha,
    const float* __restrict__ c_cdf, const float* __restrict__ c_grad,
    const float* __restrict__ c_rgb, const float* __restrict__ c_eik,
    float* __restrict__ d_o, float* __restrict__ d_d, float* __restrict__ d_z,
    float* __restrict__ d_t, float* __restrict__ gpart, float* __restrict__ ws_all,
    long long ws_stride) {
  __shared__ GemmSmem sm;
  __shared__ RayShared rs;
  __shared__ float red[NT];
  const WeightOffsets wo = weight_offsets(d);
  const Workspace L = workspace_layout(d, true);
  float* ws = ws_all + (size_t)blockIdx.x * ws_stride;
  float* gp = gpart + (size_t)blockIdx.x * (wo.total + 1);
  const float inv_s = *inv_s_ptr;
  const float c_num = c_eik[0];
  const int S = d.S, tid = threadIdx.x;
  for (size_t e = tid; e < wo.total + 1; e += NT) gp[e] = 0.f;
  __syncthreads();
  float civ = 0.f;
  for (int ray = blockIdx.x; ray < R; ray += gridDim.x) {
    if (tid < 3) {
      rs.o[tid] = rays_o[ray * 3 + tid];
      rs.d[tid] = rays_d[ray * 3 + tid];
    }
    __syncthreads();
    const float* z = mid_z + (size_t)ray * S;
    sdf_primal(sm, d, wts, wo, ws, L, rs, z);
    for (int e = tid; e < S * 3; e += NT) ws[L.g + e] = g_res[(size_t)ray * S * 3 + e];
    __syncthreads();
    colour_primal(sm, d, wts, wo, ws, L);
    for (int r = tid; r < S; r += NT) {
      const size_t pt = (size_t)ray * S + r;
      const float* g = ws + L.g + r * 3;
      const float* p = ws + L.pts + r * 3;
      const float tc = rs.d[0] * g[0] + rs.d[1] * g[1] + rs.d[2] * g[2];
      const float dist = dists[pt];
      const Chain c = alpha_chain(sdf_res[pt], tc, dist, inv_s, cos_r);
      const AlphaCots ca = alpha_chain_vjp(c, c_alpha[pt], c_cdf[pt], dist, inv_s, cos_r);
      civ += ca.civ;
      d_t[pt] = ca.ct;
      const float relax = (p[0] * p[0] + p[1] * p[1] + p[2] * p[2]) < 1.44f ? 1.f : 0.f;
      const float ke = eik_factor(c_num, relax, g);
      for (int k = 0; k < 3; ++k) {
        ws[L.cg + r * 3 + k] = c_grad[pt * 3 + k] + ca.ctc * rs.d[k] + ke * g[k];
        ws[L.cdir + r * 3 + k] = ca.ctc * g[k];
      }
      ws[L.cs + r] = (ca.cs + c_sdf[pt]) / d.scale;
    }
    for (int e = tid; e < S * d.W; e += NT) {
      const float crgb = c_rgb[(size_t)ray * S * d.W + e];
      float ch_raw = crgb;
      if (d.squeeze) {
        const float sg = sigmoidf(ws[L.head + e]);
        ch_raw = crgb * sg * (1.f - sg);
      }
      ws[L.chead + e] = ch_raw;
    }
    __syncthreads();
    colour_reverse(sm, d, wts, wo, ws, L, gp);
    sdf_reverse(sm, d, wts, wo, ws, L, gp);
    for (int r = tid; r < S; r += NT) {
      const float* dx = ws + L.dx + r * 3;
      d_z[(size_t)ray * S + r] = dx[0] * rs.d[0] + dx[1] * rs.d[1] + dx[2] * rs.d[2];
    }
    if (tid < 3) {
      float so = 0.f, sd = 0.f;
      for (int r = 0; r < S; ++r) {
        const float dx = ws[L.dx + r * 3 + tid];
        so += dx;
        sd += dx * z[r] + ws[L.cdir + r * 3 + tid];
      }
      d_o[ray * 3 + tid] = so;
      d_d[ray * 3 + tid] = sd;
    }
    __syncthreads();
  }
  const float civ_sum = cta_sum(civ, red);
  if (tid == 0) gp[wo.total] = civ_sum;
}

}  // namespace

extern "C" {

long long neus_point_weight_count(Dims d) { return (long long)weight_offsets(d).total; }

long long neus_point_workspace_floats(Dims d, int backward) {
  return (long long)workspace_layout(d, backward != 0).total;
}

// Forward: per-point sdf, alpha, cdf, inside (R*S,), grad (R*S, 3),
// rgb (R*S, W), and the eikonal (num, den) sums. eik_part is an (n_cta, 2)
// scratch; ws an (n_cta, ws_stride) one.
int neus_point_fwd(Dims d, const float* wts, const float* rays_o, const float* rays_d,
                   const float* mid_z, const float* dists, const float* inv_s, float cos_r,
                   int R, float* sdf, float* alpha, float* cdf, float* grad, float* inside,
                   float* rgb, float* eik, float* eik_part, float* ws, long long ws_stride,
                   int n_cta, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  neus_point_fwd_kernel<<<n_cta, NT, 0, st>>>(d, wts, rays_o, rays_d, mid_z, dists, inv_s, cos_r, R, sdf, alpha, cdf, grad, inside, rgb, eik_part, ws, ws_stride);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return reduce_partials(eik_part, n_cta, 2, eik, st);
}

// Backward: ray / z / dists cotangents, and the flat weight gradient with
// the inv_s gradient appended (d_w has weight_count + 1 floats). gpart is an
// (n_cta, weight_count + 1) scratch.
int neus_point_bwd(Dims d, const float* wts, const float* rays_o, const float* rays_d,
                   const float* mid_z, const float* dists, const float* inv_s, float cos_r,
                   int R, const float* sdf_res, const float* g_res, const float* c_sdf,
                   const float* c_alpha, const float* c_cdf, const float* c_grad,
                   const float* c_rgb, const float* c_eik, float* d_o, float* d_d, float* d_z,
                   float* d_t, float* d_w, float* gpart, float* ws, long long ws_stride,
                   int n_cta, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  neus_point_bwd_kernel<<<n_cta, NT, 0, st>>>(d, wts, rays_o, rays_d, mid_z, dists, inv_s, cos_r, R, sdf_res, g_res, c_sdf, c_alpha, c_cdf, c_grad, c_rgb, c_eik, d_o, d_d, d_z, d_t, gpart, ws, ws_stride);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return reduce_partials(gpart, n_cta, (long long)weight_offsets(d).total + 1, d_w, st);
}

}  // extern "C"
