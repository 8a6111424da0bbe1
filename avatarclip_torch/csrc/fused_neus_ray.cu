// Per-ray NeuS megakernel pair for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas kernels avatarclip_tpu/ops/fused_neus.py
// `_fwd_kernel_ray` (:403) and `_bwd_kernel_ray` (:620), launched by
// `_run_fwd_ray` / `_run_bwd_ray` under the custom VJP `_fused_core_ray`.
// Per ray: points o + d * mid_z, positional encoding, the SDF MLP
// (softplus beta=100, one skip concat before the head) with its analytic
// spatial gradient, the colour MLP (no_view_dir, optional extra head,
// sigmoid), the cos-annealed logistic-CDF alpha, compositing with an
// exclusive transmittance product, and the eikonal partial sums inside
// |x| < 1.2. The backward recomputes the primal stacks (taking (sdf, grad)
// from the forward as residuals), runs the compositing and alpha-chain VJP
// written by hand, the colour reverse, and forward-over-reverse through the
// SDF MLP for the eikonal and normal terms.
//
// What bounds it on this card: f32 FMA throughput of the per-ray GEMMs
// (64 rows x 256 wide, about 1.3 MFLOP per point forward and 3x that
// backward) and the shared-memory traffic of the simple tiled GEMM; no
// tensor cores (f32 throughout): the f32 operand mode, the tight oracle.
// The bf16 mode runs the tensor-core pair of fused_neus_ray_tc.cu.
//
// The per-ray device functions (network passes, alpha chain, reverse
// passes, partial sums) live in neus_ray.cuh, shared with the point-level
// pair (fused_neus_point.cu).
//
// Design: one ray (<= 64 samples) is one GEMM row block. A Pallas block held
// 16 rays x 64 samples with every 256-wide activation in VMEM (~1 MB each);
// a CTA has 227 KB of shared memory, so each CTA keeps its per-layer states
// (activations, softplus' terms, tangents, cotangents) in its own slice of a
// global workspace (~2 MB per CTA, L2/HBM resident) and only stages GEMM
// tiles in shared memory. CTAs grid-stride over rays (a few hundred CTAs).
// The TPU grid accumulated weight / inv_s gradients and the eikonal sums in
// revisited output blocks; here every CTA writes its own partial slice and a
// second pass (reduce_partials) sums them in a fixed order, so results are
// deterministic and no atomics are used. Padding rays is unnecessary: the
// ragged edge is the loop bound.
#include "neus_ray.cuh"

using namespace neus;

namespace {

__global__ void __launch_bounds__(NT) neus_ray_fwd_kernel(
    Dims d, const float* __restrict__ wts, const float* __restrict__ rays_o,
    const float* __restrict__ rays_d, const float* __restrict__ mid_z,
    const float* __restrict__ dists, const float* __restrict__ inv_s_ptr, float cos_r,
    int R, float* __restrict__ col_w, float* __restrict__ normals_w,
    float* __restrict__ wsum, float* __restrict__ sdf_out, float* __restrict__ g_out,
    float* __restrict__ eik_part, float* __restrict__ ws_all, long long ws_stride) {
  __shared__ GemmSmem sm;
  set_mode(sm, d);
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
      rs.alpha[r] = c.alpha;
      const float relax = (p[0] * p[0] + p[1] * p[1] + p[2] * p[2]) < 1.44f ? 1.f : 0.f;
      const float n = sqrtf(g[0] * g[0] + g[1] * g[1] + g[2] * g[2] + 1e-12f);
      eik_num += relax * (n - 1.f) * (n - 1.f);
      eik_den += relax;
      const size_t pt = (size_t)ray * S + r;
      sdf_out[pt] = s;
      g_out[pt * 3 + 0] = g[0];
      g_out[pt * 3 + 1] = g[1];
      g_out[pt * 3 + 2] = g[2];
    }
    __syncthreads();
    if (tid == 0) {
      float T = 1.f;
      for (int k = 0; k < S; ++k) {
        rs.w[k] = rs.alpha[k] * T;
        T *= 1.f - rs.alpha[k] + 1e-7f;
      }
    }
    __syncthreads();
    if (tid < d.W + 4) {
      float acc = 0.f;
      for (int k = 0; k < S; ++k) {
        float v;
        if (tid < d.W) v = rgb_of(d, ws[L.head + k * d.W + tid]);
        else if (tid < d.W + 3) v = ws[L.g + k * 3 + tid - d.W];
        else v = 1.f;
        acc += rs.w[k] * v;
      }
      if (tid < d.W) col_w[(size_t)ray * d.W + tid] = acc;
      else if (tid < d.W + 3) normals_w[(size_t)ray * 3 + tid - d.W] = acc;
      else wsum[ray] = acc;
    }
    __syncthreads();
  }
  const float num = cta_sum(eik_num, red);
  const float den = cta_sum(eik_den, red);
  if (tid == 0) {
    eik_part[blockIdx.x * 2 + 0] = num;
    eik_part[blockIdx.x * 2 + 1] = den;
  }
}

__global__ void __launch_bounds__(NT) neus_ray_bwd_kernel(
    Dims d, const float* __restrict__ wts, const float* __restrict__ rays_o,
    const float* __restrict__ rays_d, const float* __restrict__ mid_z,
    const float* __restrict__ dists, const float* __restrict__ inv_s_ptr, float cos_r,
    int R, const float* __restrict__ sdf_res, const float* __restrict__ g_res,
    const float* __restrict__ c_col, const float* __restrict__ c_nw,
    const float* __restrict__ c_ws, const float* __restrict__ c_eik,
    float* __restrict__ d_o, float* __restrict__ d_d, float* __restrict__ d_z,
    float* __restrict__ d_t, float* __restrict__ gpart, float* __restrict__ ws_all,
    long long ws_stride) {
  __shared__ GemmSmem sm;
  set_mode(sm, d);
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
      const float* g = ws + L.g + r * 3;
      const float tc = rs.d[0] * g[0] + rs.d[1] * g[1] + rs.d[2] * g[2];
      const Chain c = alpha_chain(sdf_res[(size_t)ray * S + r], tc, dists[(size_t)ray * S + r],
                                  inv_s, cos_r);
      rs.alpha[r] = c.alpha;
    }
    __syncthreads();
    // compositing VJP over the ray: L = sum_k w_k u_k, w_k = alpha_k T_k,
    // T_k = prod_{j<k} x_j, x_j = 1 - alpha_j + 1e-7;
    // dL/dalpha_k = T_k (u_k - B_k), B_{k-1} = u_k alpha_k + x_k B_k
    if (tid == 0) {
      float T = 1.f;
      for (int k = 0; k < S; ++k) {
        rs.T[k] = T;
        rs.w[k] = rs.alpha[k] * T;
        T *= 1.f - rs.alpha[k] + 1e-7f;
      }
      float B = 0.f;
      for (int k = S - 1; k >= 0; --k) {
        float u = c_ws[ray];
        for (int ch = 0; ch < d.W; ++ch)
          u += c_col[(size_t)ray * d.W + ch] * rgb_of(d, ws[L.head + k * d.W + ch]);
        for (int c = 0; c < 3; ++c) u += c_nw[(size_t)ray * 3 + c] * ws[L.g + k * 3 + c];
        rs.calpha[k] = rs.T[k] * (u - B);
        B = u * rs.alpha[k] + (1.f - rs.alpha[k] + 1e-7f) * B;
      }
    }
    __syncthreads();
    for (int r = tid; r < S; r += NT) {
      const float* g = ws + L.g + r * 3;
      const float* p = ws + L.pts + r * 3;
      const float tc = rs.d[0] * g[0] + rs.d[1] * g[1] + rs.d[2] * g[2];
      const float dist = dists[(size_t)ray * S + r];
      const Chain c = alpha_chain(sdf_res[(size_t)ray * S + r], tc, dist, inv_s, cos_r);
      const AlphaCots ca = alpha_chain_vjp(c, rs.calpha[r], 0.f, dist, inv_s, cos_r);
      civ += ca.civ;
      d_t[(size_t)ray * S + r] = ca.ct;
      const float relax = (p[0] * p[0] + p[1] * p[1] + p[2] * p[2]) < 1.44f ? 1.f : 0.f;
      const float ke = eik_factor(c_num, relax, g);
      const float w = rs.w[r];
      for (int k = 0; k < 3; ++k) {
        ws[L.cg + r * 3 + k] = w * c_nw[(size_t)ray * 3 + k] + ca.ctc * rs.d[k] + ke * g[k];
        ws[L.cdir + r * 3 + k] = ca.ctc * g[k];
      }
      ws[L.cs + r] = ca.cs / d.scale;
      for (int ch = 0; ch < d.W; ++ch) {
        const float h = ws[L.head + r * d.W + ch];
        const float crgb = w * c_col[(size_t)ray * d.W + ch];
        float ch_raw = crgb;
        if (d.squeeze) {
          const float sg = sigmoidf(h);
          ch_raw = crgb * sg * (1.f - sg);
        }
        ws[L.chead + r * d.W + ch] = ch_raw;
      }
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

long long neus_weight_count(Dims d) { return (long long)weight_offsets(d).total; }

long long neus_workspace_floats(Dims d, int backward) {
  return (long long)workspace_layout(d, backward != 0).total;
}

// Forward: per-ray outputs, (sdf, grad) residuals and the eikonal (num, den)
// sums. eik_part is an (n_cta, 2) scratch; ws an (n_cta, ws_stride) one.
int neus_ray_fwd(Dims d, const float* wts, const float* rays_o, const float* rays_d,
                 const float* mid_z, const float* dists, const float* inv_s, float cos_r, int R,
                 float* col_w, float* normals_w, float* wsum, float* sdf_out, float* g_out,
                 float* eik, float* eik_part, float* ws, long long ws_stride, int n_cta,
                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  neus_ray_fwd_kernel<<<n_cta, NT, 0, st>>>(d, wts, rays_o, rays_d, mid_z, dists, inv_s, cos_r, R, col_w, normals_w, wsum, sdf_out, g_out, eik_part, ws, ws_stride);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return reduce_partials(eik_part, n_cta, 2, eik, st);
}

// Backward: ray / z / dists cotangents, and the flat weight gradient with
// the inv_s gradient appended (d_w has weight_count + 1 floats). gpart is an
// (n_cta, weight_count + 1) scratch.
int neus_ray_bwd(Dims d, const float* wts, const float* rays_o, const float* rays_d,
                 const float* mid_z, const float* dists, const float* inv_s, float cos_r, int R,
                 const float* sdf_res, const float* g_res, const float* c_col, const float* c_nw,
                 const float* c_ws, const float* c_eik, float* d_o, float* d_d, float* d_z,
                 float* d_t, float* d_w, float* gpart, float* ws, long long ws_stride, int n_cta,
                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  neus_ray_bwd_kernel<<<n_cta, NT, 0, st>>>(d, wts, rays_o, rays_d, mid_z, dists, inv_s, cos_r, R, sdf_res, g_res, c_col, c_nw, c_ws, c_eik, d_o, d_d, d_z, d_t, gpart, ws, ws_stride);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return reduce_partials(gpart, n_cta, (long long)weight_offsets(d).total + 1, d_w, st);
}

}  // extern "C"
