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
// tensor cores are used yet (f32 throughout, the tight-oracle mode).
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
#include "neus_mlp.cuh"

using namespace neus;

namespace {

struct Chain {
  float tc, ic, ep, en, P, N, q, alpha;
};

// logistic-CDF alpha with cos annealing (renderer.py:221-248)
__device__ inline Chain alpha_chain(float s, float tc, float dist, float inv_s, float r) {
  Chain c;
  c.tc = tc;
  c.ic = -(fmaxf(-tc * 0.5f + 0.5f, 0.f) * (1.f - r) + fmaxf(-tc, 0.f) * r);
  c.en = s + c.ic * dist * 0.5f;
  c.ep = s - c.ic * dist * 0.5f;
  c.P = sigmoidf(c.ep * inv_s);
  c.N = sigmoidf(c.en * inv_s);
  c.q = (c.P - c.N + 1e-5f) / (c.P + 1e-5f);
  c.alpha = fminf(fmaxf(c.q, 0.f), 1.f);
  return c;
}

struct RayShared {
  float o[3], d[3];
  float alpha[MAXS], w[MAXS], T[MAXS], calpha[MAXS];
};

// points, embedding (+ first and second derivatives), SDF primal stack:
// h[i], p[i] = softplus', u = [softplus(z_skip), e] / sqrt(2), p_s, and
// out = [s_net, feature]
__device__ void sdf_primal(GemmSmem& sm, const Dims& d, const float* wts,
                           const WeightOffsets& wo, float* ws, const Workspace& L,
                           const RayShared& rs, const float* z) {
  const int S = d.S, tid = threadIdx.x;
  for (int e = tid; e < S * 3; e += NT) {
    const int r = e / 3, c = e % 3;
    ws[L.pts + e] = rs.o[c] + rs.d[c] * z[r];
  }
  __syncthreads();
  for (int e = tid; e < S * d.E; e += NT) {
    const int r = e / d.E, j = e % d.E;
    int c, kind;
    float f;
    pe_column(j, c, f, kind);
    const float xs = ws[L.pts + r * 3 + c] * d.scale;
    float val, dv, ddv;
    if (kind == 0) {
      val = xs; dv = 1.f; ddv = 0.f;
    } else {
      const float sn = sinf(f * xs), cs = cosf(f * xs);
      if (kind == 1) { val = sn; dv = f * cs; ddv = -f * f * sn; }
      else { val = cs; dv = -f * sn; ddv = -f * f * cs; }
    }
    ws[L.e + e] = val;
    ws[L.de + e] = dv;
    ws[L.dde + e] = ddv;
  }
  __syncthreads();
  for (int i = 0; i < d.NH; ++i) {
    const int in = sdf_in(d, i);
    gemm(sm, S, d.H, in, ws + L.h[i], in, false, wts + wo.sw[i], in, true,
         ws + L.h[i + 1], d.H, false, wts + wo.sb[i]);
    for (int e = tid; e < S * d.H; e += NT) {
      float sp, sg;
      sp_sig(ws[L.h[i + 1] + e], sp, sg);
      ws[L.h[i + 1] + e] = sp;
      ws[L.p[i] + e] = sg;
    }
    __syncthreads();
  }
  // skip-producing layer, written into u[:, :SW]
  gemm(sm, S, d.SW, d.H, ws + L.h[d.NH], d.H, false, wts + wo.sw[d.NH], d.H, true,
       ws + L.u, d.H, false, wts + wo.sb[d.NH]);
  for (int e = tid; e < S * d.H; e += NT) {
    const int r = e / d.H, k = e % d.H;
    if (k < d.SW) {
      float sp, sg;
      sp_sig(ws[L.u + e], sp, sg);
      ws[L.u + e] = sp * RSQRT2;
      ws[L.ps + r * d.SW + k] = sg;
    } else {
      ws[L.u + e] = ws[L.e + r * d.E + (k - d.SW)] * RSQRT2;
    }
  }
  __syncthreads();
  gemm(sm, S, 1 + d.F, d.H, ws + L.u, d.H, false, wts + wo.sw[d.NH + 1], d.H, true,
       ws + L.out, 1 + d.F, false, wts + wo.sb[d.NH + 1]);
}

// analytic spatial gradient g = d s_net / d xs by one reverse sweep
__device__ void sdf_gradient(GemmSmem& sm, const Dims& d, const float* wts,
                             const WeightOffsets& wo, float* ws, const Workspace& L) {
  const int S = d.S, tid = threadIdx.x;
  const float* wf0 = wts + wo.sw[d.NH + 1];  // head row 0 (the sdf output)
  for (int e = tid; e < S * d.SW; e += NT) {
    const int k = e % d.SW;
    ws[L.ta + e] = wf0[k] * RSQRT2 * ws[L.ps + e];
  }
  __syncthreads();
  gemm(sm, S, d.H, d.SW, ws + L.ta, d.SW, false, wts + wo.sw[d.NH], d.H, false,
       ws + L.tb, d.H, false, nullptr);
  float* q = ws + L.tb;
  float* other = ws + L.ta;
  for (int i = d.NH - 1; i >= 0; --i) {
    for (int e = tid; e < S * d.H; e += NT) q[e] *= ws[L.p[i] + e];
    __syncthreads();
    const int in = sdf_in(d, i);
    gemm(sm, S, in, d.H, q, d.H, false, wts + wo.sw[i], in, false, other, in, false, nullptr);
    float* t = q; q = other; other = t;
  }
  for (int e = tid; e < S * 3; e += NT) {
    const int r = e / 3, c = e % 3;
    float acc = 0.f;
    for (int j = c; j < d.E; j += 3)  // every embedding column of component c
      acc += (q[r * d.E + j] + wf0[d.SW + j] * RSQRT2) * ws[L.de + r * d.E + j];
    ws[L.g + e] = acc;
  }
  __syncthreads();
}

// colour MLP primal: cin = [pts, g, feature], relu stack, raw head
__device__ void colour_primal(GemmSmem& sm, const Dims& d, const float* wts,
                              const WeightOffsets& wo, float* ws, const Workspace& L) {
  const int S = d.S, tid = threadIdx.x;
  for (int e = tid; e < S * d.CW; e += NT) {
    const int r = e / d.CW, j = e % d.CW;
    float v;
    if (j < 3) v = ws[L.pts + r * 3 + j];
    else if (j < 6) v = ws[L.g + r * 3 + j - 3];
    else v = ws[L.out + r * (1 + d.F) + 1 + (j - 6)];
    ws[L.cin + e] = v;
  }
  __syncthreads();
  const float* x = ws + L.cin;
  int xin = d.CW;
  for (int l = 0; l < d.NHC; ++l) {
    float* a = ws + L.acts[l];
    gemm(sm, S, d.HC, xin, x, xin, false, wts + wo.cw[l], xin, true, a, d.HC, false,
         wts + wo.cb[l]);
    for (int e = tid; e < S * d.HC; e += NT) a[e] = fmaxf(a[e], 0.f);
    __syncthreads();
    x = a;
    xin = d.HC;
  }
  gemm(sm, S, d.W, d.HC, x, d.HC, false, wts + wo.cw[d.NHC], d.HC, true, ws + L.head, d.W,
       false, wts + wo.cb[d.NHC]);
}

__device__ inline float rgb_of(const Dims& d, float h) { return d.squeeze ? sigmoidf(h) : h; }

// fixed-order CTA sum of one value per thread (result valid in thread 0)
__device__ float cta_sum(float v, float* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int st = NT / 2; st > 0; st >>= 1) {
    if (tid < st) red[tid] += red[tid + st];
    __syncthreads();
  }
  const float s = red[0];
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(NT) neus_ray_fwd_kernel(
    Dims d, const float* __restrict__ wts, const float* __restrict__ rays_o,
    const float* __restrict__ rays_d, const float* __restrict__ mid_z,
    const float* __restrict__ dists, const float* __restrict__ inv_s_ptr, float cos_r,
    int R, float* __restrict__ col_w, float* __restrict__ normals_w,
    float* __restrict__ wsum, float* __restrict__ sdf_out, float* __restrict__ g_out,
    float* __restrict__ eik_part, float* __restrict__ ws_all, long long ws_stride) {
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

// colour reverse: weight grads into gp, input cotangents into ccin
__device__ void colour_reverse(GemmSmem& sm, const Dims& d, const float* wts,
                               const WeightOffsets& wo, float* ws, const Workspace& L,
                               float* gp) {
  const int S = d.S, tid = threadIdx.x;
  const float* a_last = ws + L.acts[d.NHC - 1];
  gemm(sm, d.W, d.HC, S, ws + L.chead, d.W, true, a_last, d.HC, false, gp + wo.cw[d.NHC],
       d.HC, true, nullptr);
  colsum_acc(S, d.W, ws + L.chead, d.W, gp + wo.cb[d.NHC]);
  gemm(sm, S, d.HC, d.W, ws + L.chead, d.W, false, wts + wo.cw[d.NHC], d.HC, false,
       ws + L.ca, d.HC, false, nullptr);
  for (int l = d.NHC - 1; l >= 0; --l) {
    const float* act = ws + L.acts[l];
    for (int e = tid; e < S * d.HC; e += NT)
      ws[L.czc + e] = act[e] > 0.f ? ws[L.ca + e] : 0.f;
    __syncthreads();
    const int nin = col_in(d, l);
    const float* xin = l == 0 ? ws + L.cin : ws + L.acts[l - 1];
    gemm(sm, d.HC, nin, S, ws + L.czc, d.HC, true, xin, nin, false, gp + wo.cw[l], nin,
         true, nullptr);
    colsum_acc(S, d.HC, ws + L.czc, d.HC, gp + wo.cb[l]);
    float* dst = l == 0 ? ws + L.ccin : ws + L.ca;
    gemm(sm, S, nin, d.HC, ws + L.czc, d.HC, false, wts + wo.cw[l], nin, false, dst, nin,
         false, nullptr);
  }
}

// forward-over-reverse through the SDF MLP: weight grads into gp and the
// cotangent on the raw points into dx (colour path's direct term included)
__device__ void sdf_reverse(GemmSmem& sm, const Dims& d, const float* wts,
                            const WeightOffsets& wo, float* ws, const Workspace& L,
                            float* gp) {
  const int S = d.S, E = d.E, H = d.H, SW = d.SW, F1 = 1 + d.F, tid = threadIdx.x;
  const float* wfin = wts + wo.sw[d.NH + 1];
  // v = total cotangent on the spatial gradient (colour normal input added)
  for (int e = tid; e < S * 3; e += NT) {
    const int r = e / 3, c = e % 3;
    ws[L.cg + e] += ws[L.ccin + r * d.CW + 3 + c];
  }
  __syncthreads();
  // tangent forward along v: t0 = de * v_c(j)
  for (int e = tid; e < S * E; e += NT) {
    const int r = e / E, j = e % E;
    ws[L.t[0] + e] = ws[L.de + e] * ws[L.cg + r * 3 + (j % 3)];
  }
  __syncthreads();
  for (int i = 0; i < d.NH; ++i) {
    const int in = sdf_in(d, i);
    gemm(sm, S, H, in, ws + L.t[i], in, false, wts + wo.sw[i], in, true, ws + L.zd[i], H,
         false, nullptr);
    for (int e = tid; e < S * H; e += NT) ws[L.t[i + 1] + e] = ws[L.p[i] + e] * ws[L.zd[i] + e];
    __syncthreads();
  }
  gemm(sm, S, SW, H, ws + L.t[d.NH], H, false, wts + wo.sw[d.NH], H, true, ws + L.zds, SW,
       false, nullptr);
  for (int e = tid; e < S * H; e += NT) {
    const int r = e / H, k = e % H;
    ws[L.udot + e] = k < SW ? ws[L.ps + r * SW + k] * ws[L.zds + r * SW + k] * RSQRT2
                            : ws[L.t[0] + r * E + (k - SW)] * RSQRT2;
  }
  for (int e = tid; e < S * F1; e += NT) {
    const int r = e / F1, j = e % F1;
    ws[L.cout + e] = j == 0 ? ws[L.cs + r] : ws[L.ccin + r * d.CW + 6 + (j - 1)];
  }
  __syncthreads();
  // head: dWfin += cout^T u, row 0 also += sum(udot); dbfin += sum(cout)
  gemm(sm, F1, H, S, ws + L.cout, F1, true, ws + L.u, H, false, gp + wo.sw[d.NH + 1], H, true,
       nullptr);
  colsum_acc(S, H, ws + L.udot, H, gp + wo.sw[d.NH + 1]);
  colsum_acc(S, F1, ws + L.cout, F1, gp + wo.sb[d.NH + 1]);
  gemm(sm, S, H, F1, ws + L.cout, F1, false, wfin, H, false, ws + L.cu, H, false, nullptr);
  // skip layer: primal and tangent cotangents
  for (int e = tid; e < S * SW; e += NT) {
    const int r = e / SW, k = e % SW;
    const float ps = ws[L.ps + e];
    const float cad = wfin[k] * RSQRT2;
    const float cas = ws[L.cu + r * H + k] * RSQRT2;
    ws[L.czs + e] = cas * ps + cad * ws[L.zds + e] * 100.f * ps * (1.f - ps);
    ws[L.czds + e] = cad * ps;
  }
  __syncthreads();
  gemm(sm, SW, H, S, ws + L.czs, SW, true, ws + L.h[d.NH], H, false, gp + wo.sw[d.NH], H,
       true, nullptr);
  gemm(sm, SW, H, S, ws + L.czds, SW, true, ws + L.t[d.NH], H, false, gp + wo.sw[d.NH], H,
       true, nullptr);
  colsum_acc(S, SW, ws + L.czs, SW, gp + wo.sb[d.NH]);
  gemm(sm, S, H, SW, ws + L.czs, SW, false, wts + wo.sw[d.NH], H, false, ws + L.ch, H, false,
       nullptr);
  gemm(sm, S, H, SW, ws + L.czds, SW, false, wts + wo.sw[d.NH], H, false, ws + L.chd, H,
       false, nullptr);
  for (int i = d.NH - 1; i >= 0; --i) {
    const int in = sdf_in(d, i);
    for (int e = tid; e < S * H; e += NT) {
      const float p = ws[L.p[i] + e];
      const float chd = ws[L.chd + e];
      ws[L.cz + e] = ws[L.ch + e] * p + chd * ws[L.zd[i] + e] * 100.f * p * (1.f - p);
      ws[L.czd + e] = chd * p;
    }
    __syncthreads();
    gemm(sm, H, in, S, ws + L.cz, H, true, ws + L.h[i], in, false, gp + wo.sw[i], in, true,
         nullptr);
    gemm(sm, H, in, S, ws + L.czd, H, true, ws + L.t[i], in, false, gp + wo.sw[i], in, true,
         nullptr);
    colsum_acc(S, H, ws + L.cz, H, gp + wo.sb[i]);
    gemm(sm, S, in, H, ws + L.cz, H, false, wts + wo.sw[i], in, false, ws + L.ch, in, false,
         nullptr);
    gemm(sm, S, in, H, ws + L.czd, H, false, wts + wo.sw[i], in, false, ws + L.chd, in, false,
         nullptr);
  }
  // embedding cotangents -> raw point cotangent
  for (int e = tid; e < S * 3; e += NT) {
    const int r = e / 3, c = e % 3;
    const float v = ws[L.cg + e];
    float acc = 0.f;
    for (int j = c; j < E; j += 3) {
      const float ce = ws[L.ch + r * E + j] + ws[L.cu + r * H + SW + j] * RSQRT2;
      const float ced = ws[L.chd + r * E + j] + wfin[SW + j] * RSQRT2;
      acc += ce * ws[L.de + r * E + j] + ced * v * ws[L.dde + r * E + j];
    }
    ws[L.dx + e] = acc * d.scale + ws[L.ccin + r * d.CW + c];
  }
  __syncthreads();
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
      const float cq = (c.q >= 0.f && c.q <= 1.f) ? rs.calpha[r] : 0.f;
      const float A = c.P + 1e-5f;
      const float cP = cq * c.N / (A * A);
      const float cN = -cq / A;
      const float dP = c.P * (1.f - c.P), dN = c.N * (1.f - c.N);
      const float cep = cP * inv_s * dP, cen = cN * inv_s * dN;
      civ += cP * c.ep * dP + cN * c.en * dN;
      const float cic = (cen - cep) * dist * 0.5f;
      d_t[(size_t)ray * S + r] = (cen - cep) * c.ic * 0.5f;
      const float ctc = cic * (0.5f * (1.f - cos_r) * (tc < 1.f ? 1.f : 0.f) +
                               cos_r * (tc < 0.f ? 1.f : 0.f));
      const float relax = (p[0] * p[0] + p[1] * p[1] + p[2] * p[2]) < 1.44f ? 1.f : 0.f;
      const float n = sqrtf(g[0] * g[0] + g[1] * g[1] + g[2] * g[2] + 1e-12f);
      const float ke = c_num * relax * 2.f * (n - 1.f) / n;
      const float w = rs.w[r];
      for (int k = 0; k < 3; ++k) {
        ws[L.cg + r * 3 + k] = w * c_nw[(size_t)ray * 3 + k] + ctc * rs.d[k] + ke * g[k];
        ws[L.cdir + r * 3 + k] = ctc * g[k];
      }
      ws[L.cs + r] = (cep + cen) / d.scale;
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

// out[i] = sum_c part[c * n + i], c in fixed order
__global__ void reduce_partials_kernel(const float* __restrict__ part, int n_part, long long n,
                                       float* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < n_part; ++c) s += part[(size_t)c * n + i];
    out[i] = s;
  }
}

int reduce_partials(const float* part, int n_part, long long n, float* out, cudaStream_t st) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  if (blocks < 1) blocks = 1;
  reduce_partials_kernel<<<(int)blocks, threads, 0, st>>>(part, n_part, n, out);
  return (int)cudaGetLastError();
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
