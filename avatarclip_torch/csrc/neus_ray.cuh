// Device code of one ray's NeuS network pass, shared by the per-ray kernel
// pair (fused_neus_ray.cu, B1), the point-level pair (fused_neus_point.cu,
// B3) and the standalone SDF pair (fused_sdf.cu, B6, which runs a block of
// up to MAXS points as one "ray"): the alpha chain and its VJP, the SDF primal
// stack with its analytic spatial gradient, the colour MLP, their reverse
// passes (forward-over-reverse through the SDF MLP) and the fixed-order
// partial-sum pass. The sdf-only kernel (fused_sdf.cu, #12) runs the primal
// stack alone. Every function is called by all NT threads of a CTA
// working on one ray of d.S <= MAXS samples, with the ray's states in the
// CTA's workspace slice ``ws`` (layout: neus_mlp.cuh).
#pragma once

#include "neus_mlp.cuh"

// No anonymous namespace here: nvcc's registration stub cannot tell one
// nested in neus from the including file's own. Each library is one
// translation unit, so these external definitions do not collide.
namespace neus {

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

// from the d.S points in ws[L.pts]: embedding (+ first and second
// derivatives), SDF primal stack: h[i], p[i] = softplus',
// u = [softplus(z_skip), e] / sqrt(2), p_s, and out = [s_net, feature].
// value_only (the sdf-only kernel): no embedding derivatives, and the head's
// sdf row alone, into out's column 0 (row stride 1 + F as before).
// In the bf16 operand mode the head's sdf row is summed from unrounded f32
// operands unless round_sdf_row (the JAX megakernels and sdf-only kernel
// take it as an f32 row form; the JAX sdf+gradient kernel's _dot rounds it).
__device__ void sdf_stack(GemmSmem& sm, const Dims& d, const float* wts,
                          const WeightOffsets& wo, float* ws, const Workspace& L,
                          bool value_only = false, bool round_sdf_row = false) {
  const int S = d.S, tid = threadIdx.x;
  for (int e = tid; e < S * d.E; e += NT) {
    const int r = e / d.E, j = e % d.E;
    int c, kind;
    float f;
    pe_column(j, c, f, kind);
    const float xs = ws[L.pts + r * 3 + c] * d.scale;
    if (value_only) {
      ws[L.e + e] = kind == 0 ? xs : (kind == 1 ? sinf(f * xs) : cosf(f * xs));
      continue;
    }
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
  const bool f32_row = d.bf16 && !round_sdf_row;
  if (!(value_only && f32_row))
    gemm(sm, S, value_only ? 1 : 1 + d.F, d.H, ws + L.u, d.H, false, wts + wo.sw[d.NH + 1], d.H,
         true, ws + L.out, 1 + d.F, false, wts + wo.sb[d.NH + 1]);
  if (f32_row) {
    // four threads a row, fixed order: strided partial sums, then two xor
    // shuffles within the four consecutive lanes
    const float* w0 = wts + wo.sw[d.NH + 1];
    const int r = tid >> 2, q = tid & 3;
    float acc = 0.f;
    if (r < S)
      for (int k = q; k < d.H; k += 4) acc += ws[L.u + r * d.H + k] * w0[k];
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (r < S && q == 0) ws[L.out + r * (1 + d.F)] = acc + wts[wo.sb[d.NH + 1]];
    __syncthreads();
  }
}

// the ray's points o + d z, then sdf_stack
__device__ void sdf_primal(GemmSmem& sm, const Dims& d, const float* wts,
                           const WeightOffsets& wo, float* ws, const Workspace& L,
                           const RayShared& rs, const float* z) {
  for (int e = threadIdx.x; e < d.S * 3; e += NT) {
    const int r = e / 3, c = e % 3;
    ws[L.pts + e] = rs.o[c] + rs.d[c] * z[r];
  }
  __syncthreads();
  sdf_stack(sm, d, wts, wo, ws, L);
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

// VJP of (alpha, prev_cdf) = alpha_chain(s, tc, dist, inv_s, r) for the
// cotangents (c_alpha, c_cdf). The clip passes the gradient on [0, 1]
// (torch's clamp); relu' is 0 at 0 (torch and JAX alike).
struct AlphaCots {
  float cs;   // on s (the sdf, in output units)
  float ct;   // on dist
  float ctc;  // on the true cos tc = d . g
  float civ;  // on inv_s
};

__device__ inline AlphaCots alpha_chain_vjp(const Chain& c, float c_alpha, float c_cdf,
                                            float dist, float inv_s, float r) {
  const float cq = (c.q >= 0.f && c.q <= 1.f) ? c_alpha : 0.f;
  const float A = c.P + 1e-5f;
  const float cP = cq * c.N / (A * A) + c_cdf;
  const float cN = -cq / A;
  const float dP = c.P * (1.f - c.P), dN = c.N * (1.f - c.N);
  const float cep = cP * inv_s * dP, cen = cN * inv_s * dN;
  AlphaCots o;
  o.civ = cP * c.ep * dP + cN * c.en * dN;
  o.cs = cep + cen;
  o.ct = (cen - cep) * c.ic * 0.5f;
  const float cic = (cen - cep) * dist * 0.5f;
  o.ctc = cic * (0.5f * (1.f - r) * (c.tc < 1.f ? 1.f : 0.f) + r * (c.tc < 0.f ? 1.f : 0.f));
  return o;
}

// cotangent on the eikonal numerator sum_relax (|g| - 1)^2 -> factor on g
__device__ inline float eik_factor(float c_num, float relax, const float* g) {
  const float n = sqrtf(g[0] * g[0] + g[1] * g[1] + g[2] * g[2] + 1e-12f);
  return c_num * relax * 2.f * (n - 1.f) / n;
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
  if (d.bf16) {
    // the sdf row (cout's column 0) in f32, as the JAX kernels' row forms;
    // the feature rows through the rounding gemm
    gemm(sm, d.F, H, S, ws + L.cout + 1, F1, true, ws + L.u, H, false,
         gp + wo.sw[d.NH + 1] + H, H, true, nullptr);
    for (int k = tid; k < H; k += NT) {
      float acc = 0.f;
      for (int r = 0; r < S; ++r)
        acc += ws[L.cs + r] * ws[L.u + r * H + k] + ws[L.udot + r * H + k];
      gp[wo.sw[d.NH + 1] + k] += acc;
    }
    __syncthreads();
  } else {
    gemm(sm, F1, H, S, ws + L.cout, F1, true, ws + L.u, H, false, gp + wo.sw[d.NH + 1], H, true,
         nullptr);
    colsum_acc(S, H, ws + L.udot, H, gp + wo.sw[d.NH + 1]);
  }
  colsum_acc(S, F1, ws + L.cout, F1, gp + wo.sb[d.NH + 1]);
  if (d.bf16) {
    gemm(sm, S, H, d.F, ws + L.cout + 1, F1, false, wfin + H, H, false, ws + L.cu, H, false,
         nullptr);
    for (int e = tid; e < S * H; e += NT) ws[L.cu + e] += ws[L.cs + e / H] * wfin[e % H];
    __syncthreads();
  } else {
    gemm(sm, S, H, F1, ws + L.cout, F1, false, wfin, H, false, ws + L.cu, H, false, nullptr);
  }
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

}  // namespace neus
