// Colour (rendering) MLP kernel pair for Hopper (sm_90a): forward and
// backward (B7).
//
// Replaces the Pallas kernels avatarclip_tpu/ops/fused_color.py `_fwd_kernel`
// (:230) and `_bwd_kernel` (:244), launched by `_run_fwd` / `_run_bwd` under
// the custom VJP `_fused_core` (entry `color_apply_fused`). Per point: the
// first relu linear over the separate inputs (points, normals, view
// directions, each 3 wide, and the geometry feature), NHC - 1 more relu
// linears, one combined head (the main rgb and, with extra_color, the extra
// rgb) and the sigmoid. The input concatenation is never built: the first
// layer's weight comes in per-input slices (a mode without normals or
// without directions has a zero slice there), and the feature is read by the
// GEMM straight from its (P, F) tensor. The backward recomputes the forward
// per block and returns the four input cotangents and every dense weight
// gradient. The renderer runs it when the megakernel is declined: with the
// NeRF++ background on (render/neus.py).
//
// What bounds it on this card: f32 FMA throughput of the per-block GEMMs
// (269,824 FLOPs a point forward, 809,472 backward at 2 x 256, head 6), well
// above the bytes (about 1.1 KB a point, the feature). The forward serves
// both operand modes: in the bf16 one (Dims::bf16, the confs' default) every
// dot operand is rounded to bf16 as the JAX kernel's _dot, with f32 sums.
// The bf16 mode's backward is the tensor-core kernel of
// fused_neus_ray_tc.cu (colour_tc_bwd); this backward serves the f32 mode.
//
// Design: as B6 (fused_sdf.cu): a block of up to MAXS = 64 points is one
// GEMM row block (neus_mlp.cuh's CTA-wide f32 GEMM), a ragged last block
// runs with fewer rows, per-layer states in the CTA's slice of a global
// workspace, CTAs grid-stride over blocks, and the weight gradients go to
// per-CTA partials and a fixed-order second pass (no atomics).
#include "neus_mlp.cuh"

using namespace neus;

namespace {

// Flat weight buffer, (out, in) row-major: wx, wn, wv (HC, 3), wf (HC, F),
// b0 (HC); hidden layers l = 1..NHC-1 as W (HC, HC) then b (HC); the head
// W (W, HC) then b (W).
struct ColOffsets {
  size_t wx, wn, wv, wf, b0, w[MAXNHC], b[MAXNHC], wh, bh, total;
};

__host__ __device__ inline ColOffsets col_offsets(const Dims& d) {
  ColOffsets o;
  size_t off = 0;
  o.wx = off; off += (size_t)d.HC * 3;
  o.wn = off; off += (size_t)d.HC * 3;
  o.wv = off; off += (size_t)d.HC * 3;
  o.wf = off; off += (size_t)d.HC * d.F;
  o.b0 = off; off += d.HC;
  for (int l = 1; l < d.NHC; ++l) {
    o.w[l] = off; off += (size_t)d.HC * d.HC;
    o.b[l] = off; off += d.HC;
  }
  o.wh = off; off += (size_t)d.W * d.HC;
  o.bh = off; off += d.W;
  o.total = off;
  return o;
}

// Per-CTA workspace (floats, MAXS rows each): the post-relu activations,
// the raw head and, in the backward, the cotangents.
struct ColWork {
  size_t acts[MAXNHC], head, chead, ca, cz, total;
};

__host__ __device__ inline ColWork col_work(const Dims& d, bool backward) {
  ColWork w;
  size_t off = 0;
  for (int l = 0; l < d.NHC; ++l) w.acts[l] = take_rows(off, d.HC);
  w.head = take_rows(off, d.W);
  w.chead = w.ca = w.cz = 0;
  if (backward) {
    w.chead = take_rows(off, d.W);
    w.ca = take_rows(off, d.HC);
    w.cz = take_rows(off, d.HC);
  }
  w.total = off;
  return w;
}

// forward states of the S = d.S points from row row0: acts[l], raw head
__device__ void colour_stack(GemmSmem& sm, const Dims& d, const float* wts,
                             const ColOffsets& o, float* ws, const ColWork& L, size_t row0,
                             const float* __restrict__ x, const float* __restrict__ n,
                             const float* __restrict__ v, const float* __restrict__ f) {
  const int S = d.S, HC = d.HC, tid = threadIdx.x;
  float* a0 = ws + L.acts[0];
  gemm(sm, S, HC, d.F, f + row0 * d.F, d.F, false, wts + o.wf, d.F, true, a0, HC, false,
       wts + o.b0);
  for (int e = tid; e < S * HC; e += NT) {
    const int r = e / HC, k = e % HC;
    const size_t p = (row0 + r) * 3;
    float z = a0[e];
    // the three 3-wide input dots, their operands rounded as gemm's
    auto op = [&](float t) { return d.bf16 ? round_bf16(t) : t; };
#pragma unroll
    for (int c = 0; c < 3; ++c)
      z += op(x[p + c]) * op(wts[o.wx + k * 3 + c]) + op(n[p + c]) * op(wts[o.wn + k * 3 + c]) +
           op(v[p + c]) * op(wts[o.wv + k * 3 + c]);
    a0[e] = fmaxf(z, 0.f);
  }
  __syncthreads();
  for (int l = 1; l < d.NHC; ++l) {
    float* a = ws + L.acts[l];
    gemm(sm, S, HC, HC, ws + L.acts[l - 1], HC, false, wts + o.w[l], HC, true, a, HC, false,
         wts + o.b[l]);
    for (int e = tid; e < S * HC; e += NT) a[e] = fmaxf(a[e], 0.f);
    __syncthreads();
  }
  gemm(sm, S, d.W, HC, ws + L.acts[d.NHC - 1], HC, false, wts + o.wh, HC, true, ws + L.head,
       d.W, false, wts + o.bh);
}

__global__ void __launch_bounds__(NT) colour_fwd_kernel(
    Dims d, const float* __restrict__ wts, const float* __restrict__ x,
    const float* __restrict__ n, const float* __restrict__ v, const float* __restrict__ f,
    int P, float* __restrict__ out, float* __restrict__ ws_all, long long ws_stride) {
  __shared__ GemmSmem sm;
  set_mode(sm, d);
  const ColOffsets o = col_offsets(d);
  const ColWork L = col_work(d, false);
  float* ws = ws_all + (size_t)blockIdx.x * ws_stride;
  const int n_blk = (P + MAXS - 1) / MAXS;
  for (int blk = blockIdx.x; blk < n_blk; blk += gridDim.x) {
    const size_t row0 = (size_t)blk * MAXS;
    Dims db = d;
    db.S = min(MAXS, P - (int)row0);
    colour_stack(sm, db, wts, o, ws, L, row0, x, n, v, f);
    for (int e = threadIdx.x; e < db.S * d.W; e += NT) {
      const float h = ws[L.head + e];
      out[row0 * d.W + e] = d.squeeze ? sigmoidf(h) : h;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT) colour_bwd_kernel(
    Dims d, const float* __restrict__ wts, const float* __restrict__ x,
    const float* __restrict__ n, const float* __restrict__ v, const float* __restrict__ f,
    int P, const float* __restrict__ c_out, float* __restrict__ dx, float* __restrict__ dn,
    float* __restrict__ dv, float* __restrict__ df, float* __restrict__ gpart,
    float* __restrict__ ws_all, long long ws_stride) {
  __shared__ GemmSmem sm;
  set_mode(sm, d);
  const ColOffsets o = col_offsets(d);
  const ColWork L = col_work(d, true);
  float* ws = ws_all + (size_t)blockIdx.x * ws_stride;
  float* gp = gpart + (size_t)blockIdx.x * o.total;
  const int HC = d.HC, tid = threadIdx.x;
  for (size_t e = tid; e < o.total; e += NT) gp[e] = 0.f;
  __syncthreads();
  const int n_blk = (P + MAXS - 1) / MAXS;
  for (int blk = blockIdx.x; blk < n_blk; blk += gridDim.x) {
    const size_t row0 = (size_t)blk * MAXS;
    Dims db = d;
    db.S = min(MAXS, P - (int)row0);
    const int S = db.S;
    colour_stack(sm, db, wts, o, ws, L, row0, x, n, v, f);
    for (int e = tid; e < S * d.W; e += NT) {
      float c = c_out[row0 * d.W + e];
      if (d.squeeze) {
        const float sg = sigmoidf(ws[L.head + e]);
        c *= sg * (1.f - sg);
      }
      ws[L.chead + e] = c;
    }
    __syncthreads();
    // head: dWh += chead^T a_last, dbh += sum chead, ca = chead Wh
    gemm(sm, d.W, HC, S, ws + L.chead, d.W, true, ws + L.acts[d.NHC - 1], HC, false, gp + o.wh,
         HC, true, nullptr);
    colsum_acc(S, d.W, ws + L.chead, d.W, gp + o.bh);
    gemm(sm, S, HC, d.W, ws + L.chead, d.W, false, wts + o.wh, HC, false, ws + L.ca, HC, false,
         nullptr);
    for (int l = d.NHC - 1; l >= 0; --l) {
      const float* act = ws + L.acts[l];
      for (int e = tid; e < S * HC; e += NT) ws[L.cz + e] = act[e] > 0.f ? ws[L.ca + e] : 0.f;
      __syncthreads();
      if (l == 0) break;
      gemm(sm, HC, HC, S, ws + L.cz, HC, true, ws + L.acts[l - 1], HC, false, gp + o.w[l], HC,
           true, nullptr);
      colsum_acc(S, HC, ws + L.cz, HC, gp + o.b[l]);
      gemm(sm, S, HC, HC, ws + L.cz, HC, false, wts + o.w[l], HC, false, ws + L.ca, HC, false,
           nullptr);
    }
    // first layer: the per-input weight gradients and input cotangents
    const float* cz = ws + L.cz;
    gemm(sm, HC, d.F, S, cz, HC, true, f + row0 * d.F, d.F, false, gp + o.wf, d.F, true, nullptr);
    gemm(sm, HC, 3, S, cz, HC, true, x + row0 * 3, 3, false, gp + o.wx, 3, true, nullptr);
    gemm(sm, HC, 3, S, cz, HC, true, n + row0 * 3, 3, false, gp + o.wn, 3, true, nullptr);
    gemm(sm, HC, 3, S, cz, HC, true, v + row0 * 3, 3, false, gp + o.wv, 3, true, nullptr);
    colsum_acc(S, HC, cz, HC, gp + o.b0);
    gemm(sm, S, d.F, HC, cz, HC, false, wts + o.wf, d.F, false, df + row0 * d.F, d.F, false,
         nullptr);
    gemm(sm, S, 3, HC, cz, HC, false, wts + o.wx, 3, false, dx + row0 * 3, 3, false, nullptr);
    gemm(sm, S, 3, HC, cz, HC, false, wts + o.wn, 3, false, dn + row0 * 3, 3, false, nullptr);
    gemm(sm, S, 3, HC, cz, HC, false, wts + o.wv, 3, false, dv + row0 * 3, 3, false, nullptr);
  }
}

}  // namespace

extern "C" {

// Dims fields read: F (feature width), HC, NHC, W (head width), squeeze.
long long colour_workspace_floats(Dims d, int backward) {
  return (long long)col_work(d, backward != 0).total;
}

// Forward: out (P, W) of the inputs x, n, v (P, 3) and f (P, F). ws is an
// (n_cta, ws_stride) scratch.
int colour_fwd(Dims d, const float* wts, const float* x, const float* n, const float* v,
               const float* f, int P, float* out, float* ws, long long ws_stride, int n_cta,
               void* stream) {
  colour_fwd_kernel<<<n_cta, NT, 0, (cudaStream_t)stream>>>(d, wts, x, n, v, f, P, out, ws,
                                                             ws_stride);
  return (int)cudaGetLastError();
}

// Backward: dx, dn, dv (P, 3), df (P, F) and the flat weight gradient d_w
// (weight_count floats). gpart is an (n_cta, weight_count) scratch.
int colour_bwd(Dims d, const float* wts, const float* x, const float* n, const float* v,
               const float* f, int P, const float* c_out, float* dx, float* dn, float* dv,
               float* df, float* d_w, float* gpart, float* ws, long long ws_stride, int n_cta,
               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  colour_bwd_kernel<<<n_cta, NT, 0, st>>>(d, wts, x, n, v, f, P, c_out, dx, dn, dv, df, gpart, ws,
                                           ws_stride);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return reduce_partials(gpart, n_cta, (long long)col_offsets(d).total, d_w, st);
}

}  // extern "C"
