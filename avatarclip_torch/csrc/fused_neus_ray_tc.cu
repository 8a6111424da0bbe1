// The NeuS kernels for Hopper (sm_90a) on the tensor cores, in the bf16
// operand mode: B1's per-ray pair, forward and backward, B3's point-level
// pair, B6's pair, B7's pair and #12's sdf-only forward (each below).
//
// B1 replaces the Pallas kernels avatarclip_tpu/ops/fused_neus.py
// `_fwd_kernel_ray` (:403) and `_bwd_kernel_ray` (:620) at their default
// operand type (fused_sdf._OPERAND_DTYPE = bf16: every dot's operands
// rounded to bf16, f32 accumulation). It computes what fused_neus_ray.cu
// computes (that pair stays as the f32 mode): per ray the points, the
// positional encoding, the SDF MLP with its analytic spatial gradient, the
// colour MLP, the cos-annealed alpha, the compositing and the eikonal
// partial sums; the backward recomputes the primal stacks, runs the
// compositing and alpha-chain VJP, the colour reverse and the
// forward-over-reverse SDF pass. Rounding points are JAX's: both operands of
// every forward, reverse, tangent and weight-gradient product; biases, the
// activations and their derivatives, the head's sdf row (JAX's f32 row
// forms), the alpha chain and the compositing stay f32.
//
// What bounds it on this card: the GEMMs, 1,186,304 FLOPs a point forward
// and 3,558,912 backward at 4x256 / 2x256 (0.96 / 2.89 ms at 12,544 x 64 at
// the 989 TFLOP/s bf16 tensor-core peak); f32 FMAs on the CUDA cores could
// not go below 14.2 / 42.6 ms. Under those, two floors the design does not
// remove (PERF.md, tools/profile_b1.py's phase counts): the epilogues
// (activations, the 16-bit scratch states, the log stores), which took as
// long as the product loops on mma.sync, and the weight stream: every
// product reads its packed weights from L2 for every tile, 1.20 MB a ray
// forward and 2.41 MB backward at 4x256 / 2x256 (the pack's k-steps x
// n-tiles x 256 bytes), 15.1 / 30.2 GB a call at 12,544 rays.
//
// Design (neus_tc.cuh):
// - one ray (64 rows) per tile, persistent CTAs (one per SM, 512 threads,
//   210-227 KB of dynamic shared memory at 256 wide) walking the rays;
// - every product on Hopper's warpgroup MMA (wgmma.mma_async.m64n64k16,
//   bf16 x bf16 -> f32): the 4 warpgroups each multiply the 64 rows by their
//   own 64 columns of a 256-column pass (a product too narrow for all four,
//   as the colour head's 8, goes to fewer). Activations stay in shared
//   memory (bf16, padded stride) and reach the products as register
//   fragments by ldmatrix; the weights, pre-packed in wgmma's K-major layout
//   with each warpgroup's slice of a pass contiguous, reach shared memory by
//   bulk copies completed on mbarriers, two k-steps a copy, into a ring of 3
//   slots a warpgroup. Each warpgroup's first thread is its producer: it
//   walks the kernel's fixed sequence of products (its plan) ahead of its
//   warpgroup, across product and ray boundaries, so the ring holds the
//   next product's first k-steps while an epilogue runs, and refills a slot
//   once its own warpgroup's wgmma on it has retired. No barrier inside a
//   k-loop and no hand-off between warpgroups there (on this card an
//   mbarrier hand-off between warps, or issuing a copy, costs more than a
//   k-step's products): one barrier after a product's epilogue (its output
//   is the next product's operand), and one before an epilogue that writes
//   over its own operand (gemm_fused's in-place case). Left as they were:
//   the epilogues and the L2 weight stream; a cluster of 2 CTAs that
//   multicasts each weight chunk would halve the stream;
// - epilogues read their inputs for four n-tiles (gemm_fused: one) at once,
//   then apply bias and activation and write the next layer's bf16 operand;
// - the states the later sweeps read (sigmoid factors, tangent
//   pre-activations, a_s) go to a per-CTA global scratch in 16 bits: a
//   sigmoid factor as the smaller of p and 1 - p in f16 with a side bit
//   (sig_load: both to 2^-11 of themselves), tangent pre-activations in
//   bf16, so that the 132 resident CTAs' scratch (~0.3 MB each at 4x256)
//   stays in L2. These roundings are not JAX's: the bf16 holds bound them;
// - the backward runs the rays in chunks (8 a CTA). Its per-ray kernel
//   writes the bf16 operands of every weight gradient (each layer's input
//   and input tangent, the cotangents on its outputs) once into a log, and
//   wgrad_kernel forms each dW = sum over the chunk's points of X^T Y as a
//   tensor-core GEMM split over the points (128 x 128 tiles, 32-row stages
//   by cp.async, ldmatrix.trans fragments); every split has its own f32
//   partial rows, summed by reduce_partials in a fixed order: no atomics,
//   the same sums every run. The per-ray kernel keeps only the bias, sdf-row
//   and inv_s sums in its own partial row;
// - the reverse products fuse the elementwise step that follows them into
//   their epilogue (gemm_fused): the relu masks of the colour net, the skip
//   and hidden layers' forward-over-reverse cotangents, with the bias sums
//   as fixed-order column sums; an SDF layer's two reverse products (the
//   cotangent and its tangent) share one weight stream (DUAL);
// - compositing and its VJP on one warp as scans over the ray's samples
//   (a product scan for the transmittance, an affine suffix scan for the
//   VJP's running term) instead of a serial loop on one thread.
//
// B3's forward in the bf16 mode (neus_point_tc_fwd) replaces
// avatarclip_tpu/ops/fused_neus.py `_fwd_kernel` (:258, launched by
// `_run_fwd` :882): B1's forward kernel body (neus_tc_fwd_kernel<true>)
// with a per-point epilogue in place of the compositing. Every sample's
// sdf, alpha, prev-CDF, inside flag, gradient and rgb go to device memory
// (48 B a point at rgb width 6, beside 1,186,304 GEMM FLOPs: bound by the
// products, 1.26 ms at 16,384 x 64 at the bf16 peak); alpha and the CDF from
// the f32 sdf row and gradient, as the CUDA-core kernel's.
//
// B3's backward in the bf16 mode (neus_point_tc_bwd) replaces
// avatarclip_tpu/ops/fused_neus.py `_bwd_kernel` (:534, launched by
// `_run_bwd` :1024): B1's backward body (neus_tc_bwd_kernel<true>) with the
// compositing VJP taken out. The per-point cotangents on sdf, alpha, cdf,
// gradient and rgb are read from memory where B1's compositing reverse
// produced them, and seed the same hand-written alpha-chain VJP, colour
// reverse and forward-over-reverse SDF pass; the weight gradients go
// through B1's log and wgrad_kernel. The work is B1's backward's, 3,558,912
// GEMM FLOPs a point at 4x256 / 2x256 (3.77 ms at 16,384 x 64 at the bf16
// peak), beside 80 bytes a point of cotangents and residuals read. Before
// this design it ran fused_neus_point.cu's CUDA-core kernel (one ray a
// block of its simple tiled GEMM, the states in a global workspace,
// rounding each staged operand), which stays as the f32 mode.
//
// B6's backward in the bf16 mode (sdf_tc_bwd) replaces
// avatarclip_tpu/ops/fused_sdf.py `_bwd_kernel` (:403, launched by
// `_run_bwd` :530): the SDF half of B1's backward (sdf_reverse_tc, shared)
// with the points read from memory in tiles of 64 (a ragged last tile
// zero-padded, with zero cotangents) and the per-point cotangents on sdf,
// feature and gradient seeding the reverse; its weight gradients go through
// the same log and wgrad_kernel (2,754,048 GEMM FLOPs a point: 2.24 ms at
// 802,816 points at the bf16 peak). The primal stack skips the head's
// feature rows, which the backward does not read.
//
// B6's forward in the bf16 mode (sdf_tc_fwd) replaces
// avatarclip_tpu/ops/fused_sdf.py `_fwd_kernel` (:261, launched by
// `_run_fwd` :343): B3's forward body (encode_points, sdf_primal_tc,
// gradient_sweep_tc) with the points read from memory in tiles of 64,
// stopped after the gradient sweep; the head's feature rows go to device
// memory in f32 from the head product's accumulators (FeatOut), and the sdf
// row is rounded, as JAX's sdf+gradient kernel rounds it. 918,016 GEMM
// FLOPs a point against 1,040 bytes out (the f32 feature): bound by the
// products, 0.75 ms at 802,816 points at the bf16 peak.
//
// #12, the sdf-only forward, in the bf16 mode (sdf_only_tc_fwd) replaces
// avatarclip_tpu/ops/fused_sdf.py `_sdf_only_kernel` (:626, under
// `_sdf_only_core` :682): a strict prefix of B6's forward (encode_points,
// then sdf_primal_tc with no state kept for a gradient sweep and no head
// product), then the head's sdf row summed in f32 from the unrounded a_s
// and encoding, as JAX's sdf-only kernel sums it. 393,728 GEMM FLOPs a
// point against 16 bytes (the point in, the sdf out) at 4x256: bound by the
// products, 0.104 ms a 262,144-point grid chunk at the bf16 peak. Its
// weights (the stack's forward forms alone) are packed per call.
//
// B7's backward in the bf16 mode (colour_tc_bwd) replaces
// avatarclip_tpu/ops/fused_color.py `_bwd_kernel` (:244, launched by
// `_run_bwd` :348): the colour half of B1's backward (colour_primal_tc with
// its activations logged, the head's sigmoid VJP, the relu layers' reverse
// products with their masks and bias sums in the epilogues) with the colour
// input read from memory in tiles of 64 as one bf16 tile over the mode's
// columns (the first layer one matrix, packed by ops/fused_neus.py's
// pack_colour_tc); layer 0's reverse product writes the four input
// cotangents in f32 from its accumulators, and the weight gradients go
// through the log and wgrad_kernel (Dims with H = 0: the colour regions and
// problems alone). 804,864 GEMM FLOPs a point against ~2.1 KB (the feature
// in, its cotangent out): 0.65 ms at 802,816 points at the bf16 peak, 0.5
// ms of bytes.
#include "neus_tc.cuh"

using namespace neus;
using namespace neus::tc;

namespace {

constexpr int RB = 8;  // rows read ahead of their stores in the column passes

// A column pass over ncol columns and the 64 rows by all TNT threads:
// thread (c, half) runs body(c, r0) over rows r0 .. r0 + 31 (r0 = 32 half),
// which returns its rows' sum of the column's cotangent; the bias gradient
// gets the two halves' sums in a fixed order. Ends with __syncthreads.
template <class Body>
__device__ __forceinline__ void column_pass(int ncol, float* red, float* bias_grad, Body body) {
  phase_mark(PH_OTHER);
  const int half = threadIdx.x / (TNT / 2), cc = threadIdx.x % (TNT / 2);
  for (int c0 = 0; c0 < ncol; c0 += TNT / 2) {
    const int c = c0 + cc;
    red[threadIdx.x] = c < ncol ? body(c, half * (ROWS / 2)) : 0.f;
    __syncthreads();
    if (half == 0 && c < ncol) bias_grad[c] += red[threadIdx.x] + red[threadIdx.x + TNT / 2];
    __syncthreads();
  }
  phase_mark(PH_COLPASS);
}

// fixed-order CTA sum of one value per thread (result valid in thread 0)
__device__ float cta_sum_tc(float v, float* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int st = TNT / 2; st > 0; st >>= 1) {
    if (tid < st) red[tid] += red[tid + st];
    __syncthreads();
  }
  const float s = red[0];
  __syncthreads();
  return s;
}

// encoding column j of a point p (3 floats): its value, and its first and
// second derivatives in the scaled coordinate
__device__ __forceinline__ void pe_eval(const Dims& d, const float* p, int j, float& val, float& dv,
                                        float& ddv) {
  int c, kind;
  float f;
  pe_column(j, c, f, kind);
  const float xs = p[c] * d.scale;
  if (kind == 0) {
    val = xs; dv = 1.f; ddv = 0.f;
  } else {
    const float sn = sinf(f * xs), cs = cosf(f * xs);
    if (kind == 1) { val = sn; dv = f * cs; ddv = -f * f * sn; }
    else { val = cs; dv = -f * sn; ddv = -f * f * cs; }
  }
}

// the encoding of the tile's points (in pts): eb = bf16 values with its
// padding columns zero; the forward also keeps the f32 values ef and
// derivatives de (the backward recomputes them where it needs them)
__device__ __forceinline__ void encode_points(const Dims& d, const Layout& L, unsigned char* sm,
                                              bool keep_f32) {
  const int tid = threadIdx.x;
  const float* pts = (const float*)(sm + L.pts);
  float* ef = (float*)(sm + L.ef);
  float* de = (float*)(sm + L.de);
  bf16* eb = (bf16*)(sm + L.eb);
  for (int e = tid; e < ROWS * L.ldE; e += TNT) {
    const int r = e / L.ldE, j = e % L.ldE;
    if (j >= d.E) { eb[e] = to_bf(0.f); continue; }
    float val, dv, ddv;
    pe_eval(d, pts + r * 3, j, val, dv, ddv);
    if (keep_f32) {
      ef[r * d.E + j] = val;
      de[r * d.E + j] = dv;
    }
    eb[e] = to_bf(val);
  }
  __syncthreads();
}

// the ray's points (zero past S), then their encoding
__device__ __forceinline__ void ray_points(const Dims& d, const Layout& L, unsigned char* sm, const float* ray,
                           const float* z, bool keep_f32) {
  float* pts = (float*)(sm + L.pts);
  for (int e = threadIdx.x; e < ROWS * 3; e += TNT) {
    const int r = e / 3, c = e % 3;
    pts[e] = r < d.S ? ray[c] + ray[3 + c] * z[r] : 0.f;
  }
  __syncthreads();
  encode_points(d, L, sm, keep_f32);
}

// SDF primal stack of the tile: hidden layers (outputs to hout(i), sigmoid
// factors to P), the skip-producing layer (u[:, :SW] = bf16(a_s), f32 a_s
// to AS, sigmoid to PS when given; ts = bf16(wsa * p_s) when given), the
// embedding half of u, then (when FOut::on) the head's feature rows through
// fout(r, c, value): into cin[:, 6:] as the colour net's bf16 operand
// (CinFeat: B1, B3), or B6's f32 feature output (FeatOut). xlog(i, ptr, ld)
// true: hidden output i (i < NH), and u (i = -1), are also copied to the
// log at ptr (stride ld). STATES false (#12's sdf-only forward, which no
// gradient sweep follows): no sigmoid factor is computed or kept (P, PS and
// ts are not written), only the softplus values.
struct NoLog {
  __device__ bool operator()(int, bf16*&, int&) const { return false; }
};
struct NoFeat {
  static constexpr bool on = false;
  __device__ void operator()(int, int, float) const {}
};
struct CinFeat {
  static constexpr bool on = true;
  bf16* cin;
  int ldC;
  __device__ void operator()(int r, int c, float v) const { cin[r * ldC + 6 + c] = to_bf(v); }
};

__device__ inline void put(float* p, float v) { *p = v; }
__device__ inline void put(f16* p, float v) { *p = __float2half_rn(v); }

template <bool STATES = true, class Hout, class ASt, class XLog, class FOut>
__device__ __forceinline__ void sdf_primal_tc(const Dims& d, const Layout& L, unsigned char* sm,
                                              Ring& rg, const float* wts, const WeightOffsets& wo,
                                              f16* P, ASt* AS, f16* PS, bf16* ts, Hout hout,
                                              XLog xlog, FOut fout) {
  const int H = d.H, SW = d.SW, ldX = L.ldX;
  const bf16* in = (const bf16*)(sm + L.eb);
  int ld_in = L.ldE;
  for (int i = 0; i < d.NH; ++i) {
    const float* bias = wts + wo.sb[i];
    f16* Pi = STATES ? P + (size_t)i * ROWS * H : nullptr;
    bf16* out = hout(i);
    phase_tag(0);
    gemm_rows_pre(rg, in, ld_in, sdf_in(d, i), FS + i, H,
                  [&](int, int c) { return c < H ? bias[c] : 0.f; },
                  [&](int r, int c, float v, float b) {
      if (!STATES) {
        const float sp = sp_fast(v + b);
        if (c < H) out[r * ldX + c] = to_bf(sp);
        return;
      }
      float sp, sg;  // computed for every column, stored for c < H: no branch
      f16 sk;
      sp_sig_fast(v + b, sp, sg, sk);
      if (c < H) {
        out[r * ldX + c] = to_bf(sp);
        Pi[r * H + c] = sk;
      }
    });
    bf16* lp;
    int lld;
    if (xlog(i, lp, lld)) log_put(lp, lld, out, ldX, H);
    in = out;
    ld_in = ldX;
  }
  bf16* u = (bf16*)(sm + L.u);
  const float* bs = wts + wo.sb[d.NH];
  const float* w0 = wts + wo.sw[d.NH + 1];  // the head's sdf row
  phase_tag(1);
  gemm_rows_pre(rg, in, ldX, H, FS + d.NH, SW,
                [&](int, int c) { return c < SW ? make_float2(bs[c], w0[c]) : make_float2(0.f, 0.f); },
                [&](int r, int c, float v, float2 bw) {
    if (!STATES) {
      if (c < SW) {
        const float sp = sp_fast(v + bw.x);
        u[r * ldX + c] = to_bf(sp);
        put(AS + r * SW + c, sp);
      }
      return;
    }
    float sp, sg;
    f16 sk;
    sp_sig_fast(v + bw.x, sp, sg, sk);
    const bool in = c < SW;
    if (ts) ts[r * ldX + c] = to_bf(in ? bw.y * RSQRT2 * sg : 0.f);
    if (in) {
      u[r * ldX + c] = to_bf(sp);
      put(AS + r * SW + c, sp);
      if (PS) PS[r * SW + c] = sk;
    }
  });
  const bf16* eb = (const bf16*)(sm + L.eb);
  for (int e = threadIdx.x; e < ROWS * d.E; e += TNT) {
    const int r = e / d.E, j = e % d.E;
    u[r * ldX + SW + j] = eb[r * L.ldE + j];
  }
  __syncthreads();
  {
    bf16* lp;
    int lld;
    if (xlog(-1, lp, lld)) log_put(lp, lld, u, ldX, H);
  }
  if (!FOut::on) return;
  const float* bf = wts + wo.sb[d.NH + 1] + 1;
  phase_tag(2);
  gemm_rows_pre(rg, u, ldX, H, FHEAD, d.F,
                [&](int, int c) { return c < d.F ? bf[c] : 0.f; },
                [&](int r, int c, float v, float b) {
                  if (c < d.F) fout(r, c, v + b);
                });
}

// colour primal: relu layers (outputs to aout(l), and to the log when
// alog(l, ptr, ld)), the raw head into head
template <class Aout, class ALog = NoLog>
__device__ __forceinline__ void colour_primal_tc(const Dims& d, const Layout& L, unsigned char* sm,
                                                 Ring& rg, const float* wts,
                                                 const WeightOffsets& wo, Aout aout,
                                                 ALog alog = NoLog()) {
  const bf16* x = (const bf16*)(sm + L.cin);
  int ldx = L.ldC;
  for (int l = 0; l < d.NHC; ++l) {
    const float* bias = wts + wo.cb[l];
    bf16* a = aout(l);
    const int ldX = L.ldX, HC = d.HC;
    phase_tag(3);
    gemm_rows_pre(rg, x, ldx, col_in(d, l), FC + l, HC,
                  [&](int, int c) { return c < HC ? bias[c] : 0.f; },
                  [&](int r, int c, float v, float b) {
      if (c < HC) a[r * ldX + c] = to_bf(fmaxf(v + b, 0.f));
    });
    bf16* lp;
    int lld;
    if (alog(l, lp, lld)) log_put(lp, lld, a, ldX, HC);
    x = a;
    ldx = L.ldX;
  }
  float* head = (float*)(sm + L.head);
  const float* bh = wts + wo.cb[d.NHC];
  phase_tag(3);
  gemm_rows_pre(rg, x, ldx, d.HC, FC + d.NHC, d.W,
                [&](int, int c) { return c < d.W ? bh[c] : 0.f; },
                [&](int r, int c, float v, float b) {
                  if (c < d.W) head[r * 8 + c] = v + b;
                });
}

// The tile's spatial gradient into g (ROWS x 3, shared memory), after
// sdf_primal_tc: the reverse sweep from ts (bf16(w0 / sqrt2 * p_s)) through
// the skip and hidden layers, each product's epilogue applying the next
// sigmoid factor (P), the embedding's cotangents into qe, then the chain
// rule through the encoding (de) with the head's direct embedding term. ts
// and skip_in (the skip layer's input, free by now) ping-pong. Shared by
// B1's and B3's forward (neus_tc_fwd_kernel) and B6's (sdf_tc_fwd_kernel).
// Ends with __syncthreads.
__device__ __forceinline__ void gradient_sweep_tc(const Dims& d, const Layout& L, unsigned char* sm,
                                                  Ring& rg, const float* wts,
                                                  const WeightOffsets& wo, const f16* P, bf16* ts,
                                                  bf16* skip_in) {
  const int H = d.H, SW = d.SW, E = d.E, ldX = L.ldX;
  float* g = (float*)(sm + L.g);
  float* qe = (float*)(sm + L.qe);
  const bf16* cur = ts;
  bf16* nxt = skip_in;
  for (int i = d.NH; i >= 0; --i) {
    const int K = i == d.NH ? SW : H, N = i == 0 ? E : H;
    if (i > 0) {
      const f16* Pm = P + (size_t)(i - 1) * ROWS * H;
      bf16* o = nxt;
      phase_tag(11);
      gemm_rows_pre(
          rg, cur, ldX, K, RS + i, N,
          [&](int r, int c) {
            float p = 0.f, q;
            if (c < N) sig_load(Pm[r * H + c], p, q);
            return p;
          },
          [&](int r, int c, float v, float p) {
            if (c < N) o[r * ldX + c] = to_bf(v * p);
          });
      nxt = (bf16*)cur;
      cur = o;
    } else {
      phase_tag(11);
      gemm_rows(rg, cur, ldX, K, RS + 0, N, [&](int r, int c, float v) {
        if (c < N) qe[r * E + c] = v;
      });
    }
  }
  const float* de = (const float*)(sm + L.de);
  const float* w0e = wts + wo.sw[d.NH + 1] + SW;
  for (int e = threadIdx.x; e < ROWS * 3; e += TNT) {
    const int r = e / 3, c = e % 3;
    float acc = 0.f;
    for (int j = c; j < E; j += 3) acc += (qe[r * E + j] + w0e[j] * RSQRT2) * de[r * E + j];
    g[e] = acc;
  }
  __syncthreads();
}

// the forward's outputs: sdf and gradient per point (B1's residuals, B3's
// outputs), then B1's per-ray compositing or B3's per-point quantities
struct FwdOut {
  float *sdf, *g;
  float *col_w, *normals_w, *wsum;   // B1
  float *alpha, *cdf, *inside, *rgb;  // B3
};

// The forward of B1 (POINT false: the compositing) and of B3 (POINT true:
// every sample's quantities to device memory), one body.
template <bool POINT>
__global__ void __launch_bounds__(TNT, 1) neus_tc_fwd_kernel(
    Dims d, Pack pp, const float* __restrict__ wts, const uint2* __restrict__ pk,
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ mid_z, const float* __restrict__ dists,
    const float* __restrict__ inv_s_ptr, float cos_r, int R, FwdOut out,
    float* __restrict__ eik_part, unsigned char* __restrict__ scr_all, long long scr_stride) {
  extern __shared__ __align__(128) unsigned char sm[];
  const Layout L = tc_layout(d, false);
  const WeightOffsets wo = weight_offsets(d);
  unsigned char* scr = scr_all + (size_t)blockIdx.x * scr_stride;
  f16* P = (f16*)(scr + L.P);
  float* AS = (float*)(scr + L.AS);
  const int S = d.S, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int SW = d.SW, E = d.E;
  const float inv_s = *inv_s_ptr;
  phase_start();
  float* ray = (float*)(sm + L.ray);
  float* pts = (float*)(sm + L.pts);
  float* g = (float*)(sm + L.g);
  float* alpha = (float*)(sm + L.alpha);
  float* srow = (float*)(sm + L.srow);
  float* head = (float*)(sm + L.head);
  bf16* ha = (bf16*)(sm + L.ha);
  bf16* hb = (bf16*)(sm + L.hb);
  bf16* cin = (bf16*)(sm + L.cin);
  // every bf16 operand buffer starts zero: padding columns are never written
  for (size_t e = tid; e < L.smem / 4; e += TNT) ((float*)sm)[e] = 0.f;
  __syncthreads();
  Ring rg = ring_init(sm + L.ring, sm + L.rbar, d, pp, pk, PLAN_RAY_FWD,
                      tiles_of(R, blockIdx.x, gridDim.x));
  float eik_num = 0.f, eik_den = 0.f;
  for (int rid = blockIdx.x; rid < R; rid += gridDim.x) {
    if (tid < 3) {
      ray[tid] = rays_o[rid * 3 + tid];
      ray[3 + tid] = rays_d[rid * 3 + tid];
    }
    __syncthreads();
    ray_points(d, L, sm, ray, mid_z + (size_t)rid * S, true);
    // hidden layers alternate ha / hb; ts (the sweep's first operand) takes
    // the buffer the skip layer does not read
    bf16* skip_in = (d.NH % 2) ? ha : hb;
    bf16* ts = skip_in == ha ? hb : ha;
    sdf_primal_tc(d, L, sm, rg, wts, wo, P, AS, (f16*)nullptr, ts,
                  [&](int i) { return (i % 2) ? hb : ha; }, NoLog(), CinFeat{cin, L.ldC});
    // the head's sdf row in f32: four threads a row, fixed order
    if (tid < 4 * ROWS) {
      const float* w0 = wts + wo.sw[d.NH + 1];
      const float* ef = (const float*)(sm + L.ef);
      const int r = tid >> 2, q = tid & 3;
      float acc = 0.f;
      for (int k = q; k < SW; k += 4) acc += AS[r * SW + k] * w0[k];
      for (int j = q; j < E; j += 4) acc += ef[r * E + j] * w0[SW + j];
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (q == 0) srow[r] = acc * RSQRT2 + wts[wo.sb[d.NH + 1]];
    }
    gradient_sweep_tc(d, L, sm, rg, wts, wo, P, ts, skip_in);
    for (int e = tid; e < ROWS * 6; e += TNT) {
      const int r = e / 6, c = e % 6;
      cin[r * L.ldC + c] = to_bf(c < 3 ? pts[r * 3 + c] : g[r * 3 + c - 3]);
    }
    __syncthreads();
    colour_primal_tc(d, L, sm, rg, wts, wo, [&](int l) { return (l % 2) ? hb : ha; });
    phase_mark(PH_OTHER);
    for (int r = tid; r < S; r += TNT) {
      const float* gr = g + r * 3;
      const float* p = pts + r * 3;
      const float s = srow[r] / d.scale;
      const float tc = ray[3] * gr[0] + ray[4] * gr[1] + ray[5] * gr[2];
      const Chain c = alpha_chain(s, tc, dists[(size_t)rid * S + r], inv_s, cos_r);
      alpha[r] = c.alpha;
      const float r2 = p[0] * p[0] + p[1] * p[1] + p[2] * p[2];
      const float relax = r2 < 1.44f ? 1.f : 0.f;
      const float n = sqrtf(gr[0] * gr[0] + gr[1] * gr[1] + gr[2] * gr[2] + 1e-12f);
      eik_num += relax * (n - 1.f) * (n - 1.f);
      eik_den += relax;
      const size_t pt = (size_t)rid * S + r;
      out.sdf[pt] = s;
      out.g[pt * 3 + 0] = gr[0];
      out.g[pt * 3 + 1] = gr[1];
      out.g[pt * 3 + 2] = gr[2];
      if (POINT) {
        out.alpha[pt] = c.alpha;
        out.cdf[pt] = c.P;
        out.inside[pt] = r2 < 1.f ? 1.f : 0.f;
      }
    }
    if (POINT) {
      const int W = d.W;
      float* rgb = out.rgb + (size_t)rid * S * W;
      for (int e = tid; e < S * W; e += TNT) rgb[e] = rgb_of(d, head[(e / W) * 8 + e % W]);
      __syncthreads();
      phase_mark(PH_COMPOSITE);
      continue;
    }
    __syncthreads();
    if (warp == 0) {
      // transmittance: exclusive prefix product of x = 1 - alpha + 1e-7 over
      // the samples, lane k holding samples k and k + 32
      const int k0 = lane, k1 = lane + 32;
      const float x0 = k0 < S ? 1.f - alpha[k0] + 1e-7f : 1.f;
      const float x1 = k1 < S ? 1.f - alpha[k1] + 1e-7f : 1.f;
      const float p0 = warp_prod_scan(x0), p1 = warp_prod_scan(x1);
      const float tot0 = __shfl_sync(0xffffffffu, p0, 31);
      const float e0 = __shfl_up_sync(0xffffffffu, p0, 1), e1 = __shfl_up_sync(0xffffffffu, p1, 1);
      const float T0 = lane == 0 ? 1.f : e0;
      const float T1 = tot0 * (lane == 0 ? 1.f : e1);
      const float w0 = k0 < S ? alpha[k0] * T0 : 0.f;
      const float w1 = k1 < S ? alpha[k1] * T1 : 0.f;
      for (int ch = 0; ch < d.W + 4; ++ch) {
        auto val = [&](int k) {
          if (ch < d.W) return rgb_of(d, head[k * 8 + ch]);
          if (ch < d.W + 3) return g[k * 3 + ch - d.W];
          return 1.f;
        };
        const float v = warp_sum(w0 * val(k0) + w1 * val(k1));
        if (lane == 0) {
          if (ch < d.W) out.col_w[(size_t)rid * d.W + ch] = v;
          else if (ch < d.W + 3) out.normals_w[(size_t)rid * 3 + ch - d.W] = v;
          else out.wsum[rid] = v;
        }
      }
    }
    __syncthreads();
    phase_mark(PH_COMPOSITE);
  }
  float* red = (float*)(sm + L.red);
  const float num = cta_sum_tc(eik_num, red);
  const float den = cta_sum_tc(eik_den, red);
  if (tid == 0) {
    eik_part[blockIdx.x * 2 + 0] = num;
    eik_part[blockIdx.x * 2 + 1] = den;
  }
  phase_end(POINT ? PK_POINT_FWD : PK_RAY_FWD);
}

// Forward-over-reverse through the SDF stack of one tile, shared by B1's
// backward (after its colour reverse) and B6's. Reads from shared memory
// the tile's points (pts), the cotangents on the spatial gradient (cg: the
// tangent direction), on the sdf in net units (cs) and on the feature (CF,
// the bf16 operand in cin's room, stride ldF), and from scratch the primal
// states (P, AS, PS); the tangent stack along cg (into ZD, ZDS), the sdf
// row's weight gradients in f32, the head reverse, the hidden layers'
// reverse pairs, then the embedding cotangents into dx, the cotangent on
// the raw points (plus ccin6's point columns when given). Every
// weight-gradient operand goes to the log through lput(m, src, ld, ncols);
// the biases and the sdf row to gp. Rows with zero cotangents add nothing.
// Ends with __syncthreads.
template <class LPut>
__device__ __forceinline__ void sdf_reverse_tc(const Dims& d, const Layout& L, unsigned char* sm,
                                               Ring& rg, const float* wts,
                                               const WeightOffsets& wo, const f16* P,
                                               const f16* AS, bf16* ZD, const f16* PS, bf16* ZDS,
                                               float* CH, float* CHD, float* gp, LPut lput,
                                               const float* ccin6) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = d.H, SW = d.SW, E = d.E, F = d.F;
  const int ldX = L.ldX, ldE = L.ldE, ldF = L.ldF;
  const float* pts = (const float*)(sm + L.pts);
  bf16* tb0 = (bf16*)(sm + L.tb0);
  bf16* cz = (bf16*)(sm + L.ha);
  bf16* czd = (bf16*)(sm + L.hb);
  const bf16* CF = (const bf16*)(sm + L.cin);
  const float* cg = (const float*)(sm + L.cg);
  const float* cs = (const float*)(sm + L.cs);
  float* dx = (float*)(sm + L.dx);
  float* cue = (float*)(sm + L.cue);
  const float* wfin = wts + wo.sw[d.NH + 1];
  float* red = (float*)(sm + L.red);
  for (int e = tid; e < ROWS * E; e += TNT) {
    const int r = e / E, j = e % E;
    float val, dv, ddv;
    pe_eval(d, pts + r * 3, j, val, dv, ddv);
    tb0[r * ldE + j] = to_bf(dv * cg[r * 3 + (j % 3)]);
  }
  __syncthreads();
  lput(LG_TB0, tb0, ldE, E);
  {
    // tangents ping-pong in cz / czd, with a copy in the log
    const bf16* tin = tb0;
    int ld_in = ldE;
    for (int i = 0; i < d.NH; ++i) {
      const f16* Pi = P + (size_t)i * ROWS * H;
      bf16* ZDi = ZD + (size_t)i * ROWS * H;
      bf16* to = (i % 2) ? czd : cz;
      phase_tag(6);
      gemm_rows_pre(
          rg, tin, ld_in, sdf_in(d, i), FS + i, H,
          [&](int r, int c) {
            float p = 0.f, q;
            if (c < H) sig_load(Pi[r * H + c], p, q);
            return p;
          },
          [&](int r, int c, float v, float p) {
            if (c < H) {
              ZDi[r * H + c] = to_bf(v);
              to[r * ldX + c] = to_bf(p * v);
            }
          });
      lput(LG_TI + i, to, ldX, H);
      tin = to;
      ld_in = ldX;
    }
    phase_tag(7);
    gemm_rows(rg, tin, ldX, H, FS + d.NH, SW, [&](int r, int c, float v) {
      if (c < SW) ZDS[r * SW + c] = to_bf(v);
    });
  }
  lput(LG_CF, CF, ldF, F);
  // the sdf row's weights in f32: sum_r cs u + udot, u = [a_s, e], udot = [p_s zd_s, t0]
  column_pass(H, red, gp + wo.sw[d.NH + 1], [&](int k, int rb) {
    float acc = 0.f;
    if (k < SW) {
      for (int r0 = rb; r0 < rb + ROWS / 2; r0 += RB) {
        f16 ps[RB], as[RB];
        bf16 zd[RB];
#pragma unroll
        for (int q = 0; q < RB; ++q) {
          ps[q] = PS[(r0 + q) * SW + k];
          as[q] = AS[(r0 + q) * SW + k];
          zd[q] = ZDS[(r0 + q) * SW + k];
        }
#pragma unroll
        for (int q = 0; q < RB; ++q) {
          float p, pq;
          sig_load(ps[q], p, pq);
          acc += cs[r0 + q] * __half2float(as[q]) + p * __bfloat162float(zd[q]);
        }
      }
    } else {
      const int j = k - SW;
      for (int r = rb; r < rb + ROWS / 2; ++r) {
        float val, dv, ddv;
        pe_eval(d, pts + r * 3, j, val, dv, ddv);
        acc += cs[r] * val + dv * cg[r * 3 + (j % 3)];
      }
    }
    return acc * RSQRT2;
  });
  if (warp == 0) {  // the sdf row's bias
    const float v = warp_sum(cs[lane] + cs[lane + 32]);
    if (lane == 0) gp[wo.sb[d.NH + 1]] += v;
  }
  // the head's reverse product (the feature cotangents, plus the sdf row's
  // share cs w0 / sqrt2) with the skip layer's cotangents in its epilogue:
  // cu = v + cs cad, zc = cu p_s + cad zd_s 100 p_s (1 - p_s), zcd = cad
  // p_s (cad = w0 / sqrt2), summed into the skip bias; the embedding half
  // of cu to cue
  phase_tag(8);
  gemm_fused<false>(
      rg, CF, nullptr, ldF, F, RHEAD, H, red, gp + wo.sb[d.NH], 0, SW,
      [&](int r, int c) {
        float p = 0.f, q = 0.f, zd = 0.f;
        if (c < SW) {
          sig_load(PS[r * SW + c], p, q);
          zd = __bfloat162float(ZDS[r * SW + c]);
        }
        return make_float3(p, q, zd);
      },
      [&](int r, int c, float v, float, float3 s3) {
        if (c >= H) return 0.f;
        const float cad = wfin[c] * RSQRT2;
        const float cu = v + cs[r] * cad;
        if (c >= SW) {
          cue[r * E + c - SW] = cu;
          if (c < pad16(SW)) cz[r * ldX + c] = czd[r * ldX + c] = to_bf(0.f);
          return 0.f;
        }
        const float zc = cu * s3.x + cad * s3.z * 100.f * s3.x * s3.y;
        cz[r * ldX + c] = to_bf(zc);
        czd[r * ldX + c] = to_bf(cad * s3.x);
        return zc;
      });
  lput(LG_CZ + d.NH, cz, ldX, SW);
  lput(LG_CZD + d.NH, czd, ldX, SW);
  // hidden layers: layer i + 1's two reverse products (cotangent and its
  // tangent) in one weight stream, whose epilogue forms layer i's
  // cotangents in place, zc = ch p + chd zd 100 p (1 - p) and zcd = chd p,
  // and sums zc into its bias gradient
  for (int i = d.NH - 1; i >= 0; --i) {
    const f16* Pi = P + (size_t)i * ROWS * H;
    const bf16* ZDi = ZD + (size_t)i * ROWS * H;
    phase_tag(9);
    gemm_fused<true>(
        rg, cz, czd, ldX, i + 1 == d.NH ? SW : H, RS + i + 1, H, red, gp + wo.sb[i], 0, H,
        [&](int r, int c) {
          float p = 0.f, q = 0.f, zd = 0.f;
          if (c < H) {
            sig_load(Pi[r * H + c], p, q);
            zd = __bfloat162float(ZDi[r * H + c]);
          }
          return make_float3(p, q, zd);
        },
        [&](int r, int c, float ch, float chd, float3 s3) {
          if (c >= H) return 0.f;
          const float zc = ch * s3.x + chd * s3.z * 100.f * s3.x * s3.y;
          cz[r * ldX + c] = to_bf(zc);
          czd[r * ldX + c] = to_bf(chd * s3.x);
          return zc;
        });
    lput(LG_CZ + i, cz, ldX, H);
    lput(LG_CZD + i, czd, ldX, H);
  }
  // layer 0's reverse products: the embedding cotangents
  phase_tag(10);
  gemm_fused<true>(rg, cz, czd, ldX, H, RS + 0, E, red, nullptr, 0, 0,
                   NoPre(), [&](int r, int c, float ch, float chd, float) {
                                 if (c < E) {
                                   CH[r * E + c] = ch;
                                   CHD[r * E + c] = chd;
                                 }
                                 return 0.f;
                               });
  // embedding cotangents -> raw point cotangent
  for (int e = tid; e < ROWS * 3; e += TNT) {
    const int r = e / 3, c = e % 3;
    const float v = cg[e];
    float acc = 0.f;
    for (int j = c; j < E; j += 3) {
      float val, dv, ddv;
      pe_eval(d, pts + r * 3, j, val, dv, ddv);
      const float ce = CH[r * E + j] + cue[r * E + j];
      const float ced = CHD[r * E + j] + wfin[SW + j] * RSQRT2;
      acc += ce * dv + ced * v * ddv;
    }
    dx[e] = acc * d.scale + (ccin6 ? ccin6[r * 6 + c] : 0.f);
  }
  __syncthreads();
}

// The backward's cotangents: B1's on its per-ray outputs, or B3's on its
// per-point outputs (P = R S points, ray-major), and the eikonal pair's.
struct BwdCots {
  const float *col, *nw, *ws;                     // B1: (R, W), (R, 3), (R, 1)
  const float *sdf, *alpha, *cdf, *grad, *rgb;    // B3: (P,), (P,), (P,), (P, 3), (P, W)
  const float* eik;                               // (2,): [num, den]
};

// The backward of B1 (POINT false: the compositing VJP seeds the alpha
// chain, the colour and the gradient cotangents) and of B3 (POINT true: the
// per-point cotangents read from memory seed them), one body.
template <bool POINT>
__global__ void __launch_bounds__(TNT, 1) neus_tc_bwd_kernel(
    Dims d, Pack pp, const float* __restrict__ wts, const uint2* __restrict__ pk,
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ mid_z, const float* __restrict__ dists,
    const float* __restrict__ inv_s_ptr, float cos_r, int R, const float* __restrict__ sdf_res,
    const float* __restrict__ g_res, BwdCots ct, float* __restrict__ d_o, float* __restrict__ d_d,
    float* __restrict__ d_z, float* __restrict__ d_t, float* __restrict__ gpart,
    unsigned char* __restrict__ scr_all, long long scr_stride, WLog lg, bf16* __restrict__ log,
    long long log_rows, int ray0, int ray1) {
  extern __shared__ __align__(128) unsigned char sm[];
  const Layout L = tc_layout(d, true);
  const WeightOffsets wo = weight_offsets(d);
  unsigned char* scr = scr_all + (size_t)blockIdx.x * scr_stride;
  float* gp = gpart + (size_t)blockIdx.x * (wo.total + 1);
  const int S = d.S, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int E = d.E, F = d.F, HC = d.HC, CW = d.CW, W = d.W;
  const int ldX = L.ldX, ldE = L.ldE, ldC = L.ldC, ldF = L.ldF;
  const float inv_s = *inv_s_ptr;
  const float c_num = ct.eik[0];
  phase_start();
  float* ray = (float*)(sm + L.ray);
  float* pts = (float*)(sm + L.pts);
  float* g = (float*)(sm + L.g);
  const bf16* eb = (const bf16*)(sm + L.eb);
  bf16* cin = (bf16*)(sm + L.cin);
  bf16* cz = (bf16*)(sm + L.ha);
  bf16* czd = (bf16*)(sm + L.hb);
  float* head = (float*)(sm + L.head);
  float* chead = (float*)(sm + L.chead);
  bf16* cheadb = (bf16*)(sm + L.cheadb);
  const int ldHd = ld_of(8);
  float* alpha = (float*)(sm + L.alpha);
  float* wgt = (float*)(sm + L.w);
  float* Tr = (float*)(sm + L.tr);
  float* calpha = (float*)(sm + L.calpha);
  float* cg = (float*)(sm + L.cg);
  float* cdir = (float*)(sm + L.cdir);
  float* dx = (float*)(sm + L.dx);
  float* cs = (float*)(sm + L.cs);
  f16* P = (f16*)(scr + L.P);
  f16* AS = (f16*)(scr + L.AS);
  bf16* ZD = (bf16*)(scr + L.ZD);
  f16* PS = (f16*)(scr + L.PS);
  bf16* ZDS = (bf16*)(scr + L.ZDS);
  float* CH = (float*)(scr + L.CH);
  float* CHD = (float*)(scr + L.CHD);
  float* ccin6 = (float*)(sm + L.ccin6);
  float* red = (float*)(sm + L.red);
  // gp: zero from the caller, summed over the chunks
  for (size_t e = tid; e < L.smem / 4; e += TNT) ((float*)sm)[e] = 0.f;
  __syncthreads();
  Ring rg = ring_init(sm + L.ring, sm + L.rbar, d, pp, pk, PLAN_RAY_BWD,
                      tiles_of(ray1 - ray0, blockIdx.x, gridDim.x));
  float civ = 0.f;
  for (int rid = ray0 + blockIdx.x; rid < ray1; rid += gridDim.x) {
    // this ray's rows of log region m, and its stride
    const long long q0 = (long long)(rid - ray0) * ROWS;
    auto lp = [&](int m) { return log_at(log, lg, log_rows, m, q0); };
    auto lput = [&](int m, const bf16* src, int lds, int ncols) { log_put(lp(m), lg.ld[m], src, lds, ncols); };
    auto to_log = [&](int base) {
      return [&, base](int i, bf16*& p, int& ld) {
        const int m = i < 0 ? LG_U : base + i;
        p = lp(m);
        ld = lg.ld[m];
        return true;
      };
    };
    if (tid < 3) {
      ray[tid] = rays_o[rid * 3 + tid];
      ray[3 + tid] = rays_d[rid * 3 + tid];
    }
    __syncthreads();
    const float* z = mid_z + (size_t)rid * S;
    ray_points(d, L, sm, ray, z, false);
    lput(LG_EB, eb, ldE, E);
    // ---- primal stacks (the gradient and sdf are the forward's residuals);
    // the hidden and colour activations ping-pong in shared memory, with a
    // copy in the log for the weight gradients
    sdf_primal_tc(d, L, sm, rg, wts, wo, P, AS, PS, nullptr,
                  [&](int i) { return (i % 2) ? czd : cz; }, to_log(LG_X), CinFeat{cin, ldC});
    for (int e = tid; e < ROWS * 3; e += TNT) {
      const int r = e / 3;
      g[e] = r < S ? g_res[(size_t)rid * S * 3 + e] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < ROWS * 6; e += TNT) {
      const int r = e / 6, c = e % 6;
      cin[r * ldC + c] = to_bf(c < 3 ? pts[r * 3 + c] : g[r * 3 + c - 3]);
    }
    for (int r = tid; r < S && !POINT; r += TNT) {
      const float* gr = g + r * 3;
      const float tc = ray[3] * gr[0] + ray[4] * gr[1] + ray[5] * gr[2];
      alpha[r] = alpha_chain(sdf_res[(size_t)rid * S + r], tc, dists[(size_t)rid * S + r], inv_s,
                             cos_r).alpha;
    }
    __syncthreads();
    lput(LG_CIN, cin, ldC, CW);
    colour_primal_tc(d, L, sm, rg, wts, wo, [&](int l) { return (l % 2) ? czd : cz; },
                     to_log(LG_ACT));
    // ---- compositing VJP on warp 0: L = sum_k w_k u_k, w_k = alpha_k T_k,
    // dL/dalpha_k = T_k (u_k - B_k) with B_{k-1} = u_k alpha_k + x_k B_k
    // (an affine suffix scan), lane k holding samples k and k + 32
    phase_mark(PH_OTHER);
    if (!POINT && warp == 0) {
      float x[2], a[2], uu[2], T[2], M[2], C[2];
      for (int h = 0; h < 2; ++h) {
        const int k = lane + 32 * h;
        const bool ok = k < S;
        x[h] = ok ? 1.f - alpha[k] + 1e-7f : 1.f;
        float uk = 0.f;
        if (ok) {
          uk = ct.ws[rid];
          for (int ch = 0; ch < W; ++ch)
            uk += ct.col[(size_t)rid * W + ch] * rgb_of(d, head[k * 8 + ch]);
          for (int c = 0; c < 3; ++c) uk += ct.nw[(size_t)rid * 3 + c] * g[k * 3 + c];
        }
        uu[h] = uk;
        a[h] = ok ? uk * alpha[k] : 0.f;
        M[h] = x[h];
        C[h] = a[h];
      }
      const float p0 = warp_prod_scan(x[0]), p1 = warp_prod_scan(x[1]);
      const float tot0 = __shfl_sync(0xffffffffu, p0, 31);
      const float e0 = __shfl_up_sync(0xffffffffu, p0, 1), e1 = __shfl_up_sync(0xffffffffu, p1, 1);
      T[0] = lane == 0 ? 1.f : e0;
      T[1] = tot0 * (lane == 0 ? 1.f : e1);
      for (int h = 0; h < 2; ++h)
        for (int o = 1; o < 32; o <<= 1) {
          const float m2 = __shfl_down_sync(0xffffffffu, M[h], o);
          const float c2 = __shfl_down_sync(0xffffffffu, C[h], o);
          if (lane + o < 32) {
            C[h] = C[h] + M[h] * c2;
            M[h] = M[h] * m2;
          }
        }
      // F_k = B_{k-1}: half 1 ends at F_64 = 0, half 0 continues into F_32
      const float F32 = __shfl_sync(0xffffffffu, C[1], 0);
      const float F0 = C[0] + M[0] * F32, F1 = C[1];
      const float n0 = __shfl_down_sync(0xffffffffu, F0, 1);
      const float n1 = __shfl_down_sync(0xffffffffu, F1, 1);
      const float B0 = lane == 31 ? F32 : n0, B1 = lane == 31 ? 0.f : n1;
      const float Bk[2] = {B0, B1};
      for (int h = 0; h < 2; ++h) {
        const int k = lane + 32 * h;
        Tr[k] = T[h];
        wgt[k] = k < S ? alpha[k] * T[h] : 0.f;
        calpha[k] = k < S ? T[h] * (uu[h] - Bk[h]) : 0.f;
      }
    }
    __syncthreads();
    for (int r = tid; r < ROWS; r += TNT) {
      const float* gr = g + r * 3;
      if (r >= S) {
        for (int k = 0; k < 3; ++k) cg[r * 3 + k] = cdir[r * 3 + k] = 0.f;
        cs[r] = 0.f;
        for (int ch = 0; ch < 8; ++ch) chead[r * 8 + ch] = 0.f;
        for (int ch = 0; ch < ldHd; ++ch) cheadb[r * ldHd + ch] = to_bf(0.f);
        continue;
      }
      const float* p = pts + r * 3;
      const size_t pt = (size_t)rid * S + r;
      const float tc = ray[3] * gr[0] + ray[4] * gr[1] + ray[5] * gr[2];
      const float dist = dists[pt];
      const Chain c = alpha_chain(sdf_res[pt], tc, dist, inv_s, cos_r);
      const AlphaCots ca = POINT ? alpha_chain_vjp(c, ct.alpha[pt], ct.cdf[pt], dist, inv_s, cos_r)
                                 : alpha_chain_vjp(c, calpha[r], 0.f, dist, inv_s, cos_r);
      civ += ca.civ;
      d_t[pt] = ca.ct;
      const float relax = (p[0] * p[0] + p[1] * p[1] + p[2] * p[2]) < 1.44f ? 1.f : 0.f;
      const float ke = eik_factor(c_num, relax, gr);
      const float w = POINT ? 0.f : wgt[r];
      for (int k = 0; k < 3; ++k) {
        const float cgk = POINT ? ct.grad[pt * 3 + k] : w * ct.nw[(size_t)rid * 3 + k];
        cg[r * 3 + k] = cgk + ca.ctc * ray[3 + k] + ke * gr[k];
        cdir[r * 3 + k] = ca.ctc * gr[k];
      }
      cs[r] = (ca.cs + (POINT ? ct.sdf[pt] : 0.f)) / d.scale;
      for (int ch = 0; ch < ldHd; ++ch) {
        float ch_raw = 0.f;
        if (ch < W) {
          const float hv = head[r * 8 + ch];
          const float crgb = POINT ? ct.rgb[pt * W + ch] : w * ct.col[(size_t)rid * W + ch];
          ch_raw = crgb;
          if (d.squeeze) {
            const float sg = sigmoidf(hv);
            ch_raw = crgb * sg * (1.f - sg);
          }
        }
        if (ch < 8) chead[r * 8 + ch] = ch_raw;
        cheadb[r * ldHd + ch] = to_bf(ch_raw);
      }
    }
    __syncthreads();
    phase_mark(PH_COMPOSITE);
    // ---- colour reverse: each reverse product's epilogue forms the next
    // layer's cotangent in cz (the relu mask from that layer's activations
    // in the log) and sums it into its bias gradient; layer 0's product
    // gives the colour input's cotangents: points and normals to ccin6, the
    // features as the head reverse's bf16 operand CF (in cin's room) with
    // their sums into the head's feature biases
    bf16* CF = cin;
    {
      lput(LG_CHEAD, cheadb, ldHd, W);
      for (int c = tid; c < W; c += TNT) {
        float s = 0.f;
        for (int r = 0; r < ROWS; ++r) s += chead[r * 8 + c];
        gp[wo.cb[d.NHC] + c] += s;
      }
      const bf16* A = cheadb;
      int lda = ldHd, K = W;
      for (int l = d.NHC; l >= 1; --l) {
        const bf16* al = lp(LG_ACT + l - 1);
        const int ldal = lg.ld[LG_ACT + l - 1];
        phase_tag(4);
        gemm_fused<false>(
            rg, A, nullptr, lda, K, RC + l, HC, red, gp + wo.cb[l - 1], 0, HC,
            [&](int r, int c) { return c < HC ? __bfloat162float(al[r * ldal + c]) : 0.f; },
            [&](int r, int c, float v, float, float a) {
              const float zc = c < HC && a > 0.f ? v : 0.f;
              if (c < HC) cz[r * ldX + c] = to_bf(zc);
              return zc;
            });
        lput(LG_CZC + l - 1, cz, ldX, HC);
        A = cz;
        lda = ldX;
        K = HC;
      }
      for (int e = tid; e < ROWS * (ldF - F); e += TNT)
        CF[(e / (ldF - F)) * ldF + F + e % (ldF - F)] = to_bf(0.f);
      phase_tag(5);
      gemm_fused<false>(rg, A, nullptr, lda, K, RC + 0, CW, red, gp + wo.sb[d.NH + 1] + 1, 6, CW,
                        NoPre(), [&](int r, int c, float v, float, float) {
                          if (c < 6) ccin6[r * 6 + c] = v;
                          else if (c < CW) CF[r * ldF + c - 6] = to_bf(v);
                          return c >= 6 && c < CW ? v : 0.f;
                        });
    }
    // ---- SDF reverse: forward-over-reverse, tangent direction v = cg
    for (int e = tid; e < ROWS * 3; e += TNT) {
      const int r = e / 3, c = e % 3;
      cg[e] += ccin6[r * 6 + 3 + c];
    }
    __syncthreads();
    sdf_reverse_tc(d, L, sm, rg, wts, wo, P, AS, ZD, PS, ZDS, CH, CHD, gp, lput, ccin6);
    for (int r = tid; r < S; r += TNT) {
      const float* dxr = dx + r * 3;
      d_z[(size_t)rid * S + r] = dxr[0] * ray[3] + dxr[1] * ray[4] + dxr[2] * ray[5];
    }
    if (tid < 3) {
      float so = 0.f, sd = 0.f;
      for (int r = 0; r < S; ++r) {
        const float v = dx[r * 3 + tid];
        so += v;
        sd += v * z[r] + cdir[r * 3 + tid];
      }
      d_o[rid * 3 + tid] = so;
      d_d[rid * 3 + tid] = sd;
    }
    __syncthreads();
  }
  const float civ_sum = cta_sum_tc(civ, red);
  if (tid == 0) gp[wo.total] += civ_sum;
  phase_end(POINT ? PK_POINT_BWD : PK_RAY_BWD);
}

// B6's backward: tiles blk0 .. blk1 of 64 points (the chunk's), each CTA
// walking them. A tile's rows past the last point are zero points with zero
// cotangents. Seeds of the reverse: the gradient cotangent is the tangent
// direction, the sdf cotangent in net units, the feature cotangent the head
// reverse's operand (its f32 column sums the feature biases' gradients).
// gp: this CTA's partial row of weight_count floats, zero from the caller.
__global__ void __launch_bounds__(TNT, 1) sdf_tc_bwd_kernel(
    Dims d, Pack pp, const float* __restrict__ wts, const uint2* __restrict__ pk,
    const float* __restrict__ pts_in, int n_pts, const float* __restrict__ c_sdf,
    const float* __restrict__ c_feat, const float* __restrict__ c_grad,
    float* __restrict__ d_pts, float* __restrict__ gpart, unsigned char* __restrict__ scr_all,
    long long scr_stride, WLog lg, bf16* __restrict__ log, long long log_rows, int blk0,
    int blk1) {
  extern __shared__ __align__(128) unsigned char sm[];
  const Layout L = tc_layout(d, true);
  const WeightOffsets wo = weight_offsets(d);
  unsigned char* scr = scr_all + (size_t)blockIdx.x * scr_stride;
  float* gp = gpart + (size_t)blockIdx.x * wo.total;
  const int tid = threadIdx.x, E = d.E, F = d.F, ldE = L.ldE, ldF = L.ldF;
  phase_start();
  float* pts = (float*)(sm + L.pts);
  float* cg = (float*)(sm + L.cg);
  float* cs = (float*)(sm + L.cs);
  const float* dx = (const float*)(sm + L.dx);
  const bf16* eb = (const bf16*)(sm + L.eb);
  bf16* cz = (bf16*)(sm + L.ha);
  bf16* czd = (bf16*)(sm + L.hb);
  bf16* CF = (bf16*)(sm + L.cin);
  f16* P = (f16*)(scr + L.P);
  f16* AS = (f16*)(scr + L.AS);
  bf16* ZD = (bf16*)(scr + L.ZD);
  f16* PS = (f16*)(scr + L.PS);
  bf16* ZDS = (bf16*)(scr + L.ZDS);
  float* CH = (float*)(scr + L.CH);
  float* CHD = (float*)(scr + L.CHD);
  float* red = (float*)(sm + L.red);
  // every bf16 operand buffer starts zero: padding columns are never written
  for (size_t e = tid; e < L.smem / 4; e += TNT) ((float*)sm)[e] = 0.f;
  __syncthreads();
  Ring rg = ring_init(sm + L.ring, sm + L.rbar, d, pp, pk, PLAN_SDF_BWD,
                      tiles_of(blk1 - blk0, blockIdx.x, gridDim.x));
  for (int blk = blk0 + blockIdx.x; blk < blk1; blk += gridDim.x) {
    const long long row0 = (long long)blk * ROWS;
    const int n = n_pts - row0 < ROWS ? (int)(n_pts - row0) : ROWS;
    const long long q0 = (long long)(blk - blk0) * ROWS;
    auto lp = [&](int m) { return log_at(log, lg, log_rows, m, q0); };
    auto lput = [&](int m, const bf16* src, int lds, int ncols) { log_put(lp(m), lg.ld[m], src, lds, ncols); };
    for (int e = tid; e < ROWS * 3; e += TNT) {
      const bool ok = e < n * 3;
      pts[e] = ok ? pts_in[row0 * 3 + e] : 0.f;
      cg[e] = ok ? c_grad[row0 * 3 + e] : 0.f;
    }
    for (int r = tid; r < ROWS; r += TNT) cs[r] = r < n ? c_sdf[row0 + r] / d.scale : 0.f;
    __syncthreads();
    encode_points(d, L, sm, false);
    lput(LG_EB, eb, ldE, E);
    sdf_primal_tc(d, L, sm, rg, wts, wo, P, AS, PS, nullptr,
                              [&](int i) { return (i % 2) ? czd : cz; },
                              [&](int i, bf16*& p, int& ld) {
                                const int m = i < 0 ? LG_U : LG_X + i;
                                p = lp(m);
                                ld = lg.ld[m];
                                return true;
                              },
                              NoFeat());
    // the feature cotangents: the head reverse's bf16 operand CF, and their
    // f32 sums into the feature biases' gradients
    column_pass(F, red, gp + wo.sb[d.NH + 1] + 1, [&](int c, int rb) {
      float acc = 0.f;
      for (int r0 = rb; r0 < rb + ROWS / 2; r0 += RB) {
        float v[RB];
#pragma unroll
        for (int q = 0; q < RB; ++q) v[q] = r0 + q < n ? c_feat[(row0 + r0 + q) * F + c] : 0.f;
#pragma unroll
        for (int q = 0; q < RB; ++q) {
          CF[(r0 + q) * ldF + c] = to_bf(v[q]);
          acc += v[q];
        }
      }
      return acc;
    });
    sdf_reverse_tc(d, L, sm, rg, wts, wo, P, AS, ZD, PS, ZDS, CH, CHD, gp, lput,
                   (const float*)nullptr);
    for (int e = tid; e < n * 3; e += TNT) d_pts[row0 * 3 + e] = dx[e];
    __syncthreads();
  }
  phase_end(PK_SDF_BWD);
}

// B6's forward: the tile's f32 feature rows, straight from the head
// product's accumulators plus bias, to the feature output; rows past the
// last point are never stored
struct FeatOut {
  static constexpr bool on = true;
  float* out;  // the tile's first row of the (P, F) feature output
  int F, n;
  __device__ void operator()(int r, int c, float v) const {
    if (r < n) out[(size_t)r * F + c] = v;
  }
};

// B6's forward in the bf16 mode: B3's forward body with the points read
// from memory in tiles of 64 (a ragged last tile zero-padded, its padded
// rows never stored), stopped after the gradient sweep: no colour net, no
// alpha chain, no eikonal sum. Out go sdf (P,) / scale, the f32 feature
// (P, F) and the gradient (P, 3). The head's sdf row is rounded, as the
// JAX sdf+gradient kernel's _dot rounds it (B1 and B3 sum it in f32 from
// AS): bf16 u = [a_s, e] against the bf16 row weights w0 / sqrt2, summed in
// f32 in a fixed order, eight threads a row.
__global__ void __launch_bounds__(TNT, 1) sdf_tc_fwd_kernel(
    Dims d, Pack pp, const float* __restrict__ wts, const uint2* __restrict__ pk,
    const float* __restrict__ pts_in, int n_pts, float* __restrict__ sdf_out,
    float* __restrict__ feat_out, float* __restrict__ g_out, unsigned char* __restrict__ scr_all,
    long long scr_stride) {
  extern __shared__ __align__(128) unsigned char sm[];
  const Layout L = tc_layout(d, false);
  const WeightOffsets wo = weight_offsets(d);
  unsigned char* scr = scr_all + (size_t)blockIdx.x * scr_stride;
  f16* P = (f16*)(scr + L.P);
  float* AS = (float*)(scr + L.AS);
  const int tid = threadIdx.x, H = d.H, ldX = L.ldX;
  phase_start();
  float* pts = (float*)(sm + L.pts);
  const float* g = (const float*)(sm + L.g);
  const bf16* u = (const bf16*)(sm + L.u);
  bf16* ha = (bf16*)(sm + L.ha);
  bf16* hb = (bf16*)(sm + L.hb);
  const float* w0 = wts + wo.sw[d.NH + 1];
  const float b0 = wts[wo.sb[d.NH + 1]];
  // every bf16 operand buffer starts zero: padding columns are never written
  for (size_t e = tid; e < L.smem / 4; e += TNT) ((float*)sm)[e] = 0.f;
  __syncthreads();
  const int n_blk = (n_pts + ROWS - 1) / ROWS;
  Ring rg = ring_init(sm + L.ring, sm + L.rbar, d, pp, pk, PLAN_SDF_FWD,
                      tiles_of(n_blk, blockIdx.x, gridDim.x));
  for (int blk = blockIdx.x; blk < n_blk; blk += gridDim.x) {
    const long long row0 = (long long)blk * ROWS;
    const int n = n_pts - row0 < ROWS ? (int)(n_pts - row0) : ROWS;
    for (int e = tid; e < ROWS * 3; e += TNT) pts[e] = e < n * 3 ? pts_in[row0 * 3 + e] : 0.f;
    __syncthreads();
    encode_points(d, L, sm, true);
    bf16* skip_in = (d.NH % 2) ? ha : hb;
    bf16* ts = skip_in == ha ? hb : ha;
    sdf_primal_tc(d, L, sm, rg, wts, wo, P, AS, (f16*)nullptr, ts,
                  [&](int i) { return (i % 2) ? hb : ha; }, NoLog(),
                  FeatOut{feat_out + row0 * d.F, d.F, n});
    // the sdf row, rounded: eight threads a row, strided partial sums, then
    // three xor shuffles within the eight consecutive lanes
    {
      const int r = tid >> 3, q = tid & 7;
      float acc = 0.f;
      for (int k = q; k < H; k += 8)
        acc += __bfloat162float(u[r * ldX + k]) * __bfloat162float(to_bf(w0[k] * RSQRT2));
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      acc += __shfl_xor_sync(0xffffffffu, acc, 4);
      if (q == 0 && r < n) sdf_out[row0 + r] = (acc + b0) / d.scale;
    }
    gradient_sweep_tc(d, L, sm, rg, wts, wo, P, ts, skip_in);
    phase_mark(PH_OTHER);
    for (int e = tid; e < n * 3; e += TNT) g_out[row0 * 3 + e] = g[e];
    __syncthreads();
    phase_mark(PH_COMPOSITE);
  }
  phase_end(PK_SDF_FWD);
}

// #12's sdf-only forward in the bf16 mode: B6's forward body up to the
// skip-producing layer, with no state kept for a gradient sweep (sigmoid
// factors, tangent operands) and no head product: the points read in tiles
// of 64 (a ragged last tile zero-padded, its padded rows never stored),
// encoded, the hidden layers and the skip layer on the tensor cores, then
// the head's sdf row alone. That row is JAX's sdf-only kernel's f32 row
// form, sum(a_s * wsa_row) + sum(e * wse_row) (fused_sdf.py:640-644), not
// B6's rounded one: the f32 a_s (from the skip product's accumulators,
// through the CTA's L2 scratch AS) and the f32 encoding ef against the f32
// row w0 / sqrt2, four threads a row in a fixed order, as B1 and B3 take it.
// Out goes sdf (P,) / scale.
__global__ void __launch_bounds__(TNT, 1) sdf_only_tc_fwd_kernel(
    Dims d, Pack pp, const float* __restrict__ wts, const uint2* __restrict__ pk,
    const float* __restrict__ pts_in, int n_pts, float* __restrict__ sdf_out,
    unsigned char* __restrict__ scr_all, long long scr_stride) {
  extern __shared__ __align__(128) unsigned char sm[];
  const Layout L = tc_layout(d, false);
  const WeightOffsets wo = weight_offsets(d);
  float* AS = (float*)(scr_all + (size_t)blockIdx.x * scr_stride + L.AS);
  const int tid = threadIdx.x, SW = d.SW, E = d.E;
  phase_start();
  float* pts = (float*)(sm + L.pts);
  const float* ef = (const float*)(sm + L.ef);
  bf16* ha = (bf16*)(sm + L.ha);
  bf16* hb = (bf16*)(sm + L.hb);
  const float* w0 = wts + wo.sw[d.NH + 1];
  const float b0 = wts[wo.sb[d.NH + 1]];
  // every bf16 operand buffer starts zero: padding columns are never written
  for (size_t e = tid; e < L.smem / 4; e += TNT) ((float*)sm)[e] = 0.f;
  __syncthreads();
  const int n_blk = (n_pts + ROWS - 1) / ROWS;
  Ring rg = ring_init(sm + L.ring, sm + L.rbar, d, pp, pk, PLAN_SDF_ONLY,
                      tiles_of(n_blk, blockIdx.x, gridDim.x));
  for (int blk = blockIdx.x; blk < n_blk; blk += gridDim.x) {
    const long long row0 = (long long)blk * ROWS;
    const int n = n_pts - row0 < ROWS ? (int)(n_pts - row0) : ROWS;
    for (int e = tid; e < ROWS * 3; e += TNT) pts[e] = e < n * 3 ? pts_in[row0 * 3 + e] : 0.f;
    __syncthreads();
    encode_points(d, L, sm, true);
    sdf_primal_tc<false>(d, L, sm, rg, wts, wo, (f16*)nullptr, AS, (f16*)nullptr, (bf16*)nullptr,
                         [&](int i) { return (i % 2) ? hb : ha; }, NoLog(), NoFeat());
    phase_mark(PH_OTHER);
    // the head's sdf row in f32: four threads a row, fixed order
    if (tid < 4 * ROWS) {
      const int r = tid >> 2, q = tid & 3;
      float acc = 0.f;
      for (int k = q; k < SW; k += 4) acc += AS[r * SW + k] * w0[k];
      for (int j = q; j < E; j += 4) acc += ef[r * E + j] * w0[SW + j];
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (q == 0 && r < n) sdf_out[row0 + r] = (acc * RSQRT2 + b0) / d.scale;
    }
    __syncthreads();  // AS and ef are the next tile's
    phase_mark(PH_COMPOSITE);
  }
  phase_end(PK_SDF_ONLY);
}

// B7's backward in the bf16 mode: tiles blk0 .. blk1 of 64 points (the
// chunk's), each CTA walking them; the colour half of B1's backward with the
// colour input read from memory. The first layer's input is one bf16 tile
// cin = the mode's columns of the colour net's concatenation: points at cx,
// normals at cn, view directions at cv (-1: an input the mode does not
// read), the feature from CW - F; rows past the last point are zero, with
// zero cotangents. The head's sigmoid VJP seeds the reverse; each reverse
// product's epilogue applies the relu mask (from the logged activations)
// and sums its column into the bias gradient (gp: this CTA's partial row of
// weight_count floats, zero from the caller); layer 0's reverse product
// writes the input cotangents in f32 straight from its accumulators. Every
// weight gradient's operands go to the log, for wgrad_kernel.
__global__ void __launch_bounds__(TNT, 1) colour_tc_bwd_kernel(
    Dims d, Pack pp, const float* __restrict__ wts, const uint2* __restrict__ pk,
    const float* __restrict__ x_in, const float* __restrict__ n_in,
    const float* __restrict__ v_in, const float* __restrict__ f_in, int n_pts, int cx, int cn,
    int cv, const float* __restrict__ c_out, float* __restrict__ dx, float* __restrict__ dn,
    float* __restrict__ dv, float* __restrict__ df, float* __restrict__ gpart, WLog lg,
    bf16* __restrict__ log, long long log_rows, int blk0, int blk1) {
  extern __shared__ __align__(128) unsigned char sm[];
  const Layout L = tc_layout(d, true);
  const WeightOffsets wo = weight_offsets(d);
  float* gp = gpart + (size_t)blockIdx.x * wo.total;
  const int tid = threadIdx.x, F = d.F, HC = d.HC, CW = d.CW, W = d.W, cf = d.CW - d.F;
  const int ldX = L.ldX, ldC = L.ldC, ldHd = ld_of(8);
  phase_start();
  bf16* cin = (bf16*)(sm + L.cin);
  bf16* cz = (bf16*)(sm + L.ha);
  bf16* czd = (bf16*)(sm + L.hb);
  const float* head = (const float*)(sm + L.head);
  float* chead = (float*)(sm + L.chead);
  bf16* cheadb = (bf16*)(sm + L.cheadb);
  float* red = (float*)(sm + L.red);
  const int vcol[3] = {cx, cn, cv};
  const float* vin[3] = {x_in, n_in, v_in};
  float* vout[3] = {dx, dn, dv};
  // every bf16 operand buffer starts zero: padding columns are never written
  for (size_t e = tid; e < L.smem / 4; e += TNT) ((float*)sm)[e] = 0.f;
  __syncthreads();
  Ring rg = ring_init(sm + L.ring, sm + L.rbar, d, pp, pk, PLAN_COL_BWD,
                      tiles_of(blk1 - blk0, blockIdx.x, gridDim.x));
  for (int blk = blk0 + blockIdx.x; blk < blk1; blk += gridDim.x) {
    const long long row0 = (long long)blk * ROWS;
    const int n = n_pts - row0 < ROWS ? (int)(n_pts - row0) : ROWS;
    const long long q0 = (long long)(blk - blk0) * ROWS;
    auto lp = [&](int m) { return log_at(log, lg, log_rows, m, q0); };
    auto lput = [&](int m, const bf16* src, int lds, int ncols) { log_put(lp(m), lg.ld[m], src, lds, ncols); };
    // the colour input tile: the vectors at their columns, then the feature
    // (its loads a batch of RB at once, then the stores)
    phase_mark(PH_OTHER);
    for (int e = tid; e < ROWS * 9; e += TNT) {
      const int r = e / 9, k = e % 9, i = k / 3;
      if (vcol[i] >= 0)
        cin[r * ldC + vcol[i] + k % 3] = to_bf(r < n ? vin[i][(row0 + r) * 3 + k % 3] : 0.f);
    }
    const float* fr = f_in + row0 * F;
    for (int e0 = tid; e0 < ROWS * F; e0 += RB * TNT) {
      float v[RB];
#pragma unroll
      for (int q = 0; q < RB; ++q) {
        const int e = e0 + q * TNT;
        v[q] = e < n * F ? fr[e] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < RB; ++q) {
        const int e = e0 + q * TNT;
        if (e < ROWS * F) cin[(e / F) * ldC + cf + e % F] = to_bf(v[q]);
      }
    }
    __syncthreads();
    phase_mark(PH_COMPOSITE);
    lput(LG_CIN, cin, ldC, CW);
    colour_primal_tc(d, L, sm, rg, wts, wo, [&](int l) { return (l % 2) ? czd : cz; },
                                 [&](int l, bf16*& p, int& ld) {
                                   p = lp(LG_ACT + l);
                                   ld = lg.ld[LG_ACT + l];
                                   return true;
                                 });
    // the head's cotangent through the sigmoid (f32, and its bf16 operand
    // copy), zero past the head's width and the last point
    phase_mark(PH_OTHER);
    for (int e = tid; e < ROWS * ldHd; e += TNT) {
      const int r = e / ldHd, ch = e % ldHd;
      float c = 0.f;
      if (ch < W && r < n) {
        c = c_out[(row0 + r) * W + ch];
        if (d.squeeze) {
          const float sg = sigmoidf(head[r * 8 + ch]);
          c *= sg * (1.f - sg);
        }
      }
      if (ch < 8) chead[r * 8 + ch] = c;
      cheadb[e] = to_bf(c);
    }
    __syncthreads();
    phase_mark(PH_COMPOSITE);
    lput(LG_CHEAD, cheadb, ldHd, W);
    for (int c = tid; c < W; c += TNT) {
      float s = 0.f;
      for (int r = 0; r < ROWS; ++r) s += chead[r * 8 + c];
      gp[wo.cb[d.NHC] + c] += s;
    }
    // the relu layers' reverse, as B1's colour reverse: each product's
    // epilogue forms the next cotangent in cz (in place: one pass) under the
    // relu mask of that layer's logged activations, and sums it into the
    // layer's bias gradient
    const bf16* A = cheadb;
    int lda = ldHd, K = W;
    for (int l = d.NHC; l >= 1; --l) {
      const bf16* al = lp(LG_ACT + l - 1);
      const int ldal = lg.ld[LG_ACT + l - 1];
      phase_tag(4);
      gemm_fused<false>(
          rg, A, nullptr, lda, K, RC + l, HC, red, gp + wo.cb[l - 1], 0, HC,
          [&](int r, int c) { return c < HC ? __bfloat162float(al[r * ldal + c]) : 0.f; },
          [&](int r, int c, float v, float, float a) {
            const float zc = c < HC && a > 0.f ? v : 0.f;
            if (c < HC) cz[r * ldX + c] = to_bf(zc);
            return zc;
          });
      lput(LG_CZC + l - 1, cz, ldX, HC);
      A = cz;
      lda = ldX;
      K = HC;
    }
    // layer 0's reverse product: the input cotangents in f32 from the
    // accumulators, the feature's to df and each vector's to its output
    phase_tag(5);
    gemm_fused<false>(rg, A, nullptr, lda, K, RC + 0, CW, red, nullptr,
                                  0, 0, NoPre(), [&](int r, int c, float v, float, float) {
                                    if (r < n && c < CW) {
                                      if (c >= cf) {
                                        df[(row0 + r) * F + c - cf] = v;
                                      } else {
#pragma unroll
                                        for (int i = 0; i < 3; ++i)
                                          if (vcol[i] >= 0 && c >= vcol[i] && c < vcol[i] + 3)
                                            vout[i][(row0 + r) * 3 + c - vcol[i]] = v;
                                      }
                                    }
                                    return 0.f;
                                  });
  }
  phase_end(PK_COL_BWD);
}

// B7's forward in the bf16 mode: persistent CTAs walk tiles of 64 points.
// The first layer's input is one bf16 tile cin over the mode's columns, as
// colour_tc_bwd_kernel builds it: points at cx, normals at cn, view
// directions at cv (-1: an input the mode does not read), the feature from
// CW - F; rows past the last point are zero and never stored. The feature,
// ~1 KB a point of the ~1.1 KB read, streams: thread 0 bulk-copies the
// next tile's f32 rows into the staging buffer (colour_fwd_layout's fstage)
// as soon as this tile has rounded its own into cin, so the copy runs under
// this tile's three products; the vectors (36 B a point) are plain loads
// issued before the wait. colour_primal_tc runs the relu layers and the
// head (no log); the head's f32 accumulators plus bias go through the
// sigmoid (when squeeze) straight to out, (n_pts, W).
__global__ void __launch_bounds__(TNT, 1) colour_tc_fwd_kernel(
    Dims d, Pack pp, const float* __restrict__ wts, const uint2* __restrict__ pk,
    const float* __restrict__ x_in, const float* __restrict__ n_in,
    const float* __restrict__ v_in, const float* __restrict__ f_in, int n_pts, int cx, int cn,
    int cv, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char sm[];
  const Layout L = colour_fwd_layout(d);
  const WeightOffsets wo = weight_offsets(d);
  const int tid = threadIdx.x, F = d.F, W = d.W, cf = d.CW - d.F, ldC = L.ldC;
  phase_start();
  bf16* cin = (bf16*)(sm + L.cin);
  bf16* ha = (bf16*)(sm + L.ha);
  bf16* hb = (bf16*)(sm + L.hb);
  const float* head = (const float*)(sm + L.head);
  const float* stage = (const float*)(sm + L.fstage);
  uint64_t* bar = (uint64_t*)(sm + L.bar);
  const int vcol[3] = {cx, cn, cv};
  const float* vin[3] = {x_in, n_in, v_in};
  const int n_blk = (n_pts + ROWS - 1) / ROWS;
  // thread 0: tile blk's feature rows into the stage (F a multiple of 4 and
  // f_in 16-byte aligned: every row run is a multiple of 16 bytes)
  auto fetch = [&](int blk) {
    const long long row0 = (long long)blk * ROWS;
    const int n = n_pts - row0 < ROWS ? (int)(n_pts - row0) : ROWS;
    bulk_load((void*)stage, f_in + row0 * F, (unsigned)(n * F * 4), bar);
  };
  // every bf16 operand buffer starts zero: padding columns are never written
  // (the stage is written by the copies alone)
  for (size_t e = tid; e < L.fstage / 4; e += TNT) ((float*)sm)[e] = 0.f;
  if (tid == 0) {
    mbar_init(bar, 1);
    if ((int)blockIdx.x < n_blk) fetch(blockIdx.x);
  }
  __syncthreads();
  Ring rg = ring_init(sm + L.ring, sm + L.rbar, d, pp, pk, PLAN_COL_FWD,
                      tiles_of(n_blk, blockIdx.x, gridDim.x));
  unsigned parity = 0;
  for (int blk = blockIdx.x; blk < n_blk; blk += gridDim.x, parity ^= 1u) {
    const long long row0 = (long long)blk * ROWS;
    const int n = n_pts - row0 < ROWS ? (int)(n_pts - row0) : ROWS;
    phase_mark(PH_OTHER);
    for (int e = tid; e < ROWS * 9; e += TNT) {
      const int r = e / 9, k = e % 9, i = k / 3;
      if (vcol[i] >= 0)
        cin[r * ldC + vcol[i] + k % 3] = to_bf(r < n ? vin[i][(row0 + r) * 3 + k % 3] : 0.f);
    }
    mbar_wait(bar, parity);
    for (int e = tid; e < ROWS * F; e += TNT)
      cin[(e / F) * ldC + cf + e % F] = to_bf(e < n * F ? stage[e] : 0.f);
    __syncthreads();  // the stage is read: the next tile's rows may land in it
    if (tid == 0 && blk + (int)gridDim.x < n_blk) fetch(blk + gridDim.x);
    phase_mark(PH_COMPOSITE);
    colour_primal_tc(d, L, sm, rg, wts, wo, [&](int l) { return (l % 2) ? hb : ha; });
    phase_mark(PH_OTHER);
    float* o = out + row0 * W;
    for (int e = tid; e < n * W; e += TNT) o[e] = rgb_of(d, head[(e / W) * 8 + e % W]);
    phase_mark(PH_COMPOSITE);
  }
  phase_end(PK_COL_FWD);
}

// Weight gradients of one chunk: CTA (item, split) takes one WG_TM x WG_TN tile
// of one problem's D (wgrad_problems) and the split's share of the chunk's
// rows (whole rays), forms X^T Y over them on the tensor cores, and adds it
// (times the problem's scale) to its own partial sums: part_base + (part *
// n_split + split) rows of the (weight_count + 1)-float partial layout. Each
// element has one writer a chunk and the chunks run in order: no atomics,
// the same sums every run.
__global__ void __launch_bounds__(WG_THREADS) wgrad_kernel(WLog lg, WProbs ps,
                                                           const bf16* __restrict__ log,
                                                           long long rows, int n_split,
                                                           float* __restrict__ part_base,
                                                           long long part_stride) {
  extern __shared__ __align__(128) unsigned char sm[];
  bf16* st = (bf16*)sm;
  phase_start();
  // which problem and tile
  int item = blockIdx.x, pi = 0;
  while (pi < ps.n && item >= wgrad_tiles(ps.p[pi])) item -= wgrad_tiles(ps.p[pi++]);
  if (pi >= ps.n) return;
  const WProb pb = ps.p[pi];
  const int ntn = (pb.N + WG_TN - 1) / WG_TN;
  const int m0 = (item / ntn) * WG_TM, n0 = (item % ntn) * WG_TN;
  const long long n_ray = rows / ROWS;
  const long long k0 = (long long)blockIdx.y * n_ray / n_split * ROWS;
  const long long k1 = (long long)(blockIdx.y + 1) * n_ray / n_split * ROWS;
  const int nkb = (int)((k1 - k0) / WG_BK);
  const bf16* X = log + lg.off[pb.x] * rows;
  const bf16* Y = log + lg.off[pb.y] * rows;
  const int ldx = lg.ld[pb.x], ldy = lg.ld[pb.y];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int wm = warp / WG_WN, wn = warp % WG_WN;  // warps of 64 x 32
  const int lr = lane & 7, blk = lane >> 3;
  // stage kb: rows k0 + 32 kb .. of X[:, m0 .. m0 + WG_TM) and Y[:, n0 ..
  // n0 + WG_TN), columns past the region's stride zero-filled
  auto issue = [&](int kb) {
    if (kb < nkb) {
      bf16* dst = st + (kb % WG_NSTG) * WG_STAGE;
      const long long r0 = k0 + (long long)kb * WG_BK;
      constexpr int NX = WG_BK * (WG_TM / 8), NY = WG_BK * (WG_TN / 8);
      for (int e = tid; e < NX + NY; e += WG_THREADS) {
        const int which = e >= NX, rem = which ? e - NX : e, w8 = (which ? WG_TN : WG_TM) / 8;
        const int r = rem / w8, c = (rem % w8) * 8;
        bf16* d = dst + (which ? WG_BK * WG_LDX + r * WG_LDY : r * WG_LDX) + c;
        const int col = (which ? n0 : m0) + c, ld = which ? ldy : ldx;
        if (col < ld) cp_async16(d, (which ? Y : X) + (r0 + r) * ld + col);
        else *(uint4*)d = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
  };
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  for (int s = 0; s < WG_NSTG - 1; ++s) issue(s);
  for (int kb = 0; kb < nkb; ++kb) {
    cp_async_wait<WG_NSTG - 2>();
    __syncthreads();  // stage kb landed for all; stage kb - 1 is free
    issue(kb + WG_NSTG - 1);
    const bf16* xs = st + (kb % WG_NSTG) * WG_STAGE;
    const bf16* ys = xs + WG_BK * WG_LDX;
#pragma unroll
    for (int kk = 0; kk < WG_BK; kk += 16) {
      // A = X^T: a0 (m +0, k +0), a1 (m +8, k +0), a2 (m +0, k +8), a3 (m +8, k +8)
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldsm_x4_t(a[i], xs + (kk + lr + (blk >> 1) * 8) * WG_LDX + wm * 64 + i * 16 + (blk & 1) * 8);
      // B = Y: b[j] = (k +0, n +8j), (k +8, n +8j), two n-tiles an ldmatrix
      uint2 b[4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t r[4];
        ldsm_x4_t(r, ys + (kk + lr + (blk & 1) * 8) * WG_LDY + wn * 32 + jj * 16 + (blk >> 1) * 8);
        b[2 * jj] = make_uint2(r[0], r[1]);
        b[2 * jj + 1] = make_uint2(r[2], r[3]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();
  float* D = part_base + (size_t)(pb.part * n_split + blockIdx.y) * part_stride + pb.doff;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int mm = m0 + wm * 64 + i * 16 + g + (e >> 1) * 8;
        const int nn = n0 + wn * 32 + j * 8 + 2 * t + (e & 1);
        if (mm < pb.M && nn < pb.N) D[(size_t)mm * pb.ldd + nn] += pb.scale * acc[i][j][e];
      }
  phase_mark(PH_WGRAD);
  phase_end(PK_WGRAD);
}

}  // namespace

extern "C" {

// dynamic shared memory and per-CTA scratch (bytes) of a kernel
long long neus_tc_smem_bytes(Dims d, int backward) {
  return (long long)tc_layout(d, backward != 0).smem;
}
long long neus_tc_scratch_bytes(Dims d, int backward) {
  return (long long)tc_layout(d, backward != 0).scratch;
}
long long neus_tc_weight_count(Dims d) { return (long long)weight_offsets(d).total; }

#ifdef NEUS_TC_PROF
// the profiling build's per-CTA phase cycles of a kernel (neus_tc.cuh's
// PK_*: 0 B1 forward, 1 B1 backward, 2 weight gradients, 3 B3 forward, 4
// B6 backward, 5 B6 forward, 6 B7 backward): n_cta x PH_N into out (host
// memory)
int neus_tc_phases(int kernel, long long* out, int n_cta) {
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(long long) * n_cta * PH_N,
                                   sizeof(long long) * PH_MAXCTA * PH_N * kernel);
}
#endif

// Forward: as neus_ray_fwd (fused_neus_ray.cu), with the packed bf16 weights
// pk (offsets pp) beside the flat f32 ones; scr an (n_cta, scr_stride)-byte
// scratch.
int neus_ray_tc_fwd(Dims d, Pack pp, const float* wts, const void* pk, const float* rays_o,
                    const float* rays_d, const float* mid_z, const float* dists,
                    const float* inv_s, float cos_r, int R, float* col_w, float* normals_w,
                    float* wsum, float* sdf_out, float* g_out, float* eik, float* eik_part,
                    void* scr, long long scr_stride, int n_cta, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int smem = (int)tc_layout(d, false).smem;
  int err = (int)cudaFuncSetAttribute(neus_tc_fwd_kernel<false>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  const FwdOut out{sdf_out, g_out, col_w, normals_w, wsum, nullptr, nullptr, nullptr, nullptr};
  neus_tc_fwd_kernel<false><<<n_cta, TNT, smem, st>>>(d, pp, wts, (const uint2*)pk, rays_o, rays_d, mid_z, dists, inv_s, cos_r, R, out, eik_part, (unsigned char*)scr, scr_stride);
  err = (int)cudaGetLastError();
  if (err) return err;
  return reduce_partials(eik_part, n_cta, 2, eik, st);
}

// B3's forward: as neus_point_fwd (fused_neus_point.cu), with the packed
// bf16 weights pk (offsets pp) beside the flat f32 ones; scr an (n_cta,
// scr_stride)-byte scratch (neus_tc_scratch_bytes(d, 0)).
int neus_point_tc_fwd(Dims d, Pack pp, const float* wts, const void* pk, const float* rays_o,
                      const float* rays_d, const float* mid_z, const float* dists,
                      const float* inv_s, float cos_r, int R, float* sdf, float* alpha, float* cdf,
                      float* grad, float* inside, float* rgb, float* eik, float* eik_part,
                      void* scr, long long scr_stride, int n_cta, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int smem = (int)tc_layout(d, false).smem;
  int err = (int)cudaFuncSetAttribute(neus_tc_fwd_kernel<true>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  const FwdOut out{sdf, grad, nullptr, nullptr, nullptr, alpha, cdf, inside, rgb};
  neus_tc_fwd_kernel<true><<<n_cta, TNT, smem, st>>>(d, pp, wts, (const uint2*)pk, rays_o, rays_d, mid_z, dists, inv_s, cos_r, R, out, eik_part, (unsigned char*)scr, scr_stride);
  err = (int)cudaGetLastError();
  if (err) return err;
  return reduce_partials(eik_part, n_cta, 2, eik, st);
}

// elements a row of the backward's weight-gradient log; CTAs of one
// weight-gradient pass (times its splits)
long long neus_tc_log_row(Dims d) { return wlog_layout(d).row; }
int neus_tc_wgrad_tiles(Dims d) {
  const WProbs ps = wgrad_problems(d);
  int n = 0;
  for (int i = 0; i < ps.n; ++i) n += wgrad_tiles(ps.p[i]);
  return n;
}

}  // extern "C"

namespace {

// The chunked backward of B1 or B3 (POINT): per chunk the per-ray kernel,
// then wgrad_kernel over the chunk's log; the partial rows summed at the end.
template <bool POINT>
int tc_bwd(Dims d, Pack pp, const float* wts, const void* pk, const float* rays_o,
           const float* rays_d, const float* mid_z, const float* dists, const float* inv_s,
           float cos_r, int R, const float* sdf_res, const float* g_res, const BwdCots& ct,
           float* d_o, float* d_d, float* d_z, float* d_t, float* d_w, float* gpart, void* scr,
           long long scr_stride, int n_cta, void* log, int chunk, int n_split, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int smem = (int)tc_layout(d, true).smem;
  int err = (int)cudaFuncSetAttribute(neus_tc_bwd_kernel<POINT>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (err) return err;
  const WLog lg = wlog_layout(d);
  const WProbs ps = wgrad_problems(d);
  const long long stride = (long long)weight_offsets(d).total + 1;
  const dim3 wgrid(neus_tc_wgrad_tiles(d), n_split);
  for (int ray0 = 0; ray0 < R; ray0 += chunk) {
    const int ray1 = ray0 + chunk < R ? ray0 + chunk : R;
    neus_tc_bwd_kernel<POINT><<<n_cta, TNT, smem, st>>>(d, pp, wts, (const uint2*)pk, rays_o, rays_d, mid_z, dists, inv_s, cos_r, R, sdf_res, g_res, ct, d_o, d_d, d_z, d_t, gpart, (unsigned char*)scr, scr_stride, lg, (bf16*)log, (long long)(ray1 - ray0) * ROWS, ray0, ray1);
    err = (int)cudaGetLastError();
    if (err) return err;
    wgrad_kernel<<<wgrid, WG_THREADS, WG_SMEM, st>>>(lg, ps, (const bf16*)log, (long long)(ray1 - ray0) * ROWS, n_split, gpart + (size_t)n_cta * stride, stride);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return reduce_partials(gpart, n_cta + 2 * n_split, stride, d_w, st);
}

}  // namespace

extern "C" {

// Backward: as neus_ray_bwd, d_w has weight_count + 1 floats (the inv_s
// gradient last). The rays run in chunks of `chunk`: the per-ray kernel
// (n_cta CTAs; scr an (n_cta, scr_stride)-byte scratch) writes the chunk's
// weight-gradient operands into log (chunk * 64 rows of neus_tc_log_row
// elements), then wgrad_kernel forms the weight gradients with n_split
// splits of the points. gpart: (n_cta + 2 n_split) partial rows of
// weight_count + 1 floats, zero on entry (the per-ray kernel's biases,
// sdf-row weights and inv_s, then the weight-gradient splits), summed in a
// fixed order into d_w.
int neus_ray_tc_bwd(Dims d, Pack pp, const float* wts, const void* pk, const float* rays_o,
                    const float* rays_d, const float* mid_z, const float* dists,
                    const float* inv_s, float cos_r, int R, const float* sdf_res,
                    const float* g_res, const float* c_col, const float* c_nw, const float* c_ws,
                    const float* c_eik, float* d_o, float* d_d, float* d_z, float* d_t,
                    float* d_w, float* gpart, void* scr, long long scr_stride, int n_cta,
                    void* log, int chunk, int n_split, void* stream) {
  const BwdCots ct{c_col, c_nw, c_ws, nullptr, nullptr, nullptr, nullptr, nullptr, c_eik};
  return tc_bwd<false>(d, pp, wts, pk, rays_o, rays_d, mid_z, dists, inv_s, cos_r, R, sdf_res,
                       g_res, ct, d_o, d_d, d_z, d_t, d_w, gpart, scr, scr_stride, n_cta, log,
                       chunk, n_split, stream);
}

// B3's backward: as neus_point_bwd (fused_neus_point.cu), on the tensor
// cores, with the packed bf16 weights pk (offsets pp) beside the flat f32
// ones; the chunks, log, scratch and partial rows as neus_ray_tc_bwd's.
int neus_point_tc_bwd(Dims d, Pack pp, const float* wts, const void* pk, const float* rays_o,
                      const float* rays_d, const float* mid_z, const float* dists,
                      const float* inv_s, float cos_r, int R, const float* sdf_res,
                      const float* g_res, const float* c_sdf, const float* c_alpha,
                      const float* c_cdf, const float* c_grad, const float* c_rgb,
                      const float* c_eik, float* d_o, float* d_d, float* d_z, float* d_t,
                      float* d_w, float* gpart, void* scr, long long scr_stride, int n_cta,
                      void* log, int chunk, int n_split, void* stream) {
  const BwdCots ct{nullptr, nullptr, nullptr, c_sdf, c_alpha, c_cdf, c_grad, c_rgb, c_eik};
  return tc_bwd<true>(d, pp, wts, pk, rays_o, rays_d, mid_z, dists, inv_s, cos_r, R, sdf_res,
                      g_res, ct, d_o, d_d, d_z, d_t, d_w, gpart, scr, scr_stride, n_cta, log,
                      chunk, n_split, stream);
}

// B6's backward: as sdf_bwd (fused_sdf.cu), with the packed bf16 SDF
// weights pk (offsets pp) beside the flat f32 ones (Dims with no colour
// net: HC = NHC = W = 0). The n_pts points run in chunks of `chunk` tiles
// of 64: the per-tile kernel (n_cta CTAs; scr an (n_cta, scr_stride)-byte
// scratch, neus_tc_scratch_bytes(d, 1)) writes the chunk's weight-gradient
// operands into log (chunk * 64 rows of neus_tc_log_row elements), then
// wgrad_kernel forms the weight gradients with n_split splits of the
// points. gpart: (n_cta + 2 n_split) partial rows of weight_count floats,
// zero on entry, summed in a fixed order into d_w.
int sdf_tc_bwd(Dims d, Pack pp, const float* wts, const void* pk, const float* pts, int n_pts,
               const float* c_sdf, const float* c_feat, const float* c_grad, float* d_pts,
               float* d_w, float* gpart, void* scr, long long scr_stride, int n_cta, void* log,
               int chunk, int n_split, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int smem = (int)tc_layout(d, true).smem;
  int err = (int)cudaFuncSetAttribute(sdf_tc_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      smem);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (err) return err;
  const WLog lg = wlog_layout(d);
  const WProbs ps = wgrad_problems(d);
  const long long stride = (long long)weight_offsets(d).total;
  const dim3 wgrid(neus_tc_wgrad_tiles(d), n_split);
  const int n_blk = (n_pts + ROWS - 1) / ROWS;
  for (int blk0 = 0; blk0 < n_blk; blk0 += chunk) {
    const int blk1 = blk0 + chunk < n_blk ? blk0 + chunk : n_blk;
    const long long rows = (long long)(blk1 - blk0) * ROWS;
    sdf_tc_bwd_kernel<<<n_cta, TNT, smem, st>>>(d, pp, wts, (const uint2*)pk, pts, n_pts, c_sdf, c_feat, c_grad, d_pts, gpart, (unsigned char*)scr, scr_stride, lg, (bf16*)log, rows, blk0, blk1);
    err = (int)cudaGetLastError();
    if (err) return err;
    wgrad_kernel<<<wgrid, WG_THREADS, WG_SMEM, st>>>(lg, ps, (const bf16*)log, rows, n_split, gpart + (size_t)n_cta * stride, stride);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return reduce_partials(gpart, n_cta + 2 * n_split, stride, d_w, st);
}

// B6's forward: as sdf_fwd (fused_sdf.cu), with the packed bf16 SDF weights
// pk (offsets pp) beside the flat f32 ones (Dims with no colour net); scr an
// (n_cta, scr_stride)-byte scratch (neus_tc_scratch_bytes(d, 0)).
int sdf_tc_fwd(Dims d, Pack pp, const float* wts, const void* pk, const float* pts, int n_pts,
               float* sdf, float* feat, float* grad, void* scr, long long scr_stride, int n_cta,
               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int smem = (int)tc_layout(d, false).smem;
  int err = (int)cudaFuncSetAttribute(sdf_tc_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      smem);
  if (err) return err;
  sdf_tc_fwd_kernel<<<n_cta, TNT, smem, st>>>(d, pp, wts, (const uint2*)pk, pts, n_pts, sdf, feat, grad, (unsigned char*)scr, scr_stride);
  return (int)cudaGetLastError();
}

// #12's forward: as sdf_only_fwd (fused_sdf.cu), with the packed bf16
// matrices of the SDF stack pk (offsets pp: the hidden and skip-producing
// layers' forward forms, ops/fused_neus.py's pack_sdf_only_tc) beside the
// flat f32 weights (Dims with no colour net; the head's sdf row and every
// bias are read from there); scr an (n_cta, scr_stride)-byte scratch
// (neus_tc_scratch_bytes(d, 0): the kernel uses its AS region).
int sdf_only_tc_fwd(Dims d, Pack pp, const float* wts, const void* pk, const float* pts,
                    int n_pts, float* sdf, void* scr, long long scr_stride, int n_cta,
                    void* stream) {
  const int smem = (int)tc_layout(d, false).smem;
  int err = (int)cudaFuncSetAttribute(sdf_only_tc_fwd_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  sdf_only_tc_fwd_kernel<<<n_cta, TNT, smem, (cudaStream_t)stream>>>(d, pp, wts, (const uint2*)pk, pts, n_pts, sdf, (unsigned char*)scr, scr_stride);
  return (int)cudaGetLastError();
}

// B7's backward: as colour_bwd (fused_color.cu) for Dims of the colour net
// alone (H = 0; CW = the first layer's input width, the feature from CW -
// F), with the packed bf16 colour weights pk (offsets pp) and their flat f32
// buffer in weight_offsets' colour layout (the first layer one (HC, CW)
// matrix over the mode's columns cx, cn, cv; -1: not read, whose cotangent
// is left as it is). The n_pts points run in chunks of `chunk` tiles of 64:
// the per-tile kernel (n_cta CTAs) writes the chunk's weight-gradient
// operands into log (chunk * 64 rows of neus_tc_log_row elements), then
// wgrad_kernel forms the weight gradients with n_split splits of the points.
// gpart: (n_cta + n_split) partial rows of weight_count floats, zero on
// entry, summed in a fixed order into d_w.
int colour_tc_bwd(Dims d, Pack pp, const float* wts, const void* pk, const float* x,
                  const float* n, const float* v, const float* f, int n_pts, int cx, int cn,
                  int cv, const float* c_out, float* dx, float* dn, float* dv, float* df,
                  float* d_w, float* gpart, int n_cta, void* log, int chunk, int n_split,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int smem = (int)tc_layout(d, true).smem;
  int err = (int)cudaFuncSetAttribute(colour_tc_bwd_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (err) return err;
  const WLog lg = wlog_layout(d);
  const WProbs ps = wgrad_problems(d);  // the colour problems: all of partial-sum set 0
  const long long stride = (long long)weight_offsets(d).total;
  const dim3 wgrid(neus_tc_wgrad_tiles(d), n_split);
  const int n_blk = (n_pts + ROWS - 1) / ROWS;
  for (int blk0 = 0; blk0 < n_blk; blk0 += chunk) {
    const int blk1 = blk0 + chunk < n_blk ? blk0 + chunk : n_blk;
    const long long rows = (long long)(blk1 - blk0) * ROWS;
    colour_tc_bwd_kernel<<<n_cta, TNT, smem, st>>>(d, pp, wts, (const uint2*)pk, x, n, v, f, n_pts, cx, cn, cv, c_out, dx, dn, dv, df, gpart, lg, (bf16*)log, rows, blk0, blk1);
    err = (int)cudaGetLastError();
    if (err) return err;
    wgrad_kernel<<<wgrid, WG_THREADS, WG_SMEM, st>>>(lg, ps, (const bf16*)log, rows, n_split, gpart + (size_t)n_cta * stride, stride);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return reduce_partials(gpart, n_cta + n_split, stride, d_w, st);
}

// B7's forward: as colour_fwd (fused_color.cu) for Dims of the colour net
// alone, with the packed bf16 colour weights pk (offsets pp) and their flat
// f32 buffer in weight_offsets' colour layout, the mode's columns cx, cn, cv
// (-1: not read); f 16-byte aligned. n_cta persistent CTAs; out (n_pts, W).
int colour_tc_fwd(Dims d, Pack pp, const float* wts, const void* pk, const float* x,
                  const float* n, const float* v, const float* f, int n_pts, int cx, int cn,
                  int cv, float* out, int n_cta, void* stream) {
  const int smem = (int)colour_fwd_layout(d).smem;
  int err = (int)cudaFuncSetAttribute(colour_tc_fwd_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  colour_tc_fwd_kernel<<<n_cta, TNT, smem, (cudaStream_t)stream>>>(d, pp, wts, (const uint2*)pk, x, n, v, f, n_pts, cx, cn, cv, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
