// Per-ray NeuS compositing pair for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas kernels avatarclip_tpu/ops/fused_composite.py
// `_fwd_kernel` (:73) and `_bwd_kernel` (:82) under the custom VJP `_fused`
// (entry `composite_fused`). Per ray of S <= 64 samples:
//
//   x_k = 1 - alpha_k + 1e-7,  T_k = prod_{j<k} x_j,  w_k = alpha_k T_k
//   color = sum_k w_k rgb_k[:3],  extra = sum_k w_k rgb_k[3:6] (zeros when
//   rgb is 3 wide),  normals = sum_k w_k grad_k
//
// Backward, with u_k = cw_k + cc.rgb_k[:3] + ce.rgb_k[3:6] + cn.grad_k:
//   d alpha_k = T_k (u_k - B_k),  B_{k-1} = u_k alpha_k + x_k B_k,  B_{S-1} = 0
//   d rgb_k = w_k [cc, ce],  d grad_k = w_k cn
// (no division by x_k, which may be ~1e-7).
//
// What bounds it on this card: device memory. Per sample it reads alpha,
// rgb and grad (40 bytes with rgb 6 wide) and writes w (4 bytes); a few
// dozen flops. The backward moves about twice that.
//
// Design: one warp per ray, two adjacent samples per lane (lane l holds
// samples 2l and 2l + 1), so a ray is one coalesced row of the inputs. The
// exclusive transmittance product is a warp-shuffle scan (Hillis-Steele over
// the 32 lanes' pair products); the weighted sums are butterfly reductions;
// the backward's affine recursion for B is a reverse warp scan of the maps
// B -> a + m B, composed pairwise. The Pallas version scanned along the
// sample lanes of a (64 rays x S) VMEM block with static shifts; nothing
// carries across rays, so there is no cross-CTA reduction.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;  // warps (rays in flight) per CTA
constexpr unsigned FULL = 0xffffffffu;

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// per lane: its two samples' alpha, x, and exclusive transmittances
struct Pair {
  float a0, a1, x0, x1, T0, T1;
};

__device__ inline Pair load_pair(const float* __restrict__ alpha, int S, int lane) {
  const int k0 = 2 * lane, k1 = k0 + 1;
  Pair p;
  p.a0 = k0 < S ? alpha[k0] : 0.f;
  p.a1 = k1 < S ? alpha[k1] : 0.f;
  p.x0 = k0 < S ? 1.f - p.a0 + 1e-7f : 1.f;
  p.x1 = k1 < S ? 1.f - p.a1 + 1e-7f : 1.f;
  float incl = p.x0 * p.x1;  // inclusive product over lanes <= lane
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl = t * incl;
  }
  const float excl = __shfl_up_sync(FULL, incl, 1);
  p.T0 = lane == 0 ? 1.f : excl;
  p.T1 = p.T0 * p.x0;
  return p;
}

__global__ void __launch_bounds__(WARPS * 32) composite_fwd_kernel(
    int R, int S, int W, const float* __restrict__ alpha, const float* __restrict__ rgb,
    const float* __restrict__ grad, float* __restrict__ w_out, float* __restrict__ color,
    float* __restrict__ extra, float* __restrict__ normals) {
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (ray >= R) return;  // whole warps exit together
  const size_t base = (size_t)ray * S;
  const Pair p = load_pair(alpha + base, S, lane);
  const int k0 = 2 * lane, k1 = k0 + 1;
  const float w0 = p.a0 * p.T0, w1 = p.a1 * p.T1;
  if (k0 < S) w_out[base + k0] = w0;
  if (k1 < S) w_out[base + k1] = w1;
  float acc[9];
#pragma unroll
  for (int c = 0; c < 9; ++c) acc[c] = 0.f;
  const float* rg = rgb + base * W;
  const float* gg = grad + base * 3;
  if (k0 < S) {
    for (int c = 0; c < W; ++c) acc[c] += w0 * rg[k0 * W + c];
    for (int c = 0; c < 3; ++c) acc[6 + c] += w0 * gg[k0 * 3 + c];
  }
  if (k1 < S) {
    for (int c = 0; c < W; ++c) acc[c] += w1 * rg[k1 * W + c];
    for (int c = 0; c < 3; ++c) acc[6 + c] += w1 * gg[k1 * 3 + c];
  }
#pragma unroll
  for (int c = 0; c < 9; ++c) acc[c] = warp_sum(acc[c]);
  if (lane < 3) {
    color[ray * 3 + lane] = acc[lane];
    extra[ray * 3 + lane] = W == 6 ? acc[3 + lane] : 0.f;
    normals[ray * 3 + lane] = acc[6 + lane];
  }
}

__global__ void __launch_bounds__(WARPS * 32) composite_bwd_kernel(
    int R, int S, int W, const float* __restrict__ alpha, const float* __restrict__ rgb,
    const float* __restrict__ grad, const float* __restrict__ cw, const float* __restrict__ cc,
    const float* __restrict__ ce, const float* __restrict__ cn, float* __restrict__ d_alpha,
    float* __restrict__ d_rgb, float* __restrict__ d_grad) {
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (ray >= R) return;
  const size_t base = (size_t)ray * S;
  const Pair p = load_pair(alpha + base, S, lane);
  const int k0 = 2 * lane, k1 = k0 + 1;
  float cot[9];  // [cc, ce, cn] of this ray
  for (int c = 0; c < 3; ++c) {
    cot[c] = cc[ray * 3 + c];
    cot[3 + c] = W == 6 ? ce[ray * 3 + c] : 0.f;
    cot[6 + c] = cn[ray * 3 + c];
  }
  const float* rg = rgb + base * W;
  const float* gg = grad + base * 3;
  float u0 = 0.f, u1 = 0.f;
  if (k0 < S) {
    u0 = cw[base + k0];
    for (int c = 0; c < W; ++c) u0 += cot[c] * rg[k0 * W + c];
    for (int c = 0; c < 3; ++c) u0 += cot[6 + c] * gg[k0 * 3 + c];
  }
  if (k1 < S) {
    u1 = cw[base + k1];
    for (int c = 0; c < W; ++c) u1 += cot[c] * rg[k1 * W + c];
    for (int c = 0; c < 3; ++c) u1 += cot[6 + c] * gg[k1 * 3 + c];
  }
  // f_k(B) = u_k alpha_k + x_k B maps B_k to B_{k-1}; this lane's pair map
  // F = f_k0 o f_k1 is B -> a + m B. Inclusive suffix composition over
  // lanes: lane l ends with F_l o ... o F_31, whose value at 0 is B_{k0-1}.
  float a = p.a0 * u0 + p.x0 * p.a1 * u1, m = p.x0 * p.x1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float a2 = __shfl_down_sync(FULL, a, o);
    const float m2 = __shfl_down_sync(FULL, m, o);
    if (lane + o < 32) {
      a = a + m * a2;
      m = m * m2;
    }
  }
  float B1 = __shfl_down_sync(FULL, a, 1);  // B_{k1} = (F_{l+1} o ...)(0)
  if (lane == 31) B1 = 0.f;
  const float B0 = p.a1 * u1 + p.x1 * B1;  // B_{k0}
  const float w0 = p.a0 * p.T0, w1 = p.a1 * p.T1;
  if (k0 < S) {
    d_alpha[base + k0] = p.T0 * (u0 - B0);
    for (int c = 0; c < W; ++c) d_rgb[(base + k0) * W + c] = w0 * cot[c];
    for (int c = 0; c < 3; ++c) d_grad[(base + k0) * 3 + c] = w0 * cot[6 + c];
  }
  if (k1 < S) {
    d_alpha[base + k1] = p.T1 * (u1 - B1);
    for (int c = 0; c < W; ++c) d_rgb[(base + k1) * W + c] = w1 * cot[c];
    for (int c = 0; c < 3; ++c) d_grad[(base + k1) * 3 + c] = w1 * cot[6 + c];
  }
}

inline int n_blocks(int R) { return (R + WARPS - 1) / WARPS; }

}  // namespace

extern "C" {

// alpha (R, S), rgb (R, S, W), grad (R, S, 3) -> w (R, S), color, extra,
// normals (R, 3). S <= 64, W in {3, 6}.
int composite_fwd(int R, int S, int W, const float* alpha, const float* rgb, const float* grad,
                  float* w, float* color, float* extra, float* normals, void* stream) {
  if (R == 0) return 0;
  composite_fwd_kernel<<<n_blocks(R), WARPS * 32, 0, (cudaStream_t)stream>>>(R, S, W, alpha, rgb, grad, w, color, extra, normals);
  return (int)cudaGetLastError();
}

// cotangents cw (R, S), cc, ce, cn (R, 3) -> d_alpha (R, S), d_rgb (R, S, W),
// d_grad (R, S, 3)
int composite_bwd(int R, int S, int W, const float* alpha, const float* rgb, const float* grad,
                  const float* cw, const float* cc, const float* ce, const float* cn,
                  float* d_alpha, float* d_rgb, float* d_grad, void* stream) {
  if (R == 0) return 0;
  composite_bwd_kernel<<<n_blocks(R), WARPS * 32, 0, (cudaStream_t)stream>>>(R, S, W, alpha, rgb, grad, cw, cc, ce, cn, d_alpha, d_rgb, d_grad);
  return (int)cudaGetLastError();
}

}  // extern "C"
