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
// What bounds it on this card: device memory. Per sample the forward reads
// alpha, rgb and grad (40 bytes with rgb 6 wide) and writes w (4 bytes); a
// few dozen flops: 46.7 MB, 0.0139 ms at 3.35 TB/s, at the validation
// chunk of 16,384 rays x 64. The backward moves about twice that.
//
// Forward design: a CTA of 4 warps takes 4 consecutive rays, whose alpha,
// rgb and grad rows are three contiguous spans of the inputs. It stages
// the spans into shared memory with cp.async (16-byte copies on each span's
// aligned interior, coalesced across the CTA, their L2 lines marked
// evict-first; single floats at its two ends: stage(), whose Python twin is
// ops/fused_composite.stage_plan), all issued at once, alpha in its own
// group: the transmittance scan starts as soon as alpha has landed while
// the rgb and grad rows are still in flight, and the other resident CTAs
// (16 an SM, 10 KB of shared memory each) keep the memory busy while this
// one computes. Then one warp a ray: lane l holds samples l and l + 32 (the
// rows read from shared memory at a stride of W floats: conflict-free at W
// 3, two-way at W 6), the exclusive transmittance product is two
// warp-shuffle scans (Hillis-Steele) joined by the first half's total, w
// is stored as one coalesced row, and the 9 channel sums are butterfly
// reductions (its times, warm and with the L2 flushed: PERF.md). The
// Pallas version scanned along the sample lanes of a (64 rays x S) VMEM
// block with static shifts; nothing carries across rays, so there is no
// cross-CTA reduction.
//
// Backward design: the forward's staging. A CTA of 4 warps takes 4
// consecutive rays; their alpha, cw, rgb and grad rows (contiguous spans)
// come into shared memory by the same cp.async stage() with the evict-first
// policy, alpha in its own group, so the transmittance scan runs while the
// rest is in flight. One warp a ray, lane l holding samples l and l + 32:
// the exclusive product T is the forward's two scans; the affine recursion
// for B a reverse warp scan of the maps B -> u_k alpha_k + x_k B in each half
// of the ray, the first half continued from the second's value at sample
// 32. d alpha is stored as one coalesced row. d rgb and d grad go back over
// the rgb and grad rows the lane read (each lane rewrites only its own
// samples' rows), and after a barrier the CTA writes both spans out with
// 16-byte stores on the destination's aligned interior (unstage(), whose
// Python twin is ops/fused_composite.unstage_plan). 84 bytes a point at rgb
// width 6 (alpha, cw, rgb, grad read; d alpha, d rgb, d grad written) and
// 36 a ray (the colour, extra and normal cotangents): 88.7 MB, 0.0265 ms at
// 3.35 TB/s at 16,384 rays x 64.
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The forward's staging: cp.async global -> shared, 16 bytes (through L2
// only, its lines marked to be evicted first: the rows are read once, and
// the lines they take are the first to go, not lines another kernel left,
// which may be dirty and cost a write-back) or 4
__device__ inline unsigned long long evict_first_policy() {
  unsigned long long pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}
__device__ inline void cp_async16(float* dst, const float* src, unsigned long long pol) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "l"(pol));
}
__device__ inline void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ inline void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

constexpr int RAYS = 4;  // rays a CTA of either pass, one a warp (16 CTAs an SM)
constexpr int MAXS = 64;

// Stage n floats src[0, n) into dst, float j at dst[m + j], where m is the
// number of floats src lies past a 16-byte boundary: the first (4 - m) % 4
// floats one at a time, then 16-byte copies (aligned at both ends), then
// the last n - head - 4 n4 < 4 floats one at a time. Returns m. Every thread
// of the CTA calls it; the copies complete at the caller's wait.
// (ops/fused_composite.stage_plan is its twin.)
__device__ inline int stage(float* dst, const float* __restrict__ src, int n,
                            unsigned long long pol) {
  const int m = (int)(((size_t)src >> 2) & 3);
  const int head = min((4 - m) & 3, n);
  const int n4 = (n - head) >> 2, tail0 = head + 4 * n4;
  for (int i = threadIdx.x; i < n4; i += RAYS * 32)
    cp_async16(dst + m + head + 4 * i, src + head + 4 * i, pol);
  if ((int)threadIdx.x < head) cp_async4(dst + m + threadIdx.x, src + threadIdx.x);
  if ((int)threadIdx.x < n - tail0) cp_async4(dst + m + tail0 + threadIdx.x, src + tail0 + threadIdx.x);
  return m;
}

// lanes: samples k0 = lane and k1 = lane + 32 of a ray's S <= 64
template <int W>
__global__ void __launch_bounds__(RAYS * 32) composite_fwd_kernel(
    int R, int S, const float* __restrict__ alpha, const float* __restrict__ rgb,
    const float* __restrict__ grad, float* __restrict__ w_out, float* __restrict__ color,
    float* __restrict__ extra, float* __restrict__ normals) {
  __shared__ __align__(16) float s_alpha[RAYS * MAXS + 4];
  __shared__ __align__(16) float s_rgb[RAYS * MAXS * W + 4];
  __shared__ __align__(16) float s_grad[RAYS * MAXS * 3 + 4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * RAYS, nr = min(RAYS, R - r0);
  const size_t base = (size_t)r0 * S;
  const unsigned long long pol = evict_first_policy();
  const int ma = stage(s_alpha, alpha + base, nr * S, pol);
  cp_async_commit();
  const int mr = stage(s_rgb, rgb + base * W, nr * S * W, pol);
  const int mg = stage(s_grad, grad + base * 3, nr * S * 3, pol);
  cp_async_commit();
  cp_async_wait<1>();  // this thread's alpha copies
  __syncthreads();     // everyone's
  const int ray = r0 + warp;
  const int k0 = lane, k1 = lane + 32;
  const float* a = s_alpha + ma + warp * S;
  const float a0 = warp < nr && k0 < S ? a[k0] : 0.f;
  const float a1 = warp < nr && k1 < S ? a[k1] : 0.f;
  float p0 = k0 < S ? 1.f - a0 + 1e-7f : 1.f, p1 = k1 < S ? 1.f - a1 + 1e-7f : 1.f;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {  // inclusive products over lanes <= lane
    const float t0 = __shfl_up_sync(FULL, p0, o), t1 = __shfl_up_sync(FULL, p1, o);
    if (lane >= o) {
      p0 = t0 * p0;
      p1 = t1 * p1;
    }
  }
  const float tot0 = __shfl_sync(FULL, p0, 31);
  const float e0 = __shfl_up_sync(FULL, p0, 1), e1 = __shfl_up_sync(FULL, p1, 1);
  const float w0 = a0 * (lane == 0 ? 1.f : e0);
  const float w1 = a1 * (tot0 * (lane == 0 ? 1.f : e1));
  if (warp < nr) {
    if (k0 < S) w_out[base + warp * S + k0] = w0;
    if (k1 < S) w_out[base + warp * S + k1] = w1;
  }
  cp_async_wait<0>();
  __syncthreads();  // the rgb and grad rows
  if (warp >= nr) return;
  const float* rg = s_rgb + mr + warp * S * W;
  const float* gd = s_grad + mg + warp * S * 3;
  float acc[W + 3];
#pragma unroll
  for (int c = 0; c < W; ++c)
    acc[c] = (k0 < S ? w0 * rg[k0 * W + c] : 0.f) + (k1 < S ? w1 * rg[k1 * W + c] : 0.f);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    acc[W + c] = (k0 < S ? w0 * gd[k0 * 3 + c] : 0.f) + (k1 < S ? w1 * gd[k1 * 3 + c] : 0.f);
#pragma unroll
  for (int c = 0; c < W + 3; ++c) acc[c] = warp_sum(acc[c]);
  // lane c < 3 stores channel c of each sum (selected, not indexed: the
  // sums stay in registers)
  auto pick = [&](int c0) { return lane == 0 ? acc[c0] : lane == 1 ? acc[c0 + 1] : acc[c0 + 2]; };
  if (lane < 3) {
    color[ray * 3 + lane] = pick(0);
    extra[ray * 3 + lane] = W == 6 ? pick(3) : 0.f;
    normals[ray * 3 + lane] = pick(W);
  }
}

// Write n floats from shared memory (float j at src[m + j]) to dst: single
// floats up to dst's first 16-byte boundary, 16-byte stores (each from four
// shared reads: src and dst may sit at different offsets from a boundary),
// then the last < 4 floats one at a time. Every thread of the CTA calls it.
// (ops/fused_composite.unstage_plan is its twin.)
__device__ inline void unstage(float* __restrict__ dst, const float* src, int m, int n) {
  const int md = (int)(((size_t)dst >> 2) & 3);
  const int head = min((4 - md) & 3, n);
  const int n4 = (n - head) >> 2, tail0 = head + 4 * n4;
  for (int i = threadIdx.x; i < n4; i += RAYS * 32) {
    const float* s = src + m + head + 4 * i;
    *(float4*)(dst + head + 4 * i) = make_float4(s[0], s[1], s[2], s[3]);
  }
  if ((int)threadIdx.x < head) dst[threadIdx.x] = src[m + threadIdx.x];
  if ((int)threadIdx.x < n - tail0) dst[tail0 + threadIdx.x] = src[m + tail0 + threadIdx.x];
}

template <int W>
__global__ void __launch_bounds__(RAYS * 32) composite_bwd_kernel(
    int R, int S, const float* __restrict__ alpha, const float* __restrict__ rgb,
    const float* __restrict__ grad, const float* __restrict__ cw, const float* __restrict__ cc,
    const float* __restrict__ ce, const float* __restrict__ cn, float* __restrict__ d_alpha,
    float* __restrict__ d_rgb, float* __restrict__ d_grad) {
  __shared__ __align__(16) float s_alpha[RAYS * MAXS + 4];
  __shared__ __align__(16) float s_cw[RAYS * MAXS + 4];
  __shared__ __align__(16) float s_rgb[RAYS * MAXS * W + 4];
  __shared__ __align__(16) float s_grad[RAYS * MAXS * 3 + 4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * RAYS, nr = min(RAYS, R - r0);
  const size_t base = (size_t)r0 * S;
  const unsigned long long pol = evict_first_policy();
  const int ma = stage(s_alpha, alpha + base, nr * S, pol);
  cp_async_commit();
  const int mw = stage(s_cw, cw + base, nr * S, pol);
  const int mr = stage(s_rgb, rgb + base * W, nr * S * W, pol);
  const int mg = stage(s_grad, grad + base * 3, nr * S * 3, pol);
  cp_async_commit();
  cp_async_wait<1>();  // this thread's alpha copies
  __syncthreads();     // everyone's
  const bool live = warp < nr;
  const int k0 = lane, k1 = lane + 32;
  const float* a = s_alpha + ma + warp * S;
  const float a0 = live && k0 < S ? a[k0] : 0.f;
  const float a1 = live && k1 < S ? a[k1] : 0.f;
  const float x0 = k0 < S ? 1.f - a0 + 1e-7f : 1.f, x1 = k1 < S ? 1.f - a1 + 1e-7f : 1.f;
  float p0 = x0, p1 = x1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {  // inclusive products over lanes <= lane
    const float t0 = __shfl_up_sync(FULL, p0, o), t1 = __shfl_up_sync(FULL, p1, o);
    if (lane >= o) {
      p0 = t0 * p0;
      p1 = t1 * p1;
    }
  }
  const float tot0 = __shfl_sync(FULL, p0, 31);
  const float e0 = __shfl_up_sync(FULL, p0, 1), e1 = __shfl_up_sync(FULL, p1, 1);
  const float T0 = lane == 0 ? 1.f : e0;
  const float T1 = tot0 * (lane == 0 ? 1.f : e1);
  cp_async_wait<0>();
  __syncthreads();  // the cw, rgb and grad rows
  const int ray = r0 + warp;
  float cot[9];  // [cc, ce, cn] of this ray
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    cot[c] = live ? cc[ray * 3 + c] : 0.f;
    cot[3 + c] = live && W == 6 ? ce[ray * 3 + c] : 0.f;
    cot[6 + c] = live ? cn[ray * 3 + c] : 0.f;
  }
  float* rg = s_rgb + mr + warp * S * W;
  float* gd = s_grad + mg + warp * S * 3;
  const float* cwr = s_cw + mw + warp * S;
  auto u_of = [&](int k) {
    float u = cwr[k];
#pragma unroll
    for (int c = 0; c < W; ++c) u += cot[c] * rg[k * W + c];
#pragma unroll
    for (int c = 0; c < 3; ++c) u += cot[6 + c] * gd[k * 3 + c];
    return u;
  };
  const float u0 = live && k0 < S ? u_of(k0) : 0.f;
  const float u1 = live && k1 < S ? u_of(k1) : 0.f;
  // f_k(B) = u_k alpha_k + x_k B maps B_k to B_{k-1}. In each half, lane l
  // composes the maps of its half's samples >= its own (a reverse scan of
  // (m, c): B -> c + m B), so C evaluated at 0 is B_{k-1} with the half
  // ending at B = 0; the first half then continues from the second half's
  // value at its first sample, B_31.
  float M0 = x0, C0 = u0 * a0, M1 = x1, C1 = u1 * a1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float m0 = __shfl_down_sync(FULL, M0, o), c0 = __shfl_down_sync(FULL, C0, o);
    const float m1 = __shfl_down_sync(FULL, M1, o), c1 = __shfl_down_sync(FULL, C1, o);
    if (lane + o < 32) {
      C0 = C0 + M0 * c0;
      M0 = M0 * m0;
      C1 = C1 + M1 * c1;
      M1 = M1 * m1;
    }
  }
  const float F32 = __shfl_sync(FULL, C1, 0);  // B_31
  const float F0 = C0 + M0 * F32;              // B_{k0 - 1}
  const float n0 = __shfl_down_sync(FULL, F0, 1), n1 = __shfl_down_sync(FULL, C1, 1);
  const float B0 = lane == 31 ? F32 : n0, B1 = lane == 31 ? 0.f : n1;  // B_k0, B_k1
  const float w0 = a0 * T0, w1 = a1 * T1;
  if (live) {
    float* da = d_alpha + base + warp * S;
    if (k0 < S) {
      da[k0] = T0 * (u0 - B0);
#pragma unroll
      for (int c = 0; c < W; ++c) rg[k0 * W + c] = w0 * cot[c];
#pragma unroll
      for (int c = 0; c < 3; ++c) gd[k0 * 3 + c] = w0 * cot[6 + c];
    }
    if (k1 < S) {
      da[k1] = T1 * (u1 - B1);
#pragma unroll
      for (int c = 0; c < W; ++c) rg[k1 * W + c] = w1 * cot[c];
#pragma unroll
      for (int c = 0; c < 3; ++c) gd[k1 * 3 + c] = w1 * cot[6 + c];
    }
  }
  __syncthreads();  // every ray's d rgb and d grad rows
  unstage(d_rgb + base * W, s_rgb, mr, nr * S * W);
  unstage(d_grad + base * 3, s_grad, mg, nr * S * 3);
}

}  // namespace

extern "C" {

// alpha (R, S), rgb (R, S, W), grad (R, S, 3) -> w (R, S), color, extra,
// normals (R, 3). S <= 64, W in {3, 6}.
int composite_fwd(int R, int S, int W, const float* alpha, const float* rgb, const float* grad,
                  float* w, float* color, float* extra, float* normals, void* stream) {
  if (R == 0) return 0;
  if (S < 1 || S > MAXS || (W != 3 && W != 6)) return (int)cudaErrorInvalidValue;
  if (W == 6)
    composite_fwd_kernel<6><<<(R + RAYS - 1) / RAYS, RAYS * 32, 0, (cudaStream_t)stream>>>(R, S, alpha, rgb, grad, w, color, extra, normals);
  else
    composite_fwd_kernel<3><<<(R + RAYS - 1) / RAYS, RAYS * 32, 0, (cudaStream_t)stream>>>(R, S, alpha, rgb, grad, w, color, extra, normals);
  return (int)cudaGetLastError();
}

// cotangents cw (R, S), cc, ce, cn (R, 3) -> d_alpha (R, S), d_rgb (R, S, W),
// d_grad (R, S, 3). S <= 64, W in {3, 6}.
int composite_bwd(int R, int S, int W, const float* alpha, const float* rgb, const float* grad,
                  const float* cw, const float* cc, const float* ce, const float* cn,
                  float* d_alpha, float* d_rgb, float* d_grad, void* stream) {
  if (R == 0) return 0;
  if (S < 1 || S > MAXS || (W != 3 && W != 6)) return (int)cudaErrorInvalidValue;
  const int blocks = (R + RAYS - 1) / RAYS;
  if (W == 6)
    composite_bwd_kernel<6><<<blocks, RAYS * 32, 0, (cudaStream_t)stream>>>(R, S, alpha, rgb, grad, cw, cc, ce, cn, d_alpha, d_rgb, d_grad);
  else
    composite_bwd_kernel<3><<<blocks, RAYS * 32, 0, (cudaStream_t)stream>>>(R, S, alpha, rgb, grad, cw, cc, ce, cn, d_alpha, d_rgb, d_grad);
  return (int)cudaGetLastError();
}

}  // extern "C"
