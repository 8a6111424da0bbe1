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
// What bounds it on this card: arithmetic on the live pairs, those with
// x > -104, where the sigmoid is not exactly 0 in f32 (below, exp(x)
// underflows and every term of the pair is exactly 0). On the pose
// optimizer's 224^2 views of a 13,776-face body about a third of all
// (pixel, face) pairs are live: the min-over-edge-lines distance stays
// within reach of sigma over a triangle ~55 px larger than the face. A live
// pair needs ~31 f32 operations and two special functions (exp and a
// reciprocal) forward, ~50 operations and the same two backward (counted in
// chip_smoke.py's SOFT_* constants); the faces
// (64 B each) and pixels (20 B each) are few bytes beside that. Three things
// held the earlier design (one 32-pixel row a warp, one face a thread)
// far above that count, and this one answers each:
//  * Culling at the grain a warp executes. A warp's pixels are a compact
//    8 x 8 patch (two pixels a lane, one column apart by 4 rows), and a face
//    is evaluated on it only if the exact half-plane test of the table
//    (every edge's maximum over the patch >= -(104 sigma + 1 px), the order
//    of ops/fused_soft.patch_keep) keeps it: a superset of the live pairs,
//    warp-uniform, on top of the table's (32 x 32 tile, 512-face block) skip.
//    The forward's lanes test 32 faces at once and ballot; the backward's
//    lanes test the 16 patches of a tile for one face.
//  * Divergence. Forward: lanes are pixels and the face is uniform, so a
//    warp idles only on the live region's rim. Backward: lanes are pixels
//    too, one face at a time, each lane summing its pixels' 13 gradient
//    terms; a (face, tile) is folded by a reduce-scatter over the warp (62
//    shuffle steps, lane 2c ends with column c) into a per-face sum in
//    shared memory, tile after tile in a fixed order.
//  * Filling the card. Forward CTAs cover 32 x 16 pixels (8 patches) for
//    one of K interleaved ranges of 256-face stages; backward CTAs take 128
//    faces (16 a warp) for one of K interleaved ranges of the 32 x 32
//    tiles. The wrapper picks K so that a call launches ~64 CTAs an SM at 2
//    views as at 5 (several waves: CTAs of unequal work balance), and a
//    second, small kernel sums the K partials in a fixed order
//    (soft_fwd_reduce, soft_bwd_reduce).
// Per live pair the forward uses ex2.approx on 64 - |x| log2(e) (a normal
// float) times 2^-64 for exp(-|x|), so a subnormal e (x in (-104, -87]) is
// rounded as IEEE does and not flushed; rcp.approx of 1 + e in [1, 2]; and
// softplus summed as max(x, 0) plus the log of a running product of the
// (1 + e) over at most 32 faces (each factor in [1, 2]), one lg2 a run.
// Deterministic: no atomics, every sum in a fixed order, so two launches on
// the same inputs give the same bits. The depth weights saturate at ezf =
// e^60 for nearly every face, so den reaches ~1e30 and the backward's
// cotangents ~1e-30: the product is formed as dw * ezf * s * (1 - s), with
// 1 - s taken as e / (1 + e) or 1 / (1 + e) rather than by a subtraction.
// The edge distances use separately rounded products and sums (__fmul_rn /
// __fadd_rn), the order of the plain PyTorch version, so ties of the min
// fall on the same pairs in both.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;     // the culling table's screen tile
constexpr int FBLOCK = 512;  // the culling table's face block
constexpr int PATCH = 8;     // a warp's pixels: 8 x 8, two a lane
constexpr float HALF = 0.5f * (PATCH - 1);
constexpr int NT = 256;      // threads a CTA, both kernels
constexpr int CW = 32, CH = 16;  // forward CTA: 4 x 2 patches
constexpr int STAGE = 256;   // forward: faces staged in shared memory at a time
constexpr int GROUP = 128;   // backward: faces a CTA
constexpr int FPW = GROUP / (NT / 32);  // backward: faces a warp
constexpr int NG = 13;       // gradient columns of a face row
constexpr int NO = 5;        // forward outputs a pixel: sil_log, num (3), den
constexpr float X_DEAD = -104.f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

#ifdef __CUDACC__
__device__ __forceinline__ float ex2_ftz(float t) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(t));
  return r;
}
__device__ __forceinline__ float rcp_ftz(float t) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(t));
  return r;
}
__device__ __forceinline__ float lg2_ftz(float t) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(t));
  return r;
}
#else
// host compilers (a CPU rehearsal of the kernels) supply their own
float ex2_ftz(float t);
float rcp_ftz(float t);
float lg2_ftz(float t);
#endif

// exp(-|x|), not flushed: 2^(64 - |x| log2 e) is normal for |x| < 104, and
// the product by 2^-64 rounds a subnormal result as IEEE does
__device__ __forceinline__ float exp_neg_abs(float x) {
  return ex2_ftz(fmaf(fabsf(x), -LOG2E, 64.f)) * 0x1p-64f;
}

// the maximum of a v_e over the 8 x 8 patch centred at (xc, yc), in the
// order of the table's test: xc a + yc b + ((c + |a| h) + |b| h)
__device__ __forceinline__ float edge_max(float xc, float yc, float a, float b, float c) {
  const float k = __fadd_rn(__fadd_rn(c, __fmul_rn(fabsf(a), HALF)), __fmul_rn(fabsf(b), HALF));
  return __fadd_rn(__fadd_rn(__fmul_rn(xc, a), __fmul_rn(yc, b)), k);
}

// can the face (q0..q2) reach the patch centred at (xc, yc)?
__device__ __forceinline__ bool reaches(const float4& q0, const float4& q1, const float4& q2,
                                        float xc, float yc, float thresh) {
  return (edge_max(xc, yc, q0.x, q0.y, q0.z) >= thresh) &
         (edge_max(xc, yc, q0.w, q1.x, q1.y) >= thresh) &
         (edge_max(xc, yc, q1.z, q1.w, q2.x) >= thresh);
}

struct Edges {  // the three v_e and their min at one pixel
  float v0, v1, v2, d;
};

// pa_e = px * a_e, shared by a lane's two pixels (one column)
__device__ __forceinline__ Edges edges(float pa0, float pa1, float pa2, float py,
                                       const float4& q0, const float4& q1, const float4& q2) {
  Edges E;
  E.v0 = __fadd_rn(__fadd_rn(pa0, __fmul_rn(py, q0.y)), q0.z);
  E.v1 = __fadd_rn(__fadd_rn(pa1, __fmul_rn(py, q1.x)), q1.y);
  E.v2 = __fadd_rn(__fadd_rn(pa2, __fmul_rn(py, q1.w)), q2.x);
  E.d = fminf(fminf(E.v0, E.v1), E.v2);
  return E;
}

struct FwdAcc {
  float pos;   // sum of max(x, 0)
  float prod;  // running product of (1 + e), at most 32 factors
  float lg;    // sum of lg2 of the folded products
  float r, g, b, den;
};

__device__ __forceinline__ void fwd_pair(FwdAcc& A, float pa0, float pa1, float pa2, float py,
                                         const float4& q0, const float4& q1, const float4& q2,
                                         const float4& q3, float inv_sigma) {
  const float x = edges(pa0, pa1, pa2, py, q0, q1, q2).d * inv_sigma;
  if (x > X_DEAD) {
    const float e = exp_neg_abs(x);
    const float u = 1.f + e;
    const float r = rcp_ftz(u);
    const float s = x >= 0.f ? r : e * r;  // sigmoid(x)
    A.pos += fmaxf(x, 0.f);                // softplus(x) = max(x, 0) + log(1 + e)
    A.prod *= u;
    const float w = s * q2.y;
    A.r += w * q2.z;
    A.g += w * q2.w;
    A.b += w * q3.x;
    A.den += w;
  }
}

// one pixel's partial outputs (NO planes of H * W) from its accumulators
__device__ __forceinline__ void store_fwd(float* out, const FwdAcc& A, int x, int y, int H, int W) {
  if (x >= W || y >= H) return;
  const size_t P = (size_t)H * W, p = (size_t)y * W + x;
  out[p] = 0.f - (A.pos + LN2 * A.lg);
  out[P + p] = A.r;
  out[2 * P + p] = A.g;
  out[3 * P + p] = A.b;
  out[4 * P + p] = A.den;
}

__global__ void __launch_bounds__(NT) soft_fwd_kernel(
    const float4* __restrict__ faces,  // (B, Fp, 16) as float4
    const int* __restrict__ tab,       // (B, n_tiles, n_fb)
    float* __restrict__ part,          // (K, B, NO, H * W)
    int H, int W, int n_fb, int K, float inv_sigma, float thresh) {
  __shared__ float4 s_face[STAGE * 4];
  const int b = blockIdx.y, B = gridDim.y;
  const int n_cx = (W + CW - 1) / CW, n_cells = n_cx * ((H + CH - 1) / CH);
  const int cell = blockIdx.x % n_cells, k = blockIdx.x / n_cells;
  const int cx0 = (cell % n_cx) * CW, cy0 = (cell / n_cx) * CH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int x0 = cx0 + (warp & 3) * PATCH, y0 = cy0 + (warp >> 2) * PATCH;
  const bool patch_in = x0 < W && y0 < H;  // warp-uniform
  const float xc = (float)x0 + HALF, yc = (float)y0 + HALF;
  const int pxi = x0 + (lane & 7), pyi = y0 + (lane >> 3);
  const float px = (float)pxi, py0 = (float)pyi, py1 = (float)(pyi + 4);
  FwdAcc A0 = {0.f, 1.f, 0.f, 0.f, 0.f, 0.f, 0.f}, A1 = A0;
  const int n_tx = (W + TILE - 1) / TILE, n_tiles = n_tx * ((H + TILE - 1) / TILE);
  const int* tb = tab + ((size_t)b * n_tiles + (cy0 / TILE) * n_tx + cx0 / TILE) * n_fb;
  const int n_stage = n_fb * (FBLOCK / STAGE);
  const float4* fv = faces + (size_t)b * n_stage * STAGE * 4;
  for (int st = k; st < n_stage; st += K) {
    if (tb[st / (FBLOCK / STAGE)] == 0) continue;  // CTA-uniform
    __syncthreads();
    const float4* src = fv + (size_t)st * STAGE * 4;
    for (int i = threadIdx.x; i < STAGE * 4; i += NT) s_face[i] = src[i];
    __syncthreads();
    if (!patch_in) continue;
    for (int c = 0; c < STAGE; c += 32) {
      const float4* mine = s_face + (c + lane) * 4;
      const bool keep = mine[3].y != 0.f && reaches(mine[0], mine[1], mine[2], xc, yc, thresh);
      unsigned m = __ballot_sync(FULL, keep);
      if (m == 0) continue;
      do {
        const float4* fq = s_face + (c + __ffs(m) - 1) * 4;
        m &= m - 1;
        const float4 q0 = fq[0], q1 = fq[1], q2 = fq[2], q3 = fq[3];
        const float pa0 = __fmul_rn(px, q0.x), pa1 = __fmul_rn(px, q0.w), pa2 = __fmul_rn(px, q1.z);
        fwd_pair(A0, pa0, pa1, pa2, py0, q0, q1, q2, q3, inv_sigma);
        fwd_pair(A1, pa0, pa1, pa2, py1, q0, q1, q2, q3, inv_sigma);
      } while (m);
      // fold the run's product (<= 2^32) into the log sum
      A0.lg += lg2_ftz(A0.prod);
      A1.lg += lg2_ftz(A1.prod);
      A0.prod = A1.prod = 1.f;
    }
  }
  float* out = part + (size_t)(k * B + b) * NO * H * W;
  store_fwd(out, A0, pxi, pyi, H, W);
  store_fwd(out, A1, pxi, pyi + 4, H, W);
}

__global__ void soft_fwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ sil_log,
                                       float* __restrict__ num, float* __restrict__ den, int B,
                                       int P, int K) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // b * P + p
  if (i >= B * P) return;
  const int b = i / P, p = i - b * P;
  float a[NO] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < K; ++k) {
    const float* o = part + (size_t)(k * B + b) * NO * P + p;
#pragma unroll
    for (int c = 0; c < NO; ++c) a[c] += o[(size_t)c * P];
  }
  sil_log[i] = a[0];
  num[3 * (size_t)i] = a[1];
  num[3 * (size_t)i + 1] = a[2];
  num[3 * (size_t)i + 2] = a[3];
  den[i] = a[4];
}

// g[0..12] += this pair's gradient terms, cv = (dsil, dnum r, g, b): the
// edge columns without their factor 1 / sigma and the colour columns
// without ezf, both applied once a face when the sums are written
__device__ __forceinline__ void bwd_pair(float* g, float fx, float fy, float pa0, float pa1,
                                         float pa2, const float4& cv, float dden,
                                         const float4& q0, const float4& q1, const float4& q2,
                                         const float4& q3, float inv_sigma) {
  const Edges E = edges(pa0, pa1, pa2, fy, q0, q1, q2);
  const float x = E.d * inv_sigma;
  if (x > X_DEAD) {
    const float e = exp_neg_abs(x);
    const float r = rcp_ftz(1.f + e);
    const float er = e * r;
    const bool pos = x >= 0.f;
    const float s = pos ? r : er;    // sigmoid(x)
    const float oms = pos ? er : r;  // 1 - sigmoid(x)
    const float ezf = q2.y;
    // num += w colf, den += w: dw = dnum . colf + dden
    const float dw = (cv.y * q2.z + cv.z * q2.w + cv.w * q3.x) + dden;
    // sil_log -= softplus(x): d/dd = -sigmoid(x) / sigma
    float dd = dw * ezf * s * oms + cv.x * (-s);
    const bool m0 = E.v0 == E.d, m1 = E.v1 == E.d, m2 = E.v2 == E.d;
    if ((m0 & m1) | (m0 & m2) | (m1 & m2)) dd = dd / (float)((int)m0 + (int)m1 + (int)m2);
    if (m0) { g[0] += fx * dd; g[1] += fy * dd; g[2] += dd; }
    if (m1) { g[3] += fx * dd; g[4] += fy * dd; g[5] += dd; }
    if (m2) { g[6] += fx * dd; g[7] += fy * dd; g[8] += dd; }
    g[9] += dw * s;  // w = s * ezf
    g[10] += s * cv.y;
    g[11] += s * cv.z;
    g[12] += s * cv.w;
  }
}

// v[0..15] summed over the warp, scattered: lanes 2c and 2c + 1 return the
// sum of column c (a fixed order: the same bits on every run)
__device__ __forceinline__ float reduce_scatter16(float* v, int lane) {
#pragma unroll
  for (int h = 8; h >= 1; h >>= 1) {
    const bool hi = (lane & (2 * h)) != 0;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = hi ? v[i] : v[i + h];
      const float keep = hi ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, 2 * h);
    }
  }
  return v[0] + __shfl_xor_sync(FULL, v[0], 1);
}

__global__ void __launch_bounds__(NT) soft_bwd_kernel(
    const float4* __restrict__ faces,  // (B, Fp, 16) as float4
    const int* __restrict__ tab,       // (B, n_tiles, n_fb)
    const float* __restrict__ dsil,    // (B, H * W)
    const float* __restrict__ dnum,    // (B, H * W, 3)
    const float* __restrict__ dden,    // (B, H * W)
    float* __restrict__ part,          // (K, B, Fp, NG)
    int H, int W, int n_fb, int K, float inv_sigma, float thresh) {
  __shared__ float4 s_face[GROUP * 4];
  __shared__ float4 s_cot[TILE * TILE];         // dsil, dnum r, g, b
  __shared__ float s_dden[TILE * (TILE + 1)];   // rows padded: no bank conflicts
  __shared__ float s_acc[GROUP * 16];
  const int b = blockIdx.y, B = gridDim.y;
  const int n_grp = n_fb * (FBLOCK / GROUP);
  const int grp = blockIdx.x % n_grp, k = blockIdx.x / n_grp;
  const int j = grp / (FBLOCK / GROUP);  // the table's face block
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t Fp = (size_t)n_fb * FBLOCK, f0 = (size_t)grp * GROUP;
  const float4* src = faces + ((size_t)b * Fp + f0) * 4;
  for (int i = threadIdx.x; i < GROUP * 4; i += NT) s_face[i] = src[i];
  for (int i = threadIdx.x; i < GROUP * 16; i += NT) s_acc[i] = 0.f;
  const int n_tx = (W + TILE - 1) / TILE, n_tiles = n_tx * ((H + TILE - 1) / TILE);
  const size_t P = (size_t)H * W;
  for (int t = k; t < n_tiles; t += K) {
    if (tab[((size_t)b * n_tiles + t) * n_fb + j] == 0) continue;  // CTA-uniform
    const int tx0 = (t % n_tx) * TILE, ty0 = (t / n_tx) * TILE;
    __syncthreads();
    for (int e = threadIdx.x; e < TILE * TILE; e += NT) {
      const int r = e / TILE, c = e % TILE;
      float4 cv = make_float4(0.f, 0.f, 0.f, 0.f);
      float dd = 0.f;
      if (ty0 + r < H && tx0 + c < W) {
        const size_t p = b * P + (size_t)(ty0 + r) * W + tx0 + c;
        cv = make_float4(dsil[p], dnum[3 * p], dnum[3 * p + 1], dnum[3 * p + 2]);
        dd = dden[p];
      }
      s_cot[e] = cv;
      s_dden[r * (TILE + 1) + c] = dd;
    }
    __syncthreads();
    for (int i = 0; i < FPW; ++i) {
      const int fl = warp * FPW + i;
      const float4* fq = s_face + fl * 4;
      const float4 q0 = fq[0], q1 = fq[1], q2 = fq[2], q3 = fq[3];
      if (q3.y == 0.f) continue;  // invalid or padding: warp-uniform
      bool keep = false;
      if (lane < 16) {  // lane tests patch (lane % 4, lane / 4) of the tile
        const int x0 = tx0 + (lane & 3) * PATCH, y0 = ty0 + (lane >> 2) * PATCH;
        keep = x0 < W && y0 < H &&
               reaches(q0, q1, q2, (float)x0 + HALF, (float)y0 + HALF, thresh);
      }
      unsigned m = __ballot_sync(FULL, keep);
      if (m == 0) continue;
      float g[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) g[c] = 0.f;
      do {
        const int pt = __ffs(m) - 1;
        m &= m - 1;
        const int lx = (pt & 3) * PATCH + (lane & 7), ly = (pt >> 2) * PATCH + (lane >> 3);
        const float fx = (float)(tx0 + lx);
        const float pa0 = __fmul_rn(fx, q0.x), pa1 = __fmul_rn(fx, q0.w), pa2 = __fmul_rn(fx, q1.z);
        bwd_pair(g, fx, (float)(ty0 + ly), pa0, pa1, pa2, s_cot[ly * TILE + lx],
                 s_dden[ly * (TILE + 1) + lx], q0, q1, q2, q3, inv_sigma);
        bwd_pair(g, fx, (float)(ty0 + ly + 4), pa0, pa1, pa2, s_cot[(ly + 4) * TILE + lx],
                 s_dden[(ly + 4) * (TILE + 1) + lx], q0, q1, q2, q3, inv_sigma);
      } while (m);
      const float v = reduce_scatter16(g, lane);
      if ((lane & 1) == 0 && (lane >> 1) < NG) s_acc[fl * 16 + (lane >> 1)] += v;
    }
  }
  __syncthreads();
  float* out = part + ((size_t)(k * B + b) * Fp + f0) * NG;
  for (int i = threadIdx.x; i < GROUP * NG; i += NT) {
    const int f = i / NG, c = i - f * NG;
    const float scale = c < 9 ? inv_sigma : (c > 9 ? s_face[f * 4 + 2].y : 1.f);  // 1 / sigma, ezf
    out[i] = s_acc[f * 16 + c] * scale;
  }
}

__global__ void soft_bwd_reduce_kernel(const float* __restrict__ part, float4* __restrict__ dfaces,
                                       int BF, int K) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // b * Fp + f
  if (i >= BF) return;
  float a[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) a[c] = 0.f;
  for (int k = 0; k < K; ++k) {
    const float* o = part + ((size_t)k * BF + i) * NG;
#pragma unroll
    for (int c = 0; c < NG; ++c) a[c] += o[c];
  }
  float4* out = dfaces + (size_t)i * 4;  // the vmask and padding columns stay 0
  out[0] = make_float4(a[0], a[1], a[2], a[3]);
  out[1] = make_float4(a[4], a[5], a[6], a[7]);
  out[2] = make_float4(a[8], a[9], a[10], a[11]);
  out[3] = make_float4(a[12], 0.f, 0.f, 0.f);
}

constexpr int RED_THREADS = 256;

}  // namespace

extern "C" int soft_fwd(const float* faces, const int* tab, float* part, int B, int H, int W,
                        int n_fb, int K, float inv_sigma, float thresh, void* stream) {
  const int n_cells = ((W + CW - 1) / CW) * ((H + CH - 1) / CH);
  soft_fwd_kernel<<<dim3(n_cells * K, B), NT, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(faces), tab, part, H, W, n_fb, K, inv_sigma, thresh);
  return (int)cudaGetLastError();
}

extern "C" int soft_fwd_reduce(const float* part, float* sil_log, float* num, float* den, int B,
                               int P, int K, void* stream) {
  const int n = B * P;
  soft_fwd_reduce_kernel<<<(n + RED_THREADS - 1) / RED_THREADS, RED_THREADS, 0,
                           (cudaStream_t)stream>>>(part, sil_log, num, den, B, P, K);
  return (int)cudaGetLastError();
}

extern "C" int soft_bwd(const float* faces, const int* tab, const float* dsil, const float* dnum,
                        const float* dden, float* part, int B, int H, int W, int n_fb, int K,
                        float inv_sigma, float thresh, void* stream) {
  const int n_grp = n_fb * (FBLOCK / GROUP);
  soft_bwd_kernel<<<dim3(n_grp * K, B), NT, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(faces), tab, dsil, dnum, dden, part, H, W, n_fb, K,
      inv_sigma, thresh);
  return (int)cudaGetLastError();
}

extern "C" int soft_bwd_reduce(const float* part, float* dfaces, int BF, int K, void* stream) {
  soft_bwd_reduce_kernel<<<(BF + RED_THREADS - 1) / RED_THREADS, RED_THREADS, 0,
                           (cudaStream_t)stream>>>(part, reinterpret_cast<float4*>(dfaces), BF, K);
  return (int)cudaGetLastError();
}
