// Shared device code of the NeuS kernel pairs (fused_neus_ray.cu,
// fused_neus_point.cu, fused_sdf.cu, fused_color.cu): network dimensions,
// the flat weight layout, the per-CTA workspace layout, one CTA-wide GEMM on
// the CUDA cores (f32 sums; bf16-rounded operands in the bf16 operand mode)
// and the fixed-order sum of per-CTA partials.
//
// Every 2-D activation is a row-major (rows x width) f32 matrix with one row
// per sample point of the ray being processed (rows <= MAXS). All weights are
// torch / JAX (out, in) row-major; the forward product z = h @ W^T reads W
// transposed, the reverse products c_h = c_z @ W and the weight gradients
// dW += c_z^T @ h read it as stored.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace neus {

constexpr int NT = 256;      // threads per CTA
constexpr int MAXS = 64;     // samples per ray (GEMM rows) at most
constexpr int MAXNH = 8;     // SDF hidden linears before the skip layer
constexpr int MAXNHC = 8;    // colour relu linears
constexpr int TM = 64, TN = 128, TK = 16;
constexpr float RSQRT2 = 0.70710678118654752f;

struct Dims {
  int S;      // samples per ray
  int L;      // positional-encoding frequencies (multires)
  int E;      // embedding width 3 * (1 + 2L)
  int H;      // SDF hidden width
  int NH;     // SDF hidden linears before the skip-producing layer
  int SW;     // skip-producing layer width H - E
  int F;      // geometry feature width (SDF d_out - 1)
  int HC;     // colour hidden width
  int NHC;    // colour relu linears
  int CW;     // colour input width 6 + F ([pts, normal, feature])
  int W;      // rgb width: 3, or 6 with the extra head
  int squeeze;  // sigmoid on the colour head
  float scale;  // SDF input scale
  int bf16;     // operand mode: 1 = dot operands rounded to bf16 (f32 sums)
};

// x rounded to bf16 (round to nearest even) and back: a dot operand in the
// bf16 mode, as the JAX kernels' _dot casts it
__device__ inline float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Flat weight buffer: SDF layers l = 0..NH+1 then colour layers l = 0..NHC,
// each as W (out, in) followed by b (out). The colour head (layer NHC) stacks
// the main and extra heads: (W, HC). Dims without an SDF net (H = 0: the
// colour net alone, B7's tensor-core backward) have the colour layers alone.
struct WeightOffsets {
  size_t sw[MAXNH + 2], sb[MAXNH + 2];
  size_t cw[MAXNHC + 1], cb[MAXNHC + 1];
  size_t total;
};

__host__ __device__ inline int sdf_in(const Dims& d, int l) { return l == 0 ? d.E : d.H; }
__host__ __device__ inline int sdf_out(const Dims& d, int l) {
  return l < d.NH ? d.H : (l == d.NH ? d.SW : 1 + d.F);
}
__host__ __device__ inline int col_in(const Dims& d, int l) { return l == 0 ? d.CW : d.HC; }
__host__ __device__ inline int col_out(const Dims& d, int l) { return l < d.NHC ? d.HC : d.W; }

__host__ __device__ inline WeightOffsets weight_offsets(const Dims& d) {
  WeightOffsets o;
  size_t off = 0;
  for (int l = 0; d.H > 0 && l <= d.NH + 1; ++l) {
    o.sw[l] = off;
    off += (size_t)sdf_out(d, l) * sdf_in(d, l);
    o.sb[l] = off;
    off += sdf_out(d, l);
  }
  for (int l = 0; l <= d.NHC; ++l) {
    o.cw[l] = off;
    off += (size_t)col_out(d, l) * col_in(d, l);
    o.cb[l] = off;
    off += col_out(d, l);
  }
  o.total = off;
  return o;
}

// Per-CTA workspace, in floats. Forward buffers first; the backward kernel
// uses all of them. Every matrix has MAXS rows.
struct Workspace {
  size_t pts, e, de, dde, h[MAXNH + 1], p[MAXNH], u, ps, out, ta, tb, g;
  size_t cin, acts[MAXNHC], head;
  // backward only
  size_t t[MAXNH + 1], zd[MAXNH], zds, udot, cout, cu, czs, czds, ch, chd,
      cz, czd, chead, ca, czc, ccin, cg, cdir, dx, cs;
  size_t total;
};

__host__ __device__ inline size_t take_rows(size_t& off, size_t cols) {
  const size_t p = off;
  off += (size_t)MAXS * cols;
  return p;
}

__host__ __device__ inline Workspace workspace_layout(const Dims& d, bool backward) {
  Workspace w;
  size_t off = 0;
#define take(cols) take_rows(off, (cols))
  w.pts = take(3);
  w.e = take(d.E);
  w.de = take(d.E);
  w.dde = take(d.E);
  w.h[0] = w.e;
  for (int i = 1; i <= d.NH; ++i) w.h[i] = take(d.H);
  for (int i = 0; i < d.NH; ++i) w.p[i] = take(d.H);
  w.u = take(d.H);
  w.ps = take(d.SW);
  w.out = take(1 + d.F);
  w.ta = take(d.H);
  w.tb = take(d.H);
  w.g = take(3);
  w.cin = take(d.CW);
  for (int i = 0; i < d.NHC; ++i) w.acts[i] = take(d.HC);
  w.head = take(d.W);
  if (backward) {
    w.t[0] = take(d.E);
    for (int i = 1; i <= d.NH; ++i) w.t[i] = take(d.H);
    for (int i = 0; i < d.NH; ++i) w.zd[i] = take(d.H);
    w.zds = take(d.SW);
    w.udot = take(d.H);
    w.cout = take(1 + d.F);
    w.cu = take(d.H);
    w.czs = take(d.SW);
    w.czds = take(d.SW);
    w.ch = take(d.H);
    w.chd = take(d.H);
    w.cz = take(d.H);
    w.czd = take(d.H);
    w.chead = take(d.W);
    w.ca = take(d.HC);
    w.czc = take(d.HC);
    w.ccin = take(d.CW);
    w.cg = take(3);
    w.cdir = take(3);
    w.dx = take(3);
    w.cs = take(1);
  }
#undef take
  w.total = off;
  return w;
}

struct GemmSmem {
  float a[TK][TM + 4];
  float b[TK][TN + 4];
  int rnd;  // the operand mode (Dims::bf16), set by every kernel at its start
};

// every thread of a kernel calls this before its first __syncthreads
__device__ inline void set_mode(GemmSmem& sm, const Dims& d) { sm.rnd = d.bf16; }

// C[i][j] = (accumulate ? C[i][j] : 0) + sum_k A(i,k) B(k,j) (+ bias[j])
//   A(i,k) = tA ? A[k*lda + i] : A[i*lda + k]
//   B(k,j) = tB ? B[j*ldb + k] : B[k*ldb + j]
// All NT threads of the CTA take part; outputs are visible CTA-wide on
// return. Output tiles of TM x TN, each thread an 8 x 4 register tile
// (rows ty*8.., columns tx + 32*j), K staged through shared memory in TK
// slices. Plain f32 FMAs: no tensor cores, no TF32. With sm.rnd each staged A
// and B value is rounded to bf16 first (the bf16 operand mode).
__device__ inline void gemm(GemmSmem& sm, int M, int N, int K,
                            const float* __restrict__ A, int lda, bool tA,
                            const float* __restrict__ B, int ldb, bool tB,
                            float* C, int ldc, bool accumulate,
                            const float* __restrict__ bias) {
  const int tid = threadIdx.x;
  const int tx = tid & 31, ty = tid >> 5;
  const bool rnd = sm.rnd != 0;
  for (int m0 = 0; m0 < M; m0 += TM) {
    for (int n0 = 0; n0 < N; n0 += TN) {
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < K; k0 += TK) {
        for (int e = tid; e < TK * TM; e += NT) {
          int kk, ii;
          if (tA) { ii = e % TM; kk = e / TM; } else { kk = e % TK; ii = e / TK; }
          const int gi = m0 + ii, gk = k0 + kk;
          float v = 0.f;
          if (gi < M && gk < K) v = tA ? A[(size_t)gk * lda + gi] : A[(size_t)gi * lda + gk];
          sm.a[kk][ii] = rnd ? round_bf16(v) : v;
        }
        for (int e = tid; e < TK * TN; e += NT) {
          int kk, jj;
          if (tB) { kk = e % TK; jj = e / TK; } else { jj = e % TN; kk = e / TN; }
          const int gj = n0 + jj, gk = k0 + kk;
          float v = 0.f;
          if (gj < N && gk < K) v = tB ? B[(size_t)gj * ldb + gk] : B[(size_t)gk * ldb + gj];
          sm.b[kk][jj] = rnd ? round_bf16(v) : v;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < TK; ++kk) {
          float a[8], b[4];
#pragma unroll
          for (int i = 0; i < 8; ++i) a[i] = sm.a[kk][ty * 8 + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = sm.b[kk][tx + 32 * j];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int gi = m0 + ty * 8 + i;
        if (gi >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gj = n0 + tx + 32 * j;
          if (gj >= N) continue;
          float v = acc[i][j];
          if (bias) v += bias[gj];
          float* c = C + (size_t)gi * ldc + gj;
          *c = accumulate ? *c + v : v;
        }
      }
    }
  }
  __syncthreads();
}

// db[j] += sum_{i < M} X[i*ld + j] for j < N (bias gradients, fixed order).
__device__ inline void colsum_acc(int M, int N, const float* X, int ld, float* db) {
  for (int j = threadIdx.x; j < N; j += NT) {
    float s = 0.f;
    for (int i = 0; i < M; ++i) s += X[(size_t)i * ld + j];
    db[j] += s;
  }
  __syncthreads();
}

// softplus(100 z) / 100 and sigmoid(100 z) from one shared exp
__device__ inline void sp_sig(float z, float& sp, float& sig) {
  const float a = 100.f * z;
  const float t = expf(-fabsf(a));
  const float inv = 1.f / (1.f + t);
  sp = (fmaxf(a, 0.f) + log1pf(t)) * 0.01f;
  sig = a >= 0.f ? inv : t * inv;
}

__device__ inline float sigmoidf(float x) {
  const float t = expf(-fabsf(x));
  const float inv = 1.f / (1.f + t);
  return x >= 0.f ? inv : t * inv;
}

// embedding column j -> (component c, frequency f, kind) with kind 0 = x,
// 1 = sin(f x), 2 = cos(f x)
__device__ inline void pe_column(int j, int& c, float& f, int& kind) {
  if (j < 3) { c = j; f = 1.f; kind = 0; return; }
  const int k = (j - 3) / 6, r = (j - 3) % 6;
  c = r % 3;
  f = (float)(1 << k);
  kind = r < 3 ? 1 : 2;
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

}  // namespace neus
