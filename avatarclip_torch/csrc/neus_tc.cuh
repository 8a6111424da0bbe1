// Tensor-core building blocks of the bf16 NeuS kernels (fused_neus_ray_tc.cu:
// B1's per-ray pair, B3's point-level pair, B6's pair, B7's pair, #12's
// sdf-only forward): the packed
// bf16 weight layout, the CTA-level GEMM forms on mma.sync.m16n8k16 (bf16
// operands, f32 accumulators: gemm_rows_pre and gemm_fused over a tile,
// wgrad_kernel's tiles over the points), the backward's weight-gradient log,
// and the shared-memory / scratch layouts of the kernels.
//
// A tile is 64 GEMM rows: one ray's samples (B1, B3) or 64 points (B6, B7).
// Rows past the ray's S samples or the last points are zero-padded points
// whose results are never read and whose cotangents are zero. An
// activation that feeds a product is a bf16 row-major (64 x ld) matrix with
// ld = pad16(K) + 8: the 8 extra columns make the row stride 4 words mod 8,
// so the 32 lanes' 32-bit fragment loads hit 32 different banks.
//
// Packed weights: a product's (K x N) right operand B is stored as mma
// B-fragments, zero-padded to pad16(K) x pad8(N): fragment (nt, kt) of lane
// l = 4 g + t is the uint2 at ((kt * NT + nt) * 32 + l) holding
// B[16 kt + 2t (+1)][8 nt + g] and B[16 kt + 2t + 8 (+1)][8 nt + g]: one
// k-step of all columns is one contiguous run, copied into shared memory by
// cp.async a few k-steps ahead of its use (gemm_rows). ops/fused_neus.py builds the
// pack per call from the flat f32 weights (pack_tc; B6's holds the SDF
// layers alone; pack_colour_tc, B7's, the colour layers alone); the flat f32
// buffer stays the interface and carries the biases and the head's f32 sdf
// row.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "neus_ray.cuh"

namespace neus {
namespace tc {

typedef __nv_bfloat16 bf16;
typedef __half f16;

// Per-phase cycle counts, compiled in only with -DNEUS_TC_PROF (the
// profiling build of avatarclip_torch/tools/profile_b1.py): thread 0 of each
// CTA adds the clock64 cycles since its previous mark to a phase, and the
// kernel's end stores the CTA's sums in g_phase[kernel][cta] (kernel: PK_*).
// A product's epilogue time also goes to slot PH_TAGS + the tag phase_tag
// last set. PH_COMPOSITE is B1's compositing and the per-point I/O: B3's and
// B6's forward's stores, B7's backward's input tile and head cotangent.
enum { PH_OTHER = 0, PH_GEMM, PH_WGRAD, PH_COLPASS = 4, PH_COMPOSITE, PH_EPI, PH_LOG,
       PH_TAGS = 8, PH_N = 24, PH_MAXCTA = 1024 };
enum { PK_RAY_FWD = 0, PK_RAY_BWD, PK_WGRAD, PK_POINT_FWD, PK_SDF_BWD, PK_SDF_FWD, PK_COL_BWD,
       PK_COL_FWD, PK_SDF_ONLY, PK_POINT_BWD, PK_N };
#if defined(NEUS_TC_PROF) && defined(__CUDACC__)
__device__ long long g_phase[PK_N][PH_MAXCTA][PH_N];
__device__ inline long long* phase_slots() {
  __shared__ long long s[PH_N + 2];  // the sums, the last stamp, the tag
  return s;
}
__device__ inline void phase_tag(int tag) {
  if (threadIdx.x == 0) phase_slots()[PH_N + 1] = tag;
}
__device__ inline void phase_start() {
  if (threadIdx.x == 0) {
    long long* s = phase_slots();
    for (int i = 0; i < PH_N; ++i) s[i] = 0;
    s[PH_N] = clock64();
    s[PH_N + 1] = 0;
  }
}
__device__ inline void phase_mark(int ph) {
  if (threadIdx.x == 0) {
    long long* s = phase_slots();
    const long long t = clock64();
    s[ph] += t - s[PH_N];
    if (ph == PH_EPI) s[PH_TAGS + s[PH_N + 1]] += t - s[PH_N];
    s[PH_N] = t;
  }
}
__device__ inline void phase_end(int kernel) {
  phase_mark(PH_OTHER);
  const unsigned b = blockIdx.x + blockIdx.y * gridDim.x;
  if (threadIdx.x == 0 && b < PH_MAXCTA)
    for (int i = 0; i < PH_N; ++i) g_phase[kernel][b][i] = phase_slots()[i];
}
#else
__host__ __device__ inline void phase_start() {}
__host__ __device__ inline void phase_tag(int) {}
__host__ __device__ inline void phase_mark(int) {}
__host__ __device__ inline void phase_end(int) {}
#endif

constexpr int ROWS = 64;         // GEMM rows of a tile: one ray of S <= 64 samples, or 64 points
constexpr int TNT = 512;         // threads a CTA: 16 warps to hide the latencies
constexpr int NWARP = TNT / 32;
// gemm_rows' warp grid: 2 x 8 warps, each 32 rows (2 m-tiles) x 4 n-tiles;
// of the 2 x 8, 4 x 4 and 1 x 16 grids it reads the fewest operand bytes
// from shared memory a k-step (A 2 KB x 8, B 8 KB x 2)
constexpr int NWM = 2, NWN = NWARP / NWM;
constexpr int MTW = 4 / NWM;     // m-tiles a warp holds
constexpr int NPW = 4;           // n-tiles a warp holds per pass
constexpr int NTP = NWN * NPW;   // n-tiles a pass
constexpr int KS = 2;            // k-steps a ring stage holds (one __syncthreads each)
constexpr int NSTAGE_FWD = 3;    // ring stages (the cp.async ring): the forward has the room
constexpr int NSTAGE_BWD = 3;    // the backward recomputes its encoding derivatives to make room
constexpr int STAGE = KS * NTP * 32;  // uint2 fragments of a stage of one pass (16 KB)

__host__ __device__ inline int pad16(int k) { return (k + 15) / 16 * 16; }
__host__ __device__ inline int ld_of(int k) { return pad16(k) + 8; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Packed matrices by index (Pack::off, in uint2 fragments). Forward forms
// B = W^T (K = in, N = out), reverse forms B = W (K = out, N = in):
//   FS + i: SDF layer i (i < NH hidden, i = NH the skip-producing layer)
//   FHEAD:  the head's feature rows / sqrt(2) (the skip concat's scale)
//   RS + i, RHEAD: their reverse forms
//   FC + l: colour layer l (l = NHC the head, main and extra rows), RC + l
enum { FS = 0, FHEAD = MAXNH + 1, RS = MAXNH + 2, RHEAD = 2 * MAXNH + 3,
       FC = 2 * MAXNH + 4, RC = 3 * MAXNH + 5, NMAT = 4 * MAXNH + 6 };

struct Pack {
  long long off[NMAT];
};

#ifdef __CUDACC__
// not volatile: a pure function of its registers, free to be scheduled
__device__ inline void mma(float* c, const uint32_t* a, uint2 b) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// 16 bytes global -> shared, asynchronous; completion by cp_async_wait
__device__ inline void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ inline void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// four 8 x 8 bf16 blocks from shared memory: lane l gives the address of
// row l % 8 of block l / 8 (16 bytes, 16-byte aligned) and receives, from
// block j, register j = {M_j[l / 4][2 (l % 4)], M_j[l / 4][2 (l % 4) + 1]}
__device__ inline void ldsm_x4(uint32_t* r, const void* row) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// four 8 x 8 bf16 blocks, transposed: lane l gives the address of row l % 8
// of block l / 8 (16 bytes, 16-byte aligned) and receives, from block j,
// register j = {M_j[2 (l % 4)][l / 4], M_j[2 (l % 4) + 1][l / 4]}: a
// fragment whose pairs run down the stored matrix's columns
__device__ inline void ldsm_x4_t(uint32_t* r, const void* row) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// A bulk copy (the Tensor Memory Accelerator's 1-D form) of `bytes` (a
// multiple of 16, both addresses 16-byte aligned) from global to shared
// memory, completing on the mbarrier bar: one thread sets the barrier's
// expected bytes and issues the copy; every thread that waits on the
// barrier's phase then sees the data. Independent of cp.async's groups, so
// it stays in flight across gemm_rows' waits.
__device__ inline void mbar_init(uint64_t* bar, int count) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(a), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ inline void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(a), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(d), "l"(src), "r"(bytes), "r"(a)
               : "memory");
}
// wait until the barrier's phase of parity `parity` has completed; a copy
// that never lands (2^32 cycles, seconds) traps instead of hanging the card
__device__ inline void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  const long long t0 = clock64();
  unsigned done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}
#else
// host compilers (a CPU rehearsal of the kernels) supply their own
void mbar_init(uint64_t* bar, int count);
void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar);
void mbar_wait(uint64_t* bar, unsigned parity);
void mma(float* c, const uint32_t* a, uint2 b);
void cp_async16(void* dst, const void* src);
void cp_async_commit();
template <int N>
void cp_async_wait();
void ldsm_x4(uint32_t* r, const void* row);
void ldsm_x4_t(uint32_t* r, const void* row);
#endif


// softplus(100 z) / 100 alone, the same operations as sp_sig_fast's (the
// same bits): the sdf-only forward keeps no sigmoid factor
__device__ inline float sp_fast(float z) {
  const float a = 100.f * z;
  return (fmaxf(a, 0.f) + __logf(1.f + __expf(-fabsf(a)))) * 0.01f;
}

// softplus(100 z) / 100 and sigmoid(100 z) with the fast intrinsics (the
// values feed bf16 operands: their few-ulp error is far below bf16's); sk
// is the sigmoid as sig_load reads it
__device__ inline void sp_sig_fast(float z, float& sp, float& sig, f16& sk) {
  const float a = 100.f * z;
  const float t = __expf(-fabsf(a));
  const float inv = __fdividef(1.f, 1.f + t);
  sp = (fmaxf(a, 0.f) + __logf(1.f + t)) * 0.01f;
  sig = a >= 0.f ? inv : t * inv;
  // the smaller of sig and 1 - sig is t / (1 + t): kept to f16's 2^-11
  // relative, with the sign bit saying which of the two it is
  sk = __float2half_rn(a >= 0.f ? -(t * inv) : t * inv);
}

// a sigmoid factor kept in 16 bits (sp_sig_fast): p and 1 - p, each to
// 2^-11 of itself, so that p (1 - p) keeps its precision at p near 1
__device__ inline bool f16_sign(f16 h);
__device__ inline void sig_load(f16 h, float& p, float& q) {
  const float v = __half2float(h), m = fabsf(v);
  const bool upper = f16_sign(h);
  p = upper ? 1.f - m : m;
  q = upper ? m : 1.f - m;
}

__device__ inline bf16 to_bf(float x) { return __float2bfloat16_rn(x); }
__device__ inline bool f16_sign(f16 h) { return (__half_as_ushort(h) & 0x8000u) != 0; }

// gemm_rows_pre: out(64 x N) = A(64 x K) . B: A bf16 row-major with stride ld (columns K ..
// pad16(K) finite: the packed rows there are zero), B packed. Calls
// epi(r, c, v) for every row and every column c < pad8(N) (v = 0 past N).
// Warp (wm, wn) takes rows 32 wm .. and n-tiles wn * NPW + j (+ NTP a
// pass), so a given (r, c) goes to the same thread in every call with the
// same N. The CTA copies the pass's fragments into the shared ring (NSTAGE
// stages of KS k-steps) ahead of their use with cp.async, one
// __syncthreads a stage.
// Every thread of the CTA calls it; ends with __syncthreads.
struct NoPre {
  __device__ float operator()(int, int) const { return 0.f; }
};

// gemm_rows with an epilogue input: pre(r, c) is read for every element of
// the pass before any epilogue runs, and epi(r, c, v, pre(r, c)) then
// stores. All the pass's loads go out together: read one by one between
// the epilogue's stores, each would wait out the memory latency (the
// compiler cannot tell a store from the next element's load apart).
// stage st (k-steps KS st ..) of pass nb0 of the product (B, K, N) into its
// ring slot, as one cp.async group
template <int NSTAGE>
__device__ __forceinline__ void issue_stage(uint2* ring, const uint2* __restrict__ B, int K, int N,
                                            int nb0, int st) {
  const int KT = (K + 15) / 16, NTl = (N + 7) / 8, NSt = (KT + KS - 1) / KS;
  const int cnt = NTl - nb0 < NTP ? NTl - nb0 : NTP;
  if (st < NSt) {
    uint2* dst = ring + (st % NSTAGE) * STAGE;
    for (int q = 0; q < KS && KS * st + q < KT; ++q) {
      const uint2* src = B + ((size_t)(KS * st + q) * NTl + nb0) * 32;
      for (int e = threadIdx.x; e < cnt * 16; e += TNT) cp_async16(dst + q * NTP * 32 + 2 * e, src + 2 * e);
    }
  }
  cp_async_commit();
}

template <int NSTAGE, class Pre, class Epi>
__device__ __forceinline__ void gemm_rows_pre(const bf16* A, int ld, int K, const uint2* __restrict__ B,
                                              int N, uint2* ring, Pre pre, Epi epi) {
  phase_mark(PH_OTHER);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int wm = warp / NWN, wn = warp % NWN, row0 = wm * MTW * 16;
  const int KT = (K + 15) / 16, NTl = (N + 7) / 8, NSt = (KT + KS - 1) / KS;
  for (int nb0 = 0; nb0 < NTl; nb0 += NTP) {
    const int nb = nb0 + wn * NPW;
    for (int s = 0; s < NSTAGE - 1; ++s) issue_stage<NSTAGE>(ring, B, K, N, nb0, s);
    float acc[MTW][NPW][4];
#pragma unroll
    for (int i = 0; i < MTW; ++i)
#pragma unroll
      for (int j = 0; j < NPW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    for (int st = 0; st < NSt; ++st) {
      cp_async_wait<NSTAGE - 2>();
      __syncthreads();  // stage st landed for all; stage st - 1 is free
      issue_stage<NSTAGE>(ring, B, K, N, nb0, st + NSTAGE - 1);
      if (nb >= NTl) continue;  // no n-tile of this pass: only the copies and barriers
#pragma unroll
      for (int q = 0; q < KS; ++q) {
        const int kt = KS * st + q;
        if (kt >= KT) break;
        const uint2* sp = ring + (st % NSTAGE) * STAGE + q * NTP * 32 + wn * NPW * 32 + lane;
        // every fragment of the step first, then the products (a missing
        // n-tile multiplies zeros: no branch around an mma)
        uint2 b[NPW];
#pragma unroll
        for (int j = 0; j < NPW; ++j) b[j] = nb + j < NTl ? sp[j * 32] : make_uint2(0u, 0u);
        uint32_t a[MTW][4];
#pragma unroll
        for (int mt = 0; mt < MTW; ++mt)
          // blocks (rows +0, k +0), (rows +8, k +0), (rows +0, k +8), (rows +8, k +8)
          ldsm_x4(a[mt], A + (size_t)(row0 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                             kt * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
          for (int j = 0; j < NPW; ++j) mma(acc[mt][j], a[mt], b[j]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the next pass or product
    phase_mark(PH_GEMM);
    using PV = decltype(pre(0, 0));
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt) {  // a 16-row slab's inputs at once, then its stores
      PV pv[NPW][4];
#pragma unroll
      for (int j = 0; j < NPW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pv[j][e] = nb + j < NTl ? pre(row0 + mt * 16 + g + (e >> 1) * 8, (nb + j) * 8 + 2 * t + (e & 1))
                                  : PV{};
#pragma unroll
      for (int j = 0; j < NPW; ++j) {
        if (nb + j >= NTl) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          epi(row0 + mt * 16 + g + (e >> 1) * 8, (nb + j) * 8 + 2 * t + (e & 1), acc[mt][j][e],
              pv[j][e]);
      }
    }
  }
  __syncthreads();
  phase_mark(PH_EPI);
}

// out(64 x N) = A . B with a store-only epilogue epi(r, c, v)
template <int NSTAGE, class Epi>
__device__ __forceinline__ void gemm_rows(const bf16* A, int ld, int K, const uint2* __restrict__ B,
                                          int N, uint2* ring, Epi epi) {
  gemm_rows_pre<NSTAGE>(A, ld, K, B, N, ring, NoPre(),
                        [&](int r, int c, float v, float) { epi(r, c, v); });
}

// A product (two when DUAL: out0 = A0 . B and out1 = A1 . B over one
// weight stream; A0, A1 bf16 64 x K, stride ld) whose epilogue may write
// over its operands and sums its columns. The k-loop of each pass ends with
// a barrier, so epi may overwrite A0 / A1 when N <= NTP * 8 (one pass).
// epi(r, c, v0, v1, pre(r, c)) stores (v1 = 0 unless DUAL) and returns the
// element's share of column c's sum; colsum[c - cs0] += the sum over the 64
// rows for cs0 <= c < cs1, in a fixed order (lanes by a butterfly, then the
// two row halves through red, 2 x NTP * 8 floats); no sums when colsum is
// null. Ends with __syncthreads.
template <int NSTAGE, bool DUAL, class Pre, class Epi>
__device__ __forceinline__ void gemm_fused(const bf16* A0, const bf16* A1, int ld, int K,
                                           const uint2* __restrict__ B, int N, uint2* ring,
                                           float* red, float* colsum, int cs0, int cs1, Pre pre,
                                           Epi epi) {
  phase_mark(PH_OTHER);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int wm = warp / NWN, wn = warp % NWN, row0 = wm * MTW * 16;
  const int KT = (K + 15) / 16, NTl = (N + 7) / 8, NSt = (KT + KS - 1) / KS;
  for (int nb0 = 0; nb0 < NTl; nb0 += NTP) {
    const int nb = nb0 + wn * NPW;
    for (int s = 0; s < NSTAGE - 1; ++s) issue_stage<NSTAGE>(ring, B, K, N, nb0, s);
    float acc0[MTW][NPW][4], acc1[MTW][NPW][4];
#pragma unroll
    for (int i = 0; i < MTW; ++i)
#pragma unroll
      for (int j = 0; j < NPW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc0[i][j][e] = acc1[i][j][e] = 0.f;
    for (int st = 0; st < NSt; ++st) {
      cp_async_wait<NSTAGE - 2>();
      __syncthreads();
      issue_stage<NSTAGE>(ring, B, K, N, nb0, st + NSTAGE - 1);
      if (nb >= NTl) continue;
#pragma unroll
      for (int q = 0; q < KS; ++q) {
        const int kt = KS * st + q;
        if (kt >= KT) break;
        const uint2* sp = ring + (st % NSTAGE) * STAGE + q * NTP * 32 + wn * NPW * 32 + lane;
        uint2 b[NPW];
#pragma unroll
        for (int j = 0; j < NPW; ++j) b[j] = nb + j < NTl ? sp[j * 32] : make_uint2(0u, 0u);
#pragma unroll
        for (int mt = 0; mt < MTW; ++mt) {
          const size_t off = (size_t)(row0 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                             kt * 16 + (lane >> 4) * 8;
          uint32_t a0[4];
          ldsm_x4(a0, A0 + off);
#pragma unroll
          for (int j = 0; j < NPW; ++j) mma(acc0[mt][j], a0, b[j]);
          if (DUAL) {
            uint32_t a1[4];
            ldsm_x4(a1, A1 + off);
#pragma unroll
            for (int j = 0; j < NPW; ++j) mma(acc1[mt][j], a1, b[j]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // A0 / A1 and the ring are free
    phase_mark(PH_GEMM);
    float cs[NPW][2];
#pragma unroll
    for (int j = 0; j < NPW; ++j) cs[j][0] = cs[j][1] = 0.f;
    using PV = decltype(pre(0, 0));
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
      for (int j = 0; j < NPW; ++j) {
        if (nb + j >= NTl) continue;
        // an n-tile's inputs at once, then its stores (few registers: the
        // accumulators of both products are live here)
        PV pv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pv[e] = pre(row0 + mt * 16 + g + (e >> 1) * 8, (nb + j) * 8 + 2 * t + (e & 1));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cs[j][e & 1] += epi(row0 + mt * 16 + g + (e >> 1) * 8, (nb + j) * 8 + 2 * t + (e & 1),
                              acc0[mt][j][e], DUAL ? acc1[mt][j][e] : 0.f, pv[e]);
      }
    if (colsum) {
#pragma unroll
      for (int j = 0; j < NPW; ++j)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          float v = cs[j][k];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0 && nb + j < NTl) red[wm * NTP * 8 + (wn * NPW + j) * 8 + 2 * t + k] = v;
        }
      __syncthreads();
      for (int c = nb0 * 8 + tid; c < N && c < (nb0 + NTP) * 8; c += TNT)
        if (c >= cs0 && c < cs1) colsum[c - cs0] += red[c - nb0 * 8] + red[NTP * 8 + c - nb0 * 8];
    }
    __syncthreads();
    phase_mark(PH_EPI);
  }
}

// ---- the backward's weight gradients
//
// A backward runs its tiles in chunks. Its per-tile kernel writes, once,
// the bf16 operands of every weight gradient (the cotangents on a layer's
// outputs and the layer's inputs) into a log; a second kernel
// (wgrad_kernel) then forms each weight's gradient as a tensor-core product
// over the chunk's points, D += scale * X^T Y, split over the points into
// n_split partial sums. A log region holds one matrix, row = point (tile
// slot q of the chunk, row r: 64 q + r), stride ld = pad8(width) elements;
// padded rows carry zero cotangents. Without a colour net (Dims::NHC = 0,
// B6) the colour regions are empty and the colour problems absent; without
// an SDF net (Dims::H = 0, B7) the SDF regions and problems.
enum { LG_EB = 0, LG_TB0, LG_X, LG_TI = LG_X + MAXNH, LG_U = LG_TI + MAXNH, LG_CIN, LG_ACT,
       LG_CZ = LG_ACT + MAXNHC, LG_CZD = LG_CZ + MAXNH + 1, LG_CF = LG_CZD + MAXNH + 1, LG_CZC,
       LG_CHEAD = LG_CZC + MAXNHC, LG_N };

struct WLog {
  long long off[LG_N];  // elements a row before region m (region m starts at off[m] * rows)
  int ld[LG_N];         // region m's row stride (0: unused)
  long long row;        // elements a row over all regions
};

__host__ __device__ inline int pad8(int k) { return (k + 7) / 8 * 8; }

__host__ __device__ inline WLog wlog_layout(const Dims& d) {
  WLog lg;
  int w[LG_N];
  for (int m = 0; m < LG_N; ++m) w[m] = 0;
  if (d.H > 0) {
    w[LG_EB] = w[LG_TB0] = d.E;
    for (int i = 0; i < d.NH; ++i) w[LG_X + i] = w[LG_TI + i] = d.H;
    w[LG_U] = d.H;
    for (int i = 0; i <= d.NH; ++i) w[LG_CZ + i] = w[LG_CZD + i] = i < d.NH ? d.H : d.SW;
    w[LG_CF] = d.F;
  }
  if (d.NHC > 0) {
    w[LG_CIN] = d.CW;
    for (int l = 0; l < d.NHC; ++l) w[LG_ACT + l] = w[LG_CZC + l] = d.HC;
    w[LG_CHEAD] = d.W;
  }
  long long off = 0;
  for (int m = 0; m < LG_N; ++m) {
    lg.off[m] = off;
    lg.ld[m] = pad8(w[m]);
    off += lg.ld[m];
  }
  lg.row = off;
  return lg;
}

// one weight-gradient product: D(M x N) += scale * sum over rows X^T Y,
// X = log region x (M wide), Y = region y (N wide); D at doff in the flat
// weight layout with row stride ldd; part 0 / 1 picks the partial-sum set
// (an SDF weight takes two products: the cotangent with the input, and the
// tangent cotangent with the input tangent)
struct WProb {
  int x, y, M, N, ldd, part;
  long long doff;
  float scale;
};
constexpr int MAXPROB = 2 * (MAXNH + 1) + MAXNHC + 2;
struct WProbs {
  WProb p[MAXPROB];
  int n;
};

__host__ __device__ inline WProbs wgrad_problems(const Dims& d) {
  const WeightOffsets wo = weight_offsets(d);
  WProbs ps;
  int n = 0;
  for (int i = 0; d.H > 0 && i <= d.NH; ++i) {
    const int in = sdf_in(d, i), out = sdf_out(d, i);
    const int x0 = i == 0 ? LG_EB : LG_X + i - 1, t0 = i == 0 ? LG_TB0 : LG_TI + i - 1;
    ps.p[n++] = WProb{LG_CZ + i, x0, out, in, in, 0, (long long)wo.sw[i], 1.f};
    ps.p[n++] = WProb{LG_CZD + i, t0, out, in, in, 1, (long long)wo.sw[i], 1.f};
  }
  if (d.H > 0)
    ps.p[n++] = WProb{LG_CF, LG_U, d.F, d.H, d.H, 0, (long long)wo.sw[d.NH + 1] + d.H, RSQRT2};
  for (int l = 0; d.NHC > 0 && l <= d.NHC; ++l) {
    const int in = col_in(d, l);
    const int x = l < d.NHC ? LG_CZC + l : LG_CHEAD, y = l == 0 ? LG_CIN : LG_ACT + l - 1;
    ps.p[n++] = WProb{x, y, col_out(d, l), in, in, 0, (long long)wo.cw[l], 1.f};
  }
  ps.n = n;
  return ps;
}

// wgrad_kernel's tiles: WG_TM x WG_TN of D a CTA, 8 warps of 64 x 32, the
// points in stages of 32 rows through a 4-deep cp.async ring (two CTAs an
// SM; a 256-row tile with 16 warps, one CTA an SM, took 6.9 ms against 4.9)
constexpr int WG_TM = 128, WG_TN = 128, WG_BK = 32, WG_NSTG = 4;
constexpr int WG_WN = WG_TN / 32, WG_THREADS = 32 * (WG_TM / 64) * WG_WN;
constexpr int WG_LDX = WG_TM + 8, WG_LDY = WG_TN + 8;  // padded smem strides
constexpr int WG_STAGE = WG_BK * (WG_LDX + WG_LDY);   // bf16 elements of a stage (X and Y)
constexpr int WG_SMEM = WG_NSTG * WG_STAGE * 2;

__host__ __device__ inline int wgrad_tiles(const WProb& p) {
  return ((p.M + WG_TM - 1) / WG_TM) * ((p.N + WG_TN - 1) / WG_TN);
}

// bf16 region m of a log chunk of `rows` rows, from row r0
__device__ inline bf16* log_at(bf16* log, const WLog& lg, long long rows, int m, long long r0) {
  return log + lg.off[m] * rows + r0 * lg.ld[m];
}

// the 64 rows x ncols of a bf16 shared-memory operand (stride lds) to a log
// region (stride ldd), 16 bytes a thread at a time, by the whole CTA. No
// barrier: the next writer of src in the kernels is always a product's
// epilogue, which runs after the product's own barriers.
__device__ inline void log_put(bf16* dst, int ldd, const bf16* src, int lds, int ncols) {
  phase_mark(PH_OTHER);
  const int n8 = (ncols + 7) / 8;
  for (int e = threadIdx.x; e < ROWS * n8; e += TNT) {
    const int r = e / n8, c = (e % n8) * 8;
    *(uint4*)(dst + (size_t)r * ldd + c) = *(const uint4*)(src + (size_t)r * lds + c);
  }
  phase_mark(PH_LOG);
}

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// inclusive prefix product over the 32 lanes
__device__ inline float warp_prod_scan(float v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v *= u;
  }
  return v;
}

// Byte offsets of a kernel's dynamic shared memory and of its per-CTA global
// scratch. Forward: activations and the colour input in shared memory, the
// hidden layers' sigmoid factors (the gradient sweep's residuals) and the
// skip layer's f32 activations in scratch. Backward: the operands of the
// current layer in shared memory; the states the later sweeps read (sigmoid
// factors, a_s, tangent pre-activations: 16 bits each) and the embedding
// cotangents in scratch.
struct Layout {
  int E, H, SW, F, HC, CW, W, NH, NHC;
  int ldE, ldX, ldC, ldF;
  // shared memory
  size_t pts, g, ef, de, dde, qe, eb, tb0, ha, hb, u, cin, head, srow, sres, cg, cdir, dx, cs,
      chead, cheadb, ray, alpha, w, tr, calpha, ccin6, cue, red, ring, fstage, bar, smem;
  // scratch
  size_t P, AS, ZD, PS, ZDS, CH, CHD, scratch;
};

__host__ __device__ inline size_t take(size_t& off, size_t bytes) {
  const size_t p = off;
  off += (bytes + 15) / 16 * 16;
  return p;
}

__host__ __device__ inline Layout tc_layout(const Dims& d, bool backward) {
  Layout L;
  L.E = d.E; L.H = d.H; L.SW = d.SW; L.F = d.F; L.HC = d.HC; L.CW = d.CW; L.W = d.W;
  L.NH = d.NH; L.NHC = d.NHC;
  L.ldE = ld_of(d.E);
  L.ldX = ld_of(imax(d.H, d.HC));
  L.ldC = ld_of(d.CW);
  L.ldF = ld_of(d.F);
  const size_t f4 = 4, b2 = 2, R = ROWS;
  size_t o = 0;
  L.pts = take(o, R * 3 * f4);
  L.g = take(o, R * 3 * f4);
  L.ef = backward ? 0 : take(o, R * d.E * f4);
  L.de = backward ? 0 : take(o, R * d.E * f4);
  L.eb = take(o, R * L.ldE * b2);
  L.u = take(o, R * L.ldX * b2);
  L.cin = take(o, R * imax(L.ldC, L.ldX) * b2);  // the backward stages ldX-wide operands here
  L.head = take(o, R * 8 * f4);
  L.ray = take(o, 8 * f4);
  L.alpha = take(o, R * f4);
  L.w = take(o, R * f4);
  L.red = take(o, imax(TNT, 2 * NTP * 8) * f4);  // cta sums; gemm_fused's column sums
  L.ring = take(o, (size_t)(backward ? NSTAGE_BWD : NSTAGE_FWD) * STAGE * 8);
  if (!backward) {
    L.qe = take(o, R * d.E * f4);
    L.ha = take(o, R * L.ldX * b2);
    L.hb = take(o, R * L.ldX * b2);
    L.srow = take(o, R * f4);
    L.dde = L.tb0 = L.sres = L.cg = L.cdir = L.dx = L.cs = L.chead = L.cheadb = L.tr =
        L.calpha = L.ccin6 = L.cue = 0;
  } else {
    L.dde = 0;
    L.tb0 = take(o, R * L.ldE * b2);
    L.ha = take(o, R * L.ldX * b2);  // the cotangent operands cz
    L.hb = take(o, R * L.ldX * b2);  // and czd
    L.sres = take(o, R * f4);
    L.cg = take(o, R * 3 * f4);
    L.cdir = take(o, R * 3 * f4);
    L.dx = take(o, R * 3 * f4);
    L.cs = take(o, R * f4);
    L.chead = take(o, R * 8 * f4);
    L.cheadb = take(o, R * ld_of(8) * b2);
    L.tr = take(o, R * f4);
    L.calpha = take(o, R * f4);
    L.ccin6 = take(o, R * 6 * f4);   // the colour input's point and normal cotangents
    L.cue = take(o, R * d.E * f4);   // the head reverse's embedding half
    L.qe = L.srow = 0;
  }
  L.fstage = L.bar = 0;
  L.smem = o;
  // scratch: 16-bit states, so that the resident CTAs' scratch stays in L2
  // (sigmoid factors as sig_load reads them, tangent pre-activations bf16;
  // the forward keeps a_s in f32 for the head's f32 sdf row)
  size_t s = 0;
  L.P = take(s, (size_t)d.NH * R * d.H * b2);
  L.AS = take(s, R * d.SW * (backward ? b2 : f4));
  if (!backward) {
    L.ZD = L.PS = L.ZDS = L.CH = L.CHD = 0;
  } else {
    L.ZD = take(s, (size_t)d.NH * R * d.H * b2);
    L.PS = take(s, R * d.SW * b2);
    L.ZDS = take(s, R * d.SW * b2);
    L.CH = take(s, R * d.E * f4);
    L.CHD = take(s, R * d.E * f4);
  }
  L.scratch = s;
  return L;
}

// B7's forward (the colour net alone, Dims with H = 0): the input tile,
// the relu layers' two ping-pong operands, the head, the product ring, then
// the f32 staging rows of the next tile's feature (ROWS x F, filled by a
// bulk copy) and its mbarrier; no scratch. At 2x256: 220,176 bytes, one CTA
// an SM.
__host__ __device__ inline Layout colour_fwd_layout(const Dims& d) {
  Layout L = {};
  L.F = d.F; L.HC = d.HC; L.CW = d.CW; L.W = d.W; L.NHC = d.NHC;
  L.ldX = ld_of(d.HC);
  L.ldC = ld_of(d.CW);
  const size_t f4 = 4, b2 = 2, R = ROWS;
  size_t o = 0;
  L.cin = take(o, R * L.ldC * b2);
  L.ha = take(o, R * L.ldX * b2);
  L.hb = take(o, R * L.ldX * b2);
  L.head = take(o, R * 8 * f4);
  L.ring = take(o, (size_t)NSTAGE_FWD * STAGE * 8);
  L.fstage = take(o, R * d.F * f4);
  L.bar = take(o, 8);
  L.smem = o;
  return L;
}

}  // namespace tc
}  // namespace neus
