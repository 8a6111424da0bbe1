// Tensor-core building blocks of the bf16 NeuS kernels (fused_neus_ray_tc.cu:
// B1's per-ray pair, B3's point-level pair, B6's pair, B7's pair, #12's
// sdf-only forward): the packed bf16 weight layout, the weight ring, the
// CTA-level product forms on Hopper's warpgroup MMA (gemm_rows_pre and
// gemm_fused over a tile: wgmma.mma_async.m64n64k16, bf16 operands, f32
// accumulators), the backward's weight-gradient log and wgrad_kernel's
// tiles (mma.sync), and the shared-memory / scratch layouts of the kernels.
//
// A tile is 64 GEMM rows: one ray's samples (B1, B3) or 64 points (B6, B7).
// Rows past the ray's S samples or the last points are zero-padded points
// whose results are never read and whose cotangents are zero. An
// activation that feeds a product is a bf16 row-major (64 x ld) matrix with
// ld = pad16(K) + 8: the 8 extra columns make the row stride 4 words mod 8,
// so ldmatrix's eight row addresses hit eight different bank groups.
//
// Packed weights: a product's (K x N) right operand B, zero-padded to
// pad16(K) x pad8(N), is stored in wgmma's K-major shared-memory layout
// without swizzle, in passes of NTP = 32 n-tiles (256 columns) and, within
// a pass, in warpgroup slices of WGN = 8 n-tiles (the last may be
// narrower): pass p, then slice w, then k-step kt (16 rows of K), then the
// slice's n-tiles (8 columns), then the two 8 x 8 core matrices of k 0-7
// and 8-15, each 8 rows of n by 8 contiguous k (128 bytes). So any run of
// k-steps of one slice is one contiguous, 256-byte-aligned run (nw * 256
// bytes a k-step, nw the slice's n-tiles), which one bulk copy puts into a
// slot of warpgroup w's ring; a descriptor reads a k-step of it with the
// core matrices 128 bytes apart in K and 256 bytes apart in N.
// ops/fused_neus.py builds the pack per call from the flat f32 weights
// (pack_b, pack_tc; B6's holds the SDF layers alone; pack_colour_tc, B7's,
// the colour layers alone); the flat f32 buffer stays the interface and
// carries the biases and the head's f32 sdf row.
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
// Thread 0 is a thread of consumer warpgroup 0 and that warpgroup's
// producer: its product k-loops (PH_GEMM) leave out its waits for a slot's
// weights to land (PH_FULL) and its issuing of the copies (PH_COPY). A
// product's epilogue time also goes to slot PH_TAGS + the tag phase_tag
// last set. PH_COMPOSITE is B1's compositing and the per-point I/O: B3's
// and B6's forward's stores, B7's backward's input tile and head cotangent.
enum { PH_OTHER = 0, PH_GEMM, PH_WGRAD, PH_COPY, PH_COLPASS, PH_COMPOSITE, PH_EPI, PH_LOG,
       PH_TAGS = 8, PH_FULL = 20, PH_N = 24, PH_MAXCTA = 1024 };
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
constexpr int TNT = 512;         // threads a CTA: 16 warps to hide the epilogues' latencies
constexpr int NWARP = TNT / 32;
constexpr int NWG = TNT / 128;   // warpgroups: each multiplies all 64 rows by its own columns
constexpr int WGN = 8;           // n-tiles a warpgroup takes a pass: one m64n64k16 a k-step
constexpr int NTP = NWG * WGN;   // n-tiles a pass (256 columns)
constexpr int KS = 2;            // k-steps a ring slot holds (one bulk copy)
constexpr int NSLOT = 3;         // weight ring slots of a warpgroup
constexpr int WSLOT = KS * WGN * 256;  // bytes of a slot (4 KB: the ring is NWG x NSLOT x 4 KB = 48 KB)

__host__ __device__ inline int pad16(int k) { return (k + 15) / 16 * 16; }
__host__ __device__ inline int ld_of(int k) { return pad16(k) + 8; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Packed matrices by index (Pack::off, in uint2: 4 bf16). Forward forms
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
// one arrival on the barrier
__device__ inline void mbar_arrive(uint64_t* bar) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(a) : "memory");
}
// order this thread's earlier generic shared-memory writes before later
// async-proxy accesses (bulk copies, wgmma's operand reads) of the same bytes
__device__ inline void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// ---- Hopper's warpgroup MMA (wgmma): the four warps of a warpgroup issue
// each instruction together; a product runs asynchronously and is ordered
// by fence (registers written before it), commit (close a group) and wait
// (at most N groups still running).
__device__ inline void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ inline void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ inline void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving a register's reads or writes across the
// asynchronous products that own it
template <int N>
__device__ inline void wg_pin(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// descriptor of a B operand in shared memory: K-major, no swizzle, core
// matrices (8 rows of n x 16 bytes of k) 128 bytes apart in K (the leading
// byte offset) and 256 bytes apart in N (the stride byte offset)
__device__ inline uint64_t b_desc(const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// d(64 x 64, f32) += A(64 x 16) . B(16 x 64), A bf16 from registers (warp
// w of the group: rows 16 w .., mma.m16n8k16's A fragment), B bf16 by
// descriptor; d as mma.m16n8k16's C fragments of the group's 8 n-tiles:
// d[4 j + e] = (row 16 w + g + 8 (e >> 1), column 8 j + 2 t + (e & 1))
__device__ inline void wgmma64(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// a barrier of the 128 threads of one warpgroup (ids 1 .. NWG; 0 is
// __syncthreads')
__device__ inline void wg_bar(int id) { asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory"); }
#else
// host compilers (a CPU rehearsal of the kernels) supply their own
void mbar_arrive(uint64_t* bar);
void fence_proxy_async();
void wg_fence();
void wg_commit();
template <int N>
void wg_wait();
template <int N>
void wg_pin(float* d);
uint64_t b_desc(const void* p);
void wgmma64(float* d, const uint32_t* a, uint64_t desc);
void wg_bar(int id);
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

// ---- the weight ring
//
// Every product of a kernel reads its weights from a ring in shared
// memory, filled by bulk copies (the Tensor Memory Accelerator's 1-D form)
// from the pack in L2. Each warpgroup has a ring of its own: NSLOT slots,
// each KS k-steps of the warpgroup's slice of a pass (one contiguous run of
// the pack, 4 KB for a full slice), each with a full mbarrier that the copy
// completes. The warpgroup's first thread is its producer. A kernel's
// products come in a fixed order for every tile (its plan, below), so the
// producer walks that sequence of weight streams ahead of its warpgroup,
// across product and tile boundaries: the ring holds the next product's
// first k-steps while an epilogue runs. It refills a slot as soon as its
// own warpgroup's wgmma.wait_group has retired the products that read it,
// so no warpgroup waits for another to release a slot (no empty barrier):
// on this card an mbarrier hand-off between warps costs more than a
// k-step's products, and so does issuing a copy (a few hundred cycles of
// the producer's own time), hence KS k-steps a copy. A pass in which a
// warpgroup has no columns has no chunks for it.

// A kernel's plan: the segments of products one tile runs, in order.
enum { SEG_SDF = 1, SEG_HEAD, SEG_SWEEP, SEG_COL, SEG_COLREV, SEG_TAN, SEG_RHEAD, SEG_PAIRS };
enum : unsigned {
  // B1's and B3's forward: the SDF stack with its head, the gradient sweep, the colour net
  PLAN_RAY_FWD = SEG_SDF | SEG_HEAD << 4 | SEG_SWEEP << 8 | SEG_COL << 12,
  // B1's and B3's backward: both primal stacks, the colour reverse, the SDF reverse
  PLAN_RAY_BWD = SEG_SDF | SEG_HEAD << 4 | SEG_COL << 8 | SEG_COLREV << 12 | SEG_TAN << 16 |
                 SEG_RHEAD << 20 | SEG_PAIRS << 24,
  PLAN_SDF_FWD = SEG_SDF | SEG_HEAD << 4 | SEG_SWEEP << 8,  // B6's forward
  PLAN_SDF_BWD = SEG_SDF | SEG_TAN << 4 | SEG_RHEAD << 8 | SEG_PAIRS << 12,  // B6's backward
  PLAN_SDF_ONLY = SEG_SDF,                                  // #12
  PLAN_COL_FWD = SEG_COL,                                   // B7's forward
  PLAN_COL_BWD = SEG_COL | SEG_COLREV << 4,                 // B7's backward
};

__host__ __device__ inline int seg_len(int seg, const Dims& d) {
  return seg == SEG_HEAD || seg == SEG_RHEAD ? 1 : (seg == SEG_COL || seg == SEG_COLREV ? d.NHC : d.NH) + 1;
}
// matrix j of a segment: the SDF stack and the tangents FS + 0 .. NH, the
// sweep and the reverse pairs RS + NH .. 0, the colour net FC + 0 .. NHC,
// its reverse RC + NHC .. 0
__host__ __device__ inline int seg_mat(int seg, int j, const Dims& d) {
  switch (seg) {
    case SEG_SDF: case SEG_TAN: return FS + j;
    case SEG_HEAD: return FHEAD;
    case SEG_SWEEP: case SEG_PAIRS: return RS + d.NH - j;
    case SEG_COL: return FC + j;
    case SEG_COLREV: return RC + d.NHC - j;
    default: return RHEAD;
  }
}
__host__ __device__ inline int plan_len(unsigned plan, const Dims& d) {
  int n = 0;
  for (; plan; plan >>= 4) n += seg_len(plan & 15, d);
  return n;
}
// the matrix of product i of a tile's plan
__host__ __device__ inline int plan_mat(unsigned plan, int i, const Dims& d) {
  for (; plan; plan >>= 4) {
    const int n = seg_len(plan & 15, d);
    if (i < n) return seg_mat(plan & 15, i, d);
    i -= n;
  }
  return -1;
}
// a packed matrix's (K, N): forward forms (in, out), reverse forms (out, in)
__host__ __device__ inline void mat_kn(const Dims& d, int m, int& K, int& N) {
  if (m == FHEAD || m == RHEAD) {
    K = m == FHEAD ? d.H : d.F;
    N = m == FHEAD ? d.F : d.H;
  } else if (m < FC) {
    const int i = m < RS ? m - FS : m - RS;
    K = m < RS ? sdf_in(d, i) : sdf_out(d, i);
    N = m < RS ? sdf_out(d, i) : sdf_in(d, i);
  } else {
    const int l = m < RC ? m - FC : m - RC;
    K = m < RC ? col_in(d, l) : col_out(d, l);
    N = m < RC ? col_out(d, l) : col_in(d, l);
  }
}

// One product of a plan as the producer reads it: its packed matrix
// (uint2 offset in the pack, and its index m), k-steps and n-tiles.
struct PlanStep {
  unsigned src;
  unsigned char KT, NT, m, pad;
};
constexpr int MAXPLAN = 4 * (MAXNH + 1) + 2 * (MAXNHC + 1) + 2;  // the longest plan's products

// the rings' full barriers and the resolved plan (tc_layout's rbar)
constexpr int RBAR_BYTES = NWG * NSLOT * 8 + MAXPLAN * (int)sizeof(PlanStep);

// Each thread's handle on its warpgroup's ring: where it lives, the
// warpgroup's count of chunks consumed (each thread of the group walks the
// same sequence), and, in the producer's registers, its cursor.
struct Ring {
  unsigned char* slots;   // the warpgroup's NSLOT x WSLOT bytes
  uint64_t* full;         // the warpgroup's NSLOT barriers: a slot's copy has landed
  const PlanStep* plan;   // the plan, resolved once at the kernel's start
  const uint2* pk;
  int len, w;             // products a tile; the thread's warpgroup
  unsigned cons;          // chunks the warpgroup consumed
  int prod;               // products begun, modulo len (thread 0's count)
  // the producer (the warpgroup's thread 0): chunks issued, the product of
  // the plan being issued, its pass and k-step, the tiles left, the product
  unsigned issued;
  int pprod, pass, kt, tiles;
  PlanStep cur;
};

// The producer: move the cursor (product, pass) forward, from where it is,
// to the first pass in which the warpgroup has columns; tiles reaches 0
// past the plan's last tile.
__device__ __forceinline__ void ring_seek(Ring& rg) {
  while (rg.tiles > 0) {
    const int rest = rg.cur.NT - rg.pass * NTP;
    if (rest > rg.w * WGN) return;
    if (rest > 0) {
      ++rg.pass;
      continue;
    }
    rg.pass = 0;
    if (++rg.pprod == rg.len) {
      rg.pprod = 0;
      --rg.tiles;
    }
    rg.cur = rg.plan[rg.pprod];
  }
}

// The producer: issue chunks (KS k-steps of the warpgroup's slice, fewer at
// a pass's end) into the slots its warpgroup has retired, up to NSLOT ahead
// of the `done` chunks whose products have all retired.
__device__ __forceinline__ void ring_fill(Ring& rg, unsigned done) {
  while (rg.tiles > 0 && rg.issued < done + NSLOT) {
    const unsigned slot = rg.issued % NSLOT;
    const int KT = rg.cur.KT, rest = rg.cur.NT - rg.pass * NTP, ntp = rest < NTP ? rest : NTP;
    const int nw = ntp - rg.w * WGN < WGN ? ntp - rg.w * WGN : WGN;
    const int nk = KT - rg.kt < KS ? KT - rg.kt : KS;
    const uint2* src = rg.pk + rg.cur.src +
                       ((size_t)(rg.pass * NTP + rg.w * WGN) * KT + (size_t)rg.kt * nw) * 32;
    bulk_load(rg.slots + (size_t)slot * WSLOT, src, (unsigned)(nk * nw) * 256u, rg.full + slot);
    ++rg.issued;
    if ((rg.kt += nk) == KT) {
      rg.kt = 0;
      ++rg.pass;
      ring_seek(rg);
    }
  }
}

// tiles a CTA b of g walks, of n: b, b + g, ...
__host__ __device__ inline int tiles_of(int n, int b, int g) { return n > b ? (n - b + g - 1) / g : 0; }

// The rings of a kernel whose CTA runs `tiles` tiles of plan `plan`, in
// shared memory at ring (slots) and rbar (barriers, plan). Every thread
// calls it, after the kernel has zeroed its shared memory (the zeroing
// threads' proxy fence orders those writes before the copies into the
// slots); it resolves the plan, starts each warpgroup's first copies and
// ends with __syncthreads.
__device__ inline Ring ring_init(unsigned char* ring, unsigned char* rbar, const Dims& d,
                                 const Pack& pp, const uint2* pk, unsigned plan, int tiles) {
  Ring rg;
  rg.w = threadIdx.x >> 7;
  rg.slots = ring + (size_t)rg.w * NSLOT * WSLOT;
  rg.full = (uint64_t*)rbar + rg.w * NSLOT;
  PlanStep* table = (PlanStep*)((uint64_t*)rbar + NWG * NSLOT);
  rg.plan = table;
  rg.pk = pk;
  rg.len = plan_len(plan, d);
  rg.cons = 0;
  rg.prod = 0;
  rg.issued = 0;
  rg.pprod = rg.pass = rg.kt = 0;
  rg.tiles = tiles;
  fence_proxy_async();
  if (threadIdx.x == 0)
    for (int i = 0; i < rg.len; ++i) {
      int K, N;
      const int m = plan_mat(plan, i, d);
      mat_kn(d, m, K, N);
      table[i] = PlanStep{(unsigned)pp.off[m], (unsigned char)((K + 15) / 16),
                          (unsigned char)((N + 7) / 8), (unsigned char)m, 0};
    }
  __syncthreads();
  if ((threadIdx.x & 127) == 0) {
    for (int i = 0; i < NSLOT; ++i) mbar_init(rg.full + i, 1);
    rg.cur = table[0];
    ring_seek(rg);
    ring_fill(rg, 0);
  }
  __syncthreads();
  return rg;
}

// A product begins: it must be the plan's next (m: its packed matrix, K x
// N); a kernel whose calls stray from its plan traps instead of reading
// another product's weights (checked by thread 0, which counts rg.prod).
__device__ __forceinline__ void ring_begin(Ring& rg, int m, int K, int N) {
  if (threadIdx.x != 0) return;
  const PlanStep p = rg.plan[rg.prod];
  if (p.m != m || p.KT != (K + 15) / 16 || p.NT != (N + 7) / 8) __trap();
  if (++rg.prod == rg.len) rg.prod = 0;
}

// The warpgroup's slot of its next chunk, once its copy has landed. One
// lane a warp polls the full barrier and __syncwarp orders the rest after
// it. A chunk the producer has not issued is a plan fault: trap.
__device__ __forceinline__ const unsigned char* ring_wait(Ring& rg) {
  if ((threadIdx.x & 127) == 0 && rg.issued <= rg.cons) __trap();
  phase_mark(PH_GEMM);
  const unsigned slot = rg.cons % NSLOT;
  if ((threadIdx.x & 31) == 0) mbar_wait(rg.full + slot, (rg.cons / NSLOT) & 1);
  __syncwarp();  // the warp after its poller, converged for the .aligned instructions
  phase_mark(PH_FULL);
  return rg.slots + (size_t)slot * WSLOT;
}

// ---- the product forms
//
// A product is out(64 x N) = A(64 x K) . B, B packed, A bf16 row-major with
// stride ld (columns K .. pad16(K) finite: the packed rows there are zero).
// Each of the NWG warpgroups multiplies all 64 rows by its own WGN n-tiles
// of a pass (warpgroup w: n-tiles w WGN .. of the pass), one m64n64k16 a
// k-step, A from registers (ldmatrix; warp q of the group gives rows 16 q
// ..), B from its ring's slot by descriptor; a warpgroup with no n-tile in
// a pass has nothing to do in it. Thread (warpgroup w, warp q, lane 4 g +
// t) then holds element (16 q + g + 8 (e >> 1), 8 n + 2 t + (e & 1)) of
// n-tile n = nb + j in acc[4 j + e]: a given (r, c) goes to the same thread
// in every call with the same N. No barrier inside a k-loop: a warpgroup
// waits only for its own slots' copies.

// the k-loop of one pass over KT k-steps (DUAL: acc1 += A1 . B on the same
// slots), one wgmma group a k-step, a new slot every KS = 2; on return
// every product of the warpgroup has retired and the producer has refilled
// the slots they read (a slot's refill goes out at the next slot's second
// k-step, under that k-step's products). `on`: the warpgroup has n-tiles
// in this pass, nw of them. The A fragments of even and odd k-steps take
// two register sets: a k-step's loads go to the set whose products
// wait_group<1> has already retired, so no register is rewritten under a
// product still reading it. (ptxas still serializes the wgmmas of most
// kernels for these loads, C7513; a slot a group with wait_group<0> before
// the next loads drew more such notes and was slower, PERF.md §6.)
static_assert(KS == 2, "kloop takes a slot's two k-steps as its even and odd step");
template <bool DUAL>
__device__ __forceinline__ void kloop(Ring& rg, const bf16* A0, const bf16* A1, int ld, int KT,
                                      bool on, int nw, float* acc0, float* acc1) {
  const int lane = threadIdx.x & 31, q = (threadIdx.x >> 5) & 3;
  // lane l's ldmatrix row: blocks (rows +0, k +0), (+8, +0), (+0, +8), (+8, +8)
  const size_t arow = (size_t)(16 * q + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
#pragma unroll
  for (int i = 0; i < 4 * WGN; ++i) acc0[i] = acc1[i] = 0.f;
  wg_pin<4 * WGN>(acc0);
  if (DUAL) wg_pin<4 * WGN>(acc1);
  // the same in every lane, and seen to be: no wgmma on a divergent path
  // (ptxas would serialize every product of the kernel)
  if (!__shfl_sync(0xffffffffu, on, 0)) return;
  const bool producer = (threadIdx.x & 127) == 0;
  const int kstep = nw * 256;  // bytes of a k-step in a slot
  uint32_t x0[2][4], x1[2][4];
  const unsigned char* slot = nullptr;
  // k-step kt, its fragments in set h = kt % 2; the even one takes a slot
  auto step = [&](int kt, int h) {
    ldsm_x4(x0[h], A0 + arow + kt * 16);
    if (DUAL) ldsm_x4(x1[h], A1 + arow + kt * 16);
    if (h == 0) {
      slot = ring_wait(rg);
      ++rg.cons;
    }
    const uint64_t desc = b_desc(slot + h * kstep);
    wg_fence();
    wgmma64(acc0, x0[h], desc);
    if (DUAL) wgmma64(acc1, x1[h], desc);
    wg_commit();
    if (h == 1 && producer) {
      // the previous wait_group<1> retired every slot before this one: the
      // copy into the oldest goes out while this slot's products run
      phase_mark(PH_GEMM);
      ring_fill(rg, rg.cons - 1);
      phase_mark(PH_COPY);
    }
    wg_wait<1>();  // the previous k-step's products have retired
    __syncwarp();
  };
#pragma unroll 1
  for (int kt = 0; kt < KT; kt += 2) {
    step(kt, 0);
    if (kt + 1 < KT) step(kt + 1, 1);
  }
  wg_wait<0>();
  wg_pin<4 * WGN>(acc0);
  if (DUAL) wg_pin<4 * WGN>(acc1);
  if (producer) ring_fill(rg, rg.cons);
  __syncwarp();
}

struct NoPre {
  __device__ float operator()(int, int) const { return 0.f; }
};

// gemm_rows_pre: epi(r, c, v, pre(r, c)) for every row and every column
// c < pad8(N) (v = 0 past N). A warpgroup's epilogue runs as soon as its
// own k-loop ends: it reads the inputs pre(r, c) of four n-tiles at once,
// then stores (read one by one between the stores, each would wait out the
// memory latency). epi must not write A. Every thread of the CTA calls it;
// ends with __syncthreads.
template <class Pre, class Epi>
__device__ __forceinline__ void gemm_rows_pre(Ring& rg, const bf16* A, int ld, int K, int m, int N,
                                              Pre pre, Epi epi) {
  phase_mark(PH_OTHER);
  ring_begin(rg, m, K, N);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * ((threadIdx.x >> 5) & 3) + g, w = threadIdx.x >> 7;
  const int KT = (K + 15) / 16, NTl = (N + 7) / 8;
  for (int nb0 = 0; nb0 < NTl; nb0 += NTP) {
    const int nb = nb0 + w * WGN;
    float acc[4 * WGN];
    kloop<false>(rg, A, A, ld, KT, nb < NTl, NTl - nb < WGN ? NTl - nb : WGN, acc, acc);
    phase_mark(PH_GEMM);
    using PV = decltype(pre(0, 0));
#pragma unroll
    for (int h = 0; h < WGN; h += 4) {
      PV pv[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pv[j][e] = nb + h + j < NTl ? pre(r0 + (e >> 1) * 8, (nb + h + j) * 8 + 2 * t + (e & 1)) : PV{};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (nb + h + j >= NTl) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          epi(r0 + (e >> 1) * 8, (nb + h + j) * 8 + 2 * t + (e & 1), acc[4 * (h + j) + e], pv[j][e]);
      }
    }
  }
  __syncthreads();
  phase_mark(PH_EPI);
}

// out(64 x N) = A . B with a store-only epilogue epi(r, c, v)
template <class Epi>
__device__ __forceinline__ void gemm_rows(Ring& rg, const bf16* A, int ld, int K, int m, int N,
                                          Epi epi) {
  gemm_rows_pre(rg, A, ld, K, m, N, NoPre(), [&](int r, int c, float v, float) { epi(r, c, v); });
}

// A product (two when DUAL: out0 = A0 . B and out1 = A1 . B over one
// weight stream; A0, A1 bf16 64 x K, stride ld) whose epilogue may write
// over its operands and sums its columns. A barrier follows each pass's
// k-loop, so epi may overwrite A0 / A1 when N <= NTP * 8 (one pass).
// epi(r, c, v0, v1, pre(r, c)) stores (v1 = 0 unless DUAL) and returns the
// element's share of column c's sum; colsum[c - cs0] += the sum over the 64
// rows for cs0 <= c < cs1, in a fixed order: within a warp by a butterfly
// over its 16 rows, then warps (q0 + q2) + (q1 + q3) of the column's
// warpgroup through red (2 x 64 floats a warpgroup); no sums when colsum is
// null. Ends with __syncthreads.
template <bool DUAL, class Pre, class Epi>
__device__ __forceinline__ void gemm_fused(Ring& rg, const bf16* A0, const bf16* A1, int ld, int K,
                                           int m, int N, float* red, float* colsum, int cs0,
                                           int cs1, Pre pre, Epi epi) {
  phase_mark(PH_OTHER);
  ring_begin(rg, m, K, N);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, q = (threadIdx.x >> 5) & 3;
  const int r0 = 16 * q + g, w = threadIdx.x >> 7;
  const int KT = (K + 15) / 16, NTl = (N + 7) / 8;
  for (int nb0 = 0; nb0 < NTl; nb0 += NTP) {
    const int nb = nb0 + w * WGN;
    float acc0[4 * WGN], acc1[4 * WGN];
    kloop<DUAL>(rg, A0, DUAL ? A1 : A0, ld, KT, nb < NTl, NTl - nb < WGN ? NTl - nb : WGN, acc0, acc1);
    __syncthreads();  // A0 / A1 are free
    phase_mark(PH_GEMM);
    float cs[WGN][2];
#pragma unroll
    for (int j = 0; j < WGN; ++j) cs[j][0] = cs[j][1] = 0.f;
    using PV = decltype(pre(0, 0));
#pragma unroll
    for (int j = 0; j < WGN; ++j) {
      if (nb + j >= NTl) continue;
      // an n-tile's inputs at once, then its stores (few registers: the
      // accumulators of both products are live here)
      PV pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[e] = pre(r0 + (e >> 1) * 8, (nb + j) * 8 + 2 * t + (e & 1));
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cs[j][e & 1] += epi(r0 + (e >> 1) * 8, (nb + j) * 8 + 2 * t + (e & 1), acc0[4 * j + e],
                            DUAL ? acc1[4 * j + e] : 0.f, pv[e]);
    }
    if (colsum) {
#pragma unroll
      for (int j = 0; j < WGN; ++j)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          float v = cs[j][k];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          cs[j][k] = v;
        }
      float* rw = red + w * 128;  // this warpgroup's 2 x 64 floats
      if (q < 2 && g == 0)
#pragma unroll
        for (int j = 0; j < WGN; ++j)
#pragma unroll
          for (int k = 0; k < 2; ++k) rw[q * 64 + j * 8 + 2 * t + k] = cs[j][k];
      wg_bar(1 + w);
      if (q >= 2 && g == 0)
#pragma unroll
        for (int j = 0; j < WGN; ++j)
#pragma unroll
          for (int k = 0; k < 2; ++k) rw[(q - 2) * 64 + j * 8 + 2 * t + k] += cs[j][k];
      wg_bar(1 + w);
      const int i = threadIdx.x & 127, c = nb * 8 + i;
      if (i < 64 && c < N && c >= cs0 && c < cs1) colsum[c - cs0] += rw[i] + rw[64 + i];
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
      chead, cheadb, ray, alpha, w, tr, calpha, ccin6, cue, red, ring, rbar, fstage, bar, smem;
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
  L.ring = take(o, (size_t)NWG * NSLOT * WSLOT);  // first: 128-byte aligned
  L.rbar = take(o, RBAR_BYTES);
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
  L.red = take(o, TNT * f4);  // cta sums; gemm_fused's column sums (2 x 64 a warpgroup)
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

// B7's forward (the colour net alone, Dims with H = 0): the weight ring and
// its barriers, the input tile, the relu layers' two ping-pong operands, the
// head, then the f32 staging rows of the next tile's feature (ROWS x F,
// filled by a bulk copy) and its mbarrier; no scratch. At 2x256: 220,320
// bytes, one CTA an SM.
__host__ __device__ inline Layout colour_fwd_layout(const Dims& d) {
  Layout L = {};
  L.F = d.F; L.HC = d.HC; L.CW = d.CW; L.W = d.W; L.NHC = d.NHC;
  L.ldX = ld_of(d.HC);
  L.ldC = ld_of(d.CW);
  const size_t f4 = 4, b2 = 2, R = ROWS;
  size_t o = 0;
  L.ring = take(o, (size_t)NWG * NSLOT * WSLOT);
  L.rbar = take(o, RBAR_BYTES);
  L.cin = take(o, R * L.ldC * b2);
  L.ha = take(o, R * L.ldX * b2);
  L.hb = take(o, R * L.ldX * b2);
  L.head = take(o, R * 8 * f4);
  L.fstage = take(o, R * d.F * f4);
  L.bar = take(o, 8);
  L.smem = o;
  return L;
}

}  // namespace tc
}  // namespace neus
