// Hard z-buffer winner selection for Hopper (sm_90a): the binned kernel (B2)
// and the brute-force kernel (#15).
//
// B2 replaces the Pallas kernel avatarclip_tpu/ops/raster_zbuffer.py
// `_zbuffer_kernel_tiled` (:266), launched by `zbuffer_select_tiled` (:304)
// with the winner rule of `_select_update` (:66).
//
// For every pixel of an (H, W) image: the face whose three oriented
// barycentric edge values are all >= 0, whose screen-linear inverse depth iz
// is > 0 and which is valid, maximising (iz, face id) lexicographically in
// exact f32 (ties to the higher face id); -1 where no face covers the pixel.
// Each edge value is evaluated as (px * c0 + py * c1) + c2 with separately
// rounded products and sums (__fmul_rn / __fadd_rn: no FMA contraction), the
// same order the plain PyTorch version uses, so the two agree bit for bit.
//
// What bounds B2 on this card: the (pixel, face) pairs inside each face's
// pixel bbox, ~17 f32 operations each (4 K=3 dots and the tests; no tensor
// cores: K = 3, and TF32 would break the inside test of thin faces), and the
// bytes (coef, valid and the corners once, the ids once). At the main path's
// shapes both lie below one launch's latency (0.2-0.7 us against a few us),
// so the floor in practice is one launch. The Pallas kernel's culling (a
// table of 32 x 32 tiles against 512-face blocks, built by ~15 small torch
// ops) kept almost every pair: a mesh's faces are in mesh order, so nearly
// every block's bbox covers nearly every tile, and 64 CTAs filled half the
// card at 256^2. Design:
// - a prologue kernel (one thread a face) turns each face's corners into
//   the pixels its bbox, widened by a 1 px float margin (the JAX table's),
//   may cover: an x and a y range, 8 bytes; an invalid face gets an empty
//   range. A tile meets the range exactly when the f32 test of
//   ops/raster_zbuffer.py's `tile_faces` (its Python twin) keeps the face;
// - the raster kernel: a 16 x 16 tile is a thread block cluster of
//   `split` CTAs (4 at 224^2 and 256^2: 784 and 1,024 CTAs; 2 at 512^2:
//   2,048), each over every split-th face, one thread a pixel. A dense
//   mesh small on the screen puts ~1,900 faces in one tile (the 13,441-face
//   body at 256^2) and none in most: the split shares out both that tile's
//   work and every CTA's walk of the face list. A CTA walks its faces in
//   passes of 2,048 in increasing id, each thread testing 8 ranges
//   (L1-resident), and compacts those that meet its tile into shared
//   memory with a warp ballot and a prefix count over the (face slot, warp)
//   counts: increasing id order, no atomics, no host sync. The next pass's
//   ranges load while this pass's faces are staged (256 at a time, 56 B
//   each) and evaluated. A warp holds 8 x 4 pixels and takes, in order,
//   only the staged faces whose range meets them (a lane tests one face of
//   32, then the ballot's bits in turn). Every thread keeps its running
//   (iz, id) winner in registers, ">=" on iz giving the tie-break; then
//   each CTA of the cluster merges a share of the tile's pixels over the
//   CTAs' winners, read from their shared memory (the largest (iz, id), in
//   rank order: the same bits every run);
// - one call, no torch ops: the caller's (F, 3, 4) coefficients, (F,) bool
//   flags and (F, 3) corners are read in place, ragged face counts and edge
//   tiles masked.
//
// The brute-force kernel (#15) replaces avatarclip_tpu/ops/raster_zbuffer.py
// `_zbuffer_kernel` (:104, entry `zbuffer_select` :144): the same winner
// rule and (px * c0 + py * c1) + c2 evaluation over EVERY (pixel, face)
// pair. It has no bbox, range, tile or table culling of any kind and shares
// nothing with B2's face_ranges_kernel (or its twin tile_faces): it is the
// check of B2's culling that B2's culling code cannot pass by construction.
// What bounds it: the pairs, H W F of them, each 16 unfused f32 operations
// (four edge values of 2 products and 2 sums) and the tests: 8.81e8 pairs
// at 256^2 x 13,441 faces, ~0.42 ms at 132 SMs x 128 lanes x 1.98 GHz.
// Design:
// - the work is split two ways (ops/raster_zbuffer.py's `brute_plan` is
//   the Python twin): 32 x 32 pixel tiles times K contiguous face slices,
//   one CTA a (tile, slice), K the most that keeps the grid within BR_CTAS
//   (2 waves of 8 CTAs an SM: 64 tiles x 33 slices at 256^2, 256 x 8 at
//   512^2, 49 x 43 at 224^2), with at least BR_FBLOCK faces a slice;
// - a CTA is 8 x 8 threads, each holding 4 x 4 pixels 8 apart (register
//   blocked): a face's 12 coefficients come as three 16-byte broadcast
//   shared loads for 16 pairs, and the products px * c0 of a column and
//   py * c1 of a row are made once for the 4 pixels that share them (the
//   same rounded products, so the same bits): 8 sums and 2 products a pair;
// - the slice's faces are staged BR_FBLOCK at a time (one a thread) by
//   cp.async into two shared buffers, block b + 1 in flight while block b
//   is evaluated. The thread that copied a face folds its `valid` flag into
//   it: an invalid face's edge-0 constant becomes NaN, so its b0 is NaN at
//   every pixel and fails ">= 0" (`fold_valid` is the twin). The inner loop
//   has no validity load or branch;
// - a slice's faces are walked in increasing id with ">=" on iz, from a
//   running iz of the least positive float (the denormal 2^-149; nothing is
//   flushed, so iz >= it iff iz > 0, NaN failing both): ties go to the
//   higher id and iz > 0 needs no test of its own. "Inside" is three
//   ">= 0" compares: not sign bits (an edge value can be -0.0, which is
//   inside) and not fminf (which drops a NaN). No FMA (__fmul_rn /
//   __fadd_rn): contraction would change the last bit of an edge value
//   near 0. No tensor cores: K is 3 and the dots stay in f32;
// - the K slices' winners merge by a 64-bit atomicMax of (iz bits << 32 |
//   id) into a zeroed (H W) scratch: valid winners have iz > 0, whose bits
//   order as unsigned integers, so the max is the lexicographic max of (iz,
//   id), the same bits in any order of arrival (a max is exact; the
//   port's one atomic). A last pass writes the id, or -1 where no key came.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BR_TILE = 32;               // #15's screen tile (pixels a side) ...
constexpr int BR_TX = 8;                  // ... its CTA's threads 8 x 8 ...
constexpr int BR_THREADS = BR_TX * BR_TX;
constexpr int BR_PX = BR_TILE / BR_TX;    // ... each 4 x 4 pixels, 8 apart
constexpr int BR_FBLOCK = BR_THREADS;     // faces a staged block, one a thread
constexpr int BR_CTAS = 2112;             // the face split's most CTAs: 2 waves of 8 an SM of 132

constexpr int BIN = 16;                // the binned kernel's screen tile (pixels a side)
constexpr int BT = BIN * BIN;          // its threads: one a pixel
constexpr int BWARPS = BT / 32;
constexpr int WX = 8, WY = 4;          // a warp's pixels: 8 x 4, the tile 2 x 4 warps
constexpr int BK = 8;                  // faces a thread tests a pass
constexpr int BPASS = BT * BK;         // faces a pass
constexpr int BSTAGE = 256;            // faces staged in shared memory at once
constexpr int EMPTY = (int)0xffff0000u;  // the range [0, -1]

__device__ __forceinline__ float lin(float px, float py, float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(px, a), __fmul_rn(py, b)), c);
}

// A face's pixel range on one axis, from its corners' min lo and max hi:
// the first pixel p in [0, n) with lo <= p + 1 in f32 (n if none) and the
// last with hi >= p - 1 (-1 if none), i.e. the pixels within the 1 px float
// margin of its bbox. Each test is monotone in p: a guess from the clamped
// value, then steps by the exact test itself.
__device__ __forceinline__ int first_px(float lo, int n) {
  int p = (int)floorf(fminf(fmaxf(lo, -4.f), n + 4.f)) - 2;
  p = min(max(p, 0), n);
  while (p > 0 && lo <= (float)p) --p;  // pixel p - 1 passes: lo <= (p - 1) + 1
  while (p < n && !(lo <= (float)(p + 1))) ++p;
  return p;
}
__device__ __forceinline__ int last_px(float hi, int n) {
  int p = (int)floorf(fminf(fmaxf(hi, -4.f), n + 4.f)) + 2;
  p = min(max(p, -1), n - 1);
  while (p < n - 1 && hi >= (float)p) ++p;  // pixel p + 1 passes: hi >= (p + 1) - 1
  while (p >= 0 && !(hi >= (float)(p - 1))) --p;
  return p;
}

__device__ __forceinline__ float min3(float a, float b, float c) { return fminf(fminf(a, b), c); }
__device__ __forceinline__ float max3(float a, float b, float c) { return fmaxf(fmaxf(a, b), c); }

// rng[f] = (x0 | x1 << 16, y0 | y1 << 16): the pixels face f may cover, in
// the padded (n_ty BIN, n_tx BIN) grid (16-bit fields); [0, -1] for an
// invalid face or one with a NaN corner. A tile (or a warp's pixels) meets
// the range iff the f32 test of tile_faces keeps the face for it.
__global__ void face_ranges_kernel(const float* __restrict__ sx, const float* __restrict__ sy,
                                   const unsigned char* __restrict__ valid, int2* __restrict__ rng,
                                   int F, int n_px, int n_py) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  const float x0 = sx[3 * f], x1 = sx[3 * f + 1], x2 = sx[3 * f + 2];
  const float y0 = sy[3 * f], y1 = sy[3 * f + 1], y2 = sy[3 * f + 2];
  const bool nan = isnan(x0) || isnan(x1) || isnan(x2) || isnan(y0) || isnan(y1) || isnan(y2);
  int2 r = make_int2(EMPTY, EMPTY);
  if (valid[f] && !nan) {
    const int px0 = first_px(min3(x0, x1, x2), n_px), px1 = last_px(max3(x0, x1, x2), n_px);
    const int py0 = first_px(min3(y0, y1, y2), n_py), py1 = last_px(max3(y0, y1, y2), n_py);
    if (px0 <= px1 && py0 <= py1) r = make_int2(px0 | (px1 << 16), py0 | (py1 << 16));
  }
  rng[f] = r;
}

// a packed range meets the pixels [lo, hi]
__device__ __forceinline__ bool meets(int packed, int lo, int hi) {
  return (packed & 0xffff) <= hi && (packed >> 16) >= lo;
}

__global__ void __launch_bounds__(BT) zbuffer_binned_kernel(
    const float* __restrict__ coef,  // (F, 3, 4): [pixel term k][b0, b1, b2, iz]
    const int2* __restrict__ rng,    // (F,) from face_ranges_kernel
    int* __restrict__ face_id,       // (H * W,) row-major
    int F, int H, int W, int n_tx) {
  __shared__ int s_cnt[BK * BWARPS];  // kept faces by (slot k, warp), then their exclusive prefix
  __shared__ int s_n;
  __shared__ int s_id[BPASS];         // the pass's kept faces, increasing id
  __shared__ float4 s_coef[BSTAGE * 3];
  __shared__ int2 s_rng[BSTAGE];
  __shared__ float s_iz[BT];          // this CTA's winners, for the cluster's merge
  __shared__ int s_best[BT];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();  // the tile's CTAs, each over every split-th face
  const int rank = (int)cluster.block_rank(), tile = blockIdx.x / split;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x0 = (tile % n_tx) * BIN, y0 = (tile / n_tx) * BIN;
  const int wx = x0 + (warp % (BIN / WX)) * WX, wy = y0 + (warp / (BIN / WX)) * WY;
  const float fx = (float)(wx + lane % WX), fy = (float)(wy + lane / WX);
  const unsigned below = (1u << lane) - 1u;
  // this CTA's faces: rank, rank + split, ...: nf of them, slot i is face rank + split i
  const int nf = F > rank ? (F - rank + split - 1) / split : 0;
  float best_iz = -1.f;
  int best = -1;
  int2 r[BK];
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const int i = k * BT + tid;
    r[k] = i < nf ? __ldg(rng + rank + (size_t)split * i) : make_int2(EMPTY, EMPTY);
  }
  for (int base = 0; base < nf; base += BPASS) {
    unsigned keep[BK];
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      keep[k] = __ballot_sync(0xffffffffu, meets(r[k].x, x0, x0 + BIN - 1) &&
                                               meets(r[k].y, y0, y0 + BIN - 1));
      if (lane == 0) s_cnt[k * BWARPS + warp] = __popc(keep[k]);
    }
    // the next pass's ranges, in flight while this pass is compacted and evaluated
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const int i = base + BPASS + k * BT + tid;
      r[k] = i < nf ? __ldg(rng + rank + (size_t)split * i) : make_int2(EMPTY, EMPTY);
    }
    __syncthreads();
    if (warp == 0) {  // exclusive prefix of the BK x BWARPS counts, in (k, warp) order
      constexpr int Q = BK * BWARPS / 32;
      int v[Q], run = 0;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        v[q] = run;
        run += s_cnt[lane * Q + q];
      }
      int incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
#pragma unroll
      for (int q = 0; q < Q; ++q) s_cnt[lane * Q + q] = incl - run + v[q];
      if (lane == 31) s_n = incl;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k)
      if (keep[k] >> lane & 1u)
        s_id[s_cnt[k * BWARPS + warp] + __popc(keep[k] & below)] = rank + split * (base + k * BT + tid);
    __syncthreads();
    const int n = s_n;
    for (int c0 = 0; c0 < n; c0 += BSTAGE) {
      const int m = min(BSTAGE, n - c0);
      for (int e = tid; e < 4 * m; e += BT) {
        const int f = s_id[c0 + e / 4], q = e % 4;
        if (q < 3) s_coef[3 * (e / 4) + q] = __ldg((const float4*)coef + (size_t)f * 3 + q);
        else s_rng[e / 4] = __ldg(rng + f);
      }
      __syncthreads();
      auto eval = [&](int jf) {
        const float4 cx = s_coef[3 * jf], cy = s_coef[3 * jf + 1], cc = s_coef[3 * jf + 2];
        const float b0 = lin(fx, fy, cx.x, cy.x, cc.x);
        const float b1 = lin(fx, fy, cx.y, cy.y, cc.y);
        const float b2 = lin(fx, fy, cx.z, cy.z, cc.z);
        const float iz = lin(fx, fy, cx.w, cy.w, cc.w);
        if (b0 >= 0.f && b1 >= 0.f && b2 >= 0.f && iz > 0.f && iz >= best_iz) {
          best_iz = iz;
          best = s_id[c0 + jf];
        }
      };
      // each warp takes, in order, the staged faces whose range meets its
      // 8 x 4 pixels: a lane tests one face of 32, then the ballot's bits
      for (int j0 = 0; j0 < m; j0 += 32) {
        const int j = j0 + lane;
        const bool hit = j < m && meets(s_rng[j].x, wx, wx + WX - 1) && meets(s_rng[j].y, wy, wy + WY - 1);
        unsigned todo = __ballot_sync(0xffffffffu, hit);
        while (todo) {
          eval(j0 + __ffs((int)todo) - 1);
          todo &= todo - 1u;
        }
      }
      __syncthreads();
    }
  }
  // the cluster's merge: rank r takes pixel slots r BT / split .. and the
  // largest (iz, id) over the ranks' winners (each the largest of its
  // faces), in rank order
  s_iz[tid] = best_iz;
  s_best[tid] = best;
  cluster.sync();
  if (tid < BT / split) {
    const int q = rank * (BT / split) + tid, qw = q >> 5, ql = q & 31;
    float iz = -1.f;
    int id = -1;
    for (int k = 0; k < split; ++k) {
      const float ci = cluster.map_shared_rank(s_iz, k)[q];
      const int cb = cluster.map_shared_rank(s_best, k)[q];
      if (ci > iz || (ci == iz && cb > id)) {
        iz = ci;
        id = cb;
      }
    }
    const int px = x0 + (qw % (BIN / WX)) * WX + ql % WX, py = y0 + (qw / (BIN / WX)) * WY + ql / WX;
    if (py < H && px < W) face_id[py * W + px] = id;
  }
  cluster.sync();  // every rank's shared memory stays until the merge has read it
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// One CTA a (32 x 32 pixel tile, face slice): tile blockIdx.x % n_tiles,
// slice blockIdx.x / n_tiles, faces [slice F / K, (slice + 1) F / K). A16:
// coef 16-byte aligned (three 16-byte copies a face; else twelve of 4).
template <bool A16>
__global__ void __launch_bounds__(BR_THREADS, 8) zbuffer_brute_kernel(
    const float* __restrict__ coef,           // (F, 3, 4): [pixel term k][b0, b1, b2, iz]
    const unsigned char* __restrict__ valid,  // (F,) bool
    unsigned long long* __restrict__ key,     // (H * W,) zeroed: the merge's max
    int F, int H, int W, int n_tx, int n_tiles, int K) {
  __shared__ __align__(16) float4 s_face[2][BR_FBLOCK * 3];
  const int tile = blockIdx.x % n_tiles, slice = blockIdx.x / n_tiles;
  const int f_lo = (int)((long long)slice * F / K), f_hi = (int)((long long)(slice + 1) * F / K);
  const int tid = threadIdx.x;
  const int x0 = (tile % n_tx) * BR_TILE + tid % BR_TX, y0 = (tile / n_tx) * BR_TILE + tid / BR_TX;
  float fx[BR_PX], fy[BR_PX];
#pragma unroll
  for (int j = 0; j < BR_PX; ++j) {
    fx[j] = (float)(x0 + BR_TX * j);
    fy[j] = (float)(y0 + BR_TX * j);
  }
  float best_iz[BR_PX][BR_PX];
  int best[BR_PX][BR_PX];
#pragma unroll
  for (int i = 0; i < BR_PX; ++i)
#pragma unroll
    for (int j = 0; j < BR_PX; ++j) {
      best_iz[i][j] = __int_as_float(1);  // 2^-149: iz >= it iff iz > 0
      best[i][j] = -1;
    }
  // copy face f0 + tid (if in the slice) into buffer b; its valid flag
  auto stage = [&](int b, int f0) -> bool {
    const int f = f0 + tid;
    if (f >= f_hi) return true;
    float* dst = reinterpret_cast<float*>(&s_face[b][3 * tid]);
    const float* src = coef + (size_t)f * 12;
    if (A16) {
#pragma unroll
      for (int q = 0; q < 3; ++q) cp_async16(dst + 4 * q, src + 4 * q);
    } else {
#pragma unroll
      for (int q = 0; q < 12; ++q) cp_async4(dst + q, src + q);
    }
    return valid[f] != 0;
  };
  bool ok_next = stage(0, f_lo);
  cp_async_commit();
  for (int f0 = f_lo, b = 0; f0 < f_hi; f0 += BR_FBLOCK, b ^= 1) {
    const bool ok = ok_next;
    if (f0 + BR_FBLOCK < f_hi) ok_next = stage(b ^ 1, f0 + BR_FBLOCK);
    cp_async_commit();  // (empty after the last block)
    cp_async_wait1();   // this thread's copies of block b are in
    if (!ok) s_face[b][3 * tid + 2].x = __int_as_float(0x7fc00000);  // b0 = NaN: never inside
    __syncthreads();
    const int n = min(BR_FBLOCK, f_hi - f0);
    for (int j = 0; j < n; ++j) {
      const float4 cx = s_face[b][3 * j], cy = s_face[b][3 * j + 1], cc = s_face[b][3 * j + 2];
      const int id = f0 + j;
      float mx[4][BR_PX], my[4][BR_PX];  // px * c0 of each column, py * c1 of each row
#pragma unroll
      for (int q = 0; q < BR_PX; ++q) {
        mx[0][q] = __fmul_rn(fx[q], cx.x);
        mx[1][q] = __fmul_rn(fx[q], cx.y);
        mx[2][q] = __fmul_rn(fx[q], cx.z);
        mx[3][q] = __fmul_rn(fx[q], cx.w);
        my[0][q] = __fmul_rn(fy[q], cy.x);
        my[1][q] = __fmul_rn(fy[q], cy.y);
        my[2][q] = __fmul_rn(fy[q], cy.z);
        my[3][q] = __fmul_rn(fy[q], cy.w);
      }
#pragma unroll
      for (int i = 0; i < BR_PX; ++i)
#pragma unroll
        for (int q = 0; q < BR_PX; ++q) {
          const float b0 = __fadd_rn(__fadd_rn(mx[0][q], my[0][i]), cc.x);
          const float b1 = __fadd_rn(__fadd_rn(mx[1][q], my[1][i]), cc.y);
          const float b2 = __fadd_rn(__fadd_rn(mx[2][q], my[2][i]), cc.z);
          const float iz = __fadd_rn(__fadd_rn(mx[3][q], my[3][i]), cc.w);
          if ((b0 >= 0.f) & (b1 >= 0.f) & (b2 >= 0.f) & (iz >= best_iz[i][q])) {
            best_iz[i][q] = iz;
            best[i][q] = id;
          }
        }
    }
    __syncthreads();  // buffer b is free for block b + 2
  }
#pragma unroll
  for (int i = 0; i < BR_PX; ++i)
#pragma unroll
    for (int q = 0; q < BR_PX; ++q) {
      const int px = x0 + BR_TX * q, py = y0 + BR_TX * i;
      if (best[i][q] >= 0 && px < W && py < H)
        atomicMax(key + (size_t)py * W + px,
                  (unsigned long long)__float_as_uint(best_iz[i][q]) << 32 | (unsigned)best[i][q]);
    }
}

__global__ void zbuffer_brute_ids(const unsigned long long* __restrict__ key, int* __restrict__ face_id,
                                  int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const unsigned long long k = key[i];
    face_id[i] = k ? (int)(unsigned)k : -1;
  }
}

}  // namespace

// #15's grid for an (H, W) image of F faces: the 32 x 32 tiles times the K
// face slices, K `split` if it is > 0, else the most that keeps the grid
// within BR_CTAS (two full waves: a third wave's few CTAs would leave most
// SMs idle), at most F / BR_FBLOCK and at least 1; 0 for a negative split
// (ops/raster_zbuffer.py's brute_plan is the twin)
extern "C" int zbuffer_brute_ctas(int H, int W, int F, int split) {
  const int n_tiles = ((W + BR_TILE - 1) / BR_TILE) * ((H + BR_TILE - 1) / BR_TILE);
  if (split != 0) return split > 0 ? n_tiles * split : 0;
  int k = n_tiles > 0 ? BR_CTAS / n_tiles : 1;
  if (k > F / BR_FBLOCK) k = F / BR_FBLOCK;
  return n_tiles * (k > 1 ? k : 1);
}

// #15: zero key ((H * W,) 8-byte aligned scratch), launch the (tile, slice)
// CTAs, then the ids from the keys; split as zbuffer_brute_ctas takes it
// (0: the entry's choice; > 0: a seam for the tests of the merge).
extern "C" int zbuffer_brute(const float* coef, const unsigned char* valid, void* key, int* face_id,
                             int F, int H, int W, int split, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int ctas = zbuffer_brute_ctas(H, W, F, split);
  if (split < 0) return (int)cudaErrorInvalidValue;
  const int n = H * W, n_tx = (W + BR_TILE - 1) / BR_TILE, n_tiles = n_tx * ((H + BR_TILE - 1) / BR_TILE);
  if (n == 0) return 0;
  const int K = ctas / n_tiles;
  int err = (int)cudaMemsetAsync(key, 0, (size_t)n * 8, st);
  if (err) return err;
  unsigned long long* k = (unsigned long long*)key;
  if (((size_t)coef & 15) == 0)
    zbuffer_brute_kernel<true><<<ctas, BR_THREADS, 0, st>>>(coef, valid, k, F, H, W, n_tx, n_tiles, K);
  else
    zbuffer_brute_kernel<false><<<ctas, BR_THREADS, 0, st>>>(coef, valid, k, F, H, W, n_tx, n_tiles, K);
  err = (int)cudaGetLastError();
  if (err) return err;
  zbuffer_brute_ids<<<(n + 255) / 256, 256, 0, st>>>(k, face_id, n);
  return (int)cudaGetLastError();
}

// CTAs a tile (its cluster) for n_tiles tiles: the most of 1, 2, 4 that keeps
// the grid within 2,048 CTAs (4 at 224^2 and 256^2, 2 at 512^2)
static int zbuffer_split(int n_tiles) {
  int k = 4;
  while (k > 1 && n_tiles * k > 2048) k /= 2;
  return k;
}

// B2's grid for an (H, W) image: the CTAs zbuffer_binned launches, tiles
// times the CTAs a tile (split; 0: zbuffer_split's); 0 for a split other
// than 0, 1, 2 or 4
extern "C" int zbuffer_ctas(int H, int W, int split) {
  const int n_tiles = ((W + BIN - 1) / BIN) * ((H + BIN - 1) / BIN);
  if (split == 0) split = zbuffer_split(n_tiles);
  return split == 1 || split == 2 || split == 4 ? n_tiles * split : 0;
}

// B2: the prologue (the faces' pixel ranges into rng, (F,) int2 scratch)
// and the raster kernel over the (ceil(H / 16), ceil(W / 16)) tiles, each a
// cluster of `split` CTAs (0: zbuffer_split's, as the entry calls it; 1, 2
// or 4: a seam for the tests of the cluster's merge); coef 16-byte aligned,
// H and W at most 32,752.
extern "C" int zbuffer_binned(const float* coef, const unsigned char* valid, const float* sx,
                              const float* sy, void* rng, int* face_id, int F, int H, int W,
                              int split, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tx = (W + BIN - 1) / BIN, n_ty = (H + BIN - 1) / BIN;
  const int ctas = zbuffer_ctas(H, W, split);
  if (ctas == 0) return (int)cudaErrorInvalidValue;
  if (F > 0) {
    face_ranges_kernel<<<(F + 255) / 256, 256, 0, st>>>(sx, sy, valid, (int2*)rng, F, n_tx * BIN, n_ty * BIN);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(BT);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas / (n_tx * n_ty);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, zbuffer_binned_kernel, coef, (const int2*)rng, face_id, F, H, W,
                                 n_tx);
}
