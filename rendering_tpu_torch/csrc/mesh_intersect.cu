// Ray-mesh intersection for Hopper (sm_90a): closest hit and any hit,
// with the root filter and the test counters as compile-time variants,
// and the pre-pass that builds their visit tables.
//
// Replaces the Pallas TPU kernel rendering_tpu/ops/pallas_intersect.py
// ::_kernel (its _cull_and_intersect and _intersect_chunk bodies), in
// its two modes: closest hit (anyhit=False, primary rays) and any hit
// (anyhit=True, batched shadow rays); and its fused multi-mesh entry
// intersect_fused (pallas_intersect.py:1154), whose tables concatenate
// every mesh's supers. Over fused tables the walk is the same; the
// fused closest hit remaps the winning chunk-space slot to (mesh sub
// index, global gather column) through idmap in its epilogue, so no
// separate pass over the rays gathers them. Pad cull chunks then sit
// inside the table (each mesh pads to whole supers); their inverted
// boxes fail the explicit lo.x > hi.x test below.
//
// Two more template flags give the kernel's optional modes:
//   ROOT_FILTER (use_root_filter, pallas_intersect.py:328-354): a hit
//     is accepted only if the ray also passes the reference's literal
//     slab test (AccelerationStructure::intersectBox, sign swap and
//     pairwise running comparisons) against the triangle's BVH reach
//     box, table rows 9-14. That replicates the reference's clipping of
//     a rotated mesh by its root box. The rows are staged with rows 0-8,
//     and the slab runs only for pairs Moller-Trumbore already accepted
//     below the running t (it can only reject), with its own operation
//     order: fminf/fmaxf or an interval form would reject the NaN corner
//     (rd_c == 0 with the origin on a box plane, 0 * inf) that the
//     reference's negated comparisons accept.
//   STATS (collect_stats, pallas_intersect.py:177-181, :260-261,
//     :272-275): [tri_tests, box_tests] with the Pallas kernel's
//     semantics. box_tests grows by n_sub * 512 for every live (tile,
//     super) step; tri_tests by tc times the number of rays whose
//     per-ray sub-chunk cull is live, for every sub-chunk, with the
//     running t at that moment. The reductions that find a tile's live
//     sub-chunks count those rays too; one thread sums in 64 bits and
//     each CTA adds once atomically, so the totals are exact and the
//     same on every run.
// Variants not asked for compile out, so a walk without them keeps its
// code.
//
// Two walks, one a query kind, both over the visit tables of the
// pre-pass below. The closest walk (closest_walk_kernel) runs every
// closest hit: K1, K3/K4's closest variants and K5's fused closest hit.
// The any-hit walk (anyhit_walk_kernel) runs every any hit: K2, K3/K4's
// any-hit variants, K5's fused any hit and K6's phases. Each walks a
// 512-ray tile's live super-chunk list (torder/counts) in order, which is
// the TPU grid's per-tile visit order. For each super it tests every
// unresolved ray against the super's n_sub cull boxes, skips a sub-chunk
// no ray of the tile needs, and stages a live sub-chunk in shared memory
// 64 triangles at a time (rows v0/e1/e2, and the reach rows for the root
// filter), against which each ray runs Moller-Trumbore.
//
// Results equal the TPU kernel's. The accept test is the strict
// t < t_best applied row by row, which picks the same winner as the
// TPU's per-chunk min plus lowest-row tie rule; every ray of the tile
// evaluates a live sub-chunk, as on the TPU, so a ray whose own cull
// failed still sees the same triangles. The f32 operation order is that
// of _intersect_chunk and the library is built with -fmad=false and
// IEEE division, so no product is contracted into an FMA. Min/max keep
// NaN (jnp.minimum/maximum semantics): a NaN slab keeps a chunk live.
// Tiles are independent, so no schedule changes a bit: ids, t and the
// counters equal the plain version's (ops/cuda_intersect.py
// intersect_plain).
//
// What bounds them on an H100: operations. Each ray-triangle pair costs
// 57 f32 instructions (pair_test): cross products p and q, 2 x (6 mul +
// 3 sub); det, 3 mul + 2 add; tv, 3 sub; u, v and t, 3 x (4 mul + 2
// add); u + v, 1 add; 7 compares; 1 select; and the IEEE reciprocal
// 1/det, MUFU.RCP plus 3 refinement instructions. The root filter's slab
// adds 29 per accepted pair: per axis 1 compare, 2 selects, 2 sub and 2
// mul; then 4 compares and 2 compare-selects. Under -fmad=false none of
// them fuses, so an H100 SXM issues them at one per lane per clock: 132
// SMs x 128 lanes x 1.98 GHz = 33.5e12/s, half its FMA-counted 67
// TFLOP/s. The tables are 16 MB at 250k triangles and the rays a few MB.
//
// What the walks do about it. A launch of one CTA a tile, in tile order,
// took as long as its heaviest tile on every query measured: one tile on
// one CTA, sharing its SM, set the time (PERF.md section 6, K1-K6).
//
// The any-hit walk evaluates the pairs of that formulation and changes
// how they land on lanes, SMs and time:
//  (i) Packing. At a tile's start and at each super boundary where a ray
//      resolved since, the unresolved rays (t >= 0, or NaN) move through
//      shared memory, 11 words each, into the lowest threads; the others
//      write their result and drop. A warp without an unresolved ray
//      skips the Moller-Trumbore loop, so the lane-slots issued are
//      packed_pairs, not warp_pairs (intersect_plain's stats).
//  (ii) A persistent grid, one CTA per SM (ops/cuda_intersect.py
//      WALK_CTAS_PER_SM), taking tiles from a global counter in the
//      schedule `order`, heaviest first (most live supers). The
//      heaviest tiles start at once and each has its SM to itself.
//  (iii) Staging overlapped with compute. A super's cull is evaluated
//      once per ray: an unresolved ray's running t is its t0 until it
//      resolves, so its live test of cull box j at any moment of the
//      super is bit j of a mask taken at the super's start. The tile-live
//      sub-chunks are the OR of the unresolved rays' masks (warp
//      reductions, one barrier), redone after each live sub-chunk, which
//      keeps the walk's order: a sub-chunk is evaluated iff some ray
//      unresolved at that moment needs it, as in the TPU formulation.
//      The rows of the next live sub-chunk (or next piece) are copied
//      with cp.async into a second buffer while the current one
//      computes, and the next super's boxes while its predecessor runs.
// It takes 2 barriers per live sub-chunk (tc = 64), none per dead one, 1
// per further piece of a sub-chunk, 2 per super and 2 per tile. The
// counters keep their semantics (box_tests n_live x n_sub x 512 per
// tile, tri_tests tc x the live rays at each sub-chunk's start), summed
// per CTA in 64 bits and added atomically.
//
// The closest walk splits the tile and keeps the evaluated set:
//  (i) Heavy tiles split over a thread block cluster of G CTAs of 512
//      threads (ops/cuda_intersect.py CLOSEST_CLUSTER): rank c holds rays
//      [c 512/G, (c+1) 512/G), each ray on G threads that split every
//      piece's triangles and meet after it (lowest t, then lowest row:
//      the row-order walk's winner, as the winner is the least t among
//      the accepted rows whatever their order). One ray a thread left a
//      split tile's CTAs 512/G threads: the cluster's CTAs ran on G SMs,
//      but at G = 4 the heaviest tile of the bouncing frame's bounce 2
//      still took 4.9 ms, latency-bound on a few warps an SM. Splitting
//      every tile cost the flagship's even tiles more in per-super
//      latency than it gained, so only a tile whose live-super count is
//      at least SPLIT_FACTOR times the query's mean is split (the
//      pre-pass's `n_split`, heaviest first); the rest run whole, one
//      CTA a tile, one ray a thread, G of them to a cluster, heaviest
//      tile first (`order`). The ranks of a split tile agree on its
//      tile-live sub-chunks through distributed shared memory: each sums
//      its rays' live masks (and, counting, its live rays per sub-chunk)
//      into a slot of its own, and after a cluster barrier every thread
//      ORs the G slots (a whole tile does the same within its CTA). A
//      ray's running t only falls, so a sub-chunk dead at the super's
//      start stays dead: the exchange runs once at the
//      super's start and again only after an evaluated sub-chunk that
//      leaves candidates, and a sub-chunk runs iff some ray of the tile
//      needs it at that moment, as in the TPU formulation. The per-pair
//      arithmetic does not change, so every ray meets the same triangles.
//  (ii) The super's cull once per ray: each cull box's ctmin and the
//      boxes the ray's slab meets are kept per thread (ptxas holds part
//      of them in local memory under the 64-register cap), and the test
//      with the running t is a compare per box.
//  (iii) Staging overlapped with compute: the next candidate sub-chunk's
//      rows and the next super's boxes are copied with cp.async into a
//      second buffer while the current rows compute; the exchange's
//      barrier publishes them, so a prefetch that stays live costs no
//      barrier of its own.
//  (iv) Rows read four triangles at a time, one 16-byte shared load per
//      row (9 per 4 pairs instead of 36).
// Lanes are not packed: on every query measured (primary rays, the
// bouncing frame's bounces 0 and 2) warp_pairs equalled union_pairs.
// box_tests (n_live x n_sub x 512) and tri_tests (tc x the tile's live
// rays at each evaluated sub-chunk's start) are summed by the tile's first
// thread.
//
// The pre-pass (prepass_kernel, entry rt_prepass) builds every walk's
// visit tables: per 512-ray tile, the supers some unresolved ray's exact
// slab test finds live, nearest first. It replaces the JAX package's XLA
// pre-pass rendering_tpu/ops/pallas_intersect.py::_tile_tables (no Pallas
// kernel; plain PyTorch before, ops/cuda_intersect.py tile_tables, which
// wrote every (tile, ray, super) intermediate to device memory and read
// the device twice a chunk). Its inputs and outputs are small (a tile's
// rays, the super boxes, one id per super and a count), so operations
// bound it: 26 f32 instructions a slab test (cull_live: per axis 2 sub,
// 2 mul, a min and a max, then the running bounds and the dead test's
// compares, as the other slab bounds count them) over tiles x 512 x Cs
// tests, at one per lane per clock (33.5e12/s on an H100 SXM). The design
// keeps every intermediate on chip: a CTA a tile, its unresolved rays
// packed in shared memory, threads owning supers and stopping at the
// first live ray, then a bitonic sort of (key, id) as one u64 in shared
// memory. The sort key (the super's squared distance from the tile's
// live-ray centroid) comes in from PyTorch, whose reductions set its
// bits. torder and counts equal tile_tables' bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRayTile = 512;   // rays per CTA (the TPU ray tile)
constexpr int kWarps = kRayTile / 32;
constexpr int kPiece = 64;      // triangles staged in shared memory at once
constexpr int kMaxSub = 16;     // cull chunks per super, at most
constexpr int kCullRegs = 8;    // ... in the closest walk, which keeps each one's ctmin per ray
constexpr float kFmax = 3.4028234663852886e38f;

// jnp.minimum / jnp.maximum: NaN in, NaN out (fminf/fmaxf drop a NaN).
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// The reference's slab test of one ray against a reach box, literally
// (pallas_intersect.py:338-354): the sign swap by inv < 0, (lo - o) *
// inv, the negated pairwise comparisons, then the select updates.
__device__ __forceinline__ bool reach_hit(const float lo[3], const float hi[3],
                                          const float o[3], const float iv[3]) {
  float tn[3], tf[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const bool neg = iv[c] < 0.0f;
    const float l = neg ? hi[c] : lo[c];
    const float h = neg ? lo[c] : hi[c];
    tn[c] = (l - o[c]) * iv[c];
    tf[c] = (h - o[c]) * iv[c];
  }
  float tmin = tn[0], tmax = tf[0];
  bool hit = !((tmin > tf[1]) || (tn[1] > tmax));
  tmin = (tn[1] > tmin) ? tn[1] : tmin;
  tmax = (tf[1] < tmax) ? tf[1] : tmax;
  return hit && !((tmin > tf[2]) || (tn[2] > tmax));
}

// The cull box's slab interval, comparisons negated so NaN stays live:
// is the box live for a ray whose running t is t_best? Pad chunks hold
// inverted boxes (lo.x > hi.x holds only for them) and are never live.
__device__ __forceinline__ bool cull_live(const float* box, const float o[3],
                                          const float iv[3], float t_best) {
  float ctmin = -kFmax, ctmax = kFmax;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float t1 = (box[c] - o[c]) * iv[c];
    const float t2 = (box[3 + c] - o[c]) * iv[c];
    ctmin = nan_max(ctmin, nan_min(t1, t2));
    ctmax = nan_min(ctmax, nan_max(t1, t2));
  }
  const bool invalid = box[0] > box[3];
  return !((ctmin > ctmax) || (ctmax < 0.0f) || invalid) &&
         !((ctmin >= t_best) || (t_best < 0.0f));
}

// Moller-Trumbore of one ray against one triangle's rows r = v0 e1 e2 in
// _intersect_chunk's f32 order, accepted strictly below t_best; the hit's
// t goes to t_hit.
__device__ __forceinline__ bool mt_accept(const float r[9], const float o[3],
                                          const float d[3], float t_best,
                                          int backface, float& t_hit) {
  const float v00 = r[0], v01 = r[1], v02 = r[2];
  const float e10 = r[3], e11 = r[4], e12 = r[5];
  const float e20 = r[6], e21 = r[7], e22 = r[8];
  const float p0v = d[1] * e22 - d[2] * e21;
  const float p1v = d[2] * e20 - d[0] * e22;
  const float p2v = d[0] * e21 - d[1] * e20;
  const float det = (e10 * p0v + e11 * p1v) + e12 * p2v;
  bool ok = backface ? (det >= 1e-8f) : (fabsf(det) >= 1e-8f);
  const float inv = 1.0f / (ok ? det : 1.0f);
  const float tv0 = o[0] - v00, tv1 = o[1] - v01, tv2 = o[2] - v02;
  const float u = ((tv0 * p0v + tv1 * p1v) + tv2 * p2v) * inv;
  const float q0 = tv1 * e12 - tv2 * e11;
  const float q1 = tv2 * e10 - tv0 * e12;
  const float q2 = tv0 * e11 - tv1 * e10;
  const float v = ((d[0] * q0 + d[1] * q1) + d[2] * q2) * inv;
  const float t = ((e20 * q0 + e21 * q1) + e22 * q2) * inv;
  t_hit = t;
  return ok && (u >= 0.0f) && (u <= 1.0f) && (v >= 0.0f) &&
         (u + v <= 1.0f) && (t >= 0.0f) && (t < t_best);
}

// The root filter's slab for staged triangle q of a (kRows, kPiece)
// block, whose rows 9-14 hold its reach box.
template <int kRows>
__device__ __forceinline__ bool reach_staged(const float (*s)[kPiece], int q,
                                             const float o[3], const float iv[3]) {
  const float lo[3] = {s[kRows - 6][q], s[kRows - 5][q], s[kRows - 4][q]};
  const float hi[3] = {s[kRows - 3][q], s[kRows - 2][q], s[kRows - 1][q]};
  return reach_hit(lo, hi, o, iv);
}

// One ray against staged triangle q (rows v0 e1 e2 [reach_lo reach_hi]
// of a (kRows, kPiece) block): mt_accept, then the root filter's slab
// for a pair it accepted.
template <int kRows, bool ROOT_FILTER>
__device__ __forceinline__ bool pair_test(const float (*s)[kPiece], int q,
                                          const float o[3], const float d[3],
                                          const float iv[3], float t_best,
                                          int backface, float& t_hit) {
  float r[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) r[i] = s[i][q];
  bool ok = mt_accept(r, o, d, t_best, backface, t_hit);
  if (ROOT_FILTER && ok) ok = reach_staged<kRows>(s, q, o, iv);
  return ok;
}

// Asynchronous global -> shared copies (cp.async, Ampere and later):
// each thread's copies complete at its own wait, so a buffer is read
// only after every thread has waited and a barrier has passed.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Thread block clusters (sm_90): the CTA's rank in its cluster and the
// cluster's index, a 32-bit load from the shared memory of the cluster's
// CTA `rank` at the address of this CTA's variable `p` (distributed
// shared memory), and the cluster-wide barrier, split into its arrive
// (release: this thread's earlier writes, shared ones included, are
// visible to every thread of the cluster after the wait) and its wait.
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_index() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned peer_load(const void* p, unsigned rank) {
  const unsigned local = (unsigned)__cvta_generic_to_shared(p);
  unsigned remote, v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(remote) : "memory");
  return v;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

struct Args {
  const float* tri;      // (Cs, 16, n_sub*tc)
  const float* cbox;     // (Cs*n_sub, 8)
  const float* aux;      // (10, rp)
  const int* torder;     // (n_tiles, Cs)
  const int* counts;     // (n_tiles,)
  const int* idmap;      // (2, n_pad), FUSED only
  const int* order;      // (n_tiles,) tile schedule, heaviest first
  const int* n_split;    // (1,) the closest walk's heavy tiles: order's first
  int* work;             // (1,) next schedule slot, zeroed, the any-hit walk
  float* t_out;          // (rp,)
  int* tri_out;          // (rp,) tri, or mid if FUSED
  int* vid_out;          // (rp,), FUSED only
  unsigned long long* counters;  // (2,) [tri_tests, box_tests], STATS only
  int n_tiles, rp, cs, n_sub, tc, n_pad, backface;
  int cluster;           // CTAs per tile, the closest walk only
};

// ---- the any-hit walk --------------------------------------------------

template <bool ROOT_FILTER, bool STATS>
__global__ void __launch_bounds__(kRayTile) anyhit_walk_kernel(const Args a) {
  constexpr int kRows = ROOT_FILTER ? 15 : 9;
  __shared__ float s_ray[10][kRayTile];   // the packing exchange
  __shared__ int s_lane[kRayTile];
  __shared__ __align__(16) float s_tri[2][kRows][kPiece];
  __shared__ __align__(16) float s_box[2][kMaxSub][8];
  __shared__ unsigned s_wmask[kWarps];
  __shared__ int s_wcount[kWarps];
  __shared__ int s_wlive[STATS ? kWarps : 1][kMaxSub];
  __shared__ int s_next[2];

  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const int rp = a.rp, n_sub = a.n_sub, tc = a.tc;
  const int n_pc = tc / kPiece;
  const long row_stride = (long)n_sub * tc;
  long long tri_tests = 0, box_tests = 0;  // STATS: thread 0's sums

  // The rows of piece p of sub-chunk j of super sup into s_tri[b]: kRows
  // x 64 floats as 16-byte copies, element e always by the same thread.
  auto stage_rows = [&](int sup, int j, int p, int b) {
    if (tid < kRows * (kPiece / 4)) {
      const int row = tid / (kPiece / 4), c = (tid % (kPiece / 4)) * 4;
      cp_async16(&s_tri[b][row][c], a.tri + (long)sup * 16 * row_stride +
                                        row * row_stride + (long)j * tc +
                                        p * kPiece + c);
    }
    cp_async_commit();
  };
  auto stage_boxes = [&](int sup, int b) {
    if (tid < n_sub * 8) {
      cp_async4(&s_box[b][tid >> 3][tid & 7], a.cbox + (long)sup * n_sub * 8 + tid);
    }
    cp_async_commit();
  };

  for (int it = 0;; ++it) {
    if (tid == 0) s_next[it & 1] = atomicAdd(a.work, 1);
    __syncthreads();
    const int slot = s_next[it & 1];
    if (slot >= a.n_tiles) break;
    const int tile = a.order[slot];
    const long r0 = (long)tile * kRayTile;
    const int n_live = a.counts[tile];
    const int* torder = a.torder + (long)tile * a.cs;

    // Every thread starts with its own lane's ray.
    float o[3], d[3], iv[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o[c] = a.aux[(long)c * rp + r0 + tid];
      d[c] = a.aux[(long)(3 + c) * rp + r0 + tid];
      iv[c] = a.aux[(long)(6 + c) * rp + r0 + tid];
    }
    float t_best = a.aux[9L * rp + r0 + tid];
    int tri_best = -1, lane = tid;
    bool has = true;       // this thread holds a ray
    int n_act = kRayTile;  // rays held by the CTA (threads 0..n_act-1)
    unsigned m = 0;        // the held ray's live sub-chunks of this super

    if (n_live > 0) {
      stage_boxes(torder[0], 0);
      const unsigned bal = __ballot_sync(~0u, !(t_best < 0.0f));
      if (wl == 0) s_wcount[warp] = __popc(bal);
      __syncthreads();
    }
    for (int k = 0; k < n_live; ++k) {
      // Pack: when a held ray has resolved since the last pack (s_wcount
      // holds every warp's unresolved count from the last barrier), the
      // unresolved ones move into the lowest threads and the resolved
      // ones write their result and drop.
      int n_now = 0, off = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int c = s_wcount[w];
        n_now += c;
        off += w < warp ? c : 0;
      }
      const bool repack = n_now != n_act;
      if (repack) {
        const bool keep = has && !(t_best < 0.0f);
        if (has && !keep) {
          a.t_out[r0 + lane] = t_best;
          a.tri_out[r0 + lane] = tri_best;
        }
        const unsigned bal = __ballot_sync(~0u, keep);
        if (keep) {
          const int dst = off + __popc(bal & ((1u << wl) - 1u));
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            s_ray[c][dst] = o[c];
            s_ray[3 + c][dst] = d[c];
            s_ray[6 + c][dst] = iv[c];
          }
          s_ray[9][dst] = t_best;
          s_lane[dst] = lane;
        }
      }
      cp_async_wait_all();
      __syncthreads();  // this super's boxes and the packed rays are visible
      if (repack) {
        n_act = n_now;
        has = tid < n_act;
        if (has) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            o[c] = s_ray[c][tid];
            d[c] = s_ray[3 + c][tid];
            iv[c] = s_ray[6 + c][tid];
          }
          t_best = s_ray[9][tid];
          lane = s_lane[tid];
          tri_best = -1;
        } else {
          t_best = -1.0f;
        }
      }
      if (k + 1 < n_live) stage_boxes(torder[k + 1], (k + 1) & 1);
      const int sup = torder[k];

      // The super's cull, once per ray: an unresolved ray's running t is
      // its t0 until it resolves, so bit j of m is its live test of cull
      // box j at every moment of the super while it stays unresolved.
      m = 0;
      if (has && !(t_best < 0.0f)) {
        for (int j = 0; j < n_sub; ++j) {
          m |= (unsigned)cull_live(s_box[k & 1][j], o, iv, t_best) << j;
        }
      }
      // Tile-live sub-chunks: the OR over the unresolved rays' masks, by
      // warp reductions and one barrier; the same barrier publishes the
      // per-warp unresolved counts (and, counting, the live rays per
      // sub-chunk).
      auto reduce = [&]() -> unsigned {
        const bool unres = has && !(t_best < 0.0f);
        const unsigned mm = unres ? m : 0u;
        const unsigned wm = __reduce_or_sync(~0u, mm);
        const unsigned cnt = __popc(__ballot_sync(~0u, unres));
        if (STATS) {
          for (int j = 0; j < n_sub; ++j) {
            const unsigned c = __popc(__ballot_sync(~0u, (mm >> j) & 1u));
            if (wl == 0) s_wlive[warp][j] = (int)c;
          }
        }
        if (wl == 0) {
          s_wmask[warp] = wm;
          s_wcount[warp] = (int)cnt;
        }
        __syncthreads();
        unsigned tm = 0;
        for (int w = 0; w < kWarps; ++w) tm |= s_wmask[w];
        return tm;
      };
      unsigned tmask = reduce();
      int j = tmask ? __ffs(tmask) - 1 : -1, p = 0, buf = 0;
      if (j >= 0) stage_rows(sup, j, 0, buf);
      while (j >= 0) {
        if (STATS && p == 0 && tid == 0) {
          int n = 0;
          for (int w = 0; w < kWarps; ++w) n += s_wlive[w][j];
          tri_tests += (long long)n * tc;
        }
        cp_async_wait_all();
        __syncthreads();  // rows of (j, p) visible; every thread is done with buf ^ 1
        // Prefetch the next unit while this one computes: the next piece,
        // or the first piece of the next sub-chunk live so far (it may
        // turn dead by the time it is reached).
        int nj = j, np = p + 1;
        if (np == n_pc) {
          const unsigned rest = tmask & ~((2u << j) - 1u);
          nj = rest ? __ffs(rest) - 1 : -1;
          np = 0;
        }
        if (nj >= 0) stage_rows(sup, nj, np, buf ^ 1);
        // A resolved ray (t_best < 0) can accept nothing; a warp whose
        // rays are all resolved or absent skips the loop as a whole.
        if (has && t_best >= 0.0f) {
          for (int q = 0; q < kPiece; ++q) {
            float t;
            if (pair_test<kRows, ROOT_FILTER>(s_tri[buf], q, o, d, iv, t_best,
                                              a.backface, t)) {
              t_best = -1.0f;  // done marker: culls every later chunk
              tri_best = 0;
              break;
            }
          }
        }
        if (np > 0) {  // the next piece of the same sub-chunk
          p = np;
          buf ^= 1;
          continue;
        }
        tmask = reduce() & ~((2u << j) - 1u);
        const int next = tmask ? __ffs(tmask) - 1 : -1;
        if (next >= 0 && next != nj) {
          // The prefetched sub-chunk turned dead: load the live one into
          // the same buffer, after this thread's earlier copy there landed.
          cp_async_wait_all();
          stage_rows(sup, next, 0, buf ^ 1);
        }
        j = next;
        p = 0;
        buf ^= 1;
      }
    }
    if (has) {
      a.t_out[r0 + lane] = t_best;
      a.tri_out[r0 + lane] = tri_best;
    }
    if (STATS && tid == 0) box_tests += (long long)n_live * n_sub * kRayTile;
  }
  cp_async_wait_all();
  if (STATS && tid == 0) {
    atomicAdd(&a.counters[0], (unsigned long long)tri_tests);
    atomicAdd(&a.counters[1], (unsigned long long)box_tests);
  }
}

// ---- the closest walk ----------------------------------------------------

// Clusters of G = a.cluster CTAs (1, 2, 4 or 8; G = 1 is a plain launch)
// of 512 threads. A heavy tile (the first n_split of order) takes a
// cluster: rank c holds rays [c 512/G, (c+1) 512/G) of the tile, each ray
// on G neighbouring threads that split every piece's triangles by groups
// of four (thread k takes groups k, k + G, ...) and meet after the piece:
// the lowest t, on a tie the lowest row, which is the row-order walk's
// winner. Every other tile runs whole on one CTA, one ray a thread (g =
// 1), G of them to a cluster. Every decision that shapes a tile's walk
// (the super, the sub-chunk, the piece) is taken by all the threads that
// share it, so they take the same steps and barriers.
template <bool FUSED, bool ROOT_FILTER, bool STATS>
__global__ void __launch_bounds__(kRayTile, 2) closest_walk_kernel(const Args a) {
  constexpr int kRows = ROOT_FILTER ? 15 : 9;
  __shared__ __align__(16) float s_tri[2][kRows][kPiece];
  __shared__ __align__(16) float s_box[2][kMaxSub][8];
  // The exchange slots, by exchange number mod 3: this CTA's OR of its
  // rays' live masks, and with STATS its live rays per sub-chunk.
  __shared__ unsigned s_xmask[3];
  __shared__ int s_xcount[STATS ? 3 : 1][kMaxSub];

  // Cluster c < n_split takes heavy tile order[c] and splits it (g = G);
  // after them, each CTA of a cluster takes a tile of its own (g = 1),
  // and CTAs past the last tile leave at once.
  const int G = a.cluster;
  const int tid = threadIdx.x, wl = tid & 31;
  const unsigned rank = G > 1 ? cluster_rank() : 0u;
  const int c_idx = G > 1 ? (int)cluster_index() : (int)blockIdx.x;
  const int n_split = G > 1 ? *a.n_split : 0;
  const int g = c_idx < n_split ? G : 1;
  const long slot = g > 1 ? c_idx : n_split + (long)(c_idx - n_split) * G + rank;
  if (slot >= a.n_tiles) return;
  const int tile = a.order[slot];
  const int rp = a.rp, n_sub = a.n_sub, tc = a.tc;
  const int n_pc = tc / kPiece;
  const long row_stride = (long)n_sub * tc;
  long long tri_tests = 0;  // STATS: the lead thread's sum
  if (tid == 0) {
    for (int x = 0; x < 3; ++x) {
      s_xmask[x] = 0;
      if (STATS) {
        for (int j = 0; j < kMaxSub; ++j) s_xcount[x][j] = 0;
      }
    }
  }

  // The rows of piece p of sub-chunk j of super sup into s_tri[b] as
  // 16-byte copies, element e always by the same thread; a super's boxes
  // into s_box[b] likewise.
  auto stage_rows = [&](int sup, int j, int p, int b) {
    const float* base = a.tri + (long)sup * 16 * row_stride + (long)j * tc + p * kPiece;
    for (int e = tid; e < kRows * (kPiece / 4); e += kRayTile) {
      const int row = e / (kPiece / 4), c = (e % (kPiece / 4)) * 4;
      cp_async16(&s_tri[b][row][c], base + row * row_stride + c);
    }
    cp_async_commit();
  };
  auto stage_boxes = [&](int sup, int b) {
    if (tid < n_sub * 2) {
      cp_async16(&s_box[b][tid >> 1][(tid & 1) * 4],
                 a.cbox + ((long)sup * n_sub) * 8 + tid * 4);
    }
    cp_async_commit();
  };

  int xe = 0;  // exchanges so far (slot xe % 3)
  int b = 0;   // the buffer of the next unit of rows
  const int sub = tid % g;  // this thread's share of the ray's triangles
  const bool lead = (g == 1 || rank == 0) && tid == 0;
  const long r = (long)tile * kRayTile +
                 (g > 1 ? (long)rank * (kRayTile / g) : 0L) + tid / g;
  float o[3], d[3], iv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o[c] = a.aux[(long)c * rp + r];
    d[c] = a.aux[(long)(3 + c) * rp + r];
    iv[c] = a.aux[(long)(6 + c) * rp + r];
  }
  float t_best = a.aux[9L * rp + r];
  int tri_best = -1;
  const int n_live = a.counts[tile];
  const int* torder = a.torder + (long)tile * a.cs;

  // The super's cull, once per ray (f32 values as cull_live's): ctmin
  // of each cull box and the bits of the boxes the ray's slab meets.
  // While the running t only falls (a closest hit's), the ray needs
  // sub-chunk j at a moment iff bit j of m0 is set and !(ctmin_j >= t
  // || t < 0).
  float ctm[kCullRegs];
  unsigned m0 = 0;
  auto live_mask = [&](unsigned cand) -> unsigned {
    unsigned m = 0;
#pragma unroll
    for (int j = 0; j < kCullRegs; ++j) {
      m |= (unsigned)(((cand >> j) & 1u) &&
                      !((ctm[j] >= t_best) || (t_best < 0.0f))) << j;
    }
    return m & m0;
  };

  // The tile-live set of the sub-chunks in `m`'s bits: the OR of every
  // ray's live mask over the tile, by a warp reduction, a shared atomic
  // per warp, one barrier (the cluster's, or the CTA's at g = 1) and a
  // load from each rank's slot; a ray counts once, on its first thread.
  // Each thread waits for its own copies first, so after the barrier
  // every staged row and box is visible. The slot of exchange x is
  // zeroed during exchange x - 1 and read after the barrier of x,
  // before the barrier of x + 1: three slots in turn keep the zeroing,
  // the writes and the peers' reads apart.
  auto exchange = [&](unsigned m) -> unsigned {
    const int sl = xe % 3;
    const unsigned wm = __reduce_or_sync(~0u, m);
    if (STATS) {
      for (int j = 0; j < n_sub; ++j) {
        const int c = __popc(__ballot_sync(~0u, sub == 0 && ((m >> j) & 1u)));
        if (wl == 0 && c) atomicAdd(&s_xcount[sl][j], c);
      }
    }
    if (wl == 0 && wm) atomicOr(&s_xmask[sl], wm);
    if (tid == 0) {
      const int nx = (xe + 1) % 3;
      s_xmask[nx] = 0;
      if (STATS) {
        for (int j = 0; j < n_sub; ++j) s_xcount[nx][j] = 0;
      }
    }
    cp_async_wait_all();
    unsigned tm = 0;
    if (g == 1) {
      __syncthreads();
      tm = s_xmask[sl];
    } else {
      cluster_arrive();
      cluster_wait();
      for (int c = 0; c < g; ++c) tm |= peer_load(&s_xmask[sl], c);
    }
    ++xe;
    return tm;
  };
  // K3's tri_tests for sub-chunk j, evaluated after the last exchange:
  // tc x the rays of the tile live for it then.
  auto count_tests = [&](int j) {
    if (STATS && lead) {
      const int sl = (xe - 1) % 3;
      long long n = 0;
      for (int c = 0; c < g; ++c) {
        n += g == 1 ? s_xcount[sl][j] : (int)peer_load(&s_xcount[sl][j], c);
      }
      tri_tests += n * tc;
    }
  };

  if (n_live > 0) stage_boxes(torder[0], 0);
  for (int k = 0; k < n_live; ++k) {
    cp_async_wait_all();
    __syncthreads();  // this super's boxes visible; every thread done with the rest
    const int sup = torder[k];
    m0 = 0;
#pragma unroll
    for (int j = 0; j < kCullRegs; ++j) {
      ctm[j] = 0.0f;
      if (j < n_sub) {
        const float* box = s_box[k & 1][j];
        float ctmin = -kFmax, ctmax = kFmax;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float t1 = (box[c] - o[c]) * iv[c];
          const float t2 = (box[3 + c] - o[c]) * iv[c];
          ctmin = nan_max(ctmin, nan_min(t1, t2));
          ctmax = nan_min(ctmax, nan_max(t1, t2));
        }
        const bool invalid = box[0] > box[3];
        ctm[j] = ctmin;
        m0 |= (unsigned)!((ctmin > ctmax) || (ctmax < 0.0f) || invalid) << j;
      }
    }
    unsigned tm = exchange(live_mask(~0u));
    if (k + 1 < n_live) stage_boxes(torder[k + 1], (k + 1) & 1);
    int j = tm ? __ffs(tm) - 1 : -1;
    if (j < 0) continue;
    count_tests(j);
    stage_rows(sup, j, 0, b);
    bool fresh = true;  // the rows of the unit need a wait and a barrier
    int p = 0;
    for (;;) {
      if (fresh) {
        cp_async_wait_all();
        __syncthreads();  // the unit's rows visible; every thread done with b ^ 1
      }
      // Prefetch the next unit while this one computes: the next piece,
      // or the first piece of the next sub-chunk live so far (it may
      // turn dead by the time it is reached).
      int nj = j, np = p + 1;
      if (np == n_pc) {
        const unsigned rest = tm & ~((2u << j) - 1u);
        nj = rest ? __ffs(rest) - 1 : -1;
        np = 0;
      }
      if (nj >= 0) stage_rows(sup, nj, np, b ^ 1);
      // A resolved ray (t_best < 0) or a NaN one accepts nothing. Rows
      // are read four triangles at a time (16-byte shared loads; the g
      // threads of a ray read neighbouring groups, in distinct banks);
      // the accept test goes in row order within the thread's share.
      const int base = (sup * n_sub + j) * tc + p * kPiece;
      if (t_best >= 0.0f) {
        const float (*s)[kPiece] = s_tri[b];
        for (int q = 4 * sub; q < kPiece; q += 4 * g) {
          float rows[9][4];
#pragma unroll
          for (int i = 0; i < 9; ++i) {
            const float4 x = *reinterpret_cast<const float4*>(&s[i][q]);
            rows[i][0] = x.x;
            rows[i][1] = x.y;
            rows[i][2] = x.z;
            rows[i][3] = x.w;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float tri[9] = {rows[0][u], rows[1][u], rows[2][u],
                                  rows[3][u], rows[4][u], rows[5][u],
                                  rows[6][u], rows[7][u], rows[8][u]};
            float t;
            bool ok = mt_accept(tri, o, d, t_best, a.backface, t);
            if (ROOT_FILTER && ok) ok = reach_staged<kRows>(s, q + u, o, iv);
            if (ok) {
              t_best = t;
              tri_best = base + q + u;
            }
          }
        }
      }
      // The ray's g threads meet: the lowest t, on a tie the lowest row.
      // A thread that accepted nothing holds the piece's starting t and
      // id, which every accepted hit beats strictly.
      for (int off = 1; off < g; off <<= 1) {
        const float t_o = __shfl_xor_sync(~0u, t_best, off);
        const int id_o = __shfl_xor_sync(~0u, tri_best, off);
        if (t_o < t_best || (t_o == t_best && id_o < tri_best)) {
          t_best = t_o;
          tri_best = id_o;
        }
      }
      b ^= 1;
      if (np > 0) {  // the next piece of the same sub-chunk
        p = np;
        fresh = true;
        continue;
      }
      // Sub-chunk j is done. Liveness only falls, so the candidates are
      // the tile-live ones after j; with none left the super is done.
      const unsigned cand = tm & ~((2u << j) - 1u);
      if (cand == 0) break;
      tm = exchange(live_mask(cand)) & cand;
      const int next = tm ? __ffs(tm) - 1 : -1;
      if (next < 0) break;
      count_tests(next);
      // The exchange's barrier made the prefetched rows visible; if the
      // prefetched sub-chunk turned dead, load the live one there.
      fresh = next != nj;
      if (fresh) stage_rows(sup, next, 0, b);
      j = next;
      p = 0;
    }
  }
  cp_async_wait_all();
  if (sub == 0 && FUSED) {
    const bool found = tri_best >= 0;
    a.t_out[r] = found ? t_best : kFmax;
    a.tri_out[r] = found ? a.idmap[tri_best] : -1;
    a.vid_out[r] = found ? a.idmap[(long)a.n_pad + tri_best] : 0;
  } else if (sub == 0) {
    a.t_out[r] = t_best;
    a.tri_out[r] = tri_best;
  }
  if (STATS && lead) {
    atomicAdd(&a.counters[0], (unsigned long long)tri_tests);
    atomicAdd(&a.counters[1], (unsigned long long)n_live * n_sub * kRayTile);
  }
  // No CTA of a split tile leaves while a peer may still read its slots.
  if (g > 1) {
    cluster_arrive();
    cluster_wait();
  }
}

// ---- the pre-pass: per-tile live supers and their visit order -----------

constexpr int kPrepassMaxSupers = 16384;  // (key, id) pairs: 128 KiB dynamic

struct PrepassArgs {
  const float* aux;      // (10, rp) rows ro xyz, rd xyz, 1/rd xyz, t0
  const float* sbox;     // (cs, 8) super boxes [lo xyz, hi xyz, 0, 0]
  const float* dist2;    // (n_tiles, cs) squared distance of each super's
                         // centre from the tile's live-ray centroid
  int* torder;           // (n_tiles, cs) visit order
  int* counts;           // (n_tiles,) live supers
  int rp, cs, p;         // p: the sort's width, a power of two >= cs
  int group;             // threads a super, a power of two <= 32
};

// (key, id) as one u64 whose unsigned order is torch.argsort(stable=True)'s
// over f32 keys: ascending, -0 equal to +0, every NaN after every number,
// ties by id.
__device__ __forceinline__ unsigned long long sort_key(float key, int id) {
  unsigned u = __float_as_uint(key);
  if (key != key) u = 0x7fffffffu;
  else if (key == 0.0f) u = 0u;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned)id;
}

// One staged ray's liveness against a super box: cull_live with t0 as the
// running t, which is tile_live_exact's per-ray test, operation for
// operation.
__device__ __forceinline__ bool staged_live(const float* box,
                                            const float4 (*s_ray)[2], int i) {
  const float4 a = s_ray[i][0], b = s_ray[i][1];
  const float o[3] = {a.x, a.y, a.z}, iv[3] = {b.x, b.y, b.z};
  return cull_live(box, o, iv, a.w);
}

// One CTA a 512-ray tile. The tile's unresolved rays (t0 >= 0 or NaN)
// are packed into shared memory; `group` threads own each super (more
// than one where Cs is below 256), each testing every group-th packed ray
// until one is live, the group ORed by shuffles. (Threads owning rays,
// the warps looping over the supers with a vote each, took 1.10x as long
// on the flagship's queries: PERF.md.) Then each super's key (dist2 if
// live, else FLT_MAX) and id are sorted as one u64 by a bitonic sort
// over p in shared memory, and the ids written in that order.
__global__ void __launch_bounds__(kRayTile) prepass_kernel(const PrepassArgs a) {
  extern __shared__ unsigned long long s_key[];  // (p,)
  __shared__ float4 s_stage[kRayTile][2];  // packed rays [o, t0], [1/rd, 0]
  __shared__ int s_n, s_live;
  const int tile = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const long r = (long)tile * kRayTile + tid;
  const float o[3] = {a.aux[r], a.aux[a.rp + r], a.aux[2L * a.rp + r]};
  const float iv[3] = {a.aux[6L * a.rp + r], a.aux[7L * a.rp + r],
                       a.aux[8L * a.rp + r]};
  const float t0 = a.aux[9L * a.rp + r];
  const bool held = !(t0 < 0.0f);  // resolved lanes add no liveness
  if (tid == 0) s_n = s_live = 0;
  __syncthreads();
  int mine = 0;  // supers this thread found live
  const unsigned vote = __ballot_sync(~0u, held);
  int base = 0;
  if (lane == 0 && vote) base = atomicAdd(&s_n, __popc(vote));
  base = __shfl_sync(~0u, base, 0);
  if (held) {
    const int slot = base + __popc(vote & ((1u << lane) - 1u));
    s_stage[slot][0] = make_float4(o[0], o[1], o[2], t0);
    s_stage[slot][1] = make_float4(iv[0], iv[1], iv[2], 0.0f);
  }
  __syncthreads();
  const int n = s_n, g = a.group, sub = tid & (g - 1);
  for (int s0 = 0; s0 < a.cs; s0 += kRayTile / g) {
    const int s = s0 + tid / g;
    bool live = false;
    if (s < a.cs) {
      float box[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) box[k] = a.sbox[8L * s + k];
      int i = box[0] > box[3] ? n : sub;  // a pad box is never live
      for (; i + 3 * g < n; i += 4 * g) {
        if (staged_live(box, s_stage, i) | staged_live(box, s_stage, i + g) |
            staged_live(box, s_stage, i + 2 * g) |
            staged_live(box, s_stage, i + 3 * g)) {
          live = true;
          break;
        }
      }
      for (; !live && i < n; i += g) live = staged_live(box, s_stage, i);
    }
    for (int w = 1; w < g; w <<= 1) {
      live = __shfl_xor_sync(~0u, (int)live, w) || live;
    }
    if (s < a.cs && sub == 0) {
      mine += live;
      s_key[s] = sort_key(live ? a.dist2[(long)tile * a.cs + s] : kFmax, s);
    }
  }
  for (int s = a.cs + tid; s < a.p; s += kRayTile) s_key[s] = ~0ull;
  if (mine) atomicAdd(&s_live, mine);
  __syncthreads();
  for (int k = 2; k <= a.p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < (a.p >> 1); i += kRayTile) {
        const int lo = 2 * i - (i & (j - 1)), hi = lo + j;
        const unsigned long long x = s_key[lo], y = s_key[hi];
        if ((x > y) == ((lo & k) == 0)) {
          s_key[lo] = y;
          s_key[hi] = x;
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < a.cs; i += kRayTile) {
    a.torder[(long)tile * a.cs + i] = (int)(unsigned)s_key[i];
  }
  if (tid == 0) a.counts[tile] = s_live;
}

// ---- launchers ------------------------------------------------------------

using WalkFn = void (*)(const Args);

// The any-hit walk's kernel for its flags (the fused any hit has none: an
// any hit over fused tables is the single-mesh walk over their geometry).
int anyhit_variant(int root_filter, int stats) {
  return (root_filter ? 2 : 0) + (stats ? 1 : 0);
}
WalkFn walk_kernel(int root_filter, int stats) {
  const WalkFn fns[4] = {
      anyhit_walk_kernel<false, false>, anyhit_walk_kernel<false, true>,
      anyhit_walk_kernel<true, false>, anyhit_walk_kernel<true, true>};
  return fns[anyhit_variant(root_filter, stats)];
}

// The persistent grid: `per_sm` CTAs on every SM (0: as many as are
// resident at once, the occupancy; cached per device and variant), at
// most one a tile.
int walk_grid(WalkFn fn, int variant, int per_sm, int n_tiles) {
  constexpr int kMaxDevices = 64;
  static int resident[kMaxDevices][4], sms[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev >= kMaxDevices) return -(int)cudaErrorInvalidDevice;
  if (resident[dev][variant] == 0) {
    int n = 0, m = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kRayTile, 0);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&m, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return -(int)err;
    if (n < 1) return -(int)cudaErrorLaunchOutOfResources;
    resident[dev][variant] = n;
    sms[dev] = m;
  }
  const int fit = resident[dev][variant];
  const long n = (long)(per_sm > 0 && per_sm < fit ? per_sm : fit) * sms[dev];
  return n < n_tiles ? (int)n : n_tiles;
}

// The closest walk's kernel for its flags.
int closest_variant(int fused, int root_filter, int stats) {
  return (fused ? 4 : 0) + (root_filter ? 2 : 0) + (stats ? 1 : 0);
}
WalkFn closest_kernel(int fused, int root_filter, int stats) {
  const WalkFn fns[8] = {
      closest_walk_kernel<false, false, false>,
      closest_walk_kernel<false, false, true>,
      closest_walk_kernel<false, true, false>,
      closest_walk_kernel<false, true, true>,
      closest_walk_kernel<true, false, false>,
      closest_walk_kernel<true, false, true>,
      closest_walk_kernel<true, true, false>,
      closest_walk_kernel<true, true, true>};
  return fns[closest_variant(fused, root_filter, stats)];
}

// The launch configuration of the closest walk: n clusters of g CTAs of
// 512 threads (g = 1: no cluster attribute).
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int n, int g, cudaStream_t s) : cfg{}, attr{} {
    cfg.gridDim = dim3((unsigned)(n * g));
    cfg.blockDim = dim3((unsigned)kRayTile);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)g;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = g > 1 ? 1 : 0;
  }
};

// Clusters of `g` CTAs of the closest walk's kernel `fn` resident at once
// on the current card (cudaOccupancyMaxActiveClusters; at g = 1 the CTAs
// per SM times the SMs), or a negative CUDA error.
int resident_clusters(WalkFn fn, int g) {
  int n = 0;
  cudaError_t err;
  if (g > 1) {
    ClusterLaunch l(1, g, nullptr);
    err = cudaOccupancyMaxActiveClusters(&n, (const void*)fn, &l.cfg);
  } else {
    int dev = 0, per_sm = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kRayTile, 0);
    }
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    n = per_sm * sms;
  }
  return err != cudaSuccess ? -(int)err : n;
}

// Launches the closest walk: n_tiles clusters of g CTAs (the ones past
// the last tile leave at once). A cluster that cannot be resident (its
// CTAs must fit one GPC at once) or a refused launch returns the CUDA
// error; nothing falls back.
int launch_closest(const Args& a, int fused, int root_filter, int stats,
                   cudaStream_t s) {
  const int g = a.cluster;
  const WalkFn fn = closest_kernel(fused, root_filter, stats);
  constexpr int kMaxDevices = 64;
  static bool fits[kMaxDevices][8][9];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const int v = closest_variant(fused, root_filter, stats);
  if (!fits[dev][v][g]) {
    const int n = resident_clusters(fn, g);
    if (n < 0) return -n;
    if (n < 1) return (int)cudaErrorLaunchOutOfResources;
    fits[dev][v][g] = true;
  }
  ClusterLaunch l(a.n_tiles, g, s);
  err = cudaLaunchKernelEx(&l.cfg, fn, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int check_shapes(int n_tiles, int rp, int n_sub, int tc) {
  if (n_sub < 1 || n_sub > kMaxSub || tc < kPiece || tc % kPiece != 0 ||
      rp != n_tiles * kRayTile) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

extern "C" {

// One intersection query over prepared rays and chunk tables.
//   anyhit=0, fused=0: closest hit, (t, chunk-space triangle id) of the
//     nearest accepted hit below t0, else (t0, -1).
//   anyhit=1, fused=0: any hit, (-1, 0) when some triangle is hit below
//     t0, else (t0, -1); over fused tables this is K5's any hit. It runs
//     the any-hit walk (anyhit_walk_kernel), which takes the tiles in the
//     schedule `order` (n_tiles,) through the counter `work` (1,) int32,
//     zeroed by the caller; tri must be 16-byte aligned.
//   anyhit=0, fused=1: fused closest hit (K5), (t, mesh sub index,
//     global gather column) through idmap (2, n_pad); (FLT_MAX, -1, 0)
//     on a miss.
// A closest hit runs the closest walk (closest_walk_kernel), which splits
// the first n_split (a (1,) int32 on the card) tiles of `order` over a
// cluster each and runs the others whole.
// root_filter=1 adds the reach-box slab (table rows 9-14); stats=1 adds
// [tri_tests, box_tests] into counters (2,) u64, which the caller zeroes.
// ctas_per_sm sets the any-hit walk's persistent grid (that many CTAs on
// every SM, 0 for as many as fit). cluster is the closest walk's CTAs per
// cluster (1, 2, 4 or 8), which takes n_sub <= 8; its tri and cbox must
// be 16-byte aligned.
int rt_intersect(const void* tri, const void* cbox, const void* aux,
                 const void* torder, const void* counts, const void* idmap,
                 const void* order, const void* n_split, void* work,
                 void* t_out, void* tri_out, void* vid_out, void* counters,
                 int n_tiles, int rp, int cs, int n_sub, int tc, int n_pad,
                 int backface, int anyhit, int fused, int root_filter,
                 int stats, int ctas_per_sm, int cluster, void* stream) {
  if (check_shapes(n_tiles, rp, n_sub, tc) || (anyhit && fused) ||
      (fused && n_pad != cs * n_sub * tc) ||
      (fused && (idmap == nullptr || vid_out == nullptr)) ||
      (stats && counters == nullptr) || order == nullptr ||
      (anyhit && work == nullptr) || (!anyhit && n_split == nullptr) ||
      (reinterpret_cast<size_t>(tri) & 15) != 0 ||
      (!anyhit && ((reinterpret_cast<size_t>(cbox) & 15) != 0 ||
                   n_sub > kCullRegs ||
                   (cluster != 1 && cluster != 2 && cluster != 4 &&
                    cluster != 8)))) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_tiles == 0) return 0;
  Args a{(const float*)tri, (const float*)cbox, (const float*)aux,
         (const int*)torder, (const int*)counts, (const int*)idmap,
         (const int*)order, (const int*)n_split, (int*)work,
         (float*)t_out, (int*)tri_out, (int*)vid_out,
         (unsigned long long*)counters,
         n_tiles, rp, cs, n_sub, tc, n_pad, backface};
  const cudaStream_t s = (cudaStream_t)stream;
  if (anyhit) {
    const WalkFn fn = walk_kernel(root_filter, stats);
    const int grid = walk_grid(fn, anyhit_variant(root_filter, stats),
                               ctas_per_sm, n_tiles);
    if (grid < 0) return -grid;
    fn<<<grid, kRayTile, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  a.cluster = cluster;
  return launch_closest(a, fused, root_filter, stats, s);
}

// Resources of a walk's variant (anyhit=1 the any-hit walk, 0 the closest
// walk): out[0..4] = resident CTAs per SM at 512 threads, registers per
// thread, local (spill) bytes per thread, static shared bytes, SMs;
// out[5] = clusters of `cluster` CTAs of the closest walk resident at
// once on the card (0 for the any-hit walk).
int rt_resources(int anyhit, int fused, int root_filter, int stats,
                 int cluster, int* out) {
  if ((anyhit && fused) || cluster < 1 || cluster > 8) {
    return (int)cudaErrorInvalidValue;
  }
  const WalkFn fn = anyhit ? walk_kernel(root_filter, stats)
                           : closest_kernel(fused, root_filter, stats);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, (const void*)fn);
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn, kRayTile, 0);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&out[4], cudaDevAttrMultiProcessorCount, dev);
  }
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = (int)attr.sharedSizeBytes;
  out[5] = 0;
  if (err == cudaSuccess && !anyhit) {
    const int n = resident_clusters(fn, cluster);
    if (n < 0) return -n;
    out[5] = n;
  }
  return (int)err;
}

// The pre-pass of one query (prepass_kernel): per 512-ray tile of the
// prepared rays aux (10, rp), the live supers of sbox (cs, 8) in visit
// order, torder (n_tiles, cs) int32, and their number, counts (n_tiles,)
// int32, with the sort keys dist2 (n_tiles, cs) f32.
int rt_prepass(const void* aux, const void* sbox, const void* dist2,
               void* torder, void* counts, int n_tiles, int rp, int cs,
               void* stream) {
  if (n_tiles < 0 || cs < 0 || cs > kPrepassMaxSupers ||
      rp != n_tiles * kRayTile) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_tiles == 0) return 0;
  PrepassArgs a{(const float*)aux, (const float*)sbox, (const float*)dist2,
                (int*)torder, (int*)counts, rp, cs, 1, 1};
  while (a.p < cs) a.p <<= 1;
  while (a.group < 32 && 2 * a.group * cs <= kRayTile) a.group <<= 1;
  const size_t bytes = sizeof(unsigned long long) * (size_t)a.p;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)prepass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  prepass_kernel<<<n_tiles, kRayTile, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
