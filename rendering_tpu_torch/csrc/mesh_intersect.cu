// Ray-mesh intersection for Hopper (sm_90a): closest hit and any hit,
// with the root filter and the test counters as compile-time variants.
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
//     running t at that moment. __syncthreads_count gives that number
//     where the plain walk uses __syncthreads_or; thread 0 sums in 64
//     bits and each CTA adds once atomically, so the totals are exact
//     and the same on every run.
// Variants not asked for compile out, so the plain walk keeps its code.
//
// Two walks. The tile walk (mesh_intersect_kernel) runs every closest
// hit, and the any hit as it was before the any-hit walk replaced it
// (entry rt_anyhit_tile_walk, launched only to be timed against the
// any-hit walk). The any-hit walk (anyhit_walk_kernel) runs every any
// hit: K2, K3/K4's any-hit variants, K5's fused any hit and K6's phases.
//
// The tile walk. One CTA per 512-ray tile, one ray per thread, launched
// in tile order. The CTA walks its tile's live super-chunk list
// (torder/counts, from the pre-pass in ops/cuda_intersect.py) in order,
// which is the TPU grid's per-tile visit order. For each super it stages
// the super's n_sub cull boxes in shared memory; each thread slab-tests
// its ray against each cull box with its running t, and a sub-chunk no
// ray of the tile needs is skipped. A live sub-chunk is staged in shared
// memory 64 triangles at a time (rows v0/e1/e2, and the reach rows for
// the root filter) and every thread runs Moller-Trumbore against each
// triangle in ascending row order.
//
// Results equal the TPU kernel's. The accept test is the strict
// t < t_best applied row by row, which picks the same winner as the
// TPU's per-chunk min plus lowest-row tie rule; every ray of the tile
// evaluates a live sub-chunk, as on the TPU, so a ray whose own cull
// failed still sees the same triangles. The f32 operation order is that
// of _intersect_chunk and the library is built with -fmad=false and
// IEEE division, so no product is contracted into an FMA. Min/max keep
// NaN (jnp.minimum/maximum semantics): a NaN slab keeps a chunk live.
//
// What bounds it on an H100: operations. Each ray-triangle pair costs
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
// What bounded the tile walk's any hit (H100 80GB HBM3, 700 W, PERF.md):
// on the bouncing scene's point+distant shadow query (262,144 rays, 250k
// triangles) the pairs its per-ray cull needs are 19.9M, the pairs the
// tile's unresolved rays evaluate (union_pairs, the TPU formulation)
// 77.8M, the lane-slots it issued (warp_pairs) 97.9M. It took 1.80 ms,
// and so did its longest tile (2.00 ms of a 2.00 ms span; the mean tile
// 96 us): one tile, sharing its SM with a second CTA, set the time.
//
// The any-hit walk evaluates the same set of pairs and changes only how
// it lands on lanes, SMs and time:
//  (i) Packing. At a tile's start and at each super boundary where a ray
//      resolved since, the unresolved rays (t >= 0, or NaN) move through
//      shared memory, 11 words each, into the lowest threads; the others
//      write their result and drop. A warp without an unresolved ray
//      skips the Moller-Trumbore loop. Issued lane-slots fall from
//      warp_pairs to packed_pairs (82.1M on that query).
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
// Barriers per live sub-chunk fall from 3 to 2 (tc = 64), per dead
// sub-chunk from 1 to 0, per further piece of a sub-chunk from 2 to 1;
// per super both walks take 2, and the any-hit walk 2 per tile more.
// The counters keep their semantics (box_tests n_live x n_sub x 512 per
// tile, tri_tests tc x the live rays at each sub-chunk's start), summed
// per CTA in 64 bits and added atomically. Tiles are independent, so
// the schedule changes no bit; ids and t equal the tile walk's and the
// plain version's.
//
// TIMING variants (not launched by any render path) record each tile's
// [%globaltimer start, end, %smid]: tools/anyhit_walk_torch.py turns them
// into the longest and mean tile and the tail.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRayTile = 512;   // rays per CTA (the TPU ray tile)
constexpr int kWarps = kRayTile / 32;
constexpr int kPiece = 64;      // triangles staged in shared memory at once
constexpr int kMaxSub = 16;     // cull chunks per super, at most
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

// One ray against staged triangle q (rows v0 e1 e2 [reach_lo reach_hi]
// of a (kRows, kPiece) block): Moller-Trumbore in _intersect_chunk's f32
// order, accepted strictly below t_best, then the root filter's slab
// for a pair it accepted. The hit's t goes to t_hit.
template <int kRows, bool ROOT_FILTER>
__device__ __forceinline__ bool pair_test(const float (*s)[kPiece], int q,
                                          const float o[3], const float d[3],
                                          const float iv[3], float t_best,
                                          int backface, float& t_hit) {
  const float v00 = s[0][q], v01 = s[1][q], v02 = s[2][q];
  const float e10 = s[3][q], e11 = s[4][q], e12 = s[5][q];
  const float e20 = s[6][q], e21 = s[7][q], e22 = s[8][q];
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
  ok = ok && (u >= 0.0f) && (u <= 1.0f) && (v >= 0.0f) &&
       (u + v <= 1.0f) && (t >= 0.0f) && (t < t_best);
  if (ROOT_FILTER && ok) {
    const float lo[3] = {s[kRows - 6][q], s[kRows - 5][q], s[kRows - 4][q]};
    const float hi[3] = {s[kRows - 3][q], s[kRows - 2][q], s[kRows - 1][q]};
    ok = reach_hit(lo, hi, o, iv);
  }
  t_hit = t;
  return ok;
}

// Device clock and SM id, for the TIMING variants' per-tile records.
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned sm_id() {
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
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

struct Args {
  const float* tri;      // (Cs, 16, n_sub*tc)
  const float* cbox;     // (Cs*n_sub, 8)
  const float* aux;      // (10, rp)
  const int* torder;     // (n_tiles, Cs)
  const int* counts;     // (n_tiles,)
  const int* idmap;      // (2, n_pad), FUSED only
  const int* order;      // (n_tiles,) tile schedule, the any-hit walk only
  int* work;             // (1,) next schedule slot, zeroed, the any-hit walk
  long long* timing;     // (n_tiles, 3) [start ns, end ns, SM], TIMING only
  float* t_out;          // (rp,)
  int* tri_out;          // (rp,) tri, or mid if FUSED
  int* vid_out;          // (rp,), FUSED only
  unsigned long long* counters;  // (2,) [tri_tests, box_tests], STATS only
  int n_tiles, rp, cs, n_sub, tc, n_pad, backface;
};

// ---- the tile walk: closest hit, and the any hit as it was -------------

template <bool ANYHIT, bool FUSED, bool ROOT_FILTER, bool STATS, bool TIMING>
__global__ void __launch_bounds__(kRayTile) mesh_intersect_kernel(const Args a) {
  constexpr int kRows = ROOT_FILTER ? 15 : 9;  // v0 e1 e2 [reach_lo reach_hi]
  __shared__ float s_box[kMaxSub][8];
  __shared__ float s_tri[kRows][kPiece];

  const int tile = blockIdx.x;
  const int lane = threadIdx.x;
  unsigned long long t_start = 0;
  if (TIMING && lane == 0) t_start = global_ns();
  const int rp = a.rp, n_sub = a.n_sub, tc = a.tc;
  const long r = (long)tile * kRayTile + lane;
  const float* aux = a.aux;
  const float o[3] = {aux[0L * rp + r], aux[1L * rp + r], aux[2L * rp + r]};
  const float d[3] = {aux[3L * rp + r], aux[4L * rp + r], aux[5L * rp + r]};
  const float iv[3] = {aux[6L * rp + r], aux[7L * rp + r], aux[8L * rp + r]};
  float t_best = aux[9L * rp + r];
  int tri_best = -1;
  long long tri_tests = 0;  // STATS: the same in every thread

  const long row_stride = (long)n_sub * tc;
  const int n_live = a.counts[tile];
  for (int k = 0; k < n_live; ++k) {
    const int sup = a.torder[(long)tile * a.cs + k];
    __syncthreads();  // every thread is done with the previous super's boxes
    if (lane < n_sub * 6) {
      s_box[lane / 6][lane % 6] = a.cbox[((long)sup * n_sub + lane / 6) * 8 + lane % 6];
    }
    __syncthreads();
    for (int j = 0; j < n_sub; ++j) {
      const bool live = cull_live(s_box[j], o, iv, t_best);
      if (STATS) {
        const int n = __syncthreads_count(live);
        if (n == 0) continue;
        tri_tests += (long long)n * tc;
      } else if (!__syncthreads_or(live)) {
        continue;
      }

      const float* base = a.tri + (long)sup * 16 * row_stride + (long)j * tc;
      for (int p0 = 0; p0 < tc; p0 += kPiece) {
        for (int e = lane; e < kRows * kPiece; e += kRayTile) {
          s_tri[e / kPiece][e % kPiece] = base[(e / kPiece) * row_stride + p0 + e % kPiece];
        }
        __syncthreads();
        // A resolved ray (t_best < 0) can accept nothing: t >= 0 > t_best.
        if (t_best >= 0.0f) {
          for (int q = 0; q < kPiece; ++q) {
            float t;
            if (pair_test<kRows, ROOT_FILTER>(s_tri, q, o, d, iv, t_best,
                                              a.backface, t)) {
              if (ANYHIT) {
                t_best = -1.0f;  // done marker: culls every later chunk
                tri_best = 0;
                break;
              }
              t_best = t;
              tri_best = (sup * n_sub + j) * tc + p0 + q;
            }
          }
        }
        __syncthreads();  // s_tri is rewritten by the next piece
      }
    }
  }
  if (FUSED) {
    const bool found = tri_best >= 0;
    a.t_out[r] = found ? t_best : kFmax;
    a.tri_out[r] = found ? a.idmap[tri_best] : -1;
    a.vid_out[r] = found ? a.idmap[(long)a.n_pad + tri_best] : 0;
  } else {
    a.t_out[r] = t_best;
    a.tri_out[r] = tri_best;
  }
  if (STATS && lane == 0) {
    atomicAdd(&a.counters[0], (unsigned long long)tri_tests);
    atomicAdd(&a.counters[1], (unsigned long long)n_live * n_sub * kRayTile);
  }
  if (TIMING) {
    __syncthreads();
    if (lane == 0) {
      a.timing[3L * tile] = (long long)t_start;
      a.timing[3L * tile + 1] = (long long)global_ns();
      a.timing[3L * tile + 2] = (long long)sm_id();
    }
  }
}

// ---- the any-hit walk --------------------------------------------------

template <bool ROOT_FILTER, bool STATS, bool TIMING>
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
    unsigned long long t_start = 0;
    if (TIMING && tid == 0) t_start = global_ns();
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
    if (TIMING) {
      __syncthreads();
      if (tid == 0) {
        a.timing[3L * tile] = (long long)t_start;
        a.timing[3L * tile + 1] = (long long)global_ns();
        a.timing[3L * tile + 2] = (long long)sm_id();
      }
    }
  }
  cp_async_wait_all();
  if (STATS && tid == 0) {
    atomicAdd(&a.counters[0], (unsigned long long)tri_tests);
    atomicAdd(&a.counters[1], (unsigned long long)box_tests);
  }
}

// ---- launchers ------------------------------------------------------------

template <bool ANYHIT, bool FUSED, bool ROOT_FILTER, bool STATS, bool TIMING>
int launch_tiles(const Args& a, cudaStream_t stream) {
  mesh_intersect_kernel<ANYHIT, FUSED, ROOT_FILTER, STATS, TIMING>
      <<<a.n_tiles, kRayTile, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool ANYHIT, bool FUSED, bool TIMING>
int launch_variant(const Args& a, int root_filter, int stats, cudaStream_t s) {
  if (root_filter) {
    return stats ? launch_tiles<ANYHIT, FUSED, true, true, TIMING>(a, s)
                 : launch_tiles<ANYHIT, FUSED, true, false, TIMING>(a, s);
  }
  return stats ? launch_tiles<ANYHIT, FUSED, false, true, TIMING>(a, s)
               : launch_tiles<ANYHIT, FUSED, false, false, TIMING>(a, s);
}

// The any-hit walk's kernel for its flags.
using WalkFn = void (*)(const Args);
WalkFn walk_kernel(int root_filter, int stats, int timing) {
  const WalkFn fns[8] = {
      anyhit_walk_kernel<false, false, false>, anyhit_walk_kernel<false, false, true>,
      anyhit_walk_kernel<false, true, false>, anyhit_walk_kernel<false, true, true>,
      anyhit_walk_kernel<true, false, false>, anyhit_walk_kernel<true, false, true>,
      anyhit_walk_kernel<true, true, false>, anyhit_walk_kernel<true, true, true>};
  return fns[(root_filter ? 4 : 0) + (stats ? 2 : 0) + (timing ? 1 : 0)];
}

// The persistent grid: `per_sm` CTAs on every SM (0: as many as are
// resident at once, the occupancy; cached per device and variant), at
// most one a tile.
int walk_grid(WalkFn fn, int variant, int per_sm, int n_tiles) {
  constexpr int kMaxDevices = 64;
  static int resident[kMaxDevices][8], sms[kMaxDevices];
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
// root_filter=1 adds the reach-box slab (table rows 9-14); stats=1 adds
// [tri_tests, box_tests] into counters (2,) u64, which the caller zeroes.
// timing, when not null, takes (n_tiles, 3) int64 per-tile records [start
// ns, end ns, SM id] of the any hit (its TIMING variant). ctas_per_sm
// sets the any-hit walk's persistent grid: that many CTAs on every SM, 0
// for as many as fit.
int rt_intersect(const void* tri, const void* cbox, const void* aux,
                 const void* torder, const void* counts, const void* idmap,
                 const void* order, void* work, void* timing,
                 void* t_out, void* tri_out, void* vid_out, void* counters,
                 int n_tiles, int rp, int cs, int n_sub, int tc, int n_pad,
                 int backface, int anyhit, int fused, int root_filter,
                 int stats, int ctas_per_sm, void* stream) {
  if (check_shapes(n_tiles, rp, n_sub, tc) || (anyhit && fused) ||
      (fused && n_pad != cs * n_sub * tc) ||
      (fused && (idmap == nullptr || vid_out == nullptr)) ||
      (stats && counters == nullptr) || (timing && !anyhit) ||
      (anyhit && (order == nullptr || work == nullptr ||
                  (reinterpret_cast<size_t>(tri) & 15) != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_tiles == 0) return 0;
  const Args a{(const float*)tri, (const float*)cbox, (const float*)aux,
               (const int*)torder, (const int*)counts, (const int*)idmap,
               (const int*)order, (int*)work, (long long*)timing,
               (float*)t_out, (int*)tri_out, (int*)vid_out,
               (unsigned long long*)counters,
               n_tiles, rp, cs, n_sub, tc, n_pad, backface};
  const cudaStream_t s = (cudaStream_t)stream;
  if (anyhit) {
    const int variant = (root_filter ? 4 : 0) + (stats ? 2 : 0) + (timing ? 1 : 0);
    const WalkFn fn = walk_kernel(root_filter, stats, timing != nullptr);
    const int grid = walk_grid(fn, variant, ctas_per_sm, n_tiles);
    if (grid < 0) return -grid;
    fn<<<grid, kRayTile, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  if (fused) return launch_variant<false, true, false>(a, root_filter, stats, s);
  return launch_variant<false, false, false>(a, root_filter, stats, s);
}

// The any hit as the tile walk (one CTA per tile in tile order), kept to
// be timed against the any-hit walk; same arguments and results as
// rt_intersect with anyhit=1 (order and work are not used).
int rt_anyhit_tile_walk(const void* tri, const void* cbox, const void* aux,
                        const void* torder, const void* counts, void* timing,
                        void* t_out, void* tri_out, void* counters,
                        int n_tiles, int rp, int cs, int n_sub, int tc,
                        int backface, int root_filter, int stats, void* stream) {
  if (check_shapes(n_tiles, rp, n_sub, tc) || (stats && counters == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_tiles == 0) return 0;
  const Args a{(const float*)tri, (const float*)cbox, (const float*)aux,
               (const int*)torder, (const int*)counts, nullptr, nullptr,
               nullptr, (long long*)timing, (float*)t_out, (int*)tri_out,
               nullptr, (unsigned long long*)counters,
               n_tiles, rp, cs, n_sub, tc, 0, backface};
  const cudaStream_t s = (cudaStream_t)stream;
  return timing ? launch_variant<true, false, true>(a, root_filter, stats, s)
                : launch_variant<true, false, false>(a, root_filter, stats, s);
}

// Resources of an any-hit kernel (walk=1 the any-hit walk, 0 the tile
// walk): out[0..4] = resident CTAs per SM at 512 threads, registers per
// thread, local (spill) bytes per thread, static shared bytes, SMs.
int rt_anyhit_resources(int walk, int root_filter, int stats, int* out) {
  const void* fn;
  if (walk) {
    fn = (const void*)walk_kernel(root_filter, stats, 0);
  } else if (root_filter) {
    fn = stats ? (const void*)mesh_intersect_kernel<true, false, true, true, false>
               : (const void*)mesh_intersect_kernel<true, false, true, false, false>;
  } else {
    fn = stats ? (const void*)mesh_intersect_kernel<true, false, false, true, false>
               : (const void*)mesh_intersect_kernel<true, false, false, false, false>;
  }
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
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
  return (int)err;
}

const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
