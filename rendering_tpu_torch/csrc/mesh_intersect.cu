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
// Work layout. One CTA per 512-ray tile, one ray per thread. The CTA
// walks its tile's live super-chunk list (torder/counts, from the
// pre-pass in ops/cuda_intersect.py) in order, which is the TPU grid's
// per-tile visit order. For each super it stages the super's n_sub cull
// boxes in shared memory; each thread slab-tests its ray against each
// cull box with its running t, and a sub-chunk no ray of the tile needs
// is skipped. A live sub-chunk is staged in shared memory 64 triangles
// at a time (rows v0/e1/e2, and the reach rows for the root filter) and
// every thread runs Moller-Trumbore against each triangle in ascending
// row order.
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
// 57 f32 instructions in the loop below: cross products p and q,
// 2 x (6 mul + 3 sub); det, 3 mul + 2 add; tv, 3 sub; u, v and t,
// 3 x (4 mul + 2 add); u + v, 1 add; 7 compares; 1 select; and the IEEE
// reciprocal 1/det, MUFU.RCP plus 3 refinement instructions. The root
// filter's slab adds 29 per accepted pair: per axis 1 compare, 2
// selects, 2 sub and 2 mul; then 4 compares and 2 compare-selects.
// Under -fmad=false none of them fuses, so an H100 SXM issues them at
// one per lane per clock: 132 SMs x 128 lanes x 1.98 GHz = 33.5e12/s,
// half its FMA-counted 67 TFLOP/s. A 250k-triangle block needs ~6e7
// pairs per launch, while the tables are 16 MB and the rays a few MB.
// The design keeps the triangle rows in shared memory (one global read
// per 512 rays) and skips sub-chunks by the running t; rays already
// resolved (t < 0: padding, pre-done shadow lanes, any-hit done) skip
// the arithmetic. It does not yet overlap loads with compute or balance
// tiles across SMs: that is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRayTile = 512;   // rays per CTA (the TPU ray tile)
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

struct Args {
  const float* tri;      // (Cs, 16, n_sub*tc)
  const float* cbox;     // (Cs*n_sub, 8)
  const float* aux;      // (10, rp)
  const int* torder;     // (n_tiles, Cs)
  const int* counts;     // (n_tiles,)
  const int* idmap;      // (2, n_pad), FUSED only
  float* t_out;          // (rp,)
  int* tri_out;          // (rp,) tri, or mid if FUSED
  int* vid_out;          // (rp,), FUSED only
  unsigned long long* counters;  // (2,) [tri_tests, box_tests], STATS only
  int n_tiles, rp, cs, n_sub, tc, n_pad, backface;
};

template <bool ANYHIT, bool FUSED, bool ROOT_FILTER, bool STATS>
__global__ void __launch_bounds__(kRayTile) mesh_intersect_kernel(const Args a) {
  constexpr int kRows = ROOT_FILTER ? 15 : 9;  // v0 e1 e2 [reach_lo reach_hi]
  __shared__ float s_box[kMaxSub][6];
  __shared__ float s_tri[kRows][kPiece];

  const int tile = blockIdx.x;
  const int lane = threadIdx.x;
  const int rp = a.rp, n_sub = a.n_sub, tc = a.tc;
  const long r = (long)tile * kRayTile + lane;
  const float* aux = a.aux;
  const float ro0 = aux[0L * rp + r], ro1 = aux[1L * rp + r], ro2 = aux[2L * rp + r];
  const float rd0 = aux[3L * rp + r], rd1 = aux[4L * rp + r], rd2 = aux[5L * rp + r];
  const float iv0 = aux[6L * rp + r], iv1 = aux[7L * rp + r], iv2 = aux[8L * rp + r];
  const float o[3] = {ro0, ro1, ro2};
  const float iv[3] = {iv0, iv1, iv2};
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
      // Slab test of the cull box, comparisons negated so NaN stays live.
      float ctmin = -kFmax, ctmax = kFmax;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float t1 = (s_box[j][c] - o[c]) * iv[c];
        const float t2 = (s_box[j][3 + c] - o[c]) * iv[c];
        ctmin = nan_max(ctmin, nan_min(t1, t2));
        ctmax = nan_min(ctmax, nan_max(t1, t2));
      }
      // Pad chunks hold inverted boxes: lo.x > hi.x only holds for them.
      const bool invalid = s_box[j][0] > s_box[j][3];
      const bool live = !((ctmin > ctmax) || (ctmax < 0.0f) || invalid) &&
                        !((ctmin >= t_best) || (t_best < 0.0f));
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
            const float v00 = s_tri[0][q], v01 = s_tri[1][q], v02 = s_tri[2][q];
            const float e10 = s_tri[3][q], e11 = s_tri[4][q], e12 = s_tri[5][q];
            const float e20 = s_tri[6][q], e21 = s_tri[7][q], e22 = s_tri[8][q];
            const float p0v = rd1 * e22 - rd2 * e21;
            const float p1v = rd2 * e20 - rd0 * e22;
            const float p2v = rd0 * e21 - rd1 * e20;
            const float det = (e10 * p0v + e11 * p1v) + e12 * p2v;
            bool ok = a.backface ? (det >= 1e-8f) : (fabsf(det) >= 1e-8f);
            const float inv = 1.0f / (ok ? det : 1.0f);
            const float tv0 = ro0 - v00, tv1 = ro1 - v01, tv2 = ro2 - v02;
            const float u = ((tv0 * p0v + tv1 * p1v) + tv2 * p2v) * inv;
            const float q0 = tv1 * e12 - tv2 * e11;
            const float q1 = tv2 * e10 - tv0 * e12;
            const float q2 = tv0 * e11 - tv1 * e10;
            const float v = ((rd0 * q0 + rd1 * q1) + rd2 * q2) * inv;
            const float t = ((e20 * q0 + e21 * q1) + e22 * q2) * inv;
            ok = ok && (u >= 0.0f) && (u <= 1.0f) && (v >= 0.0f) &&
                 (u + v <= 1.0f) && (t >= 0.0f) && (t < t_best);
            if (ROOT_FILTER && ok) {
              const float lo[3] = {s_tri[kRows - 6][q], s_tri[kRows - 5][q],
                                   s_tri[kRows - 4][q]};
              const float hi[3] = {s_tri[kRows - 3][q], s_tri[kRows - 2][q],
                                   s_tri[kRows - 1][q]};
              ok = reach_hit(lo, hi, o, iv);
            }
            if (ok) {
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
}

template <bool ANYHIT, bool FUSED, bool ROOT_FILTER, bool STATS>
int launch(const Args& a, cudaStream_t stream) {
  mesh_intersect_kernel<ANYHIT, FUSED, ROOT_FILTER, STATS>
      <<<a.n_tiles, kRayTile, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool ANYHIT, bool FUSED>
int launch_variant(const Args& a, int root_filter, int stats, cudaStream_t stream) {
  if (root_filter) {
    return stats ? launch<ANYHIT, FUSED, true, true>(a, stream)
                 : launch<ANYHIT, FUSED, true, false>(a, stream);
  }
  return stats ? launch<ANYHIT, FUSED, false, true>(a, stream)
               : launch<ANYHIT, FUSED, false, false>(a, stream);
}

}  // namespace

extern "C" {

// One intersection query over prepared rays and chunk tables.
//   anyhit=0, fused=0: closest hit, (t, chunk-space triangle id) of the
//     nearest accepted hit below t0, else (t0, -1).
//   anyhit=1, fused=0: any hit, (-1, 0) when some triangle is hit below
//     t0, else (t0, -1); over fused tables this is K5's any hit.
//   anyhit=0, fused=1: fused closest hit (K5), (t, mesh sub index,
//     global gather column) through idmap (2, n_pad); (FLT_MAX, -1, 0)
//     on a miss.
// root_filter=1 adds the reach-box slab (table rows 9-14); stats=1 adds
// [tri_tests, box_tests] into counters (2,) u64, which the caller zeroes.
int rt_intersect(const void* tri, const void* cbox, const void* aux,
                 const void* torder, const void* counts, const void* idmap,
                 void* t_out, void* tri_out, void* vid_out, void* counters,
                 int n_tiles, int rp, int cs, int n_sub, int tc, int n_pad,
                 int backface, int anyhit, int fused, int root_filter,
                 int stats, void* stream) {
  if (n_sub < 1 || n_sub > kMaxSub || tc % kPiece != 0 || rp != n_tiles * kRayTile ||
      (anyhit && fused) || (fused && n_pad != cs * n_sub * tc) ||
      (fused && (idmap == nullptr || vid_out == nullptr)) ||
      (stats && counters == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_tiles == 0) return 0;
  const Args a{(const float*)tri, (const float*)cbox, (const float*)aux,
               (const int*)torder, (const int*)counts, (const int*)idmap,
               (float*)t_out, (int*)tri_out, (int*)vid_out,
               (unsigned long long*)counters,
               n_tiles, rp, cs, n_sub, tc, n_pad, backface};
  const cudaStream_t s = (cudaStream_t)stream;
  if (fused) return launch_variant<false, true>(a, root_filter, stats, s);
  if (anyhit) return launch_variant<true, false>(a, root_filter, stats, s);
  return launch_variant<false, false>(a, root_filter, stats, s);
}

const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
