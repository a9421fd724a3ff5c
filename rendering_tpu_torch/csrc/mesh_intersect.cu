// Ray-mesh intersection for Hopper (sm_90a): closest hit and any hit.
//
// Replaces the Pallas TPU kernel rendering_tpu/ops/pallas_intersect.py
// ::_kernel (its _cull_and_intersect and _intersect_chunk bodies), in
// its two modes: closest hit (anyhit=False, primary rays) and any hit
// (anyhit=True, batched shadow rays).
//
// Work layout. One CTA per 512-ray tile, one ray per thread. The CTA
// walks its tile's live super-chunk list (torder/counts, from the
// pre-pass in ops/cuda_intersect.py) in order, which is the TPU grid's
// per-tile visit order. For each super it stages the super's n_sub cull
// boxes in shared memory; each thread slab-tests its ray against each
// cull box with its running t, and __syncthreads_or skips a sub-chunk
// no ray of the tile needs. A live sub-chunk is staged in shared memory
// 64 triangles at a time (rows v0/e1/e2 only) and every thread runs
// Moller-Trumbore against each triangle in ascending row order.
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
// reciprocal 1/det, MUFU.RCP plus 3 refinement instructions. Under
// -fmad=false none of them fuses, so an H100 SXM issues them at one per
// lane per clock: 132 SMs x 128 lanes x 1.98 GHz = 33.5e12/s, half its
// FMA-counted 67 TFLOP/s. A 250k-triangle block needs ~6e7 pairs per
// launch, while the tables are 16 MB and the rays a few MB. The design
// keeps the triangle rows in shared memory (one global read per 512
// rays) and skips sub-chunks by the running t; rays already resolved
// (t < 0: padding, pre-done shadow lanes, any-hit done) skip the
// arithmetic. It does not yet overlap loads with compute or balance
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

template <bool ANYHIT>
__global__ void __launch_bounds__(kRayTile)
mesh_intersect_kernel(const float* __restrict__ tri,    // (Cs, 16, n_sub*tc)
                      const float* __restrict__ cbox,   // (Cs*n_sub, 8)
                      const float* __restrict__ aux,    // (10, rp)
                      const int* __restrict__ torder,   // (n_tiles, Cs)
                      const int* __restrict__ counts,   // (n_tiles,)
                      float* __restrict__ t_out,        // (rp,)
                      int* __restrict__ tri_out,        // (rp,)
                      int rp, int cs, int n_sub, int tc, int backface) {
  __shared__ float s_box[kMaxSub][6];
  __shared__ float s_tri[9][kPiece];

  const int tile = blockIdx.x;
  const int lane = threadIdx.x;
  const long r = (long)tile * kRayTile + lane;
  const float ro0 = aux[0L * rp + r], ro1 = aux[1L * rp + r], ro2 = aux[2L * rp + r];
  const float rd0 = aux[3L * rp + r], rd1 = aux[4L * rp + r], rd2 = aux[5L * rp + r];
  const float iv0 = aux[6L * rp + r], iv1 = aux[7L * rp + r], iv2 = aux[8L * rp + r];
  float t_best = aux[9L * rp + r];
  int tri_best = -1;

  const long row_stride = (long)n_sub * tc;
  const int n_live = counts[tile];
  for (int k = 0; k < n_live; ++k) {
    const int sup = torder[(long)tile * cs + k];
    __syncthreads();  // every thread is done with the previous super's boxes
    if (lane < n_sub * 6) {
      s_box[lane / 6][lane % 6] = cbox[((long)sup * n_sub + lane / 6) * 8 + lane % 6];
    }
    __syncthreads();
    for (int j = 0; j < n_sub; ++j) {
      // Slab test of the cull box, comparisons negated so NaN stays live.
      float ctmin = -kFmax, ctmax = kFmax;
      {
        const float o[3] = {ro0, ro1, ro2};
        const float iv[3] = {iv0, iv1, iv2};
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float t1 = (s_box[j][c] - o[c]) * iv[c];
          const float t2 = (s_box[j][3 + c] - o[c]) * iv[c];
          ctmin = nan_max(ctmin, nan_min(t1, t2));
          ctmax = nan_min(ctmax, nan_max(t1, t2));
        }
      }
      // Pad chunks hold inverted boxes: lo.x > hi.x only holds for them.
      const bool invalid = s_box[j][0] > s_box[j][3];
      const bool live = !((ctmin > ctmax) || (ctmax < 0.0f) || invalid) &&
                        !((ctmin >= t_best) || (t_best < 0.0f));
      if (!__syncthreads_or(live)) continue;

      const float* base = tri + (long)sup * 16 * row_stride + (long)j * tc;
      for (int p0 = 0; p0 < tc; p0 += kPiece) {
        for (int e = lane; e < 9 * kPiece; e += kRayTile) {
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
            bool ok = backface ? (det >= 1e-8f) : (fabsf(det) >= 1e-8f);
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
  t_out[r] = t_best;
  tri_out[r] = tri_best;
}

template <bool ANYHIT>
int launch(const void* tri, const void* cbox, const void* aux, const void* torder,
           const void* counts, void* t_out, void* tri_out, int n_tiles, int rp,
           int cs, int n_sub, int tc, int backface, void* stream) {
  if (n_sub < 1 || n_sub > kMaxSub || tc % kPiece != 0 || rp != n_tiles * kRayTile) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_tiles == 0) return 0;
  mesh_intersect_kernel<ANYHIT><<<n_tiles, kRayTile, 0, (cudaStream_t)stream>>>(
      (const float*)tri, (const float*)cbox, (const float*)aux, (const int*)torder,
      (const int*)counts, (float*)t_out, (int*)tri_out, rp, cs, n_sub, tc, backface);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Closest hit: (t, chunk-space triangle id) of the nearest accepted hit
// below t0, else (t0, -1).
int rt_closest_hit(const void* tri, const void* cbox, const void* aux,
                   const void* torder, const void* counts, void* t_out,
                   void* tri_out, int n_tiles, int rp, int cs, int n_sub,
                   int tc, int backface, void* stream) {
  return launch<false>(tri, cbox, aux, torder, counts, t_out, tri_out, n_tiles,
                       rp, cs, n_sub, tc, backface, stream);
}

// Any hit: (-1, 0) when some triangle is hit below t0, else (t0, -1).
int rt_any_hit(const void* tri, const void* cbox, const void* aux,
               const void* torder, const void* counts, void* t_out,
               void* tri_out, int n_tiles, int rp, int cs, int n_sub, int tc,
               int backface, void* stream) {
  return launch<true>(tri, cbox, aux, torder, counts, t_out, tri_out, n_tiles,
                      rp, cs, n_sub, tc, backface, stream);
}

const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
