// The showAC walk for Hopper (sm_90a): for each ray, the number of real
// BVH nodes whose box it hits while the boxes of all their ancestors were
// hit (the reference's AccelerationStructure::recCountAC,
// src/objects.cpp:572-585). It has no Pallas counterpart: the JAX package
// runs it as an XLA while loop (rendering_tpu/ops/traversal.py:161,
// count_ac_nodes), and ops/traversal.py's plain PyTorch version is a torch
// loop over walk steps, which costs more on the card than the frame it
// draws (24.4 s against 1.3 s at 3840x1080 with a 250k mesh on an H100,
// PERF.md section 6).
//
// Design: one thread a ray, the stackless skip walk over the flattened
// tree (a hit box steps to the next node in depth-first order, a missed
// one jumps to skip[node]), the node arrays read from global memory
// through the read-only cache (62,049-96,367 nodes, 2-3 MB, at 250k
// triangles: they stay in L2). Neighbouring threads hold neighbouring
// pixels of a row, whose walks mostly agree, so a warp's loads of a node
// coalesce.
// Bound: f32 operations, the slab tests the walk makes (26 each: per
// axis 2 selects, 1 sub and 1 mul for each side; 4 compares for the hit;
// 2 compare-selects narrowing the interval after y) at one an SM lane a
// clock; the bytes (the rays once, the nodes once, a count a ray) are
// ~100x less.
//
// The slab test is a literal transcription of intersectBox, as
// ops/intersect.py::slab_test is: 1/rd by IEEE division, the box sides
// picked by the sign of 1/rd, a sub and a mul per side (built with
// -fmad=false: never contracted), and the reference's comparisons, which
// are false on a NaN; no fminf/fmaxf. A box behind the origin counts as
// hit. 1/rd and its signs are per ray, so they are computed once before
// the walk; the values are the same ones the plain version recomputes at
// each step. With use_ac == 0 every box counts as hit, so the walk would
// visit every node in order and every ray counts all the real nodes: the
// kernel sums real_flag once a block instead (96,367 steps a ray took
// 10.2 ms a block on an H100; PERF.md section 7), as the plain version
// sums it once.
//
// bvh_closest_kernel is the closest-hit walk over the same tree, the
// oracle of a mesh above settings.bruteforce_threshold triangles when
// use_pallas_intersect is off (rendering_tpu/ops/traversal.py:49,
// traverse_bvh, the reference's intersectAccelStruct,
// src/objects.cpp:587-631). It has no Pallas counterpart either: the JAX
// package runs it as an XLA while loop, and the plain version in
// ops/traversal.py is a torch loop over walk steps, which on the card
// costs what the showAC loop did and more (PERF.md section 6).
//
// Design: ac_walk's, one thread a ray and the stackless skip walk with
// the node arrays through the read-only cache. At a hit leaf chunk the
// thread tests the chunk's leaf_count (<= leaf_chunk, 8) triangles of
// leaf_tris against the Morton-ordered v (T, 3, 3) in order with the
// strict t < t_best, so the first in leaf depth-first order wins a tie, as
// JAX's first-occurrence argmin over the chunk's lanes does; a triangle a
// leaf duplicates is tested, and counted, at every visit. With prune a
// box skips when (tmax < 0) | (tmin > t_best), written out so that a NaN
// never skips; use_ac == 0 forces the box hit but keeps that prune on the
// slab's own interval (JAX's behaviour, not ac_walk's shortcut). A
// t_limit (a shadow query's light distance, -1 for a ray already
// resolved) starts t_best at min(FLT_MAX, t_limit), NaN-propagating, and a
// ray that found nothing reads FLT_MAX again at the end. The counters are
// JAX's: a box test per step on a real node (x use_ac), a triangle test
// per leaf lane tested; each thread counts its own, a block sums them and
// adds them to two int64 counters.
// Bound: f32 operations, the slab tests (26 each, as above) and the
// Moller-Trumbore pair tests (57 each) that this run's counters count;
// the bytes (rays, nodes, leaf ids and vertices once, t, id, u, v a ray)
// are far fewer. A simple kernel first: an any-hit early exit for shadow
// rays, warp-coherent traversal and compressed nodes are later work.
// Moller-Trumbore is ops/intersect.py::ray_triangle_r's sequence: the
// same cross products, left-to-right sums, no contraction (-fmad=false),
// 1/det by IEEE division; the slab test is ac_walk's with the interval
// narrowed on z too.
//
// The C entry points return the launch's cudaError_t (0 on success).

#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ac_walk_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
               const float* __restrict__ node_min,
               const float* __restrict__ node_max,
               const int* __restrict__ skip,
               const int* __restrict__ real_flag, int* __restrict__ counts,
               int n_rays, int n_nodes, int use_ac) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (!use_ac) {
    // Every box counts as hit: the walk would visit nodes 0..n_nodes-1 in
    // order, so every ray counts all the real nodes. The block sums them
    // (every thread of the block reaches the barrier).
    __shared__ int warp_sums[kThreads / 32];
    int part = 0;
    for (int j = threadIdx.x; j < n_nodes; j += kThreads)
      part += __ldg(real_flag + j) > 0;
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_down_sync(0xffffffffu, part, off);
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = part;
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int k = 0; k < kThreads / 32; ++k) total += warp_sums[k];
    if (i < n_rays) counts[i] = total;
    return;
  }
  if (i >= n_rays) return;
  const float o[3] = {ro[3 * i], ro[3 * i + 1], ro[3 * i + 2]};
  float inv[3];
  bool neg[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    inv[c] = 1.0f / rd[3 * i + c];
    neg[c] = inv[c] < 0.0f;
  }
  int cur = 0;
  int count = 0;
  while (cur < n_nodes) {
    float t_lo[3], t_hi[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float bmin = __ldg(node_min + 3 * cur + c);
      const float bmax = __ldg(node_max + 3 * cur + c);
      const float lo = neg[c] ? bmax : bmin;
      const float hi = neg[c] ? bmin : bmax;
      t_lo[c] = (lo - o[c]) * inv[c];
      t_hi[c] = (hi - o[c]) * inv[c];
    }
    float tmin = t_lo[0], tmax = t_hi[0];
    bool hit = !((tmin > t_hi[1]) || (t_lo[1] > tmax));
    tmin = (t_lo[1] > tmin) ? t_lo[1] : tmin;
    tmax = (t_hi[1] < tmax) ? t_hi[1] : tmax;
    hit = hit && !((tmin > t_hi[2]) || (t_lo[2] > tmax));
    if (hit) {
      count += __ldg(real_flag + cur) > 0;
      cur += 1;
    } else {
      cur = __ldg(skip + cur);
    }
  }
  counts[i] = count;
}

__global__ void __launch_bounds__(kThreads)
bvh_closest_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                   const float* __restrict__ t_limit,
                   const float* __restrict__ node_min,
                   const float* __restrict__ node_max,
                   const int* __restrict__ skip,
                   const int* __restrict__ leaf_start,
                   const int* __restrict__ leaf_count,
                   const int* __restrict__ real_flag,
                   const int* __restrict__ leaf_tris,
                   const float* __restrict__ v, float* __restrict__ t_out,
                   int* __restrict__ tri_out, float* __restrict__ u_out,
                   float* __restrict__ v_out,
                   unsigned long long* __restrict__ counters, int n_rays,
                   int n_nodes, int culling, int use_ac, int prune) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long box_ct = 0, tri_ct = 0;
  if (i < n_rays) {
    const float o[3] = {ro[3 * i], ro[3 * i + 1], ro[3 * i + 2]};
    const float d[3] = {rd[3 * i], rd[3 * i + 1], rd[3 * i + 2]};
    float inv[3];
    bool neg[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      inv[c] = 1.0f / d[c];
      neg[c] = inv[c] < 0.0f;
    }
    float t_best = FLT_MAX;
    if (t_limit != nullptr) {
      // min(FLT_MAX, t_limit), a NaN kept.
      const float tl = t_limit[i];
      t_best = (tl != tl) ? tl : ((tl < FLT_MAX) ? tl : FLT_MAX);
    }
    int tri_best = -1;
    float u_best = 0.0f, v_best = 0.0f;
    int cur = 0;
    while (cur < n_nodes) {
      float t_lo[3], t_hi[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float bmin = __ldg(node_min + 3 * cur + c);
        const float bmax = __ldg(node_max + 3 * cur + c);
        const float lo = neg[c] ? bmax : bmin;
        const float hi = neg[c] ? bmin : bmax;
        t_lo[c] = (lo - o[c]) * inv[c];
        t_hi[c] = (hi - o[c]) * inv[c];
      }
      float tmin = t_lo[0], tmax = t_hi[0];
      bool hit = !((tmin > t_hi[1]) || (t_lo[1] > tmax));
      tmin = (t_lo[1] > tmin) ? t_lo[1] : tmin;
      tmax = (t_hi[1] < tmax) ? t_hi[1] : tmax;
      hit = hit && !((tmin > t_hi[2]) || (t_lo[2] > tmax));
      tmin = (t_lo[2] > tmin) ? t_lo[2] : tmin;
      tmax = (t_hi[2] < tmax) ? t_hi[2] : tmax;
      bool descend = use_ac ? hit : true;
      if (prune) descend = descend && !((tmax < 0.0f) || (tmin > t_best));
      if (use_ac && __ldg(real_flag + cur) > 0) ++box_ct;
      const int cnt = __ldg(leaf_count + cur);
      if (descend && cnt > 0) {
        const int start = __ldg(leaf_start + cur);
        for (int k = 0; k < cnt; ++k) {
          const int id = __ldg(leaf_tris + start + k);
          const float* tv = v + 9 * (size_t)id;
          float v0[3], e1[3], e2[3];
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            v0[c] = __ldg(tv + c);
            e1[c] = __ldg(tv + 3 + c) - v0[c];
            e2[c] = __ldg(tv + 6 + c) - v0[c];
          }
          const float p0 = d[1] * e2[2] - d[2] * e2[1];
          const float p1 = d[2] * e2[0] - d[0] * e2[2];
          const float p2 = d[0] * e2[1] - d[1] * e2[0];
          const float det = (e1[0] * p0 + e1[1] * p1) + e1[2] * p2;
          bool ok = culling ? (det >= 1e-8f) : (fabsf(det) >= 1e-8f);
          const float inv_det = 1.0f / (ok ? det : 1.0f);
          const float s0 = o[0] - v0[0], s1 = o[1] - v0[1], s2 = o[2] - v0[2];
          const float u = ((s0 * p0 + s1 * p1) + s2 * p2) * inv_det;
          ok = ok && (u >= 0.0f) && (u <= 1.0f);
          const float q0 = s1 * e1[2] - s2 * e1[1];
          const float q1 = s2 * e1[0] - s0 * e1[2];
          const float q2 = s0 * e1[1] - s1 * e1[0];
          const float vv = ((d[0] * q0 + d[1] * q1) + d[2] * q2) * inv_det;
          ok = ok && (vv >= 0.0f) && (u + vv <= 1.0f);
          const float t = ((e2[0] * q0 + e2[1] * q1) + e2[2] * q2) * inv_det;
          ok = ok && (t >= 0.0f);
          if (ok && t < t_best) {
            t_best = t;
            tri_best = id;
            u_best = u;
            v_best = vv;
          }
        }
        tri_ct += (unsigned long long)cnt;
      }
      cur = descend ? cur + 1 : __ldg(skip + cur);
    }
    if (t_limit != nullptr && tri_best < 0) t_best = FLT_MAX;
    t_out[i] = t_best;
    tri_out[i] = tri_best;
    u_out[i] = u_best;
    v_out[i] = v_best;
  }
  // Every thread of the block reaches the sums.
  __shared__ unsigned long long sums[2][kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    box_ct += __shfl_down_sync(0xffffffffu, box_ct, off);
    tri_ct += __shfl_down_sync(0xffffffffu, tri_ct, off);
  }
  if ((threadIdx.x & 31) == 0) {
    sums[0][threadIdx.x >> 5] = box_ct;
    sums[1][threadIdx.x >> 5] = tri_ct;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    unsigned long long total = 0;
#pragma unroll
    for (int k = 0; k < kThreads / 32; ++k) total += sums[threadIdx.x][k];
    if (total) atomicAdd(counters + threadIdx.x, total);
  }
}

}  // namespace

extern "C" {

// counts[i] for rays i < n_rays (ro, rd: (n_rays, 3) f32) over a tree of
// n_nodes nodes (node_min, node_max: (n_nodes, 3) f32; skip, real_flag:
// (n_nodes,) int32).
int bw_ac_walk(const void* ro, const void* rd, const void* node_min,
               const void* node_max, const void* skip, const void* real_flag,
               void* counts, int n_rays, int n_nodes, int use_ac,
               void* stream) {
  if (n_rays < 0 || n_nodes < 0) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  ac_walk_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)ro, (const float*)rd, (const float*)node_min,
      (const float*)node_max, (const int*)skip, (const int*)real_flag,
      (int*)counts, n_rays, n_nodes, use_ac);
  return (int)cudaGetLastError();
}

// The closest hits of rays i < n_rays (ro, rd: (n_rays, 3) f32; t_limit:
// (n_rays,) f32 or null) over a tree of n_nodes nodes (node_min,
// node_max: (n_nodes, 3) f32; skip, leaf_start, leaf_count, real_flag:
// (n_nodes,) int32; leaf_tris int32; v (T, 3, 3) f32): t, tri, u, v per
// ray and counters[0..1] (int64, zeroed by the caller) += box and
// triangle tests.
int bw_bvh_closest(const void* ro, const void* rd, const void* t_limit,
                   const void* node_min, const void* node_max,
                   const void* skip, const void* leaf_start,
                   const void* leaf_count, const void* real_flag,
                   const void* leaf_tris, const void* v, void* t_out,
                   void* tri_out, void* u_out, void* v_out, void* counters,
                   int n_rays, int n_nodes, int culling, int use_ac,
                   int prune, void* stream) {
  if (n_rays < 0 || n_nodes < 0) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  bvh_closest_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)ro, (const float*)rd, (const float*)t_limit,
      (const float*)node_min, (const float*)node_max, (const int*)skip,
      (const int*)leaf_start, (const int*)leaf_count,
      (const int*)real_flag, (const int*)leaf_tris, (const float*)v,
      (float*)t_out, (int*)tri_out, (float*)u_out, (float*)v_out,
      (unsigned long long*)counters, n_rays, n_nodes, culling, use_ac,
      prune);
  return (int)cudaGetLastError();
}

const char* bw_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
