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
// The C entry point returns the launch's cudaError_t (0 on success).

#include <cuda_runtime.h>

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

const char* bw_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
