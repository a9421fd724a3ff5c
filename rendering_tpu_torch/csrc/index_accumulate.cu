// The integrator's deterministic index accumulation for Hopper (sm_90a):
// out[c, key] = accum[c, key] + the sum of values[c, lane] over the lanes
// whose id is key, for C channel rows of N columns and Q lanes. It has no
// Pallas counterpart: the JAX package adds radiance into the frame with
// XLA's scatter-add (`accum3.at[:, pix_flat].add(...)`,
// rendering_tpu/render/integrator.py:964) and leaves its gathers'
// backward to XLA. Two callers: the radiance scatter into the frame
// (Q = every lane of a bounce, N = the pixels) and the backward of the
// per-object gathers (N = the scene's object rows). PyTorch's
// deterministic scatter
// (`index_add` under use_deterministic_algorithms, the sort-based
// indexing_backward_kernel) gives each run of equal ids to one warp,
// which walks it serially; the runs here are long (fill lanes at one
// pixel, pad lanes at pixel 0, a handful of object rows for 131,072
// lanes), so it took 20-40 ms a call on an H100 (PERF.md).
//
// Design. The wrapper (ops/accumulate.py) stable-sorts the ids with
// PyTorch's radix sort and passes the sorted keys (int32) and the
// permutation (int64); the wrapper has copied accum into out.
// 1. chunk_kernel: the sorted lanes in fixed chunks of kThreads x S
//    lanes, one CTA each. A thread sums its S contiguous lanes in order,
//    restarting at each new key. A segmented scan over the CTA's threads
//    (seg_scan, Hillis-Steele in shared memory) gives each thread the sum
//    of the run that continues into its slice from the threads before it.
//    Each lane that ends a run then holds the run's sum within the chunk;
//    a run wholly inside the chunk has that one owner, which adds it into
//    out with no atomics. A run that crosses a chunk boundary leaves its
//    partial sums: `tail` (the chunk's last lane, always written) and
//    `head` (the chunk's first run, when it began in an earlier chunk and
//    ends in this one).
// 2. carry_kernel: one CTA per channel scans the chunks' tails with the
//    same segmented scan, tile by tile in chunk order, and each crossing
//    run's last chunk adds (its earlier chunks' sum + its head) into out.
// The order of every sum follows from (ids, Q, S) alone, never from the
// schedule, so repeat frames and train steps are bit-equal; the plain
// version (ops/accumulate.py, index_accumulate_plain) repeats it. All in
// f32; lanes of value 0 are summed like any other. The grid comes from Q
// on the host: no host sync.
// Bound: bytes. Per call the sort (keys and the permutation, a few
// passes), the gather of the values through the permutation, and the
// accumulator's columns read and written: ~40 MB for 524,288 lanes x 3
// channels, ~14 us at 2.88e12 B/s.
//
// Built with -fmad=false (utils/nvcc.py); only additions here, which are
// never contracted anyway. An id outside [0, N) traps, as PyTorch's
// index_add asserts on the device.
//
// The C entry points return the launches' cudaError_t (0 on success).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;        // a chunk's CTA, one slice a thread
constexpr int kCarryThreads = 1024;  // the carry pass's CTA, one a channel

// Inclusive segmented scan over the CTA's kN threads: x is this thread's
// value, g whether a segment starts at it. On return x is the sum of its
// segment up to and including this thread, and g whether a segment start
// lies at or before it. Step d adds the value d threads back unless a
// start lies between: a fixed order. xs holds the results until the next
// call.
template <int kN>
__device__ void seg_scan(float& x, int& g, float* xs, int* gs) {
  const int i = threadIdx.x;
  __syncthreads();  // the last call's readers of xs are done
  xs[i] = x;
  gs[i] = g;
  __syncthreads();
  for (int d = 1; d < kN; d <<= 1) {
    float xo = 0.0f;
    int go = 0;
    if (i >= d) {
      xo = xs[i - d];
      go = gs[i - d];
    }
    __syncthreads();
    if (i >= d) {
      if (!g) x = xo + x;
      g = g | go;
    }
    xs[i] = x;
    gs[i] = g;
    __syncthreads();
  }
}

__device__ __forceinline__ void add_into(float* row, int key, int n,
                                         float total) {
  if (key < 0 || key >= n) __trap();
  row[key] = row[key] + total;
}

template <int S>
__global__ void __launch_bounds__(kThreads)
chunk_kernel(const int* __restrict__ keys, const int64_t* __restrict__ perm,
             const float* __restrict__ values, float* __restrict__ out,
             float* __restrict__ head, float* __restrict__ tail, int64_t q,
             int n, int channels) {
  __shared__ float xs[kThreads];
  __shared__ int gs[kThreads];
  const int64_t chunk = blockIdx.x;
  const int64_t n_chunks = gridDim.x;
  const int64_t c0 = chunk * (int64_t)(kThreads * S);
  const int64_t c_end = min(c0 + (int64_t)(kThreads * S), q);
  const int i = threadIdx.x;
  const int64_t j0 = c0 + (int64_t)i * S;
  const int cnt = (int)max((int64_t)0, min((int64_t)S, c_end - j0));
  int key[S];
  int64_t src[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    key[s] = s < cnt ? keys[j0 + s] : -1;
    src[s] = s < cnt ? perm[j0 + s] : 0;
  }
  int last_key = key[0];
#pragma unroll
  for (int s = 1; s < S; ++s)
    if (s == cnt - 1) last_key = key[s];
  // The id after the slice's last lane (-1 past the end), and before the
  // chunk's first lane (-1 in chunk 0).
  const int key_next = (cnt > 0 && j0 + cnt < q) ? keys[j0 + cnt] : -1;
  const int key_before = c0 > 0 ? keys[c0 - 1] : -1;
  // The slice's first run goes on from the thread before, in this chunk;
  // the segment of its last run starts here unless that run is the same.
  const bool cont = i > 0 && cnt > 0 && key[0] == keys[j0 - 1];
  const int g_slice = !(cont && last_key == key[0]);
  for (int c = 0; c < channels; ++c) {
    const float* v = values + (int64_t)c * q;
    float acc[S];
    float a = 0.0f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      acc[s] = 0.0f;
      if (s < cnt) {
        const float x = v[src[s]];
        a = (s > 0 && key[s] == key[s - 1]) ? a + x : x;
        acc[s] = a;
      }
    }
    float x = cnt > 0 ? a : 0.0f;
    int g = g_slice;
    seg_scan<kThreads>(x, g, xs, gs);
    const float before = i > 0 ? xs[i - 1] : 0.0f;
    float* row = out + (int64_t)c * n;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (s >= cnt) continue;
      const int k = key[s];
      const bool end = (s + 1 < cnt) ? key[s + 1] != k : key_next != k;
      const bool last = j0 + s == c_end - 1;
      if (!end && !last) continue;
      const float total = (cont && k == key[0]) ? before + acc[s] : acc[s];
      if (last) tail[c * n_chunks + chunk] = total;
      if (end) {
        if (k == key_before)
          head[c * n_chunks + chunk] = total;
        else
          add_into(row, k, n, total);
      }
    }
  }
}

__global__ void __launch_bounds__(kCarryThreads)
carry_kernel(const int* __restrict__ keys, const float* __restrict__ head,
             const float* __restrict__ tail, float* __restrict__ scan,
             float* __restrict__ out, int64_t q, int n, int n_chunks,
             int64_t chunk_lanes) {
  __shared__ float xs[kCarryThreads];
  __shared__ int gs[kCarryThreads];
  __shared__ float carry_s;
  const int c = blockIdx.x;
  const int i = threadIdx.x;
  const float* t = tail + (int64_t)c * n_chunks;
  float* sc = scan + (int64_t)c * n_chunks;
  float carry = 0.0f;
  // Each chunk's last run: sum over the chunks it spans so far, the
  // segment starting where the run began inside its chunk.
  for (int base = 0; base < n_chunks; base += kCarryThreads) {
    const int k = base + i;
    float x = 0.0f;
    int g = 1;
    if (k < n_chunks) {
      x = t[k];
      const int64_t first = (int64_t)k * chunk_lanes;
      const int64_t last = min(first + chunk_lanes, q) - 1;
      g = !(k > 0 && keys[last] == keys[first - 1]);
    }
    seg_scan<kCarryThreads>(x, g, xs, gs);
    if (base > 0 && !g) x = carry + x;
    if (k < n_chunks) sc[k] = x;
    if (i == kCarryThreads - 1) carry_s = x;
    __syncthreads();
    carry = carry_s;
  }
  __syncthreads();  // sc is written
  // A run that began before chunk k and ends in it: its total.
  for (int k = i; k < n_chunks; k += kCarryThreads) {
    if (k == 0) continue;
    const int64_t first = (int64_t)k * chunk_lanes;
    const int64_t last = min(first + chunk_lanes, q) - 1;
    const int kf = keys[first];
    if (kf != keys[first - 1]) continue;
    if (keys[last] == kf && last + 1 < q && keys[last + 1] == kf) continue;
    add_into(out + (int64_t)c * n, kf, n,
             sc[k - 1] + head[(int64_t)c * n_chunks + k]);
  }
}

}  // namespace

extern "C" {

// out (channels, n) f32, already holding accum, += the values (channels,
// q) f32 of the lanes perm[j] at columns keys[j] (keys: the ids sorted
// stably, int32; perm: int64); head, tail, scan: (channels, n_chunks) f32
// scratch, n_chunks = ceil(q / (256 * slice_lanes)); slice_lanes 1, 2, 4
// or 8.
int ia_accumulate(const void* keys, const void* perm, const void* values,
                  void* out, void* head, void* tail, void* scan,
                  long long q, int n, int channels, int slice_lanes,
                  void* stream) {
  if (q < 0 || n < 0 || channels < 0) return (int)cudaErrorInvalidValue;
  if (q == 0 || channels == 0) return 0;
  const long long chunk_lanes = (long long)kThreads * slice_lanes;
  const long long n_chunks = (q + chunk_lanes - 1) / chunk_lanes;
  if (n_chunks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* k = (const int*)keys;
  const int64_t* p = (const int64_t*)perm;
  const float* v = (const float*)values;
  float* o = (float*)out;
  float* h = (float*)head;
  float* t = (float*)tail;
  const int grid = (int)n_chunks;
  switch (slice_lanes) {
    case 1:
      chunk_kernel<1><<<grid, kThreads, 0, st>>>(k, p, v, o, h, t, q, n,
                                                 channels);
      break;
    case 2:
      chunk_kernel<2><<<grid, kThreads, 0, st>>>(k, p, v, o, h, t, q, n,
                                                 channels);
      break;
    case 4:
      chunk_kernel<4><<<grid, kThreads, 0, st>>>(k, p, v, o, h, t, q, n,
                                                 channels);
      break;
    case 8:
      chunk_kernel<8><<<grid, kThreads, 0, st>>>(k, p, v, o, h, t, q, n,
                                                 channels);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  int rc = (int)cudaGetLastError();
  if (rc != 0 || n_chunks == 1) return rc;
  carry_kernel<<<channels, kCarryThreads, 0, st>>>(
      k, h, t, (float*)scan, o, q, n, grid, chunk_lanes);
  return (int)cudaGetLastError();
}

const char* ia_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

}  // extern "C"
