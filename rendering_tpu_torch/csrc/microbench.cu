// Hardware-ceiling probes for Hopper (sm_90a): the f32 issue rate with
// and without FMA (K7), the per-CTA cost of a grid (K8), and the pair
// test's product in f32 on the SIMT lanes and in TF32 on the tensor
// cores (K9). They replace the three Pallas probes of the JAX package's
// tools/microbench_vpu.py and tools/microbench_kernel.py, and give the
// port measured ceilings in place of the data sheet's: chip_smoke.py's
// F32_OPS_RATE and HBM_RATE, and the bounds of mesh_intersect.cu.
//
// Built with the flags of mesh_intersect.cu (-fmad=false, IEEE division),
// so a multiply and an add that the source writes apart stay apart.
// Every C entry point returns the launch's cudaError_t (0 on success).

#include <cuda_runtime.h>
#include <mma.h>

namespace {

// ---- K8: per-CTA cost ------------------------------------------------------
// Replaces tools/microbench_kernel.py:61 (the pallas_call in
// bench_grid_overhead :36, body :40): a grid of n_steps sequential steps
// that revisit one (8, br) block, step 0 copying x to o. On Hopper the
// steps become n_steps CTAs of one launch, in no order; CTA 0 copies the
// block and the others return at once. Bound: launch latency and the
// block scheduler's cost per CTA (the data is 2 x 8 * br * 4 bytes); a
// launch of one CTA (the empty grid) gives the first alone. CTA 0 loads
// 8 float4 a thread before it stores any, so the copy costs about one
// round trip to memory and hides few of the other CTAs behind it.
constexpr int kOverheadThreads = 256;
constexpr int kCopyBatch = 8;

__global__ void __launch_bounds__(kOverheadThreads)
grid_overhead_kernel(const float* __restrict__ x, float* __restrict__ o,
                     int n) {
  if (blockIdx.x != 0) return;
  const bool vec = ((reinterpret_cast<size_t>(x) |
                     reinterpret_cast<size_t>(o)) & 15) == 0;
  const int n4 = vec ? n / 4 : 0;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(o);
  for (int base = 0; base < n4; base += kCopyBatch * kOverheadThreads) {
    float4 v[kCopyBatch];
#pragma unroll
    for (int j = 0; j < kCopyBatch; ++j) {
      const int i = base + j * kOverheadThreads + threadIdx.x;
      if (i < n4) v[j] = x4[i];
    }
#pragma unroll
    for (int j = 0; j < kCopyBatch; ++j) {
      const int i = base + j * kOverheadThreads + threadIdx.x;
      if (i < n4) o4[i] = v[j];
    }
  }
  for (int i = 4 * n4 + threadIdx.x; i < n; i += kOverheadThreads) o[i] = x[i];
}

// ---- K7: f32 issue rate ----------------------------------------------------
// Replaces tools/microbench_vpu.py:65 (_fma_bench, body _fma_kernel :44):
// per element a = x * 1.000001 + 0.3, b = x * 0.999999 - 0.3, NC
// accumulators x + 0.01 * c, INNER steps of acc = acc * a + b on each,
// then their sum in chain order. FUSED writes each multiply-add as one
// FMA (__fmaf_rn, one rounding), as the TPU's interpret mode contracts
// them; !FUSED writes a multiply and an add (__fmul_rn, __fadd_rn,
// two roundings, never contracted). One build gives both: the unfused
// variant measures the issue rate of separate f32 instructions, which
// the bound of mesh_intersect.cu assumes (33.5e12/s on an H100 SXM at
// 700 W by the data sheet); the fused one the FMA rate (67 TFLOP/s
// counting an FMA as two). Bound: f32 operations; the chains live in
// registers and the block is read and written once. INNER is a runtime
// argument, so no chain can be folded.
//
// The TPU grid's 64 steps revisit one (256, 1024) block; here they are
// 64 x (n / 256) CTAs that recompute that block and write the same
// values. One block is 262,144 threads, about one wave of the card
// (132 SMs x 2,048 resident threads), so the 64 repeats keep it full.
constexpr int kFmaThreads = 256;
constexpr int kMaxChains = 8;

template <bool FUSED>
__device__ __forceinline__ float chain_step(float acc, float a, float b) {
  return FUSED ? __fmaf_rn(acc, a, b) : __fadd_rn(__fmul_rn(acc, a), b);
}

template <bool FUSED, int NC>
__global__ void __launch_bounds__(kFmaThreads)
fma_chain_kernel(const float* __restrict__ x, float* __restrict__ o, int n,
                 int inner, int blocks_per_step) {
  const int i = (blockIdx.x % blocks_per_step) * kFmaThreads + threadIdx.x;
  if (i >= n) return;
  const float xi = x[i];
  const float a = chain_step<FUSED>(xi, 1.000001f, 0.3f);
  const float b = chain_step<FUSED>(xi, 0.999999f, -0.3f);
  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = __fadd_rn(xi, (float)(0.01 * c));
#pragma unroll 4
  for (int it = 0; it < inner; ++it) {
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = chain_step<FUSED>(acc[c], a, b);
  }
  float out = acc[0];
#pragma unroll
  for (int c = 1; c < NC; ++c) out = __fadd_rn(out, acc[c]);
  o[i] = out;
}

template <bool FUSED>
cudaError_t launch_fma(const float* x, float* o, int n, int inner, int grid,
                       int n_chains, cudaStream_t s) {
  const int per_step = (n + kFmaThreads - 1) / kFmaThreads;
  const dim3 blocks(per_step * grid);
#define RT_FMA_CASE(NC)                                                    \
  case NC:                                                                 \
    fma_chain_kernel<FUSED, NC><<<blocks, kFmaThreads, 0, s>>>(            \
        x, o, n, inner, per_step);                                         \
    break;
  switch (n_chains) {
    RT_FMA_CASE(1) RT_FMA_CASE(2) RT_FMA_CASE(3) RT_FMA_CASE(4)
    RT_FMA_CASE(5) RT_FMA_CASE(6) RT_FMA_CASE(7) RT_FMA_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef RT_FMA_CASE
  return cudaGetLastError();
}

// ---- K9: the pair test's product -------------------------------------------
// Replaces tools/microbench_kernel.py:127 (the pallas_call in bench_matmul
// :102, body _mm_kernel :72). Per grid step s the TPU kernel forms
// P = coef[s % n_tab] (4 tc, k) x feats (k, br) at HIGHEST or DEFAULT
// precision, then either o = P[0] + 0.5 o, or the Moller-Trumbore
// epilogue: det, tdet, udet, vdet are the four tc-row blocks of P;
// accept det >= 1e-8, u, v in range, u + v <= 1, t >= 0; per column the
// least accepted t (3e38 if none) and its lowest row; o = min(t_min +
// row * 0, o). The TPU read o before writing it; here o starts as the
// caller's o_init.
//
// Hopper runs CTAs in no order, so one CTA takes one (step, column tile)
// and forms that step's product in registers, with the coef rows staged
// in shared memory a row group at a time (all four row blocks of the
// group, so the epilogue sees det, tdet, udet and vdet of a row
// together). With the epilogue the steps' minima combine with an atomic
// min on the bits as integers: tm >= 0 and t_min + 0 is never -0, so
// the order is valid for them; the wrapper rejects an o_init with its
// sign bit set or NaN. The result does not depend on the steps' order.
// Without it each CTA writes P[0] of its columns to scratch (n_steps,
// br), and a second kernel runs o = p_s + 0.5 o in step order.
//
// HIGHEST: f32 on the SIMT lanes, each product summed in k order with
// __fmul_rn / __fadd_rn (bit-equal to the plain version). DEFAULT: the
// TF32 tensor cores (nvcuda::wmma m16n16k8, inputs rounded by
// __float_to_tf32, k zero-padded to a multiple of 8), the Hopper
// counterpart of the TPU's DEFAULT-precision MXU pass; the tensor cores
// accumulate in an order of their own.
//
// Bound: operations, 2 x 4 tc x br x k per step (67 TFLOP/s f32 by the
// data sheet, which needs FMAs; the SIMT form issues a multiply and an
// add, so its own ceiling is half that; 495 TFLOP/s TF32), against the
// bytes of the tables, feats and o read once. The output without the
// epilogue reads one row of P, and nvcc would drop the other 4 tc - 1
// (and fold row * 0): a store of every row, guarded by a runtime flag
// that the probe never sets (keep), holds them live, as the TPU
// computed them.
constexpr int kMaxK = 128;
constexpr int kSimtCols = 128;  // one column per thread
constexpr int kSimtRows = 8;    // rows per row block in a staged group
constexpr int kTcCols = 64;     // 4 warps x 16 columns
constexpr int kTcRows = 16;     // one m16 tile per row block

struct PairArgs {
  const float* coef;   // (n_tab, 4 tc, k)
  const float* feats;  // (k, br)
  float* o;            // (br,), o_init on entry
  float* scratch;      // (n_steps, br) without the epilogue
  float* sink;         // written only when keep != 0
  int n_tab, tc, br, k, n_steps, keep;
};

// One row r of the epilogue; `best`/`best_row` keep the least accepted t
// and its lowest row (rows arrive in ascending order, so a strict < keeps
// the lowest of equal values).
__device__ __forceinline__ void epilogue_row(float det, float tdet,
                                             float udet, float vdet, int row,
                                             float& best, int& best_row) {
  bool ok = det >= 1e-8f;
  const float inv = 1.0f / (ok ? det : 1.0f);
  const float u = __fmul_rn(udet, inv);
  const float v = __fmul_rn(vdet, inv);
  const float t = __fmul_rn(tdet, inv);
  ok = ok && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
       __fadd_rn(u, v) <= 1.0f && t >= 0.0f;
  const float tm = ok ? t : 3.0e38f;
  if (tm < best) {
    best = tm;
    best_row = row;
  }
}

// o = min(t_min + row * 0, o): the sum makes a -0 t_min +0, so every
// value is >= +0 and its bits order as integers.
__device__ __forceinline__ void epilogue_store(const PairArgs& a, int col,
                                               float best, int best_row) {
  const float val = __fadd_rn(best, __fmul_rn((float)best_row, 0.0f));
  atomicMin(reinterpret_cast<int*>(a.o) + col, __float_as_int(val));
  if (a.keep) a.sink[col] = (float)best_row;
}

template <bool EPILOGUE>
__global__ void __launch_bounds__(kSimtCols) pair_simt_kernel(PairArgs a) {
  __shared__ float cs[4 * kSimtRows * kMaxK];
  const int col = blockIdx.x * kSimtCols + threadIdx.x;
  const int step = blockIdx.y;
  const float* coef = a.coef + (size_t)(step % a.n_tab) * 4 * a.tc * a.k;
  float best = 3.0e38f;
  int best_row = 0;
  float p0 = 0.0f;
  for (int r0 = 0; r0 < a.tc; r0 += kSimtRows) {
    __syncthreads();
    // Staged row q = blk * kSimtRows + j is P's row blk * tc + r0 + j.
    for (int e = threadIdx.x; e < 4 * kSimtRows * a.k; e += kSimtCols) {
      const int q = e / a.k, kk = e - q * a.k;
      const int row = (q / kSimtRows) * a.tc + r0 + q % kSimtRows;
      cs[e] = coef[(size_t)row * a.k + kk];
    }
    __syncthreads();
    float acc[4 * kSimtRows];
    {
      const float f = a.feats[col];
#pragma unroll
      for (int q = 0; q < 4 * kSimtRows; ++q) acc[q] = __fmul_rn(cs[q * a.k], f);
    }
    for (int kk = 1; kk < a.k; ++kk) {
      const float f = a.feats[(size_t)kk * a.br + col];
#pragma unroll
      for (int q = 0; q < 4 * kSimtRows; ++q)
        acc[q] = __fadd_rn(acc[q], __fmul_rn(cs[q * a.k + kk], f));
    }
    if (a.keep) {
#pragma unroll
      for (int q = 0; q < 4 * kSimtRows; ++q)
        a.sink[(size_t)q * a.br + col] = acc[q];
    }
    if (EPILOGUE) {
#pragma unroll
      for (int j = 0; j < kSimtRows; ++j)
        epilogue_row(acc[j], acc[kSimtRows + j], acc[2 * kSimtRows + j],
                     acc[3 * kSimtRows + j], r0 + j, best, best_row);
    } else if (r0 == 0) {
      p0 = acc[0];
    }
  }
  if (EPILOGUE) {
    epilogue_store(a, col, best, best_row);
  } else {
    a.scratch[(size_t)step * a.br + col] = p0;
  }
}

template <bool EPILOGUE>
__global__ void __launch_bounds__(128) pair_tf32_kernel(PairArgs a, int kp) {
  using namespace nvcuda;
  extern __shared__ __align__(128) float smem[];
  float* as = smem;                      // (4 * kTcRows, kp): the row group
  float* bs = as + 4 * kTcRows * kp;     // (kp, kTcCols): this CTA's feats
  float* cs = bs + kp * kTcCols;         // (4 * kTcRows, kTcCols): P's rows
  const int warp = threadIdx.x / 32;
  const int col0 = blockIdx.x * kTcCols;
  const int step = blockIdx.y;
  const float* coef = a.coef + (size_t)(step % a.n_tab) * 4 * a.tc * a.k;
  for (int e = threadIdx.x; e < kp * kTcCols; e += blockDim.x) {
    const int kk = e / kTcCols, c = e - kk * kTcCols;
    bs[e] = kk < a.k
                ? wmma::__float_to_tf32(a.feats[(size_t)kk * a.br + col0 + c])
                : 0.0f;
  }
  float best = 3.0e38f;
  int best_row = 0;
  float p0 = 0.0f;
  for (int r0 = 0; r0 < a.tc; r0 += kTcRows) {
    __syncthreads();
    // Staged row q = blk * kTcRows + j is P's row blk * tc + r0 + j.
    for (int e = threadIdx.x; e < 4 * kTcRows * kp; e += blockDim.x) {
      const int q = e / kp, kk = e - q * kp;
      const int row = (q / kTcRows) * a.tc + r0 + q % kTcRows;
      as[e] = kk < a.k ? wmma::__float_to_tf32(coef[(size_t)row * a.k + kk])
                       : 0.0f;
    }
    __syncthreads();
    wmma::fragment<wmma::accumulator, 16, 16, 8, float> acc[4];
#pragma unroll
    for (int blk = 0; blk < 4; ++blk) wmma::fill_fragment(acc[blk], 0.0f);
    for (int kk = 0; kk < kp; kk += 8) {
      wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32,
                     wmma::row_major> fb;
      wmma::load_matrix_sync(fb, bs + kk * kTcCols + warp * 16, kTcCols);
#pragma unroll
      for (int blk = 0; blk < 4; ++blk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32,
                       wmma::row_major> fa;
        wmma::load_matrix_sync(fa, as + blk * kTcRows * kp + kk, kp);
        wmma::mma_sync(acc[blk], fa, fb, acc[blk]);
      }
    }
#pragma unroll
    for (int blk = 0; blk < 4; ++blk)
      wmma::store_matrix_sync(cs + blk * kTcRows * kTcCols + warp * 16,
                              acc[blk], kTcCols, wmma::mem_row_major);
    __syncthreads();
    if (a.keep) {
      for (int e = threadIdx.x; e < 4 * kTcRows * kTcCols; e += blockDim.x)
        a.sink[(size_t)(e / kTcCols) * a.br + col0 + e % kTcCols] = cs[e];
    }
    if (threadIdx.x < kTcCols) {
      const int c = threadIdx.x;
      if (EPILOGUE) {
        for (int j = 0; j < kTcRows; ++j)
          epilogue_row(cs[j * kTcCols + c], cs[(kTcRows + j) * kTcCols + c],
                       cs[(2 * kTcRows + j) * kTcCols + c],
                       cs[(3 * kTcRows + j) * kTcCols + c], r0 + j, best,
                       best_row);
      } else if (r0 == 0) {
        p0 = cs[c];
      }
    }
  }
  if (threadIdx.x < kTcCols) {
    const int col = col0 + threadIdx.x;
    if (EPILOGUE) {
      epilogue_store(a, col, best, best_row);
    } else {
      a.scratch[(size_t)step * a.br + col] = p0;
    }
  }
}

// o = p_s + 0.5 o for s in step order, one column per thread.
__global__ void pair_recurrence_kernel(const float* __restrict__ scratch,
                                       float* __restrict__ o, int br,
                                       int n_steps) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= br) return;
  float v = o[col];
  for (int s = 0; s < n_steps; ++s)
    v = __fadd_rn(scratch[(size_t)s * br + col], __fmul_rn(v, 0.5f));
  o[col] = v;
}

template <bool EPILOGUE>
cudaError_t launch_pair(const PairArgs& a, bool tf32, cudaStream_t s) {
  if (tf32) {
    const int kp = (a.k + 7) / 8 * 8;
    const size_t smem =
        sizeof(float) * (4 * kTcRows * kp + kp * kTcCols + 4 * kTcRows * kTcCols);
    cudaError_t err = cudaFuncSetAttribute(
        pair_tf32_kernel<EPILOGUE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    pair_tf32_kernel<EPILOGUE>
        <<<dim3(a.br / kTcCols, a.n_steps), 128, smem, s>>>(a, kp);
  } else {
    pair_simt_kernel<EPILOGUE>
        <<<dim3(a.br / kSimtCols, a.n_steps), kSimtCols, 0, s>>>(a);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || EPILOGUE) return err;
  pair_recurrence_kernel<<<(a.br + 127) / 128, 128, 0, s>>>(a.scratch, a.o,
                                                           a.br, a.n_steps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K8: n_steps CTAs; CTA 0 copies x (n floats) to o.
int mb_grid_overhead(const void* x, void* o, int n, int n_steps,
                     void* stream) {
  if (n < 0 || n_steps < 1) return (int)cudaErrorInvalidValue;
  grid_overhead_kernel<<<n_steps, kOverheadThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)o, n);
  return (int)cudaGetLastError();
}

// K7: the chains over n elements of x, the block recomputed grid times.
int mb_fma_chain(const void* x, void* o, int n, int inner, int grid,
                 int n_chains, int fused, void* stream) {
  if (n < 1 || inner < 0 || grid < 1 || n_chains < 1 ||
      n_chains > kMaxChains ||
      (long long)((n + kFmaThreads - 1) / kFmaThreads) * grid > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(fused ? launch_fma<true>((const float*)x, (float*)o, n, inner,
                                        grid, n_chains, s)
                     : launch_fma<false>((const float*)x, (float*)o, n, inner,
                                         grid, n_chains, s));
}

// K9: n_steps products coef[s % n_tab] (4 tc, k) x feats (k, br) into o
// (br,), which holds o_init on entry. tf32 selects the tensor-core form;
// epilogue the Moller-Trumbore epilogue (o >= +0 on entry, no NaN), else
// scratch (n_steps, br) takes P[0] per step. keep != 0 writes each row
// group's product rows into sink (64, br), overwritten group by group.
int mb_pair_product(const void* coef, const void* feats, void* o,
                    void* scratch, void* sink, int n_tab, int tc, int br,
                    int k, int n_steps, int tf32, int epilogue, int keep,
                    void* stream) {
  const int row_group = tf32 ? kTcRows : kSimtRows;
  const int col_tile = tf32 ? kTcCols : kSimtCols;
  if (n_tab < 1 || tc < row_group || tc % row_group || br < col_tile ||
      br % col_tile || k < 1 || k > kMaxK || n_steps < 1 ||
      n_steps > 65535 || (!epilogue && scratch == nullptr) ||
      (keep && sink == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const PairArgs a{(const float*)coef, (const float*)feats, (float*)o,
                   (float*)scratch, (float*)sink, n_tab, tc, br, k, n_steps,
                   keep};
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(epilogue ? launch_pair<true>(a, tf32 != 0, s)
                        : launch_pair<false>(a, tf32 != 0, s));
}

const char* mb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
