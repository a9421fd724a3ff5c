// Hardware-ceiling probes for Hopper (sm_90a): the f32 issue rate with
// and without FMA (K7), the cost of a grid's steps (K8), and the pair
// test's product in f32 on the SIMT lanes and in TF32 on the tensor
// cores (K9). They replace the three Pallas probes of the JAX package's
// tools/microbench_vpu.py and tools/microbench_kernel.py, and give the
// port measured ceilings in place of the data sheet's: ops/microbench.py's
// F32_OPS_RATE and HBM_RATE, and the bounds of mesh_intersect.cu.
//
// K8 comes in two forms: `grid_overhead_kernel` carries the TPU grid over
// block by block (one CTA per grid step), `grid_overhead_loop_kernel`
// takes the sequential grid as a loop inside persistent CTAs. K9 takes
// its grid as such a loop: `pair_simt_kernel` (a register-tiled outer
// product) and `pair_wgmma_kernel` (wgmma on tables streamed by bulk
// copies). K9's first form, one CTA per step and column tile, lost to
// them on every configuration measured (PERF.md section 6) and is gone.
//
// Built with the flags of mesh_intersect.cu (-fmad=false, IEEE division),
// so a multiply and an add that the source writes apart stay apart.
// Every C entry point returns the launch's cudaError_t (0 on success).

#include <cuda_runtime.h>
#include <mma.h>

#include <algorithm>
#include <cstdint>

namespace {

// ---- K8: per-CTA and per-step cost -----------------------------------------
// Replaces tools/microbench_kernel.py:61 (the pallas_call in
// bench_grid_overhead :36, body :40): a grid of n_steps sequential steps
// that revisit one (8, br) block, step 0 copying x to o.
//
// grid_overhead_kernel (the first form): the steps become n_steps CTAs of
// one launch, in no order; CTA 0 copies the block and the others return
// at once. It measures launch latency and the block scheduler's cost per
// CTA, a ceiling of its own (a launch of one CTA gives the first alone).
//
// grid_overhead_loop_kernel (the TPU probe's form): one CTA per SM; step s
// is taken by CTA s mod gridDim.x, and each step ends at a __syncthreads(),
// the boundary of a step of the TPU's sequential grid; the CTA holding
// step 0 copies the block. It measures the cost of one step of a loop
// inside the block. Bound of both: launch latency; the data is
// 2 x 8 * br * 4 bytes. The copy loads 8 float4 a thread before it stores
// any, so it costs about one round trip to memory.
constexpr int kOverheadThreads = 256;
constexpr int kCopyBatch = 8;

__device__ __forceinline__ void copy_block(const float* __restrict__ x,
                                           float* __restrict__ o, int n) {
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

__global__ void __launch_bounds__(kOverheadThreads)
grid_overhead_kernel(const float* __restrict__ x, float* __restrict__ o,
                     int n) {
  if (blockIdx.x != 0) return;
  copy_block(x, o, n);
}

__global__ void __launch_bounds__(kOverheadThreads)
grid_overhead_loop_kernel(const float* __restrict__ x, float* __restrict__ o,
                          int n, int n_steps) {
  for (int s = blockIdx.x; s < n_steps; s += gridDim.x) {
    if (s == 0) copy_block(x, o, n);
    __syncthreads();
  }
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
// Hopper runs CTAs in no order. With the epilogue the steps' minima
// combine with an atomic min on the bits as integers: tm >= 0 and
// t_min + 0 is never -0, so the order is valid for them; the wrapper
// rejects an o_init with its sign bit set or NaN. The min of values >= +0
// is order-free, so the result does not depend on the steps' order, nor
// on how a CTA folds the rows and steps it holds before its atomic.
// Without it P[0] of each step goes to scratch (n_steps, br), and a second
// kernel runs o = p_s + 0.5 o in step order.
//
// HIGHEST: f32 on the SIMT lanes, each product summed in k order with
// __fmul_rn / __fadd_rn (bit-equal to the plain version; k is never padded,
// since -0 + 0 * f is +0). DEFAULT: the TF32 tensor cores, inputs rounded
// by __float_to_tf32 (cvt.rna), k zero-padded to kp, a multiple of 8; the
// tensor cores accumulate in an order of their own.
//
// Bound: operations, 2 x 4 tc x br x k per step (67 TFLOP/s f32 by the
// data sheet, which needs FMAs; the SIMT form issues a multiply and an add,
// so its own ceiling is half that; 495 TFLOP/s TF32), plus the epilogue's
// kEpilogueOps SIMT instructions per (row, column) and step, against the
// bytes of the tables, feats and o read once. The output without the
// epilogue reads one row of P, and nvcc would drop the other 4 tc - 1 (and
// fold row * 0): a store of every row, guarded by a runtime flag that the
// probe never sets (keep), holds them live, as the TPU computed them.
constexpr int kMaxK = 128;

// The epilogue's instructions per (row, column) pair, from epilogue_row:
// det >= 1e-8 (1 compare), ok ? det : 1 (1 select), the IEEE reciprocal
// (MUFU.RCP and 3 refinement instructions), u, v, t (3 multiplies),
// u >= 0, u <= 1, v >= 0 (3 compares), u + v (1 add) and its compare,
// t >= 0 (1 compare), ok ? t : 3e38 (1 select), tm < best (1 compare)
// and its two selects. Predicate logic and the row's index are left out,
// so it stays a lower bound.
constexpr int kEpilogueOps = 1 + 1 + 4 + 3 + 3 + 1 + 1 + 1 + 1 + 1 + 2;

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

// t_min + row * 0: the sum makes a -0 t_min +0, so every value is >= +0
// and its bits order as integers.
__device__ __forceinline__ float epilogue_value(float best, int best_row) {
  return __fadd_rn(best, __fmul_rn((float)best_row, 0.0f));
}

__device__ __forceinline__ float min_nonneg(float a, float b) {
  return b < a ? b : a;
}

__device__ __forceinline__ void epilogue_store(const PairArgs& a, int col,
                                               float val, int best_row) {
  atomicMin(reinterpret_cast<int*>(a.o) + col, __float_as_int(val));
  if (a.keep) a.sink[col] = (float)best_row;
}

// ---- K9, HIGHEST: a register-tiled outer product ---------------------------
// A persistent grid: CTA b takes column tile b % n_ct (kSimtCols columns)
// and steps b / n_ct, b / n_ct + s_par, ... (s_par = gridDim.x / n_ct), so
// the grid is as many CTAs as fit on the card, not n_steps x (br / 128).
// Its feats tile (k, kSimtCols) is staged once. The step's table streams
// through shared memory in chunks of kSimtChunk rows of each of the four
// row blocks, transposed to (k, 4 kSimtChunk) so that four consecutive
// rows of a block are one 16-byte load, double-buffered by 4-byte
// cp.async copies (the transpose rules out 16-byte ones) issued one chunk
// ahead. Warp w owns rows 4w .. 4w + 3 of each block of the chunk; lane l
// owns columns 4l .. 4l + 3. Per k a thread loads 4 float4 of coef (one
// per block; the warp reads one address, a broadcast) and 1 float4 of
// feats, then issues 64 multiplies and 64 adds: 5 shared loads per 128
// f32 operations. The epilogue runs on the 64 accumulators in registers:
// det, tdet, udet and vdet of a (row, column) sit in one thread. Each thread folds its rows of a step into
// (best, best_row) and the steps into one running min per column; the
// warps' minima meet in shared memory and one atomicMin a column ends the
// CTA. Without the epilogue warp 0 (row 0 of block 0) writes P[0].
// sink is (4 kSimtChunk, br), overwritten chunk by chunk.
constexpr int kSimtThreads = 256;
constexpr int kSimtCols = 128;      // 32 lanes x 4 columns
constexpr int kSimtChunk = 32;      // rows a block in a staged chunk
constexpr int kSimtRows = 4;        // rows a block a thread
constexpr int kSimtStride = 4 * kSimtChunk + 4;  // a staged k row, padded

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <bool EPILOGUE>
__global__ void __launch_bounds__(kSimtThreads, 2)
pair_simt_kernel(PairArgs a, int n_ct) {
  extern __shared__ __align__(16) float smem[];
  float* fs = smem;                                  // (k, kSimtCols)
  float* cs = fs + a.k * kSimtCols;                  // 2 x (k, kSimtStride)
  const int chunk_floats = a.k * kSimtStride;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col0 = (blockIdx.x % n_ct) * kSimtCols;
  const int s_par = gridDim.x / n_ct;
  const int first = blockIdx.x / n_ct;
  const int n_chunks = a.tc / kSimtChunk;
  const int my_steps = first < a.n_steps
                           ? (a.n_steps - first + s_par - 1) / s_par : 0;
  const int total = my_steps * n_chunks;

  for (int e = threadIdx.x; e < a.k * kSimtCols; e += kSimtThreads) {
    const int kk = e / kSimtCols;
    fs[e] = a.feats[(size_t)kk * a.br + col0 + (e - kk * kSimtCols)];
  }
  // Chunk i: step first + (i / n_chunks) s_par, rows (i % n_chunks) x
  // kSimtChunk of each block. Thread t copies staged row q = t % 128
  // (block q / 32, row q % 32) at k = t / 128, t / 128 + 2, ...
  auto load = [&](int i) {
    const int step = first + (i / n_chunks) * s_par;
    const int r0 = (i % n_chunks) * kSimtChunk;
    const int q = threadIdx.x % (4 * kSimtChunk);
    const int row = (q / kSimtChunk) * a.tc + r0 + q % kSimtChunk;
    const float* src = a.coef +
                       ((size_t)(step % a.n_tab) * 4 * a.tc + row) * a.k;
    float* dst = cs + (i & 1) * chunk_floats + q;
    for (int kk = threadIdx.x / (4 * kSimtChunk); kk < a.k; kk += 2)
      cp_async4(dst + kk * kSimtStride, src + kk);
  };
  if (total > 0) load(0);
  cp_async_commit();

  float best[4], run[4];
  int best_row[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    best[c] = 3.0e38f;
    best_row[c] = 0;
    run[c] = 3.0e38f;
  }
  for (int i = 0; i < total; ++i) {
    if (i + 1 < total) load(i + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const int chunk = i % n_chunks;
    const float* cb = cs + (i & 1) * chunk_floats + warp * kSimtRows;
    float acc[4][kSimtRows][4];  // [block][row][column]
    {
      const float4 f = *reinterpret_cast<const float4*>(fs + lane * 4);
#pragma unroll
      for (int blk = 0; blk < 4; ++blk) {
        const float4 c4 =
            *reinterpret_cast<const float4*>(cb + blk * kSimtChunk);
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int j = 0; j < kSimtRows; ++j) {
          acc[blk][j][0] = __fmul_rn(cv[j], f.x);
          acc[blk][j][1] = __fmul_rn(cv[j], f.y);
          acc[blk][j][2] = __fmul_rn(cv[j], f.z);
          acc[blk][j][3] = __fmul_rn(cv[j], f.w);
        }
      }
    }
    for (int kk = 1; kk < a.k; ++kk) {
      const float4 f =
          *reinterpret_cast<const float4*>(fs + kk * kSimtCols + lane * 4);
      const float* ck = cb + kk * kSimtStride;
#pragma unroll
      for (int blk = 0; blk < 4; ++blk) {
        const float4 c4 =
            *reinterpret_cast<const float4*>(ck + blk * kSimtChunk);
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int j = 0; j < kSimtRows; ++j) {
          acc[blk][j][0] = __fadd_rn(acc[blk][j][0], __fmul_rn(cv[j], f.x));
          acc[blk][j][1] = __fadd_rn(acc[blk][j][1], __fmul_rn(cv[j], f.y));
          acc[blk][j][2] = __fadd_rn(acc[blk][j][2], __fmul_rn(cv[j], f.z));
          acc[blk][j][3] = __fadd_rn(acc[blk][j][3], __fmul_rn(cv[j], f.w));
        }
      }
    }
    if (a.keep) {
#pragma unroll
      for (int blk = 0; blk < 4; ++blk)
#pragma unroll
        for (int j = 0; j < kSimtRows; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            a.sink[(size_t)(blk * kSimtChunk + warp * kSimtRows + j) * a.br +
                   col0 + lane * 4 + c] = acc[blk][j][c];
    }
    const int step = first + (i / n_chunks) * s_par;
    if (EPILOGUE) {
      const int r = chunk * kSimtChunk + warp * kSimtRows;
#pragma unroll
      for (int j = 0; j < kSimtRows; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          epilogue_row(acc[0][j][c], acc[1][j][c], acc[2][j][c], acc[3][j][c],
                       r + j, best[c], best_row[c]);
      if (chunk == n_chunks - 1) {  // the step's end: fold it, start anew
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          run[c] = min_nonneg(run[c], epilogue_value(best[c], best_row[c]));
          best[c] = 3.0e38f;
          best_row[c] = 0;
        }
      }
    } else if (chunk == 0 && warp == 0) {
      *reinterpret_cast<float4*>(a.scratch + (size_t)step * a.br + col0 +
                                 lane * 4) =
          make_float4(acc[0][0][0], acc[0][0][1], acc[0][0][2], acc[0][0][3]);
    }
    __syncthreads();  // buffer i & 1 is free for chunk i + 2
  }
  if (EPILOGUE && total > 0) {
    float* red = cs;  // (8 warps, kSimtCols), free after the loop
#pragma unroll
    for (int c = 0; c < 4; ++c) red[warp * kSimtCols + lane * 4 + c] = run[c];
    __syncthreads();
    if (threadIdx.x < kSimtCols) {
      float v = red[threadIdx.x];
      for (int w = 1; w < kSimtThreads / 32; ++w)
        v = min_nonneg(v, red[w * kSimtCols + threadIdx.x]);
      epilogue_store(a, col0 + threadIdx.x, v, best_row[0]);
    }
  }
}

// ---- K9, DEFAULT: wgmma on streamed tables ----------------------------------
// The tables are packed once per call (pack_tf32_kernel, counted in K9's
// time): each (n_tab, 4 tc, k) table is rounded by __float_to_tf32,
// zero-padded to kp = roundup(k, 8) and written as the shared-memory image
// that wgmma reads, in chunks of kWgN rows of each of the four row blocks
// (chunk c holds rows c kWgN .. c kWgN + kWgN - 1 of det, tdet, udet and
// vdet in turn). Inside a chunk the layout is wgmma's K-major one without
// swizzle: core matrices of 8 rows x 4 values (128 contiguous bytes),
// ordered by row group, then by k / 4. A chunk is contiguous, so one bulk
// copy (the TMA's non-tensor form; a coef row at k = 13 is 52 bytes, which
// a tensor map's 16-byte strides cannot take) moves it, and the packed
// layout is that copy's only requirement.
//
// Each CTA is persistent: column tile b % n_ct of WGS x 64 columns, steps
// b / n_ct, b / n_ct + s_par, ... Its feats tile is written once,
// transposed to (columns, kp) in the same image layout and rounded.
// Thread 0 streams the chunks of its steps through a ring of n_stages
// shared-memory stages (an mbarrier `full` per stage completed by the
// copy's bytes, one `empty` per stage released by every warp), refilling
// a stage one load after its release. A stage holds `group` consecutive
// chunks of a step, as many as fit in kWgStageBytes (a whole table at
// tc 256, kp 16): on an H100 a bulk copy took ~0.8 us whatever its size
// from 8 to 64 KB and however deep the ring, so one copy a chunk held the
// kernel to ~0.8 us a chunk. Thread 0 is no warp of its own: ptxas
// sizes a wgmma kernel's registers by whole warpgroups, so a producer warp
// costs a warpgroup's registers. Each of the WGS warpgroups (4, or 2 where
// k > 64 leaves no room for a wider feats tile) owns one M-tile of 64
// columns: per chunk it issues 4 x kp / 8 wgmma m64n32k8 (A = its feats
// columns, B = one row block's 32 rows of the chunk), so det, tdet, udet
// and vdet of a (column, row) land in the same register of four
// accumulators of one thread: the epilogue runs on registers, and four
// warpgroups an SM (16 warps) hide its latencies and each other's waits
// for the tensor cores. A thread holds 2 columns x 8 rows a chunk; it
// folds rows and steps into one running min per column, and the 4 lanes
// sharing a column meet by shuffles before one atomicMin a column. Without
// the epilogue the lanes holding row 0 of block 0 write P[0]. The stages
// (rows tiled by chunks of 32) keep k = 128 and tc = 512 tables, 256 KB
// and more, out of the need to fit. sink is (4 kWgN, br), overwritten
// chunk by chunk.
constexpr int kWgN = 32;           // rows a block in a chunk: wgmma's N
constexpr int kWgM = 64;           // columns an M-tile: wgmma's M
constexpr int kWgMaxGroups = 4;    // warpgroups a CTA, one M-tile each
constexpr int kWgMaxStages = 4;
constexpr int kWgStageBytes = 65536;  // a stage's most: a table at kp 16
constexpr int kSmemLimit = 232448;  // a block's dynamic shared memory

__global__ void pack_tf32_kernel(const float* __restrict__ coef,
                                 float* __restrict__ packed, int n_tab, int tc,
                                 int k, int kp) {
  const int per_table = 4 * tc * kp;
  const int total = n_tab * per_table;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int t = i / per_table, e = i - t * per_table;
    const int rest = e >> 5;               // row group x (kp / 4) + k / 4
    const int kk = (rest % (kp >> 2)) * 4 + (e & 3);
    const int q = (rest / (kp >> 2)) * 8 + ((e >> 2) & 7);
    const int chunk = q / (4 * kWgN), w = q - chunk * 4 * kWgN;
    const int row = (w / kWgN) * tc + chunk * kWgN + w % kWgN;
    packed[i] = kk < k ? nvcuda::wmma::__float_to_tf32(
                             coef[((size_t)t * 4 * tc + row) * k + kk])
                       : 0.0f;
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits for the phase of parity `parity` to complete. A protocol fault
// would spin for ever: after ~2^32 cycles (about 2 s) the kernel traps, so
// the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    if (clock64() - t0 > (1ll << 32)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A wgmma shared-memory descriptor: K-major, no swizzle; the leading byte
// offset (between the two core matrices of a k8 slice, along k) is 128,
// the stride byte offset (between row groups of 8) sbo.
__device__ __forceinline__ uint64_t wg_desc(const float* p, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma (CUTLASS's warpgroup_fence_operand).
__device__ __forceinline__ void fence_acc(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 32, f32) = A (64 x 8) B (8 x 32) + (scale_d ? D : 0), TF32.
__device__ __forceinline__ void wgmma_m64n32k8(float (&d)[16], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <bool EPILOGUE, int WGS, int KP>
__global__ void __launch_bounds__(128 * WGS, 1)
pair_wgmma_kernel(PairArgs a, const float* __restrict__ packed, int kp_arg,
                  int n_ct, int n_stages, int group) {
  constexpr int kCols = WGS * kWgM;
  const int kp = KP ? KP : kp_arg;
  extern __shared__ __align__(128) float smem[];
  float* ft = smem;                          // feats^T image (kCols, kp)
  float* stages = ft + kCols * kp;           // n_stages x group chunks
  const int chunk_floats = 4 * kWgN * kp;
  const int stage_floats = group * chunk_floats;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(stages + n_stages * stage_floats);
  uint64_t* empty = full + kWgMaxStages;
  const int col0 = (blockIdx.x % n_ct) * kCols;
  const int s_par = gridDim.x / n_ct;
  const int first = blockIdx.x / n_ct;
  const int n_chunks = a.tc / kWgN;
  const int my_steps = first < a.n_steps
                           ? (a.n_steps - first + s_par - 1) / s_par : 0;
  const int groups = n_chunks / group;      // a step's stage loads
  const int total = my_steps * groups;

  for (int e = threadIdx.x; e < kCols * kp; e += 128 * WGS) {
    const int rest = e >> 5;
    const int kk = (rest % (kp >> 2)) * 4 + (e & 3);
    const int col = (rest / (kp >> 2)) * 8 + ((e >> 2) & 7);
    ft[e] = kk < a.k ? nvcuda::wmma::__float_to_tf32(
                           a.feats[(size_t)kk * a.br + col0 + col])
                     : 0.0f;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < n_stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WGS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The feats image was written by the threads; wgmma reads it through
  // the async proxy.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // Thread 0 fills the ring: load i (chunks (i % groups) x group .. of
  // step first + (i / groups) s_par) goes to stage i % n_stages once the
  // warps have released that stage's previous load.
  auto issue = [&](int i) {
    const int s = i % n_stages;
    mbar_wait(&empty[s], ((i / n_stages) & 1) ^ 1);
    const int step = first + (i / groups) * s_par;
    const float* src =
        packed + ((size_t)(step % a.n_tab) * n_chunks + (i % groups) * group) *
                     chunk_floats;
    mbar_expect_tx(&full[s], stage_floats * 4);
    bulk_copy(stages + s * stage_floats, src, stage_floats * 4, &full[s]);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < min(total, n_stages); ++i) issue(i);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, wq = warp % 4;
  const uint32_t sbo = 32 * kp;  // bytes between row groups of 8
  const float* at = ft + wg * kWgM * kp;  // this warpgroup's M-tile
  // Accumulator element 4 ii + 2 h + e is P's column c_h = col0 + 64 wg +
  // 16 wq + lane / 4 + 8 h and row 8 ii + 2 (lane % 4) + e of the chunk.
  const int c0 = col0 + wg * kWgM + 16 * wq + lane / 4;
  float best[2], run[2];
  int best_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    best[h] = 3.0e38f;
    best_row[h] = 0;
    run[h] = 3.0e38f;
  }

  // Chunk i: load i / group, in stage (i / group) % n_stages. The warp-
  // group waits for each chunk's wgmma group before its epilogue (two
  // accumulator sets, chunk i + 1's MMAs under chunk i's epilogue, took 2x
  // as long on an H100: they fit only two warpgroups a CTA, and
  // 128-column tiles copy each table twice as often).
  float acc[4][16] = {};
  for (int i = 0; i < total * group; ++i) {
    const int load = i / group, in_load = i - load * group;
    const int s = load % n_stages;
    if (in_load == 0) {
      mbar_wait(&full[s], (load / n_stages) & 1);
      __syncwarp();
    }
    const float* st = stages + s * stage_floats + in_load * chunk_floats;
#pragma unroll
    for (int blk = 0; blk < 4; ++blk) fence_acc(acc[blk]);
    wgmma_fence();
#pragma unroll
    for (int blk = 0; blk < 4; ++blk) {
      const float* bt = st + blk * kWgN * kp;
#pragma unroll
      for (int j = 0; j < kp / 8; ++j)
        wgmma_m64n32k8(acc[blk], wg_desc(at + 64 * j, sbo),
                       wg_desc(bt + 64 * j, sbo), j > 0);
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int blk = 0; blk < 4; ++blk) fence_acc(acc[blk]);
    if (in_load == group - 1) {  // the stage is free: refill it
      if (lane == 0) mbar_arrive(&empty[s]);
      if (threadIdx.x == 0 && load + n_stages < total) issue(load + n_stages);
      __syncwarp();
    }

    const int chunk = (load % groups) * group + in_load;
    const int step = first + (load / groups) * s_par;
    if (a.keep) {
#pragma unroll
      for (int blk = 0; blk < 4; ++blk)
#pragma unroll
        for (int idx = 0; idx < 16; ++idx) {
          const int row = blk * kWgN + 8 * (idx / 4) + 2 * (lane % 4) +
                          idx % 2;
          a.sink[(size_t)row * a.br + c0 + 8 * ((idx / 2) % 2)] =
              acc[blk][idx];
        }
    }
    if (EPILOGUE) {
      const int r = chunk * kWgN + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * ii + 2 * h + e;
            epilogue_row(acc[0][idx], acc[1][idx], acc[2][idx], acc[3][idx],
                         r + 8 * ii + e, best[h], best_row[h]);
          }
      if (chunk == n_chunks - 1) {  // the step's end: fold it, start anew
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          run[h] = min_nonneg(run[h], epilogue_value(best[h], best_row[h]));
          best[h] = 3.0e38f;
          best_row[h] = 0;
        }
      }
    } else if (chunk == 0 && lane % 4 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a.scratch[(size_t)step * a.br + c0 + 8 * h] = acc[0][2 * h];
    }
  }
  if (EPILOGUE && total > 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = run[h];
      v = min_nonneg(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = min_nonneg(v, __shfl_xor_sync(0xffffffffu, v, 2));
      if (lane % 4 == 0) epilogue_store(a, c0 + 8 * h, v, best_row[h]);
    }
  }
}

// o = p_s + 0.5 o for s in step order, one column per thread, with the
// loads of kRecUnroll steps issued before their adds (they do not depend
// on o), so a thread waits for memory once per kRecUnroll steps. Bound: the bytes of
// scratch read once.
constexpr int kRecUnroll = 16;

__global__ void pair_recurrence_kernel(const float* __restrict__ scratch,
                                       float* __restrict__ o, int br,
                                       int n_steps) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= br) return;
  float v = o[col];
  int s = 0;
  for (; s + kRecUnroll <= n_steps; s += kRecUnroll) {
    float p[kRecUnroll];
#pragma unroll
    for (int j = 0; j < kRecUnroll; ++j)
      p[j] = scratch[(size_t)(s + j) * br + col];
#pragma unroll
    for (int j = 0; j < kRecUnroll; ++j)
      v = __fadd_rn(p[j], __fmul_rn(v, 0.5f));
  }
  for (; s < n_steps; ++s)
    v = __fadd_rn(scratch[(size_t)s * br + col], __fmul_rn(v, 0.5f));
  o[col] = v;
}

// The persistent grid: n_ct column tiles x s_par step strides, as many
// CTAs as fit on the card at once (fewer when there are fewer steps).
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem,
                            int n_ct, int n_steps, int* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int s_par = std::max(1, std::min(n_steps, per_sm * sms / n_ct));
  *grid = n_ct * s_par;
  return cudaSuccess;
}

template <bool EPILOGUE>
cudaError_t launch_simt(const PairArgs& a, cudaStream_t s) {
  // The staged chunks' room also holds the final (8 warps, kSimtCols)
  // minima.
  const size_t smem =
      sizeof(float) * ((size_t)a.k * kSimtCols +
                       std::max(2 * a.k * kSimtStride,
                                kSimtThreads / 32 * kSimtCols));
  const int n_ct = a.br / kSimtCols;
  int grid = 0;
  cudaError_t err = persistent_grid(pair_simt_kernel<EPILOGUE>, kSimtThreads,
                                    smem, n_ct, a.n_steps, &grid);
  if (err != cudaSuccess) return err;
  pair_simt_kernel<EPILOGUE><<<grid, kSimtThreads, smem, s>>>(a, n_ct);
  return cudaGetLastError();
}

template <bool EPILOGUE, int WGS, int KP>
cudaError_t launch_wgmma(const PairArgs& a, const float* packed,
                         cudaStream_t s) {
  constexpr int kCols = WGS * kWgM;
  const int kp = (a.k + 7) / 8 * 8;
  const size_t fbytes = sizeof(float) * kCols * kp;
  const size_t chunk_bytes = sizeof(float) * 4 * kWgN * kp;
  const size_t bars = 2 * kWgMaxStages * sizeof(uint64_t);
  // A bulk copy costs about the same time (~0.8 us on an H100) whatever
  // its size from 8 to 64 KB, so a stage takes as many of a step's chunks
  // as fit in kWgStageBytes and divide the step's count.
  const int n_chunks = a.tc / kWgN;
  int group = 1;
  for (int g = 1; g <= n_chunks; ++g)
    if (n_chunks % g == 0 && g * chunk_bytes <= (size_t)kWgStageBytes)
      group = g;
  const size_t stage_bytes = group * chunk_bytes;
  if (fbytes + 2 * stage_bytes + bars > (size_t)kSmemLimit)
    return cudaErrorInvalidValue;
  const int n_stages = (int)std::min<size_t>(
      kWgMaxStages, (kSmemLimit - fbytes - bars) / stage_bytes);
  const size_t smem = fbytes + n_stages * stage_bytes + bars;
  const int n_ct = a.br / kCols;
  int grid = 0;
  cudaError_t err = persistent_grid(pair_wgmma_kernel<EPILOGUE, WGS, KP>,
                                    128 * WGS, smem, n_ct, a.n_steps, &grid);
  if (err != cudaSuccess) return err;
  pair_wgmma_kernel<EPILOGUE, WGS, KP>
      <<<grid, 128 * WGS, smem, s>>>(a, packed, kp, n_ct, n_stages, group);
  return cudaGetLastError();
}

// Without the epilogue the caller runs pair_recurrence_kernel after it
// (mb_pair_recurrence).
template <bool EPILOGUE>
cudaError_t launch_pair(const PairArgs& a, const float* packed, bool tf32,
                        cudaStream_t s) {
  if (!tf32) return launch_simt<EPILOGUE>(a, s);
  // Four warpgroups (256 columns) where their feats tile leaves room for
  // two stages, else two; the tool's k = 13 (kp 16) with the k loop
  // unrolled.
  if (a.k > 64) return launch_wgmma<EPILOGUE, 2, 0>(a, packed, s);
  if ((a.k + 7) / 8 * 8 == 16)
    return launch_wgmma<EPILOGUE, kWgMaxGroups, 16>(a, packed, s);
  return launch_wgmma<EPILOGUE, kWgMaxGroups, 0>(a, packed, s);
}

}  // namespace

extern "C" {

// K8, first form: n_steps CTAs; CTA 0 copies x (n floats) to o.
int mb_grid_overhead(const void* x, void* o, int n, int n_steps,
                     void* stream) {
  if (n < 0 || n_steps < 1) return (int)cudaErrorInvalidValue;
  grid_overhead_kernel<<<n_steps, kOverheadThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)o, n);
  return (int)cudaGetLastError();
}

// K8, the loop: min(n_steps, SMs) CTAs take the n_steps steps in turn;
// the CTA holding step 0 copies x (n floats) to o.
int mb_grid_overhead_loop(const void* x, void* o, int n, int n_steps,
                          void* stream) {
  if (n < 0 || n_steps < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  grid_overhead_loop_kernel<<<std::min(n_steps, sms), kOverheadThreads, 0,
                              (cudaStream_t)stream>>>((const float*)x,
                                                      (float*)o, n, n_steps);
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

// K9's packing pass: coef (n_tab, 4 tc, k) into packed (n_tab, 4 tc, kp)
// values in the image order of pair_wgmma_kernel, rounded to TF32.
int mb_pack_tables(const void* coef, void* packed, int n_tab, int tc, int k,
                   void* stream) {
  if (n_tab < 1 || tc < kWgN || tc % kWgN || k < 1 || k > kMaxK ||
      (long long)n_tab * 4 * tc * kMaxK > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const int kp = (k + 7) / 8 * 8;
  const int total = n_tab * 4 * tc * kp;
  pack_tf32_kernel<<<std::min((total + 255) / 256, 4096), 256, 0,
                     (cudaStream_t)stream>>>((const float*)coef,
                                             (float*)packed, n_tab, tc, k, kp);
  return (int)cudaGetLastError();
}

// K9: n_steps products coef[s % n_tab] (4 tc, k) x feats
// (k, br) into o (br,), which holds o_init on entry. tf32 selects the
// tensor-core form, which reads the tables from packed (mb_pack_tables
// of coef); epilogue the Moller-Trumbore epilogue (o >= +0 on entry, no
// NaN), else scratch (n_steps, br) takes P[0] per step and the caller
// runs mb_pair_recurrence. keep != 0 writes each chunk's product rows
// into sink (128, br).
int mb_pair_product(const void* coef, const void* feats, void* o,
                    void* scratch, void* sink, const void* packed, int n_tab,
                    int tc, int br, int k, int n_steps, int tf32, int epilogue,
                    int keep, void* stream) {
  const int row_group = tf32 ? kWgN : kSimtChunk;
  const int col_tile = tf32 ? kWgMaxGroups * kWgM : kSimtCols;
  if (n_tab < 1 || tc < row_group || tc % row_group || br < col_tile ||
      br % col_tile || k < 1 || k > kMaxK || n_steps < 1 ||
      (long long)n_steps * br > 0x7fffffffLL ||
      (!epilogue && scratch == nullptr) || (keep && sink == nullptr) ||
      (tf32 && packed == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const PairArgs a{(const float*)coef, (const float*)feats, (float*)o,
                   (float*)scratch, (float*)sink, n_tab, tc, br, k, n_steps,
                   keep};
  const cudaStream_t s = (cudaStream_t)stream;
  const float* p = (const float*)packed;
  return (int)(epilogue ? launch_pair<true>(a, p, tf32 != 0, s)
                        : launch_pair<false>(a, p, tf32 != 0, s));
}

// K9's second pass without the epilogue: o (br,) = p_s + 0.5 o over the
// n_steps rows of scratch (n_steps, br), in step order.
int mb_pair_recurrence(const void* scratch, void* o, int br, int n_steps,
                       void* stream) {
  if (br < 1 || n_steps < 1 || (long long)n_steps * br > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  pair_recurrence_kernel<<<(br + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const float*)scratch, (float*)o, br, n_steps);
  return (int)cudaGetLastError();
}

const char* mb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
