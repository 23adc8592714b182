// Shared device helpers for the kube_batch_tpu_torch kernels: the tie hash
// and the mask value, each bit-identical to the JAX package's definition
// (kube_batch_tpu/ops/assignment.py _H1/_H2/_H3 and tie_break_hash_rows),
// and the layout both kernels share with its budget staging.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace kbt {

// the mask value of an infeasible cell (ops/pallas_kernels.py NEG)
constexpr float NEG = -3.0e38f;
// the widest resource axis a kernel keeps in registers; wrappers check it
constexpr int MAX_R = 8;
constexpr unsigned FULL_MASK = 0xffffffffu;

// Per-(task, node) tie hash in [0, 65535] at GLOBAL indices, from
// x = ti * H1 + ni * H2, so that a kernel walking adjacent nodes steps x by
// H2 instead of multiplying again.  The JAX package computes it with int32
// wrapping multiplies and logical shifts; signed overflow is undefined in
// C++, so the arithmetic is uint32_t, which is bit-identical modulo 2^32.
constexpr uint32_t H1 = 0x9E3779B1u, H2 = 0x85EBCA77u, H3 = 0xCA87C3EBu;

__device__ __forceinline__ int32_t tie_hash_mix(uint32_t x) {
  x = (x ^ (x >> 15)) * H3;
  return static_cast<int32_t>(x >> 16);
}

// The layout of both kernels: a CTA of WARPS warps, each sweeping
// rows_per_warp<R>() rows over the columns in steps of STEP (four adjacent
// columns per lane), with the node budgets plus quanta staged in shared
// memory per chunk_cols<R>() columns.  Rows and chunk shrink for a wide
// resource axis so registers and shared memory stay bounded.
constexpr int WARPS = 8;
constexpr int STEP = 128;
template <int R> constexpr int rows_per_warp() { return R <= 4 ? 4 : 2; }
template <int R> constexpr int chunk_cols() { return R <= 4 ? 1024 : 512; }

// Writes budget + quanta of columns [c0, c0 + cw) of [N, R] `idle` and
// `releasing` into the [R][CHUNK] shared arrays `bqi` and `bqr` — the same
// single f32 add as the fit's `req <= budget + quanta`.  Every thread of
// the CTA takes part, between two __syncthreads().
template <int R, int CHUNK>
__device__ __forceinline__ void stage_budgets(float* bqi, float* bqr,
                                              const float* __restrict__ idle,
                                              const float* __restrict__ releasing,
                                              const float* __restrict__ quanta,
                                              int c0, int cw) {
  const long long g0 = static_cast<long long>(c0) * R;
  for (int e = threadIdx.x; e < cw * R; e += WARPS * 32) {
    const int c = e / R, r = e - c * R;
    const float q = __ldg(quanta + r);
    bqi[r * CHUNK + c] = __ldg(idle + g0 + e) + q;
    bqr[r * CHUNK + c] = __ldg(releasing + g0 + e) + q;
  }
}

// A lane's four staged columns from chunk-local column `jl` (a multiple of
// 4): one conflict-free 16 B shared read per resource and budget.
template <int R, int CHUNK>
__device__ __forceinline__ void load_budgets(float (&bi)[R][4],
                                             float (&br)[R][4],
                                             const float* bqi, const float* bqr,
                                             int jl) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float4 a = *reinterpret_cast<const float4*>(bqi + r * CHUNK + jl);
    const float4 b = *reinterpret_cast<const float4*>(bqr + r * CHUNK + jl);
    bi[r][0] = a.x; bi[r][1] = a.y; bi[r][2] = a.z; bi[r][3] = a.w;
    br[r][0] = b.x; br[r][1] = b.y; br[r][2] = b.z; br[r][3] = b.w;
  }
}

}  // namespace kbt

extern "C" const char* kbt_error_string(int code);
