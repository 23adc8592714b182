// The enqueue admission gate, by hand for Hopper.
//
// Replaces `gate_scan` of kube_batch_tpu/ops/admission.py, a jax.lax.scan
// that XLA compiles into one device program (it is not a Pallas kernel).
// Over the candidate rows in admission order it carries the cluster's idle
// budget as a Kahan-compensated pair (idle, comp) of [R] f32 vectors:
//   eff   = idle + comp
//   fits  = all_r (m <= eff) | (m - eff < quanta)
//   ok    = cand & fits                            -> admitted[row]
//   y     = ok ? comp - m : comp
//   t     = idle + y
//   comp  = (idle - t) + y
//   idle  = max(t, 0)
//   comp  = idle > 0 ? comp : 0
// in exactly this f32 operation order, so the verdicts are bit-identical
// to XLA's.  Only adds, subtracts, compares and a max: nothing can contract
// into an FMA, and the build never passes --use_fast_math.  The clamp keeps
// a NaN, as XLA's max does (an infinite budget folds inf - inf into comp).
// A row whose cand is false still folds comp into idle (t = idle + comp),
// so the walk covers every row up to the last candidate; rows past `n` are
// left to the wrapper's zeros.
//
// What bounds it: the dependence chain.  Row i + 1 reads the (idle, comp)
// row i wrote, so the k rows run one after another on one warp; the bytes
// (k * R * 4 in, k out) take nanoseconds.  Both outcomes of a row depend
// only on (idle, comp, m), not on the verdict, so each is computed beside
// the fit test and the vote picks one: the carried path is then the longer
// of eff, m - eff, FSETP, VOTE, select (five) and the admitted outcome's
// comp - m, t, idle - t, + y, zeroing select, select (six) — at least 24
// cycles a row at Hopper's 4-cycle dependent-issue latency.  The design:
//   - one warp walks the rows, lane r holding resource r of idle, comp and
//     quanta in registers; `fits` is one warp vote (__all_sync), so the
//     carry never leaves registers, and the next row's reads are issued
//     before the current row's chain;
//   - the other seven warps of the CTA stage the next chunk of rows
//     (min_res and cand) into the second of two shared buffers while the
//     walking warp reads the first, so global latency stays off the chain.

#include "kbt_common.cuh"

namespace {

constexpr int GATE_WARPS = 8;
constexpr int GATE_CHUNK = 512;  // rows per staged buffer

// max(a, b) that returns NaN when either is NaN, as XLA's max does
// (fmaxf would return the other operand)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ void stage_rows(float* sm, uint8_t* sc,
                                           const float* __restrict__ min_res,
                                           const uint8_t* __restrict__ cand,
                                           int c0, int cw, int R, int tid,
                                           int nthreads) {
  const long long g0 = static_cast<long long>(c0) * R;
  for (int e = tid; e < cw * R; e += nthreads) sm[e] = __ldg(min_res + g0 + e);
  for (int e = tid; e < cw; e += nthreads) sc[e] = __ldg(cand + c0 + e);
}

__global__ void __launch_bounds__(GATE_WARPS * 32)
enqueue_gate_kernel(const float* __restrict__ min_res,
                    const uint8_t* __restrict__ cand,
                    const float* __restrict__ idle0,
                    const float* __restrict__ quanta, int n, int R,
                    uint8_t* __restrict__ admitted) {
  __shared__ float sm[2][GATE_CHUNK * kbt::MAX_R];
  __shared__ uint8_t sc[2][GATE_CHUNK];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_chunks = (n + GATE_CHUNK - 1) / GATE_CHUNK;

  stage_rows(sm[0], sc[0], min_res, cand, 0, min(GATE_CHUNK, n), R,
             threadIdx.x, GATE_WARPS * 32);
  __syncthreads();

  const bool live = lane < R;
  const int lane_r = min(lane, R - 1);  // lanes past R read a live column
  float idle = live ? idle0[lane] : 0.0f;
  float comp = 0.0f;
  const float q = live ? quanta[lane] : 0.0f;

  for (int k = 0; k < n_chunks; ++k) {
    const int c0 = k * GATE_CHUNK;
    const int cw = min(GATE_CHUNK, n - c0);
    if (warp != 0) {
      if (k + 1 < n_chunks) {
        const int c1 = c0 + GATE_CHUNK;
        stage_rows(sm[(k + 1) & 1], sc[(k + 1) & 1], min_res, cand, c1,
                   min(GATE_CHUNK, n - c1), R, threadIdx.x - 32,
                   (GATE_WARPS - 1) * 32);
      }
    } else {
      const float* rows = sm[k & 1];
      const uint8_t* flags = sc[k & 1];
      // row i + 1's reads are issued before row i's chain, so shared
      // memory latency stays off it; a row that is not a candidate asks
      // for NaN, which fails every compare on lane 0 (R >= 1) whatever the
      // budget, so `cand` costs the chain nothing
      float m_next = rows[lane_r];
      bool c_next = flags[0] != 0;
      for (int i = 0; i < cw; ++i) {
        const float m = m_next;
        const float m_fit = c_next ? m : __int_as_float(0x7fc00000);  // NaN
        const int nx = min(i + 1, cw - 1);
        m_next = rows[nx * R + lane_r];
        c_next = flags[nx] != 0;
        const float eff = idle + comp;  // also the rejected outcome's t
        // both outcomes before the vote; idle = max(t, 0) > 0 iff t > 0
        const float y = comp - m;
        const float t = idle + y;
        const float idle_in = max_nan(t, 0.0f);
        const float comp_in = t > 0.0f ? (idle - t) + y : 0.0f;
        const float idle_out = max_nan(eff, 0.0f);
        const float comp_out = eff > 0.0f ? (idle - eff) + comp : 0.0f;
        const bool fit = !live || (m_fit <= eff) || (m_fit - eff < q);
        const bool ok = __all_sync(kbt::FULL_MASK, fit);
        idle = ok ? idle_in : idle_out;
        comp = ok ? comp_in : comp_out;
        if (lane == 0) admitted[c0 + i] = ok;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Launches the gate on `stream` over rows [0, n); returns
// cudaGetLastError() (0 = launched).
extern "C" int kbt_enqueue_gate(const float* min_res, const uint8_t* cand,
                                const float* idle0, const float* quanta, int n,
                                int R, uint8_t* admitted, void* stream) {
  if (n <= 0 || R < 1 || R > kbt::MAX_R) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  enqueue_gate_kernel<<<1, GATE_WARPS * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      min_res, cand, idle0, quanta, n, R, admitted);
  return static_cast<int>(cudaGetLastError());
}
