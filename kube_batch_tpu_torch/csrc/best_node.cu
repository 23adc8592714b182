// K1: the fused round head of the allocate solve, by hand for Hopper.
//
// Replaces the TPU kernel `_kernel` of kube_batch_tpu/ops/pallas_kernels.py
// (launched by `masked_best_node_raw`).  Per task row t it computes
//   feas[t, n] = static_ok[t, n] & pending[t]
//                & (fit(req[t], idle[n]) | fit(req[t], releasing[n]))
// masks infeasible cells to NEG and takes the lexicographic argmax
// (score desc, tie hash desc, node index asc) — the JAX package's
// `_best_node` with first-index ties.  The row part of the tie hash is
// `(t0 + t) * H1`, or `rows[t] * H1` when `rows` is not null (the what-if
// probe's G rows, at the global task rows the gang would occupy, which need
// not be contiguous).  Outputs: best [T] i32 (block-local
// node index), val [T] f32, hash [T] f32, chose_idle [T] (the idle fit at
// the pick).  Rows with no feasible cell (and rows that are not pending)
// still get a defined pick: the first column of highest hash, val NEG.
//
// What bounds it: bytes.  A pending row costs 4 B of score plus 1 B of
// static_ok per cell, read once (≈1.28 GB at 50176 × 5120 with every row
// pending, ≈0.38 ms at 3.35 TB/s); a row that is not pending costs no
// bytes, only its tie hashes.  The design:
//   - each warp sweeps ROWS task rows at once over the columns, each lane
//     four adjacent columns per step (one 16 B score load and one 4 B
//     static_ok load per row, so ROWS × 20 B are in flight per lane);
//   - the node budgets plus quanta (`idle + q`, `releasing + q`, the same
//     single f32 add as the fit's) are staged once per CTA and column chunk
//     in shared memory as [R][CHUNK], so the per-cell fit reads registers
//     loaded by conflict-free 16 B shared loads and each warp reuses them
//     for all of its rows;
//   - work is lazy, in order of cost: a row that is not pending reads
//     nothing and reduces its tie hash alone; a pending row computes the
//     fit only where static_ok is set; chose_idle is one idle fit per row,
//     at the winning column, after the reduction;
//   - per step a lane first reduces its own four cells, computing the tie
//     hash only for cells equal to their best value and only when that
//     value can still win, then merges the result into its running best
//     once, which keeps the serial compare chain per row short (at a
//     homogeneous round 0 every node scores alike, so the hash decides
//     almost every cell); the hash steps x by H2 from column to column;
//   - a row whose start is not 16 B aligned (odd N, or an offset view) keeps
//     the same column-to-lane map and loads its four cells one by one; the
//     last partial step is bounds-checked per cell.
// A lane visits its columns in increasing order, so a lane-local tie keeps
// the earlier column; the warp-shuffle merge compares all three keys.  No
// CTA splits N, so no cross-CTA merge (and no atomic) is needed.

#include "kbt_common.cuh"

namespace {



__device__ __forceinline__ bool better(float v, int32_t h, int32_t j, float bv,
                                       int32_t bh, int32_t bj) {
  return v > bv || (v == bv && (h > bh || (h == bh && j < bj)));
}

template <int R, int ROWS, int CHUNK>
__global__ void __launch_bounds__(kbt::WARPS * 32)
masked_best_node_kernel(const float* __restrict__ score,
                        const uint8_t* __restrict__ static_ok,
                        const float* __restrict__ task_req,
                        const float* __restrict__ idle,
                        const float* __restrict__ releasing,
                        const uint8_t* __restrict__ pending,
                        const float* __restrict__ quanta,
                        const int32_t* __restrict__ rows, int T, int N, int t0,
                        int n0, int32_t* __restrict__ best_out,
                        float* __restrict__ val_out,
                        float* __restrict__ hash_out,
                        uint8_t* __restrict__ chose_out) {
  // budgets + quanta of the current column chunk: [R][CHUNK] each
  __shared__ __align__(16) float bqi[R * CHUNK];
  __shared__ __align__(16) float bqr[R * CHUNK];

  const int lane = threadIdx.x & 31;
  const long long tbase =
      (static_cast<long long>(blockIdx.x) * kbt::WARPS + (threadIdx.x >> 5)) *
      ROWS;

  float req[ROWS][R];
  bool live[ROWS], pend[ROWS], vec[ROWS];
  uint32_t hx[ROWS];  // t * H1, the row's part of the tie hash
  float bv[ROWS];
  int32_t bh[ROWS], bj[ROWS];
  bool warp_pend = false;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const long long t = tbase + i;
    live[i] = t < T;
    pend[i] = live[i] && pending[t] != 0;
    warp_pend |= pend[i];
#pragma unroll
    for (int r = 0; r < R; ++r) req[i][r] = live[i] ? task_req[t * R + r] : 0.f;
    const uint32_t trow =
        rows != nullptr ? (live[i] ? static_cast<uint32_t>(rows[t]) : 0u)
                        : static_cast<uint32_t>(t0) + static_cast<uint32_t>(t);
    hx[i] = trow * kbt::H1;
    vec[i] = live[i] &&
             (reinterpret_cast<uintptr_t>(score + t * N) & 15) == 0 &&
             (reinterpret_cast<uintptr_t>(static_ok + t * N) & 3) == 0;
    // every real cell is >= NEG with a hash >= 0, so it beats this start
    bv[i] = kbt::NEG;
    bh[i] = -1;
    bj[i] = 0x7fffffff;
  }
  // every warp of the CTA reaches this barrier (no early return above)
  const bool cta_pend = __syncthreads_or(warp_pend) != 0;

  for (int c0 = 0; c0 < N; c0 += CHUNK) {
    const int cw = min(CHUNK, N - c0);
    if (cta_pend) {
      __syncthreads();  // the previous chunk's readers are done
      kbt::stage_budgets<R, CHUNK>(bqi, bqr, idle, releasing, quanta, c0, cw);
      __syncthreads();
    }
    for (int s = 0; s < cw; s += kbt::STEP) {
      const int jl = s + 4 * lane;  // chunk-local first column of the lane
      const int j = c0 + jl;
      const bool full4 = j + 3 < N;

      // issue every pending row's loads before any compute
      float sc[ROWS][4];
      uint32_t ok[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        ok[i] = 0;
        sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
        if (!pend[i]) continue;  // warp-uniform
        const long long o = (tbase + i) * N + j;
        if (vec[i] && full4) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(score + o));
          sc[i][0] = v.x; sc[i][1] = v.y; sc[i][2] = v.z; sc[i][3] = v.w;
          ok[i] = __ldg(reinterpret_cast<const uint32_t*>(static_ok + o));
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (j + k < N) {
              sc[i][k] = __ldg(score + o + k);
              ok[i] |= static_cast<uint32_t>(__ldg(static_ok + o + k)) << (8 * k);
            }
          }
        }
      }
      float bi[R][4], br[R][4];
      if (warp_pend) {
        kbt::load_budgets<R, CHUNK>(bi, br, bqi, bqr, jl);
      }

      if (j < N) {
        const float ninf = __int_as_float(static_cast<int>(0xff800000u));
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          if (!live[i]) continue;
          // x of the tie hash at column j; column j + k adds k * H2
          const uint32_t x0 =
              hx[i] + (static_cast<uint32_t>(n0) + static_cast<uint32_t>(j)) *
                          kbt::H2;
          if (!pend[i]) {  // warp-uniform: the hash alone decides
            int32_t hb = -1, kb = 0;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (j + k < N) {
                const int32_t h = kbt::tie_hash_mix(x0 + k * kbt::H2);
                if (h > hb) {  // k ascends: a tie keeps the earlier column
                  hb = h;
                  kb = k;
                }
              }
            }
            if (hb > bh[i]) {
              bh[i] = hb;
              bj[i] = j + kb;
            }
            continue;
          }
          // the masked value of each of the lane's four cells (-inf past N)
          float v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            v[k] = j + k < N ? kbt::NEG : ninf;
            if ((ok[i] >> (8 * k)) & 0xffu) {
              bool fi = true, fr = true;
#pragma unroll
              for (int r = 0; r < R; ++r) {
                fi &= req[i][r] <= bi[r][k];
                fr &= req[i][r] <= br[r][k];
              }
              if (fi || fr) v[k] = sc[i][k];
            }
          }
          const float m = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
          if (m >= bv[i]) {  // only a step that can still win pays the hash
            int32_t hb = -1, kb = 0;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (v[k] == m) {
                const int32_t h = kbt::tie_hash_mix(x0 + k * kbt::H2);
                if (h > hb) {
                  hb = h;
                  kb = k;
                }
              }
            }
            if (m > bv[i] || hb > bh[i]) {  // equal (v, h): keep the earlier
              bv[i] = m;
              bh[i] = hb;
              bj[i] = j + kb;
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    if (!live[i]) continue;  // warp-uniform: the shuffles below stay full
    float v = bv[i];
    int32_t h = bh[i], jb = bj[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kbt::FULL_MASK, v, off);
      const int32_t oh = __shfl_xor_sync(kbt::FULL_MASK, h, off);
      const int32_t oj = __shfl_xor_sync(kbt::FULL_MASK, jb, off);
      if (better(ov, oh, oj, v, h, jb)) {
        v = ov;
        h = oh;
        jb = oj;
      }
    }
    if (lane == 0) {
      const long long t = tbase + i;
      bool ci = true;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        ci &= req[i][r] <= __ldg(idle + static_cast<long long>(jb) * R + r) +
                               __ldg(quanta + r);
      }
      best_out[t] = jb;
      val_out[t] = v;
      hash_out[t] = static_cast<float>(h);
      chose_out[t] = ci ? 1 : 0;
    }
  }
}

template <int R>
void launch(const float* score, const uint8_t* static_ok, const float* task_req,
            const float* idle, const float* releasing, const uint8_t* pending,
            const float* quanta, const int32_t* rows, int T, int N, int t0,
            int n0, int32_t* best, float* val, float* hash, uint8_t* chose_idle,
            cudaStream_t stream) {
  constexpr int ROWS = kbt::rows_per_warp<R>();
  const long long rows_per_cta = static_cast<long long>(kbt::WARPS) * ROWS;
  const long long blocks = (T + rows_per_cta - 1) / rows_per_cta;
  masked_best_node_kernel<R, ROWS, kbt::chunk_cols<R>()>
      <<<static_cast<unsigned>(blocks), kbt::WARPS * 32, 0, stream>>>(
          score, static_ok, task_req, idle, releasing, pending, quanta, rows,
          T, N, t0, n0, best, val, hash, chose_idle);
}

}  // namespace

extern "C" const char* kbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches K1 on `stream`; returns cudaGetLastError() (0 = launched).
// `rows` may be null: the tie hash then takes rows t0 + t.
extern "C" int kbt_masked_best_node(const float* score, const uint8_t* static_ok,
                                    const float* task_req, const float* idle,
                                    const float* releasing,
                                    const uint8_t* pending, const float* quanta,
                                    const int32_t* rows, int T, int N, int R,
                                    int t0, int n0,
                                    int32_t* best, float* val, float* hash,
                                    uint8_t* chose_idle, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#define KBT_K1(RR)                                                          \
  case RR:                                                                  \
    launch<RR>(score, static_ok, task_req, idle, releasing, pending, quanta, \
               rows, T, N, t0, n0, best, val, hash, chose_idle, s);         \
    break;
  switch (R) {
    KBT_K1(1) KBT_K1(2) KBT_K1(3) KBT_K1(4)
    KBT_K1(5) KBT_K1(6) KBT_K1(7) KBT_K1(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef KBT_K1
  return static_cast<int>(cudaGetLastError());
}
