// K2: the fused candidate-table build of the compacted allocate solve, by
// hand for Hopper.
//
// Replaces the TPU kernel `_topk_kernel` of
// kube_batch_tpu/ops/pallas_kernels.py (launched by `masked_topk_blocks`).
// For bucket row p (global task row rows[p]) and node n it writes
//   skey[p, n] = f32_sort_key(fit(idle) | fit(releasing) ? score_static : NEG)
// — the order-preserving f32 → i32 key, with `+ 0.0f` canonicalising -0.0
// (why the library is built without --use_fast_math) — and, for every full
// 64-wide node block b, the winner triple under (key desc, tie hash desc,
// column asc): bval/bhash [P, N/64] and bcol, the block-local column.
// A trailing partial block emits keys but no triple, as the TPU kernel's
// grid does.
//
// What bounds it: bytes.  Each cell reads 4 B of score_static and writes a
// 4 B key (≈2.06 GB at P = 50176, N = 5120, ≈0.61 ms at 3.35 TB/s); the
// triples add N/64 × 12 B per row.  The design:
//   - each warp sweeps ROWS bucket rows at once, loading each row's `req`
//     and `rows[p]` once; each lane takes four adjacent columns per step, so
//     a half-warp covers one 64-column block with one 16 B load and one 16 B
//     store per lane, and the triple is a 16-lane shuffle reduction;
//   - the node budgets plus quanta are staged once per CTA and column chunk
//     in shared memory as [R][CHUNK] (conflict-free 16 B reads), so the fit
//     costs no strided global loads;
//   - the fit is computed only where it can change the key: a cell whose
//     score_static is already NEG keys as NEG whatever the fit says;
//   - the tie hash is computed only for a lane's cells that hold its
//     largest key, stepping x by H2 from column to column;
//   - the triple's order (key desc, hash desc, column asc) is packed into
//     one 64-bit word, so each shuffle level is one u64 shuffle and max;
//   - a row whose start is not 16 B aligned (N % 4 != 0, or an offset view)
//     keeps the same column-to-lane map with per-cell loads and stores; the
//     last partial step is bounds-checked per cell.

#include "kbt_common.cuh"

namespace {

constexpr int BLOCK_COLS = 64;  // TOPK_BLOCK of the JAX package

__device__ __forceinline__ int32_t sort_key(float x) {
  const int32_t b = __float_as_int(x + 0.0f);
  return b < 0 ? (b ^ 0x7fffffff) : b;
}

template <int R, int ROWS, int CHUNK>
__global__ void __launch_bounds__(kbt::WARPS * 32)
masked_topk_blocks_kernel(const float* __restrict__ score_static,
                          const float* __restrict__ task_req,
                          const float* __restrict__ idle,
                          const float* __restrict__ releasing,
                          const int32_t* __restrict__ rows,
                          const float* __restrict__ quanta, int P, int N,
                          int n0, int32_t* __restrict__ skey,
                          int32_t* __restrict__ bval_out,
                          int32_t* __restrict__ bhash_out,
                          int32_t* __restrict__ bcol_out) {
  __shared__ __align__(16) float bqi[R * CHUNK];
  __shared__ __align__(16) float bqr[R * CHUNK];

  const int lane = threadIdx.x & 31;
  const long long pbase =
      (static_cast<long long>(blockIdx.x) * kbt::WARPS + (threadIdx.x >> 5)) *
      ROWS;
  const int NB = N / BLOCK_COLS;

  float req[ROWS][R];
  bool live[ROWS], vec[ROWS];
  uint32_t hx[ROWS];  // rows[p] * H1, the row's part of the tie hash
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const long long p = pbase + i;
    live[i] = p < P;
#pragma unroll
    for (int r = 0; r < R; ++r) req[i][r] = live[i] ? task_req[p * R + r] : 0.f;
    hx[i] = live[i] ? static_cast<uint32_t>(rows[p]) * kbt::H1 : 0u;
    vec[i] = live[i] &&
             (reinterpret_cast<uintptr_t>(score_static + p * N) & 15) == 0 &&
             (reinterpret_cast<uintptr_t>(skey + p * N) & 15) == 0;
  }

  for (int c0 = 0; c0 < N; c0 += CHUNK) {
    const int cw = min(CHUNK, N - c0);
    __syncthreads();  // the previous chunk's readers are done
    kbt::stage_budgets<R, CHUNK>(bqi, bqr, idle, releasing, quanta, c0, cw);
    __syncthreads();

    for (int s = 0; s < cw; s += kbt::STEP) {
      const int jl = s + 4 * lane;  // chunk-local first column of the lane
      const int j = c0 + jl;
      const bool full4 = j + 3 < N;

      float sc[ROWS][4];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = kbt::NEG;
        if (!live[i]) continue;  // warp-uniform
        const long long o = (pbase + i) * N + j;
        if (vec[i] && full4) {
          const float4 v =
              __ldg(reinterpret_cast<const float4*>(score_static + o));
          sc[i][0] = v.x; sc[i][1] = v.y; sc[i][2] = v.z; sc[i][3] = v.w;
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (j + k < N) sc[i][k] = __ldg(score_static + o + k);
          }
        }
      }
      float bi[R][4], br[R][4];
      kbt::load_budgets<R, CHUNK>(bi, br, bqi, bqr, jl);

      // the 64-column block of this lane's half-warp, and whether it is full
      const int blk = (c0 + s) / BLOCK_COLS + (lane >> 4);
      const bool full_blk = blk < NB;
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        if (!live[i]) continue;  // warp-uniform: the shuffles stay full
        int32_t key[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float x = sc[i][k];
          if (x != kbt::NEG) {  // only here can the fit change the key
            bool fi = true, fr = true;
#pragma unroll
            for (int r = 0; r < R; ++r) {
              fi &= req[i][r] <= bi[r][k];
              fr &= req[i][r] <= br[r][k];
            }
            if (!(fi || fr)) x = kbt::NEG;
          }
          key[k] = j + k < N ? sort_key(x) : INT32_MIN;
        }
        int32_t* krow = skey + (pbase + i) * N;
        if (vec[i] && full4) {
          *reinterpret_cast<int4*>(krow + j) =
              make_int4(key[0], key[1], key[2], key[3]);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (j + k < N) krow[j + k] = key[k];
          }
        }

        // The three-key order packed into one u64: the key's bits made
        // unsigned-ordered above (hash << 6 | 63 - block column), so a larger
        // word is a larger key, then a larger hash, then an earlier column.
        const int32_t m = max(max(key[0], key[1]), max(key[2], key[3]));
        const uint32_t x0 =
            hx[i] + (static_cast<uint32_t>(n0) + static_cast<uint32_t>(j)) *
                        kbt::H2;
        const int c0b = j - blk * BLOCK_COLS;  // block column of k = 0
        uint32_t hc = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (key[k] == m) {  // the hash only where the key can win
            const uint32_t h = kbt::tie_hash_mix(x0 + k * kbt::H2);
            hc = max(hc, (h << 6) | static_cast<uint32_t>(63 - (c0b + k)));
          }
        }
        unsigned long long w =
            (static_cast<unsigned long long>(static_cast<uint32_t>(m) ^
                                             0x80000000u) << 32) | hc;
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {  // within the half-warp
          w = max(w, __shfl_xor_sync(kbt::FULL_MASK, w, off));
        }
        if ((lane & 15) == 0 && full_blk) {
          const long long o = (pbase + i) * NB + blk;
          const uint32_t lo = static_cast<uint32_t>(w);
          bval_out[o] = static_cast<int32_t>(static_cast<uint32_t>(w >> 32) ^
                                             0x80000000u);
          bhash_out[o] = static_cast<int32_t>(lo >> 6);
          bcol_out[o] = 63 - static_cast<int32_t>(lo & 63u);
        }
      }
    }
  }
}

template <int R>
void launch(const float* score_static, const float* task_req, const float* idle,
            const float* releasing, const int32_t* rows, const float* quanta,
            int P, int N, int n0, int32_t* skey, int32_t* bval, int32_t* bhash,
            int32_t* bcol, cudaStream_t stream) {
  constexpr int ROWS = kbt::rows_per_warp<R>();
  const long long rows_per_cta = static_cast<long long>(kbt::WARPS) * ROWS;
  const long long blocks = (P + rows_per_cta - 1) / rows_per_cta;
  masked_topk_blocks_kernel<R, ROWS, kbt::chunk_cols<R>()>
      <<<static_cast<unsigned>(blocks), kbt::WARPS * 32, 0, stream>>>(
          score_static, task_req, idle, releasing, rows, quanta, P, N, n0,
          skey, bval, bhash, bcol);
}

}  // namespace

// Launches K2 on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int kbt_masked_topk_blocks(const float* score_static,
                                      const float* task_req, const float* idle,
                                      const float* releasing,
                                      const int32_t* rows, const float* quanta,
                                      int P, int N, int R, int n0,
                                      int32_t* skey, int32_t* bval,
                                      int32_t* bhash, int32_t* bcol,
                                      void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#define KBT_K2(RR)                                                            \
  case RR:                                                                    \
    launch<RR>(score_static, task_req, idle, releasing, rows, quanta, P, N, n0, \
               skey, bval, bhash, bcol, s);                                   \
    break;
  switch (R) {
    KBT_K2(1) KBT_K2(2) KBT_K2(3) KBT_K2(4)
    KBT_K2(5) KBT_K2(6) KBT_K2(7) KBT_K2(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef KBT_K2
  return static_cast<int>(cudaGetLastError());
}
