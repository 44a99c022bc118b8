// Dense interval-stabbing rule matcher for Hopper (sm_90a).
//
// Replaces repro/kernels/rule_match.py::rule_match_pallas (kernel body
// _kernel). For each query b it takes, over the rules r, the AND over the C
// criteria of mins[c, r] <= q[c, b] <= maxs[c, r]; a matching rule scores its
// weight, and the result is the highest score with the lowest rule index
// among ties, or (-1, -1) when nothing matches. Layouts are the Pallas
// kernel's: criterion-major queries (C, B) and bounds (C, R), weights (R,).
//
// What bounds it: int32 compares on the CUDA cores. At the paper's scale
// (R = 160k rules, C = 31) the whole table is about 40 MB, which fits the
// 50 MB L2, while a batch of B queries needs up to B * R * C compare pairs,
// so the work is operations, not bytes. No tensor-core path applies.
//
// Design:
//  - The TPU grid (B / tile_b, R / tile_r) runs its rule dimension in order
//    and carries the running best across rule tiles. Here blocks run in
//    parallel in no order, so pass 1 gives every (batch tile, rule tile) pair
//    its own block, which writes a partial best to scratch, and pass 2
//    reduces the rule tiles of each query in increasing order with a strict
//    ">", so the earlier tile wins ties exactly as on the TPU.
//  - One thread per query keeps its C codes in registers (the criterion
//    count is rounded up to a compile-time bound so the loop unrolls).
//  - A block stages its rule tile through shared memory `stage` rules at a
//    time: (C, stage) bounds loaded coalesced along R, plus the weights.
//    Every thread then reads the same rule, a broadcast with no bank
//    conflicts. At C = 31 a stage of 128 rules is 32 KB, under the 48 KB
//    that needs no opt-in; wider tables stage 64 rules.
//  - Each thread walks the rules in increasing index order and leaves a rule
//    at its first failing criterion, so a rule costs what the data needs.
//    It updates its best only on a strictly greater weight, starting from
//    (-1, -1): the lowest-index tie-break comes with no second scan.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxCrit = 64;
constexpr int kSmemBudget = 48 * 1024;

int stage_for(int n_crit) {
  // largest stage whose bounds + weights fit the static shared-memory budget
  int stage = 128;
  while (stage > 32 &&
         (2 * n_crit * stage + stage) * static_cast<int>(sizeof(int)) >
             kSmemBudget)
    stage /= 2;
  return stage;
}

template <int MAXC>
__global__ void rule_match_tiles(const int* __restrict__ q_t,
                                 const int* __restrict__ mins_t,
                                 const int* __restrict__ maxs_t,
                                 const int* __restrict__ weights,
                                 int* __restrict__ part_w,
                                 int* __restrict__ part_i, int n_crit, int B,
                                 int R, int tile_r, int stage) {
  extern __shared__ int smem[];
  int* s_min = smem;                       // (n_crit, stage)
  int* s_max = smem + n_crit * stage;      // (n_crit, stage)
  int* s_w = smem + 2 * n_crit * stage;    // (stage,)

  const int b = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = b < B;
  const int r_begin = blockIdx.x * tile_r;
  const int r_end = min(r_begin + tile_r, R);

  int q[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c)
    q[c] = (live && c < n_crit) ? q_t[static_cast<int64_t>(c) * B + b] : 0;

  int best_w = -1;
  int best_i = -1;
  for (int r0 = r_begin; r0 < r_end; r0 += stage) {
    const int n = min(stage, r_end - r0);
    __syncthreads();  // the previous stage is no longer read
    for (int k = threadIdx.x; k < n_crit * n; k += blockDim.x) {
      const int c = k / n;
      const int r = k - c * n;
      const int64_t src = static_cast<int64_t>(c) * R + r0 + r;
      s_min[c * stage + r] = mins_t[src];
      s_max[c * stage + r] = maxs_t[src];
    }
    for (int k = threadIdx.x; k < n; k += blockDim.x) s_w[k] = weights[r0 + k];
    __syncthreads();
    if (!live) continue;
    for (int r = 0; r < n; ++r) {
      bool ok = true;
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        if (c >= n_crit) break;
        const int v = q[c];
        if (v < s_min[c * stage + r] || v > s_max[c * stage + r]) {
          ok = false;
          break;
        }
      }
      if (ok) {
        const int w = s_w[r];
        if (w > best_w) {  // strict: the lower index keeps a tie
          best_w = w;
          best_i = r0 + r;
        }
      }
    }
  }
  if (live) {
    const int64_t o = static_cast<int64_t>(blockIdx.x) * B + b;
    part_w[o] = best_w;
    part_i[o] = best_i;
  }
}

__global__ void rule_match_reduce(const int* __restrict__ part_w,
                                  const int* __restrict__ part_i,
                                  int* __restrict__ out_w,
                                  int* __restrict__ out_i, int n_tiles,
                                  int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int bw = -1;
  int bi = -1;
  for (int t = 0; t < n_tiles; ++t) {  // in rule order: earlier tile wins ties
    const int64_t o = static_cast<int64_t>(t) * B + b;
    const int w = part_w[o];
    if (w > bw) {
      bw = w;
      bi = part_i[o];
    }
  }
  out_w[b] = bw;
  out_i[b] = bi;
}

template <int MAXC>
void launch_tiles(dim3 grid, dim3 block, size_t smem, cudaStream_t stream,
                  const int* q_t, const int* mins_t, const int* maxs_t,
                  const int* weights, int* part_w, int* part_i, int n_crit,
                  int B, int R, int tile_r, int stage) {
  rule_match_tiles<MAXC><<<grid, block, smem, stream>>>(
      q_t, mins_t, maxs_t, weights, part_w, part_i, n_crit, B, R, tile_r,
      stage);
}

}  // namespace

// Launches both passes on `stream`; part_w/part_i are (R / tile_r, B)
// scratch buffers. Returns cudaGetLastError() after the launches (0 == ok).
extern "C" int rule_match_launch(const void* q_t, const void* mins_t,
                                 const void* maxs_t, const void* weights,
                                 void* part_w, void* part_i, void* out_w,
                                 void* out_i, int n_crit, int B, int R,
                                 int tile_b, int tile_r, void* stream) {
  if (n_crit < 1 || n_crit > kMaxCrit || tile_b < 1 || tile_b > 1024 ||
      tile_r < 1 || B < 1 || R < 1 || B % tile_b != 0 || R % tile_r != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = R / tile_r;
  const int n_btiles = B / tile_b;
  if (n_btiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int stage = stage_for(n_crit);
  const size_t smem = static_cast<size_t>(2 * n_crit * stage + stage) *
                      sizeof(int);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_tiles, n_btiles);
  const dim3 block(tile_b);
  const int* q = static_cast<const int*>(q_t);
  const int* mn = static_cast<const int*>(mins_t);
  const int* mx = static_cast<const int*>(maxs_t);
  const int* w = static_cast<const int*>(weights);
  int* pw = static_cast<int*>(part_w);
  int* pi = static_cast<int*>(part_i);
  if (n_crit <= 8)
    launch_tiles<8>(grid, block, smem, s, q, mn, mx, w, pw, pi, n_crit, B, R,
                    tile_r, stage);
  else if (n_crit <= 16)
    launch_tiles<16>(grid, block, smem, s, q, mn, mx, w, pw, pi, n_crit, B, R,
                     tile_r, stage);
  else if (n_crit <= 32)
    launch_tiles<32>(grid, block, smem, s, q, mn, mx, w, pw, pi, n_crit, B, R,
                     tile_r, stage);
  else
    launch_tiles<64>(grid, block, smem, s, q, mn, mx, w, pw, pi, n_crit, B, R,
                     tile_r, stage);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  rule_match_reduce<<<(B + threads - 1) / threads, threads, 0, s>>>(
      pw, pi, static_cast<int*>(out_w), static_cast<int*>(out_i), n_tiles, B);
  return static_cast<int>(cudaGetLastError());
}
