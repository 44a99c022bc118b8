// Dense interval-stabbing rule matcher for Hopper (sm_90a).
//
// Replaces repro/kernels/rule_match.py::rule_match_pallas (kernel body
// _kernel). For each query b it takes, over the rules r, the AND over the C
// criteria of min[c, r] <= q[b, c] <= max[c, r]; a matching rule scores its
// weight, and the result is the highest score with the lowest rule index
// among ties, or (-1, -1) when nothing matches.
//
// Inputs are the packed table that kernels/rule_match.py::pack builds once
// per upload: bounds (C, R, 2) int32 of (base, span) pairs with base = min
// and span = max - min taken as uint32, rows in the kernel's criterion order
// `crit` (most selective first, estimated from the table alone), and
// weights (R,) with -1 for every rule that has min > max somewhere. A bound
// min <= q <= max is then the single unsigned test (q - base) <= span,
// exact for every int32 q whenever min <= max; rules with min > max carry
// -1 and a score of -1 never beats the starting best of -1. Queries are
// read as (B, C) with any strides, in the caller's column order, through a
// permutation `order`: one the caller gives, or the batch sorted by its
// code in the leading criterion, which a first kernel of the launch writes;
// the results are written back through it (the unsort).
//
// What bounds it: int32 ALU work on the CUDA cores. The packed table is
// about 40 MB at the paper's 160k rules (it stays in the 50 MB L2 between
// batches) while B queries need B * R criterion tests times the depth the
// data reaches, so the work is operations, not bytes. There is no product
// to put on the tensor cores (wgmma): the tests are integer interval
// compares with a data-dependent early exit.
//
// Design:
//  - One thread holds QPT queries (2 at C <= 32) in registers. A warp owns
//    32 * QPT consecutive slots of the sorted batch, so its queries share
//    few leading codes; it lists them once, in shared memory.
//  - Filter: lane l tests rule r + l's leading criterion against the
//    warp's codes, and a ballot leaves the rules some query passes. Only
//    those are walked, one by one, four criteria between votes (one
//    broadcast load of (base, span) per criterion feeds all the warp's
//    queries), until every lane has failed. Branches in the walk are
//    warp-uniform; only the weight update diverges.
//  - Rule stages of 64 rules (all C criteria and the weights) are staged by
//    16-byte cp.async into a ring of 3 stages in dynamic shared memory, so
//    the copy of stage s + 2 overlaps the tests of stage s. Stage width and
//    chunk counts are powers of two: the copy loop shifts and masks. A
//    partial chunk at the ragged end of R is zero-filled by cp.async, and
//    the tests never read past the block's last rule.
//  - Blocks of 128 threads (256 once the batch fills two of their tiles,
//    halving the passes over the table), __launch_bounds__ keeping 512
//    threads resident on an SM. The grid is sized from the SM count and
//    that occupancy: each batch tile gets `n_runs` blocks, each walking one
//    contiguous run of rules (a multiple of 4) of at most 1024 rules, so
//    the data-dependent work of large batches spreads over several waves
//    and the block scheduler balances it (on the main path's batches one
//    wave of long runs is slower at B = 4096, runs of 256 or 512 rules
//    cost more partials; benchmarks/torch_rule_match_grid.py times them).
//  - Each block walks its rules in increasing index order and updates a
//    query's best only on a strictly greater weight, so it keeps the lowest
//    index among ties. A second pass reduces the runs of each query in rule
//    order with a strict ">", the TPU grid's tie-break, with 32 slices of
//    runs in parallel per query, and scatters through `order`.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kStage = 64;         // rules a stage (power of two)
constexpr int kRing = 3;           // stages in shared memory
constexpr int kChunksRow = kStage * 8 / 16;  // 16-byte chunks a criterion row
constexpr int kLogChunksRow = 5;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 4;          // criteria a walk tests between votes
constexpr int kMaxRun = 1024;      // rules a block walks at most: more waves
constexpr int kRunAlign = 4;       // run bounds: one 16-byte chunk of weights
constexpr int kMaxCrit = 64;
constexpr int kReduceQ = 32;       // pass 2: queries a block
constexpr int kReduceSlices = 32;  // pass 2: slices of runs per query
constexpr int kSortMax = 2048;     // batch sort: keys in one block's smem
constexpr int kSortThreads = 1024;
static_assert(kChunksRow == (1 << kLogChunksRow), "stage width");
static_assert(kStage % 32 == 0 && kStage % kRunAlign == 0, "stage width");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// min <= q <= max as one unsigned compare of (q - base) against the span
__device__ __forceinline__ bool inside(int q, uint2 b) {
  return static_cast<unsigned>(q) - b.x <= b.y;
}

__host__ __device__ constexpr int slot_bytes(int n_crit) {
  return n_crit * kStage * 8 + kStage * 4;
}

// Issue the cp.async copies of rules [g0, min(g0 + kStage, g_end)) into one
// ring slot: (n_crit, kStage) bounds, then kStage weights.
template <int NT>
__device__ __forceinline__ void stage_copy(unsigned char* slot,
                                           const int2* __restrict__ bounds,
                                           const int* __restrict__ weights,
                                           int n_crit, int R, int g0,
                                           int g_end) {
  uint2* sb = reinterpret_cast<uint2*>(slot);
  const int total = n_crit << kLogChunksRow;
  for (int k = threadIdx.x; k < total; k += NT) {
    const int c = k >> kLogChunksRow;
    const int j = k & (kChunksRow - 1);
    const int r = g0 + 2 * j;
    const int bytes = min(16, (g_end - r) * 8);
    if (bytes > 0)
      cp_async16(sb + c * kStage + 2 * j,
                 bounds + static_cast<int64_t>(c) * R + r, bytes);
  }
  int* sw = reinterpret_cast<int*>(slot + n_crit * kStage * 8);
  for (int j = threadIdx.x; j < kStage / 4; j += NT) {
    const int r = g0 + 4 * j;
    const int bytes = min(16, (g_end - r) * 4);
    if (bytes > 0) cp_async16(sw + 4 * j, weights + r, bytes);
  }
}

// Walk rule `rr` of the stage for the warp's queries until every lane has
// failed: criterion 0, then kChunk criteria at a time (independent loads
// and tests, one vote a chunk), so a walk is a short chain of dependent
// steps. A match updates the lane's best on a strictly greater weight, so
// the lower index keeps a tie.
template <int MAXC, int QPT>
__device__ __forceinline__ void walk(const int (&q)[QPT][MAXC],
                                     const bool (&live)[QPT],
                                     const uint2* sb, const int* sw, int rr,
                                     int rule, int n_crit, int (&best_w)[QPT],
                                     int (&best_i)[QPT]) {
  const uint2 b0 = sb[rr];
  bool a[QPT];
  bool some = false;
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    a[i] = live[i] && inside(q[i][0], b0);
    some |= a[i];
  }
#pragma unroll
  for (int c0 = 1; c0 < MAXC; c0 += kChunk) {
    if (c0 >= n_crit || !__any_sync(kFull, some)) break;
    uint2 bc[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k)  // past the last criterion: always true
      bc[k] = (c0 + k < MAXC && c0 + k < n_crit)
                  ? sb[(c0 + k) * kStage + rr]
                  : make_uint2(0u, 0xffffffffu);
    some = false;
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      bool t = a[i];
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        if (c0 + k < MAXC) t &= inside(q[i][c0 + k], bc[k]);
      a[i] = t;
      some |= t;
    }
  }
  if (some) {
    const int w = sw[rr];
#pragma unroll
    for (int i = 0; i < QPT; ++i)
      if (a[i] && w > best_w[i]) {
        best_w[i] = w;
        best_i[i] = rule;
      }
  }
}

template <int NT, int MAXC, int QPT>
__global__ void __launch_bounds__(NT, 512 / NT)
    rule_match_runs(const int* __restrict__ queries, int64_t q_row,
                    int64_t q_col, const int64_t* __restrict__ order,
                    const int* __restrict__ crit,
                    const int2* __restrict__ bounds,
                    const int* __restrict__ weights, int* __restrict__ part_w,
                    int* __restrict__ part_i, int n_crit, int B, int R,
                    int run) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_codes[NT / 32][32 * QPT];
  const int sbytes = slot_bytes(n_crit);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r_begin = blockIdx.x * run;
  const int r_end = min(r_begin + run, R);
  const int n_stages = (r_end - r_begin + kStage - 1) / kStage;

  // start the copies first: the query loads below overlap them
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    const int g0 = r_begin + s * kStage;
    if (s < n_stages)
      stage_copy<NT>(smem + s * sbytes, bounds, weights, n_crit, R, g0,
                     r_end);
    cp_async_commit();
  }

  int slot[QPT];
  bool live[QPT];
  int q[QPT][MAXC];
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    slot[i] = blockIdx.y * (NT * QPT) + warp * (32 * QPT) + 32 * i + lane;
    live[i] = slot[i] < B;
    const int64_t row = !live[i] ? 0 : (order ? order[slot[i]] : slot[i]);
    const int* qr = queries + row * q_row;
#pragma unroll
    for (int c = 0; c < MAXC; ++c)
      q[i][c] = (live[i] && c < n_crit) ? qr[crit[c] * q_col] : 0;
  }

  // the distinct leading codes among the warp's live queries (few in a
  // sorted batch): a rule concerns the warp only if one of them passes it
  int* codes = s_codes[warp];
  int n_codes = 0;
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const unsigned live_mask = __ballot_sync(kFull, live[i]);
    const unsigned peers = __match_any_sync(kFull, q[i][0]) & live_mask;
    const bool leader = live[i] && __ffs(peers) - 1 == lane;
    const unsigned leaders = __ballot_sync(kFull, leader);
    if (leader)
      codes[n_codes + __popc(leaders & ((1u << lane) - 1u))] = q[i][0];
    n_codes += __popc(leaders);
  }
  __syncwarp();

  int best_w[QPT], best_i[QPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i) best_w[i] = best_i[i] = -1;

  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kRing - 2>();  // this thread's copies of stage s landed
    __syncthreads();             // everyone's; and stage s - 1 is read
    {
      const int sn = s + kRing - 1;
      if (sn < n_stages)
        stage_copy<NT>(smem + (sn % kRing) * sbytes, bounds, weights, n_crit,
                       R, r_begin + sn * kStage, r_end);
      cp_async_commit();
    }
    const unsigned char* st = smem + (s % kRing) * sbytes;
    const uint2* sb = reinterpret_cast<const uint2*>(st);
    const int* sw = reinterpret_cast<const int*>(st + n_crit * kStage * 8);
    const int g0 = r_begin + s * kStage;
    const int n = min(kStage, r_end - g0);

    // filter: lane l tests rule r + l's leading criterion against the
    // warp's codes; the ballot leaves the rules some query passes
    for (int r = 0; r < n; r += 32) {
      bool hit = false;
      if (r + lane < n) {
        const uint2 b = sb[r + lane];
        for (int d = 0; d < n_codes; ++d) hit |= inside(codes[d], b);
      }
      unsigned todo = __ballot_sync(kFull, hit);
      while (todo) {  // in rule order
        const int j = __ffs(todo) - 1;
        todo &= todo - 1;
        walk<MAXC, QPT>(q, live, sb, sw, r + j, g0 + r + j, n_crit, best_w,
                        best_i);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < QPT; ++i)
    if (live[i]) {
      const int64_t o = static_cast<int64_t>(blockIdx.x) * B + slot[i];
      part_w[o] = best_w[i];
      part_i[o] = best_i[i];
    }
}

// The batch order: one block sorts (code in column `col`, slot) pairs as
// 64-bit keys with a bitonic network in shared memory and writes the slots,
// so the queries come out grouped by their leading code.
__global__ void __launch_bounds__(kSortThreads)
    rule_match_sort(const int* __restrict__ queries, int64_t q_row,
                    int64_t q_col, int col, int B, int n_pow2,
                    int64_t* __restrict__ order) {
  extern __shared__ unsigned long long keys[];
  for (int i = threadIdx.x; i < n_pow2; i += kSortThreads) {
    const unsigned code =
        i < B ? static_cast<unsigned>(queries[i * q_row + col * q_col]) ^
                    0x80000000u  // signed order as unsigned
              : 0xffffffffu;
    keys[i] = i < B ? (static_cast<unsigned long long>(code) << 32) |
                          static_cast<unsigned>(i)
                    : ~0ull;  // padding sorts last
  }
  __syncthreads();
  for (int k = 2; k <= n_pow2; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n_pow2; i += kSortThreads) {
        const int l = i ^ j;
        if (l > i) {
          const unsigned long long x = keys[i];
          const unsigned long long y = keys[l];
          if ((x > y) == ((i & k) == 0)) {
            keys[i] = y;
            keys[l] = x;
          }
        }
      }
      __syncthreads();
    }
  for (int i = threadIdx.x; i < B; i += kSortThreads)
    order[i] = static_cast<int64_t>(keys[i] & 0xffffffffull);
}

__global__ void __launch_bounds__(kReduceQ* kReduceSlices)
    rule_match_reduce(const int* __restrict__ part_w,
                      const int* __restrict__ part_i,
                      const int64_t* __restrict__ order,
                      int* __restrict__ out_w, int* __restrict__ out_i,
                      int n_runs, int B) {
  __shared__ int s_w[kReduceSlices][kReduceQ];
  __shared__ int s_i[kReduceSlices][kReduceQ];
  const int x = threadIdx.x;
  const int y = threadIdx.y;
  const int b = blockIdx.x * kReduceQ + x;
  int bw = -1;
  int bi = -1;
  if (b < B) {
    // slice y holds runs [p0, p1), in rule order: earlier runs win ties
    const int p0 = static_cast<int>(static_cast<int64_t>(n_runs) * y /
                                    kReduceSlices);
    const int p1 = static_cast<int>(static_cast<int64_t>(n_runs) * (y + 1) /
                                    kReduceSlices);
    for (int p = p0; p < p1; ++p) {
      const int64_t o = static_cast<int64_t>(p) * B + b;
      const int w = part_w[o];
      if (w > bw) {
        bw = w;
        bi = part_i[o];
      }
    }
  }
  s_w[y][x] = bw;
  s_i[y][x] = bi;
  __syncthreads();
  if (y != 0 || b >= B) return;
  for (int k = 1; k < kReduceSlices; ++k)
    if (s_w[k][x] > bw) {
      bw = s_w[k][x];
      bi = s_i[k][x];
    }
  const int64_t dst = order ? order[b] : b;  // unsort
  out_w[dst] = bw;
  out_i[dst] = bi;
}

using RunsKernel = void (*)(const int*, int64_t, int64_t, const int64_t*,
                            const int*, const int2*, const int*, int*, int*,
                            int, int, int, int);

// Queries a thread: two hold 2 * MAXC codes in registers, so up to 32
// criteria; one above.
int qpt_for(int n_crit) { return n_crit <= 32 ? 2 : 1; }

template <int NT>
RunsKernel pick_nt(int n_crit) {
  if (n_crit < 1 || n_crit > kMaxCrit) return nullptr;
  if (n_crit <= 8) return rule_match_runs<NT, 8, 2>;
  if (n_crit <= 16) return rule_match_runs<NT, 16, 2>;
  if (n_crit <= 32) return rule_match_runs<NT, 32, 2>;
  return rule_match_runs<NT, 64, 1>;
}

RunsKernel pick(int n_crit, int threads) {
  if (threads == 128) return pick_nt<128>(n_crit);
  if (threads == 256) return pick_nt<256>(n_crit);
  return nullptr;
}

// Threads a block: 256 once the batch fills two of their tiles (half the
// passes over the table), else 128 (twice the blocks on a small batch).
int threads_for(int B, int qpt) { return B >= 2 * 256 * qpt ? 256 : 128; }

// Allow the ring's dynamic shared memory: with the static code lists it
// passes the 48 KB that needs no opt-in at C = 31.
cudaError_t prepare(RunsKernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

// Grid of one call on the current device: plan = {n_runs, run, n_btiles,
// smem bytes, blocks per SM, SMs, threads a block, queries a thread}.
// Returns a CUDA error code (0 == ok).
extern "C" int rule_match_plan(int n_crit, int B, int R, int* plan) {
  const int qpt = qpt_for(n_crit);
  const int threads = B >= 1 ? threads_for(B, qpt) : 128;
  RunsKernel kernel = pick(n_crit, threads);
  if (!kernel || B < 1 || R < 2 || R % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kRing * slot_bytes(n_crit);
  cudaError_t err = prepare(kernel, smem);
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int per_block = threads * qpt;
  const int n_btiles = (B + per_block - 1) / per_block;
  if (n_btiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // one wave: split the rules of each batch tile over the resident slots,
  // at least one stage of rules a run
  int n_runs = (sms * per_sm) / n_btiles;
  n_runs = std::max(n_runs, (R + kMaxRun - 1) / kMaxRun);
  n_runs = std::max(1, std::min(n_runs, (R + kStage - 1) / kStage));
  int run = (R + n_runs - 1) / n_runs;
  run = (run + kRunAlign - 1) / kRunAlign * kRunAlign;
  n_runs = (R + run - 1) / run;
  plan[0] = n_runs;
  plan[1] = run;
  plan[2] = n_btiles;
  plan[3] = smem;
  plan[4] = per_sm;
  plan[5] = sms;
  plan[6] = threads;
  plan[7] = qpt;
  return 0;
}

// Launches both passes on `stream`: part_w/part_i are (n_runs, B) scratch,
// out_w/out_i (B,). order (B,) int64 may be null (identity). Returns
// cudaGetLastError() after the launches (0 == ok).
extern "C" int rule_match_packed_launch(
    const void* queries, long long q_row, long long q_col, void* order,
    int sort_col, const void* crit, const void* bounds, const void* weights,
    void* part_w, void* part_i, void* out_w, void* out_i, int n_crit, int B,
    int R, int threads, int n_runs, int run, void* stream) {
  RunsKernel kernel = pick(n_crit, threads);
  if (!kernel || B < 1 || R < 2 || R % 2 != 0 || run < 1 ||
      run % kRunAlign != 0 || n_runs < 1 ||
      static_cast<int64_t>(n_runs) * run < R ||
      static_cast<int64_t>(n_runs - 1) * run >= R ||
      (sort_col >= 0 && (sort_col >= n_crit || B > kSortMax || !order)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = threads * qpt_for(n_crit);
  const int n_btiles = (B + per_block - 1) / per_block;
  if (n_btiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kRing * slot_bytes(n_crit);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t* ord = static_cast<int64_t*>(order);
  if (sort_col >= 0) {
    int n_pow2 = 1;
    while (n_pow2 < B) n_pow2 <<= 1;
    const int sort_smem = n_pow2 * static_cast<int>(sizeof(unsigned long long));
    rule_match_sort<<<1, kSortThreads, sort_smem, s>>>(
        static_cast<const int*>(queries), q_row, q_col, sort_col, B, n_pow2,
        ord);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int* pw = static_cast<int*>(part_w);
  int* pi = static_cast<int*>(part_i);
  kernel<<<dim3(n_runs, n_btiles), threads, smem, s>>>(
      static_cast<const int*>(queries), q_row, q_col, ord,
      static_cast<const int*>(crit), static_cast<const int2*>(bounds),
      static_cast<const int*>(weights), pw, pi, n_crit, B, R, run);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rule_match_reduce<<<(B + kReduceQ - 1) / kReduceQ,
                      dim3(kReduceQ, kReduceSlices), 0, s>>>(
      pw, pi, ord, static_cast<int*>(out_w), static_cast<int*>(out_i), n_runs,
      B);
  return static_cast<int>(cudaGetLastError());
}
