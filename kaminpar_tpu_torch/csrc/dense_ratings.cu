// K2: dense_block_ratings -- the exact i32[n, k] table
//   conn[u, clip(labels[dst[e]], 0, k-1)] += w[e]  for e in row u's span,
// with each span [start[u], end[u]) clipped to [0, S), S = the slot count.
// The label table has L entries, L = n on the shared-memory path; a shard
// of the dist path passes its owned labels followed by its ghost labels
// (L = n_loc + g_loc > n).  dst indexes the table, clamped into [0, L).
//
// Replaces the gather-then-accumulate around the TPU kernel
// kaminpar_tpu/ops/lane_gather.py::lane_gather as routed_block_ratings
// (lane_gather.py:451) uses it, and segments.dense_block_ratings
// (segments.py:461): the neighbour-block lookup is fused into the
// accumulation, so the gathered labels never reach device memory.
//
//
// Precondition: the spans are in row order and do not overlap
// (start[u] <= end[u] <= start[u+1] after clipping), as CSR offsets and
// the compacted spans of an LP delta round are.  Slots outside every span
// (edge padding, the unused tail of a delta buffer) are never read.
//
// Bound on the H100: bytes.  The spans (8 n), the covered slots' dst and
// w (8 per edge, streamed), the labels (4 n, read at random but small
// enough to stay in the 50 MB L2) and the table, written once (4 n k).
//
// Design.  The work of a call is a merge path over rows and slots (the
// CSR merge-based decomposition of Merrill and Garland): a row costs
// RC = max(k, 8) units (its k counters are zeroed and stored), a slot one
// unit, and block c takes the units [c D, (c+1) D) (D = kCost = 4096).
// So every block has at most about D slots and ceil(D / RC) + 1 rows,
// whatever the degree skew: a hub row of 45k
// edges is cut over a dozen blocks, and a run of empty padding rows is
// cut the same way.  plan_kernel finds each block's first row and
// first slot by a binary search over the clipped ends.  The block keeps
// its rows' k counters in shared memory and adds into them with shared
// atomics (integer adds are exact in any order), then stores each row it
// owns once, coalesced, zeros included: there is no memset of the table.
// A row cut by a block boundary is the exception: plan_kernel zeroes it,
// and every block that holds part of it adds its partial counters with
// global atomics, so the blocks meet exactly.  dst and w are read
// through the read-only path, kUnroll = 16 slots in flight per thread;
// evict-first loads of them (meant to keep the labels in L2) and other
// values of D and kUnroll changed the time by under 10% on the H100
// (PERF.md), so they are fixed.
//
// Large k: a block's rows hold fewer than D + 2 RC counters, which fit
// shared memory for k <= 2048.  Above that, the table is zeroed with
// cudaMemsetAsync and the same plan feeds blocks that add each edge into
// the table with a global atomic (RC = 8 then only bounds the rows whose
// spans a block looks up).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSharedK = 2048;      // largest k kept in shared memory
constexpr int kMinRowCost = 8;
constexpr long long kCost = 4096;      // units of work per block (D)
constexpr int kUnroll = 16;            // slots in flight per thread

__host__ __device__ inline long long row_cost(int k) {
  return k <= kMaxSharedK ? (k > kMinRowCost ? k : kMinRowCost)
                          : kMinRowCost;
}

// most rows a block can touch, rounded up to whole 16-byte vectors
constexpr int kMaxRows = (int)((kCost / kMinRowCost + 2 + 3) / 4 * 4);

// counters of a block's rows, rounded up to whole 16-byte vectors
inline int counter_ints(int k) {
  long long rc = row_cost(k);
  long long rows = (kCost + rc - 1) / rc + 1;
  return (int)((rows * k + 3) / 4 * 4);
}

__device__ __forceinline__ long long clip_slot(long long v, long long S) {
  return v < 0 ? 0 : (v > S ? S : v);
}

// clipped end of row i (i >= 0); the clipped end before row 0 is 0
__device__ __forceinline__ long long end_at(const int32_t* end, long long i,
                                            long long S) {
  return i < 0 ? 0 : clip_slot(__ldg(end + i), S);
}

// The merge-path state at cost d: the largest row count i in [0, n] with
// i * rc + end(i - 1) <= d, and the slot j reached at that row count.
__device__ void split_at(const int32_t* end, long long n, long long S,
                         long long rc, long long d, long long* i_out,
                         long long* j_out) {
  long long lo = 0, hi = n;  // invariant: cost(lo) <= d
  while (lo < hi) {
    long long mid = (lo + hi + 1) >> 1;
    if (mid * rc + end_at(end, mid - 1, S) <= d) lo = mid;
    else hi = mid - 1;
  }
  long long j = d - lo * rc;
  long long cap = end_at(end, lo < n ? lo : n - 1, S);
  *i_out = lo;
  *j_out = j < cap ? j : cap;
}

// plan[c] = first row of block c, plan[nblocks + 1 + c] = its first slot,
// for c in [0, nblocks]; with zero_cut, a row cut by the boundary of
// block c (it has slots before it and is owned after it) is zeroed.
__global__ void plan_kernel(const int32_t* __restrict__ start,
                            const int32_t* __restrict__ end,
                            int32_t* __restrict__ conn, int32_t* plan,
                            long long n, long long S, int k, long long rc,
                            long long nblocks, bool zero_cut) {
  long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c > nblocks) return;
  long long i, j;
  split_at(end, n, S, rc, c * kCost, &i, &j);
  plan[c] = (int32_t)i;
  plan[nblocks + 1 + c] = (int32_t)j;
  if (zero_cut && i < n) {
    long long s = clip_slot(__ldg(start + i), S);
    if (s < j) {
      int32_t* row = conn + i * k;
      for (int b = 0; b < k; ++b) row[b] = 0;
    }
  }
}

// One batch of a block's slots: kUnroll per thread, neighbouring threads
// on neighbouring slots.  Each weight, and each label of a slot with a
// weight, the index clamped into the table.
__device__ __forceinline__ void load_batch(
    const int32_t* __restrict__ dst, const int32_t* __restrict__ w,
    const int32_t* __restrict__ labels, int base, int j1, int nl,
    int32_t (&we)[kUnroll], int32_t (&lab)[kUnroll]) {
  int32_t d[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    int j = base + u * kThreads + threadIdx.x;
    bool in = j < j1;
    we[u] = in ? __ldg(w + j) : 0;
    d[u] = in ? __ldg(dst + j) : 0;
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    int dc = d[u] < 0 ? 0 : (d[u] >= nl ? nl - 1 : d[u]);
    lab[u] = we[u] != 0 ? __ldg(labels + dc) : 0;
  }
}

// Shared memory: the spans of the block's rows (kMaxRows each), then
// (kShared) their counters.
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
ratings_kernel(const int32_t* __restrict__ start,
               const int32_t* __restrict__ end,
               const int32_t* __restrict__ dst, const int32_t* __restrict__ w,
               const int32_t* __restrict__ labels, int32_t* __restrict__ conn,
               const int32_t* __restrict__ plan, int n, int nl, int S, int k,
               int nblocks) {
  extern __shared__ int4 smem[];
  int32_t* row_s = reinterpret_cast<int32_t*>(smem);
  int32_t* row_e = row_s + kMaxRows;
  int32_t* counters = row_e + kMaxRows;

  const int c = blockIdx.x;
  const int i0 = plan[c], i1 = plan[c + 1];
  const int j0 = plan[nblocks + 1 + c], j1 = plan[nblocks + 2 + c];
  if (i0 >= n) return;
  // rows [i0, i1) are owned here; row i1 (if any) may get a partial sum
  const int last = i1 < n ? i1 : n - 1;
  const int nr = last - i0 + 1;

  // the block's slots, kUnroll in flight per thread; neighbouring threads
  // take neighbouring slots, so the label reads of a warp share sectors where
  // a row's sorted neighbours lie close.  The first batch's loads go out
  // before the spans are staged, so the two latencies overlap; a
  // label is read before its slot's row is known (the index clamped into
  // the table, the value used only for a slot inside a span).
  int32_t we[kUnroll], lab[kUnroll];
  load_batch(dst, w, labels, j0, j1, nl, we, lab);

  for (int r = threadIdx.x; r < nr; r += kThreads) {
    int e = (int)clip_slot(__ldg(end + i0 + r), S);
    int s = (int)clip_slot(__ldg(start + i0 + r), S);
    row_s[r] = s < e ? s : e;
    row_e[r] = e;
  }
  const int nvec = (nr * k + 3) / 4;
  if (kShared) {
    int4* cv = reinterpret_cast<int4*>(counters);
    for (int t = threadIdx.x; t < nvec; t += kThreads) {
      cv[t] = make_int4(0, 0, 0, 0);
    }
  }
  __syncthreads();

  for (int base = j0; base < j1; base += kUnroll * kThreads) {
    if (base != j0) {
      load_batch(dst, w, labels, base, j1, nl, we, lab);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      int j = base + u * kThreads + threadIdx.x;
      if (we[u] == 0) continue;
      // first row whose end is past j
      int lo = 0, hi = nr - 1;
      while (lo < hi) {
        int mid = (lo + hi) >> 1;
        if (row_e[mid] > j) hi = mid;
        else lo = mid + 1;
      }
      if (j < row_s[lo] || j >= row_e[lo]) continue;  // not in a span
      int32_t b = lab[u] < 0 ? 0 : (lab[u] >= k ? k - 1 : lab[u]);
      if (kShared) {
        atomicAdd(counters + lo * k + b, we[u]);
      } else {
        atomicAdd(conn + (long long)(i0 + lo) * k + b, we[u]);
      }
    }
  }
  if (!kShared) return;
  __syncthreads();

  // rows stored whole: owned here and no slot of theirs before j0; the
  // rest (a row cut by a boundary) was zeroed by plan_kernel
  int32_t* out = conn + (long long)i0 * k;
  if (k % 4 == 0) {  // a 16-byte vector lies in one row
    const int4* cv = reinterpret_cast<const int4*>(counters);
    int4* ov = reinterpret_cast<int4*>(out);
    for (int t = threadIdx.x; t < nvec; t += kThreads) {
      int r = (4 * t) / k;
      int4 v = cv[t];
      if (i0 + r < i1 && row_s[r] >= j0) {
        ov[t] = v;
      } else {
        int32_t* o = out + 4 * t;
        if (v.x) atomicAdd(o, v.x);
        if (v.y) atomicAdd(o + 1, v.y);
        if (v.z) atomicAdd(o + 2, v.z);
        if (v.w) atomicAdd(o + 3, v.w);
      }
    }
  } else {
    for (int t = threadIdx.x; t < nr * k; t += kThreads) {
      int r = t / k;
      int32_t v = counters[t];
      if (i0 + r < i1 && row_s[r] >= j0) {
        out[t] = v;
      } else if (v != 0) {
        atomicAdd(out + t, v);
      }
    }
  }
}

template <bool kShared>
int launch_ratings(const void* start, const void* end, const void* dst,
                   const void* w, const void* labels, void* conn,
                   const int32_t* plan, int n, int nl, int S, int k,
                   int nblocks, cudaStream_t st) {
  size_t smem = (2 * (size_t)kMaxRows +
                 (kShared ? (size_t)counter_ints(k) : 0)) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ratings_kernel<kShared>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ratings_kernel<kShared><<<(unsigned)nblocks, kThreads, smem, st>>>(
      (const int32_t*)start, (const int32_t*)end, (const int32_t*)dst,
      (const int32_t*)w, (const int32_t*)labels, (int32_t*)conn, plan, n, nl,
      S, k, nblocks);
  return 0;
}

}  // namespace

// n rows, n_labels label entries and `slots` slots (all below 2^31);
// plan: int32[2 (nblocks + 1)] scratch, nblocks from
// kp_dense_block_ratings_blocks.
extern "C" int kp_dense_block_ratings(const void* start, const void* end,
                                      const void* dst, const void* w,
                                      const void* labels, void* conn,
                                      void* plan, long long n,
                                      long long n_labels, long long slots,
                                      int k,
                                      long long nblocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool shared = k <= kMaxSharedK;
  if (!shared) {
    cudaMemsetAsync(conn, 0, (size_t)n * k * sizeof(int32_t), st);
  }
  const int plan_threads = 256;
  plan_kernel<<<(unsigned)((nblocks + plan_threads) / plan_threads),
                plan_threads, 0, st>>>(
      (const int32_t*)start, (const int32_t*)end, (int32_t*)conn,
      (int32_t*)plan, n, slots, k, row_cost(k), nblocks, shared);
  const int32_t* p = (const int32_t*)plan;
  int code = shared
      ? launch_ratings<true>(start, end, dst, w, labels, conn, p, (int)n,
                             (int)n_labels, (int)slots, k, (int)nblocks, st)
      : launch_ratings<false>(start, end, dst, w, labels, conn, p, (int)n,
                              (int)n_labels, (int)slots, k, (int)nblocks,
                              st);
  if (code != 0) return code;
  return (int)cudaGetLastError();
}

// The block count of a call: rows cost RC units, slots one, kCost per
// block.
extern "C" long long kp_dense_block_ratings_blocks(long long n,
                                                   long long slots, int k) {
  long long b = (n * row_cost(k) + slots + kCost - 1) / kCost;
  return b > 0 ? b : 1;
}
