// K3: best_from_slots -- per row of the two-pass hashed slot table, the
// own-label connection and the best feasible other label; and the fused
// K3, which builds that table itself in shared memory.
//
// Replaces the TPU kernel kaminpar_tpu/ops/rating.py::best_from_slots_pallas
// and, with require_fit, the masked reduction rating.best_from_slots that
// the scatter rating engine and two-hop clustering call.  Per row:
//   w_own = max(0, max slot weight whose label is the row's own label);
//   among slots with label >= 0, label != own and (unless require_fit is
//   off) cluster_weights[l] + node_w[row] <= cap[l] in wrapping int32:
//   the lexicographic max of (weight, hash_u32(label, salt), label);
//   best = that label and its weight, or -1 / INT32_MIN when no slot is
//   feasible or the best weight is INT32_MIN.
// That lexicographic max is exactly the JAX three-stage reduction (max
// weight, then max hash among the tied, then max label).  RowArgmax is
// that reduction for one row, by one warp; every kernel below uses it.
//
// Standalone (kp_best_from_slots): the table comes from device memory.
// It takes the same communities restriction as the fused kernel (below)
// and a label range: with has_range, a label l is feasible only where
// lo <= l < hi (the dist path's local-lp clusterer, which joins only
// clusters led by a node of its own shard); w_own does not depend on
// either mask.
// Bound on the H100: bytes.  The two slot tables (n_pad * S * 8 bytes)
// are read once; the cluster-weight lookups hit L2.  Design: one warp per
// row, each lane strides over the S = 2 * num_slots slots with coalesced
// loads, keeps its own running best, and a shuffle butterfly merges the
// 32 candidates; lane 0 writes the three outputs.
//
// Fused (kp_scatter_best_from_slots): rating.scatter_slot_ratings followed
// by the reduction above, for the edges of each row's span [start, end)
// (clipped to the slot buffer), with the neighbour labels labels[dst]
// gathered here.  Per row and pass p (salt s1 = salt, s2 = salt ^
// 0x5851F42D in the low 32 bits), for each edge whose label nb >= 0:
//   slot = hash_u32(nb, s_p) % num_slots;
//   key  = ((hash_u32(nb, s_p ^ 0x3779B97F) & key_mask) << label_bits) | nb;
// the slot's winner is the edge label of its largest key, and the edges
// of the winner add their weights into the slot (wrapping int32); pass 2
// takes only the edges that lost pass 1, and a row whose edge also lost
// pass 2 is not fully rated.  The tables never leave shared memory: the
// row's four outputs (best, best_w, w_own, fully_rated) are all it writes.
// With communities (a nullable int32[n], the v-cycle's community
// restriction), a label l is feasible for row u only where
// communities[clamp(l, 0, n - 1)] == communities[u]: one load of the row's
// community, then one dependent load and a compare per candidate; w_own and
// fully_rated do not depend on it.  A null pointer leaves the kernel as it
// was: the test is a branch on a kernel parameter.
// The tables are filled by shared-memory atomicMax / atomicAdd on int32,
// native on Hopper and exact in any order, so the result is bitwise the
// plain torch composition's.
// Bound on the H100: bytes.  Spans (8 n), each span edge's dst and w and
// its label gather (12 per edge), labels, node weights, cluster weights
// and caps (16 n) and the outputs (13 n); the operations (three hashes and
// a few compares per edge, one hash per slot) take about 60% of that time.
// Design: the phases of a row are (1) pass-1 winner keys, (2) pass-1
// weights and the pass-2 keys of the edges that lost, (3) pass-2 weights
// and the row's lost flag, (4) the arg-max; a barrier separates them.
// Light rows (at most kLightMax edges, most rows) take one warp each, the
// edges held in registers across the phases, kLightEdges per lane; the
// warp appends a longer row to a device-side list instead.  A light row is
// bound by the instructions it issues, not by memory: its loops stop at
// its last edge, a power-of-two num_slots takes a mask instead of `%`,
// and its arg-max reads the slots its edges won (ceil(L / 32) per lane)
// instead of all 2 num_slots.  A second kernel, launched behind the first
// with no host sync, walks the list with a grid-stride loop, one whole
// block (kHeavyThreads) per heavy row: the row's edges are re-read in each
// phase (L1/L2 hits), kUnroll per thread in flight, so a hub row of
// thousands of edges takes a few passes of the block rather than one
// warp's hundreds.
#include <cuda_runtime.h>
#include <stdint.h>

#define KP_INT32_MIN (-2147483647 - 1)

// segments.hash_u32: murmur3-style finalizer in wrapping uint32, then >> 1
__device__ __forceinline__ int32_t kp_hash_u32(int32_t x, uint32_t salt) {
  uint32_t h = (uint32_t)x * 0x9E3779B1u + salt;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return (int32_t)(h >> 1);
}

__device__ __forceinline__ bool kp_better(int32_t w, int32_t h, int32_t l,
                                          int32_t bw, int32_t bh,
                                          int32_t bl) {
  if (w != bw) return w > bw;
  if (h != bh) return h > bh;
  return l > bl;
}

struct RowBest {
  int32_t best, best_w, w_own;
};

// The row reduction, split in two so that both kernels share it: each
// lane of a warp add()s the candidates (label, weight) it sees, then
// result() merges the 32 lanes (all of them call it; every lane gets the
// row's result).  A candidate repeated, or an empty slot (label -1,
// weight 0), leaves the result as it is.
struct RowArgmax {
  int32_t own, nw;
  const int32_t* __restrict__ cw;
  const int32_t* __restrict__ cap;
  int C;
  uint32_t salt;
  int require_fit;
  // communities: null, or the rows' communities (n entries) and the row's
  const int32_t* __restrict__ comm = nullptr;
  int n = 0;
  int32_t own_comm = 0;
  // label range: with has_range, only labels in [lo, hi) are feasible
  int has_range = 0;
  int32_t lo = 0, hi = 0;
  int32_t w_own = 0, bw = KP_INT32_MIN, bh = -1, bl = -1;

  __device__ __forceinline__ RowArgmax(int32_t own_, int32_t nw_,
                                       const int32_t* cw_,
                                       const int32_t* cap_, int C_,
                                       uint32_t salt_, int require_fit_)
      : own(own_), nw(nw_), cw(cw_), cap(cap_), C(C_), salt(salt_),
        require_fit(require_fit_) {}

  __device__ __forceinline__ void add(int32_t lab, int32_t w) {
    if (lab == own && w > w_own) w_own = w;
    bool feas = lab >= 0 && lab != own;
    if (feas && has_range) feas = lab >= lo && lab < hi;
    if (feas && require_fit) {
      const int32_t c = lab >= C ? C - 1 : lab;
      const int32_t sum = (int32_t)((uint32_t)__ldg(cw + c) + (uint32_t)nw);
      feas = sum <= __ldg(cap + c);
    }
    if (feas && comm != nullptr) {
      feas = __ldg(comm + (lab >= n ? n - 1 : lab)) == own_comm;
    }
    if (feas) {
      const int32_t h = kp_hash_u32(lab, salt);
      if (kp_better(w, h, lab, bw, bh, bl)) {
        bw = w;
        bh = h;
        bl = lab;
      }
    }
  }

  __device__ __forceinline__ RowBest result() {
    for (int off = 16; off > 0; off >>= 1) {
      const int32_t ow = __shfl_xor_sync(0xffffffffu, bw, off);
      const int32_t oh = __shfl_xor_sync(0xffffffffu, bh, off);
      const int32_t ol = __shfl_xor_sync(0xffffffffu, bl, off);
      const int32_t oo = __shfl_xor_sync(0xffffffffu, w_own, off);
      if (kp_better(ow, oh, ol, bw, bh, bl)) {
        bw = ow;
        bh = oh;
        bl = ol;
      }
      if (oo > w_own) w_own = oo;
    }
    const bool has = bl >= 0 && bw > KP_INT32_MIN;
    return RowBest{has ? bl : -1, has ? bw : KP_INT32_MIN, w_own};
  }
};

// The row reduction over a table of S slots by one warp: slots(j,
// &label, &weight) reads slot j.
template <class Slots>
__device__ __forceinline__ RowBest kp_row_best(const Slots& slots, int S,
                                               RowArgmax acc) {
  for (int j = threadIdx.x & 31; j < S; j += 32) {
    int32_t lab, w;
    slots(j, lab, w);
    acc.add(lab, w);
  }
  return acc.result();
}

// ---------------------------------------------------------- standalone K3

struct GlobalSlots {
  const int32_t* __restrict__ lab;
  const int32_t* __restrict__ w;
  __device__ __forceinline__ void operator()(int j, int32_t& l,
                                             int32_t& x) const {
    l = __ldg(lab + j);
    x = __ldg(w + j);
  }
};

__global__ void best_from_slots_kernel(
    const int32_t* __restrict__ slot_label, const int32_t* __restrict__ slot_w,
    const int32_t* __restrict__ labels, const int32_t* __restrict__ cw,
    const int32_t* __restrict__ node_w, const int32_t* __restrict__ cap,
    int32_t* __restrict__ out_best, int32_t* __restrict__ out_w,
    int32_t* __restrict__ out_own, long long n_rows, int S, int C,
    uint32_t salt, int require_fit, const int32_t* __restrict__ comm,
    int has_range, int32_t lo, int32_t hi) {
  const long long warps_per_block = blockDim.x >> 5;
  const long long first = (long long)blockIdx.x * warps_per_block +
                          (threadIdx.x >> 5);
  const long long step = (long long)gridDim.x * warps_per_block;
  for (long long row = first; row < n_rows; row += step) {
    RowArgmax acc(__ldg(labels + row), __ldg(node_w + row), cw, cap, C, salt,
                  require_fit);
    if (comm != nullptr) {
      acc.comm = comm;
      acc.n = (int)n_rows;
      acc.own_comm = __ldg(comm + row);
    }
    acc.has_range = has_range;
    acc.lo = lo;
    acc.hi = hi;
    const RowBest r = kp_row_best(
        GlobalSlots{slot_label + row * S, slot_w + row * S}, S, acc);
    if ((threadIdx.x & 31) == 0) {
      out_best[row] = r.best;
      out_w[row] = r.best_w;
      out_own[row] = r.w_own;
    }
  }
}

extern "C" int kp_best_from_slots(const void* slot_label, const void* slot_w,
                                  const void* labels, const void* cw,
                                  const void* node_w, const void* cap,
                                  void* out_best, void* out_w, void* out_own,
                                  long long n_rows, int S, int C,
                                  unsigned int salt, int require_fit,
                                  const void* communities, int has_range,
                                  int lo, int hi, void* stream) {
  if (n_rows > 0) {
    const int threads = 256;  // 8 rows per block
    long long blocks = (n_rows + 7) / 8;
    if (blocks > 132LL * 64) blocks = 132LL * 64;
    best_from_slots_kernel<<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
        (const int32_t*)slot_label, (const int32_t*)slot_w,
        (const int32_t*)labels, (const int32_t*)cw, (const int32_t*)node_w,
        (const int32_t*)cap, (int32_t*)out_best, (int32_t*)out_w,
        (int32_t*)out_own, n_rows, S, C, salt, require_fit,
        (const int32_t*)communities, has_range, lo, hi);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- fused K3

namespace {

constexpr int kLightThreads = 256;            // 8 warps, one row each
constexpr int kLightEdges = 8;                // edges per lane in registers
constexpr int kLightMax = 32 * kLightEdges;   // longest row a warp takes
constexpr int kHeavyThreads = 1024;           // one block per heavy row
constexpr int kUnroll = 4;                    // heavy: edges in flight
constexpr int kMaxFusedSlots = 256;           // num_slots the kernel takes

struct Fused {
  const int32_t* __restrict__ start;
  const int32_t* __restrict__ end;
  const int32_t* __restrict__ dst;
  const int32_t* __restrict__ w;
  const int32_t* __restrict__ labels;
  const int32_t* __restrict__ cw;
  const int32_t* __restrict__ node_w;
  const int32_t* __restrict__ cap;
  const int32_t* __restrict__ comm;  // null: no community restriction
  int32_t* out_best;
  int32_t* out_w;
  int32_t* out_own;
  uint8_t* out_full;
  int32_t* heavy;  // heavy[0]: count; heavy[1 + i]: the i-th heavy row
  int n, D, C, num_slots, label_bits;
  int slot_mask;  // num_slots - 1 when a power of two, else -1
  uint32_t salt1, salt2, ksalt1, ksalt2;
  int require_fit;
};

// The tables of one row: key[2 S1] (pass 1 then pass 2; -1 = empty) and
// w[2 S1].  A slot's label is its key's low label_bits, or -1 when empty.
struct KeySlots {
  const int32_t* key;
  const int32_t* w;
  int32_t lab_mask;
  __device__ __forceinline__ void operator()(int j, int32_t& l,
                                             int32_t& x) const {
    const int32_t k = key[j];
    l = k >= 0 ? (k & lab_mask) : -1;
    x = w[j];
  }
};

__device__ __forceinline__ void clipped_span(const Fused& p, int row, int& s,
                                             int& e) {
  e = __ldg(p.end + row);
  e = e < 0 ? 0 : (e > p.D ? p.D : e);
  s = __ldg(p.start + row);
  s = s < 0 ? 0 : (s > e ? e : s);
}

// the clipped target of buffer slot j; its label is read separately, so
// that a batch issues all its dst loads before any label load
__device__ __forceinline__ int32_t target(const Fused& p, int j) {
  const int32_t d = __ldg(p.dst + j);
  return d < 0 ? 0 : (d >= p.n ? p.n - 1 : d);
}

// the edge's label clipped to the row domain, or -1 when it does not count
__device__ __forceinline__ int32_t edge_label(const Fused& p, int32_t d) {
  const int32_t lab = __ldg(p.labels + d);
  return lab < 0 ? -1 : (lab >= p.n ? p.n - 1 : lab);
}

// hash_u32(nb, salt) % num_slots; the hash is non-negative, so a power
// of two takes a mask (an integer division costs some twenty instructions)
__device__ __forceinline__ int slot_of(int32_t nb, uint32_t salt,
                                       const Fused& p) {
  const int32_t h = kp_hash_u32(nb, salt);
  return p.slot_mask >= 0 ? (h & p.slot_mask) : h % p.num_slots;
}

__device__ __forceinline__ int32_t key_of(int32_t nb, uint32_t ksalt,
                                          const Fused& p) {
  const int32_t key_mask = (int32_t)((1u << (31 - p.label_bits)) - 1u);
  return ((kp_hash_u32(nb, ksalt) & key_mask) << p.label_bits) | nb;
}

__device__ __forceinline__ void write_row(const Fused& p, int row,
                                          const RowBest& r, bool full) {
  p.out_best[row] = r.best;
  p.out_w[row] = r.best_w;
  p.out_own[row] = r.w_own;
  p.out_full[row] = full ? 1 : 0;
}

__device__ __forceinline__ RowArgmax row_argmax(const Fused& p, int row) {
  RowArgmax acc(__ldg(p.labels + row), __ldg(p.node_w + row), p.cw, p.cap,
                p.C, p.salt1, p.require_fit);
  if (p.comm != nullptr) {
    acc.comm = p.comm;
    acc.n = p.n;
    acc.own_comm = __ldg(p.comm + row);
  }
  return acc;
}

// Shared memory: per warp, key[2 S1] then w[2 S1].
__global__ void __launch_bounds__(kLightThreads)
fused_light_kernel(Fused p) {
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int S1 = p.num_slots, S = 2 * S1;
  int32_t* key = smem + warp * 2 * S;
  int32_t* wt = key + S;
  const int32_t lab_mask = (int32_t)((1u << p.label_bits) - 1u);
  const int warps = kLightThreads / 32;
  for (int row = blockIdx.x * warps + warp; row < p.n;
       row += gridDim.x * warps) {
    int s, e;
    clipped_span(p, row, s, e);
    const int L = e - s;
    if (L == 0) {  // an empty span: no slot, nothing contested
      if (lane == 0) {
        write_row(p, row, RowBest{-1, KP_INT32_MIN, 0}, true);
      }
      continue;
    }
    if (L > kLightMax) {  // left to the heavy kernel
      if (lane == 0) p.heavy[1 + atomicAdd(p.heavy, 1)] = row;
      continue;
    }
    // register u of a lane holds edge s + lane + 32 u; the loops stop at
    // the row's last register, a branch that the warp takes as one.
    // nb: the edge's label, or -1 when it does not count.  slot: the
    // edge's slot in pass 1 (< S1) or pass 2 (>= S1), -1 once it lost both.
    int32_t nb[kLightEdges], we[kLightEdges], slot[kLightEdges];
#pragma unroll
    for (int u = 0; u < kLightEdges; ++u) {
      if (32 * u >= L) break;
      const int j = s + lane + 32 * u;
      we[u] = j < e ? __ldg(p.w + j) : 0;
      slot[u] = j < e ? target(p, j) : -1;  // the target, for now
    }
#pragma unroll
    for (int u = 0; u < kLightEdges; ++u) {
      if (32 * u >= L) break;
      nb[u] = slot[u] >= 0 ? edge_label(p, slot[u]) : -1;
    }
    for (int j = lane; j < S; j += 32) {
      key[j] = -1;
      wt[j] = 0;
    }
    __syncwarp();
    // (1) pass-1 winner keys
#pragma unroll
    for (int u = 0; u < kLightEdges; ++u) {
      if (32 * u >= L) break;
      if (nb[u] >= 0) {
        slot[u] = slot_of(nb[u], p.salt1, p);
        atomicMax(key + slot[u], key_of(nb[u], p.ksalt1, p));
      }
    }
    __syncwarp();
    // (2) pass-1 weights; the losers' pass-2 keys
#pragma unroll
    for (int u = 0; u < kLightEdges; ++u) {
      if (32 * u >= L) break;
      if (nb[u] >= 0) {
        if ((key[slot[u]] & lab_mask) == nb[u]) {
          atomicAdd(wt + slot[u], we[u]);
        } else {
          slot[u] = S1 + slot_of(nb[u], p.salt2, p);
          atomicMax(key + slot[u], key_of(nb[u], p.ksalt2, p));
        }
      }
    }
    __syncwarp();
    // (3) pass-2 weights; the row's lost flag
    bool lost = false;
#pragma unroll
    for (int u = 0; u < kLightEdges; ++u) {
      if (32 * u >= L) break;
      if (nb[u] >= 0 && slot[u] >= S1) {
        if ((key[slot[u]] & lab_mask) == nb[u]) {
          atomicAdd(wt + slot[u], we[u]);
        } else {
          lost = true;
          slot[u] = -1;
        }
      }
    }
    const bool full = !__any_sync(0xffffffffu, lost);
    __syncwarp();
    // (4) the arg-max.  Every slot that holds a label holds it for the
    // edges that won it, so the lanes offer their winning edges' slots
    // instead of the 2 S1 slots: a row of L edges reads ceil(L / 32)
    // candidates per lane rather than 2 S1 / 32.
    RowArgmax acc = row_argmax(p, row);
#pragma unroll
    for (int u = 0; u < kLightEdges; ++u) {
      if (32 * u >= L) break;
      if (nb[u] >= 0 && slot[u] >= 0) acc.add(nb[u], wt[slot[u]]);
    }
    const RowBest r = acc.result();
    if (lane == 0) write_row(p, row, r, full);
    __syncwarp();  // the next row's reset waits for every lane's reads
  }
}

// One block per heavy row; shared memory: key[2 S1] then w[2 S1].
__global__ void __launch_bounds__(kHeavyThreads)
fused_heavy_kernel(Fused p) {
  extern __shared__ int32_t smem[];
  const int S1 = p.num_slots, S = 2 * S1;
  int32_t* key = smem;
  int32_t* wt = smem + S;
  const int32_t lab_mask = (int32_t)((1u << p.label_bits) - 1u);
  const int count = p.heavy[0];
  for (int h = blockIdx.x; h < count; h += gridDim.x) {
    const int row = p.heavy[1 + h];
    int s, e;
    clipped_span(p, row, s, e);
    for (int j = threadIdx.x; j < S; j += kHeavyThreads) {
      key[j] = -1;
      wt[j] = 0;
    }
    __syncthreads();
    int lost = 0;
    // phases 1-3: the same steps as the light kernel, each over the span
    for (int phase = 1; phase <= 3; ++phase) {
      for (int base = s + threadIdx.x; base < e;
           base += kHeavyThreads * kUnroll) {
        int32_t nb[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = base + u * kHeavyThreads;
          nb[u] = j < e ? target(p, j) : -1;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          nb[u] = nb[u] >= 0 ? edge_label(p, nb[u]) : -1;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (nb[u] < 0) continue;
          const int j = base + u * kHeavyThreads;
          const int s1 = slot_of(nb[u], p.salt1, p);
          if (phase == 1) {
            atomicMax(key + s1, key_of(nb[u], p.ksalt1, p));
            continue;
          }
          const bool win1 = (key[s1] & lab_mask) == nb[u];
          if (phase == 2 && win1) {
            atomicAdd(wt + s1, __ldg(p.w + j));
            continue;
          }
          if (win1) continue;
          const int s2 = S1 + slot_of(nb[u], p.salt2, p);
          if (phase == 2) {
            atomicMax(key + s2, key_of(nb[u], p.ksalt2, p));
          } else if ((key[s2] & lab_mask) == nb[u]) {
            atomicAdd(wt + s2, __ldg(p.w + j));
          } else {
            lost = 1;
          }
        }
      }
      if (phase < 3) __syncthreads();
    }
    const bool full = __syncthreads_or(lost) == 0;
    if (threadIdx.x < 32) {
      const RowBest r = kp_row_best(KeySlots{key, wt, lab_mask}, S,
                                    row_argmax(p, row));
      if (threadIdx.x == 0) write_row(p, row, r, full);
    }
    __syncthreads();  // the next row's reset waits for the reduction
  }
}

}  // namespace

// n rows (the labels' length, below 2^31), D buffer slots (dst and w);
// heavy: int32[n + 1] scratch.  out_full is one byte per row (0 / 1).
// communities: null, or int32[n].
// Returns cudaErrorInvalidValue for a num_slots outside [1, 256] or a
// label_bits outside [1, 27].
extern "C" int kp_scatter_best_from_slots(
    const void* start, const void* end, const void* dst, const void* w,
    const void* labels, const void* cw, const void* node_w, const void* cap,
    const void* communities, void* out_best, void* out_w, void* out_own,
    void* out_full, void* heavy, int n, int D, int C, int num_slots,
    int label_bits, unsigned int salt, int require_fit, void* stream) {
  if (num_slots < 1 || num_slots > kMaxFusedSlots || label_bits < 1 ||
      label_bits > 27) {
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  Fused p;
  p.start = (const int32_t*)start;
  p.end = (const int32_t*)end;
  p.dst = (const int32_t*)dst;
  p.w = (const int32_t*)w;
  p.labels = (const int32_t*)labels;
  p.cw = (const int32_t*)cw;
  p.node_w = (const int32_t*)node_w;
  p.cap = (const int32_t*)cap;
  p.comm = (const int32_t*)communities;
  p.out_best = (int32_t*)out_best;
  p.out_w = (int32_t*)out_w;
  p.out_own = (int32_t*)out_own;
  p.out_full = (uint8_t*)out_full;
  p.heavy = (int32_t*)heavy;
  p.n = n;
  p.D = D;
  p.C = C;
  p.num_slots = num_slots;
  p.label_bits = label_bits;
  p.slot_mask = (num_slots & (num_slots - 1)) == 0 ? num_slots - 1 : -1;
  p.salt1 = salt;
  p.salt2 = salt ^ 0x5851F42Du;
  p.ksalt1 = p.salt1 ^ 0x3779B97Fu;
  p.ksalt2 = p.salt2 ^ 0x3779B97Fu;
  p.require_fit = require_fit;
  cudaError_t err = cudaMemsetAsync(heavy, 0, sizeof(int32_t), st);
  if (err != cudaSuccess) return (int)err;

  const int warps = kLightThreads / 32;
  long long blocks = ((long long)n + warps - 1) / warps;
  if (blocks > 132LL * 32) blocks = 132LL * 32;
  const size_t light_smem = (size_t)warps * 4 * num_slots * sizeof(int32_t);
  fused_light_kernel<<<(unsigned)blocks, kLightThreads, light_smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // at most min(n, D / (kLightMax + 1)) heavy rows
  long long most = (long long)D / (kLightMax + 1);
  if (most > n) most = n;
  if (most > 0) {
    long long hb = most < 132LL * 2 ? most : 132LL * 2;
    fused_heavy_kernel<<<(unsigned)hb, kHeavyThreads,
                         (size_t)4 * num_slots * sizeof(int32_t), st>>>(p);
  }
  return (int)cudaGetLastError();
}
