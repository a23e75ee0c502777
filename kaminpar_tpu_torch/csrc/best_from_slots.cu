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
// that reduction for one row, by one warp; the fused kernels use it, the
// standalone kernel has its own (RowScan, below).
//
// The 64-bit weight build (KAMINPAR_TPU_64BIT=1).  Every kernel here is a
// template over the weight type W: int32_t, or long long for the int64
// variants kp_best_from_slots_i64 and kp_scatter_best_from_slots_i64.
// There slot weights, cluster weights, caps, node weights, best_w and
// w_own are int64, the fit test wraps in int64 and the sentinel is int64's
// minimum, as the JAX package's best_from_slots_pallas under x64 (its
// output dtype follows slot_w).  Labels, hashes and the winner keys stay
// int32 in both.  The fused kernel's weight tables in shared memory grow
// to 8 bytes a slot: the light kernel's 8 warps then hold 8 * 2S * 12 B,
// 49,152 B at num_slots = 256 (the launch raises the dynamic limit where
// it must), the heavy kernel's block 6 KB; the engine choice does not
// depend on the dtype, so the int64 kernel takes every num_slots the int32
// one takes.
//
// Standalone (kp_best_from_slots): the table comes from device memory.
// It takes the same communities restriction as the fused kernel (below)
// and a label range: with has_range, a label l is feasible only where
// lo <= l < hi (the dist path's local-lp clusterer, which joins only
// clusters led by a node of its own shard); w_own does not depend on
// either mask.
// Bound on the H100: bytes.  The two slot tables (n_pad * S * (4 +
// sizeof(W)) bytes) are read once and nothing else is as large; the
// cluster-weight, cap and community lookups hit L1 or L2.  The design
// keeps the stream's bytes in flight and takes the lookups off its path:
// - Vectors.  A lane reads its slots V at a time: one 16-byte load of
//   labels and one (int32) or two (int64) of weights, V = 4, streamed
//   (__ldcs: read once, they do not evict the lookups' lines from L1).  A
//   table whose rows are not 16-byte aligned (S % 4 != 0, or a base off a
//   16-byte boundary) takes V = 2 (8-byte label loads) or V = 1; the
//   kernel is a template over V.
// - Lane groups sized to the row.  Each lane takes kVecs = 2 vectors of
//   an item, so a row of S / V vectors gets a group of G = min(32, next
//   power of two >= S / (2 V)) lanes and a warp takes 32 / G consecutive
//   rows at once (S = 128: G = 16, two rows; S = 8: one lane a row), so a
//   short row idles no lanes.  Within each of its two loads the warp reads
//   neighbouring vectors; a row longer than 2 G vectors is read in chunks.
// - Register double buffering on a persistent grid.  The grid is the SM
//   count times the blocks an SM holds (cudaOccupancy...), and each warp
//   walks its (rows, chunk) items with the next item's loads, and its rows'
//   own labels, node weights and communities, sent out before the current
//   item is reduced.
// - Feasibility after comparison.  A lane compares each slot with its best
//   feasible candidate (weight, hash, label) first, and reads cw[l], cap[l]
//   and communities[l] only for a slot that would win.  The kept candidate
//   is feasible either way, so the result is the same; a slot that cannot
//   win adds no dependent load.  w_own is taken from every slot that holds
//   the row's own label, before any mask.
// - A butterfly of width G merges each group's candidates (shuffles with
//   width G, so the groups of a warp merge at once); the group's first
//   lane writes the row's three outputs.
// Tried on the card and left out (PERF.md section 6): a ring of 4 or 8 stages
// per warp in shared memory filled by 1-D bulk copies (cp.async.bulk with
// an mbarrier), one vector or four per lane, two items in flight, a
// group-wide fit test of the row's best candidate, and eager lookups of
// every candidate: each was slower than this design.
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

// the sentinel weight of W: the minimum of the weight type
template <class W>
__device__ __forceinline__ W kp_wmin();
template <>
__device__ __forceinline__ int32_t kp_wmin<int32_t>() {
  return KP_INT32_MIN;
}
template <>
__device__ __forceinline__ long long kp_wmin<long long>() {
  return (-9223372036854775807LL - 1);
}

// a + b wrapping in W (two's complement)
__device__ __forceinline__ int32_t kp_wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ long long kp_wrap_add(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}

// shared-memory add of a weight (wrapping)
__device__ __forceinline__ void kp_add(int32_t* p, int32_t v) {
  atomicAdd(p, v);
}
__device__ __forceinline__ void kp_add(long long* p, long long v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p),
            static_cast<unsigned long long>(v));
}

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

template <class W>
__device__ __forceinline__ bool kp_better(W w, int32_t h, int32_t l, W bw,
                                          int32_t bh, int32_t bl) {
  if (w != bw) return w > bw;
  if (h != bh) return h > bh;
  return l > bl;
}

template <class W>
struct RowBest {
  int32_t best;
  W best_w, w_own;
};

// The row reduction, split in two so that both kernels share it: each
// lane of a warp add()s the candidates (label, weight) it sees, then
// result() merges the 32 lanes (all of them call it; every lane gets the
// row's result).  A candidate repeated, or an empty slot (label -1,
// weight 0), leaves the result as it is.
template <class W>
struct RowArgmax {
  int32_t own;
  W nw;
  const W* __restrict__ cw;
  const W* __restrict__ cap;
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
  W w_own = 0, bw = kp_wmin<W>();
  int32_t bh = -1, bl = -1;

  __device__ __forceinline__ RowArgmax(int32_t own_, W nw_, const W* cw_,
                                       const W* cap_, int C_, uint32_t salt_,
                                       int require_fit_)
      : own(own_), nw(nw_), cw(cw_), cap(cap_), C(C_), salt(salt_),
        require_fit(require_fit_) {}

  __device__ __forceinline__ void add(int32_t lab, W w) {
    if (lab == own && w > w_own) w_own = w;
    bool feas = lab >= 0 && lab != own;
    if (feas && has_range) feas = lab >= lo && lab < hi;
    if (feas && require_fit) {
      const int32_t c = lab >= C ? C - 1 : lab;
      const W sum = kp_wrap_add(__ldg(cw + c), nw);
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

  __device__ __forceinline__ RowBest<W> result() {
    for (int off = 16; off > 0; off >>= 1) {
      const W ow = __shfl_xor_sync(0xffffffffu, bw, off);
      const int32_t oh = __shfl_xor_sync(0xffffffffu, bh, off);
      const int32_t ol = __shfl_xor_sync(0xffffffffu, bl, off);
      const W oo = __shfl_xor_sync(0xffffffffu, w_own, off);
      if (kp_better(ow, oh, ol, bw, bh, bl)) {
        bw = ow;
        bh = oh;
        bl = ol;
      }
      if (oo > w_own) w_own = oo;
    }
    const bool has = bl >= 0 && bw > kp_wmin<W>();
    return RowBest<W>{has ? bl : -1, has ? bw : kp_wmin<W>(), w_own};
  }
};

// The row reduction over a table of S slots by one warp: slots(j,
// &label, &weight) reads slot j.
template <class W, class Slots>
__device__ __forceinline__ RowBest<W> kp_row_best(const Slots& slots, int S,
                                                  RowArgmax<W> acc) {
  for (int j = threadIdx.x & 31; j < S; j += 32) {
    int32_t lab;
    W w;
    slots(j, lab, w);
    acc.add(lab, w);
  }
  return acc.result();
}

// ---------------------------------------------------------- standalone K3

namespace {

constexpr int kScanThreads = 256;  // 8 warps a block
constexpr int kVecs = 2;           // vectors a lane reads per item

template <class W>
struct ScanArgs {
  const int32_t* __restrict__ slot_label;
  const W* __restrict__ slot_w;
  const int32_t* __restrict__ labels;
  const W* __restrict__ cw;
  const W* __restrict__ node_w;
  const W* __restrict__ cap;
  const int32_t* __restrict__ comm;  // null: no community restriction
  int32_t* out_best;
  W* out_w;
  W* out_own;
  long long n_rows;
  long long n_steps;  // warp steps: ceil(n_rows / rows_per_warp)
  int S, C;
  int G, log_g;  // lanes per row (a power of two <= 32) and its log2
  int nv;        // vectors per row, S / V
  int chunks;    // items per row: ceil(nv / (G * kVecs)), at least 1
  uint32_t salt;
  int require_fit, has_range;
  int32_t lo, hi;
};

// one 16-, 8- or 4-byte load of V consecutive entries, streamed (read
// once: __ldcs keeps them from evicting the lookups' lines from L1)
template <int V>
__device__ __forceinline__ void load_vec(const int32_t* p, int32_t* x) {
  if constexpr (V == 4) {
    const int4 v = __ldcs(reinterpret_cast<const int4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else if constexpr (V == 2) {
    const int2 v = __ldcs(reinterpret_cast<const int2*>(p));
    x[0] = v.x;
    x[1] = v.y;
  } else {
    x[0] = __ldcs(p);
  }
}
template <int V>
__device__ __forceinline__ void load_vec(const long long* p, long long* x) {
  if constexpr (V == 4) {
    const longlong2 a = __ldcs(reinterpret_cast<const longlong2*>(p));
    const longlong2 b = __ldcs(reinterpret_cast<const longlong2*>(p) + 1);
    x[0] = a.x;
    x[1] = a.y;
    x[2] = b.x;
    x[3] = b.y;
  } else if constexpr (V == 2) {
    const longlong2 a = __ldcs(reinterpret_cast<const longlong2*>(p));
    x[0] = a.x;
    x[1] = a.y;
  } else {
    x[0] = __ldcs(p);
  }
}

// What a lane holds of one item: kVecs vectors of V slots of one row, and
// the row's own label, node weight and community.
template <class W, int V>
struct Item {
  int32_t lab[kVecs * V];
  W w[kVecs * V];
  int32_t own, own_comm;
  W nw;
};

// A warp's position in its items: step (32 / G rows) and chunk (G *
// kVecs vectors of each of those rows).
struct Cursor {
  long long step;
  int chunk;
  __device__ __forceinline__ void next(int chunks, long long stride) {
    if (++chunk == chunks) {
      chunk = 0;
      step += stride;
    }
  }
};

// Load the item at `at` for this lane's group: row step * (32 / G) +
// group; vector (chunk * kVecs + k) * G + lane-in-group for k < kVecs.  A
// row past n_rows or a vector past the row reads nothing and holds empty
// slots (label -1, weight 0).
template <class W, int V>
__device__ __forceinline__ void load_item(const ScanArgs<W>& a, Cursor at,
                                          Item<W, V>& it) {
  const int lane = threadIdx.x & 31;
  const long long row = (at.step << (5 - a.log_g)) + (lane >> a.log_g);
  const bool in_row = row < a.n_rows;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int v = (at.chunk * kVecs + k) * a.G + (lane & (a.G - 1));
    if (in_row && v < a.nv) {
      const long long off = row * a.S + (long long)v * V;
      load_vec<V>(a.slot_label + off, it.lab + k * V);
      load_vec<V>(a.slot_w + off, it.w + k * V);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        it.lab[k * V + i] = -1;
        it.w[k * V + i] = 0;
      }
    }
  }
  it.own = in_row ? __ldg(a.labels + row) : -1;
  it.nw = in_row && a.require_fit ? __ldg(a.node_w + row) : 0;
  it.own_comm = in_row && a.comm != nullptr ? __ldg(a.comm + row) : 0;
}

// A lane's running best feasible candidate of one row, and w_own.
template <class W>
struct RowScan {
  W w_own, bw;
  int32_t bh, bl;

  __device__ __forceinline__ void reset() {
    w_own = 0;
    bw = kp_wmin<W>();
    bh = -1;
    bl = -1;
  }

  // the fit and community tests of label lab for the item's row
  template <int V>
  __device__ __forceinline__ bool feasible(const ScanArgs<W>& a,
                                           int32_t lab,
                                           const Item<W, V>& it) const {
    if (a.require_fit) {
      const int32_t c = lab >= a.C ? a.C - 1 : lab;
      if (kp_wrap_add(__ldg(a.cw + c), it.nw) > __ldg(a.cap + c)) {
        return false;
      }
    }
    return a.comm == nullptr ||
           __ldg(a.comm + (lab >= a.n_rows ? a.n_rows - 1 : lab)) ==
               it.own_comm;
  }

  // The item's slots in turn.  A slot is compared with the lane's best
  // first; only one that would win is looked up for fit and community.
  // The best is feasible either way, so the result is the same.
  template <int V>
  __device__ __forceinline__ void add(const ScanArgs<W>& a,
                                      const Item<W, V>& it) {
#pragma unroll
    for (int i = 0; i < kVecs * V; ++i) {
      const int32_t lab = it.lab[i];
      const W w = it.w[i];
      if (lab == it.own && w > w_own) w_own = w;
      if (lab < 0 || lab == it.own || w < bw) continue;
      if (a.has_range && (lab < a.lo || lab >= a.hi)) continue;
      const int32_t h = kp_hash_u32(lab, a.salt);
      if (w == bw && (h < bh || (h == bh && lab <= bl))) continue;
      if (!feasible(a, lab, it)) continue;
      bw = w;
      bh = h;
      bl = lab;
    }
  }

  // merge the G lanes of each group (every lane of the warp calls it)
  __device__ __forceinline__ RowBest<W> result(int G) {
    for (int off = G >> 1; off > 0; off >>= 1) {
      const W ow = __shfl_xor_sync(0xffffffffu, bw, off, G);
      const int32_t oh = __shfl_xor_sync(0xffffffffu, bh, off, G);
      const int32_t ol = __shfl_xor_sync(0xffffffffu, bl, off, G);
      const W oo = __shfl_xor_sync(0xffffffffu, w_own, off, G);
      if (kp_better(ow, oh, ol, bw, bh, bl)) {
        bw = ow;
        bh = oh;
        bl = ol;
      }
      if (oo > w_own) w_own = oo;
    }
    const bool has = bl >= 0 && bw > kp_wmin<W>();
    return RowBest<W>{has ? bl : -1, has ? bw : kp_wmin<W>(), w_own};
  }
};

template <class W, int V>
__global__ void __launch_bounds__(kScanThreads)
best_from_slots_kernel(ScanArgs<W> a) {
  constexpr int kWarps = kScanThreads / 32;
  const int lane = threadIdx.x & 31;
  const long long first = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long stride = (long long)gridDim.x * kWarps;
  if (first >= a.n_steps) return;  // the whole warp
  const long long n_items =
      (a.n_steps - first + stride - 1) / stride * a.chunks;
  Item<W, V> next;
  Cursor in{first, 0}, out{first, 0};
  load_item(a, in, next);
  RowScan<W> scan;
  for (long long i = 0; i < n_items; ++i) {  // the same for the warp
    const Item<W, V> cur = next;
    if (i + 1 < n_items) {  // the next item's loads go out first
      in.next(a.chunks, stride);
      load_item(a, in, next);
    }
    if (out.chunk == 0) scan.reset();
    scan.add(a, cur);
    if (out.chunk == a.chunks - 1) {
      const RowBest<W> r = scan.result(a.G);
      const long long row = (out.step << (5 - a.log_g)) + (lane >> a.log_g);
      if ((lane & (a.G - 1)) == 0 && row < a.n_rows) {
        a.out_best[row] = r.best;
        a.out_w[row] = r.best_w;
        a.out_own[row] = r.w_own;
      }
    }
    out.next(a.chunks, stride);
  }
}

template <class W, int V>
int launch_scan(const ScanArgs<W>& a, cudaStream_t st) {
  // the persistent grid: the SM count times the blocks an SM holds of this
  // kernel, asked once per process (no host query on later launches)
  static const long long resident = [] {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, best_from_slots_kernel<W, V>, kScanThreads, 0) !=
            cudaSuccess) {
      return 0LL;
    }
    return (long long)sms * per_sm;
  }();
  if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long warps = kScanThreads / 32;
  long long blocks = (a.n_steps + warps - 1) / warps;
  if (blocks > resident) blocks = resident;
  best_from_slots_kernel<W, V><<<(unsigned)blocks, kScanThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <class W>
int launch_best_from_slots(const void* slot_label, const void* slot_w,
                           const void* labels, const void* cw,
                           const void* node_w, const void* cap,
                           void* out_best, void* out_w, void* out_own,
                           long long n_rows, int S, int C, unsigned int salt,
                           int require_fit, const void* communities,
                           int has_range, int lo, int hi, void* stream) {
  if (n_rows <= 0) return (int)cudaGetLastError();
  ScanArgs<W> a;
  a.slot_label = (const int32_t*)slot_label;
  a.slot_w = (const W*)slot_w;
  a.labels = (const int32_t*)labels;
  a.cw = (const W*)cw;
  a.node_w = (const W*)node_w;
  a.cap = (const W*)cap;
  a.comm = (const int32_t*)communities;
  a.out_best = (int32_t*)out_best;
  a.out_w = (W*)out_w;
  a.out_own = (W*)out_own;
  a.n_rows = n_rows;
  a.S = S;
  a.C = C;
  a.salt = salt;
  a.require_fit = require_fit;
  a.has_range = has_range;
  a.lo = lo;
  a.hi = hi;
  // V: the widest vector every row's base is aligned to
  const uintptr_t pl = (uintptr_t)slot_label, pw = (uintptr_t)slot_w;
  int V = 1;
  if (S % 4 == 0 && pl % 16 == 0 && pw % 16 == 0) {
    V = 4;
  } else if (S % 2 == 0 && pl % 8 == 0 && pw % (2 * sizeof(W)) == 0) {
    V = 2;
  }
  // G: the least power of two (at most 32) of lanes that, kVecs vectors
  // each, cover the row; a longer row takes several chunks
  a.nv = S / V;
  const int per_lane = (a.nv + kVecs - 1) / kVecs;
  a.log_g = 0;
  while (a.log_g < 5 && (1 << a.log_g) < per_lane) ++a.log_g;
  a.G = 1 << a.log_g;
  const int span = a.G * kVecs;
  a.chunks = a.nv > span ? (a.nv + span - 1) / span : 1;
  const long long rows_per_warp = 32 >> a.log_g;
  a.n_steps = (n_rows + rows_per_warp - 1) / rows_per_warp;
  cudaStream_t st = (cudaStream_t)stream;
  if (V == 4) return launch_scan<W, 4>(a, st);
  if (V == 2) return launch_scan<W, 2>(a, st);
  return launch_scan<W, 1>(a, st);
}

}  // namespace

// n_rows rows of S slots (any S >= 0; the slot tables' bases need no
// alignment).  slot_w, cw, node_w, cap, out_w and out_own are int32 here
// and int64 in kp_best_from_slots_i64; labels, slot labels, communities
// and best are int32 in both.
extern "C" int kp_best_from_slots(const void* slot_label, const void* slot_w,
                                  const void* labels, const void* cw,
                                  const void* node_w, const void* cap,
                                  void* out_best, void* out_w, void* out_own,
                                  long long n_rows, int S, int C,
                                  unsigned int salt, int require_fit,
                                  const void* communities, int has_range,
                                  int lo, int hi, void* stream) {
  return launch_best_from_slots<int32_t>(
      slot_label, slot_w, labels, cw, node_w, cap, out_best, out_w, out_own,
      n_rows, S, C, salt, require_fit, communities, has_range, lo, hi,
      stream);
}

extern "C" int kp_best_from_slots_i64(
    const void* slot_label, const void* slot_w, const void* labels,
    const void* cw, const void* node_w, const void* cap, void* out_best,
    void* out_w, void* out_own, long long n_rows, int S, int C,
    unsigned int salt, int require_fit, const void* communities,
    int has_range, int lo, int hi, void* stream) {
  return launch_best_from_slots<long long>(
      slot_label, slot_w, labels, cw, node_w, cap, out_best, out_w, out_own,
      n_rows, S, C, salt, require_fit, communities, has_range, lo, hi,
      stream);
}

// ---------------------------------------------------------------- fused K3

namespace {

constexpr int kLightThreads = 256;            // 8 warps, one row each
constexpr int kLightEdges = 8;                // edges per lane in registers
constexpr int kLightMax = 32 * kLightEdges;   // longest row a warp takes
constexpr int kHeavyThreads = 1024;           // one block per heavy row
constexpr int kUnroll = 4;                    // heavy: edges in flight
constexpr int kMaxFusedSlots = 256;           // num_slots the kernel takes

template <class W>
struct Fused {
  const int32_t* __restrict__ start;
  const int32_t* __restrict__ end;
  const int32_t* __restrict__ dst;
  const W* __restrict__ w;
  const int32_t* __restrict__ labels;
  const W* __restrict__ cw;
  const W* __restrict__ node_w;
  const W* __restrict__ cap;
  const int32_t* __restrict__ comm;  // null: no community restriction
  int32_t* out_best;
  W* out_w;
  W* out_own;
  uint8_t* out_full;
  int32_t* heavy;  // heavy[0]: count; heavy[1 + i]: the i-th heavy row
  int n, D, C, num_slots, label_bits;
  int slot_mask;  // num_slots - 1 when a power of two, else -1
  uint32_t salt1, salt2, ksalt1, ksalt2;
  int require_fit;
};

// The tables of one row: key[2 S1] (pass 1 then pass 2; -1 = empty) and
// w[2 S1].  A slot's label is its key's low label_bits, or -1 when empty.
template <class W>
struct KeySlots {
  const int32_t* key;
  const W* w;
  int32_t lab_mask;
  __device__ __forceinline__ void operator()(int j, int32_t& l,
                                             W& x) const {
    const int32_t k = key[j];
    l = k >= 0 ? (k & lab_mask) : -1;
    x = w[j];
  }
};

template <class W>
__device__ __forceinline__ void clipped_span(const Fused<W>& p, int row,
                                             int& s, int& e) {
  e = __ldg(p.end + row);
  e = e < 0 ? 0 : (e > p.D ? p.D : e);
  s = __ldg(p.start + row);
  s = s < 0 ? 0 : (s > e ? e : s);
}

// the clipped target of buffer slot j; its label is read separately, so
// that a batch issues all its dst loads before any label load
template <class W>
__device__ __forceinline__ int32_t target(const Fused<W>& p, int j) {
  const int32_t d = __ldg(p.dst + j);
  return d < 0 ? 0 : (d >= p.n ? p.n - 1 : d);
}

// the edge's label clipped to the row domain, or -1 when it does not count
template <class W>
__device__ __forceinline__ int32_t edge_label(const Fused<W>& p, int32_t d) {
  const int32_t lab = __ldg(p.labels + d);
  return lab < 0 ? -1 : (lab >= p.n ? p.n - 1 : lab);
}

// hash_u32(nb, salt) % num_slots; the hash is non-negative, so a power
// of two takes a mask (an integer division costs some twenty instructions)
template <class W>
__device__ __forceinline__ int slot_of(int32_t nb, uint32_t salt,
                                       const Fused<W>& p) {
  const int32_t h = kp_hash_u32(nb, salt);
  return p.slot_mask >= 0 ? (h & p.slot_mask) : h % p.num_slots;
}

template <class W>
__device__ __forceinline__ int32_t key_of(int32_t nb, uint32_t ksalt,
                                          const Fused<W>& p) {
  const int32_t key_mask = (int32_t)((1u << (31 - p.label_bits)) - 1u);
  return ((kp_hash_u32(nb, ksalt) & key_mask) << p.label_bits) | nb;
}

template <class W>
__device__ __forceinline__ void write_row(const Fused<W>& p, int row,
                                          const RowBest<W>& r, bool full) {
  p.out_best[row] = r.best;
  p.out_w[row] = r.best_w;
  p.out_own[row] = r.w_own;
  p.out_full[row] = full ? 1 : 0;
}

template <class W>
__device__ __forceinline__ RowArgmax<W> row_argmax(const Fused<W>& p,
                                                   int row) {
  RowArgmax<W> acc(__ldg(p.labels + row), __ldg(p.node_w + row), p.cw,
                   p.cap, p.C, p.salt1, p.require_fit);
  if (p.comm != nullptr) {
    acc.comm = p.comm;
    acc.n = p.n;
    acc.own_comm = __ldg(p.comm + row);
  }
  return acc;
}

// Shared memory: per warp, key[2 S1] then w[2 S1]; a warp's region is
// 2 S1 (4 + sizeof(W)) bytes and its keys 2 S1 * 4 = 8 S1 bytes, both
// multiples of 8, so every weight table stays aligned for 8-byte weights.
template <class W>
__global__ void __launch_bounds__(kLightThreads)
fused_light_kernel(Fused<W> p) {
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int S1 = p.num_slots, S = 2 * S1;
  int32_t* key = smem + warp * S * (int)((4 + sizeof(W)) / 4);
  W* wt = reinterpret_cast<W*>(key + S);
  const int32_t lab_mask = (int32_t)((1u << p.label_bits) - 1u);
  const int warps = kLightThreads / 32;
  for (int row = blockIdx.x * warps + warp; row < p.n;
       row += gridDim.x * warps) {
    int s, e;
    clipped_span(p, row, s, e);
    const int L = e - s;
    if (L == 0) {  // an empty span: no slot, nothing contested
      if (lane == 0) {
        write_row(p, row, RowBest<W>{-1, kp_wmin<W>(), 0}, true);
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
    int32_t nb[kLightEdges], slot[kLightEdges];
    W we[kLightEdges];
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
          kp_add(wt + slot[u], we[u]);
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
          kp_add(wt + slot[u], we[u]);
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
    RowArgmax<W> acc = row_argmax(p, row);
#pragma unroll
    for (int u = 0; u < kLightEdges; ++u) {
      if (32 * u >= L) break;
      if (nb[u] >= 0 && slot[u] >= 0) acc.add(nb[u], wt[slot[u]]);
    }
    const RowBest<W> r = acc.result();
    if (lane == 0) write_row(p, row, r, full);
    __syncwarp();  // the next row's reset waits for every lane's reads
  }
}

// One block per heavy row; shared memory: key[2 S1] then w[2 S1].
template <class W>
__global__ void __launch_bounds__(kHeavyThreads)
fused_heavy_kernel(Fused<W> p) {
  extern __shared__ int32_t smem[];
  const int S1 = p.num_slots, S = 2 * S1;
  int32_t* key = smem;
  W* wt = reinterpret_cast<W*>(smem + S);
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
            kp_add(wt + s1, __ldg(p.w + j));
            continue;
          }
          if (win1) continue;
          const int s2 = S1 + slot_of(nb[u], p.salt2, p);
          if (phase == 2) {
            atomicMax(key + s2, key_of(nb[u], p.ksalt2, p));
          } else if ((key[s2] & lab_mask) == nb[u]) {
            kp_add(wt + s2, __ldg(p.w + j));
          } else {
            lost = 1;
          }
        }
      }
      if (phase < 3) __syncthreads();
    }
    const bool full = __syncthreads_or(lost) == 0;
    if (threadIdx.x < 32) {
      const RowBest<W> r = kp_row_best<W>(KeySlots<W>{key, wt, lab_mask}, S,
                                          row_argmax(p, row));
      if (threadIdx.x == 0) write_row(p, row, r, full);
    }
    __syncthreads();  // the next row's reset waits for the reduction
  }
}

template <class W>
int launch_scatter_best_from_slots(
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
  Fused<W> p;
  p.start = (const int32_t*)start;
  p.end = (const int32_t*)end;
  p.dst = (const int32_t*)dst;
  p.w = (const W*)w;
  p.labels = (const int32_t*)labels;
  p.cw = (const W*)cw;
  p.node_w = (const W*)node_w;
  p.cap = (const W*)cap;
  p.comm = (const int32_t*)communities;
  p.out_best = (int32_t*)out_best;
  p.out_w = (W*)out_w;
  p.out_own = (W*)out_own;
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

  // per row: 2 S1 weights and 2 S1 keys
  const size_t row_smem = (size_t)2 * num_slots * (sizeof(W) + 4);
  const int warps = kLightThreads / 32;
  long long blocks = ((long long)n + warps - 1) / warps;
  if (blocks > 132LL * 32) blocks = 132LL * 32;
  const size_t light_smem = (size_t)warps * row_smem;
  if (light_smem >= 48 * 1024) {
    err = cudaFuncSetAttribute(fused_light_kernel<W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)light_smem);
    if (err != cudaSuccess) return (int)err;
  }
  fused_light_kernel<W><<<(unsigned)blocks, kLightThreads, light_smem, st>>>(
      p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // at most min(n, D / (kLightMax + 1)) heavy rows
  long long most = (long long)D / (kLightMax + 1);
  if (most > n) most = n;
  if (most > 0) {
    long long hb = most < 132LL * 2 ? most : 132LL * 2;
    fused_heavy_kernel<W><<<(unsigned)hb, kHeavyThreads, row_smem, st>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// n rows (the labels' length, below 2^31), D buffer slots (dst and w);
// heavy: int32[n + 1] scratch.  out_full is one byte per row (0 / 1).
// communities: null, or int32[n].  w, cw, node_w, cap, out_w and out_own
// are int32 here and int64 in kp_scatter_best_from_slots_i64.
// Returns cudaErrorInvalidValue for a num_slots outside [1, 256] or a
// label_bits outside [1, 27].
extern "C" int kp_scatter_best_from_slots(
    const void* start, const void* end, const void* dst, const void* w,
    const void* labels, const void* cw, const void* node_w, const void* cap,
    const void* communities, void* out_best, void* out_w, void* out_own,
    void* out_full, void* heavy, int n, int D, int C, int num_slots,
    int label_bits, unsigned int salt, int require_fit, void* stream) {
  return launch_scatter_best_from_slots<int32_t>(
      start, end, dst, w, labels, cw, node_w, cap, communities, out_best,
      out_w, out_own, out_full, heavy, n, D, C, num_slots, label_bits, salt,
      require_fit, stream);
}

extern "C" int kp_scatter_best_from_slots_i64(
    const void* start, const void* end, const void* dst, const void* w,
    const void* labels, const void* cw, const void* node_w, const void* cap,
    const void* communities, void* out_best, void* out_w, void* out_own,
    void* out_full, void* heavy, int n, int D, int C, int num_slots,
    int label_bits, unsigned int salt, int require_fit, void* stream) {
  return launch_scatter_best_from_slots<long long>(
      start, end, dst, w, labels, cw, node_w, cap, communities, out_best,
      out_w, out_own, out_full, heavy, n, D, C, num_slots, label_bits, salt,
      require_fit, stream);
}
