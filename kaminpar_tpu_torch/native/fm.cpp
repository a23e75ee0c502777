// Localized batch k-way FM refinement (native host runtime).
//
// The native analog of the reference's parallel localized FM
// (kaminpar-shm/refinement/fm/fm_refiner.cc:48-110 FMRefiner/
// LocalizedFMRefiner, gains/delta_gain_caches.h:202): seed nodes are
// polled from a shared border queue, each batch grows a localized region
// speculatively against a DELTA overlay of the partition and gain table,
// and only the best prefix of the batch's moves is committed to the
// global state; non-moved region nodes are released for later batches.
//
// Threading mirrors the reference's scheme: a pool of workers pulls seed
// batches from the shared border queue; per-node ownership claims (the
// NodeTracker analog, fm_refiner.cc NodeTracker) keep regions disjoint,
// global partition/gain-table/block-weight accesses go through relaxed
// std::atomic_ref (the reference's atomic gain cache), and commits
// re-check the block-weight caps with fetch_add + rollback so the cap
// is NEVER exceeded — stricter than the reference's transient
// overshoot.  num_threads <= 1 runs the identical code on one thread
// and visits exactly the old sequential state sequence (rerun
// determinism for tests and 1-CPU hosts).  Stale gains from concurrent
// commits are tolerated exactly like the reference tolerates them: the
// delta overlay re-checks gains before applying, and the global table
// stays exact because every update is an exact integer fetch_add.
//
// Dense (n, k) gain table (gains/sparse_gain_cache.h lineage), sparse
// delta map, adaptive (Osipov-Sanders) or simple stopping.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <queue>
#include <thread>
#include <tuple>
#include <unordered_map>
#include <vector>

namespace {

struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed ^ 0x9E3779B97F4A7C15ULL) {
    if (s == 0) s = 0x2545F4914F6CDD1DULL;
  }
  uint64_t next() {
    uint64_t z = (s += 0x9E3779B97F4A7C15ULL);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  }
  uint32_t tie() { return (uint32_t)(next() >> 32); }
};

constexpr auto kRelaxed = std::memory_order_relaxed;

struct Ctx {
  int64_t n, k;
  const int64_t* xadj;
  const int32_t* adjncy;
  const int64_t* node_w;
  const int64_t* edge_w;
  const int64_t* max_bw;
  int32_t* part;
  std::vector<int64_t> conn;  // dense (n, k) connection table
  std::vector<int64_t> bw;    // global block weights

  // relaxed-atomic views of the shared state (plain loads/stores when
  // single-threaded; the values are identical either way)
  int64_t conn_at(int64_t u, int64_t b) const {
    return std::atomic_ref(const_cast<int64_t&>(conn[u * k + b]))
        .load(kRelaxed);
  }
  int32_t part_at(int64_t u) const {
    return std::atomic_ref(const_cast<int32_t&>(part[u])).load(kRelaxed);
  }
  int64_t bw_at(int64_t b) const {
    return std::atomic_ref(const_cast<int64_t&>(bw[b])).load(kRelaxed);
  }
};

// per-node ownership within a pass (NodeTracker analog):
// kFree = claimable, kMoved = committed this pass, else owning batch id
constexpr int32_t kFree = -1;
constexpr int32_t kMoved = -2;

void build_conn(Ctx& c) {
  std::fill(c.conn.begin(), c.conn.end(), 0);
  std::fill(c.bw.begin(), c.bw.end(), 0);
  for (int64_t u = 0; u < c.n; ++u) {
    c.bw[c.part[u]] += c.node_w[u];
    for (int64_t e = c.xadj[u]; e < c.xadj[u + 1]; ++e)
      c.conn[u * c.k + c.part[c.adjncy[e]]] += c.edge_w[e];
  }
}

// Delta overlay (delta_gain_caches.h analog): tentative partition and
// gain-table deltas for the current batch.  Touched nodes get a dense
// ARENA row copy of their (k-wide) connection row plus a tentative
// block field — one hash lookup per row access instead of k map probes
// per gain query (the hot path of the whole refiner).
struct Delta {
  const Ctx* c;
  std::unordered_map<int64_t, int32_t> slot;  // u -> arena index
  std::vector<int64_t> rows;                  // arena, k per slot
  std::vector<int32_t> blocks;                // arena slot -> tent. block
  std::vector<int64_t> bw_delta;

  explicit Delta(const Ctx& ctx) : c(&ctx), bw_delta(ctx.k, 0) {
    slot.reserve(1 << 14);
  }
  void clear() {
    slot.clear();
    rows.clear();
    blocks.clear();
    std::fill(bw_delta.begin(), bw_delta.end(), 0);
  }
  // arena row of u, materialized from the global table on first touch
  int64_t* row(int64_t u) {
    auto [it, fresh] = slot.try_emplace(u, (int32_t)blocks.size());
    if (fresh) {
      const size_t base = rows.size();
      rows.resize(base + c->k);
      for (int64_t b = 0; b < c->k; ++b)
        rows[base + b] = c->conn_at(u, b);
      blocks.push_back(c->part_at(u));
    }
    return rows.data() + (int64_t)it->second * c->k;
  }
  int32_t block(int64_t u) const {
    auto it = slot.find(u);
    return it == slot.end() ? c->part_at(u) : blocks[it->second];
  }
  // row view: the arena row when touched, else a temp copy of the
  // global row (atomic loads — the global row may be concurrently
  // updated by other batches' commits)
  const int64_t* row_view(int64_t u, int64_t* scratch) const {
    auto it = slot.find(u);
    if (it != slot.end())
      return rows.data() + (int64_t)it->second * c->k;
    for (int64_t b = 0; b < c->k; ++b) scratch[b] = c->conn_at(u, b);
    return scratch;
  }
  int64_t weight(int64_t b) const { return c->bw_at(b) + bw_delta[b]; }
  // tentatively move u from -> to, updating neighbor rows
  void move(int64_t u, int32_t from, int32_t to) {
    row(u);  // materialize so the block override has a slot
    blocks[slot.find(u)->second] = to;
    bw_delta[from] -= c->node_w[u];
    bw_delta[to] += c->node_w[u];
    for (int64_t e = c->xadj[u]; e < c->xadj[u + 1]; ++e) {
      const int32_t v = c->adjncy[e];
      int64_t* r = row(v);
      r[from] -= c->edge_w[e];
      r[to] += c->edge_w[e];
    }
  }
};

// best feasible move of u under the delta view: (gain, target) or
// (INT64_MIN, -1)
std::pair<int64_t, int32_t> best_move(const Delta& d, int64_t u, Rng& rng,
                                      int64_t* scratch) {
  const Ctx& c = *d.c;
  const int32_t b = d.block(u);
  const int64_t* r = d.row_view(u, scratch);
  const int64_t own = r[b];
  int64_t best_gain = INT64_MIN;
  int32_t best_t = -1;
  uint32_t best_tie = 0;
  for (int32_t t = 0; t < c.k; ++t) {
    if (t == b) continue;
    if (d.weight(t) + c.node_w[u] > c.max_bw[t]) continue;
    const int64_t g = r[t] - own;
    if (g > best_gain) {
      best_gain = g;
      best_t = t;
      best_tie = rng.tie();
    } else if (g == best_gain && best_t >= 0) {
      const uint32_t tb = rng.tie();
      if (tb > best_tie) {
        best_t = t;
        best_tie = tb;
      }
    }
  }
  return {best_gain, best_t};
}

// commit a move to the GLOBAL state with a cap re-check: concurrent
// batches may have filled the target block since the delta check, so
// reserve the weight first and roll back on overshoot.  Returns false
// (and leaves the state untouched) when the target no longer fits —
// the block-weight cap is never exceeded, even transiently beyond this
// one reservation.
bool commit_move(Ctx& c, int64_t u, int32_t from, int32_t to) {
  const int64_t w = c.node_w[u];
  std::atomic_ref bw_to(c.bw[to]);
  if (bw_to.fetch_add(w, kRelaxed) + w > c.max_bw[to]) {
    bw_to.fetch_sub(w, kRelaxed);
    return false;
  }
  std::atomic_ref(c.bw[from]).fetch_sub(w, kRelaxed);
  std::atomic_ref(c.part[u]).store(to, kRelaxed);
  for (int64_t e = c.xadj[u]; e < c.xadj[u + 1]; ++e) {
    const int32_t v = c.adjncy[e];
    std::atomic_ref(c.conn[(int64_t)v * c.k + from])
        .fetch_sub(c.edge_w[e], kRelaxed);
    std::atomic_ref(c.conn[(int64_t)v * c.k + to])
        .fetch_add(c.edge_w[e], kRelaxed);
  }
  return true;
}

struct Move {
  int64_t u;
  int32_t from, to;
  int64_t gain;
};

// one localized batch (LocalizedFMRefiner::run_batch); returns committed
// gain.  `owner` claims keep concurrent regions disjoint.
int64_t run_batch(Ctx& c, Delta& d, std::atomic<int32_t>* owner,
                  int32_t my_id, const std::vector<int64_t>& seeds,
                  double alpha, int64_t num_fruitless, int use_adaptive,
                  Rng& rng, std::vector<int64_t>& scratch) {
  d.clear();
  using Entry = std::tuple<int64_t, uint32_t, int64_t, int32_t>;
  std::priority_queue<Entry> pq;
  std::vector<int64_t> touched;

  auto claim = [&](int64_t u) {
    int32_t expect = kFree;
    return owner[u].compare_exchange_strong(expect, my_id, kRelaxed);
  };
  auto push = [&](int64_t u) {
    auto [g, t] = best_move(d, u, rng, scratch.data());
    if (t >= 0) pq.push({g, rng.tie(), u, t});
  };
  for (int64_t s : seeds) {
    // seeds arrive pre-claimed by the seed poller
    touched.push_back(s);
    push(s);
  }
  if (pq.empty()) {
    for (int64_t u : touched) owner[u].store(kFree, kRelaxed);
    return 0;
  }

  std::vector<Move> moves;
  int64_t cur = 0, best = 0;
  size_t best_len = 0;
  int64_t fruitless = 0;
  int64_t steps = 0;
  double mean = 0.0, m2 = 0.0;
  const size_t max_moves = 4096;  // region safety cap

  while (!pq.empty() && moves.size() < max_moves) {
    auto [g, tie, u, t] = pq.top();
    pq.pop();
    if (owner[u].load(kRelaxed) != my_id) continue;  // lost to a commit
    // stale check: gains shift as the region moves.  Re-queue only on a
    // GAIN change — the target may legitimately differ on ties (random
    // tie-break per query), and re-queuing on target alone could cycle
    auto [g2, t2] = best_move(d, u, rng, scratch.data());
    if (t2 < 0) continue;
    if (g2 != g) {
      pq.push({g2, rng.tie(), u, t2});
      continue;
    }
    t = t2;
    const int32_t b = d.block(u);
    d.move(u, b, t);
    moves.push_back({u, b, t, g2});
    cur += g2;
    if (cur > best) {
      best = cur;
      best_len = moves.size();
    }
    // expand: adjacent unclaimed nodes join the region
    for (int64_t e = c.xadj[u]; e < c.xadj[u + 1]; ++e) {
      const int32_t v = c.adjncy[e];
      const int32_t o = owner[v].load(kRelaxed);
      if (o == kFree) {
        if (claim(v)) {
          touched.push_back(v);
          push(v);
        }
      } else if (o == my_id) {
        push(v);
      }
    }
    // stopping policies (stopping_policies.h:16)
    if (use_adaptive) {
      ++steps;
      const double dlt = (double)g - mean;
      mean += dlt / (double)steps;
      m2 += dlt * ((double)g - mean);
      if (steps >= 2) {
        const double variance = m2 / (double)(steps - 1);
        if (mean < 0 &&
            (double)steps * mean * mean > alpha * variance + 10.0)
          break;
      }
    } else {
      fruitless = (g > 0) ? 0 : fruitless + 1;
      if (fruitless >= num_fruitless) break;
    }
  }

  // commit the best prefix globally; release the rest.  A cap re-check
  // failure aborts the remainder of the prefix (the delta gains beyond
  // a skipped move are no longer meaningful).
  int64_t committed_gain = 0;
  size_t i = 0;
  for (; i < best_len; ++i) {
    if (!commit_move(c, moves[i].u, moves[i].from, moves[i].to)) break;
    owner[moves[i].u].store(kMoved, kRelaxed);
    committed_gain += moves[i].gain;
  }
  for (int64_t u : touched)
    if (owner[u].load(kRelaxed) == my_id) owner[u].store(kFree, kRelaxed);
  return committed_gain;
}

// ---------------------------------------------------------------------------
// Sparse compact-hashing connection table + FM path (large k).
//
// The dense (n, k) table above is O(n*k) memory — impossible at the
// reference's large-k operating point (README.MD:17 rides
// gains/compact_hashing_gain_cache.h:34 there).  This path stores, per
// node, a power-of-two open-addressing table of (block, weight) entries
// sized 2*ceil2(min(deg, k)) — distinct adjacent blocks never exceed
// deg, the 2x headroom absorbs tombstones, and a row is rebuilt exactly
// from the adjacency when probing saturates.  Entries pack
// (block + 1) << 48 | weight, so a weight update is one fetch_add and
// an insert is one CAS.  Total memory O(sum 2*ceil2(deg)) = O(m).
// ---------------------------------------------------------------------------

namespace sparse_fm {

constexpr int64_t kTagShift = 48;
constexpr int64_t kWeightMask = ((int64_t)1 << kTagShift) - 1;

inline int64_t pack(int32_t block, int64_t w) {
  return ((int64_t)(block + 1) << kTagShift) | w;
}
// unsigned shift: block+1 can reach bit 63's neighborhood at large k
// and an arithmetic shift would sign-extend into a wrong (negative) tag
inline int32_t tag_of(int64_t e) {
  return (int32_t)((uint64_t)e >> kTagShift) - 1;
}
inline int64_t weight_of(int64_t e) { return e & kWeightMask; }

inline uint64_t hash_block(int32_t b) {
  uint64_t z = (uint64_t)b * 0x9E3779B97F4A7C15ULL;
  return z ^ (z >> 29);
}

struct SparseCtx {
  int64_t n, k;
  const int64_t* xadj;
  const int32_t* adjncy;
  const int64_t* node_w;
  const int64_t* edge_w;
  const int64_t* max_bw;
  int32_t* part;
  std::vector<int64_t> off;      // slot ranges (off[u]..off[u+1]), pow2 caps
  std::vector<int64_t> entries;  // packed atomic slots
  std::vector<int64_t> wdeg;     // weighted degree (border test)
  std::vector<int64_t> bw;

  int64_t cap(int64_t u) const { return off[u + 1] - off[u]; }
  int32_t part_at(int64_t u) const {
    return std::atomic_ref(const_cast<int32_t&>(part[u])).load(kRelaxed);
  }
  int64_t bw_at(int64_t b) const {
    return std::atomic_ref(const_cast<int64_t&>(bw[b])).load(kRelaxed);
  }

  int64_t load(int64_t u, int32_t b) const {
    const int64_t base = off[u], c = cap(u);
    if (c == 0) return 0;
    const int64_t mask = c - 1;
    for (int64_t i = 0; i < c; ++i) {
      const int64_t s = base + ((hash_block(b) + (uint64_t)i) & mask);
      const int64_t e =
          std::atomic_ref(const_cast<int64_t&>(entries[s])).load(kRelaxed);
      if (e == 0) return 0;
      if (tag_of(e) == b) return weight_of(e);
    }
    return 0;  // saturated row without the tag: weight is 0
  }

  // add w (may be negative) to (u, b); returns false when the row needs
  // a rebuild (all slots probed, tag absent — only possible for w > 0)
  bool add(int64_t u, int32_t b, int64_t w) {
    const int64_t base = off[u], c = cap(u);
    if (c == 0) return true;
    const int64_t mask = c - 1;
    for (int64_t i = 0; i < c; ++i) {
      const int64_t s = base + ((hash_block(b) + (uint64_t)i) & mask);
      std::atomic_ref<int64_t> ref(entries[s]);
      int64_t e = ref.load(kRelaxed);
      while (e == 0) {
        // claim the empty slot (tag + weight in one CAS); a zero-weight
        // claim is fine — it acts as a pre-claimed tombstone
        if (ref.compare_exchange_weak(e, pack(b, w), kRelaxed)) return true;
      }
      if (tag_of(e) == b) {
        ref.fetch_add(w, kRelaxed);  // weight field only; tag untouched
        return true;
      }
    }
    return false;
  }

  // exact rebuild of u's row from the adjacency + current partition
  // (clears tombstones; single-threaded callers only)
  void rebuild_row(int64_t u) {
    std::fill(entries.begin() + off[u], entries.begin() + off[u + 1], 0);
    for (int64_t e = xadj[u]; e < xadj[u + 1]; ++e)
      (void)add(u, part_at(adjncy[e]), edge_w[e]);
  }

  template <class Fn>
  void for_entries(int64_t u, Fn&& fn) const {
    for (int64_t s = off[u]; s < off[u + 1]; ++s) {
      const int64_t e =
          std::atomic_ref(const_cast<int64_t&>(entries[s])).load(kRelaxed);
      if (e != 0 && weight_of(e) > 0) fn(tag_of(e), weight_of(e));
    }
  }
};

inline int64_t ceil2_i64(int64_t x) {
  int64_t p = 1;
  while (p < x) p <<= 1;
  return p;
}

void build_sparse(SparseCtx& c) {
  c.off.assign(c.n + 1, 0);
  for (int64_t u = 0; u < c.n; ++u) {
    const int64_t deg = c.xadj[u + 1] - c.xadj[u];
    const int64_t distinct = std::min<int64_t>(deg, c.k);
    c.off[u + 1] =
        c.off[u] + (distinct == 0 ? 0 : 2 * ceil2_i64(distinct));
  }
  c.entries.assign(c.off[c.n], 0);
  c.wdeg.assign(c.n, 0);
  c.bw.assign(c.k, 0);
  for (int64_t u = 0; u < c.n; ++u) {
    c.bw[c.part[u]] += c.node_w[u];
    for (int64_t e = c.xadj[u]; e < c.xadj[u + 1]; ++e) {
      c.wdeg[u] += c.edge_w[e];
      (void)c.add(u, c.part[c.adjncy[e]], c.edge_w[e]);
    }
  }
}

// Delta overlay: private copies of touched rows (cap-sized, same
// probing), tentative blocks, block-weight deltas.
struct SparseDelta {
  SparseCtx* c;
  std::unordered_map<int64_t, int64_t> slot;  // u -> arena offset
  std::vector<int64_t> arena;                 // cap(u) packed entries per row
  std::unordered_map<int64_t, int32_t> blocks;
  std::vector<int64_t> bw_delta;

  explicit SparseDelta(SparseCtx& ctx) : c(&ctx), bw_delta(ctx.k, 0) {
    slot.reserve(1 << 12);
  }
  void clear() {
    slot.clear();
    arena.clear();
    blocks.clear();
    std::fill(bw_delta.begin(), bw_delta.end(), 0);
  }
  int64_t* row(int64_t u) {
    auto [it, fresh] = slot.try_emplace(u, (int64_t)arena.size());
    if (fresh) {
      const size_t base = arena.size();
      arena.resize(base + c->cap(u));
      for (int64_t s = 0; s < c->cap(u); ++s)
        arena[base + s] = std::atomic_ref(c->entries[c->off[u] + s])
                              .load(kRelaxed);
    }
    return arena.data() + it->second;
  }
  int32_t block(int64_t u) const {
    auto it = blocks.find(u);
    return it == blocks.end() ? c->part_at(u) : it->second;
  }
  int64_t weight(int64_t b) const { return c->bw_at(b) + bw_delta[b]; }

  // private-row add with exact rebuild on saturation
  void row_add(int64_t u, int32_t b, int64_t w) {
    int64_t* r = row(u);
    const int64_t cp = c->cap(u);
    if (cp == 0) return;
    const int64_t mask = cp - 1;
    for (int64_t i = 0; i < cp; ++i) {
      int64_t& e = r[(hash_block(b) + (uint64_t)i) & mask];
      if (e == 0) {
        e = pack(b, w);
        return;
      }
      if (tag_of(e) == b) {
        e += w;
        return;
      }
    }
    // saturated: rebuild the private row exactly from the adjacency
    // under the delta's tentative blocks (rare; O(deg * probe))
    std::fill(r, r + cp, 0);
    for (int64_t e2 = c->xadj[u]; e2 < c->xadj[u + 1]; ++e2) {
      const int32_t bb = block(c->adjncy[e2]);
      const int64_t mask2 = cp - 1;
      for (int64_t i = 0; i < cp; ++i) {
        int64_t& e = r[(hash_block(bb) + (uint64_t)i) & mask2];
        if (e == 0) {
          e = pack(bb, c->edge_w[e2]);
          break;
        }
        if (tag_of(e) == bb) {
          e += c->edge_w[e2];
          break;
        }
      }
    }
  }

  int64_t row_load(int64_t u, int32_t b) const {
    auto it = slot.find(u);
    if (it == slot.end()) return c->load(u, b);
    const int64_t* r = arena.data() + it->second;
    const int64_t cp = c->cap(u);
    if (cp == 0) return 0;
    const int64_t mask = cp - 1;
    for (int64_t i = 0; i < cp; ++i) {
      const int64_t e = r[(hash_block(b) + (uint64_t)i) & mask];
      if (e == 0) return 0;
      if (tag_of(e) == b) return weight_of(e);
    }
    return 0;
  }

  void move(int64_t u, int32_t from, int32_t to) {
    row(u);
    blocks[u] = to;
    bw_delta[from] -= c->node_w[u];
    bw_delta[to] += c->node_w[u];
    for (int64_t e = c->xadj[u]; e < c->xadj[u + 1]; ++e) {
      const int32_t v = c->adjncy[e];
      row_add(v, from, -c->edge_w[e]);
      row_add(v, to, c->edge_w[e]);
    }
  }

  // best feasible move among u's ADJACENT blocks (the compact-hashing
  // cache iterates its entries — non-adjacent targets are the
  // balancers' job, as in the reference's large-k configuration)
  std::pair<int64_t, int32_t> best_move(int64_t u, Rng& rng) const {
    const int32_t b = block(u);
    const int64_t own = row_load(u, b);
    int64_t best_gain = INT64_MIN;
    int32_t best_t = -1;
    uint32_t best_tie = 0;
    auto consider = [&](int32_t t, int64_t w) {
      if (t == b) return;
      if (weight(t) + c->node_w[u] > c->max_bw[t]) return;
      const int64_t g = w - own;
      if (g > best_gain) {
        best_gain = g;
        best_t = t;
        best_tie = rng.tie();
      } else if (g == best_gain && best_t >= 0) {
        const uint32_t tb = rng.tie();
        if (tb > best_tie) {
          best_t = t;
          best_tie = tb;
        }
      }
    };
    auto it = slot.find(u);
    if (it == slot.end()) {
      c->for_entries(u, consider);
    } else {
      const int64_t* r = arena.data() + it->second;
      for (int64_t s = 0; s < c->cap(u); ++s)
        if (r[s] != 0 && weight_of(r[s]) > 0)
          consider(tag_of(r[s]), weight_of(r[s]));
    }
    return {best_gain, best_t};
  }
};

// commit with cap re-check (mirrors dense commit_move); a saturated
// neighbor row is rebuilt exactly (single-threaded path — the sparse
// configuration runs T=1, see kmp_fm_refine)
bool commit_move(SparseCtx& c, int64_t u, int32_t from, int32_t to) {
  const int64_t w = c.node_w[u];
  std::atomic_ref bw_to(c.bw[to]);
  if (bw_to.fetch_add(w, kRelaxed) + w > c.max_bw[to]) {
    bw_to.fetch_sub(w, kRelaxed);
    return false;
  }
  std::atomic_ref(c.bw[from]).fetch_sub(w, kRelaxed);
  std::atomic_ref(c.part[u]).store(to, kRelaxed);
  for (int64_t e = c.xadj[u]; e < c.xadj[u + 1]; ++e) {
    const int32_t v = c.adjncy[e];
    (void)c.add(v, from, -c.edge_w[e]);
    if (!c.add(v, to, c.edge_w[e])) c.rebuild_row(v);
  }
  return true;
}

int64_t run_batch(SparseCtx& c, SparseDelta& d,
                  std::atomic<int32_t>* owner, int32_t my_id,
                  const std::vector<int64_t>& seeds, double alpha,
                  int64_t num_fruitless, int use_adaptive, Rng& rng) {
  d.clear();
  using Entry = std::tuple<int64_t, uint32_t, int64_t, int32_t>;
  std::priority_queue<Entry> pq;
  std::vector<int64_t> touched;

  auto claim = [&](int64_t u) {
    int32_t expect = kFree;
    return owner[u].compare_exchange_strong(expect, my_id, kRelaxed);
  };
  auto push = [&](int64_t u) {
    auto [g, t] = d.best_move(u, rng);
    if (t >= 0) pq.push({g, rng.tie(), u, t});
  };
  for (int64_t s : seeds) {
    touched.push_back(s);
    push(s);
  }
  if (pq.empty()) {
    for (int64_t u : touched) owner[u].store(kFree, kRelaxed);
    return 0;
  }

  std::vector<Move> moves;
  int64_t cur = 0, best = 0;
  size_t best_len = 0;
  int64_t fruitless = 0;
  int64_t steps = 0;
  double mean = 0.0, m2 = 0.0;
  const size_t max_moves = 4096;

  while (!pq.empty() && moves.size() < max_moves) {
    auto [g, tie, u, t] = pq.top();
    pq.pop();
    if (owner[u].load(kRelaxed) != my_id) continue;
    auto [g2, t2] = d.best_move(u, rng);
    if (t2 < 0) continue;
    if (g2 != g) {
      pq.push({g2, rng.tie(), u, t2});
      continue;
    }
    t = t2;
    const int32_t b = d.block(u);
    d.move(u, b, t);
    moves.push_back({u, b, t, g2});
    cur += g2;
    if (cur > best) {
      best = cur;
      best_len = moves.size();
    }
    for (int64_t e = c.xadj[u]; e < c.xadj[u + 1]; ++e) {
      const int32_t v = c.adjncy[e];
      const int32_t o = owner[v].load(kRelaxed);
      if (o == kFree) {
        if (claim(v)) {
          touched.push_back(v);
          push(v);
        }
      } else if (o == my_id) {
        push(v);
      }
    }
    if (use_adaptive) {
      ++steps;
      const double dlt = (double)g - mean;
      mean += dlt / (double)steps;
      m2 += dlt * ((double)g - mean);
      if (steps >= 2) {
        const double variance = m2 / (double)(steps - 1);
        if (mean < 0 &&
            (double)steps * mean * mean > alpha * variance + 10.0)
          break;
      }
    } else {
      fruitless = (g > 0) ? 0 : fruitless + 1;
      if (fruitless >= num_fruitless) break;
    }
  }

  int64_t committed_gain = 0;
  for (size_t i = 0; i < best_len; ++i) {
    if (!commit_move(c, moves[i].u, moves[i].from, moves[i].to)) break;
    owner[moves[i].u].store(kMoved, kRelaxed);
    committed_gain += moves[i].gain;
  }
  for (int64_t u : touched)
    if (owner[u].load(kRelaxed) == my_id) owner[u].store(kFree, kRelaxed);
  return committed_gain;
}

int64_t refine(int64_t n, const int64_t* xadj, const int32_t* adjncy,
               const int64_t* node_w, const int64_t* edge_w, int64_t k,
               const int64_t* max_bw, int32_t* part,
               int64_t num_iterations, int64_t num_seed_nodes,
               double alpha, int64_t num_fruitless_moves,
               int32_t use_adaptive, uint64_t seed) {
  // the packed tag field holds block+1 in 16 bits (max tag = k).
  // INT64_MIN is the REFUSAL sentinel — the caller must distinguish "FM
  // did not run" from "FM found no improvement" (ADVICE round 5 low #3),
  // and a small negative value would be ambiguous: with threads > 1 a
  // cap-race-aborted commit prefix can legitimately sum negative.
  if (k > 0xFFFF) return INT64_MIN;
  SparseCtx c{n, k, xadj, adjncy, node_w, edge_w, max_bw, part,
              {}, {}, {}, {}};
  Rng rng(seed);
  build_sparse(c);

  std::unique_ptr<std::atomic<int32_t>[]> owner(
      new std::atomic<int32_t>[n]);
  SparseDelta d(c);

  int64_t total = 0;
  int64_t first_pass_gain = 0;
  std::vector<int64_t> border;
  for (int64_t pass = 0; pass < std::max<int64_t>(1, num_iterations);
       ++pass) {
    border.clear();
    for (int64_t u = 0; u < n; ++u)
      if (c.load(u, c.part[u]) < c.wdeg[u]) border.push_back(u);
    if (border.empty()) break;
    for (int64_t i = (int64_t)border.size() - 1; i > 0; --i)
      std::swap(border[i],
                border[(int64_t)(rng.next() % (uint64_t)(i + 1))]);

    for (int64_t u = 0; u < n; ++u) owner[u].store(kFree, kRelaxed);
    const int64_t nseeds = std::max<int64_t>(1, num_seed_nodes);
    size_t head = 0;
    int64_t pass_gain = 0;
    int32_t next_batch_id = 0;

    for (;;) {
      const int32_t my_id = ++next_batch_id;
      std::vector<int64_t> seeds;
      while ((int64_t)seeds.size() < nseeds && head < border.size()) {
        const int64_t u = border[head++];
        int32_t expect = kFree;
        if (owner[u].compare_exchange_strong(expect, my_id, kRelaxed))
          seeds.push_back(u);
      }
      if (seeds.empty()) break;
      pass_gain += run_batch(c, d, owner.get(), my_id, seeds, alpha,
                             num_fruitless_moves, use_adaptive, rng);
    }

    total += pass_gain;
    if (pass_gain <= 0) break;
    if (pass == 0)
      first_pass_gain = pass_gain;
    else if (pass_gain * 20 < first_pass_gain)
      break;
  }
  return total;
}

}  // namespace sparse_fm

}  // namespace

// test hook: force the sparse compact-hashing path at any k (the
// normal entry dispatches on table size; tests exercise both on the
// same small graph and assert both improve the cut)
extern "C" int64_t kmp_fm_refine_sparse(
    int64_t n, const int64_t* xadj, const int32_t* adjncy,
    const int64_t* node_w, const int64_t* edge_w, int64_t k,
    const int64_t* max_bw, int32_t* part, int64_t num_iterations,
    int64_t num_seed_nodes, double alpha, int64_t num_fruitless_moves,
    int32_t use_adaptive, uint64_t seed, int64_t /*num_threads*/) {
  if (n <= 0 || k <= 1) return 0;
  return sparse_fm::refine(n, xadj, adjncy, node_w, edge_w, k, max_bw,
                           part, num_iterations, num_seed_nodes, alpha,
                           num_fruitless_moves, use_adaptive, seed);
}

extern "C" int64_t kmp_fm_refine(
    int64_t n, const int64_t* xadj, const int32_t* adjncy,
    const int64_t* node_w, const int64_t* edge_w, int64_t k,
    const int64_t* max_bw, int32_t* part, int64_t num_iterations,
    int64_t num_seed_nodes, double alpha, int64_t num_fruitless_moves,
    int32_t use_adaptive, uint64_t seed, int64_t num_threads) {
  if (n <= 0 || k <= 1) return 0;
  if (n * k > (int64_t)3e8) {
    // large k: the dense (n, k) table is unaffordable — run the sparse
    // compact-hashing path (compact_hashing_gain_cache.h:34 analog),
    // O(m) memory.  Single-threaded: its exact rebuild-on-saturation
    // is not written for concurrent writers.
    return sparse_fm::refine(n, xadj, adjncy, node_w, edge_w, k, max_bw,
                             part, num_iterations, num_seed_nodes, alpha,
                             num_fruitless_moves, use_adaptive, seed);
  }
  Ctx c{n, k, xadj, adjncy, node_w, edge_w, max_bw, part, {}, {}};
  c.conn.resize(n * k);
  c.bw.resize(k);
  Rng rng(seed);
  build_conn(c);

  const int64_t T = std::max<int64_t>(1, num_threads);
  std::unique_ptr<std::atomic<int32_t>[]> owner(
      new std::atomic<int32_t>[n]);

  int64_t total = 0;
  int64_t first_pass_gain = 0;
  std::vector<int64_t> border;
  for (int64_t pass = 0; pass < std::max<int64_t>(1, num_iterations);
       ++pass) {
    // border nodes: nonzero external connection
    border.clear();
    for (int64_t u = 0; u < n; ++u) {
      const int64_t own = c.conn_at(u, c.part[u]);
      int64_t deg_w = 0;
      for (int64_t b = 0; b < k; ++b) deg_w += c.conn_at(u, b);
      if (deg_w > own) border.push_back(u);
    }
    if (border.empty()) break;
    for (int64_t i = (int64_t)border.size() - 1; i > 0; --i)
      std::swap(border[i], border[(int64_t)(rng.next() % (uint64_t)(i + 1))]);

    for (int64_t u = 0; u < n; ++u) owner[u].store(kFree, kRelaxed);
    const int64_t nseeds = std::max<int64_t>(1, num_seed_nodes);
    std::atomic<size_t> head{0};
    std::atomic<int64_t> pass_gain{0};
    std::atomic<int32_t> next_batch_id{0};

    auto worker = [&](int64_t tid) {
      Delta d(c);
      Rng wrng(seed ^ (0x9E3779B9ULL * (uint64_t)(pass * T + tid + 1)));
      // thread 0 on a single-thread run reuses the pass RNG so the
      // sequential state sequence matches the pre-threading code
      Rng& r = (T == 1) ? rng : wrng;
      std::vector<int64_t> scratch(k);
      std::vector<int64_t> seeds;
      for (;;) {
        // allocate the batch id FIRST so seed claims are uniquely
        // tagged from the start (a provisional shared tag could make a
        // foreign region adopt the seed)
        const int32_t my_id = next_batch_id.fetch_add(1, kRelaxed) + 1;
        seeds.clear();
        while ((int64_t)seeds.size() < nseeds) {
          const size_t i = head.fetch_add(1, kRelaxed);
          if (i >= border.size()) break;
          const int64_t u = border[i];
          int32_t expect = kFree;
          if (owner[u].compare_exchange_strong(expect, my_id, kRelaxed))
            seeds.push_back(u);
        }
        if (seeds.empty()) break;
        pass_gain.fetch_add(
            run_batch(c, d, owner.get(), my_id, seeds, alpha,
                      num_fruitless_moves, use_adaptive, r, scratch),
            kRelaxed);
      }
    };

    if (T == 1) {
      worker(0);
    } else {
      std::vector<std::thread> pool;
      pool.reserve(T);
      for (int64_t t = 0; t < T; ++t) pool.emplace_back(worker, t);
      for (auto& th : pool) th.join();
    }

    const int64_t pg = pass_gain.load(kRelaxed);
    total += pg;
    if (pg <= 0) break;
    // improvement abortion (initial_fm_refiner improvement_abortion
    // lineage): later passes chase diminishing returns at full pass cost
    if (pass == 0)
      first_pass_gain = pg;
    else if (pg * 20 < first_pass_gain)
      break;
  }
  return total;
}
