// Sequential multilevel 2-way bipartitioner (native host runtime).
//
// The native equivalent of kaminpar_tpu/initial/{coarsening,flat,fm,
// bipartitioner}.py — itself the analog of the reference's sequential
// initial partitioning stack (kaminpar-shm/initial_partitioning/:
// initial_coarsener.cc, initial_{bfs,ggg,random}_bipartitioner.h,
// initial_fm_refiner.h:68, initial_pool_bipartitioner.h:24-56,
// initial_multilevel_bipartitioner.cc:55,83).  The reference keeps this
// stage sequential C++ per thread by design; the Python/numpy port of it
// became the single largest host cost of the TPU pipeline (a 16k-node
// coarsest graph costs ~60 s in pure-python FM loops), so this file
// restores the reference's design point: the whole multilevel
// bipartition — LP coarsening, flat pool, FM at every level — runs
// native, exposed through one C ABI entry point called via ctypes.
//
// Algorithmic behavior matches the Python implementation (same config
// knobs, same stopping rules, same pool adaptivity); node visit order
// and tie-breaking use a private RNG, so cuts differ seed-to-seed from
// the numpy path the way two reference threads' results do.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <queue>
#include <tuple>
#include <vector>

namespace {

// ---------------------------------------------------------------- RNG --
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed ^ 0x9E3779B97F4A7C15ULL) {
    if (s == 0) s = 0x2545F4914F6CDD1DULL;
  }
  uint64_t next() {
    // splitmix64
    uint64_t z = (s += 0x9E3779B97F4A7C15ULL);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  }
  int64_t below(int64_t n) { return n > 0 ? (int64_t)(next() % (uint64_t)n) : 0; }
  uint32_t tie() { return (uint32_t)(next() >> 32); }
};

// -------------------------------------------------------------- Graph --
struct Graph {
  int64_t n = 0, m = 0;
  const int64_t* xadj = nullptr;
  const int32_t* adjncy = nullptr;
  const int64_t* node_w = nullptr;
  const int64_t* edge_w = nullptr;
  // backing storage for coarse levels (views point into these)
  std::vector<int64_t> xadj_v, node_w_v, edge_w_v;
  std::vector<int32_t> adjncy_v;

  void adopt() {
    xadj = xadj_v.data();
    adjncy = adjncy_v.data();
    node_w = node_w_v.data();
    edge_w = edge_w_v.data();
    n = (int64_t)xadj_v.size() - 1;
    m = (int64_t)adjncy_v.size();
  }
  int64_t total_node_weight() const {
    int64_t t = 0;
    for (int64_t u = 0; u < n; ++u) t += node_w[u];
    return t;
  }
};

struct Level {
  Graph coarse;
  std::vector<int32_t> cmap;  // fine node -> coarse node
};

// ------------------------------------------------- LP coarsening pass --
// Async in-order size-constrained LP (initial_coarsener.cc behavior):
// visit nodes in random order, move each to its best-rated cluster under
// the weight cap.  Dense rating array + touched list (the RatingMap
// small-map analog at these sizes).
int64_t lp_cluster(const Graph& g, int64_t max_cluster_weight, Rng& rng,
                   std::vector<int32_t>& labels, int iterations = 3) {
  const int64_t n = g.n;
  labels.resize(n);
  for (int64_t u = 0; u < n; ++u) labels[u] = (int32_t)u;
  if (n == 0 || g.m == 0) return n;

  std::vector<int64_t> cw(g.node_w, g.node_w + n);
  std::vector<int64_t> rating(n, 0);
  std::vector<int32_t> touched;
  touched.reserve(64);
  std::vector<int32_t> order(n);
  for (int64_t u = 0; u < n; ++u) order[u] = (int32_t)u;

  for (int it = 0; it < iterations; ++it) {
    // Fisher–Yates shuffle
    for (int64_t i = n - 1; i > 0; --i) {
      int64_t j = rng.below(i + 1);
      std::swap(order[i], order[j]);
    }
    int64_t moves = 0;
    for (int64_t idx = 0; idx < n; ++idx) {
      const int32_t u = order[idx];
      const int64_t lo = g.xadj[u], hi = g.xadj[u + 1];
      if (lo == hi) continue;
      touched.clear();
      for (int64_t e = lo; e < hi; ++e) {
        const int32_t c = labels[g.adjncy[e]];
        if (rating[c] == 0) touched.push_back(c);
        rating[c] += g.edge_w[e];
      }
      const int32_t own = labels[u];
      const int64_t wu = g.node_w[u];
      int64_t best_r = (rating[own] > 0) ? rating[own] : 0;
      int32_t best_c = own;
      uint32_t best_t = 0;
      for (int32_t c : touched) {
        if (c == own) continue;
        if (cw[c] + wu > max_cluster_weight) continue;
        const int64_t r = rating[c];
        if (r > best_r) {
          best_r = r;
          best_c = c;
          best_t = rng.tie();
        } else if (r == best_r && r > 0) {
          const uint32_t t = rng.tie();
          if (t > best_t) {
            best_c = c;
            best_t = t;
          }
        }
      }
      for (int32_t c : touched) rating[c] = 0;
      if (best_c != own) {
        cw[own] -= wu;
        cw[best_c] += wu;
        labels[u] = best_c;
        ++moves;
      }
    }
    if (moves == 0) break;
  }
  // count distinct clusters
  std::vector<int64_t> seen(n, 0);
  int64_t distinct = 0;
  for (int64_t u = 0; u < n; ++u) {
    if (!seen[labels[u]]) {
      seen[labels[u]] = 1;
      ++distinct;
    }
  }
  return distinct;
}

// ------------------------------------------------------- contraction --
// Sequential analog of contraction/cluster_contraction.h: dense leader
// remap, bucket fine nodes by coarse id, dedup edges per coarse node
// with a dense rating map.
void contract(const Graph& g, const std::vector<int32_t>& labels,
              Graph& coarse, std::vector<int32_t>& cmap) {
  const int64_t n = g.n;
  std::vector<int32_t> remap(n, -1);
  cmap.resize(n);
  int32_t c_n = 0;
  for (int64_t u = 0; u < n; ++u) {
    int32_t l = labels[u];
    if (remap[l] < 0) remap[l] = c_n++;
    cmap[u] = remap[l];
  }
  // bucket fine nodes by coarse id (counting sort)
  std::vector<int64_t> bstart(c_n + 1, 0);
  for (int64_t u = 0; u < n; ++u) ++bstart[cmap[u] + 1];
  for (int32_t c = 0; c < c_n; ++c) bstart[c + 1] += bstart[c];
  std::vector<int32_t> bucket(n);
  {
    std::vector<int64_t> pos(bstart.begin(), bstart.end() - 1);
    for (int64_t u = 0; u < n; ++u) bucket[pos[cmap[u]]++] = (int32_t)u;
  }
  coarse.node_w_v.assign(c_n, 0);
  for (int64_t u = 0; u < n; ++u) coarse.node_w_v[cmap[u]] += g.node_w[u];

  coarse.xadj_v.assign(c_n + 1, 0);
  coarse.adjncy_v.clear();
  coarse.edge_w_v.clear();
  std::vector<int64_t> rating(c_n, 0);
  std::vector<int32_t> touched;
  for (int32_t c = 0; c < c_n; ++c) {
    touched.clear();
    for (int64_t i = bstart[c]; i < bstart[c + 1]; ++i) {
      const int32_t u = bucket[i];
      for (int64_t e = g.xadj[u]; e < g.xadj[u + 1]; ++e) {
        const int32_t cv = cmap[g.adjncy[e]];
        if (cv == c) continue;
        if (rating[cv] == 0) touched.push_back(cv);
        rating[cv] += g.edge_w[e];
      }
    }
    for (int32_t cv : touched) {
      coarse.adjncy_v.push_back(cv);
      coarse.edge_w_v.push_back(rating[cv]);
      rating[cv] = 0;
    }
    coarse.xadj_v[c + 1] = (int64_t)coarse.adjncy_v.size();
  }
  coarse.adopt();
}

// ------------------------------------------------- flat bipartitioners --
// Shared growth postlude: admit a random weight-prefix of the remainder
// (the fragmented-remainder bulk admit both python growers use).
void bulk_admit_rest(const Graph& g, std::vector<int8_t>& part, int64_t& w0,
                     int64_t target0, int64_t stop_at,
                     const std::vector<int8_t>& taken, Rng& rng) {
  std::vector<int32_t> rest;
  for (int64_t u = 0; u < g.n; ++u)
    if (!taken[u]) rest.push_back((int32_t)u);
  for (int64_t i = (int64_t)rest.size() - 1; i > 0; --i)
    std::swap(rest[i], rest[rng.below(i + 1)]);
  for (int32_t u : rest) {
    if (w0 >= stop_at) break;
    if (w0 + g.node_w[u] <= target0) {
      part[u] = 0;
      w0 += g.node_w[u];
    }
  }
}

void random_bipartition(const Graph& g, const int64_t max_bw[2], Rng& rng,
                        std::vector<int8_t>& part) {
  const int64_t n = g.n;
  part.assign(n, 0);
  int64_t w[2] = {0, 0};
  std::vector<int32_t> order(n);
  for (int64_t u = 0; u < n; ++u) order[u] = (int32_t)u;
  for (int64_t i = n - 1; i > 0; --i)
    std::swap(order[i], order[rng.below(i + 1)]);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t u = order[i];
    int b = (int)(rng.next() & 1);
    if (w[b] + g.node_w[u] > max_bw[b]) b = 1 - b;
    part[u] = (int8_t)b;
    w[b] += g.node_w[u];
  }
}

// Greedy BFS growth (initial_bfs_bipartitioner.h:41): grow block 0 from
// a random seed node-by-node in queue order, skipping too-heavy nodes,
// reseeding into unexplored components.
void bfs_bipartition(const Graph& g, const int64_t max_bw[2], Rng& rng,
                     std::vector<int8_t>& part) {
  const int64_t n = g.n;
  part.assign(n, 1);
  if (n == 0) return;
  const int64_t total = g.total_node_weight();
  const int64_t target0 = max_bw[0];
  const int64_t stop_at = std::max(total - max_bw[1], (total + 1) / 2);

  std::vector<int8_t> visited(n, 0);
  std::vector<int32_t> queue;
  queue.reserve(n);
  int64_t head = 0;
  int64_t w0 = 0;
  int32_t seed = (int32_t)rng.below(n);
  visited[seed] = 1;
  queue.push_back(seed);
  int64_t visited_count = 1;
  while (w0 < stop_at) {
    if (head == (int64_t)queue.size()) {
      if (visited_count == n) break;
      // reseed into an unvisited component
      int32_t s = -1;
      // random probe first (fast on large remainders), linear fallback
      for (int tries = 0; tries < 16; ++tries) {
        int32_t c = (int32_t)rng.below(n);
        if (!visited[c]) {
          s = c;
          break;
        }
      }
      if (s < 0) {
        for (int64_t u = 0; u < n; ++u)
          if (!visited[u]) {
            s = (int32_t)u;
            break;
          }
      }
      visited[s] = 1;
      ++visited_count;
      queue.push_back(s);
    }
    const int32_t u = queue[head++];
    if (w0 + g.node_w[u] <= target0) {
      part[u] = 0;
      w0 += g.node_w[u];
    }
    for (int64_t e = g.xadj[u]; e < g.xadj[u + 1]; ++e) {
      const int32_t v = g.adjncy[e];
      if (!visited[v]) {
        visited[v] = 1;
        ++visited_count;
        queue.push_back(v);
      }
    }
  }
}

// Greedy graph growing (initial_ggg_bipartitioner.h:18): absorb the
// frontier node with the highest gain (connection to block 0 minus
// connection to block 1 approximated as connection growth, like the
// python port: gain = accumulated connection to block 0).
void ggg_bipartition(const Graph& g, const int64_t max_bw[2], Rng& rng,
                     std::vector<int8_t>& part) {
  const int64_t n = g.n;
  part.assign(n, 1);
  if (n == 0) return;
  const int64_t total = g.total_node_weight();
  const int64_t target0 = max_bw[0];
  const int64_t stop_at = std::max(total - max_bw[1], (total + 1) / 2);

  std::vector<int64_t> gain(n, -1);
  std::vector<int8_t> taken(n, 0);
  using Entry = std::tuple<int64_t, uint32_t, int32_t>;  // (gain, tie, u)
  std::priority_queue<Entry> pq;
  int32_t seed = (int32_t)rng.below(n);
  gain[seed] = 0;
  pq.push({0, rng.tie(), seed});
  int64_t w0 = 0;
  while (w0 < stop_at) {
    int32_t u = -1;
    while (!pq.empty()) {
      auto [gq, t, cand] = pq.top();
      pq.pop();
      if (!taken[cand] && gain[cand] == gq) {
        u = cand;
        break;
      }
    }
    if (u < 0) {
      // reseed or bulk-admit the fragmented remainder
      int32_t s = -1;
      for (int tries = 0; tries < 16; ++tries) {
        int32_t c = (int32_t)rng.below(n);
        if (!taken[c] && gain[c] < 0) {
          s = c;
          break;
        }
      }
      if (s < 0) {
        bulk_admit_rest(g, part, w0, target0, stop_at, taken, rng);
        break;
      }
      gain[s] = 0;
      pq.push({0, rng.tie(), s});
      continue;
    }
    if (w0 + g.node_w[u] > target0) {
      taken[u] = 1;  // too heavy: drop from frontier, stays in block 1
      continue;
    }
    taken[u] = 1;
    part[u] = 0;
    w0 += g.node_w[u];
    for (int64_t e = g.xadj[u]; e < g.xadj[u + 1]; ++e) {
      const int32_t v = g.adjncy[e];
      if (taken[v]) continue;
      gain[v] = (gain[v] < 0 ? 0 : gain[v]) + g.edge_w[e];
      pq.push({gain[v], rng.tie(), v});
    }
  }
}

// ------------------------------------------------------------ metrics --
int64_t cut_of(const Graph& g, const std::vector<int8_t>& part) {
  int64_t cut = 0;
  for (int64_t u = 0; u < g.n; ++u)
    for (int64_t e = g.xadj[u]; e < g.xadj[u + 1]; ++e)
      if (part[u] != part[g.adjncy[e]]) cut += g.edge_w[e];
  return cut / 2;
}

int64_t overload_of(const Graph& g, const std::vector<int8_t>& part,
                    const int64_t max_bw[2]) {
  int64_t w[2] = {0, 0};
  for (int64_t u = 0; u < g.n; ++u) w[part[u]] += g.node_w[u];
  return std::max<int64_t>(w[0] - max_bw[0], 0) +
         std::max<int64_t>(w[1] - max_bw[1], 0);
}

// ------------------------------------------------------------- 2-way FM --
struct FmConfig {
  int disabled;
  int stopping_rule;  // 0 = simple, 1 = adaptive
  int64_t num_fruitless_moves;
  double alpha;
  int64_t num_iterations;
};

// One FM pass (initial_fm_refiner.h:68 / python _fm_pass): two PQs with
// lazy deletion, best-prefix rollback, simple/adaptive stopping.
int64_t fm_pass(const Graph& g, std::vector<int8_t>& part,
                const int64_t max_bw[2], const FmConfig& cfg, Rng& rng) {
  const int64_t n = g.n;
  std::vector<int64_t> gain(n, 0);
  int64_t block_w[2] = {0, 0};
  for (int64_t u = 0; u < n; ++u) {
    block_w[part[u]] += g.node_w[u];
    int64_t ext = 0, internal = 0;
    for (int64_t e = g.xadj[u]; e < g.xadj[u + 1]; ++e) {
      if (part[g.adjncy[e]] != part[u])
        ext += g.edge_w[e];
      else
        internal += g.edge_w[e];
    }
    gain[u] = ext - internal;
  }
  using Entry = std::tuple<int64_t, uint32_t, int32_t>;
  std::priority_queue<Entry> pqs[2];
  std::vector<uint32_t> tie(n);
  for (int64_t u = 0; u < n; ++u) {
    tie[u] = rng.tie();
    pqs[part[u]].push({gain[u], tie[u], (int32_t)u});
  }
  std::vector<int8_t> locked(n, 0);

  // stopping state
  int64_t fruitless = 0;
  int64_t steps = 0;
  double mean = 0.0, m2 = 0.0;

  std::vector<int32_t> moves;
  moves.reserve(n);
  int64_t cur_delta = 0, best_delta = 0;
  size_t best_len = 0;

  while (true) {
    // peek the best valid candidate of each block
    int have[2] = {0, 0};
    Entry top[2];
    for (int b = 0; b < 2; ++b) {
      auto& pq = pqs[b];
      while (!pq.empty()) {
        auto [gq, t, u] = pq.top();
        if (locked[u] || part[u] != b || gain[u] != gq) {
          pq.pop();
          continue;
        }
        top[b] = pq.top();
        have[b] = 1;
        break;
      }
    }
    int pick = -1;
    // prefer the feasible move with higher (gain, tie)
    for (int b = 0; b < 2; ++b) {
      if (!have[b]) continue;
      const int32_t u = std::get<2>(top[b]);
      if (block_w[1 - b] + g.node_w[u] > max_bw[1 - b]) continue;
      if (pick < 0 || top[b] > top[pick]) pick = b;
    }
    if (pick < 0) {
      // no balance-feasible move: move from the heavier block
      const int heavier = block_w[1] > block_w[0] ? 1 : 0;
      if (!have[heavier]) break;
      pick = heavier;
    }
    const auto [gq, t, u] = top[pick];
    const int b = pick;
    pqs[b].pop();

    locked[u] = 1;
    part[u] = (int8_t)(1 - b);
    block_w[b] -= g.node_w[u];
    block_w[1 - b] += g.node_w[u];
    cur_delta += gq;
    moves.push_back(u);

    // stopping update
    if (cfg.stopping_rule == 0) {
      fruitless = gq > 0 ? 0 : fruitless + 1;
    } else {
      ++steps;
      const double d = (double)gq - mean;
      mean += d / (double)steps;
      m2 += d * ((double)gq - mean);
    }
    if (cur_delta > best_delta) {
      best_delta = cur_delta;
      best_len = moves.size();
    }

    for (int64_t e = g.xadj[u]; e < g.xadj[u + 1]; ++e) {
      const int32_t v = g.adjncy[e];
      const int64_t w = g.edge_w[e];
      if (part[v] == b)
        gain[v] += 2 * w;
      else
        gain[v] -= 2 * w;
      if (!locked[v]) pqs[part[v]].push({gain[v], tie[v], v});
    }
    gain[u] = -gain[u];

    if (cfg.stopping_rule == 0) {
      if (fruitless >= cfg.num_fruitless_moves) break;
    } else if (steps >= 2) {
      const double variance = m2 / (double)(steps - 1);
      if (mean < 0 &&
          (double)steps * mean * mean > cfg.alpha * variance + 10.0)
        break;
    }
  }
  for (size_t i = best_len; i < moves.size(); ++i)
    part[moves[i]] = (int8_t)(1 - part[moves[i]]);
  return best_delta;
}

int64_t fm_refine(const Graph& g, std::vector<int8_t>& part,
                  const int64_t max_bw[2], const FmConfig& cfg, Rng& rng) {
  if (cfg.disabled || g.n == 0) return 0;
  int64_t total = 0;
  const int64_t iters = std::max<int64_t>(1, cfg.num_iterations);
  for (int64_t i = 0; i < iters; ++i) {
    const int64_t imp = fm_pass(g, part, max_bw, cfg, rng);
    total += imp;
    if (imp == 0) break;
  }
  return total;
}

// --------------------------------------------------------------- pool --
struct PoolConfig {
  int64_t min_reps, min_nonadaptive_reps, max_reps;
  double rep_multiplier;
  int adaptive;
  int enable[3];  // bfs, ggg, random
  FmConfig fm;
};

void pool_bipartition(const Graph& g, const int64_t max_bw[2],
                      const PoolConfig& cfg, Rng& rng,
                      std::vector<int8_t>& best_part) {
  struct PoolEntry {
    int which;  // 0 bfs, 1 ggg, 2 random
    int64_t runs = 0;
    double mean = 0.0;
  };
  std::vector<PoolEntry> entries;
  for (int i = 0; i < 3; ++i)
    if (cfg.enable[i]) entries.push_back({i});
  if (entries.empty()) entries.push_back({2});

  int64_t n_reps = (int64_t)std::llround(cfg.rep_multiplier *
                                         (double)cfg.min_reps);
  n_reps = std::max<int64_t>(1, std::min(n_reps, cfg.max_reps));

  std::vector<int8_t> part;
  int64_t best_overload = INT64_MAX, best_cut = INT64_MAX;
  best_part.assign(g.n, 0);
  for (int64_t rep = 0; rep < n_reps; ++rep) {
    size_t skip = entries.size();  // index of the entry to skip (none)
    if (cfg.adaptive && rep >= cfg.min_nonadaptive_reps &&
        entries.size() > 1) {
      // skip the worst-scoring bipartitioner this rep
      double worst = -1.0;
      for (size_t i = 0; i < entries.size(); ++i)
        if (entries[i].mean > worst) {
          worst = entries[i].mean;
          skip = i;
        }
    }
    for (size_t i = 0; i < entries.size(); ++i) {
      if (i == skip) continue;
      auto& entry = entries[i];
      switch (entry.which) {
        case 0: bfs_bipartition(g, max_bw, rng, part); break;
        case 1: ggg_bipartition(g, max_bw, rng, part); break;
        default: random_bipartition(g, max_bw, rng, part); break;
      }
      fm_refine(g, part, max_bw, cfg.fm, rng);
      const int64_t cut = cut_of(g, part);
      const int64_t overload = overload_of(g, part, max_bw);
      const double score = (double)cut + (double)overload * 1000.0;
      entry.runs += 1;
      entry.mean += (score - entry.mean) / (double)entry.runs;
      if (overload < best_overload ||
          (overload == best_overload && cut < best_cut)) {
        best_overload = overload;
        best_cut = cut;
        best_part = part;
      }
    }
  }
}

}  // namespace

// ------------------------------------------------------------- C ABI --
extern "C" int64_t kmp_ml_bipartition(
    int64_t n, const int64_t* xadj, const int32_t* adjncy,
    const int64_t* node_w, const int64_t* edge_w, int64_t max_w0,
    int64_t max_w1,
    // initial coarsening (initial_coarsener.cc loop)
    int64_t ic_contraction_limit, double ic_convergence_threshold,
    int64_t max_cluster_weight,
    // pool (initial_pool_bipartitioner.h)
    int64_t pool_min_reps, int64_t pool_min_nonadaptive_reps,
    int64_t pool_max_reps, double pool_rep_multiplier, int32_t pool_adaptive,
    int32_t enable_bfs, int32_t enable_ggg, int32_t enable_random,
    // pool-internal FM
    int32_t pfm_disabled, int32_t pfm_stopping_rule,
    int64_t pfm_num_fruitless_moves, double pfm_alpha,
    int64_t pfm_num_iterations,
    // per-level FM (outer refinement ctx)
    int32_t fm_disabled, int32_t fm_stopping_rule,
    int64_t fm_num_fruitless_moves, double fm_alpha, int64_t fm_num_iterations,
    uint64_t seed, int8_t* out_part) {
  if (n <= 0) return 0;
  Rng rng(seed);
  const int64_t max_bw[2] = {max_w0, max_w1};

  Graph root;
  root.n = n;
  root.m = xadj[n];
  root.xadj = xadj;
  root.adjncy = adjncy;
  root.node_w = node_w;
  root.edge_w = edge_w;

  // --- coarsen (coarsen_for_bipartition) ---
  // deque, NOT vector: `current` points into the container while new
  // levels are appended; vector reallocation would dangle it
  std::deque<Level> levels;
  const Graph* current = &root;
  const int64_t limit = 2 * ic_contraction_limit;
  std::vector<int32_t> labels;
  while (current->n > limit) {
    const int64_t distinct =
        lp_cluster(*current, max_cluster_weight, rng, labels);
    if ((double)distinct >=
        (1.0 - ic_convergence_threshold) * (double)current->n)
      break;  // converged, not shrinking enough
    levels.emplace_back();
    contract(*current, labels, levels.back().coarse, levels.back().cmap);
    current = &levels.back().coarse;
  }

  // --- flat pool on the coarsest ---
  PoolConfig pool_cfg;
  pool_cfg.min_reps = pool_min_reps;
  pool_cfg.min_nonadaptive_reps = pool_min_nonadaptive_reps;
  pool_cfg.max_reps = pool_max_reps;
  pool_cfg.rep_multiplier = pool_rep_multiplier;
  pool_cfg.adaptive = pool_adaptive;
  pool_cfg.enable[0] = enable_bfs;
  pool_cfg.enable[1] = enable_ggg;
  pool_cfg.enable[2] = enable_random;
  pool_cfg.fm = {pfm_disabled, pfm_stopping_rule, pfm_num_fruitless_moves,
                 pfm_alpha, pfm_num_iterations};
  std::vector<int8_t> part;
  pool_bipartition(*current, max_bw, pool_cfg, rng, part);

  // --- uncoarsen with FM per level ---
  const FmConfig fm_cfg = {fm_disabled, fm_stopping_rule,
                           fm_num_fruitless_moves, fm_alpha,
                           fm_num_iterations};
  for (int64_t i = (int64_t)levels.size() - 1; i >= 0; --i) {
    const auto& cmap = levels[i].cmap;
    const Graph& fine = (i > 0) ? levels[i - 1].coarse : root;
    std::vector<int8_t> fine_part(fine.n);
    for (int64_t u = 0; u < fine.n; ++u) fine_part[u] = part[cmap[u]];
    part.swap(fine_part);
    fm_refine(fine, part, max_bw, fm_cfg, rng);
  }

  std::memcpy(out_part, part.data(), (size_t)n);
  return cut_of(root, part);
}
