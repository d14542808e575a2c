// Native HNSW index: approximate cosine top-k for large catalogs.
//
// The reference serves similarity through Postgres pgvector's HNSW index
// (m=24, ef_construction=200, ef_search=100, cosine — `database.py:102-113`,
// `APIController/controller.py:84-94`). The exact scanner (vecindex.cc) is
// the honest equivalent at ~50k items; THIS is the equivalent at 1M+:
// a from-scratch Hierarchical Navigable Small World graph (Malkov &
// Yashunin 2016) with the reference's parameters as defaults.
//
//   * level assignment: floor(-ln(U) * 1/ln(M))
//   * insert: greedy descent to the node's level, then ef_construction
//     beam search per layer; neighbor selection by distance with degree
//     pruning (M per upper layer, 2M at layer 0)
//   * search: greedy descent with ef=1, beam of ef_search at layer 0
//
// Cosine metric via normalize-on-insert (dot == cosine). C ABI for ctypes.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

constexpr int kNumLinkLocks = 4096;  // striped per-node link locks

struct Hnsw {
  int dim = 0;
  int M = 24;                 // max degree on upper layers; 2M at layer 0
  int ef_construction = 200;
  double mult = 1.0 / std::log(24.0);
  std::mt19937_64 rng{42};

  std::vector<float> data;                    // (n, dim) normalized
  std::vector<int64_t> ids;                   // node -> external id
  std::unordered_map<int64_t, int> id_to_node;
  std::vector<int> levels;                    // node -> top level
  // links[l][node] = neighbor list (flat, padded with -1)
  std::vector<std::vector<int>> links;        // per level: n * cap ints
  int entry = -1;
  int max_level = -1;
  std::mutex mu;
  // striped locks guarding neighbor lists during concurrent insert
  std::unique_ptr<std::mutex[]> link_locks{new std::mutex[kNumLinkLocks]};

  std::mutex& link_lock(int node) {
    return link_locks[node & (kNumLinkLocks - 1)];
  }

  int cap(int level) const { return level == 0 ? 2 * M : M; }

  const float* vec(int node) const { return data.data() + (size_t)node * dim; }

  float dot(const float* a, const float* b) const {
    float s0 = 0, s1 = 0, s2 = 0, s3 = 0;
    int d = 0;
    for (; d + 4 <= dim; d += 4) {
      s0 += a[d] * b[d];
      s1 += a[d + 1] * b[d + 1];
      s2 += a[d + 2] * b[d + 2];
      s3 += a[d + 3] * b[d + 3];
    }
    for (; d < dim; ++d) s0 += a[d] * b[d];
    return s0 + s1 + s2 + s3;
  }

  int* neighbors(int level, int node) {
    return links[level].data() + (size_t)node * cap(level);
  }
};

void normalize(float* v, int dim) {
  double s = 0;
  for (int d = 0; d < dim; ++d) s += double(v[d]) * v[d];
  float inv = s > 0 ? float(1.0 / std::sqrt(s)) : 0.0f;
  for (int d = 0; d < dim; ++d) v[d] *= inv;
}

struct Cand {
  float sim;
  int node;
};
struct WorstFirst {  // min-heap on similarity
  bool operator()(const Cand& a, const Cand& b) const { return a.sim > b.sim; }
};
struct BestFirst {   // max-heap on similarity
  bool operator()(const Cand& a, const Cand& b) const { return a.sim < b.sim; }
};

// Per-thread scratch for concurrent searches (the index's shared
// visit_mark would race between inserter threads).
struct VisitBuf {
  std::vector<uint32_t> mark;
  uint32_t epoch = 0;
  std::vector<int> nb_copy;  // reusable snapshot of a neighbor list
};

// Beam search on one layer; returns up to ef best candidates.
// ``locked`` snapshots each neighbor list under its stripe lock — required
// while other threads may be concurrently rewriting links (parallel insert).
std::vector<Cand> search_layer(Hnsw* ix, const float* q, int entry, int level,
                               int ef, VisitBuf& vb, bool locked) {
  if (vb.mark.size() < ix->ids.size()) vb.mark.resize(ix->ids.size(), 0);
  uint32_t epoch = ++vb.epoch;
  std::priority_queue<Cand, std::vector<Cand>, BestFirst> frontier;
  std::priority_queue<Cand, std::vector<Cand>, WorstFirst> best;  // keep ef
  float e_sim = ix->dot(q, ix->vec(entry));
  frontier.push({e_sim, entry});
  best.push({e_sim, entry});
  vb.mark[entry] = epoch;
  int cap = ix->cap(level);
  vb.nb_copy.resize(cap);
  while (!frontier.empty()) {
    Cand c = frontier.top();
    frontier.pop();
    if ((int)best.size() >= ef && c.sim < best.top().sim) break;
    const int* nb;
    if (locked) {
      std::lock_guard<std::mutex> lk(ix->link_lock(c.node));
      std::memcpy(vb.nb_copy.data(), ix->neighbors(level, c.node),
                  sizeof(int) * cap);
      nb = vb.nb_copy.data();
    } else {
      nb = ix->neighbors(level, c.node);
    }
    for (int j = 0; j < cap; ++j) {
      int v = nb[j];
      if (v < 0) break;
      if (vb.mark[v] == epoch) continue;
      vb.mark[v] = epoch;
      float s = ix->dot(q, ix->vec(v));
      if ((int)best.size() < ef || s > best.top().sim) {
        frontier.push({s, v});
        best.push({s, v});
        if ((int)best.size() > ef) best.pop();
      }
    }
  }
  std::vector<Cand> out;
  out.reserve(best.size());
  while (!best.empty()) {
    out.push_back(best.top());
    best.pop();
  }
  std::reverse(out.begin(), out.end());  // best first
  return out;
}

// Diversity heuristic (Malkov & Yashunin alg. 4): keep candidate e only if
// it is closer to q than to every already-selected neighbor — preserves
// graph connectivity on clustered/high-dim data.
std::vector<int> select_neighbors(Hnsw* ix, const std::vector<Cand>& cands,
                                  int m) {
  std::vector<int> out;
  out.reserve(m);
  for (const Cand& c : cands) {
    if ((int)out.size() >= m) break;
    bool ok = true;
    const float* cv = ix->vec(c.node);
    for (int sel : out) {
      if (ix->dot(cv, ix->vec(sel)) > c.sim) {  // closer to a selected one
        ok = false;
        break;
      }
    }
    if (ok) out.push_back(c.node);
  }
  // backfill with closest skipped candidates if the heuristic was too strict
  for (const Cand& c : cands) {
    if ((int)out.size() >= m) break;
    if (std::find(out.begin(), out.end(), c.node) == out.end())
      out.push_back(c.node);
  }
  return out;
}

void add_link_unlocked(Hnsw* ix, int level, int from, int to) {
  int* nb = ix->neighbors(level, from);
  int cap = ix->cap(level);
  for (int j = 0; j < cap; ++j) {
    if (nb[j] == to) return;  // no duplicate links
    if (nb[j] < 0) {
      nb[j] = to;
      return;
    }
  }
  // full: re-select via the diversity heuristic over {existing + new}
  const float* fv = ix->vec(from);
  std::vector<Cand> all;
  all.push_back({ix->dot(fv, ix->vec(to)), to});
  for (int j = 0; j < cap; ++j) all.push_back({ix->dot(fv, ix->vec(nb[j])), nb[j]});
  std::sort(all.begin(), all.end(),
            [](const Cand& a, const Cand& b) { return a.sim > b.sim; });
  std::vector<int> kept = select_neighbors(ix, all, cap);
  for (int j = 0; j < cap; ++j) nb[j] = j < (int)kept.size() ? kept[j] : -1;
}

void add_link(Hnsw* ix, int level, int from, int to, bool locked) {
  if (!locked) {
    add_link_unlocked(ix, level, from, to);
    return;
  }
  std::lock_guard<std::mutex> lk(ix->link_lock(from));
  add_link_unlocked(ix, level, from, to);
}

// Allocate a node (data/ids/levels) WITHOUT sizing its link lists — call
// ensure_links() after a batch of allocations. Caller holds ix->mu.
// Returns -1 for an overwrite of an existing external id.
int alloc_node(Hnsw* ix, int64_t ext_id, const float* vec) {
  auto it = ix->id_to_node.find(ext_id);
  if (it != ix->id_to_node.end()) {  // overwrite vector, keep links
    float* dst = ix->data.data() + (size_t)it->second * ix->dim;
    std::memcpy(dst, vec, sizeof(float) * ix->dim);
    normalize(dst, ix->dim);
    return -1;
  }
  int node = (int)ix->ids.size();
  ix->ids.push_back(ext_id);
  ix->id_to_node[ext_id] = node;
  ix->data.insert(ix->data.end(), vec, vec + ix->dim);
  normalize(ix->data.data() + (size_t)node * ix->dim, ix->dim);
  std::uniform_real_distribution<double> uni(0.0, 1.0);
  double u = uni(ix->rng);
  if (u < 1e-12) u = 1e-12;
  ix->levels.push_back((int)std::floor(-std::log(u) * ix->mult));
  return node;
}

// Grow the per-level flat link arrays to the current node count.
// ``max_new_level`` = highest level among the just-allocated nodes (avoids
// an O(n) rescan of all node levels per insert).
void ensure_links(Hnsw* ix, int max_new_level) {
  while ((int)ix->links.size() <= max_new_level) ix->links.emplace_back();
  for (int l = 0; l < (int)ix->links.size(); ++l)
    ix->links[l].resize(ix->ids.size() * (size_t)ix->cap(l), -1);
}

// Wire a pre-allocated node into the graph (greedy descent + beam insert).
// ``locked=true`` makes every neighbor-list read/write go through the
// stripe locks so many threads can insert concurrently.
void insert_links(Hnsw* ix, int node, VisitBuf& vb, bool locked) {
  int level = ix->levels[node];
  int ep, top;
  {
    std::unique_lock<std::mutex> lk(ix->mu, std::defer_lock);
    if (locked) lk.lock();
    ep = ix->entry;
    top = ix->max_level;
  }
  const float* q = ix->vec(node);
  // greedy descent through layers above the node's level
  for (int l = top; l > level; --l) {
    bool improved = true;
    float best = ix->dot(q, ix->vec(ep));
    int cap = ix->cap(l);
    vb.nb_copy.resize(cap);
    while (improved) {
      improved = false;
      const int* nb;
      if (locked) {
        std::lock_guard<std::mutex> lk(ix->link_lock(ep));
        std::memcpy(vb.nb_copy.data(), ix->neighbors(l, ep), sizeof(int) * cap);
        nb = vb.nb_copy.data();
      } else {
        nb = ix->neighbors(l, ep);
      }
      for (int j = 0; j < cap; ++j) {
        if (nb[j] < 0) break;
        float s = ix->dot(q, ix->vec(nb[j]));
        if (s > best) {
          best = s;
          ep = nb[j];
          improved = true;
        }
      }
    }
  }
  // beam insert on layers [min(level, top) .. 0]
  for (int l = std::min(level, top); l >= 0; --l) {
    auto cands = search_layer(ix, q, ep, l, ix->ef_construction, vb, locked);
    std::vector<int> sel = select_neighbors(ix, cands, ix->M);
    for (int nb : sel) {
      add_link(ix, l, node, nb, locked);
      add_link(ix, l, nb, node, locked);
    }
    if (!cands.empty()) ep = cands[0].node;
  }
  if (level > top) {
    std::unique_lock<std::mutex> lk(ix->mu, std::defer_lock);
    if (locked) lk.lock();
    if (level > ix->max_level) {
      ix->max_level = level;
      ix->entry = node;
    }
  }
}

}  // namespace

extern "C" {

void* hnsw_create(int dim, int M, int ef_construction, uint64_t seed) {
  auto* ix = new Hnsw();
  ix->dim = dim;
  ix->M = M > 1 ? M : 24;
  ix->ef_construction = ef_construction > 0 ? ef_construction : 200;
  ix->mult = 1.0 / std::log((double)ix->M);
  ix->rng.seed(seed);
  return ix;
}

void hnsw_free(void* h) { delete static_cast<Hnsw*>(h); }
int64_t hnsw_size(void* h) { return (int64_t) static_cast<Hnsw*>(h)->ids.size(); }
int hnsw_dim(void* h) { return static_cast<Hnsw*>(h)->dim; }

void hnsw_add(void* h, const int64_t* ext_ids, const float* vecs, int64_t n) {
  auto* ix = static_cast<Hnsw*>(h);
  std::lock_guard<std::mutex> lock(ix->mu);
  VisitBuf vb;
  for (int64_t i = 0; i < n; ++i) {
    int node = alloc_node(ix, ext_ids[i], vecs + i * ix->dim);
    if (node < 0) continue;  // overwrite
    ensure_links(ix, ix->levels[node]);
    if (ix->entry < 0) {
      ix->entry = node;
      ix->max_level = ix->levels[node];
      continue;
    }
    insert_links(ix, node, vb, /*locked=*/false);
  }
}

// Concurrent batch insert (hnswlib-style): allocate every node up front
// under the global lock (so no vector reallocates during the parallel
// phase), then wire links from ``num_threads`` workers with striped
// per-node link locks and per-thread visit buffers. The reference's
// pgvector HNSW builds single-threaded inside Postgres; this is the
// serving-side answer to the "~30 s at 47k items" build-time bottleneck.
void hnsw_add_parallel(void* h, const int64_t* ext_ids, const float* vecs,
                       int64_t n, int num_threads) {
  auto* ix = static_cast<Hnsw*>(h);
  if (num_threads <= 1 || n < 64) {
    hnsw_add(h, ext_ids, vecs, n);
    return;
  }
  std::vector<int> nodes;
  nodes.reserve(n);
  {
    std::lock_guard<std::mutex> lock(ix->mu);
    int batch_max_level = 0;
    for (int64_t i = 0; i < n; ++i) {
      int node = alloc_node(ix, ext_ids[i], vecs + i * ix->dim);
      if (node >= 0) {
        nodes.push_back(node);
        batch_max_level = std::max(batch_max_level, ix->levels[node]);
      }
    }
    ensure_links(ix, batch_max_level);
    if (ix->entry < 0 && !nodes.empty()) {
      // seed the graph with the first node; it gets linked by its peers
      ix->entry = nodes.front();
      ix->max_level = ix->levels[nodes.front()];
      nodes.erase(nodes.begin());
    }
  }
  std::atomic<size_t> next{0};
  auto worker = [&]() {
    VisitBuf vb;
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= nodes.size()) break;
      insert_links(ix, nodes[i], vb, /*locked=*/true);
    }
  };
  int t = std::min<int64_t>(num_threads, (int64_t)nodes.size());
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (int i = 0; i < t; ++i) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

// Batch top-k: queries (m, dim) -> ids/scores (m, k), -1 padded.
void hnsw_topk(void* h, const float* queries, int64_t m, int k, int ef_search,
               int64_t* out_ids, float* out_scores) {
  auto* ix = static_cast<Hnsw*>(h);
  if (ef_search < k) ef_search = k;
  VisitBuf vb;
  for (int64_t qi = 0; qi < m; ++qi) {
    std::vector<float> q(queries + qi * ix->dim, queries + (qi + 1) * ix->dim);
    normalize(q.data(), ix->dim);
    int64_t* ids = out_ids + qi * k;
    float* scores = out_scores + qi * k;
    for (int j = 0; j < k; ++j) {
      ids[j] = -1;
      scores[j] = 0.0f;
    }
    if (ix->entry < 0) continue;
    int ep = ix->entry;
    for (int l = ix->max_level; l > 0; --l) {
      bool improved = true;
      float best = ix->dot(q.data(), ix->vec(ep));
      while (improved) {
        improved = false;
        const int* nb = ix->neighbors(l, ep);
        for (int j = 0; j < ix->cap(l); ++j) {
          if (nb[j] < 0) break;
          float s = ix->dot(q.data(), ix->vec(nb[j]));
          if (s > best) {
            best = s;
            ep = nb[j];
            improved = true;
          }
        }
      }
    }
    auto cands = search_layer(ix, q.data(), ep, 0, ef_search, vb,
                              /*locked=*/false);
    int got = std::min((int)cands.size(), k);
    for (int j = 0; j < got; ++j) {
      ids[j] = ix->ids[cands[j].node];
      scores[j] = cands[j].sim;
    }
  }
}

int hnsw_save(void* h, const char* path) {
  auto* ix = static_cast<Hnsw*>(h);
  FILE* f = std::fopen(path, "wb");
  if (!f) return 0;
  int64_t n = (int64_t)ix->ids.size();
  int n_levels = (int)ix->links.size();
  std::fwrite(&ix->dim, sizeof(int), 1, f);
  std::fwrite(&ix->M, sizeof(int), 1, f);
  std::fwrite(&ix->ef_construction, sizeof(int), 1, f);
  std::fwrite(&n, sizeof(int64_t), 1, f);
  std::fwrite(&ix->entry, sizeof(int), 1, f);
  std::fwrite(&ix->max_level, sizeof(int), 1, f);
  std::fwrite(&n_levels, sizeof(int), 1, f);
  std::fwrite(ix->ids.data(), sizeof(int64_t), n, f);
  std::fwrite(ix->levels.data(), sizeof(int), n, f);
  std::fwrite(ix->data.data(), sizeof(float), n * ix->dim, f);
  for (int l = 0; l < n_levels; ++l) {
    int64_t sz = (int64_t)ix->links[l].size();
    std::fwrite(&sz, sizeof(int64_t), 1, f);
    std::fwrite(ix->links[l].data(), sizeof(int), sz, f);
  }
  std::fclose(f);
  return 1;
}

void* hnsw_load(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  auto* ix = new Hnsw();
  int n_levels = 0;
  int64_t n = 0;
  bool ok = std::fread(&ix->dim, sizeof(int), 1, f) == 1 &&
            std::fread(&ix->M, sizeof(int), 1, f) == 1 &&
            std::fread(&ix->ef_construction, sizeof(int), 1, f) == 1 &&
            std::fread(&n, sizeof(int64_t), 1, f) == 1 &&
            std::fread(&ix->entry, sizeof(int), 1, f) == 1 &&
            std::fread(&ix->max_level, sizeof(int), 1, f) == 1 &&
            std::fread(&n_levels, sizeof(int), 1, f) == 1;
  if (ok) {
    ix->mult = 1.0 / std::log((double)ix->M);
    ix->ids.resize(n);
    ix->levels.resize(n);
    ix->data.resize(n * ix->dim);
    ok = std::fread(ix->ids.data(), sizeof(int64_t), n, f) == (size_t)n &&
         std::fread(ix->levels.data(), sizeof(int), n, f) == (size_t)n &&
         std::fread(ix->data.data(), sizeof(float), n * ix->dim, f) ==
             (size_t)(n * ix->dim);
    for (int l = 0; ok && l < n_levels; ++l) {
      int64_t sz = 0;
      ok = std::fread(&sz, sizeof(int64_t), 1, f) == 1;
      if (ok) {
        ix->links.emplace_back(sz);
        ok = std::fread(ix->links.back().data(), sizeof(int), sz, f) == (size_t)sz;
      }
    }
  }
  std::fclose(f);
  if (!ok) {
    delete ix;
    return nullptr;
  }
  for (int64_t i = 0; i < n; ++i) ix->id_to_node[ix->ids[i]] = (int)i;
  return ix;
}

}  // extern "C"
