// Native vector index: the serving-side ANN/top-k engine.
//
// TPU-native replacement for the reference's Postgres pgvector HNSW index
// (reference `database.py:102-113`, `APIController/controller.py:84-116`):
// the big batch scoring runs on TPU through the sharded top-k path, and
// THIS index serves low-latency single/low-batch similarity queries on the
// host without a device roundtrip. Exact brute-force scan (the honest
// equivalent at catalog scale ~100k x 128), multithreaded and blocked for
// cache locality, with incremental add/remove and binary save/load.
//
// C ABI only — consumed from Python via ctypes (no pybind11 in the image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct VecIndex {
  int dim = 0;
  bool cosine = true;  // normalize vectors on insert; dot == cosine
  std::vector<float> data;          // row-major (n, dim)
  std::vector<int64_t> ids;         // row -> external id
  std::unordered_map<int64_t, size_t> id_to_row;
  std::mutex mu;

  size_t size() const { return ids.size(); }
};

void normalize_row(float* v, int dim) {
  double s = 0.0;
  for (int d = 0; d < dim; ++d) s += double(v[d]) * v[d];
  float inv = s > 0 ? float(1.0 / std::sqrt(s)) : 0.0f;
  for (int d = 0; d < dim; ++d) v[d] *= inv;
}

struct HeapEntry {
  float score;
  int64_t id;
  bool operator<(const HeapEntry& o) const { return score > o.score; }  // min-heap
};

// Scan rows [lo, hi) for one query, maintaining a k-min-heap.
void scan_range(const VecIndex* ix, const float* q, size_t lo, size_t hi, int k,
                std::vector<HeapEntry>* heap) {
  const int dim = ix->dim;
  for (size_t r = lo; r < hi; ++r) {
    const float* row = ix->data.data() + r * dim;
    float s = 0.0f;
    int d = 0;
    // 4-way unrolled dot product; the compiler vectorizes this cleanly
    float s0 = 0, s1 = 0, s2 = 0, s3 = 0;
    for (; d + 4 <= dim; d += 4) {
      s0 += row[d] * q[d];
      s1 += row[d + 1] * q[d + 1];
      s2 += row[d + 2] * q[d + 2];
      s3 += row[d + 3] * q[d + 3];
    }
    for (; d < dim; ++d) s0 += row[d] * q[d];
    s = s0 + s1 + s2 + s3;
    if ((int)heap->size() < k) {
      heap->push_back({s, ix->ids[r]});
      std::push_heap(heap->begin(), heap->end());
    } else if (s > heap->front().score) {
      std::pop_heap(heap->begin(), heap->end());
      heap->back() = {s, ix->ids[r]};
      std::push_heap(heap->begin(), heap->end());
    }
  }
}

}  // namespace

extern "C" {

void* vecindex_create(int dim, int cosine) {
  auto* ix = new VecIndex();
  ix->dim = dim;
  ix->cosine = cosine != 0;
  return ix;
}

void vecindex_free(void* h) { delete static_cast<VecIndex*>(h); }

int vecindex_dim(void* h) { return static_cast<VecIndex*>(h)->dim; }
int64_t vecindex_size(void* h) {
  return (int64_t) static_cast<VecIndex*>(h)->size();
}

// Upsert n vectors. Existing ids are overwritten in place.
void vecindex_add(void* h, const int64_t* ids, const float* vecs, int64_t n) {
  auto* ix = static_cast<VecIndex*>(h);
  std::lock_guard<std::mutex> lock(ix->mu);
  const int dim = ix->dim;
  for (int64_t i = 0; i < n; ++i) {
    std::vector<float> row(vecs + i * dim, vecs + (i + 1) * dim);
    if (ix->cosine) normalize_row(row.data(), dim);
    auto it = ix->id_to_row.find(ids[i]);
    if (it != ix->id_to_row.end()) {
      std::memcpy(ix->data.data() + it->second * dim, row.data(),
                  sizeof(float) * dim);
    } else {
      ix->id_to_row[ids[i]] = ix->ids.size();
      ix->ids.push_back(ids[i]);
      ix->data.insert(ix->data.end(), row.begin(), row.end());
    }
  }
}

// Remove one id (swap-with-last). Returns 1 if removed.
int vecindex_remove(void* h, int64_t id) {
  auto* ix = static_cast<VecIndex*>(h);
  std::lock_guard<std::mutex> lock(ix->mu);
  auto it = ix->id_to_row.find(id);
  if (it == ix->id_to_row.end()) return 0;
  size_t row = it->second, last = ix->size() - 1;
  const int dim = ix->dim;
  if (row != last) {
    std::memcpy(ix->data.data() + row * dim, ix->data.data() + last * dim,
                sizeof(float) * dim);
    ix->ids[row] = ix->ids[last];
    ix->id_to_row[ix->ids[row]] = row;
  }
  ix->ids.pop_back();
  ix->data.resize(ix->ids.size() * dim);
  ix->id_to_row.erase(it);
  return 1;
}

// Batch top-k: queries (m, dim) -> out_ids/out_scores (m, k), -1 padded.
void vecindex_topk(void* h, const float* queries, int64_t m, int k,
                   int64_t* out_ids, float* out_scores, int num_threads) {
  auto* ix = static_cast<VecIndex*>(h);
  const int dim = ix->dim;
  const size_t n = ix->size();
  if (num_threads < 1) num_threads = 1;

  auto run_query = [&](int64_t qi) {
    std::vector<float> q(queries + qi * dim, queries + (qi + 1) * dim);
    if (ix->cosine) normalize_row(q.data(), dim);
    std::vector<HeapEntry> heap;
    heap.reserve(k);
    scan_range(ix, q.data(), 0, n, k, &heap);
    std::sort(heap.begin(), heap.end(),
              [](const HeapEntry& a, const HeapEntry& b) {
                return a.score > b.score;
              });
    for (int j = 0; j < k; ++j) {
      if (j < (int)heap.size()) {
        out_ids[qi * k + j] = heap[j].id;
        out_scores[qi * k + j] = heap[j].score;
      } else {
        out_ids[qi * k + j] = -1;
        out_scores[qi * k + j] = 0.0f;
      }
    }
  };

  if (num_threads == 1 || m == 1) {
    // parallelize the scan itself for single queries on big indexes
    if (m == 1 && num_threads > 1 && n > 4096) {
      std::vector<float> q(queries, queries + dim);
      if (ix->cosine) normalize_row(q.data(), dim);
      std::vector<std::vector<HeapEntry>> heaps(num_threads);
      std::vector<std::thread> ts;
      size_t chunk = (n + num_threads - 1) / num_threads;
      for (int t = 0; t < num_threads; ++t) {
        size_t lo = t * chunk, hi = std::min(n, lo + chunk);
        ts.emplace_back([&, lo, hi, t] {
          heaps[t].reserve(k);
          scan_range(ix, q.data(), lo, hi, k, &heaps[t]);
        });
      }
      for (auto& t : ts) t.join();
      std::vector<HeapEntry> all;
      for (auto& hp : heaps) all.insert(all.end(), hp.begin(), hp.end());
      std::sort(all.begin(), all.end(), [](const HeapEntry& a, const HeapEntry& b) {
        return a.score > b.score;
      });
      for (int j = 0; j < k; ++j) {
        if (j < (int)all.size()) {
          out_ids[j] = all[j].id;
          out_scores[j] = all[j].score;
        } else {
          out_ids[j] = -1;
          out_scores[j] = 0.0f;
        }
      }
      return;
    }
    for (int64_t qi = 0; qi < m; ++qi) run_query(qi);
    return;
  }
  // parallelize over queries
  std::vector<std::thread> ts;
  int64_t per = (m + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    int64_t lo = t * per, hi = std::min<int64_t>(m, lo + per);
    if (lo >= hi) break;
    ts.emplace_back([&, lo, hi] {
      for (int64_t qi = lo; qi < hi; ++qi) run_query(qi);
    });
  }
  for (auto& t : ts) t.join();
}

int vecindex_save(void* h, const char* path) {
  auto* ix = static_cast<VecIndex*>(h);
  FILE* f = std::fopen(path, "wb");
  if (!f) return 0;
  int64_t n = (int64_t)ix->size();
  int cosine = ix->cosine ? 1 : 0;
  std::fwrite(&ix->dim, sizeof(int), 1, f);
  std::fwrite(&cosine, sizeof(int), 1, f);
  std::fwrite(&n, sizeof(int64_t), 1, f);
  std::fwrite(ix->ids.data(), sizeof(int64_t), n, f);
  std::fwrite(ix->data.data(), sizeof(float), n * ix->dim, f);
  std::fclose(f);
  return 1;
}

void* vecindex_load(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  int dim = 0, cosine = 1;
  int64_t n = 0;
  if (std::fread(&dim, sizeof(int), 1, f) != 1) { std::fclose(f); return nullptr; }
  if (std::fread(&cosine, sizeof(int), 1, f) != 1) { std::fclose(f); return nullptr; }
  if (std::fread(&n, sizeof(int64_t), 1, f) != 1) { std::fclose(f); return nullptr; }
  auto* ix = new VecIndex();
  ix->dim = dim;
  ix->cosine = cosine != 0;
  ix->ids.resize(n);
  ix->data.resize(n * dim);
  if (std::fread(ix->ids.data(), sizeof(int64_t), n, f) != (size_t)n ||
      std::fread(ix->data.data(), sizeof(float), n * dim, f) != (size_t)(n * dim)) {
    std::fclose(f);
    delete ix;
    return nullptr;
  }
  std::fclose(f);
  for (size_t r = 0; r < (size_t)n; ++r) ix->id_to_row[ix->ids[r]] = r;
  return ix;
}

}  // extern "C"
