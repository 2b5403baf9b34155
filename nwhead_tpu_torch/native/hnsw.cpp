// HNSW approximate nearest-neighbour index (first-party C++), the port's
// own copy of the JAX package's source, code unchanged, so that both build
// the same graph from the same rows, seed and insertion order.
//
// The reference's third-party hnswlib (nwhead/utils.py:195-216) replaced by
// an L2-space hierarchical navigable small-world graph (Malkov & Yashunin,
// 2016). The graph search is pointer-chasing host work; the neighbour ids
// it returns index the bank on the GPU, where the NW head runs. Defaults
// mirror the reference: ef_construction=100, M=16.
//
// C ABI (ctypes, bound by native/hnsw.py):
//   hnsw_create(dim, max_elements, M, ef_construction, seed) -> handle
//   hnsw_add_items(handle, data, n, dim)   // sequential inserts, row-major f32
//   hnsw_search(handle, queries, nq, dim, k, ef, out_ids)  // int64 ids
//   hnsw_size(handle)
//   hnsw_free(handle)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <random>
#include <unordered_set>
#include <vector>

namespace {

struct Neighbor {
  float dist;
  int32_t id;
};

struct FurthestFirst {
  bool operator()(const Neighbor& a, const Neighbor& b) const {
    return a.dist < b.dist;  // max-heap on distance
  }
};
struct ClosestFirst {
  bool operator()(const Neighbor& a, const Neighbor& b) const {
    return a.dist > b.dist;  // min-heap on distance
  }
};

class HnswIndex {
 public:
  HnswIndex(int dim, int max_elements, int M, int ef_construction,
            unsigned seed)
      : dim_(dim),
        max_elements_(max_elements),
        M_(M),
        M0_(2 * M),
        ef_construction_(ef_construction),
        inv_log_M_(1.0 / std::log(static_cast<double>(M))),
        rng_(seed),
        entry_(-1),
        top_level_(-1) {
    data_.reserve(static_cast<size_t>(max_elements) * dim);
    levels_.reserve(max_elements);
    links_.reserve(max_elements);
  }

  int size() const { return static_cast<int>(levels_.size()); }

  void add(const float* vec) {
    const int32_t id = size();
    data_.insert(data_.end(), vec, vec + dim_);
    const int level = random_level();
    levels_.push_back(level);
    links_.emplace_back(level + 1);
    for (int l = 0; l <= level; ++l) {
      links_[id][l].reserve(l == 0 ? M0_ : M_);
    }

    if (entry_ < 0) {
      entry_ = id;
      top_level_ = level;
      return;
    }

    int32_t cur = entry_;
    // Greedy descent through levels above the new node's level.
    for (int l = top_level_; l > level; --l) cur = greedy_closest(vec, cur, l);

    // Insert at each level from min(level, top_level_) down to 0.
    for (int l = std::min(level, top_level_); l >= 0; --l) {
      auto cands = search_layer(vec, cur, ef_construction_, l);
      const int max_links = (l == 0) ? M0_ : M_;
      auto selected = select_neighbors(cands, M_);
      for (const auto& nb : selected) {
        link(id, nb.id, l, max_links);
        link(nb.id, id, l, max_links);
      }
      // Continue the descent from the closest candidate (selection may
      // have dropped it for diversity).
      if (!cands.empty()) cur = cands.front().id;
    }
    if (level > top_level_) {
      top_level_ = level;
      entry_ = id;
    }
  }

  void search(const float* query, int k, int ef, int64_t* out) const {
    if (entry_ < 0) {
      for (int i = 0; i < k; ++i) out[i] = -1;
      return;
    }
    int32_t cur = entry_;
    for (int l = top_level_; l > 0; --l) cur = greedy_closest(query, cur, l);
    auto cands =
        search_layer(query, cur, std::max(ef, k), 0);  // closest-first order
    std::sort(cands.begin(), cands.end(),
              [](const Neighbor& a, const Neighbor& b) {
                return a.dist < b.dist;
              });
    for (int i = 0; i < k; ++i) {
      out[i] = (i < static_cast<int>(cands.size())) ? cands[i].id : -1;
    }
  }

 private:
  float l2(const float* a, const float* b) const {
    float acc = 0.f;
    for (int i = 0; i < dim_; ++i) {
      const float d = a[i] - b[i];
      acc += d * d;
    }
    return acc;
  }
  const float* vec(int32_t id) const {
    return data_.data() + static_cast<size_t>(id) * dim_;
  }

  int random_level() {
    std::uniform_real_distribution<double> u(0.0, 1.0);
    double r = u(rng_);
    if (r <= 0.0) r = std::numeric_limits<double>::min();
    return static_cast<int>(-std::log(r) * inv_log_M_);
  }

  int32_t greedy_closest(const float* q, int32_t start, int level) const {
    int32_t cur = start;
    float cur_d = l2(q, vec(cur));
    bool improved = true;
    while (improved) {
      improved = false;
      for (int32_t nb : links_[cur][level]) {
        const float d = l2(q, vec(nb));
        if (d < cur_d) {
          cur_d = d;
          cur = nb;
          improved = true;
        }
      }
    }
    return cur;
  }

  // Beam search at one level; returns up to ef closest candidates.
  std::vector<Neighbor> search_layer(const float* q, int32_t start, int ef,
                                     int level) const {
    std::priority_queue<Neighbor, std::vector<Neighbor>, ClosestFirst>
        candidates;
    std::priority_queue<Neighbor, std::vector<Neighbor>, FurthestFirst> best;
    std::unordered_set<int32_t> visited;

    const float d0 = l2(q, vec(start));
    candidates.push({d0, start});
    best.push({d0, start});
    visited.insert(start);

    while (!candidates.empty()) {
      const Neighbor c = candidates.top();
      if (c.dist > best.top().dist &&
          static_cast<int>(best.size()) >= ef)
        break;
      candidates.pop();
      if (level >= static_cast<int>(links_[c.id].size())) continue;
      for (int32_t nb : links_[c.id][level]) {
        if (!visited.insert(nb).second) continue;
        const float d = l2(q, vec(nb));
        if (static_cast<int>(best.size()) < ef || d < best.top().dist) {
          candidates.push({d, nb});
          best.push({d, nb});
          if (static_cast<int>(best.size()) > ef) best.pop();
        }
      }
    }
    std::vector<Neighbor> out;
    out.reserve(best.size());
    while (!best.empty()) {
      out.push_back(best.top());
      best.pop();
    }
    std::reverse(out.begin(), out.end());  // closest first
    return out;
  }

  // hnswlib's neighbor-selection heuristic (HNSW paper Algorithm 4 /
  // hnswlib getNeighborsByHeuristic2): walk candidates closest-first and
  // keep one only if it is closer to the query than to every neighbor
  // already kept — spreads links across clusters, which preserves graph
  // navigability (and recall) on clustered banks where plain closest-m
  // links collapse into one cluster.
  std::vector<Neighbor> select_neighbors(std::vector<Neighbor> cands,
                                         int m) const {
    std::sort(cands.begin(), cands.end(),
              [](const Neighbor& a, const Neighbor& b) {
                return a.dist < b.dist;
              });
    if (static_cast<int>(cands.size()) <= m) return cands;
    std::vector<Neighbor> result;
    result.reserve(m);
    for (const Neighbor& c : cands) {
      if (static_cast<int>(result.size()) >= m) break;
      bool good = true;
      for (const Neighbor& r : result) {
        if (l2(vec(c.id), vec(r.id)) < c.dist) {
          good = false;
          break;
        }
      }
      if (good) result.push_back(c);
    }
    return result;
  }

  void link(int32_t from, int32_t to, int level, int max_links) {
    if (from == to) return;
    auto& lst = links_[from][level];
    for (int32_t existing : lst)
      if (existing == to) return;
    if (static_cast<int>(lst.size()) < max_links) {
      lst.push_back(to);
      return;
    }
    // Prune with the same diversification heuristic over {existing + new}
    // (hnswlib mutuallyConnectNewElement overflow path).
    const float* fv = vec(from);
    std::vector<Neighbor> cands;
    cands.reserve(lst.size() + 1);
    for (int32_t nb : lst) cands.push_back({l2(fv, vec(nb)), nb});
    cands.push_back({l2(fv, vec(to)), to});
    auto selected = select_neighbors(std::move(cands), max_links);
    lst.clear();
    for (const Neighbor& nb : selected) lst.push_back(nb.id);
  }

  const int dim_;
  const int max_elements_;
  const int M_, M0_, ef_construction_;
  const double inv_log_M_;
  std::mt19937 rng_;

  std::vector<float> data_;
  std::vector<int> levels_;
  // links_[id][level] -> neighbor ids
  std::vector<std::vector<std::vector<int32_t>>> links_;
  int32_t entry_;
  int top_level_;
};

}  // namespace

extern "C" {

void* hnsw_create(int dim, int max_elements, int M, int ef_construction,
                  unsigned seed) {
  return new HnswIndex(dim, max_elements, M, ef_construction, seed);
}

void hnsw_add_items(void* handle, const float* data, int n, int dim) {
  auto* idx = static_cast<HnswIndex*>(handle);
  for (int i = 0; i < n; ++i) idx->add(data + static_cast<size_t>(i) * dim);
}

void hnsw_search(void* handle, const float* queries, int nq, int dim, int k,
                 int ef, int64_t* out_ids) {
  auto* idx = static_cast<HnswIndex*>(handle);
  for (int i = 0; i < nq; ++i) {
    idx->search(queries + static_cast<size_t>(i) * dim, k, ef,
                out_ids + static_cast<size_t>(i) * k);
  }
}

int hnsw_size(void* handle) { return static_cast<HnswIndex*>(handle)->size(); }

void hnsw_free(void* handle) { delete static_cast<HnswIndex*>(handle); }

}  // extern "C"
