// hnsw.cc — hierarchical NSW graph of the HNSW index family, the port's own
// copy of the JAX package's native/hnsw/hnsw.cc (same code, so both packages
// build the same graph from the same rows and seed; reference:
// src/vector/vector_index_hnsw.{h,cc} wraps the vendored hnswlib fork).
//
// Division of labor (BASELINE config 4): the host graph handles writes and
// the host search arm; the card re-ranks its candidate set with exact
// batched distances, and walks the exported level-0 adjacency itself on
// the device arm (dingo_tpu_torch/index/hnsw.py, ops/beam.py).
//
// Build: g++ -O3 -std=c++17 -fPIC -shared -march=native hnsw.cc
// (dingo_tpu_torch/native/__init__.py does it at first use; auto-vectorized
// scalar loops, no hand intrinsics).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <unordered_map>
#include <vector>

namespace {

struct Hnsw {
  int dim = 0;
  int metric = 0;  // 0 = L2, 1 = IP (cosine handled by normalized input)
  int M = 16;
  int M0 = 32;  // layer-0 degree cap (2*M, hnsw convention)
  int ef_construction = 200;
  double level_mult = 1.0;
  std::mt19937_64 rng{0x5eed};

  // node storage
  std::vector<float> vecs;                    // [n, dim]
  std::vector<int64_t> labels;                // external ids
  std::vector<uint8_t> deleted;               // tombstones
  std::vector<int> levels;                    // top layer per node
  // links[l] is a flat array: node i's neighbors at slot i*cap .. with count
  std::vector<std::vector<int>> links;        // per layer: [n * cap_l]
  std::vector<std::vector<int>> link_count;   // per layer: [n]
  std::unordered_map<int64_t, int> label_to_node;
  int entry = -1;
  int max_level = -1;
  // Bumped whenever the adjacency STRUCTURE can have changed (new node
  // inserted, snapshot loaded). In-place vector replacement and tombstone
  // deletes keep the links untouched and do NOT bump it — the Python side
  // keys its device adjacency mirror on (graph_version, store version).
  int64_t graph_version = 0;
  std::mutex mu;

  int cap(int level) const { return level == 0 ? M0 : M; }

  float dist(const float* a, const float* b) const {
    float acc = 0.f;
    if (metric == 0) {
      for (int i = 0; i < dim; ++i) {
        float t = a[i] - b[i];
        acc += t * t;
      }
      return acc;
    }
    for (int i = 0; i < dim; ++i) acc += a[i] * b[i];
    return -acc;  // smaller-is-better internally
  }

  const float* vec(int node) const { return vecs.data() + (size_t)node * dim; }

  int random_level() {
    std::uniform_real_distribution<double> u(0.0, 1.0);
    double r = u(rng);
    int lvl = (int)(-std::log(std::max(r, 1e-12)) * level_mult);
    return std::min(lvl, 32);
  }

  void ensure_layer(int level) {
    while ((int)links.size() <= level) {
      links.emplace_back();
      link_count.emplace_back();
    }
    // Every layer indexes by node id, so all layers grow with node count.
    size_t n = labels.size();
    for (size_t l = 0; l < links.size(); ++l) {
      links[l].resize(n * (size_t)cap((int)l), -1);
      link_count[l].resize(n, 0);
    }
  }

  // Greedy single-entry descent at `level`.
  int greedy(int start, const float* q, int level) const {
    int cur = start;
    float cd = dist(q, vec(cur));
    bool improved = true;
    while (improved) {
      improved = false;
      const int c = cap(level);
      const int* nb = links[level].data() + (size_t)cur * c;
      int cnt = link_count[level][cur];
      for (int j = 0; j < cnt; ++j) {
        int nx = nb[j];
        if (nx < 0) continue;
        float nd = dist(q, vec(nx));
        if (nd < cd) {
          cd = nd;
          cur = nx;
          improved = true;
        }
      }
    }
    return cur;
  }

  // Beam search at one layer; returns up to ef (dist, node) pairs sorted asc.
  std::vector<std::pair<float, int>> beam(int start, const float* q, int ef,
                                          int level,
                                          bool skip_deleted) const {
    // max-heap for results (worst on top), min-heap for frontier
    std::priority_queue<std::pair<float, int>> results;
    std::priority_queue<std::pair<float, int>,
                        std::vector<std::pair<float, int>>,
                        std::greater<>> frontier;
    std::vector<uint8_t> visited(labels.size(), 0);
    float sd = dist(q, vec(start));
    frontier.emplace(sd, start);
    visited[start] = 1;
    if (!skip_deleted || !deleted[start]) results.emplace(sd, start);
    while (!frontier.empty()) {
      auto [cd, cur] = frontier.top();
      if (!results.empty() && (int)results.size() >= ef &&
          cd > results.top().first)
        break;
      frontier.pop();
      const int c = cap(level);
      const int* nb = links[level].data() + (size_t)cur * c;
      int cnt = link_count[level][cur];
      for (int j = 0; j < cnt; ++j) {
        int nx = nb[j];
        if (nx < 0 || visited[nx]) continue;
        visited[nx] = 1;
        float nd = dist(q, vec(nx));
        if ((int)results.size() < ef ||
            nd < results.top().first) {
          frontier.emplace(nd, nx);
          if (!skip_deleted || !deleted[nx]) {
            results.emplace(nd, nx);
            if ((int)results.size() > ef) results.pop();
          }
        }
      }
    }
    std::vector<std::pair<float, int>> out(results.size());
    for (int i = (int)results.size() - 1; i >= 0; --i) {
      out[i] = results.top();
      results.pop();
    }
    return out;
  }

  // Heuristic neighbor selection (keep candidates not dominated by chosen).
  std::vector<int> select(const std::vector<std::pair<float, int>>& cand,
                          int maxn) const {
    std::vector<int> chosen;
    for (const auto& [cd, node] : cand) {
      if ((int)chosen.size() >= maxn) break;
      bool ok = true;
      for (int s : chosen) {
        if (dist(vec(node), vec(s)) < cd) {
          ok = false;
          break;
        }
      }
      if (ok) chosen.push_back(node);
    }
    // backfill with nearest remaining if pruning was too aggressive
    if ((int)chosen.size() < maxn) {
      for (const auto& [cd, node] : cand) {
        if ((int)chosen.size() >= maxn) break;
        if (std::find(chosen.begin(), chosen.end(), node) == chosen.end())
          chosen.push_back(node);
      }
    }
    return chosen;
  }

  void connect(int a, int b, int level) {
    const int c = cap(level);
    int* nb = links[level].data() + (size_t)a * c;
    int& cnt = link_count[level][a];
    if (cnt < c) {
      nb[cnt++] = b;
      return;
    }
    // full: re-select among existing + new
    std::vector<std::pair<float, int>> cand;
    cand.reserve(c + 1);
    cand.emplace_back(dist(vec(a), vec(b)), b);
    for (int j = 0; j < cnt; ++j)
      cand.emplace_back(dist(vec(a), vec(nb[j])), nb[j]);
    std::sort(cand.begin(), cand.end());
    auto chosen = select(cand, c);
    cnt = (int)chosen.size();
    for (int j = 0; j < cnt; ++j) nb[j] = chosen[j];
    for (int j = cnt; j < c; ++j) nb[j] = -1;
  }

  int add_one(int64_t label, const float* v) {
    auto it = label_to_node.find(label);
    if (it != label_to_node.end()) {
      // upsert: replace vector in place (links stay; graph quality degrades
      // slightly, matching hnswlib's updatePoint approximation)
      std::memcpy(vecs.data() + (size_t)it->second * dim, v,
                  sizeof(float) * dim);
      deleted[it->second] = 0;
      return it->second;
    }
    int node = (int)labels.size();
    ++graph_version;
    labels.push_back(label);
    deleted.push_back(0);
    vecs.insert(vecs.end(), v, v + dim);
    int lvl = random_level();
    levels.push_back(lvl);
    ensure_layer(std::max(lvl, std::max(max_level, 0)));
    label_to_node.emplace(label, node);

    if (entry < 0) {
      entry = node;
      max_level = lvl;
      return node;
    }
    int cur = entry;
    for (int l = max_level; l > lvl; --l) cur = greedy(cur, v, l);
    for (int l = std::min(lvl, max_level); l >= 0; --l) {
      auto cand = beam(cur, v, ef_construction, l, /*skip_deleted=*/false);
      auto neighbors = select(cand, cap(l));
      for (int nb : neighbors) {
        connect(node, nb, l);
        connect(nb, node, l);
      }
      if (!cand.empty()) cur = cand.front().second;
    }
    if (lvl > max_level) {
      max_level = lvl;
      entry = node;
    }
    return node;
  }

  void search_one(const float* q, int k, int ef, int64_t* out_labels,
                  float* out_d) const {
    if (entry < 0) {
      for (int i = 0; i < k; ++i) {
        out_labels[i] = -1;
        out_d[i] = INFINITY;
      }
      return;
    }
    int cur = entry;
    for (int l = max_level; l > 0; --l) cur = greedy(cur, q, l);
    auto cand = beam(cur, q, std::max(ef, k), 0, /*skip_deleted=*/true);
    int i = 0;
    for (; i < k && i < (int)cand.size(); ++i) {
      out_labels[i] = labels[cand[i].second];
      out_d[i] = metric == 0 ? cand[i].first : -cand[i].first;
    }
    for (; i < k; ++i) {
      out_labels[i] = -1;
      out_d[i] = INFINITY;
    }
  }
};

}  // namespace

extern "C" {

void* hnsw_new(int dim, int metric, int M, int ef_construction,
               uint64_t seed) {
  auto* h = new Hnsw();
  h->dim = dim;
  h->metric = metric;
  h->M = M;
  h->M0 = 2 * M;
  h->ef_construction = ef_construction;
  h->level_mult = 1.0 / std::log(std::max(2.0, (double)M));
  h->rng.seed(seed);
  return h;
}

void hnsw_free(void* p) { delete (Hnsw*)p; }

void hnsw_add(void* p, int n, const int64_t* labels, const float* vecs) {
  auto* h = (Hnsw*)p;
  std::lock_guard<std::mutex> g(h->mu);
  for (int i = 0; i < n; ++i)
    h->add_one(labels[i], vecs + (size_t)i * h->dim);
}

int hnsw_delete(void* p, int n, const int64_t* labels) {
  auto* h = (Hnsw*)p;
  std::lock_guard<std::mutex> g(h->mu);
  int removed = 0;
  for (int i = 0; i < n; ++i) {
    auto it = h->label_to_node.find(labels[i]);
    if (it != h->label_to_node.end() && !h->deleted[it->second]) {
      h->deleted[it->second] = 1;
      ++removed;
    }
  }
  return removed;
}

void hnsw_search(void* p, int nq, const float* queries, int k, int ef,
                 int64_t* out_labels, float* out_d) {
  auto* h = (Hnsw*)p;
  for (int i = 0; i < nq; ++i)
    h->search_one(queries + (size_t)i * h->dim, k, ef,
                  out_labels + (size_t)i * k, out_d + (size_t)i * k);
}

int64_t hnsw_count(void* p) {
  auto* h = (Hnsw*)p;
  int64_t live = 0;
  for (size_t i = 0; i < h->labels.size(); ++i)
    if (!h->deleted[i]) ++live;
  return live;
}

int64_t hnsw_deleted_count(void* p) {
  auto* h = (Hnsw*)p;
  return (int64_t)h->labels.size() - hnsw_count(p);
}

int64_t hnsw_memory(void* p) {
  auto* h = (Hnsw*)p;
  int64_t m = (int64_t)h->vecs.capacity() * 4 + h->labels.capacity() * 8;
  for (auto& l : h->links) m += (int64_t)l.capacity() * 4;
  return m;
}

// Serialization: simple versioned binary blob.
int64_t hnsw_save_size(void* p) {
  auto* h = (Hnsw*)p;
  int64_t sz = 8 * 8;  // header
  size_t n = h->labels.size();
  sz += (int64_t)n * (h->dim * 4 + 8 + 1 + 4);
  for (size_t l = 0; l < h->links.size(); ++l)
    sz += 8 + (int64_t)h->links[l].size() * 4 + (int64_t)n * 4;
  return sz;
}

int64_t hnsw_save(void* p, uint8_t* buf) {
  auto* h = (Hnsw*)p;
  uint8_t* w = buf;
  auto w64 = [&](int64_t v) { std::memcpy(w, &v, 8); w += 8; };
  w64(1);  // version
  w64(h->dim);
  w64(h->metric);
  w64(h->M);
  w64(h->ef_construction);
  w64((int64_t)h->labels.size());
  w64(h->entry);
  w64(h->max_level);
  size_t n = h->labels.size();
  std::memcpy(w, h->vecs.data(), n * h->dim * 4);
  w += n * h->dim * 4;
  std::memcpy(w, h->labels.data(), n * 8);
  w += n * 8;
  std::memcpy(w, h->deleted.data(), n);
  w += n;
  std::memcpy(w, h->levels.data(), n * 4);
  w += n * 4;
  for (size_t l = 0; l < h->links.size(); ++l) {
    w64((int64_t)h->links[l].size());
    std::memcpy(w, h->links[l].data(), h->links[l].size() * 4);
    w += h->links[l].size() * 4;
    std::memcpy(w, h->link_count[l].data(), n * 4);
    w += n * 4;
  }
  return w - buf;
}

void* hnsw_load(const uint8_t* buf, int64_t len) {
  const uint8_t* r = buf;
  auto r64 = [&]() { int64_t v; std::memcpy(&v, r, 8); r += 8; return v; };
  int64_t version = r64();
  if (version != 1) return nullptr;
  auto* h = new Hnsw();
  h->dim = (int)r64();
  h->metric = (int)r64();
  h->M = (int)r64();
  h->M0 = 2 * h->M;
  h->ef_construction = (int)r64();
  h->level_mult = 1.0 / std::log(std::max(2.0, (double)h->M));
  size_t n = (size_t)r64();
  h->entry = (int)r64();
  h->max_level = (int)r64();
  h->vecs.resize(n * h->dim);
  std::memcpy(h->vecs.data(), r, n * h->dim * 4);
  r += n * h->dim * 4;
  h->labels.resize(n);
  std::memcpy(h->labels.data(), r, n * 8);
  r += n * 8;
  h->deleted.resize(n);
  std::memcpy(h->deleted.data(), r, n);
  r += n;
  h->levels.resize(n);
  std::memcpy(h->levels.data(), r, n * 4);
  r += n * 4;
  while (r < buf + len) {
    int64_t sz = r64();
    h->links.emplace_back(sz);
    std::memcpy(h->links.back().data(), r, sz * 4);
    r += sz * 4;
    h->link_count.emplace_back(n);
    std::memcpy(h->link_count.back().data(), r, n * 4);
    r += n * 4;
  }
  for (size_t i = 0; i < n; ++i)
    h->label_to_node.emplace(h->labels[i], (int)i);
  h->graph_version = (int64_t)n;
  return h;
}

// ---- device-graph export: flattened level-0 adjacency ----------------------
// The device beam walk reads a dense fixed-degree [n, deg] int array; these
// hooks hand the Python side the level-0 neighbor lists (node indices,
// -1 padded) plus the labels needed to remap node space -> slot space.

int64_t hnsw_total_count(void* p) {
  // total nodes INCLUDING tombstones (adjacency indexes by node id)
  auto* h = (Hnsw*)p;
  return (int64_t)h->labels.size();
}

int64_t hnsw_graph_version(void* p) {
  auto* h = (Hnsw*)p;
  return h->graph_version;
}

int64_t hnsw_entry_label(void* p) {
  auto* h = (Hnsw*)p;
  return h->entry >= 0 ? h->labels[h->entry] : -1;
}

void hnsw_export_level0(void* p, int64_t max_nodes, int deg_cap,
                        int64_t* out_labels, int32_t* out_adj) {
  auto* h = (Hnsw*)p;
  std::lock_guard<std::mutex> g(h->mu);
  // Clamp to the CALLER'S buffer capacity: the caller sized its arrays
  // from an earlier hnsw_total_count() read, and a concurrent insert may
  // have grown labels since — writing labels.size() entries would
  // overflow the caller's heap. A clamped (stale) export is fine: the
  // caller keys its mirror on graph_version and re-exports next search.
  size_t n = std::min(h->labels.size(), (size_t)std::max<int64_t>(0, max_nodes));
  if (n == 0) return;
  std::memcpy(out_labels, h->labels.data(), n * sizeof(int64_t));
  std::fill(out_adj, out_adj + n * (size_t)deg_cap, -1);
  if (h->links.empty()) return;
  const int c = h->cap(0);
  const int take = std::min(deg_cap, c);
  for (size_t i = 0; i < n; ++i) {
    int cnt = std::min(h->link_count[0][i], take);
    const int* nb = h->links[0].data() + i * (size_t)c;
    for (int j = 0; j < cnt; ++j)
      // neighbors past the clamp (concurrently inserted nodes wired
      // into existing lists) have no label in the caller's view: pad
      out_adj[i * (size_t)deg_cap + j] = nb[j] < (int64_t)n ? nb[j] : -1;
  }
}

}  // extern "C"
