// Native ego-batch sampler of the PyTorch port (taxoexpan_torch).
//
// The port's own copy of taxoexpan_tpu/native/sampler.cpp, with the same
// logic, so one seed gives the same batches in both packages. It replaces
// the reference's host-side sampling pipeline: 8-20 torch DataLoader worker
// processes each running the Python egonet builder
// (data_loader/dataset.py:290-437, data_loaders.py:98). Here the whole
// per-batch hot path (negative-queue sampling with mask rejection, star
// egonet construction: grandparents + anchor + sampled siblings,
// negative-egonet caching, and the padded slot-array fill) runs in one C++
// call writing directly into caller-owned numpy buffers. The call holds no
// Python lock (ctypes.CDLL releases the GIL), so the loader's producer
// thread builds batches while the main thread queues the card's kernels.
//
// Semantics mirror MaskedGraphDataset:
// - negative queue = train_ids x 5, shuffled at wrap, walking pointer
//   (dataset.py:277-279,334-381): "exactly k" with refill for training mode.
// - masks[query] = positions unusable as negatives (descendants + parents +
//   self + roots, dataset.py:247-259), passed in as per-query sorted CSR.
// - egonets: all grandparents (capped), anchor, <=expand_factor children
//   sampled WITH replacement when over-full (random.choices,
//   dataset.py:416-424); positive egonets drop the query from the siblings.
// - negative egonets cached per anchor, refreshed after cache_refresh_time
//   reuses; positives never cached (dataset.py:383-402).
//
// C ABI only (loaded via ctypes); 32-bit node ids, 64-bit indptr.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <random>
#include <unordered_map>
#include <vector>

namespace {

struct Csr {
  const int64_t* indptr;
  const int32_t* indices;
  int64_t n;
  inline const int32_t* begin(int32_t u) const { return indices + indptr[u]; }
  inline int64_t deg(int32_t u) const { return indptr[u + 1] - indptr[u]; }
};

struct CachedEgo {
  std::vector<int32_t> gps;
  std::vector<int32_t> sibs;
  int32_t uses = 0;
};

struct Sampler {
  Csr children;
  Csr parents;
  // masks per query: sorted position lists, CSR over a query->row mapping
  std::vector<int64_t> mask_indptr;
  std::vector<int32_t> mask_indices;
  std::unordered_map<int32_t, int32_t> query_row;

  std::vector<int32_t> queue;
  int64_t pointer = 0;
  std::unordered_map<int32_t, CachedEgo> cache;
  std::unordered_map<int32_t, int32_t> positive_ptr;
  int32_t cache_refresh_time = 128;
  std::mt19937_64 rng;

  bool masked(int32_t query, int32_t pos) const {
    auto it = query_row.find(query);
    if (it == query_row.end()) return false;
    const int32_t* lo = mask_indices.data() + mask_indptr[it->second];
    const int32_t* hi = mask_indices.data() + mask_indptr[it->second + 1];
    return std::binary_search(lo, hi, pos);
  }
};

}  // namespace

extern "C" {

void* te_sampler_create(const int64_t* child_indptr, const int32_t* child_idx,
                        const int64_t* parent_indptr, const int32_t* parent_idx,
                        int64_t num_nodes, const int32_t* train_ids,
                        int64_t num_train, int32_t cache_refresh_time,
                        uint64_t seed) {
  auto* s = new Sampler();
  s->children = {child_indptr, child_idx, num_nodes};
  s->parents = {parent_indptr, parent_idx, num_nodes};
  s->queue.reserve(num_train * 5);
  for (int r = 0; r < 5; ++r)
    s->queue.insert(s->queue.end(), train_ids, train_ids + num_train);
  s->cache_refresh_time = cache_refresh_time;
  s->rng.seed(seed);
  return s;
}

void te_sampler_set_masks(void* handle, const int32_t* query_ids,
                          int64_t num_queries, const int64_t* indptr,
                          const int32_t* indices) {
  auto* s = static_cast<Sampler*>(handle);
  s->mask_indptr.assign(indptr, indptr + num_queries + 1);
  s->mask_indices.assign(indices, indices + indptr[num_queries]);
  s->query_row.clear();
  for (int64_t i = 0; i < num_queries; ++i)
    s->query_row[query_ids[i]] = static_cast<int32_t>(i);
}

void te_sampler_destroy(void* handle) { delete static_cast<Sampler*>(handle); }

namespace {

// exactly-k negatives via the queue walk (dataset.py:357-381)
void sample_negatives(Sampler* s, int32_t query, int32_t k,
                      std::vector<int32_t>* out) {
  out->clear();
  if (s->pointer == 0)
    std::shuffle(s->queue.begin(), s->queue.end(), s->rng);
  int tries = 0;
  while (static_cast<int32_t>(out->size()) != k) {
    int64_t lack = k - static_cast<int64_t>(out->size());
    int64_t end = std::min<int64_t>(s->pointer + lack,
                                    static_cast<int64_t>(s->queue.size()));
    for (int64_t i = s->pointer; i < end; ++i) {
      int32_t cand = s->queue[i];
      if (!s->masked(query, cand)) out->push_back(cand);
    }
    s->pointer = end;
    if (s->pointer >= static_cast<int64_t>(s->queue.size())) {
      s->pointer = 0;
      std::shuffle(s->queue.begin(), s->queue.end(), s->rng);
    }
    if (++tries > 10) {  // corner case: trim/fill like the reference
      while (static_cast<int32_t>(out->size()) < k)
        out->push_back(s->queue[out->size() % s->queue.size()]);
      out->resize(k);
      break;
    }
  }
}

// star egonet of `anchor` (dataset.py:404-437); query < 0 -> no exclusion
void build_egonet(Sampler* s, int32_t query, int32_t anchor, bool positive,
                  int32_t max_parents, int32_t expand_factor,
                  std::vector<int32_t>* gps, std::vector<int32_t>* sibs) {
  gps->clear();
  sibs->clear();
  int64_t ndeg = s->parents.deg(anchor);
  int64_t ng = std::min<int64_t>(ndeg, max_parents);
  gps->insert(gps->end(), s->parents.begin(anchor),
              s->parents.begin(anchor) + ng);
  int64_t cdeg = s->children.deg(anchor);
  const int32_t* ch = s->children.begin(anchor);
  if (cdeg <= expand_factor) {
    for (int64_t i = 0; i < cdeg; ++i) {
      if (positive && ch[i] == query) continue;
      sibs->push_back(ch[i]);
    }
  } else {
    std::uniform_int_distribution<int64_t> pick(0, cdeg - 1);
    for (int32_t i = 0; i < expand_factor; ++i) {  // with replacement
      int32_t c = ch[pick(s->rng)];
      if (positive && c == query) continue;
      sibs->push_back(c);
    }
  }
}

void emit(const std::vector<int32_t>& gps, int32_t anchor,
          const std::vector<int32_t>& sibs, int32_t max_parents,
          int32_t expand_factor, int32_t* node_ids_row, int32_t* ngp,
          int32_t* nsib) {
  int32_t n = max_parents + 1 + expand_factor;
  std::memset(node_ids_row, 0, sizeof(int32_t) * n);
  int32_t g = std::min<int32_t>(gps.size(), max_parents);
  for (int32_t i = 0; i < g; ++i) node_ids_row[i] = gps[i];
  node_ids_row[max_parents] = anchor;
  int32_t sc = std::min<int32_t>(sibs.size(), expand_factor);
  for (int32_t i = 0; i < sc; ++i) node_ids_row[max_parents + 1 + i] = sibs[i];
  *ngp = g;
  *nsib = sc;
}

}  // namespace

// Sample a full training GroupBatch (sampling_mode 1): for each query, one
// positive (round-robin over parents) in column 0 + negative_size negatives.
// Outputs: node_ids [G*C, N] int32, ngp/nsib [G*C] int32,
//          labels/cand_mask [G*C] float32/uint8 laid out row-major [G, C].
// Returns 0 on success.
int32_t te_sample_train_batch(void* handle, const int32_t* query_ids,
                              int32_t num_queries, int32_t negative_size,
                              int32_t expand_factor, int32_t max_parents,
                              int32_t* node_ids, int32_t* ngp, int32_t* nsib,
                              float* labels, uint8_t* cand_mask) {
  auto* s = static_cast<Sampler*>(handle);
  const int32_t c = 1 + negative_size;
  const int32_t n = max_parents + 1 + expand_factor;
  std::vector<int32_t> negs, gps, sibs;
  for (int32_t q = 0; q < num_queries; ++q) {
    int32_t query = query_ids[q];
    // positive: round-robin over true parents (dataset.py:308-313)
    int64_t pdeg = s->parents.deg(query);
    if (pdeg == 0) return -1;  // roots are never queries
    int32_t& pp = s->positive_ptr[query];
    int32_t parent = s->parents.begin(query)[pp % pdeg];
    pp = static_cast<int32_t>((pp + 1) % pdeg);
    build_egonet(s, query, parent, /*positive=*/true, max_parents,
                 expand_factor, &gps, &sibs);
    int64_t row = static_cast<int64_t>(q) * c;
    emit(gps, parent, sibs, max_parents, expand_factor,
         node_ids + row * n, ngp + row, nsib + row);
    labels[row] = 1.0f;
    cand_mask[row] = 1;

    sample_negatives(s, query, negative_size, &negs);
    for (int32_t j = 0; j < negative_size; ++j) {
      int32_t anchor = negs[j];
      int64_t r = row + 1 + j;
      auto it = s->cache.find(anchor);
      if (it != s->cache.end() && it->second.uses < s->cache_refresh_time) {
        ++it->second.uses;
        emit(it->second.gps, anchor, it->second.sibs, max_parents,
             expand_factor, node_ids + r * n, ngp + r, nsib + r);
      } else {
        build_egonet(s, query, anchor, /*positive=*/false, max_parents,
                     expand_factor, &gps, &sibs);
        CachedEgo& ce = s->cache[anchor];
        ce.gps = gps;
        ce.sibs = sibs;
        ce.uses = 0;
        emit(gps, anchor, sibs, max_parents, expand_factor, node_ids + r * n,
             ngp + r, nsib + r);
      }
      labels[r] = 0.0f;
      cand_mask[r] = 1;
    }
  }
  return 0;
}

namespace {

// at-most-k negatives: one k-wide queue window filtered by masks; advance
// (with wrap + reshuffle) until the window yields anything
// (dataset.py:340-355 — the validation-layout counterpart of the exactly-k
// walk above)
void sample_at_most_k(Sampler* s, int32_t query, int32_t k,
                      std::vector<int32_t>* out) {
  if (s->pointer == 0)
    std::shuffle(s->queue.begin(), s->queue.end(), s->rng);
  const int64_t qsize = static_cast<int64_t>(s->queue.size());
  while (true) {
    out->clear();
    int64_t end = std::min<int64_t>(s->pointer + k, qsize);
    for (int64_t i = s->pointer; i < end; ++i) {
      int32_t cand = s->queue[i];
      if (!s->masked(query, cand)) out->push_back(cand);
    }
    if (!out->empty()) break;
    s->pointer += k;
    if (s->pointer >= qsize) {
      s->pointer = 0;
      std::shuffle(s->queue.begin(), s->queue.end(), s->rng);
    }
  }
  s->pointer += k;
  if (s->pointer >= qsize) s->pointer = 0;
}

}  // namespace

// Sample a full validation GroupBatch (sampling_mode 0): for each query, one
// positive egonet per TRUE PARENT in the leading columns (labels 1), then
// at-most-negative_size negatives (labels 0); unused columns stay empty
// (cand_mask 0) — the layout of data/loader.py:_build_batch for
// mode 0 / dataset.py:304-307,340-355. C = max_pos + negative_size.
// parent_list/parent_counts carry each query's TRUE parents ([G, max_pos]
// row-major + [G]): validation queries are held-out leaves whose edges are
// NOT in the working-graph CSR (node2parents comes from the full taxonomy).
// Returns 0 on success, -1 for a parentless query, -2 when a query has more
// parents than max_pos.
int32_t te_sample_eval_batch(void* handle, const int32_t* query_ids,
                             int32_t num_queries, const int32_t* parent_list,
                             const int32_t* parent_counts,
                             int32_t negative_size,
                             int32_t max_pos, int32_t expand_factor,
                             int32_t max_parents, int32_t* node_ids,
                             int32_t* ngp, int32_t* nsib, float* labels,
                             uint8_t* cand_mask) {
  auto* s = static_cast<Sampler*>(handle);
  const int32_t c = max_pos + negative_size;
  const int32_t n = max_parents + 1 + expand_factor;
  std::vector<int32_t> negs, gps, sibs;
  // zero the whole batch first: empty columns must be empty egonets
  std::memset(node_ids, 0,
              sizeof(int32_t) * static_cast<int64_t>(num_queries) * c * n);
  std::memset(ngp, 0, sizeof(int32_t) * static_cast<int64_t>(num_queries) * c);
  std::memset(nsib, 0,
              sizeof(int32_t) * static_cast<int64_t>(num_queries) * c);
  std::memset(labels, 0,
              sizeof(float) * static_cast<int64_t>(num_queries) * c);
  std::memset(cand_mask, 0,
              sizeof(uint8_t) * static_cast<int64_t>(num_queries) * c);
  for (int32_t q = 0; q < num_queries; ++q) {
    int32_t query = query_ids[q];
    int64_t pdeg = parent_counts[q];
    if (pdeg == 0) return -1;
    if (pdeg > max_pos) return -2;
    int64_t row = static_cast<int64_t>(q) * c;
    for (int64_t j = 0; j < pdeg; ++j) {
      int32_t parent = parent_list[static_cast<int64_t>(q) * max_pos + j];
      build_egonet(s, query, parent, /*positive=*/true, max_parents,
                   expand_factor, &gps, &sibs);
      emit(gps, parent, sibs, max_parents, expand_factor,
           node_ids + (row + j) * n, ngp + row + j, nsib + row + j);
      labels[row + j] = 1.0f;
      cand_mask[row + j] = 1;
    }
    sample_at_most_k(s, query, negative_size, &negs);
    for (size_t j = 0; j < negs.size(); ++j) {
      int32_t anchor = negs[j];
      int64_t r = row + max_pos + static_cast<int64_t>(j);
      auto it = s->cache.find(anchor);
      if (it != s->cache.end() && it->second.uses < s->cache_refresh_time) {
        ++it->second.uses;
        emit(it->second.gps, anchor, it->second.sibs, max_parents,
             expand_factor, node_ids + r * n, ngp + r, nsib + r);
      } else {
        build_egonet(s, query, anchor, /*positive=*/false, max_parents,
                     expand_factor, &gps, &sibs);
        CachedEgo& ce = s->cache[anchor];
        ce.gps = gps;
        ce.sibs = sibs;
        ce.uses = 0;
        emit(gps, anchor, sibs, max_parents, expand_factor, node_ids + r * n,
             ngp + r, nsib + r);
      }
      cand_mask[r] = 1;
    }
  }
  return 0;
}

// Build query-independent anchor egonets (phase-1 eval encoding,
// test_fast.py:96-97): one row per anchor.
int32_t te_build_anchor_egonets(void* handle, const int32_t* anchors,
                                int32_t num_anchors, int32_t expand_factor,
                                int32_t max_parents, int32_t* node_ids,
                                int32_t* ngp, int32_t* nsib) {
  auto* s = static_cast<Sampler*>(handle);
  const int32_t n = max_parents + 1 + expand_factor;
  std::vector<int32_t> gps, sibs;
  for (int32_t i = 0; i < num_anchors; ++i) {
    build_egonet(s, -1, anchors[i], /*positive=*/false, max_parents,
                 expand_factor, &gps, &sibs);
    emit(gps, anchors[i], sibs, max_parents, expand_factor,
         node_ids + static_cast<int64_t>(i) * n, ngp + i, nsib + i);
  }
  return 0;
}

}  // extern "C"
