// hnsw_tpu native graph builder + CPU search engine.
//
// Brand-new array-based reimplementation of the HNSW construction semantics
// surveyed from the reference (hnswlib/hnswalg.h): level assignment
// (hnswalg.h:207-211), ef_construction beam search per layer (226-305),
// neighbor-selection heuristic (getNeighborsByHeuristic2, 443-483), mutual
// connection with overflow re-prune (mutuallyConnectNewElement, 506-630),
// update/repair (995-1150), delete-marking (853-900), and query search
// (1271-1324). No reference code is used; the data layout here is padded
// flat arrays (ready for zero-copy export to the TPU padded-CSR format)
// instead of the reference's interleaved per-node byte blobs.
//
// This engine has two roles in the framework:
//  1. Host-side incremental builder (insert/update/delete) feeding the
//     device-resident index.
//  2. The single-core CPU baseline for bench.py (stand-in for hnswlib's
//     single-core QPS, same algorithm & parameters).
//
// Exposed as a C ABI for ctypes binding (no pybind11 in this image).

#include <algorithm>
#include <atomic>
#include <cassert>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <mutex>
#include <queue>
#include <random>
#include <shared_mutex>
#include <stdexcept>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

using std::size_t;

// ---------------------------------------------------------------------------
// Distance kernels. AVX-512/AVX2 fused-multiply-add paths when the build
// host has them (the functional equivalent of the reference's intrinsic
// ladders, hnswlib/space_l2.h:216-235, space_ip.h — a 16-lane FMA loop is
// the one canonical shape for this kernel), falling back to a 4-wide
// unrolled loop the compiler autovectorizes. Strict-FP builds cannot
// widen the scalar loop past its 4 accumulators on their own (float adds
// don't reassociate), which left ~4x of the host's zmm width unused —
// measured 3.6x slower than hnswlib single-core in round 4 before this.
// ---------------------------------------------------------------------------

#if defined(__AVX512F__) || defined(__AVX2__)
#include <immintrin.h>
#endif

static inline float l2_sq(const float* a, const float* b, int dim) {
  int i = 0;
  float acc;
#if defined(__AVX512F__)
  __m512 v = _mm512_setzero_ps();
  for (; i + 16 <= dim; i += 16) {
    __m512 d = _mm512_sub_ps(_mm512_loadu_ps(a + i), _mm512_loadu_ps(b + i));
    v = _mm512_fmadd_ps(d, d, v);
  }
  acc = _mm512_reduce_add_ps(v);
#elif defined(__AVX2__)
  __m256 v = _mm256_setzero_ps();
  for (; i + 8 <= dim; i += 8) {
    __m256 d = _mm256_sub_ps(_mm256_loadu_ps(a + i), _mm256_loadu_ps(b + i));
    v = _mm256_fmadd_ps(d, d, v);
  }
  __m128 lo = _mm256_castps256_ps128(v), hi = _mm256_extractf128_ps(v, 1);
  __m128 s = _mm_add_ps(lo, hi);
  s = _mm_hadd_ps(s, s);
  s = _mm_hadd_ps(s, s);
  acc = _mm_cvtss_f32(s);
#else
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
  for (; i + 4 <= dim; i += 4) {
    float d0 = a[i] - b[i];
    float d1 = a[i + 1] - b[i + 1];
    float d2 = a[i + 2] - b[i + 2];
    float d3 = a[i + 3] - b[i + 3];
    acc0 += d0 * d0;
    acc1 += d1 * d1;
    acc2 += d2 * d2;
    acc3 += d3 * d3;
  }
  acc = acc0 + acc1 + acc2 + acc3;
#endif
  for (; i < dim; ++i) {
    float d = a[i] - b[i];
    acc += d * d;
  }
  return acc;
}

static inline float ip_dist(const float* a, const float* b, int dim) {
  int i = 0;
  float acc;
#if defined(__AVX512F__)
  __m512 v = _mm512_setzero_ps();
  for (; i + 16 <= dim; i += 16)
    v = _mm512_fmadd_ps(_mm512_loadu_ps(a + i), _mm512_loadu_ps(b + i), v);
  acc = _mm512_reduce_add_ps(v);
#elif defined(__AVX2__)
  __m256 v = _mm256_setzero_ps();
  for (; i + 8 <= dim; i += 8)
    v = _mm256_fmadd_ps(_mm256_loadu_ps(a + i), _mm256_loadu_ps(b + i), v);
  __m128 lo = _mm256_castps256_ps128(v), hi = _mm256_extractf128_ps(v, 1);
  __m128 s = _mm_add_ps(lo, hi);
  s = _mm_hadd_ps(s, s);
  s = _mm_hadd_ps(s, s);
  acc = _mm_cvtss_f32(s);
#else
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
  for (; i + 4 <= dim; i += 4) {
    acc0 += a[i] * b[i];
    acc1 += a[i + 1] * b[i + 1];
    acc2 += a[i + 2] * b[i + 2];
    acc3 += a[i + 3] * b[i + 3];
  }
  acc = acc0 + acc1 + acc2 + acc3;
#endif
  for (; i < dim; ++i) acc += a[i] * b[i];
  return 1.0f - acc;
}

// ---------------------------------------------------------------------------
// Epoch-tagged visited set (semantics of hnswlib/visited_list_pool.h:10-77,
// single-owner variant: one per builder, O(1) reset via epoch bump).
// ---------------------------------------------------------------------------

struct VisitedSet {
  std::vector<uint32_t> tags;
  uint32_t epoch = 0;

  void ensure(size_t n) {
    if (tags.size() < n) tags.resize(n, 0);
  }
  void reset() {
    ++epoch;
    if (epoch == 0) {  // wrapped: clear and restart
      std::fill(tags.begin(), tags.end(), 0);
      epoch = 1;
    }
  }
  bool test_and_set(uint32_t id) {
    if (tags[id] == epoch) return true;
    tags[id] = epoch;
    return false;
  }
};

struct Cand {
  float dist;
  uint32_t id;
};
struct CandCloser {  // min-heap by dist when used with priority_queue
  bool operator()(const Cand& a, const Cand& b) const { return a.dist > b.dist; }
};
struct CandFarther {  // max-heap by dist
  bool operator()(const Cand& a, const Cand& b) const { return a.dist < b.dist; }
};

using MinHeap = std::priority_queue<Cand, std::vector<Cand>, CandCloser>;
using MaxHeap = std::priority_queue<Cand, std::vector<Cand>, CandFarther>;

// ---------------------------------------------------------------------------
// The builder.
// ---------------------------------------------------------------------------

struct HnswBuilder {
  int dim;
  int space;  // 0 = l2, 1 = ip
  int M;      // max links per node on upper levels
  int maxM0;  // max links at level 0 (= 2*M, as hnswalg.h:102)
  int ef_construction;
  double mult;  // 1 / ln(M)  (hnswalg.h:106)
  std::mt19937_64 rng;

  size_t n = 0;
  std::vector<float> data;          // [n, dim]
  std::vector<int64_t> labels;      // [n]
  std::vector<int32_t> node_level;  // [n]
  std::vector<uint8_t> deleted;     // [n] (accessed via del_get/del_set)
  // level-0 adjacency: flat [n, maxM0], -1 padded.
  std::vector<int32_t> links0;
  std::vector<int32_t> cnt0;  // [n] valid-link counts
  // upper adjacency: per node, flat [node_level, M], -1 padded (levels 1..).
  std::vector<std::vector<int32_t>> links_upper;
  std::vector<std::vector<int32_t>> cnt_upper;

  int32_t entry_point = -1;
  int max_level = -1;
  std::unordered_map<int64_t, uint32_t> label_to_id;
  std::atomic<size_t> num_deleted{0};

  // Delete marks are read by concurrent searches while a writer flips them
  // (markDelete is lock-free vs queries in hnswlib too, hnswalg.h:867-877,
  // which uses a flag byte inside the link-count word): relaxed atomic
  // byte access keeps that behavior defined.
  inline bool del_get(uint32_t id) const {
    return __atomic_load_n(&deleted[id], __ATOMIC_RELAXED) != 0;
  }
  inline void del_set(uint32_t id, bool v) {
    __atomic_store_n(&deleted[id], uint8_t(v), __ATOMIC_RELAXED);
  }
  // Deleted slots available for reuse (allow_replace_deleted semantics,
  // hnswalg.h:954-961 with the deleted_elements_ set at 815,879-921).
  std::unordered_set<uint32_t> deleted_ids;

  // Dirty tracking for incremental device sync (the resizeIndex analog,
  // hnswalg.h:633-683: host growth is automatic, the device applies row
  // deltas instead of a full re-upload). dirty0 marks nodes whose level-0
  // row changed since the last hnsw_clear_dirty/take; upper_dirty covers any
  // upper-level/entry change (small arrays, re-exported wholesale);
  // full_dirty covers in-place vector updates (referencing inline rows all
  // go stale -> caller does a full resync).
  std::vector<uint8_t> dirty0;
  std::vector<int32_t> dirty_list;
  std::atomic<bool> upper_dirty{false};
  std::atomic<bool> full_dirty{false};
  mutable std::mutex dirty_mutex;

  // In-place vector updates tracked by id (updatePoint analog): the device
  // applies them as row deltas — new vector row + refreshed inline rows of
  // every level-0 IN-neighbor (found by flush_updates' one-pass scan) —
  // instead of the full table rebuild the round-2 design did (minutes at 1M
  // for a single update).
  std::vector<uint8_t> vec_dirty0;
  std::vector<int32_t> vec_dirty_list;

  void mark0(uint32_t id) {
    std::lock_guard<std::mutex> g(dirty_mutex);
    if (dirty0.size() < n) dirty0.resize(n, 0);
    if (!dirty0[id]) {
      dirty0[id] = 1;
      dirty_list.push_back(int32_t(id));
    }
  }
  void mark_vec(uint32_t id) {
    std::lock_guard<std::mutex> g(dirty_mutex);
    if (vec_dirty0.size() < n) vec_dirty0.resize(n, 0);
    if (!vec_dirty0[id]) {
      vec_dirty0[id] = 1;
      vec_dirty_list.push_back(int32_t(id));
    }
  }
  // Mark every node whose level-0 row references an updated vector (their
  // inline neighbor-vector rows embed the stale bytes). One O(N * maxM0)
  // pass — ~100ms at 1M, vs minutes for the full-table rebuild it replaces.
  // Returns the number of pending vector updates.
  int64_t flush_updates() {
    std::lock_guard<std::mutex> g(dirty_mutex);
    if (vec_dirty_list.empty()) return 0;
    if (vec_dirty0.size() < n) vec_dirty0.resize(n, 0);
    if (dirty0.size() < n) dirty0.resize(n, 0);
    for (size_t i = 0; i < n; ++i) {
      if (dirty0[i]) continue;
      const int32_t* row = links0.data() + i * size_t(maxM0);
      int c = cnt0[i];
      for (int j = 0; j < c; ++j) {
        int32_t nb = row[j];
        if (nb >= 0 && size_t(nb) < vec_dirty0.size() && vec_dirty0[nb]) {
          dirty0[i] = 1;
          dirty_list.push_back(int32_t(i));
          break;
        }
      }
    }
    return int64_t(vec_dirty_list.size());
  }
  void clear_dirty() {
    std::lock_guard<std::mutex> g(dirty_mutex);
    std::fill(dirty0.begin(), dirty0.end(), 0);
    dirty_list.clear();
    std::fill(vec_dirty0.begin(), vec_dirty0.end(), 0);
    vec_dirty_list.clear();
    upper_dirty = false;
    full_dirty = false;
  }

  mutable VisitedSet visited;
  mutable std::mutex big_lock;  // structural mutations (append, maps)
  // Striped per-node link locks for concurrent inserts (role of the
  // reference's per-node link_list_locks_, hnswalg.h:43; striping avoids
  // growing a mutex array under concurrency).
  static constexpr size_t kStripes = 65536;
  mutable std::vector<std::mutex> link_locks{kStripes};
  std::mutex entry_lock;  // entry_point/max_level (hnswalg.h:42)

  // Growth lock: hnswlib PREALLOCATES max_elements so addPoint never moves
  // storage and queries can run lock-free alongside inserts; this engine
  // grows std::vectors instead, so a reallocation during a concurrent read
  // is a use-after-free (caught by the TSan stress, bin/tsan_check.py —
  // reader thread SEGV'd mid insert_batch). Registration/update phases take
  // it unique; searches and the threaded link phase take it shared.
  mutable std::shared_mutex grow_lock;
  // Count of in-flight writer operations: searches escalate to
  // stripe-locked neighbor reads only while a writer is active, so the
  // single-threaded serving path stays lock-free on links.
  std::atomic<int> writers{0};

  std::mutex& lock_of(uint32_t id) const { return link_locks[id & (kStripes - 1)]; }

  HnswBuilder(int dim_, int space_, int M_, int efc, uint64_t seed)
      : dim(dim_),
        space(space_),
        M(M_),
        maxM0(2 * M_),
        ef_construction(efc),
        mult(1.0 / std::log(double(M_))),
        rng(seed) {}

  inline float dist(const float* a, const float* b) const {
    return space == 0 ? l2_sq(a, b, dim) : ip_dist(a, b, dim);
  }
  inline const float* vec(uint32_t id) const { return data.data() + size_t(id) * dim; }

  // Random level, same distribution as hnswalg.h:207-211.
  int random_level() {
    std::uniform_real_distribution<double> u(0.0, 1.0);
    double r = -std::log(u(rng)) * mult;
    return int(r);
  }

  inline const int32_t* neighbors(uint32_t id, int level, int* count) const {
    if (level == 0) {
      *count = cnt0[id];
      return links0.data() + size_t(id) * maxM0;
    }
    *count = cnt_upper[id][level - 1];
    return links_upper[id].data() + size_t(level - 1) * M;
  }
  inline int32_t* mutable_neighbors(uint32_t id, int level, int32_t** countp) {
    if (level == 0) {
      *countp = &cnt0[id];
      return links0.data() + size_t(id) * maxM0;
    }
    *countp = &cnt_upper[id][level - 1];
    return links_upper[id].data() + size_t(level - 1) * M;
  }

  // Greedy 1-best descent on one upper level (hnswalg.h:1213-1239 /
  // 1278-1303 semantics). `locked` copies each list under its node's
  // stripe lock (concurrent-build path, cf. hnswalg.h:255).
  uint32_t greedy_level(const float* q, uint32_t ep, int level, float* ep_dist,
                        bool locked = false) const {
    uint32_t cur = ep;
    float cur_d = *ep_dist;
    bool changed = true;
    // sized from maxM0 (>= M): a fixed local[64] silently truncated link
    // copies for maxM0 > 64 (the reference supports arbitrary M)
    std::vector<int32_t> local(static_cast<size_t>(maxM0));
    while (changed) {
      changed = false;
      int cnt;
      const int32_t* nb;
      if (locked) {
        std::lock_guard<std::mutex> g(lock_of(cur));
        const int32_t* src = neighbors(cur, level, &cnt);
        std::memcpy(local.data(), src, size_t(cnt) * sizeof(int32_t));
        nb = local.data();
      } else {
        nb = neighbors(cur, level, &cnt);
      }
      for (int j = 0; j < cnt; ++j) {
        uint32_t cand = uint32_t(nb[j]);
        float d = dist(q, vec(cand));
        if (d < cur_d) {
          cur_d = d;
          cur = cand;
          changed = true;
        }
      }
    }
    *ep_dist = cur_d;
    return cur;
  }

  // ef-bounded beam search on one level (semantics of searchBaseLayer,
  // hnswalg.h:226-305). Returns a max-heap of up to `ef` (dist, id).
  // `elig` (optional, per internal id): BaseFilterFunctor semantics
  // (hnswlib/hnswlib.h:128-132, applied at hnswalg.h:1271/searchBaseLayerST):
  // ineligible nodes are traversed but never enter the result heap.
  MaxHeap search_layer(const float* q, uint32_t ep, int level, int ef,
                       bool skip_deleted_results = false, bool locked = false,
                       VisitedSet* vis = nullptr,
                       const uint8_t* elig = nullptr) const {
    VisitedSet& visited = vis ? *vis : this->visited;
    visited.ensure(n);
    visited.reset();
    MaxHeap results;
    MinHeap candidates;

    float d0 = dist(q, vec(ep));
    visited.test_and_set(ep);
    candidates.push({d0, ep});
    float lower_bound;
    if ((!skip_deleted_results || !del_get(ep)) && (!elig || elig[ep])) {
      results.push({d0, ep});
      lower_bound = d0;
    } else {
      lower_bound = std::numeric_limits<float>::max();
    }

    std::vector<int32_t> local(static_cast<size_t>(maxM0));
    while (!candidates.empty()) {
      Cand c = candidates.top();
      if (c.dist > lower_bound && results.size() >= size_t(ef)) break;
      candidates.pop();
      int cnt;
      const int32_t* nb;
      if (locked) {
        std::lock_guard<std::mutex> g(lock_of(c.id));
        const int32_t* src = neighbors(c.id, level, &cnt);
        std::memcpy(local.data(), src, size_t(cnt) * sizeof(int32_t));
        nb = local.data();
      } else {
        nb = neighbors(c.id, level, &cnt);
      }
      if (cnt > 0) __builtin_prefetch(vec(uint32_t(nb[0])));
      for (int j = 0; j < cnt; ++j) {
        uint32_t cand = uint32_t(nb[j]);
        // hide the random row fetch behind the current distance (the
        // reference's _mm_prefetch ladder, hnswalg.h:320-428)
        if (j + 1 < cnt) __builtin_prefetch(vec(uint32_t(nb[j + 1])));
        if (visited.test_and_set(cand)) continue;
        float d = dist(q, vec(cand));
        if (results.size() < size_t(ef) || d < lower_bound) {
          candidates.push({d, cand});
          if ((!skip_deleted_results || !del_get(cand)) &&
              (!elig || elig[cand])) {
            results.push({d, cand});
            if (results.size() > size_t(ef)) results.pop();
          }
          if (!results.empty() && results.size() >= size_t(ef))
            lower_bound = results.top().dist;
        }
      }
    }
    return results;
  }

  // Neighbor-selection heuristic (getNeighborsByHeuristic2 semantics,
  // hnswalg.h:443-483): scan candidates closest-first, keep a candidate iff
  // it is closer to the query point than to every already-kept neighbor.
  void select_neighbors(std::vector<Cand>& cands, int m) const {
    if (cands.size() <= size_t(m)) return;
    std::sort(cands.begin(), cands.end(),
              [](const Cand& a, const Cand& b) { return a.dist < b.dist; });
    std::vector<Cand> kept;
    kept.reserve(m);
    for (const Cand& c : cands) {
      if (kept.size() >= size_t(m)) break;
      bool good = true;
      for (const Cand& s : kept) {
        float d_cs = dist(vec(c.id), vec(s.id));
        if (d_cs < c.dist) {
          good = false;
          break;
        }
      }
      if (good) kept.push_back(c);
    }
    cands.swap(kept);
  }

  // Connect `id` to selected neighbors at `level`; add reverse links with
  // overflow re-prune (mutuallyConnectNewElement, hnswalg.h:506-630).
  // Returns the closest selected neighbor (next entry point).
  uint32_t connect(uint32_t id, std::vector<Cand>& cands, int level,
                   bool locked = false) {
    (void)locked;  // link writes are always stripe-locked now
    int m_cap = level == 0 ? maxM0 : M;
    select_neighbors(cands, M);  // forward selection capped at M (hnswalg.h:513)
    uint32_t closest = cands.empty() ? id : cands.front().id;
    float best = std::numeric_limits<float>::max();

    {
      std::lock_guard<std::mutex> g(lock_of(id));
      int32_t* cntp;
      int32_t* my = mutable_neighbors(id, level, &cntp);
      *cntp = 0;
      for (const Cand& c : cands) {
        my[(*cntp)++] = int32_t(c.id);
        if (c.dist < best) {
          best = c.dist;
          closest = c.id;
        }
      }
      for (int j = *cntp; j < m_cap; ++j) my[j] = -1;
    }
    if (level == 0) mark0(id); else upper_dirty = true;

    for (const Cand& c : cands) {
      std::lock_guard<std::mutex> g(lock_of(c.id));
      int32_t* ocntp;
      int32_t* other = mutable_neighbors(c.id, level, &ocntp);
      // the link may already exist (update/repair path re-links a live node)
      bool present = false;
      for (int j = 0; j < *ocntp; ++j)
        if (other[j] == int32_t(id)) {
          present = true;
          break;
        }
      if (present) continue;
      if (level == 0) mark0(c.id); else upper_dirty = true;
      if (*ocntp < m_cap) {
        other[(*ocntp)++] = int32_t(id);
      } else {
        // Overflow: re-select among existing links + the new node
        // (hnswalg.h:586-625).
        float d_new = dist(vec(id), vec(c.id));
        std::vector<Cand> pool;
        pool.reserve(*ocntp + 1);
        pool.push_back({d_new, id});
        for (int j = 0; j < *ocntp; ++j) {
          uint32_t o = uint32_t(other[j]);
          pool.push_back({dist(vec(o), vec(c.id)), o});
        }
        select_neighbors(pool, m_cap);
        *ocntp = 0;
        for (const Cand& p : pool) other[(*ocntp)++] = int32_t(p.id);
        // clear stale slots beyond the live count (the flat array is
        // exported as a -1-padded row)
        for (int j = *ocntp; j < m_cap; ++j) other[j] = -1;
      }
    }
    return closest;
  }

  // RAII writer presence: searches escalate to stripe-locked neighbor
  // reads while any writer op is in flight; the first unique grow_lock
  // acquisition inside the op drains searches that began before the flag
  // was visible.
  struct WriterScope {
    HnswBuilder* b;
    explicit WriterScope(HnswBuilder* b_) : b(b_) {
      b->writers.fetch_add(1, std::memory_order_acq_rel);
    }
    ~WriterScope() { b->writers.fetch_sub(1, std::memory_order_release); }
  };

  // Core insert (addPoint semantics, hnswalg.h:954-1267).
  void insert(const float* v, int64_t label) {
    WriterScope ws(this);
    std::lock_guard<std::mutex> g(big_lock);
    auto it = label_to_id.find(label);
    if (it != label_to_id.end()) {
      update(it->second, v);
      return;
    }
    uint32_t id = uint32_t(n);
    int level = random_level();
    {
      std::unique_lock<std::shared_mutex> gg(grow_lock);
      ++n;
      data.insert(data.end(), v, v + dim);
      labels.push_back(label);
      deleted.push_back(0);
      cnt0.push_back(0);
      links0.resize(n * size_t(maxM0), -1);
      node_level.push_back(level);
      links_upper.emplace_back(size_t(level) * M, -1);
      cnt_upper.emplace_back(size_t(level), 0);
      label_to_id.emplace(label, id);
    }

    mark0(id);
    if (level > 0) upper_dirty = true;
    if (entry_point < 0) {
      std::lock_guard<std::mutex> ge(entry_lock);
      entry_point = int32_t(id);
      max_level = level;
      upper_dirty = true;
      return;
    }
    link_node(id, level, /*locked=*/writers.load() > 1, nullptr);
  }

  // Descend + search + mutually connect a pre-registered node. With
  // locked=true this is safe to run concurrently across nodes (the parallel
  // bulk-build path; reference semantics of concurrent addPoint,
  // hnswalg.h:954-1267 with per-node link locks).
  void link_node(uint32_t id, int level, bool locked, VisitedSet* vis) {
    const float* v = vec(id);
    int ml;
    uint32_t ep;
    if (locked) {
      std::lock_guard<std::mutex> g(entry_lock);
      ml = max_level;
      ep = uint32_t(entry_point);
    } else {
      ml = max_level;
      ep = uint32_t(entry_point);
    }
    float ep_d = dist(v, vec(ep));
    for (int l = ml; l > level; --l) ep = greedy_level(v, ep, l, &ep_d, locked);

    for (int l = std::min(level, ml); l >= 0; --l) {
      MaxHeap top = search_layer(v, ep, l, ef_construction, false, locked, vis);
      std::vector<Cand> cands;
      cands.reserve(top.size());
      while (!top.empty()) {
        cands.push_back(top.top());
        top.pop();
      }
      ep = connect(id, cands, l, locked);
    }
    if (level > ml) {
      std::lock_guard<std::mutex> g(entry_lock);
      if (level > max_level) {
        max_level = level;
        entry_point = int32_t(id);
        upper_dirty = true;
      }
    }
  }

  // Parallel bulk insert: phase 1 registers all new nodes serially
  // (storage append, level assignment — keeps levels deterministic),
  // phase 2 links them across threads with striped per-node locks,
  // phase 3 applies updates of pre-existing labels serially.
  void insert_batch(const float* vecs, const int64_t* batch_labels,
                    size_t count, int n_threads) {
    WriterScope ws(this);
    std::vector<uint32_t> fresh;
    std::vector<size_t> updates;
    {
      std::lock_guard<std::mutex> g(big_lock);
      std::unique_lock<std::shared_mutex> gg(grow_lock);
      fresh.reserve(count);
      for (size_t i = 0; i < count; ++i) {
        int64_t label = batch_labels[i];
        if (label_to_id.count(label)) {
          updates.push_back(i);
          continue;
        }
        uint32_t id = uint32_t(n);
        ++n;
        const float* v = vecs + i * size_t(dim);
        data.insert(data.end(), v, v + dim);
        labels.push_back(label);
        deleted.push_back(0);
        cnt0.push_back(0);
        links0.resize(n * size_t(maxM0), -1);
        int level = random_level();
        node_level.push_back(level);
        links_upper.emplace_back(size_t(level) * M, -1);
        cnt_upper.emplace_back(size_t(level), 0);
        label_to_id.emplace(label, id);
        mark0(id);
        if (level > 0) upper_dirty = true;
        if (entry_point < 0) {
          std::lock_guard<std::mutex> ge(entry_lock);
          entry_point = int32_t(id);
          max_level = level;
          upper_dirty = true;
          continue;
        }
        fresh.push_back(id);
      }
    }
    if (n_threads <= 0) {
      n_threads = int(std::thread::hardware_concurrency());
      if (n_threads <= 0) n_threads = 1;
    }
    n_threads = std::min<size_t>(n_threads, std::max<size_t>(fresh.size(), 1));
    if (n_threads <= 1 || fresh.size() < 64) {
      VisitedSet vis;
      bool lk = writers.load() > 1;  // another writer op may be in flight
      for (uint32_t id : fresh) link_node(id, node_level[id], lk, &vis);
    } else {
      std::atomic<size_t> next{0};
      std::vector<std::thread> pool;
      for (int t = 0; t < n_threads; ++t) {
        pool.emplace_back([&] {
          VisitedSet vis;
          while (true) {
            size_t i = next.fetch_add(1);
            if (i >= fresh.size()) break;
            link_node(fresh[i], node_level[fresh[i]], true, &vis);
          }
        });
      }
      for (auto& th : pool) th.join();
    }
    for (size_t i : updates) {
      std::lock_guard<std::mutex> g(big_lock);
      update(label_to_id[batch_labels[i]], vecs + i * size_t(dim));
    }
  }

  // Snapshot a node's neighbor list at a level under its stripe lock
  // (getConnectionsWithLock analog, hnswalg.h:1145-1153).
  std::vector<uint32_t> neighbor_snapshot(uint32_t id, int level) {
    std::lock_guard<std::mutex> g(lock_of(id));
    int cnt;
    const int32_t* nb = neighbors(id, level, &cnt);
    std::vector<uint32_t> out;
    out.reserve(cnt);
    for (int j = 0; j < cnt; ++j)
      if (nb[j] >= 0) out.push_back(uint32_t(nb[j]));
    return out;
  }

  // Update an existing element's vector and repair its links (updatePoint /
  // repairConnectionsForUpdate semantics, hnswalg.h:995-1150). Two phases,
  // matching the reference's algorithm:
  //   1. Neighborhood repair (hnswalg.h:1007-1068): at each of the node's
  //      levels, every current 1-hop neighbor re-selects its own links from
  //      the 2-hop candidate set around the updated node (which includes
  //      the node with its NEW vector) — under churn this lets neighbors
  //      drop/keep the moved point on merit instead of keeping stale edges.
  //   2. Re-link the node itself from a fresh entry descent
  //      (repairConnectionsForUpdate, hnswalg.h:1071-1141).
  // The vector change propagates to the device as a row delta: mark_vec
  // records the id, and flush_updates later marks every level-0 in-neighbor
  // dirty (their inline rows embed this vector). Upper-table rows embed it
  // too when the node lives above level 0 — upper tables are small and
  // rebuilt wholesale on upper_dirty.
  void update(uint32_t id, const float* v) {
    {
      // drains concurrent searches: their reads of this vector are done
      // before the exclusive lock is granted
      std::unique_lock<std::shared_mutex> gg(grow_lock);
      std::memcpy(data.data() + size_t(id) * dim, v, sizeof(float) * dim);
    }
    mark_vec(id);
    mark0(id);  // its own row is re-linked below
    if (node_level[id] > 0) upper_dirty = true;
    if (del_get(id)) {
      del_set(id, false);
      num_deleted.fetch_sub(1);
      deleted_ids.erase(id);
    }
    if (n == 1) return;
    int level = node_level[id];

    // Phase 1: neighborhood repair (hnswalg.h:1007-1068). The reference
    // samples neighbors with updateNeighborProbability; the only caller
    // (updatePoint from addPoint) passes 1.0, so every neighbor repairs.
    for (int l = 0; l <= level; ++l) {
      std::vector<uint32_t> one_hop = neighbor_snapshot(id, l);
      if (one_hop.empty()) continue;
      std::unordered_set<uint32_t> cand_set;
      cand_set.insert(id);
      for (uint32_t nb : one_hop) {
        cand_set.insert(nb);
        for (uint32_t nb2 : neighbor_snapshot(nb, l)) cand_set.insert(nb2);
      }
      int m_cap = l == 0 ? maxM0 : M;
      for (uint32_t neigh : one_hop) {
        // closest min(efC, |sCand\{neigh}|) candidates by distance to the
        // neighbor, then the diversity heuristic (hnswalg.h:1034-1058)
        std::vector<Cand> cands;
        cands.reserve(cand_set.size());
        for (uint32_t c : cand_set) {
          if (c == neigh) continue;
          cands.push_back({dist(vec(neigh), vec(c)), c});
        }
        if (cands.empty()) continue;
        if (cands.size() > size_t(ef_construction)) {
          std::nth_element(
              cands.begin(), cands.begin() + ef_construction, cands.end(),
              [](const Cand& a, const Cand& b) { return a.dist < b.dist; });
          cands.resize(ef_construction);
        }
        select_neighbors(cands, m_cap);
        std::lock_guard<std::mutex> g(lock_of(neigh));
        int32_t* cntp;
        int32_t* row = mutable_neighbors(neigh, l, &cntp);
        *cntp = 0;
        for (const Cand& c : cands) row[(*cntp)++] = int32_t(c.id);
        for (int j = *cntp; j < m_cap; ++j) row[j] = -1;
        if (l == 0) mark0(neigh); else upper_dirty = true;
      }
    }

    // Phase 2: re-link the node itself (repairConnectionsForUpdate).
    uint32_t ep = uint32_t(entry_point);
    if (ep == id) {
      // find any other node to use as the descent entry
      ep = id == 0 ? 1 : 0;
      for (uint32_t cand = 0; cand < n; ++cand)
        if (cand != id && node_level[cand] == max_level) {
          ep = cand;
          break;
        }
    }
    float ep_d = dist(v, vec(ep));
    for (int l = max_level; l > level; --l) ep = greedy_level(v, ep, l, &ep_d);
    for (int l = std::min(level, max_level); l >= 0; --l) {
      MaxHeap top = search_layer(v, ep, l, ef_construction);
      std::vector<Cand> cands;
      cands.reserve(top.size());
      while (!top.empty()) {
        Cand c = top.top();
        top.pop();
        if (c.id != id) cands.push_back(c);
      }
      if (!cands.empty()) ep = connect(id, cands, l);
    }
  }

  // Insert reusing a delete-marked slot when one exists (addPoint with
  // replace_deleted=true, hnswalg.h:954-961: pick a deleted slot, swap the
  // label mapping, update the vector in place and re-link at the slot's
  // existing level). Returns 1 if a slot was reused, 0 if appended.
  int insert_replace(const float* v, int64_t label) {
    WriterScope ws(this);
    uint32_t reuse_id;
    {
      std::lock_guard<std::mutex> g(big_lock);
      auto it = label_to_id.find(label);
      if (it != label_to_id.end()) {
        update(it->second, v);
        return 0;
      }
      if (deleted_ids.empty()) {
        // fall through to a normal append outside the lock
        reuse_id = UINT32_MAX;
      } else {
        reuse_id = *deleted_ids.begin();
        deleted_ids.erase(deleted_ids.begin());
        int64_t old_label = labels[reuse_id];
        label_to_id.erase(old_label);
        labels[reuse_id] = label;
        label_to_id.emplace(label, reuse_id);
        del_set(reuse_id, false);
        num_deleted.fetch_sub(1);
        update(reuse_id, v);
        return 1;
      }
    }
    insert(v, label);
    return 0;
  }

  bool mark_deleted(int64_t label, bool del) {
    std::lock_guard<std::mutex> g(big_lock);
    auto it = label_to_id.find(label);
    if (it == label_to_id.end()) return false;
    if (del_get(it->second) != del) {
      del_set(it->second, del);
      if (del) num_deleted.fetch_add(1); else num_deleted.fetch_sub(1);
      if (del) deleted_ids.insert(it->second);
      else deleted_ids.erase(it->second);
    }
    return true;
  }

  // Query search (searchKnn semantics, hnswalg.h:1271-1324). Deleted
  // elements are traversed but excluded from results. `elig` (optional,
  // per internal id) is the BaseFilterFunctor analog (hnswlib.h:128-132):
  // filtered nodes are traversed but excluded from results — the CPU
  // parity oracle for the device path's `eligible` mask.
  int search(const float* q, int k, int ef, int64_t* out_labels,
             float* out_dists, const uint8_t* elig = nullptr,
             VisitedSet* vis = nullptr) const {
    // shared growth lock: (a) no vector reallocation mid-search, (b) a
    // writer's first exclusive acquisition drains searches that started
    // before its `writers` increment was visible
    std::shared_lock<std::shared_mutex> sg(grow_lock);
    // stripe-locked neighbor reads only while a writer op is in flight —
    // the single-threaded serving path stays lock-free
    bool locked =
        const_cast<HnswBuilder*>(this)->writers.load(
            std::memory_order_acquire) > 0;
    int ml;
    int32_t epi;
    {
      std::lock_guard<std::mutex> ge(
          const_cast<HnswBuilder*>(this)->entry_lock);
      ml = max_level;
      epi = entry_point;
    }
    if (n == 0 || epi < 0) return 0;
    uint32_t ep = uint32_t(epi);
    float ep_d = dist(q, vec(ep));
    for (int l = ml; l > 0; --l)
      ep = greedy_level(q, ep, l, &ep_d, locked);
    MaxHeap top = search_layer(q, ep, 0, std::max(ef, k),
                               num_deleted.load() > 0, locked, vis, elig);
    std::vector<Cand> res;
    res.reserve(top.size());
    while (!top.empty()) {
      res.push_back(top.top());
      top.pop();
    }
    std::reverse(res.begin(), res.end());  // ascending
    int out = int(std::min(res.size(), size_t(k)));
    for (int i = 0; i < out; ++i) {
      out_labels[i] = labels[res[i].id];
      out_dists[i] = res[i].dist;
    }
    return out;
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// C ABI.
// ---------------------------------------------------------------------------

extern "C" {

HnswBuilder* hnsw_create(int dim, int space, int M, int ef_construction,
                         uint64_t seed) {
  return new HnswBuilder(dim, space, M, ef_construction, seed);
}

void hnsw_free(HnswBuilder* b) { delete b; }

void hnsw_add(HnswBuilder* b, const float* vec, int64_t label) {
  b->insert(vec, label);
}

void hnsw_add_batch(HnswBuilder* b, const float* vecs, const int64_t* labels,
                    int64_t count, int n_threads) {
  b->insert_batch(vecs, labels, size_t(count), n_threads);
}

// --- bulk-build support (device-accelerated construction path) -------------

// Insert with a forced level (bulk build pre-samples levels host-side so the
// level-0-only population can be wave-linked separately).
void hnsw_add_with_level(HnswBuilder* b, const float* vec, int64_t label,
                         int level) {
  HnswBuilder::WriterScope ws(b);
  std::lock_guard<std::mutex> g(b->big_lock);
  auto it = b->label_to_id.find(label);
  if (it != b->label_to_id.end()) {
    b->update(it->second, vec);
    return;
  }
  uint32_t id = uint32_t(b->n);
  {
    std::unique_lock<std::shared_mutex> gg(b->grow_lock);
    ++b->n;
    b->data.insert(b->data.end(), vec, vec + b->dim);
    b->labels.push_back(label);
    b->deleted.push_back(0);
    b->cnt0.push_back(0);
    b->links0.resize(b->n * size_t(b->maxM0), -1);
    b->node_level.push_back(level);
    b->links_upper.emplace_back(size_t(level) * b->M, -1);
    b->cnt_upper.emplace_back(size_t(level), 0);
    b->label_to_id.emplace(label, id);
  }
  b->mark0(id);
  if (level > 0) b->upper_dirty = true;
  if (b->entry_point < 0) {
    std::lock_guard<std::mutex> ge(b->entry_lock);
    b->entry_point = int32_t(id);
    b->max_level = level;
    b->upper_dirty = true;
    return;
  }
  b->link_node(id, level, b->writers.load() > 1, nullptr);
}

// Register level-0 nodes WITHOUT linking (they become reachable only after
// hnsw_connect_batch applies their links). Returns the first assigned id.
int64_t hnsw_register_level0_batch(HnswBuilder* b, const float* vecs,
                                   const int64_t* labels, int64_t count) {
  HnswBuilder::WriterScope ws(b);
  std::lock_guard<std::mutex> g(b->big_lock);
  std::unique_lock<std::shared_mutex> gg(b->grow_lock);
  int64_t first = int64_t(b->n);
  for (int64_t i = 0; i < count; ++i) {
    uint32_t id = uint32_t(b->n);
    ++b->n;
    const float* v = vecs + size_t(i) * b->dim;
    b->data.insert(b->data.end(), v, v + b->dim);
    b->labels.push_back(labels[i]);
    b->deleted.push_back(0);
    b->cnt0.push_back(0);
    b->links0.resize(b->n * size_t(b->maxM0), -1);
    b->node_level.push_back(0);
    b->links_upper.emplace_back();
    b->cnt_upper.emplace_back();
    b->label_to_id.emplace(labels[i], id);
    b->mark0(id);
    if (b->entry_point < 0) {
      std::lock_guard<std::mutex> ge(b->entry_lock);
      b->entry_point = int32_t(id);
      b->max_level = 0;
      b->upper_dirty = true;
    }
  }
  return first;
}

// Apply pre-selected level-0 links for a wave of registered nodes: forward
// links + reverse links with overflow re-prune (mutuallyConnectNewElement
// semantics, hnswalg.h:506-630). selected: [count, m_sel], -1 padded.
void hnsw_connect_batch(HnswBuilder* b, const uint32_t* ids, int64_t count,
                        const int32_t* selected, int m_sel) {
  HnswBuilder::WriterScope ws(b);
  // drain searches that started before the writer flag was visible (they
  // read neighbor lists without stripe locks)
  { std::unique_lock<std::shared_mutex> gg(b->grow_lock); }
  for (int64_t i = 0; i < count; ++i) {
    uint32_t id = ids[i];
    std::vector<Cand> cands;
    cands.reserve(m_sel);
    for (int j = 0; j < m_sel; ++j) {
      int32_t s = selected[i * m_sel + j];
      if (s < 0 || uint32_t(s) == id) continue;
      cands.push_back({b->dist(b->vec(id), b->vec(uint32_t(s))), uint32_t(s)});
    }
    std::sort(cands.begin(), cands.end(),
              [](const Cand& a, const Cand& c) { return a.dist < c.dist; });
    if (!cands.empty()) b->connect(id, cands, 0);
  }
}

int hnsw_mark_deleted(HnswBuilder* b, int64_t label) {
  return b->mark_deleted(label, true) ? 0 : -1;
}
int hnsw_unmark_deleted(HnswBuilder* b, int64_t label) {
  return b->mark_deleted(label, false) ? 0 : -1;
}

int64_t hnsw_size(HnswBuilder* b) { return int64_t(b->n); }
// getMaxElements analog (hnswalg.h:213-215). hnswlib preallocates a fixed
// max_elements and addPoint throws past it; this builder auto-grows (the
// resizeIndex analog is the incremental device sync), so "max elements"
// is the currently allocated slot capacity — inserts beyond it just grow.
int64_t hnsw_capacity(HnswBuilder* b) { return int64_t(b->labels.capacity()); }
// clear() analog (hnswalg.h:149-161): drop all index content. The reference
// frees storage and zeroes cur_element_count (the handle is dead until a
// re-init); this engine resets its arrays so the same handle is immediately
// reusable for new inserts with the original config.
void hnsw_clear(HnswBuilder* b) {
  HnswBuilder::WriterScope ws(b);
  std::lock_guard<std::mutex> g(b->big_lock);
  std::unique_lock<std::shared_mutex> gg(b->grow_lock);
  b->n = 0;
  b->data.clear();
  b->labels.clear();
  b->node_level.clear();
  b->deleted.clear();
  b->links0.clear();
  b->cnt0.clear();
  b->links_upper.clear();
  b->cnt_upper.clear();
  b->entry_point = -1;
  b->max_level = -1;
  b->label_to_id.clear();
  b->num_deleted = 0;
  b->deleted_ids.clear();
  {
    std::lock_guard<std::mutex> gd(b->dirty_mutex);
    b->dirty0.clear();
    b->dirty_list.clear();
    b->vec_dirty0.clear();
    b->vec_dirty_list.clear();
  }
  b->upper_dirty = true;
  b->full_dirty = true;  // any device state is now stale
}
// indexFileSize analog (hnswalg.h:658-683): byte size of the hnswlib binary
// save an EQUIVALENT index would produce (header PODs + per-element level-0
// block + per-node upper linklists, saveIndex layout hnswalg.h:685-713).
// Reported for capacity-planning parity; this framework's own checkpoint
// format is npz (io/checkpoint.py).
int64_t hnsw_index_file_size(HnswBuilder* b) {
  std::lock_guard<std::mutex> g(b->big_lock);
  std::shared_lock<std::shared_mutex> sg(b->grow_lock);
  // hnswlib header: 10 size_t fields (offsetLevel0, max_elements,
  // cur_element_count, size_data_per_element, label_offset, offsetData,
  // maxM, maxM0, M, ef_construction) + int maxlevel + u32 entrypoint +
  // double mult.
  size_t size = 10 * sizeof(uint64_t) + sizeof(int32_t) + sizeof(uint32_t) +
                sizeof(double);
  // per element: level-0 links block (u32 count word + maxM0 ids), vector
  // bytes, label (hnswalg.h:120-124).
  size_t per_elem = (size_t(b->maxM0) * 4 + 4) + size_t(b->dim) * 4 + 8;
  size += b->n * per_elem;
  // per node: u32 upper-list byte length + level * (M ids + count word)
  size_t per_level = size_t(b->M) * 4 + 4;
  for (size_t i = 0; i < b->n; ++i) {
    size += 4;
    if (b->node_level[i] > 0) size += per_level * size_t(b->node_level[i]);
  }
  return int64_t(size);
}
// getDataByLabel (hnswalg.h:826-851): O(1) hash lookup, fails (-1) on an
// absent or delete-marked label exactly like the reference's throw paths.
int hnsw_get_data_by_label(HnswBuilder* b, int64_t label, float* out) {
  std::lock_guard<std::mutex> g(b->big_lock);
  std::shared_lock<std::shared_mutex> sg(b->grow_lock);
  auto it = b->label_to_id.find(label);
  if (it == b->label_to_id.end() || b->del_get(it->second)) return -1;
  std::memcpy(out, b->vec(it->second), b->dim * sizeof(float));
  return 0;
}
int hnsw_max_level(HnswBuilder* b) { return b->max_level; }
int hnsw_entry_point(HnswBuilder* b) { return b->entry_point; }
int hnsw_dim(HnswBuilder* b) { return b->dim; }
int hnsw_m(HnswBuilder* b) { return b->M; }
int hnsw_max_m0(HnswBuilder* b) { return b->maxM0; }
int64_t hnsw_num_deleted(HnswBuilder* b) { return int64_t(b->num_deleted); }

// Export: level-0 links [n, maxM0] (-1 padded), per-node levels, labels,
// deleted flags, vectors.
void hnsw_export_level0(HnswBuilder* b, int32_t* out) {
  std::memcpy(out, b->links0.data(), b->n * size_t(b->maxM0) * sizeof(int32_t));
}
void hnsw_export_levels(HnswBuilder* b, int32_t* out) {
  std::memcpy(out, b->node_level.data(), b->n * sizeof(int32_t));
}
void hnsw_export_labels(HnswBuilder* b, int64_t* out) {
  std::memcpy(out, b->labels.data(), b->n * sizeof(int64_t));
}
void hnsw_export_deleted(HnswBuilder* b, uint8_t* out) {
  std::memcpy(out, b->deleted.data(), b->n * sizeof(uint8_t));
}
void hnsw_export_vectors(HnswBuilder* b, float* out) {
  std::memcpy(out, b->data.data(), b->n * size_t(b->dim) * sizeof(float));
}

// Upper-level export: count of nodes at `level`, then their ids and padded
// [count, M] link rows.
int64_t hnsw_upper_count(HnswBuilder* b, int level) {
  int64_t c = 0;
  for (size_t i = 0; i < b->n; ++i)
    if (b->node_level[i] >= level) ++c;
  return c;
}
void hnsw_export_upper(HnswBuilder* b, int level, int32_t* out_ids,
                       int32_t* out_links) {
  int64_t row = 0;
  for (size_t i = 0; i < b->n; ++i) {
    if (b->node_level[i] < level) continue;
    out_ids[row] = int32_t(i);
    const int32_t* src =
        b->links_upper[i].data() + size_t(level - 1) * b->M;
    std::memcpy(out_links + row * b->M, src, b->M * sizeof(int32_t));
    ++row;
  }
}

// Import a complete graph state (checkpoint/resume path: the Python side
// holds the padded-CSR checkpoint; this rebuilds a live builder so the
// index keeps accepting inserts/updates/deletes after load — the analog of
// hnswlib::loadIndex, hnswalg.h:716-822).
// `upper_flat`: for node i, node_level[i]*M int32 entries (level 1..top),
// -1 padded, concatenated in node order.
HnswBuilder* hnsw_import(int dim, int space, int M, int ef_construction,
                         uint64_t seed, int64_t n, const float* vectors,
                         const int64_t* labels, const int32_t* node_level,
                         const uint8_t* deleted, const int32_t* level0,
                         const int32_t* upper_flat, int max_level,
                         int entry_point) {
  auto* b = new HnswBuilder(dim, space, M, ef_construction, seed);
  b->n = size_t(n);
  b->data.assign(vectors, vectors + size_t(n) * dim);
  b->labels.assign(labels, labels + n);
  b->node_level.assign(node_level, node_level + n);
  b->deleted.assign(deleted, deleted + n);
  b->num_deleted = 0;
  for (int64_t i = 0; i < n; ++i) {
    b->num_deleted += deleted[i];
    if (deleted[i]) b->deleted_ids.insert(uint32_t(i));
  }
  b->links0.assign(level0, level0 + size_t(n) * b->maxM0);
  b->cnt0.resize(n);
  for (int64_t i = 0; i < n; ++i) {
    int c = 0;
    const int32_t* row = level0 + size_t(i) * b->maxM0;
    for (int j = 0; j < b->maxM0; ++j)
      if (row[j] >= 0) ++c;
    b->cnt0[i] = c;
  }
  b->links_upper.resize(n);
  b->cnt_upper.resize(n);
  size_t off = 0;
  for (int64_t i = 0; i < n; ++i) {
    int lv = node_level[i];
    b->links_upper[i].assign(upper_flat + off, upper_flat + off + size_t(lv) * M);
    off += size_t(lv) * M;
    b->cnt_upper[i].resize(lv);
    for (int l = 0; l < lv; ++l) {
      int c = 0;
      for (int j = 0; j < M; ++j)
        if (b->links_upper[i][size_t(l) * M + j] >= 0) ++c;
      b->cnt_upper[i][l] = c;
    }
  }
  b->max_level = max_level;
  b->entry_point = entry_point;
  for (int64_t i = 0; i < n; ++i) b->label_to_id.emplace(labels[i], uint32_t(i));
  return b;
}

static thread_local VisitedSet tls_visited;

int hnsw_search(HnswBuilder* b, const float* q, int k, int ef,
                int64_t* out_labels, float* out_dists) {
  return b->search(q, k, ef, out_labels, out_dists, nullptr, &tls_visited);
}

// Filtered search: `eligible` is a per-internal-id mask (1 = allowed), the
// CPU parity oracle for the device path's BaseFilterFunctor mask
// (hnswlib/hnswlib.h:128-132, hnswalg.h:1271).
int hnsw_search_filtered(HnswBuilder* b, const float* q, int k, int ef,
                         const uint8_t* eligible, int64_t* out_labels,
                         float* out_dists) {
  return b->search(q, k, ef, out_labels, out_dists, eligible, &tls_visited);
}

void hnsw_search_batch_filtered(HnswBuilder* b, const float* qs, int64_t nq,
                                int k, int ef, const uint8_t* eligible,
                                int64_t* out_labels, float* out_dists,
                                int32_t* out_counts) {
  for (int64_t i = 0; i < nq; ++i) {
    out_counts[i] = b->search(qs + size_t(i) * b->dim, k, ef,
                              out_labels + size_t(i) * k,
                              out_dists + size_t(i) * k, eligible,
                              &tls_visited);
  }
}

int hnsw_add_replace(HnswBuilder* b, const float* vec, int64_t label) {
  return b->insert_replace(vec, label);
}

// --- incremental device sync (dirty-row deltas) -----------------------------

int64_t hnsw_dirty_count(HnswBuilder* b) {
  std::lock_guard<std::mutex> g(b->dirty_mutex);
  return int64_t(b->dirty_list.size());
}

// bit 0: upper levels / entry point changed; bit 1: in-place vector update
// happened (caller must full-resync).
int hnsw_dirty_flags(HnswBuilder* b) {
  return (b->upper_dirty.load() ? 1 : 0) | (b->full_dirty.load() ? 2 : 0);
}

// Copy the dirty-node list into `out` (caller sized it from
// hnsw_dirty_count) and clear all dirty state.
void hnsw_take_dirty(HnswBuilder* b, int32_t* out) {
  std::lock_guard<std::mutex> g(b->dirty_mutex);
  std::memcpy(out, b->dirty_list.data(),
              b->dirty_list.size() * sizeof(int32_t));
  std::fill(b->dirty0.begin(), b->dirty0.end(), 0);
  b->dirty_list.clear();
  b->upper_dirty = false;
  b->full_dirty = false;
}

void hnsw_clear_dirty(HnswBuilder* b) { b->clear_dirty(); }

// Pending in-place vector updates: flush merges their level-0 in-neighbors
// into the dirty-row list (call BEFORE hnsw_dirty_count / hnsw_take_dirty)
// and returns the pending-update count; take copies the updated ids and
// clears the vec-dirty state.
int64_t hnsw_flush_updates(HnswBuilder* b) { return b->flush_updates(); }

void hnsw_take_vec_dirty(HnswBuilder* b, int32_t* out) {
  std::lock_guard<std::mutex> g(b->dirty_mutex);
  std::memcpy(out, b->vec_dirty_list.data(),
              b->vec_dirty_list.size() * sizeof(int32_t));
  std::fill(b->vec_dirty0.begin(), b->vec_dirty0.end(), 0);
  b->vec_dirty_list.clear();
}

void hnsw_export_vectors_rows(HnswBuilder* b, const int32_t* ids, int64_t k,
                              float* out) {
  for (int64_t i = 0; i < k; ++i) {
    std::memcpy(out + i * b->dim,
                b->data.data() + size_t(uint32_t(ids[i])) * b->dim,
                size_t(b->dim) * sizeof(float));
  }
}

void hnsw_export_level0_rows(HnswBuilder* b, const int32_t* ids, int64_t k,
                             int32_t* out) {
  for (int64_t i = 0; i < k; ++i) {
    std::memcpy(out + i * b->maxM0,
                b->links0.data() + size_t(uint32_t(ids[i])) * b->maxM0,
                b->maxM0 * sizeof(int32_t));
  }
}

void hnsw_export_vectors_range(HnswBuilder* b, int64_t start, int64_t count,
                               float* out) {
  std::memcpy(out, b->data.data() + size_t(start) * b->dim,
              size_t(count) * b->dim * sizeof(float));
}

void hnsw_export_labels_range(HnswBuilder* b, int64_t start, int64_t count,
                              int64_t* out) {
  std::memcpy(out, b->labels.data() + start, size_t(count) * sizeof(int64_t));
}

// Streaming `.adj` export (format: index_builder/build.cpp:14-21, writer
// semantics of export_adjacency 22-107): one buffered pass over the graph.
// The numpy writer needs ~27s at 1M on this host; this is <1s.
int hnsw_export_adj(HnswBuilder* b, const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  std::vector<char> io_buf(1 << 20);
  setvbuf(f, io_buf.data(), _IOFBF, io_buf.size());
  uint32_t hdr[3] = {uint32_t(std::max(b->entry_point, 0)),
                     uint32_t(std::max(b->max_level, 0)), uint32_t(b->n)};
  fwrite(hdr, 4, 3, f);
  std::vector<uint32_t> rec;
  for (size_t i = 0; i < b->n; ++i) {
    rec.clear();
    rec.push_back(uint32_t(uint64_t(b->labels[i]) & 0xFFFFFFFFu));
    int lv = b->node_level[i];
    rec.push_back(uint32_t(lv + 1));
    for (int l = 0; l <= lv; ++l) {
      int cnt;
      const int32_t* nb = b->neighbors(uint32_t(i), l, &cnt);
      rec.push_back(uint32_t(cnt));
      for (int j = 0; j < cnt; ++j) rec.push_back(uint32_t(nb[j]));
    }
    if (fwrite(rec.data(), 4, rec.size(), f) != rec.size()) {
      fclose(f);
      return -1;
    }
  }
  return fclose(f) == 0 ? 0 : -1;
}

// Batched single-thread search (for baseline QPS measurement).
void hnsw_search_batch(HnswBuilder* b, const float* qs, int64_t nq, int k,
                       int ef, int64_t* out_labels, float* out_dists,
                       int32_t* out_counts) {
  for (int64_t i = 0; i < nq; ++i) {
    out_counts[i] = b->search(qs + size_t(i) * b->dim, k, ef,
                              out_labels + size_t(i) * k,
                              out_dists + size_t(i) * k, nullptr,
                              &tls_visited);
  }
}

}  // extern "C"
