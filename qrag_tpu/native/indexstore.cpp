// indexstore — native host-side vector store + exact scan.
//
// The reference delegated its on-disk index and flat scan to faiss-cpu's
// C++ (mcp/server/tools/store_in_faiss.py:105 builds IndexFlatL2 and the
// library does the heavy lifting).  This is the rebuild's native
// counterpart for the HOST side of the system: an mmap-backed,
// append-only vector store with a binary manifest header, plus an exact
// L2/IP scan + top-k heap used as (a) the CPU oracle for kernel parity
// tests and (b) the retrieval fallback where no accelerator exists.
// The device compute path (XLA / Pallas) remains the production scan; this
// file is the runtime/IO layer around it.
//
// File layout (little-endian):
//   header (64 bytes):
//     magic   "QIDX"            4
//     version u32               4
//     d       u32               4
//     metric  u32  (0=ip,1=l2)  4
//     ntotal  u64               8
//     capacity u64              8  (rows allocated in the file)
//     normalized u32            4
//     reserved               28
//   data: capacity * d * f32 row-major
//
// Concurrency contract: single writer, multiple readers (the reference
// had unguarded read-modify-write of its index file — SURVEY.md §5
// "race detection"; here appends are in-place + a single ntotal header
// store with release semantics, so readers never see torn rows).
// A handle is NOT thread-safe: share the file across threads/processes
// by giving each its own qidx_open handle.  Readers lazily remap when
// the writer has grown the file past their mapping (ensure_mapped):
// the writer's ftruncate happens-before its release-store of ntotal,
// so any reader that observed the new ntotal will find the file large
// enough when it re-stats.
//
// Build: make -C qrag_tpu/native   (g++ -O3 -shared; no deps)

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

static const uint32_t QIDX_VERSION = 1;
static const uint64_t HEADER_BYTES = 64;

struct Header {
  char magic[4];
  uint32_t version;
  uint32_t d;
  uint32_t metric;
  uint64_t ntotal;
  uint64_t capacity;
  uint32_t normalized;
  char reserved[28];
};

struct Store {
  int fd;
  uint8_t* map;
  uint64_t map_bytes;
  Header* header;
  float* data;
  int writable;
};

static uint64_t file_bytes_for(uint32_t d, uint64_t capacity) {
  return HEADER_BYTES + (uint64_t)d * capacity * sizeof(float);
}

static int remap(Store* s, uint64_t new_bytes) {
  if (s->map) munmap(s->map, s->map_bytes);
  s->map = (uint8_t*)mmap(nullptr, new_bytes,
                          s->writable ? (PROT_READ | PROT_WRITE) : PROT_READ,
                          MAP_SHARED, s->fd, 0);
  if (s->map == MAP_FAILED) {
    s->map = nullptr;
    return -1;
  }
  s->map_bytes = new_bytes;
  s->header = (Header*)s->map;
  s->data = (float*)(s->map + HEADER_BYTES);
  return 0;
}

// open-or-create (the open-or-create+append semantics of the
// reference's store tool, done safely).  Returns handle or null.
Store* qidx_open(const char* path, uint32_t d, uint32_t metric,
                 uint32_t normalized, int writable) {
  Store* s = new Store();
  std::memset(s, 0, sizeof(Store));
  s->writable = writable;
  int flags = writable ? (O_RDWR | O_CREAT) : O_RDONLY;
  s->fd = open(path, flags, 0644);
  if (s->fd < 0) { delete s; return nullptr; }
  struct stat st;
  fstat(s->fd, &st);
  if (st.st_size == 0) {
    if (!writable) { close(s->fd); delete s; return nullptr; }
    uint64_t cap = 1024;
    if (ftruncate(s->fd, file_bytes_for(d, cap)) != 0) {
      close(s->fd); delete s; return nullptr;
    }
    if (remap(s, file_bytes_for(d, cap)) != 0) {
      close(s->fd); delete s; return nullptr;
    }
    std::memcpy(s->header->magic, "QIDX", 4);
    s->header->version = QIDX_VERSION;
    s->header->d = d;
    s->header->metric = metric;
    s->header->ntotal = 0;
    s->header->capacity = cap;
    s->header->normalized = normalized;
  } else {
    if (remap(s, (uint64_t)st.st_size) != 0) {
      close(s->fd); delete s; return nullptr;
    }
    if (std::memcmp(s->header->magic, "QIDX", 4) != 0 ||
        s->header->version != QIDX_VERSION ||
        (d != 0 && s->header->d != d)) {  // d=0 means "accept existing"
      munmap(s->map, s->map_bytes); close(s->fd); delete s; return nullptr;
    }
  }
  return s;
}

// Grow this handle's mapping to cover need_bytes of the (possibly
// writer-grown) file.  Readers call this before dereferencing past
// their original mapping — the round-1 reader-growth SIGSEGV fix: a
// reader's map length was fixed at open while the writer published a
// larger ntotal, so qidx_read bounds-checked against ntotal but then
// dereferenced past map_bytes.
static int ensure_mapped(Store* s, uint64_t need_bytes) {
  if (need_bytes <= s->map_bytes) return 0;
  struct stat st;
  if (fstat(s->fd, &st) != 0) return -1;
  if ((uint64_t)st.st_size < need_bytes) return -1;
  return remap(s, (uint64_t)st.st_size);
}

uint32_t qidx_dim(Store* s) { return s->header->d; }
uint32_t qidx_metric(Store* s) { return s->header->metric; }
uint32_t qidx_normalized(Store* s) { return s->header->normalized; }
uint64_t qidx_ntotal(Store* s) {
  return std::atomic_ref<uint64_t>(s->header->ntotal).load(
      std::memory_order_acquire);
}

// Append rows.  Single-writer: grows the file geometrically, copies
// rows, then publishes the new ntotal with a release store so
// concurrent readers never observe partially-written rows.
int64_t qidx_append(Store* s, const float* rows, uint64_t n) {
  if (!s->writable) return -1;
  uint32_t d = s->header->d;
  uint64_t ntotal = s->header->ntotal;
  uint64_t need = ntotal + n;
  if (need > s->header->capacity) {
    uint64_t cap = s->header->capacity;
    while (cap < need) cap *= 2;
    if (ftruncate(s->fd, file_bytes_for(d, cap)) != 0) return -1;
    if (remap(s, file_bytes_for(d, cap)) != 0) return -1;
    s->header->capacity = cap;
  }
  std::memcpy(s->data + ntotal * d, rows, n * d * sizeof(float));
  std::atomic_ref<uint64_t>(s->header->ntotal)
      .store(need, std::memory_order_release);
  return (int64_t)need;
}

// Zero-copy-ish read: copies [start, start+n) rows into out.
int qidx_read(Store* s, uint64_t start, uint64_t n, float* out) {
  uint64_t ntotal = qidx_ntotal(s);
  if (start + n > ntotal) return -1;
  uint32_t d = s->header->d;
  if (ensure_mapped(s, file_bytes_for(d, start + n)) != 0) return -1;
  std::memcpy(out, s->data + start * (uint64_t)d,
              n * (uint64_t)d * sizeof(float));
  return 0;
}

int qidx_flush(Store* s) {
  return msync(s->map, s->map_bytes, MS_SYNC);
}

void qidx_close(Store* s) {
  if (!s) return;
  if (s->map) munmap(s->map, s->map_bytes);
  if (s->fd >= 0) close(s->fd);
  delete s;
}

// ---------------------------------------------------------------- scan

// Exact scan + top-k over the store (or any raw matrix).
// metric: 0=ip (descending), 1=l2 (ascending squared distances).
// Results are written as (b, k) scores + int64 indices, sorted, padded
// with score=+-inf / idx=-1 when ntotal < k.  Tie-break: lower index
// first (matches lax.top_k / the Pallas kernel).  `base` offsets the
// emitted indices (corpus-split threading scans sub-ranges).
// Single dot kernel shared by the scan and the clustered search: the
// exactness/tie contract between them depends on BITWISE-identical
// accumulation, so there is exactly one copy of this loop.
static inline float dotf(const float* a, const float* b_, uint32_t d) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  uint32_t j = 0;
  for (; j + 4 <= d; j += 4) {
    a0 += a[j] * b_[j];
    a1 += a[j + 1] * b_[j + 1];
    a2 += a[j + 2] * b_[j + 2];
    a3 += a[j + 3] * b_[j + 3];
  }
  float dot = a0 + a1 + a2 + a3;
  for (; j < d; ++j) dot += a[j] * b_[j];
  return dot;
}

// xsq_pre: optional precomputed row sqnorms (l2) — the clustered
// fallback already holds them; nullptr recomputes locally.
static void scan_topk(const float* x, uint64_t n, uint32_t d,
                      const float* q, uint64_t b, uint32_t k,
                      uint32_t metric, float* out_scores,
                      int64_t* out_idx, uint64_t base = 0,
                      const float* xsq_pre = nullptr) {
  std::vector<float> xsq_own;
  const float* xsq = xsq_pre;
  if (metric == 1 && xsq == nullptr) {
    xsq_own.resize(n);
    for (uint64_t i = 0; i < n; ++i) {
      const float* row = x + i * d;
      float acc = 0.f;
      for (uint32_t j = 0; j < d; ++j) acc += row[j] * row[j];
      xsq_own[i] = acc;
    }
    xsq = xsq_own.data();
  }
  for (uint64_t bi = 0; bi < b; ++bi) {
    const float* qq = q + bi * d;
    float qsq = 0.f;
    if (metric == 1)
      for (uint32_t j = 0; j < d; ++j) qsq += qq[j] * qq[j];
    // max-goodness selection on (-d2 | ip); min-heap of size k keyed by
    // (goodness, -index) so ties keep the LOWER index.
    typedef std::pair<float, int64_t> Entry;  // (goodness, -index)
    std::vector<Entry> heap;
    heap.reserve(k + 1);
    auto cmp = [](const Entry& a, const Entry& b_) { return a > b_; };
    for (uint64_t i = 0; i < n; ++i) {
      float dot = dotf(x + i * d, qq, d);  // dotf: one shared kernel
      float g = (metric == 1) ? (2.f * dot - qsq - xsq[i]) : dot;
      Entry e(g, -(int64_t)(base + i));
      if (heap.size() < k) {
        heap.push_back(e);
        std::push_heap(heap.begin(), heap.end(), cmp);
      } else if (e > heap.front()) {
        std::pop_heap(heap.begin(), heap.end(), cmp);
        heap.back() = e;
        std::push_heap(heap.begin(), heap.end(), cmp);
      }
    }
    std::sort_heap(heap.begin(), heap.end(), cmp);  // descending goodness
    for (uint32_t r = 0; r < k; ++r) {
      if (r < heap.size()) {
        float g = heap[r].first;
        out_scores[bi * k + r] =
            (metric == 1) ? std::max(0.f, -g) : g;
        out_idx[bi * k + r] = -heap[r].second;
      } else {
        out_scores[bi * k + r] =
            (metric == 1) ? __builtin_inff() : -__builtin_inff();
        out_idx[bi * k + r] = -1;
      }
    }
  }
}

void qidx_scan_topk(Store* s, const float* q, uint64_t b, uint32_t k,
                    float* out_scores, int64_t* out_idx) {
  uint64_t ntotal = qidx_ntotal(s);
  if (ensure_mapped(s, file_bytes_for(s->header->d, ntotal)) != 0) {
    // unreachable under the single-writer contract; degrade to the
    // rows this handle can still see rather than crash
    ntotal = (s->map_bytes - HEADER_BYTES) /
             ((uint64_t)s->header->d * sizeof(float));
  }
  scan_topk(s->data, ntotal, s->header->d, q, b, k,
            s->header->metric, out_scores, out_idx);
}

void qidx_raw_scan_topk(const float* x, uint64_t n, uint32_t d,
                        const float* q, uint64_t b, uint32_t k,
                        uint32_t metric, float* out_scores,
                        int64_t* out_idx) {
  scan_topk(x, n, d, q, b, k, metric, out_scores, out_idx);
}

// ------------------------------------------------------ threaded scan

// Merge T per-thread (k) candidate lists for one query into the final
// (k).  Scores are already finalized (l2: ascending distances); the
// comparator mirrors scan_topk's ordering incl. the lower-index
// tie-break, and padding slots (idx = -1) sort last naturally.
static void merge_candidates(const float* scores, const int64_t* idx,
                             uint32_t t, uint32_t k, uint32_t metric,
                             float* out_scores, int64_t* out_idx) {
  std::vector<std::pair<float, int64_t>> all;
  all.reserve((size_t)t * k);
  for (uint32_t ti = 0; ti < t; ++ti)
    for (uint32_t r = 0; r < k; ++r)
      all.emplace_back(scores[ti * k + r], idx[ti * k + r]);
  auto better = [metric](const std::pair<float, int64_t>& a,
                         const std::pair<float, int64_t>& b_) {
    bool a_pad = a.second < 0, b_pad = b_.second < 0;
    if (a_pad != b_pad) return b_pad;  // real entries first
    if (a.first != b_.first)
      return metric == 1 ? a.first < b_.first : a.first > b_.first;
    return a.second < b_.second;  // lower index wins ties
  };
  std::sort(all.begin(), all.end(), better);
  for (uint32_t r = 0; r < k; ++r) {
    out_scores[r] = all[r].first;
    out_idx[r] = all[r].second;
  }
}

// Multithreaded exact scan: query-parallel when b >= threads (each
// thread owns a query slice — zero synchronization), otherwise
// corpus-split (each thread scans a row range with globalized indices,
// per-query k-way merge at the end).  The single-threaded path stays
// the deterministic oracle; this is the serving-scale variant of the
// host runtime (the role faiss-cpu's OpenMP scan played).
void qidx_raw_scan_topk_mt(const float* x, uint64_t n, uint32_t d,
                           const float* q, uint64_t b, uint32_t k,
                           uint32_t metric, uint32_t n_threads,
                           float* out_scores, int64_t* out_idx) {
  if (n_threads == 0)
    n_threads = std::max(1u, std::thread::hardware_concurrency());
  // never more threads than useful work units in the chosen mode
  uint64_t max_units = std::max<uint64_t>(b, n / 4096);
  n_threads = (uint32_t)std::min<uint64_t>(n_threads,
                                           std::max<uint64_t>(max_units, 1));
  if (n_threads <= 1 || n == 0) {
    scan_topk(x, n, d, q, b, k, metric, out_scores, out_idx);
    return;
  }
  if (b >= n_threads) {
    std::vector<std::thread> pool;
    uint64_t per = (b + n_threads - 1) / n_threads;
    for (uint32_t ti = 0; ti < n_threads; ++ti) {
      uint64_t s = ti * per, e = std::min(b, s + per);
      if (s >= e) break;
      pool.emplace_back([=] {
        scan_topk(x, n, d, q + s * d, e - s, k, metric,
                  out_scores + s * k, out_idx + s * k);
      });
    }
    for (auto& th : pool) th.join();
    return;
  }
  // corpus-split: T threads over row ranges, then per-query merge
  uint32_t t = n_threads;
  std::vector<float> part_scores((size_t)t * b * k);
  std::vector<int64_t> part_idx((size_t)t * b * k);
  std::vector<std::thread> pool;
  uint64_t per = (n + t - 1) / t;
  for (uint32_t ti = 0; ti < t; ++ti) {
    uint64_t s = ti * per, e = std::min(n, s + per);
    pool.emplace_back([=, &part_scores, &part_idx] {
      if (s < e)
        scan_topk(x + s * d, e - s, d, q, b, k, metric,
                  part_scores.data() + (size_t)ti * b * k,
                  part_idx.data() + (size_t)ti * b * k, s);
      else
        for (uint64_t j = 0; j < b * (uint64_t)k; ++j) {
          part_scores[(size_t)ti * b * k + j] =
              (metric == 1) ? __builtin_inff() : -__builtin_inff();
          part_idx[(size_t)ti * b * k + j] = -1;
        }
    });
  }
  for (auto& th : pool) th.join();
  // gather each query's t candidate lists (strided by b*k per thread)
  std::vector<float> qs((size_t)t * k);
  std::vector<int64_t> qi((size_t)t * k);
  for (uint64_t bi = 0; bi < b; ++bi) {
    for (uint32_t ti = 0; ti < t; ++ti) {
      std::memcpy(qs.data() + (size_t)ti * k,
                  part_scores.data() + ((size_t)ti * b + bi) * k,
                  k * sizeof(float));
      std::memcpy(qi.data() + (size_t)ti * k,
                  part_idx.data() + ((size_t)ti * b + bi) * k,
                  k * sizeof(int64_t));
    }
    merge_candidates(qs.data(), qi.data(), t, k, metric,
                     out_scores + bi * k, out_idx + bi * k);
  }
}

void qidx_scan_topk_mt(Store* s, const float* q, uint64_t b, uint32_t k,
                       uint32_t n_threads, float* out_scores,
                       int64_t* out_idx) {
  uint64_t ntotal = qidx_ntotal(s);
  if (ensure_mapped(s, file_bytes_for(s->header->d, ntotal)) != 0) {
    ntotal = (s->map_bytes - HEADER_BYTES) /
             ((uint64_t)s->header->d * sizeof(float));
  }
  qidx_raw_scan_topk_mt(s->data, ntotal, s->header->d, q, b, k,
                        s->header->metric, n_threads, out_scores, out_idx);
}

// --------------------------------------------- cluster-pruned search

// Host-tier twin of ops/cluster_topk.py (the device design at the C++
// tier — faiss-cpu's IVF role, but PROVABLY EXACT): per-cluster
// centroid/radius upper bounds certify which clusters can hold top-k
// rows; only those are scored.  Certify -> 4x-budget escalation ->
// full-scan fallback; exactness is unconditional, clustering quality
// only sets the pruning rate.  Scoring/tie semantics are scan_topk's
// (float accumulation, lower index wins ties); the margins cover the
// float evaluation drift the same way the device op's _acc_rel does.

// relative error bound of one float reduction over d terms (d * eps
// with headroom — mirrors cluster_topk._acc_rel's role, sized for the
// float accumulation this file uses)
static inline float host_acc_rel(uint32_t d) { return 2.0e-7f * (float)d; }

// One certification tier for one query.  Returns true when the
// certificate held; the (k)-heap results land in out (sorted).
static bool cluster_tier(const float* x, const float* xsq, uint32_t d,
                         const int32_t* order, const int64_t* goff,
                         const float* cent, const float* csq,
                         const float* radii, const float* mxn, uint32_t G,
                         const float* qq, float qsq, uint32_t k,
                         uint32_t metric, uint32_t S,
                         const float* ub,  // (G) precomputed bounds
                         float* out_scores, int64_t* out_idx) {
  // exact top-S clusters by upper bound (ties: lower cluster id)
  std::vector<uint32_t> gids(G);
  for (uint32_t g = 0; g < G; ++g) gids[g] = g;
  if (S < G)
    std::nth_element(gids.begin(), gids.begin() + S, gids.end(),
                     [&](uint32_t a, uint32_t b_) {
                       if (ub[a] != ub[b_]) return ub[a] > ub[b_];
                       return a < b_;
                     });
  uint32_t sel = std::min<uint32_t>(S, G);

  typedef std::pair<float, int64_t> Entry;  // (goodness, -index)
  std::vector<Entry> heap;
  heap.reserve(k + 1);
  auto cmp = [](const Entry& a, const Entry& b_) { return a > b_; };
  for (uint32_t si = 0; si < sel; ++si) {
    uint32_t g = gids[si];
    for (int64_t p = goff[g]; p < goff[g + 1]; ++p) {
      int64_t i = order[p];
      float dot = dotf(x + (uint64_t)i * d, qq, d);
      float gd = (metric == 1) ? (2.f * dot - qsq - xsq[i]) : dot;
      Entry e(gd, -i);
      if (heap.size() < k) {
        heap.push_back(e);
        std::push_heap(heap.begin(), heap.end(), cmp);
      } else if (e > heap.front()) {
        std::pop_heap(heap.begin(), heap.end(), cmp);
        heap.back() = e;
        std::push_heap(heap.begin(), heap.end(), cmp);
      }
    }
  }
  if (heap.size() < k) return false;  // degenerate: fewer than k rows
  float thr = heap.front().first;     // k-th best goodness
  // cert: every cluster whose bound clears thr must be selectable
  // within S (count <= S implies the exact top-S selection covers it)
  uint32_t count = 0;
  for (uint32_t g = 0; g < G; ++g)
    if (ub[g] >= thr && ++count > S) return false;

  std::sort_heap(heap.begin(), heap.end(), cmp);
  for (uint32_t r = 0; r < k; ++r) {
    float gd = heap[r].first;
    out_scores[r] = (metric == 1) ? std::max(0.f, -gd) : gd;
    out_idx[r] = -heap[r].second;
  }
  return true;
}

// metric: 0=ip, 1=l2.  order/goff describe variable-size clusters
// (goff has G+1 entries into order); cent/csq/radii/mxn are the
// per-cluster stats (radii and mxn pre-inflated by the caller for
// the float rounding of computing them).  out_stats (2): per-query
// fallback count, escalation count.
void qidx_raw_cluster_topk(const float* x, uint64_t n, uint32_t d,
                           const float* xsq, const int32_t* order,
                           const int64_t* goff, const float* cent,
                           const float* csq, const float* radii,
                           const float* mxn, uint32_t G, const float* q,
                           uint64_t b, uint32_t k, uint32_t metric,
                           uint32_t budget, float* out_scores,
                           int64_t* out_idx, uint32_t* out_stats) {
  out_stats[0] = out_stats[1] = 0;
  if (k == 0) return;  // (b, 0) outputs: nothing to write
  // the clustered tiers cover exactly the rows the structure indexes
  // (goff[G] entries of order); the fallback must scan the SAME
  // coverage, not a possibly-newer live ntotal — one batch must never
  // mix two corpus snapshots (certified queries on the old rows next
  // to fallback queries seeing appended rows)
  const uint64_t n_cov = std::min<uint64_t>(n, (uint64_t)goff[G]);
  const float accrel = host_acc_rel(d);
  std::vector<float> ub(G);
  for (uint64_t bi = 0; bi < b; ++bi) {
    const float* qq = q + bi * d;
    float qsq = dotf(qq, qq, d);
    float qn = std::sqrt(std::max(qsq, 0.f));
    // per-cluster goodness upper bounds (triangle inequality +
    // float-drift margins — the host mirror of _group_upper_bounds)
    for (uint32_t g = 0; g < G; ++g) {
      float qc = dotf(qq, cent + (uint64_t)g * d, d);
      float cn = std::sqrt(std::max(csq[g], 0.f));
      float e_qc = accrel * qn * cn;
      if (metric == 1) {
        float refine_m =
            2.f * accrel * qn * mxn[g] + accrel * (qsq + mxn[g] * mxn[g]);
        float d2 = qsq + csq[g] - 2.f * qc;
        float e2 = 1.25f * (2.f * e_qc + accrel * (qsq + csq[g]));
        float dlb = std::sqrt(std::max(d2 - e2, 0.f));
        float dist = std::max(dlb - radii[g], 0.f);
        ub[g] = -(dist * dist) + refine_m;
      } else {
        ub[g] = qc + 1.25f * e_qc + qn * radii[g] + accrel * qn * mxn[g];
      }
      if (goff[g + 1] <= goff[g]) ub[g] = -__builtin_inff();  // empty
    }
    float* os = out_scores + bi * k;
    int64_t* oi = out_idx + bi * k;
    uint32_t S1 = std::max(budget, k);
    if (cluster_tier(x, xsq, d, order, goff, cent, csq, radii, mxn, G,
                     qq, qsq, k, metric, S1, ub.data(), os, oi))
      continue;
    out_stats[1]++;  // tier-1 failed -> escalate
    uint32_t S2 = std::min<uint32_t>(4 * S1, G);
    if (S2 > S1 &&
        cluster_tier(x, xsq, d, order, goff, cent, csq, radii, mxn, G,
                     qq, qsq, k, metric, S2, ub.data(), os, oi))
      continue;
    out_stats[0]++;  // exact full-scan backstop (scan_topk semantics)
    scan_topk(x, n_cov, d, qq, 1, k, metric, os, oi, 0, xsq);
  }
}

// Query-parallel MT variant (each thread owns a query slice — zero
// synchronization; per-thread stats summed at the end).  Results are
// identical to the single-thread form: per-query work is independent.
void qidx_raw_cluster_topk_mt(const float* x, uint64_t n, uint32_t d,
                              const float* xsq, const int32_t* order,
                              const int64_t* goff, const float* cent,
                              const float* csq, const float* radii,
                              const float* mxn, uint32_t G,
                              const float* q, uint64_t b, uint32_t k,
                              uint32_t metric, uint32_t budget,
                              uint32_t n_threads, float* out_scores,
                              int64_t* out_idx, uint32_t* out_stats) {
  if (n_threads == 0)
    n_threads = std::max(1u, std::thread::hardware_concurrency());
  n_threads = (uint32_t)std::min<uint64_t>(n_threads, std::max<uint64_t>(b, 1));
  if (n_threads <= 1) {
    qidx_raw_cluster_topk(x, n, d, xsq, order, goff, cent, csq, radii,
                          mxn, G, q, b, k, metric, budget, out_scores,
                          out_idx, out_stats);
    return;
  }
  std::vector<uint32_t> part_stats((size_t)n_threads * 2, 0);
  std::vector<std::thread> pool;
  uint64_t per = (b + n_threads - 1) / n_threads;
  for (uint32_t ti = 0; ti < n_threads; ++ti) {
    uint64_t s = ti * per, e = std::min(b, s + per);
    if (s >= e) break;
    pool.emplace_back([=, &part_stats] {
      qidx_raw_cluster_topk(x, n, d, xsq, order, goff, cent, csq,
                            radii, mxn, G, q + s * d, e - s, k, metric,
                            budget, out_scores + s * k, out_idx + s * k,
                            part_stats.data() + (size_t)ti * 2);
    });
  }
  for (auto& th : pool) th.join();
  out_stats[0] = out_stats[1] = 0;
  for (uint32_t ti = 0; ti < n_threads; ++ti) {
    out_stats[0] += part_stats[(size_t)ti * 2];
    out_stats[1] += part_stats[(size_t)ti * 2 + 1];
  }
}

// Store-backed variant: searches the mmap'd rows in place (no host
// copy); metric comes from the store header.
void qidx_cluster_topk(Store* s, const float* xsq, const int32_t* order,
                       const int64_t* goff, const float* cent,
                       const float* csq, const float* radii,
                       const float* mxn, uint32_t G, const float* q,
                       uint64_t b, uint32_t k, uint32_t budget,
                       float* out_scores, int64_t* out_idx,
                       uint32_t* out_stats) {
  uint64_t ntotal = qidx_ntotal(s);
  if (ensure_mapped(s, file_bytes_for(s->header->d, ntotal)) != 0) {
    ntotal = (s->map_bytes - HEADER_BYTES) /
             ((uint64_t)s->header->d * sizeof(float));
  }
  qidx_raw_cluster_topk(s->data, ntotal, s->header->d, xsq, order, goff,
                        cent, csq, radii, mxn, G, q, b, k,
                        s->header->metric, budget, out_scores, out_idx,
                        out_stats);
}

}  // extern "C"
