// Affinity-graph watershed + hierarchical mean-affinity agglomeration.
// The port's copy of chunkflow_tpu/native/src/watershed.cpp, the native
// equivalent of the waterz wheel used by the reference's
// agglomerate plugin (chunkflow/plugins/agglomerate.py:35-43): turn a
// 3-channel zyx affinity map into a segmentation. Priority-queue region
// merging is inherently sequential — host-side by design.
//
// Algorithm:
//  1. seeds: connected components of the graph restricted to edges with
//     affinity >= t_high (strongly-connected cores);
//  2. fragments: steepest-ascent watershed (Zlateski/Seung zwatershed
//     semantics — the fragment algorithm behind the reference's waterz
//     wheel): edges below t_low are removed, every voxel computes its
//     best surviving incident affinity, and each surviving edge that is
//     the steepest edge of either endpoint is contracted. Voxels with no
//     surviving edge stay background (0). Order-independent linear
//     passes, no queue — measured 0.4 s vs 18.8 s for a priority-flood
//     at 64x512x512, with equal quality-harness ARI/VOI (the flood
//     variant was deleted per the measured-winner rule; history in git).
//     Tie semantics (canonical zwatershed): ALL tied steepest edges
//     contract, so a constant-affinity plateau becomes one fragment and
//     can bridge seed cores it touches — measured harmless on
//     uint8-quantized realistic fixtures (ARI 1.0,
//     tests/test_native.py::TestAgglomerationQuality::test_quantized_...)
//     and pinned as documented behavior by ::test_plateau_merges_as_one.
//  3. agglomerate: region adjacency graph scored by mean affinity of
//     boundary edges; hierarchical greedy merging (highest current score
//     first) with full boundary-statistic rescoring after every merge —
//     the waterz semantics. Rescoring is what keeps noisy small boundary
//     patches from chain-merging distinct objects: a tiny high-variance
//     boundary that scores above threshold pre-merge is re-evaluated
//     against the COMBINED boundary after its region grows (single-shot
//     scoring measured ARI 0.03 on a dropout-noise fixture vs 0.9+ with
//     rescoring — tests/test_native.py TestAgglomerationQuality).
//
// Parallelism (VERDICT r4 #3): phases 1-2 and RAG accumulation are
// linear edge scans, threaded over contiguous z-slabs. Within-slab
// edges touch only within-slab union-find entries / best[] entries, so
// slabs are data-race free; the z-edges crossing slab boundaries (one
// plane per seam) are stitched sequentially after the join. The slab
// partition is a pure function of (sz, thread count), and per-pair RAG
// sums are combined in slab order, so results are deterministic for a
// fixed CHUNKFLOW_NATIVE_THREADS. The phase-3 merge loop itself stays
// sequential (priority-queue semantics), but its region graph is a flat
// open-addressing pair map + CSR neighbor lists instead of per-region
// std::map trees — measured 67.9 s -> 18.2 s single-threaded on the
// 2.8M-fragment worst case (uniform-random affinities, t_low ~ 0),
// with the realistic 600-object fixture at 10.4 Mvox/s (1.6 s).
#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <queue>
#include <utility>
#include <vector>

#include "zslab.h"

// first-encounter label compaction shared with the Python renumber API
// (defined in remap.cpp, same shared library)
extern "C" int64_t cf_renumber_u32(const uint32_t* in, uint32_t* out,
                                   int64_t n, uint64_t start_id,
                                   uint64_t* keys, uint64_t* vals,
                                   int64_t max_pairs);

namespace {

using chunkflow::UnionFind;
using chunkflow::run_slabs;
using chunkflow::slab_bounds;
using chunkflow::thread_count;

// CHUNKFLOW_WATERSHED_TIMING=1: phase timings on stderr (perf diagnosis)
struct PhaseTimer {
  const bool on = std::getenv("CHUNKFLOW_WATERSHED_TIMING") != nullptr;
  std::chrono::steady_clock::time_point t = std::chrono::steady_clock::now();
  void lap(const char* name) {
    if (!on) return;
    const auto now = std::chrono::steady_clock::now();
    std::fprintf(stderr, "[watershed] %s: %.2fs\n", name,
                 std::chrono::duration<double>(now - t).count());
    t = now;
  }
};

// Flat open-addressing map from a canonical region pair (lo<<32|hi, both
// >= 1 so key is never 0) to boundary statistics. Linear probing with
// backward-shift deletion: the merge loop erases one entry per moved
// boundary, and tombstones would degrade probe lengths over millions of
// merges.
// Boundary statistics per region pair. The default (mean scoring)
// carries only sum/count; max/min scoring instantiates the extended
// stat — keeping the hot mean path's table entries 8 bytes smaller
// (measured ~6% realistic / ~35% pathological end-to-end when extrema
// tracking was unconditionally in the one struct).
struct PairStat {
  static constexpr bool kExtrema = false;
  static constexpr bool kHistogram = false;
  uint64_t key = 0;  // 0 = empty
  double sum = 0.0;
  int64_t cnt = 0;
  void absorb_edge(float e) {
    sum += e;
    cnt += 1;
  }
  void absorb(const PairStat& o) {
    sum += o.sum;
    cnt += o.cnt;
  }
};

struct PairStatEx {
  static constexpr bool kExtrema = true;
  static constexpr bool kHistogram = false;
  uint64_t key = 0;  // 0 = empty
  double sum = 0.0;
  int64_t cnt = 0;
  float mx = -std::numeric_limits<float>::infinity();
  float mn = std::numeric_limits<float>::infinity();
  void absorb_edge(float e) {
    sum += e;
    cnt += 1;
    if (e > mx) mx = e;
    if (e < mn) mn = e;
  }
  void absorb(const PairStatEx& o) {
    sum += o.sum;
    cnt += o.cnt;
    if (o.mx > mx) mx = o.mx;
    if (o.mn < mn) mn = o.mn;
  }
};

// Quantile scoring (the waterz QuantileAffinity<..., q, ...> spelling,
// e.g. the common production aff50 median): a 256-bin histogram of the
// boundary's edge affinities, exact under merging (bins add), with the
// quantile read off as the midpoint of the bin holding the rank —
// discretization error <= 1/512 on [0,1] affinities, matching waterz's
// own discretized histogram provider. 1 KB per boundary pair: choose
// this scoring for realistic fragment counts, not the multi-million-
// fragment pathological regimes.
struct PairStatQ {
  static constexpr bool kExtrema = false;
  static constexpr bool kHistogram = true;
  static constexpr int kBins = 256;
  uint64_t key = 0;  // 0 = empty
  int64_t cnt = 0;  // no sum: dispatch guarantees quantile-only scoring
  uint32_t hist[kBins] = {};
  static int bin_of(float e) {
    int b = static_cast<int>(e * kBins);
    if (b < 0) b = 0;
    if (b >= kBins) b = kBins - 1;
    return b;
  }
  void absorb_edge(float e) {
    cnt += 1;
    hist[bin_of(e)] += 1;
  }
  void absorb(const PairStatQ& o) {
    cnt += o.cnt;
    for (int b = 0; b < kBins; ++b) hist[b] += o.hist[b];
  }
  float quantile(int q) const {
    // rank of the q-th percentile under nearest-rank-with-midpoint
    const double rank = (cnt - 1) * (q / 100.0);
    int64_t cum = 0;
    for (int b = 0; b < kBins; ++b) {
      cum += hist[b];
      if (cum > rank) return (b + 0.5f) / kBins;
    }
    return 1.0f;
  }
};

template <class Stat>
class PairMap {
 public:
  explicit PairMap(size_t expected = 16) { rehash(capacity_for(expected)); }

  static uint64_t make_key(uint32_t a, uint32_t b) {
    if (a > b) std::swap(a, b);
    return (static_cast<uint64_t>(a) << 32) | b;
  }

  Stat* find(uint64_t key) {
    size_t i = index_of(key);
    while (slots_[i].key != 0) {
      if (slots_[i].key == key) return &slots_[i];
      i = (i + 1) & mask_;
    }
    return nullptr;
  }

  Stat& upsert(uint64_t key) {
    if ((size_ + 1) * 10 > capacity() * 7) rehash(capacity() * 2);
    size_t i = index_of(key);
    while (slots_[i].key != 0) {
      if (slots_[i].key == key) return slots_[i];
      i = (i + 1) & mask_;
    }
    slots_[i] = Stat{};
    slots_[i].key = key;
    ++size_;
    return slots_[i];
  }

  void erase(uint64_t key) {
    size_t i = index_of(key);
    while (slots_[i].key != 0 && slots_[i].key != key) i = (i + 1) & mask_;
    if (slots_[i].key == 0) return;
    // backward-shift deletion
    size_t hole = i;
    size_t j = (i + 1) & mask_;
    while (slots_[j].key != 0) {
      const size_t home = index_of(slots_[j].key);
      // can slot j legally move into the hole? yes iff home is not in
      // the (cyclic) range (hole, j]
      const bool movable = (hole <= j) ? (home <= hole || home > j)
                                       : (home <= hole && home > j);
      if (movable) {
        slots_[hole] = slots_[j];
        hole = j;
      }
      j = (j + 1) & mask_;
    }
    slots_[hole].key = 0;
    --size_;
  }

  size_t size() const { return size_; }
  const std::vector<Stat>& raw() const { return slots_; }

 private:
  static size_t capacity_for(size_t n) {
    size_t cap = 16;
    while (cap * 7 < n * 10) cap <<= 1;  // keep load factor <= 0.7
    return cap;
  }
  size_t capacity() const { return slots_.size(); }
  size_t index_of(uint64_t key) const {
    // splitmix64 finalizer
    uint64_t h = key + 0x9e3779b97f4a7c15ULL;
    h = (h ^ (h >> 30)) * 0xbf58476d1ce4e5b9ULL;
    h = (h ^ (h >> 27)) * 0x94d049bb133111ebULL;
    h ^= h >> 31;
    return static_cast<size_t>(h) & mask_;
  }
  void rehash(size_t new_cap) {
    std::vector<Stat> old;
    old.swap(slots_);
    slots_.assign(new_cap, Stat{});
    mask_ = new_cap - 1;
    size_ = 0;
    for (const auto& s : old) {
      if (s.key == 0) continue;
      Stat& dst = upsert(s.key);
      const uint64_t k = dst.key;
      dst = s;
      dst.key = k;
    }
  }

  std::vector<Stat> slots_;
  size_t mask_ = 0;
  size_t size_ = 0;
};


// waterz-parity boundary scoring: how a region pair's merge priority is
// derived from its boundary-edge statistics. Mean is the default (the
// reference plugin's OneMinus<MeanAffinity<...>> spelling); max/min map
// the waterz Max/MinAffinity aggregators. All three stay EXACT under
// hierarchical rescoring: sums/counts add and max/min combine when
// boundaries merge.
// scoring encoding: 0 mean, 1 max, 2 min, 100+q = q-th percentile
// (e.g. 150 = median / the waterz aff50 config)
enum Scoring { kScoreMean = 0, kScoreMax = 1, kScoreMin = 2,
               kScoreQuantileBase = 100 };

template <class Stat>
inline float score_of(const Stat& s, int scoring) {
  if constexpr (Stat::kHistogram) {
    // dispatch routes histogram stats only for scoring >= quantile base
    return s.quantile(scoring - kScoreQuantileBase);
  } else {
    if constexpr (Stat::kExtrema) {
      switch (scoring) {
        case kScoreMax: return s.mx;
        case kScoreMin: return s.mn;
        default: break;
      }
    }
    return static_cast<float>(s.sum / s.cnt);
  }
}

// Phase 3 (shared by the full watershed entry and the
// fragments-provided entry): hierarchical agglomeration with full
// rescoring over a compact fragment labeling ids[] (values 1..nseg,
// 0 = background). Writes the final compact segmentation to out and
// returns its segment count.
template <class Stat>
uint32_t agglomerate_ids(const float* const chan[3], const uint32_t* ids,
                         uint32_t nseg, int64_t sz, int64_t sy, int64_t sx,
                         float merge_threshold, int scoring, uint32_t* out,
                         PhaseTimer& timer) {
  const int64_t n = sz * sy * sx;
  const int64_t strides[3] = {sy * sx, sx, 1};
  const int nt = thread_count(sz);
  if (merge_threshold <= 0.0f || nseg <= 1) {
    std::memcpy(out, ids, n * sizeof(uint32_t));
    return nseg;
  }
  // 3a. boundary statistics, threaded: each slab accumulates its own
  // PairMap (edges reaching into the previous slab only READ ids[], so
  // no seam special-case is needed), merged into the global map in
  // slab order for deterministic double sums. stats starts empty: at
  // nt == 1 it is move-assigned from the single accumulator, and at
  // nt > 1 it grows on merge — pre-sizing it here would just be a
  // wasted multi-hundred-MB zero-fill on the worst cases.
  PairMap<Stat> stats;
  {
    std::vector<PairMap<Stat>> local;
    local.reserve(nt);
    for (int t = 0; t < nt; ++t)
      // histogram stats are ~1 KB/slot: let those maps grow on demand
      // instead of zero-filling a multi-GB pre-size tuned for the
      // 24-byte mean stat
      local.emplace_back(
          Stat::kHistogram ? 16 : static_cast<size_t>(nseg / nt) * 3 + 16);
    run_slabs(sz, nt, [&](int t, int64_t z0, int64_t z1) {
      PairMap<Stat>& m = local[t];
      auto add = [&](uint32_t a, uint32_t b, float e) {
        if (!a || !b || a == b) return;
        m.upsert(PairMap<Stat>::make_key(a, b)).absorb_edge(e);
      };
      for (int64_t z = z0; z < z1; ++z)
        for (int64_t y = 0; y < sy; ++y) {
          const int64_t row = (z * sy + y) * sx;
          for (int64_t x = 0; x < sx; ++x) {
            const int64_t i = row + x;
            const uint32_t a = ids[i];
            if (z > 0) add(a, ids[i - strides[0]], chan[0][i]);
            if (y > 0) add(a, ids[i - strides[1]], chan[1][i]);
            if (x > 0) add(a, ids[i - strides[2]], chan[2][i]);
          }
        }
    });
    if (nt == 1) {
      stats = std::move(local[0]);
    } else {
      for (int t = 0; t < nt; ++t)
        for (const auto& s : local[t].raw()) {
          if (s.key == 0) continue;
          stats.upsert(s.key).absorb(s);
        }
    }
  }
  timer.lap("phase3a rag");

  // 3b. CSR neighbor lists from the initial pair set, plus a linked
  // overflow chain for neighbors gained through merges (lazy deletion:
  // stale entries are skipped when their pair stat no longer exists).
  std::vector<int64_t> offsets(nseg + 2, 0);
  std::vector<uint32_t> csr;
  {
    for (const auto& s : stats.raw()) {
      if (s.key == 0) continue;
      const uint32_t a = static_cast<uint32_t>(s.key >> 32);
      const uint32_t b = static_cast<uint32_t>(s.key & 0xffffffffu);
      ++offsets[a + 1];
      ++offsets[b + 1];
    }
    for (size_t r = 1; r < offsets.size(); ++r) offsets[r] += offsets[r - 1];
    csr.resize(static_cast<size_t>(offsets[nseg + 1]));
    std::vector<int64_t> cursor(offsets.begin(), offsets.end() - 1);
    for (const auto& s : stats.raw()) {
      if (s.key == 0) continue;
      const uint32_t a = static_cast<uint32_t>(s.key >> 32);
      const uint32_t b = static_cast<uint32_t>(s.key & 0xffffffffu);
      csr[static_cast<size_t>(cursor[a]++)] = b;
      csr[static_cast<size_t>(cursor[b]++)] = a;
    }
  }
  struct ExtraNode {
    uint32_t nb;
    int64_t next;
  };
  std::vector<int64_t> extra_head(nseg + 1, -1);
  std::vector<ExtraNode> extra;
  auto for_each_neighbor = [&](uint32_t r, auto&& fn) {
    for (int64_t k = offsets[r]; k < offsets[r + 1]; ++k)
      fn(csr[static_cast<size_t>(k)]);
    for (int64_t node = extra_head[r]; node != -1;
         node = extra[static_cast<size_t>(node)].next)
      fn(extra[static_cast<size_t>(node)].nb);
  };
  auto add_neighbor = [&](uint32_t r, uint32_t nb) {
    extra.push_back({nb, extra_head[r]});
    extra_head[r] = static_cast<int64_t>(extra.size()) - 1;
  };

  UnionFind ruf(nseg + 1);
  using QItem = std::pair<float, std::pair<uint32_t, uint32_t>>;
  std::priority_queue<QItem> queue;
  for (const auto& s : stats.raw()) {
    if (s.key == 0) continue;
    const float score = score_of(s, scoring);
    if (score < merge_threshold) continue;  // can only go stale downward
    queue.push({score,
                {static_cast<uint32_t>(s.key >> 32),
                 static_cast<uint32_t>(s.key & 0xffffffffu)}});
  }
  while (!queue.empty()) {
    const auto [score, pair] = queue.top();
    queue.pop();
    // entries only ever go stale downward-in-validity, never does a
    // current score lack an entry, so the popped score bounds every
    // remaining current score: stop here. (Holds for max/min scoring
    // too: a merged boundary's max can only stay or RISE, and every
    // rise is re-pushed; mean and min only fall or re-push.)
    if (score < merge_threshold) break;
    const uint32_t a = pair.first, b = pair.second;
    if (ruf.find(a) != a || ruf.find(b) != b) continue;  // merged away
    Stat* st = stats.find(PairMap<Stat>::make_key(a, b));
    if (st == nullptr) continue;
    const float cur = score_of(*st, scoring);
    if (cur != score) continue;  // stale; the fresh entry is queued
    // merge the larger-id root into the smaller (matches UnionFind)
    ruf.unite(a, b);
    const uint32_t r = ruf.find(a);
    const uint32_t o = (r == a) ? b : a;
    stats.erase(PairMap<Stat>::make_key(a, b));
    // move the loser's boundaries onto the winner, rescoring each
    // combined boundary against the grown region
    for_each_neighbor(o, [&](uint32_t nb) {
      if (nb == r || nb == o) return;
      Stat* src = stats.find(PairMap<Stat>::make_key(o, nb));
      if (src == nullptr) return;  // stale/lazy-deleted entry
      const Stat moved = *src;
      stats.erase(PairMap<Stat>::make_key(o, nb));
      Stat& dst = stats.upsert(PairMap<Stat>::make_key(r, nb));
      dst.absorb(moved);
      add_neighbor(r, nb);
      add_neighbor(nb, r);
      const float rescored = score_of(dst, scoring);
      if (rescored >= merge_threshold)
        queue.push({rescored, {std::min(r, nb), std::max(r, nb)}});
    });
  }
  timer.lap("phase3 agglomerate");
  std::vector<uint32_t> remap(nseg + 1, 0);
  uint32_t finalc = 0;
  for (uint32_t s = 1; s <= nseg; ++s) {
    const uint32_t root = ruf.find(s);
    if (remap[root] == 0) remap[root] = ++finalc;
    remap[s] = remap[root];
  }
  for (int64_t i = 0; i < n; ++i) out[i] = remap[ids[i]];
  return finalc;
}

uint32_t agglomerate_dispatch(const float* const chan[3],
                              const uint32_t* ids, uint32_t nseg,
                              int64_t sz, int64_t sy, int64_t sx,
                              float merge_threshold, int scoring,
                              uint32_t* out, PhaseTimer& timer) {
  if (scoring >= kScoreQuantileBase)
    return agglomerate_ids<PairStatQ>(chan, ids, nseg, sz, sy, sx,
                                      merge_threshold, scoring, out, timer);
  if (scoring == kScoreMean)
    return agglomerate_ids<PairStat>(chan, ids, nseg, sz, sy, sx,
                                     merge_threshold, scoring, out, timer);
  return agglomerate_ids<PairStatEx>(chan, ids, nseg, sz, sy, sx,
                                     merge_threshold, scoring, out, timer);
}

}  // namespace

extern "C" {

// out must hold sz*sy*sx uint32. Returns number of segments.
// Affinity channel c at voxel (z,y,x) connects it to the voxel one step
// NEGATIVE along axis c (the common zyx affinity convention): channel 0
// edge (i, i - sy*sx), channel 1 edge (i, i - sx), channel 2 edge
// (i, i - 1).
uint32_t watershed_agglomerate_scored(const float* aff, uint32_t* out,
                                      int64_t sz, int64_t sy, int64_t sx,
                                      float t_high, float t_low,
                                      float merge_threshold, int scoring) {
  PhaseTimer timer;
  const int64_t n = sz * sy * sx;
  const int64_t strides[3] = {sy * sx, sx, 1};
  const float* chan[3] = {aff, aff + n, aff + 2 * n};
  const int nt = thread_count(sz);

  // all edges whose BOTH endpoints lie in z-slab [z0, z1), one fused
  // voxel scan (one pass over memory for all three channels); channel-0
  // edges at z == z0 (z0 > 0) reach into the previous slab and are
  // emitted by for_each_seam_edge instead
  auto for_each_edge = [&](int64_t z0, int64_t z1, auto&& fn) {
    const int64_t z_edge_start = (z0 == 0) ? 1 : z0 + 1;
    for (int64_t z = z0; z < z1; ++z) {
      const bool zedge = z >= z_edge_start;
      for (int64_t y = 0; y < sy; ++y) {
        const int64_t row = (z * sy + y) * sx;
        for (int64_t x = 0; x < sx; ++x) {
          const int64_t i = row + x;
          if (zedge) fn(i, i - strides[0], chan[0][i]);
          if (y > 0) fn(i, i - strides[1], chan[1][i]);
          if (x > 0) fn(i, i - strides[2], chan[2][i]);
        }
      }
    }
  };
  // channel-0 edges crossing slab seams (one z-plane per interior bound)
  auto for_each_seam_edge = [&](auto&& fn) {
    if (nt == 1) return;
    const auto bounds = slab_bounds(sz, nt);
    const float* a = chan[0];
    const int64_t s = strides[0];
    for (int t = 1; t < nt; ++t) {
      const int64_t z = bounds[t];
      if (z == 0) continue;
      for (int64_t y = 0; y < sy; ++y) {
        const int64_t row = (z * sy + y) * sx;
        for (int64_t x = 0; x < sx; ++x) {
          const int64_t i = row + x;
          fn(i, i - s, a[i]);
        }
      }
    }
  };

  // ---- 1+2: seeds, then steepest-ascent fragments (see header) ----
  //
  // Both phases contract a fixed, order-independent edge set (phase 1:
  // e >= t_high; phase 2: steepest surviving edge of either endpoint,
  // judged against the fully-computed best[]), so ALL seam unites are
  // deferred until after every threaded pass has joined. This keeps the
  // thread-safety invariant airtight: until the seam stitch runs, no
  // union-find chain crosses a slab boundary, so each worker's
  // find/unite path-halving writes stay inside its own slab. (Stitching
  // seams between the threaded passes would let a chain span slabs and
  // make the later threaded contract pass race on shared parent[]
  // entries.)
  UnionFind uf(n);
  std::vector<uint8_t> active(n, 0);  // voxel belongs to some region
  auto seed_edge = [&](int64_t i, int64_t j, float e) {
    if (e >= t_high) {
      uf.unite(static_cast<uint32_t>(i), static_cast<uint32_t>(j));
      active[i] = active[j] = 1;
    }
  };
  run_slabs(sz, nt, [&](int, int64_t z0, int64_t z1) {
    for_each_edge(z0, z1, seed_edge);
  });

  timer.lap("phase1 seeds");
  {
    // best surviving (>= t_low) incident affinity per voxel; the filter
    // runs BEFORE the steepest computation (zwatershed order), so a
    // voxel whose strongest edge was removed can still be claimed by a
    // neighbor whose steepest surviving edge reaches it.
    // Initialized to -inf, NOT 0: with t_low <= 0 a genuine 0.0 (or
    // negative) surviving edge must win only when it truly is the
    // steepest, never by tying an arbitrary init value (ADVICE r4).
    std::vector<float> best(n, -std::numeric_limits<float>::infinity());
    auto best_edge = [&](int64_t i, int64_t j, float e) {
      if (e < t_low) return;  // removed edge
      if (e > best[i]) best[i] = e;
      if (e > best[j]) best[j] = e;
    };
    run_slabs(sz, nt, [&](int, int64_t z0, int64_t z1) {
      for_each_edge(z0, z1, best_edge);
    });
    for_each_seam_edge(best_edge);  // writes best[] only — no uf access

    auto contract_edge = [&](int64_t i, int64_t j, float e) {
      if (e < t_low) return;
      if (e == best[i] || e == best[j]) {
        uf.unite(static_cast<uint32_t>(i), static_cast<uint32_t>(j));
        active[i] = active[j] = 1;
      }
    };
    run_slabs(sz, nt, [&](int, int64_t z0, int64_t z1) {
      for_each_edge(z0, z1, contract_edge);
    });
    // deferred seam stitch: the only unites that cross slab boundaries,
    // all sequential, after every worker has joined
    for_each_seam_edge(seed_edge);
    for_each_seam_edge(contract_edge);
  }

  timer.lap("phase2 fragments");
  // compact region ids: sequential first-encounter raster numbering,
  // allocation-free (no O(n) remap vector) — smaller-root-wins makes
  // every root its fragment's minimum voxel index, so after full path
  // compression roots renumber in place (see cc3d.cpp for the pattern)
  std::vector<uint32_t> ids(n, 0);
  uint32_t nseg = 0;
  {
    for (int64_t i = 0; i < n; ++i)
      if (active[i]) uf.parent[i] = uf.find(static_cast<uint32_t>(i));
    for (int64_t i = 0; i < n; ++i) {
      if (!active[i]) continue;
      const uint32_t root = uf.parent[i];
      if (root == static_cast<uint32_t>(i)) {
        uf.parent[i] = ++nseg;
        ids[i] = nseg;
      } else {
        ids[i] = uf.parent[root];
      }
    }
  }

  timer.lap("compact");
  return agglomerate_dispatch(chan, ids.data(), nseg, sz, sy, sx,
                              merge_threshold, scoring, out, timer);
}

// Backward-compatible spelling: mean-affinity scoring.
uint32_t watershed_agglomerate(const float* aff, uint32_t* out, int64_t sz,
                               int64_t sy, int64_t sx, float t_high,
                               float t_low, float merge_threshold) {
  return watershed_agglomerate_scored(aff, out, sz, sy, sx, t_high, t_low,
                                      merge_threshold, kScoreMean);
}

// Agglomerate PRECOMPUTED fragments (the reference plugin's
// ``fragments=`` input, waterz agglomerate(affs, fragments=...)): skip
// the seed/steepest-ascent phases, compact the caller's arbitrary
// nonzero uint32 fragment labels to 1..nseg by first raster encounter,
// and run the same hierarchical rescoring agglomeration. frags and out
// may NOT alias.
uint32_t agglomerate_fragments(const float* aff, const uint32_t* frags,
                               uint32_t* out, int64_t sz, int64_t sy,
                               int64_t sx, float merge_threshold,
                               int scoring) {
  PhaseTimer timer;
  const int64_t n = sz * sy * sx;
  const float* chan[3] = {aff, aff + n, aff + 2 * n};
  // compact arbitrary labels -> 1..nseg by first raster encounter via
  // the shared renumber kernel (remap.cpp). out[] is fully written even
  // when the mapping export overflows max_pairs (we pass 0 and no
  // buffers — the mapping itself is not needed), and |ret| is the
  // distinct-label count either way.
  std::vector<uint32_t> ids(n, 0);
  const int64_t r =
      cf_renumber_u32(frags, ids.data(), n, 1, nullptr, nullptr, 0);
  const uint32_t nseg = static_cast<uint32_t>(r < 0 ? -r : r);
  timer.lap("compact");
  return agglomerate_dispatch(chan, ids.data(), nseg, sz, sy, sx,
                              merge_threshold, scoring, out, timer);
}

}  // extern "C"
