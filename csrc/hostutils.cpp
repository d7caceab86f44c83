// Native host runtime for cuda.radixsort_tpu.
//
// The reference repo's host side (main.cu [RECON, SURVEY.md §2.2]) does data
// initialization, a CPU oracle sort for verification, and timing. This is
// that runtime, implemented natively and multithreaded so it keeps up with
// contract-scale inputs (1B keys): a threaded xoshiro256** key generator, the
// canonical CPU LSD radix sort (8-bit digits, histogram -> exclusive scan ->
// stable scatter — the same pipeline as the device `reference` engine), pair
// sorting, and bit-exact verification.
//
// Exposed through ctypes (cuda/radixsort_tpu/utils/native.py). No Python.h
// dependency: plain C ABI.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Xoshiro256ss {
  uint64_t s[4];
  explicit Xoshiro256ss(uint64_t seed) {
    // splitmix64 init
    uint64_t x = seed;
    for (int i = 0; i < 4; i++) {
      x += 0x9e3779b97f4a7c15ULL;
      uint64_t z = x;
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      s[i] = z ^ (z >> 31);
    }
  }
  static inline uint64_t rotl(uint64_t v, int k) {
    return (v << k) | (v >> (64 - k));
  }
  inline uint64_t next() {
    uint64_t result = rotl(s[1] * 5, 7) * 9;
    uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
};

int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n ? static_cast<int>(n) : 4;
}

template <typename F>
void parallel_for_chunks(int64_t n, F&& fn) {
  int nt = hw_threads();
  if (n < (1 << 16)) nt = 1;
  std::vector<std::thread> ts;
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    int64_t lo = t * chunk, hi = lo + chunk > n ? n : lo + chunk;
    if (lo >= hi) break;
    ts.emplace_back([&fn, lo, hi, t] { fn(lo, hi, t); });
  }
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// Fill buf[0..n) with uniform random uint32 (threaded, deterministic in seed).
void rt_fill_random_u32(uint32_t* buf, int64_t n, uint64_t seed) {
  parallel_for_chunks(n, [&](int64_t lo, int64_t hi, int t) {
    Xoshiro256ss rng(seed * 0x9e3779b97f4a7c15ULL + (uint64_t)t * 0xd1b54a32d192ed03ULL + 1);
    int64_t i = lo;
    for (; i + 1 < hi; i += 2) {
      uint64_t v = rng.next();
      buf[i] = (uint32_t)v;
      buf[i + 1] = (uint32_t)(v >> 32);
    }
    if (i < hi) buf[i] = (uint32_t)rng.next();
  });
}

// Zipf-ish skewed keys: with prob num/den emit hot key, else uniform.
void rt_fill_skewed_u32(uint32_t* buf, int64_t n, uint64_t seed,
                        uint32_t hot_key, uint32_t num, uint32_t den) {
  parallel_for_chunks(n, [&](int64_t lo, int64_t hi, int t) {
    Xoshiro256ss rng(seed + 77777ULL * (uint64_t)t);
    for (int64_t i = lo; i < hi; i++) {
      uint64_t v = rng.next();
      buf[i] = ((uint32_t)v % den) < num ? hot_key : (uint32_t)(v >> 32);
    }
  });
}

// Canonical CPU LSD radix sort, 8-bit digits: per-pass histogram ->
// exclusive scan -> stable scatter (the reference pipeline, host edition).
// tmp must hold n elements. Multithreaded histogram; scatter single-thread
// per pass (stability).
void rt_lsd_sort_u32(uint32_t* keys, uint32_t* tmp, int64_t n) {
  uint32_t* src = keys;
  uint32_t* dst = tmp;
  for (int pass = 0; pass < 4; pass++) {
    int shift = pass * 8;
    int64_t hist[256] = {0};
    {
      // threaded histogram with private counters
      int nt = hw_threads();
      std::vector<std::vector<int64_t>> ph(nt, std::vector<int64_t>(256, 0));
      parallel_for_chunks(n, [&](int64_t lo, int64_t hi, int t) {
        auto& h = ph[t < nt ? t : 0];
        for (int64_t i = lo; i < hi; i++) h[(src[i] >> shift) & 255]++;
      });
      for (auto& h : ph)
        for (int b = 0; b < 256; b++) hist[b] += h[b];
    }
    int64_t base[256];
    int64_t run = 0;
    for (int b = 0; b < 256; b++) {
      base[b] = run;
      run += hist[b];
    }
    for (int64_t i = 0; i < n; i++) dst[base[(src[i] >> shift) & 255]++] = src[i];
    std::swap(src, dst);
  }
  // 4 passes (even) => result already back in `keys`
}

// Pair sort: values follow keys through the same permutation.
void rt_lsd_sort_pairs_u32(uint32_t* keys, uint32_t* vals, uint32_t* tmpk,
                           uint32_t* tmpv, int64_t n) {
  uint32_t *sk = keys, *sv = vals, *dk = tmpk, *dv = tmpv;
  for (int pass = 0; pass < 4; pass++) {
    int shift = pass * 8;
    int64_t hist[256] = {0};
    for (int64_t i = 0; i < n; i++) hist[(sk[i] >> shift) & 255]++;
    int64_t base[256];
    int64_t run = 0;
    for (int b = 0; b < 256; b++) {
      base[b] = run;
      run += hist[b];
    }
    for (int64_t i = 0; i < n; i++) {
      int64_t p = base[(sk[i] >> shift) & 255]++;
      dk[p] = sk[i];
      dv[p] = sv[i];
    }
    std::swap(sk, dk);
    std::swap(sv, dv);
  }
}

// Returns -1 if sorted ascending, else the first violating index.
int64_t rt_verify_sorted_u32(const uint32_t* keys, int64_t n) {
  std::atomic<int64_t> bad(-1);
  parallel_for_chunks(n - 1, [&](int64_t lo, int64_t hi, int) {
    for (int64_t i = lo; i < hi; i++) {
      if (keys[i] > keys[i + 1]) {
        int64_t expected = -1;
        int64_t cur = bad.load();
        while ((cur == -1 || i < cur) && !bad.compare_exchange_weak(cur, i)) {
        }
        return;
      }
    }
  });
  return bad.load();
}

// Bit-exact comparison; returns -1 if equal else first differing index.
int64_t rt_compare_u32(const uint32_t* a, const uint32_t* b, int64_t n) {
  std::atomic<int64_t> bad(-1);
  parallel_for_chunks(n, [&](int64_t lo, int64_t hi, int) {
    if (memcmp(a + lo, b + lo, (size_t)(hi - lo) * 4) == 0) return;
    for (int64_t i = lo; i < hi; i++) {
      if (a[i] != b[i]) {
        int64_t cur = bad.load();
        while ((cur == -1 || i < cur) && !bad.compare_exchange_weak(cur, i)) {
        }
        return;
      }
    }
  });
  return bad.load();
}

// 16-bin digit histogram (cross-check for the fused histogram kernel).
void rt_histogram16(const uint32_t* keys, int64_t n, int shift,
                    int64_t* out16) {
  int nt = hw_threads();
  std::vector<std::vector<int64_t>> ph(nt, std::vector<int64_t>(16, 0));
  parallel_for_chunks(n, [&](int64_t lo, int64_t hi, int t) {
    auto& h = ph[t < nt ? t : 0];
    for (int64_t i = lo; i < hi; i++) h[(keys[i] >> shift) & 15]++;
  });
  for (int b = 0; b < 16; b++) out16[b] = 0;
  for (auto& h : ph)
    for (int b = 0; b < 16; b++) out16[b] += h[b];
}

// ---- round-2 additions: u64 oracles (the 256M u64+payload contract
// config, BASELINE.json:8, needs host verification that keeps up) ----

// 8-pass LSD sort of u64 keys; even pass count => result lands in `keys`.
void rt_lsd_sort_u64(uint64_t* keys, uint64_t* tmp, int64_t n) {
  uint64_t* src = keys;
  uint64_t* dst = tmp;
  for (int pass = 0; pass < 8; pass++) {
    int shift = pass * 8;
    int64_t hist[256] = {0};
    {
      int nt = hw_threads();
      std::vector<std::vector<int64_t>> ph(nt, std::vector<int64_t>(256, 0));
      parallel_for_chunks(n, [&](int64_t lo, int64_t hi, int t) {
        auto& h = ph[t < nt ? t : 0];
        for (int64_t i = lo; i < hi; i++) h[(src[i] >> shift) & 255]++;
      });
      for (auto& h : ph)
        for (int b = 0; b < 256; b++) hist[b] += h[b];
    }
    int64_t base[256];
    int64_t run = 0;
    for (int b = 0; b < 256; b++) {
      base[b] = run;
      run += hist[b];
    }
    for (int64_t i = 0; i < n; i++)
      dst[base[(src[i] >> shift) & 255]++] = src[i];
    std::swap(src, dst);
  }
}

// Stable u64-key + u32-payload pair sort (values follow keys).
void rt_lsd_sort_pairs_u64(uint64_t* keys, uint32_t* vals, uint64_t* tmpk,
                           uint32_t* tmpv, int64_t n) {
  uint64_t *sk = keys, *dk = tmpk;
  uint32_t *sv = vals, *dv = tmpv;
  for (int pass = 0; pass < 8; pass++) {
    int shift = pass * 8;
    int64_t hist[256] = {0};
    for (int64_t i = 0; i < n; i++) hist[(sk[i] >> shift) & 255]++;
    int64_t base[256];
    int64_t run = 0;
    for (int b = 0; b < 256; b++) {
      base[b] = run;
      run += hist[b];
    }
    for (int64_t i = 0; i < n; i++) {
      int64_t p = base[(sk[i] >> shift) & 255]++;
      dk[p] = sk[i];
      dv[p] = sv[i];
    }
    std::swap(sk, dk);
    std::swap(sv, dv);
  }
}

int64_t rt_verify_sorted_u64(const uint64_t* keys, int64_t n) {
  std::atomic<int64_t> bad{-1};
  parallel_for_chunks(n - 1, [&](int64_t lo, int64_t hi, int) {
    for (int64_t i = lo; i < hi; i++) {
      if (keys[i] > keys[i + 1]) {
        int64_t cur = bad.load();
        while ((cur == -1 || i < cur) &&
               !bad.compare_exchange_weak(cur, i)) {
        }
        return;
      }
    }
  });
  return bad.load();
}

int64_t rt_compare_u64(const uint64_t* a, const uint64_t* b, int64_t n) {
  std::atomic<int64_t> bad{-1};
  parallel_for_chunks(n, [&](int64_t lo, int64_t hi, int) {
    for (int64_t i = lo; i < hi; i++) {
      if (a[i] != b[i]) {
        int64_t cur = bad.load();
        while ((cur == -1 || i < cur) &&
               !bad.compare_exchange_weak(cur, i)) {
        }
        return;
      }
    }
  });
  return bad.load();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Parallel k-way merge of sorted runs — the host half of the external
// (out-of-core) sort: the device sorts HBM-sized chunks at full speed, this
// merges the returned runs. Output-partitioned parallelism: thread t owns
// output ranks [t*n/T, (t+1)*n/T); its slice of every run is found by a
// binary search ON THE VALUE SPACE (32 probes x k lower_bounds — the
// merge-path split generalized to k runs), then merged with a 2^h min-heap
// keyed on (value, run index) so equal keys preserve run order (stability:
// runs are chunk-ordered).
// ---------------------------------------------------------------------------

namespace {

// rows strictly less than value v across all runs (v in [0, 2^32])
inline int64_t merged_rank_u32(const uint32_t* const* runs,
                               const int64_t* lens, int k, uint64_t v) {
  int64_t rank = 0;
  for (int i = 0; i < k; i++) {
    if (v >= 0x100000000ULL) {
      rank += lens[i];
      continue;
    }
    uint32_t key = static_cast<uint32_t>(v);
    int64_t a = 0, b = lens[i];
    while (a < b) {
      int64_t m = (a + b) >> 1;
      if (runs[i][m] < key) a = m + 1; else b = m;
    }
    rank += a;
  }
  return rank;
}

// starting cursor of every run for global output rank R: the unique
// frontier (c_0..c_{k-1}) with sum c_i == R that splits the merged order
void split_at_rank_u32(const uint32_t* const* runs, const int64_t* lens,
                       int k, int64_t R, int64_t* cursors) {
  // binary search the (value, run) pair at global rank R
  uint64_t lo = 0, hi = 0x100000001ULL;  // value search over [0, 2^32]
  while (lo < hi) {
    uint64_t mid = (lo + hi) >> 1;
    if (merged_rank_u32(runs, lens, k, mid) <= R) lo = mid + 1;
    else hi = mid;
  }
  // lo-1 is the value v at rank R's row (or R lands inside v's equal block)
  uint64_t v = lo == 0 ? 0 : lo - 1;
  int64_t base = merged_rank_u32(runs, lens, k, v);
  // cursors: all rows < v, then fill the equal-v block run by run (the
  // merged order of equal keys is run-major)
  int64_t remaining = R - base;
  for (int i = 0; i < k; i++) {
    int64_t a = 0, b = lens[i];
    while (a < b) {  // lower_bound of v
      int64_t m = (a + b) >> 1;
      if (runs[i][m] < static_cast<uint32_t>(v)) a = m + 1; else b = m;
    }
    int64_t eq_a = a, b2 = lens[i];
    int64_t a2 = a;
    while (a2 < b2) {  // upper_bound of v
      int64_t m = (a2 + b2) >> 1;
      if (runs[i][m] <= static_cast<uint32_t>(v)) a2 = m + 1; else b2 = m;
    }
    int64_t eq = a2 - eq_a;
    int64_t take = remaining < eq ? remaining : eq;
    cursors[i] = eq_a + take;
    remaining -= take;
  }
}

struct HeapEntryU32 {
  uint32_t key;
  int32_t run;
  int64_t pos;
};

inline bool heap_less(const HeapEntryU32& a, const HeapEntryU32& b) {
  return a.key < b.key || (a.key == b.key && a.run < b.run);
}

}  // namespace

extern "C" {

void rt_kway_merge_u32(const uint32_t* const* runs, const int64_t* lens,
                       int k, int64_t n, uint32_t* out,
                       const uint32_t* const* vruns, uint32_t* vout) {
  if (k <= 0 || n <= 0) return;
  int nt = hw_threads();
  if (n < (1 << 16)) nt = 1;
  std::vector<std::thread> ts;
  for (int t = 0; t < nt; t++) {
    int64_t lo = n * t / nt, hi = n * (t + 1) / nt;
    if (lo >= hi) continue;
    ts.emplace_back([=]() {
      std::vector<int64_t> cur(k);
      split_at_rank_u32(runs, lens, k, lo, cur.data());
      // binary min-heap of run heads
      std::vector<HeapEntryU32> heap;
      heap.reserve(k);
      for (int i = 0; i < k; i++) {
        if (cur[i] < lens[i]) {
          heap.push_back({runs[i][cur[i]], i, cur[i]});
        }
      }
      auto sift_up = [&](size_t j) {
        while (j > 0) {
          size_t p = (j - 1) >> 1;
          if (heap_less(heap[j], heap[p])) {
            std::swap(heap[j], heap[p]);
            j = p;
          } else break;
        }
      };
      auto sift_down = [&](size_t j) {
        for (;;) {
          size_t l = 2 * j + 1, r = l + 1, m = j;
          if (l < heap.size() && heap_less(heap[l], heap[m])) m = l;
          if (r < heap.size() && heap_less(heap[r], heap[m])) m = r;
          if (m == j) break;
          std::swap(heap[j], heap[m]);
          j = m;
        }
      };
      for (size_t j = heap.size(); j-- > 0;) sift_down(j);
      (void)sift_up;
      for (int64_t o = lo; o < hi; o++) {
        HeapEntryU32 top = heap[0];
        out[o] = top.key;
        if (vout) vout[o] = vruns[top.run][top.pos];
        int64_t np = top.pos + 1;
        if (np < lens[top.run]) {
          heap[0] = {runs[top.run][np], top.run, np};
        } else {
          heap[0] = heap.back();
          heap.pop_back();
        }
        if (!heap.empty()) sift_down(0);
      }
    });
  }
  for (auto& th : ts) th.join();
}

}  // extern "C"
