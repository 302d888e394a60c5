// Native relation loader + exact column statistics.
//
// The port's own copy of sigmod2018_tpu/storage/native/loader.cpp, with
// the same C ABI (s18_load, s18_unload, s18_stats): mmap each binary
// relation file (layout: uint64 num_tuples | uint64 num_cols |
// column-major uint64 data) and compute per-column {min, max, count,
// distinct, fmax, mode} for the planner.
//
// - Stats run multithreaded across columns.
// - Each column is sorted by an LSD radix sort (11-bit digits) that skips
//   the digits every key shares, where the reference package's copy
//   calls std::sort: keys below 2^22 take two passes.
// - Distinct counts are exact (sort-unique), and the mode is the
//   smallest of the most frequent values: the first run of the largest
//   length in ascending order wins (`run > fmax`).  That is what
//   np.unique + argmax gives, so these stats equal
//   storage/catalog.py::compute_column_stats in all six fields.
// - Exposed as a C ABI for ctypes: no Python headers, so g++ builds it
//   in about a second.
//
// Build: storage/native/__init__.py compiles this with g++ -O3 at first
// use into build/native/loader-<source hash>.so.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// Sorts a[0, n) ascending; tmp holds n scratch words.  One read builds
// the histograms of all six 11-bit digits; a digit whose histogram has a
// single bucket holding every key leaves the order as it is and is
// skipped.  Each pass is a stable scatter, so the passes compose.
void radix_sort_u64(uint64_t* a, uint64_t* tmp, uint64_t n) {
  constexpr int kBits = 11, kPasses = 6, kBuckets = 1 << kBits;
  std::vector<uint64_t> hist(kPasses * kBuckets, 0);
  for (uint64_t i = 0; i < n; ++i) {
    uint64_t v = a[i];
    for (int p = 0; p < kPasses; ++p)
      ++hist[p * kBuckets + ((v >> (p * kBits)) & (kBuckets - 1))];
  }
  uint64_t* src = a;
  uint64_t* dst = tmp;
  for (int p = 0; p < kPasses; ++p) {
    uint64_t* h = hist.data() + p * kBuckets;
    const int shift = p * kBits;
    if (h[(src[0] >> shift) & (kBuckets - 1)] == n) continue;
    uint64_t sum = 0;
    for (int b = 0; b < kBuckets; ++b) {
      uint64_t c = h[b];
      h[b] = sum;
      sum += c;
    }
    for (uint64_t i = 0; i < n; ++i) {
      uint64_t v = src[i];
      dst[h[(v >> shift) & (kBuckets - 1)]++] = v;
    }
    std::swap(src, dst);
  }
  if (src != a) std::memcpy(a, src, n * sizeof(uint64_t));
}

}  // namespace

extern "C" {

struct S18Relation {
  const uint64_t* data;   // mmap'd base (first column), column-major
  uint64_t num_tuples;
  uint64_t num_cols;
  void* map_base;         // for munmap
  uint64_t map_len;
};

// Maps `path`; fills `out`. Returns 0 on success, negative errno-style code.
int s18_load(const char* path, S18Relation* out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return -2; }
  if (st.st_size < 16) { close(fd); return -3; }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return -4;
  const uint64_t* header = static_cast<const uint64_t*>(base);
  uint64_t tuples = header[0], cols = header[1];
  // Overflow-safe bounds check: `16 + tuples * cols * 8` can wrap for a
  // corrupt header (e.g. tuples = 2^61) and bypass a naive comparison,
  // turning a bad file into out-of-bounds reads.  Divide instead.
  uint64_t avail_words = (static_cast<uint64_t>(st.st_size) - 16) / 8;
  if (tuples != 0 && (cols > avail_words / tuples)) {
    munmap(base, st.st_size);
    return -5;
  }
  out->data = header + 2;
  out->num_tuples = tuples;
  out->num_cols = cols;
  out->map_base = base;
  out->map_len = st.st_size;
  return 0;
}

void s18_unload(S18Relation* rel) {
  if (rel->map_base) munmap(rel->map_base, rel->map_len);
  rel->map_base = nullptr;
}

// Per-column stats: min, max, distinct (exact, sort-unique), and a
// 1-bucket MCV sketch (fmax = top multiplicity, mode = its value).
// Layout: stats_out[6*c + {0..5}] = {min, max, count, distinct, fmax,
// mode}.  Columns are processed by `threads` workers in parallel.
void s18_stats(const uint64_t* data, uint64_t num_tuples, uint64_t num_cols,
               uint64_t* stats_out, int threads) {
  if (num_tuples == 0 || num_cols == 0) {
    for (uint64_t c = 0; c < num_cols; ++c)
      for (int k = 0; k < 6; ++k) stats_out[6 * c + k] = 0;
    return;
  }
  std::atomic<uint64_t> next{0};
  auto worker = [&]() {
    std::vector<uint64_t> scratch, tmp;
    for (;;) {
      uint64_t c = next.fetch_add(1);
      if (c >= num_cols) return;
      const uint64_t* col = data + c * num_tuples;
      uint64_t mn = col[0], mx = col[0];
      for (uint64_t i = 1; i < num_tuples; ++i) {
        uint64_t v = col[i];
        if (v < mn) mn = v;
        if (v > mx) mx = v;
      }
      scratch.assign(col, col + num_tuples);
      tmp.resize(num_tuples);
      radix_sort_u64(scratch.data(), tmp.data(), num_tuples);
      uint64_t distinct = 0, fmax = 0, mode = scratch[0];
      uint64_t run = 1;
      for (uint64_t i = 1; i <= num_tuples; ++i) {
        if (i < num_tuples && scratch[i] == scratch[i - 1]) {
          ++run;
        } else {
          ++distinct;
          if (run > fmax) { fmax = run; mode = scratch[i - 1]; }
          run = 1;
        }
      }
      stats_out[6 * c + 0] = mn;
      stats_out[6 * c + 1] = mx;
      stats_out[6 * c + 2] = num_tuples;
      stats_out[6 * c + 3] = distinct;
      stats_out[6 * c + 4] = fmax;
      stats_out[6 * c + 5] = mode;
    }
  };
  int n = std::max(1, std::min<int>(threads, static_cast<int>(num_cols)));
  std::vector<std::thread> pool;
  pool.reserve(n);
  for (int i = 0; i < n; ++i) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
}

}  // extern "C"
