// Staircase match counts of a sorted probe side against a sorted build
// side, for Hopper (sm_90a).
//
// Replaces the Pallas kernel sigmod2018_tpu/ops/ms_join.py::_stair_kernel.
// Contract (the same): kb [Pb] and kp [Pp] are u64 keys sorted ascending
// in their live prefixes [0, n_b) and [0, n_p); for every probe row
//   cnt[i] = #{ j < n_b : kb[j] == kp[i] }   (0 for i >= n_p)
//   lo[i]  = the first such j                (unspecified where cnt == 0)
// Liveness is by position, so a live key 2^64-1 counts exactly whatever
// the pads hold.
//
// The TPU kernel walks a staircase of (probe chunk, build chunk) tiles
// because a TPU grid runs in order over VMEM tiles.  Here the probe side
// is cut into chunks of kChunk sorted rows, and two launches answer them:
//
// 1. chunk_bounds_kernel: one warp per (chunk, bound) finds lb(kf),
//    ub(kf), lb(kl) or ub(kl) in the live build, kf and kl being the
//    chunk's first and last key.  Each round its lanes test 128 pivots
//    (4 a lane, loads all in flight) and a ballot narrows the range
//    128-fold: 3 rounds at 2^21 rows, every search of the call in one
//    wave.  No block waits on a serial search of its own.
// 2. stair_counts_kernel: one block per chunk, kRows contiguous rows a
//    thread, keys and results in registers.  It reads its four bounds,
//    starts cp.async copies (16 bytes each) of the middle window
//    [ub(kf), lb(kl)) -- the only build keys that rows strictly between kf
//    and kl can match -- and loads its own keys with 16-byte loads.  Rows
//    whose key is kf or kl take (cnt, lo) from the bounds, so a hot key's
//    run (one key on 1/4 of the rows, say) costs no search at all.  Each
//    thread merges its sorted run against the window with galloping
//    searches: one walk per run, not two binary searches per row.  A
//    window longer than kTile keys comes in more tiles: no step cap, no
//    search in global memory per row.  Each thread's rows are one 16-byte
//    store of cnt and one of lo.
//
// What bounds it on this card: bytes.  It reads the live probe keys once,
// the build keys of each chunk's window about once, and writes two int32
// per probe row.  The bounds pass reads a few KB.  Shared memory holds
// only the window tile that the merges read; per-row keys and results live
// in registers, out of reach of shared-memory bank conflicts, which at
// these widths cost more time than the bytes.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kRows = 4;  // contiguous rows a thread: one int4 of output
static_assert(kRows == 4, "a thread stores its rows as one int4");
constexpr int kChunk = kThreads * kRows;        // probe rows per block
constexpr int kTile = 3064;                     // staged build keys a tile
constexpr int kPivots = 4;                      // per lane and search round

struct Live {
  int nb, np;
};

__device__ __forceinline__ Live live_counts(const int* n_dev, int nb, int np,
                                            int Pb, int Pp) {
  if (n_dev) {
    nb = n_dev[0];
    np = n_dev[1];
  }
  return {min(max(nb, 0), Pb), min(max(np, 0), Pp)};
}

// Live rows of chunk c: [c * kChunk, c * kChunk + result); none match an
// empty build.
__device__ __forceinline__ int chunk_live(int c, Live n) {
  return n.nb > 0 ? max(min(kChunk, n.np - c * kChunk), 0) : 0;
}

// bounds[4 c + s] for s = 0..3: lb(kf), ub(kf), lb(kl), ub(kl) of chunk c
// in kb[0, n_b) (0 for a chunk without live rows).  One warp a search.
__global__ void __launch_bounds__(kThreads)
chunk_bounds_kernel(const u64* __restrict__ kb, int Pb,
                    const u64* __restrict__ kp, int Pp,
                    const int* __restrict__ n_dev, int nb_arg, int np_arg,
                    int searches, int* __restrict__ bounds) {
  const int w = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= searches) return;  // warp-uniform
  const Live n = live_counts(n_dev, nb_arg, np_arg, Pb, Pp);
  const int c = w >> 2, s = w & 3;
  const int nlive = chunk_live(c, n);
  int lo = 0, hi = 0;
  if (nlive > 0) {
    const u64 key = __ldg(kp + c * kChunk + (s < 2 ? 0 : nlive - 1));
    const bool upper = s & 1;  // ub: first key > k; lb: first key >= k
    hi = n.nb;
    while (lo < hi) {  // warp-uniform
      const int step = (hi - lo + 32 * kPivots - 1) / (32 * kPivots);
      int below = 0;
#pragma unroll
      for (int i = 0; i < kPivots; ++i) {
        const int p = lo + (i * 32 + lane) * step;
        bool f = false;
        if (p < hi) {
          const u64 v = __ldg(kb + p);
          f = upper ? v <= key : v < key;
        }
        below += __popc(__ballot_sync(0xffffffffu, f));
      }
      if (below == 0) {  // pivots below the key are a prefix of them
        hi = lo;
      } else {
        const int base = lo;
        lo = base + (below - 1) * step + 1;
        hi = min(base + below * step, hi);
      }
    }
  }
  if (lane == 0) bounds[w] = lo;
}

// First i in [p, n) with a[i] >= k (strict) or a[i] > k, given that every
// a[j < p] is below k: gallop from p, then a binary search.
template <bool kStrict>
__device__ __forceinline__ int gallop(const u64* a, int p, int n, u64 k) {
  auto below = [&](u64 v) { return kStrict ? v < k : v <= k; };
  if (p >= n || !below(a[p])) return p;
  int lo = p, step = 1;  // a[lo] below k
  while (lo + step < n && below(a[lo + step])) {
    lo += step;
    step <<= 1;
  }
  int hi = min(lo + step, n);
  ++lo;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (below(a[mid])) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Starts asynchronous copies of src[0, n) to shared dst[0, n), 16 bytes a
// copy where src is 16-byte aligned, and commits them; the caller waits.
__device__ __forceinline__ void copy_async(u64* dst, const u64* src, int n,
                                           bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < (n >> 1); i += kThreads)
      __pipeline_memcpy_async(dst + 2 * i, src + 2 * i, 16);
    if ((n & 1) && threadIdx.x == 0)
      __pipeline_memcpy_async(dst + n - 1, src + n - 1, 8);
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads)
      __pipeline_memcpy_async(dst + i, src + i, 8);
  }
  __pipeline_commit();
}

__global__ void __launch_bounds__(kThreads)
stair_counts_kernel(const u64* __restrict__ kb, int Pb,
                    const u64* __restrict__ kp, int Pp,
                    const int* __restrict__ n_dev, int nb_arg, int np_arg,
                    const int* __restrict__ bounds, bool kb_vec, bool kp_vec,
                    bool out_vec, int* __restrict__ cnt,
                    int* __restrict__ lo) {
  __shared__ __align__(16) u64 win[kTile + 2];  // a middle-window tile

  const Live n = live_counts(n_dev, nb_arg, np_arg, Pb, Pp);
  const int c0 = blockIdx.x * kChunk;
  const int nlive = chunk_live(blockIdx.x, n);  // block-uniform
  const int r0 = threadIdx.x * kRows;           // my rows: c0 + r0 + j
  int c[kRows], l[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) c[j] = l[j] = 0;

  if (nlive > 0) {
    const int4 bd = reinterpret_cast<const int4*>(bounds)[blockIdx.x];
    const int m0 = bd.y, m1 = max(bd.z, bd.y);  // middle window [m0, m1)
    u64 k[kRows];
    if (kp_vec && r0 + kRows <= nlive) {
      const ulonglong2* k2 = reinterpret_cast<const ulonglong2*>(kp + c0 + r0);
      const ulonglong2 a = __ldg(k2), b = __ldg(k2 + 1);
      k[0] = a.x;
      k[1] = a.y;
      k[2] = b.x;
      k[3] = b.y;
    } else {
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        k[j] = r0 + j < nlive ? __ldg(kp + c0 + r0 + j) : 0ull;
    }
    const u64 kf = __ldg(kp + c0), kl = __ldg(kp + c0 + nlive - 1);

    // rows of kf and kl from the bounds; the others (mid) from the window
    bool mid[kRows], any = false;
    u64 kmin = ~0ull, kmax = 0ull;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const bool live = r0 + j < nlive;
      mid[j] = live && k[j] != kf && k[j] != kl;
      if (live && k[j] == kf) {
        c[j] = bd.y - bd.x;
        l[j] = bd.x;
      } else if (live && k[j] == kl) {
        c[j] = bd.w - bd.z;
        l[j] = bd.z;
      } else if (mid[j]) {
        l[j] = m0;
        any = true;
        kmin = min(kmin, k[j]);
        kmax = max(kmax, k[j]);
      }
    }

    for (int t0 = m0; t0 < m1; t0 += kTile) {  // block-uniform
      const int a0 = kb_vec ? t0 & ~1 : t0;    // 16-byte aligned start
      const int nt = min(t0 + kTile, m1) - a0;
      const int base = t0 - a0;
      if (t0 > m0) __syncthreads();  // the previous tile is no longer read
      copy_async(win, kb + a0, nt, kb_vec);
      __pipeline_wait_prior(0);
      __syncthreads();
      if (!any || kmax < win[base]) continue;  // tile past my keys
      if (kmin > win[nt - 1]) {                // tile below my keys
#pragma unroll
        for (int j = 0; j < kRows; ++j) l[j] += mid[j] ? nt - base : 0;
        continue;
      }
      int p = base, q = base;  // every win[base, q) is below the next key
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (!mid[j]) continue;
        if (j == 0 || !mid[j - 1] || k[j] != k[j - 1]) {
          p = gallop<true>(win, q, nt, k[j]);
          q = gallop<false>(win, p, nt, k[j]);
        }
        c[j] += q - p;
        l[j] += p - base;
      }
    }
  }

  const int rows = Pp - c0 - r0;  // of my rows, those inside the output
  if (rows <= 0) return;
  if (out_vec && rows >= kRows) {
    reinterpret_cast<int4*>(cnt + c0 + r0)[0] = make_int4(c[0], c[1], c[2], c[3]);
    reinterpret_cast<int4*>(lo + c0 + r0)[0] = make_int4(l[0], l[1], l[2], l[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (j < rows) {
        cnt[c0 + r0 + j] = c[j];
        lo[c0 + r0 + j] = l[j];
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

}  // namespace

// int32 scratch that s18_stair_counts needs for Pp probe rows: the bounds
// pass's four build positions per chunk of kChunk rows.
extern "C" long long s18_stair_scratch_ints(int Pp) {
  return Pp > 0 ? 4LL * ((Pp + kChunk - 1) / kChunk) : 0;
}

// Launches both passes on `stream`.  The live counts come either from the
// device (n_dev != nullptr: int32 [2] = {n_b, n_p}, so a count the device
// just computed needs no host sync) or from the host ints n_b, n_p.
// `scratch`: int32 [scratch_ints], 16-byte aligned, at least
// s18_stair_scratch_ints(Pp).  *launched is set to the kernels launched:
// 2, or 1 when the host counts leave no live row (the bounds pass is then
// skipped), or 0 for Pp == 0.  Returns cudaErrorInvalidValue for a scratch
// too small or misaligned, else cudaGetLastError() after the launches.
extern "C" int s18_stair_counts(const void* kb, int Pb, const void* kp,
                                int Pp, const void* n_dev, int n_b, int n_p,
                                void* cnt, void* lo, void* scratch,
                                long long scratch_ints, void* stream,
                                int* launched) {
  *launched = 0;
  if (Pp <= 0) return static_cast<int>(cudaSuccess);
  const int chunks = (Pp + kChunk - 1) / kChunk;
  const int searches = 4 * chunks;
  if (scratch_ints < searches || !aligned16(scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_dev || (n_b > 0 && n_p > 0)) {  // else no chunk has live rows
    chunk_bounds_kernel<<<(searches + kThreads / 32 - 1) / (kThreads / 32),
                          kThreads, 0, st>>>(
        static_cast<const u64*>(kb), Pb, static_cast<const u64*>(kp), Pp,
        static_cast<const int*>(n_dev), n_b, n_p, searches,
        static_cast<int*>(scratch));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
  }
  stair_counts_kernel<<<chunks, kThreads, 0, st>>>(
      static_cast<const u64*>(kb), Pb, static_cast<const u64*>(kp), Pp,
      static_cast<const int*>(n_dev), n_b, n_p,
      static_cast<const int*>(scratch), aligned16(kb), aligned16(kp),
      aligned16(cnt) && aligned16(lo), static_cast<int*>(cnt),
      static_cast<int*>(lo));
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return static_cast<int>(err);
}

extern "C" const char* s18_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
