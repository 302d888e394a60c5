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
// because a TPU grid runs in order over VMEM tiles.  Here each block owns
// one chunk of kChunk sorted probe rows and FINDS its band of the build:
// two binary searches give the window [w0, w1) holding every match of the
// chunk (lower bound of its first live key, upper bound of its last).
// The window is staged in shared memory when it fits; then each thread
// finds lower and upper bounds for its rows inside it.  A hot key whose
// window does not fit is searched in place in global memory (L2-resident
// after the first probes), so there is no step cap and no fallback.
//
// What bounds it on this card: bytes.  It reads the two sorted u64 arrays
// (kb once per window, kp once) and writes two int32 per probe row;
// the searches cost O(log window) shared-memory reads per row.  Rows map
// to threads with a stride of kThreads, so every global read and write of
// a warp is coalesced.

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kChunk = kThreads * kRowsPerThread;  // probe rows per block
constexpr int kWindow = 4096;                      // staged keys: 32 KB

__device__ __forceinline__ int lower_bound(const u64* a, int lo, int hi,
                                           u64 k) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (a[mid] < k) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int upper_bound(const u64* a, int lo, int hi,
                                           u64 k) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (a[mid] <= k) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
stair_counts_kernel(const u64* __restrict__ kb, int Pb,
                    const u64* __restrict__ kp, int Pp,
                    const int* __restrict__ n_dev, int nb_arg, int np_arg,
                    int* __restrict__ cnt, int* __restrict__ lo) {
  __shared__ u64 win[kWindow];
  __shared__ int bounds[2];

  int nb = n_dev ? n_dev[0] : nb_arg;
  int np = n_dev ? n_dev[1] : np_arg;
  nb = min(max(nb, 0), Pb);
  np = min(max(np, 0), Pp);

  const int c0 = blockIdx.x * kChunk;
  const int c1 = min(c0 + kChunk, np);  // live rows of the chunk: [c0, c1)

  if (c0 < c1) {  // block-uniform
    if (threadIdx.x == 0) bounds[0] = lower_bound(kb, 0, nb, kp[c0]);
    if (threadIdx.x == 32) bounds[1] = upper_bound(kb, 0, nb, kp[c1 - 1]);
  }
  __syncthreads();
  const int w0 = c0 < c1 ? bounds[0] : 0;
  const int wn = c0 < c1 ? bounds[1] - w0 : 0;
  const bool staged = wn <= kWindow;
  if (staged) {
    for (int i = threadIdx.x; i < wn; i += kThreads) win[i] = kb[w0 + i];
  }
  __syncthreads();

  const u64* g = kb + w0;
  for (int r = threadIdx.x; r < kChunk; r += kThreads) {
    const int row = c0 + r;
    if (row >= Pp) break;
    int c = 0, l = 0;
    if (row < c1) {
      const u64 k = kp[row];
      int a, b;
      if (staged) {
        a = lower_bound(win, 0, wn, k);
        b = upper_bound(win, a, wn, k);
      } else {
        a = lower_bound(g, 0, wn, k);
        b = upper_bound(g, a, wn, k);
      }
      c = b - a;
      l = w0 + a;
    }
    cnt[row] = c;
    lo[row] = l;
  }
}

}  // namespace

// Launches on `stream`.  The live counts come either from the device
// (n_dev != nullptr: int32 [2] = {n_b, n_p}, so a count the device just
// computed needs no host sync) or from the host ints n_b, n_p.  Returns
// cudaGetLastError() right after the launch.
extern "C" int s18_stair_counts(const void* kb, int Pb, const void* kp,
                                int Pp, const void* n_dev, int n_b, int n_p,
                                void* cnt, void* lo, void* stream) {
  if (Pp <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (Pp + kChunk - 1) / kChunk;
  stair_counts_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(kb), Pb, static_cast<const u64*>(kp), Pp,
      static_cast<const int*>(n_dev), n_b, n_p, static_cast<int*>(cnt),
      static_cast<int*>(lo));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* s18_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
