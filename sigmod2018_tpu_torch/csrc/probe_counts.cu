// Per-bucket dual match counts of the radix and equi-depth join members,
// for Hopper (sm_90a).
//
// Replaces the Pallas kernel
// sigmod2018_tpu/ops/radix_join.py::_probe_kernel.  Contract (the same, in
// bucket-major layout): kb [B, Sb] and kp [B, Sp] hold each bucket's build
// and probe keys (u64 bit patterns); wb, wp int32 [B, 2] give each bucket's
// live window [lo, hi) in its build and probe row.  For every bucket b
//   mc[b, i] = #{ j in wp[b] : kp[b, j] == kb[b, i] }   for i in wb[b]
//   pc[b, j] = #{ i in wb[b] : kb[b, i] == kp[b, j] }   for j in wp[b]
// and 0 outside the windows.  A window may hold its keys in any order.
//
// The TPU kernel compares every build slot with every probe slot of a
// bucket (u32 limbs, f32 sums).  Counting equal keys needs no product:
// with both windows sorted, pc[j] is the length of kp[j]'s equal range in
// the build window and mc[i] that of kb[i] in the probe window.  So:
//
// - The grid is (bucket, slot chunk of kChunk slots): block (b, ch) owns
//   mc[b, ch*kChunk ...] and pc[b, ch*kChunk ...], so a bucket of
//   thousands of rows spreads over many blocks, and every output slot has
//   one writer (plain stores, no atomics, no zero-fill pass).
// - A block stages the bucket's live build window in shared memory
//   (16-byte loads); if a block-wide check (__syncthreads_and) finds it
//   not ascending, it sorts it there (a bitonic network whose slots past
//   the window act as +inf, so any length works).  Each of its live probe
//   slots then takes pc from two binary searches.
// - The probe window goes the same way, in tiles when it is longer than
//   the shared memory left, and each live build slot of the block adds the
//   length of its equal range in every tile: mc.
// - Slots outside the windows get zeros in 16-byte stores.
//
// Both callers (the radix and qd members) pass ascending windows, so the
// sort is skipped there.  Work per bucket is about (nb + np) log(nb + np)
// instead of nb * np.  What bounds it on this card: bytes (the live keys
// read once, mc and pc written once; zeros are most of the output).  A
// block needs 8 * (Sb + tile) bytes of dynamic shared memory, tile =
// min(Sp, what is left of the block's 227 KB); Sb <= 19,370 leaves a tile
// of at least 9,686 slots.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kChunk = 1024;                 // output slots per block and side
constexpr int kSlots = kChunk / kThreads;    // per thread
constexpr int kMaxSharedBytes = 232448;      // per block on sm_90
constexpr int kMaxBuildSlots = 19370;        // the wrapper's limit

__device__ __forceinline__ int lower_bound(const u64* a, int n, u64 k) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < k) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int upper_bound(const u64* a, int lo, int n,
                                           u64 k) {
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= k) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Copies src[0, n) to dst[0, n), sorts it ascending if it is not, and
// ends with a barrier.  dst is 16-byte aligned; src is when `vec`.
__device__ void stage_sorted(u64* dst, const u64* __restrict__ src, int n,
                             bool vec) {
  if (vec) {
    const ulonglong2* s2 = reinterpret_cast<const ulonglong2*>(src);
    ulonglong2* d2 = reinterpret_cast<ulonglong2*>(dst);
    for (int i = threadIdx.x; i < (n >> 1); i += kThreads) d2[i] = __ldg(s2 + i);
    if ((n & 1) && threadIdx.x == 0) dst[n - 1] = __ldg(src + n - 1);
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = __ldg(src + i);
  }
  __syncthreads();
  bool ordered = true;
  for (int i = threadIdx.x; i + 1 < n; i += kThreads)
    ordered &= dst[i] <= dst[i + 1];
  if (__syncthreads_and(ordered)) return;  // block-uniform

  // Bitonic network over the next power of two, every comparator
  // ascending: the first step of each merge compares mirrored slots, the
  // rest are half-cleaners.  A slot >= n is +inf and never moves, so
  // comparators that reach it are skipped.
  int N = 1;
  while (N < n) N <<= 1;
  for (int k = 2; k <= N; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int shift = __ffs(j) - 1;  // j is a power of two
      for (int i = threadIdx.x; i < (N >> 1); i += kThreads) {
        const int off = i & (j - 1);
        const int a = ((i >> shift) << (shift + 1)) + off;
        const int b = j == (k >> 1) ? a - off + 2 * j - 1 - off : a + j;
        if (b < n) {
          const u64 x = dst[a], y = dst[b];
          if (x > y) {
            dst[a] = y;
            dst[b] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// row[s0, s1) = 0, 16 bytes a store where the address allows.
__device__ __forceinline__ void zero(int* row, int s0, int s1) {
  if (s0 >= s1) return;
  const int head = min(s1, s0 + static_cast<int>(
      ((16 - (reinterpret_cast<std::uintptr_t>(row + s0) & 15)) & 15) >> 2));
  const int body = head + ((s1 - head) & ~3);
  for (int s = s0 + threadIdx.x; s < head; s += kThreads) row[s] = 0;
  int4* r4 = reinterpret_cast<int4*>(row + head);
  for (int s = threadIdx.x; s < ((body - head) >> 2); s += kThreads)
    r4[s] = make_int4(0, 0, 0, 0);
  for (int s = body + threadIdx.x; s < s1; s += kThreads) row[s] = 0;
}

__global__ void __launch_bounds__(kThreads)
probe_counts_kernel(const u64* __restrict__ kb, int Sb,
                    const int* __restrict__ wb, const u64* __restrict__ kp,
                    int Sp, const int* __restrict__ wp, int nch, int tile,
                    int* __restrict__ mc, int* __restrict__ pc) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* sb = reinterpret_cast<u64*>(smem);  // sorted build window [Sb]
  u64* sp = sb + Sb + (Sb & 1);            // a sorted probe tile [tile]

  const long long b = blockIdx.x / nch;
  const int s0 = (blockIdx.x % nch) * kChunk;
  const int blo = min(max(wb[2 * b], 0), Sb);
  const int bhi = min(max(wb[2 * b + 1], blo), Sb);
  const int plo = min(max(wp[2 * b], 0), Sp);
  const int phi = min(max(wp[2 * b + 1], plo), Sp);
  const u64* brow = kb + b * Sb;
  const u64* prow = kp + b * Sp;
  int* mcrow = mc + b * Sb;
  int* pcrow = pc + b * Sp;

  // my live slots: build [i0, i1) and probe [j0, j1); empty when the other
  // window is, since their counts are then 0
  const int e_b = min(s0 + kChunk, Sb), e_p = min(s0 + kChunk, Sp);
  int i0 = max(s0, blo), i1 = min(e_b, bhi);
  int j0 = max(s0, plo), j1 = min(e_p, phi);
  if (phi == plo) i1 = i0;
  if (bhi == blo) j1 = j0;
  if (i1 <= i0) i0 = i1 = min(s0, Sb);
  if (j1 <= j0) j0 = j1 = min(s0, Sp);
  zero(mcrow, min(s0, Sb), i0);
  zero(mcrow, i1, e_b);
  zero(pcrow, min(s0, Sp), j0);
  zero(pcrow, j1, e_p);

  if (j1 > j0) {  // pc: probe keys searched in the sorted build window
    const int nw = bhi - blo;
    stage_sorted(sb, brow + blo, nw,
                 ((reinterpret_cast<std::uintptr_t>(brow + blo) & 15) == 0));
    for (int j = j0 + threadIdx.x; j < j1; j += kThreads) {
      const u64 k = __ldg(prow + j);
      const int lo = lower_bound(sb, nw, k);
      pcrow[j] = upper_bound(sb, lo, nw, k) - lo;
    }
  }

  if (i1 > i0) {  // mc: build keys searched in sorted probe tiles
    u64 k[kSlots];
    int acc[kSlots];
#pragma unroll
    for (int r = 0; r < kSlots; ++r) {
      const int i = i0 + threadIdx.x + r * kThreads;
      k[r] = i < i1 ? __ldg(brow + i) : 0ull;
      acc[r] = 0;
    }
    for (int t0 = plo; t0 < phi; t0 += tile) {  // block-uniform
      const int n = min(tile, phi - t0);
      __syncthreads();  // the previous tile is no longer read
      stage_sorted(sp, prow + t0, n,
                   ((reinterpret_cast<std::uintptr_t>(prow + t0) & 15) == 0));
#pragma unroll
      for (int r = 0; r < kSlots; ++r) {
        if (i0 + threadIdx.x + r * kThreads < i1) {
          const int lo = lower_bound(sp, n, k[r]);
          acc[r] += upper_bound(sp, lo, n, k[r]) - lo;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kSlots; ++r) {
      const int i = i0 + threadIdx.x + r * kThreads;
      if (i < i1) mcrow[i] = acc[r];
    }
  }
}

}  // namespace

// Launches on `stream`.  kb u64 [B, Sb], kp u64 [B, Sp], wb and wp int32
// [B, 2], mc int32 [B, Sb], pc int32 [B, Sp], all on the device.  Returns
// cudaErrorInvalidValue when a build row does not fit in shared memory,
// else cudaGetLastError() right after the launch.
extern "C" int s18_probe_counts(const void* kb, int Sb, const void* wb,
                                const void* kp, int Sp, const void* wp, int B,
                                void* mc, void* pc, void* stream) {
  if (B <= 0 || Sb <= 0 || Sp <= 0) return static_cast<int>(cudaSuccess);
  if (Sb > kMaxBuildSlots) return static_cast<int>(cudaErrorInvalidValue);
  const int build_slots = Sb + (Sb & 1);  // keeps the probe tile aligned
  const int tile = min(Sp, kMaxSharedBytes / 8 - build_slots);
  const int nch = (max(Sb, Sp) + kChunk - 1) / kChunk;
  if (static_cast<long long>(B) * nch > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = 8 * static_cast<size_t>(build_slots + tile);
  if (bytes > 48 * 1024) {
    // set on the current device each time: the attribute is per device
    const cudaError_t err = cudaFuncSetAttribute(
        probe_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSharedBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  probe_counts_kernel<<<B * nch, kThreads, bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(kb), Sb, static_cast<const int*>(wb),
      static_cast<const u64*>(kp), Sp, static_cast<const int*>(wp), nch, tile,
      static_cast<int*>(mc), static_cast<int*>(pc));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* s18_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
