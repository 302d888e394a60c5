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
// and 0 outside the windows.  Both counts come out of one pass.
//
// The TPU kernel keeps the build matrix resident in VMEM with the bucket on
// the lane axis, streams probe tiles from HBM, compares u32 limbs and sums
// in f32.  Here one block owns one bucket: it stages the live build window
// in shared memory (8 bytes per key) beside an int32 counter per build slot,
// its threads stride over the live probe window holding kRows probe keys
// each, scan the staged window once for all of them (every thread of a warp
// reads the same key: a shared-memory broadcast), count matches per probe
// slot in registers and add them per build slot with shared atomics.
// Padding slots are never compared.
//
// What bounds it on this card: the window scan, nb * np compares per
// bucket (about 2^9 x 2^9 per bucket at 2^21 rows), not bytes: it reads each
// key once and writes one int32 per slot.  A build row of Sb slots needs
// 12 * Sb bytes of dynamic shared memory; past 48 KB the launch raises the
// kernel's limit with cudaFuncSetAttribute, up to the block's 227 KB
// (Sb <= 19,370).

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kRows = 2;  // probe slots per thread per pass
constexpr int kMaxSharedBytes = 232448;  // per block on sm_90
constexpr int kBytesPerBuildSlot = 12;   // u64 key + int32 counter

__global__ void __launch_bounds__(kThreads)
probe_counts_kernel(const u64* __restrict__ kb, int Sb,
                    const int* __restrict__ wb, const u64* __restrict__ kp,
                    int Sp, const int* __restrict__ wp, int* __restrict__ mc,
                    int* __restrict__ pc) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* win = reinterpret_cast<u64*>(smem);
  int* cnt = reinterpret_cast<int*>(win + Sb);

  const long long b = blockIdx.x;
  const int blo = min(max(wb[2 * b], 0), Sb);
  const int bhi = min(max(wb[2 * b + 1], blo), Sb);
  const int plo = min(max(wp[2 * b], 0), Sp);
  const int phi = min(max(wp[2 * b + 1], plo), Sp);
  const int nw = bhi - blo;

  const u64* brow = kb + b * Sb + blo;
  for (int i = threadIdx.x; i < nw; i += kThreads) {
    win[i] = brow[i];
    cnt[i] = 0;
  }
  __syncthreads();

  const u64* prow = kp + b * Sp;
  int* pcrow = pc + b * Sp;
  for (int s = threadIdx.x; s < Sp; s += kThreads) {
    if (s < plo || s >= phi) pcrow[s] = 0;
  }
  for (int base = plo + threadIdx.x; base < phi; base += kThreads * kRows) {
    u64 k[kRows];
    int c[kRows];
    bool v[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = base + r * kThreads;
      v[r] = j < phi;
      k[r] = v[r] ? prow[j] : 0ull;
      c[r] = 0;
    }
    for (int i = 0; i < nw; ++i) {
      const u64 w = win[i];
      int m = 0;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int e = (v[r] && k[r] == w) ? 1 : 0;
        c[r] += e;
        m += e;
      }
      if (m) atomicAdd(&cnt[i], m);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (v[r]) pcrow[base + r * kThreads] = c[r];
    }
  }
  __syncthreads();

  int* mcrow = mc + b * Sb;
  for (int s = threadIdx.x; s < Sb; s += kThreads) {
    mcrow[s] = (s >= blo && s < bhi) ? cnt[s - blo] : 0;
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
  const long long bytes = static_cast<long long>(Sb) * kBytesPerBuildSlot;
  if (bytes > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    // set on the current device each time: the attribute is per device
    const cudaError_t err = cudaFuncSetAttribute(
        probe_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSharedBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  probe_counts_kernel<<<B, kThreads, static_cast<size_t>(bytes),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(kb), Sb, static_cast<const int*>(wb),
      static_cast<const u64*>(kp), Sp, static_cast<const int*>(wp),
      static_cast<int*>(mc), static_cast<int*>(pc));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* s18_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
