// Bucket slot fill of the radix and equi-depth join members, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel
// sigmod2018_tpu/ops/radix_join.py::_slotfill_kernel.  Contract: K source
// arrays src_k [N] (u64 bit patterns) are grouped by bucket, bucket b's
// rows being src_k[starts[b], starts[b] + cnts[b]).  Row b of each output
// out_k [B, SP] receives them in slots [0, cnts[b]); every other slot is 0,
// and so is any read past the end of the source.  out is one [K, B, SP]
// buffer.
//
// The TPU kernel DMAs a 1024-aligned SP-long segment per bucket (1-D HBM
// refs are 1024-tiled) and leaves the head misalignment for the probe
// kernel to mask.  Here a block copies a chunk of one bucket's row with no
// alignment constraint, so a bucket's window always starts at slot 0 and
// the slots past it are written as zeros instead of neighbouring buckets'
// rows.
//
// What bounds it on this card: bytes.  It reads each live row once
// (8 bytes per array) and writes the whole B x SP matrix of each array
// (8 bytes per slot, zeros included).  Neighbouring threads take
// neighbouring slots, so every read and write of a warp is coalesced.

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kSlotsPerBlock = 2048;  // 8 slots per thread
constexpr int kMaxArrays = 16;        // source pointers per launch

struct Sources {
  const u64* src[kMaxArrays];
};

__global__ void __launch_bounds__(kThreads)
slot_fill_kernel(Sources a, int K, long long N, const int* __restrict__ starts,
                 const int* __restrict__ cnts, int B, int SP,
                 u64* __restrict__ out) {
  const int b = blockIdx.x;
  const long long st = starts[b];
  const int cnt = min(max(cnts[b], 0), SP);
  const int s0 = blockIdx.y * kSlotsPerBlock;
  const int s1 = min(s0 + kSlotsPerBlock, SP);
  for (int k = 0; k < K; ++k) {
    const u64* src = a.src[k];
    u64* row = out + (static_cast<long long>(k) * B + b) * SP;
    for (int s = s0 + threadIdx.x; s < s1; s += kThreads) {
      const long long i = st + s;
      row[s] = (s < cnt && i >= 0 && i < N) ? src[i] : 0ull;
    }
  }
}

}  // namespace

// Launches on `stream` for K <= 16 sources (the caller splits larger K).
// srcs: a host array of K device pointers; starts, cnts: int32 [B] on the
// device; out: u64 [K, B, SP].  Returns cudaGetLastError() right after the
// launch.
extern "C" int s18_slot_fill(const void* const* srcs, int K, long long N,
                             const void* starts, const void* cnts, int B,
                             int SP, void* out, void* stream) {
  if (K <= 0 || B <= 0 || SP <= 0) return static_cast<int>(cudaSuccess);
  if (K > kMaxArrays) return static_cast<int>(cudaErrorInvalidValue);
  Sources a = {};
  for (int k = 0; k < K; ++k) a.src[k] = static_cast<const u64*>(srcs[k]);
  const dim3 grid(B, (SP + kSlotsPerBlock - 1) / kSlotsPerBlock);
  slot_fill_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, K, N, static_cast<const int*>(starts), static_cast<const int*>(cnts),
      B, SP, static_cast<u64*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int s18_slot_fill_max_sources() { return kMaxArrays; }

extern "C" const char* s18_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
