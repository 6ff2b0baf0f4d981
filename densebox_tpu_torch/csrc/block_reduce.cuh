// One block-wide round of sums and a maximum with a single barrier, sm_90a:
// what every count of csrc/ohem.cu's bisections waits for. csrc/floor.cu
// times a chain of such rounds alone.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// Floats as unsigned keys of the same order (any finite value and the
// infinities), so that a maximum is one integer reduction.
__device__ __forceinline__ unsigned float_key(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// One block-wide round: up to four sums, or three and a float maximum, with
// one barrier; every thread gets the totals. Two ways, by the number of
// warps:
//   - a word vector per warp, double-buffered, which every thread adds up
//     after the barrier (cheapest at 4 warps: one vector load a warp);
//   - shared-memory atomics into one vector, which every thread reads after
//     the barrier; three vectors in turn, the next one zeroed before the
//     barrier (it was last read two barriers ago), so the cost after the
//     barrier does not grow with the warps.
template <int THREADS, bool ATOMIC>
struct Reducer {
  static constexpr int kWarps = THREADS / 32;
  static constexpr int kWords = ATOMIC ? 3 * 4 : 2 * 4 * kWarps;
  unsigned* buf;  // kWords words in shared memory, 16-byte aligned, zero
  int phase;

  template <int NA, bool MAX>
  __device__ __forceinline__ void run(unsigned (&a)[4], float& m) {
#pragma unroll
    for (int k = 0; k < NA; ++k) a[k] = __reduce_add_sync(kFull, a[k]);
    if (MAX) a[3] = __reduce_max_sync(kFull, float_key(m));
    const bool first = (threadIdx.x & 31) == 0;
    uint4 t;
    if (ATOMIC) {
      unsigned* cur = buf + 4 * phase;
      phase = phase == 2 ? 0 : phase + 1;
      if (first) {
#pragma unroll
        for (int k = 0; k < NA; ++k) atomicAdd(cur + k, a[k]);
        if (MAX) atomicMax(cur + 3, a[3]);
      }
      if (threadIdx.x < 4) buf[4 * phase + threadIdx.x] = 0u;
      __syncthreads();
      t = *reinterpret_cast<const uint4*>(cur);
    } else {
      uint4* slot = reinterpret_cast<uint4*>(buf) + phase * kWarps;
      phase ^= 1;
      if (first) slot[threadIdx.x >> 5] = make_uint4(a[0], a[1], a[2], a[3]);
      __syncthreads();
      t = slot[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        const uint4 o = slot[w];
        t.x += o.x;
        t.y += o.y;
        t.z += o.z;
        t.w = MAX ? max(t.w, o.w) : t.w + o.w;
      }
    }
    a[0] = t.x;
    a[1] = t.y;
    a[2] = t.z;
    a[3] = t.w;
    if (MAX) m = key_float(t.w);
  }

  // one sum (at most 16384 a block)
  __device__ __forceinline__ int sum(int v) {
    unsigned a[4] = {(unsigned)v, 0u, 0u, 0u};
    float unused = 0.f;
    run<1, false>(a, unused);
    return (int)a[0];
  }

  // one sum and one maximum
  __device__ __forceinline__ int sum_max(int v, float& m) {
    unsigned a[4] = {(unsigned)v, 0u, 0u, 0u};
    run<1, true>(a, m);
    return (int)a[0];
  }
};

// By the chain's timing on an H100 (a round takes 0.070, 0.126 and 0.337 us
// at 4, 8 and 16 warps through per-warp vectors and 0.090, 0.096 and 0.112
// through atomics): atomics from 8 warps on.
template <int THREADS>
using BlockReducer = Reducer<THREADS, (THREADS > 128)>;

}  // namespace
