// OHEM hard-negative selection by threshold bisection, sm_90a.
//
// Replaces densebox_tpu/ops/pallas/ohem.py:_ohem_kernel (with
// _count_threshold, behind ohem_mask_pallas). Same contract as its plain
// PyTorch version, densebox_tpu_torch/ops/kernels/ohem.py:
// ohem_select_reference. Per sample over P pixels, from the squared
// classification error sq, the positive and gray-zone flags and uniform noise
// rnd (drawn by the caller):
//   candidates    = ~pos & ~ign
//   n_neg         = round_half_even(ratio * n_pos), or min_neg when n_pos = 0,
//                   capped by the number of candidates
//   n_hard        = floor(hard_frac * n_neg), n_rand = n_neg - n_hard
//   threshold(v, set, n): lo = -1, hi = max(v over set, else 0) + 1; 40 times
//                   mid = 0.5 * (lo + hi); if count(set & v > mid) > n then
//                   lo = mid else hi = mid; the result is hi
//   above         = candidates with sq > threshold(sq, candidates, n_hard)
//   ties          = candidates with sq == max(sq over candidates not above)
//   hard          = above | ties with rnd > threshold(rnd, ties,
//                   n_hard - |above|)
//   rand          = (candidates not hard) with rnd > threshold(rnd, those,
//                   n_rand)
//   mask          = pos | hard | rand
// The bisection is followed literally, in float32: 40 halvings of an interval
// of width max + 2 do not separate values closer than about (max + 2) * 2^-40,
// and that, like the noise-ordered tie class, is part of what the TPU kernel
// computes. A sort or a radix select would compute something else.
//
// What bounds it on the card: latency. A sample reads 10 bytes a pixel and
// writes one (B=32, P=3600: 1.15 MB read, 0.12 MB written, well under a
// microsecond of HBM time), while the three bisections are 120 dependent
// block-wide counts. The TPU kernel's unit middle axis and VMEM block specs
// answer TPU constraints and have no counterpart. The design:
//   - one block of 512 threads per sample, all samples in one launch;
//   - each thread keeps its pixels (element j * 512 + tid, so that loads
//     coalesce) in registers: ITEMS values of sq and rnd, and the flags as
//     bits of one word; ITEMS (1..32, a power of two) is a template
//     parameter picked from P, so P <= 16384;
//   - a count or a maximum is a warp reduction, one word per warp in shared
//     memory and one __syncthreads(); the words are double-buffered so that
//     one barrier per reduction is enough. Every thread then adds the 16
//     words itself and carries lo, hi and the counts redundantly: no
//     broadcast step.
// Counts are integers, so the result does not depend on the order of the
// reduction: the mask equals the plain version's and the TPU kernel's bit
// for bit. Inputs are expected finite (a NaN error is dropped by fmaxf where
// jnp.max would carry it).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBisectIters = 40;

struct Reducer {
  unsigned (*buf)[kWarps];  // [2][kWarps] in shared memory
  int phase;

  __device__ __forceinline__ void put(unsigned v) {
    if ((threadIdx.x & 31) == 0) buf[phase][threadIdx.x >> 5] = v;
    __syncthreads();
  }
  __device__ __forceinline__ int sum(int v) {
    put((unsigned)__reduce_add_sync(0xffffffffu, v));
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += (int)buf[phase][w];
    phase ^= 1;
    return s;
  }
  __device__ __forceinline__ float maxf(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    put(__float_as_uint(v));
    float m = __uint_as_float(buf[phase][0]);
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      m = fmaxf(m, __uint_as_float(buf[phase][w]));
    phase ^= 1;
    return m;
  }
};

// Bits of `set` whose value is above `t`.
template <int ITEMS>
__device__ __forceinline__ unsigned above_bits(const float (&v)[ITEMS],
                                               unsigned set, float t) {
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if (v[j] > t) bits |= 1u << j;
  return bits & set;
}

template <int ITEMS>
__device__ float count_threshold(Reducer& red, const float (&v)[ITEMS],
                                 unsigned set, int n_want) {
  float local = 0.f;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if ((set >> j) & 1u) local = fmaxf(local, v[j]);
  float hi = __fadd_rn(red.maxf(local), 1.0f);
  float lo = -1.0f;
  for (int it = 0; it < kBisectIters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    const int cnt = red.sum(__popc(above_bits<ITEMS>(v, set, mid)));
    if (cnt > n_want)
      lo = mid;
    else
      hi = mid;
  }
  return hi;
}

template <int ITEMS>
__global__ void __launch_bounds__(kThreads)
ohem_kernel(const float* __restrict__ sq, const float* __restrict__ rnd,
            const uint8_t* __restrict__ pos, const uint8_t* __restrict__ ign,
            uint8_t* __restrict__ mask, int p, float ratio, float hard_frac,
            int min_neg) {
  __shared__ unsigned buf[2][kWarps];
  Reducer red{buf, 0};
  const size_t base = (size_t)blockIdx.x * p;
  float v[ITEMS], u[ITEMS];
  unsigned is_pos = 0, cand = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = j * kThreads + threadIdx.x;
    v[j] = 0.f;
    u[j] = 0.f;
    if (i < p) {
      v[j] = sq[base + i];
      u[j] = rnd[base + i];
      const bool ps = pos[base + i] != 0;
      const bool ig = ign[base + i] != 0;
      if (ps) is_pos |= 1u << j;
      if (!ps && !ig) cand |= 1u << j;
    }
  }
  const int n_pos = red.sum(__popc(is_pos));
  const int n_cand = red.sum(__popc(cand));
  int n_neg = n_pos > 0 ? (int)rintf(__fmul_rn(ratio, (float)n_pos)) : min_neg;
  n_neg = min(n_neg, n_cand);
  const int n_hard = (int)floorf(__fmul_rn(hard_frac, (float)n_neg));
  const int n_rand = n_neg - n_hard;

  const float t_hard = count_threshold<ITEMS>(red, v, cand, n_hard);
  const unsigned above = above_bits<ITEMS>(v, cand, t_hard);
  const int n_above = red.sum(__popc(above));
  float local = -INFINITY;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if (((cand & ~above) >> j) & 1u) local = fmaxf(local, v[j]);
  const float vstar = red.maxf(local);
  unsigned ties = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if (v[j] == vstar) ties |= 1u << j;
  ties &= cand;
  const float t_tie = count_threshold<ITEMS>(red, u, ties, n_hard - n_above);
  const unsigned hard = above | above_bits<ITEMS>(u, ties, t_tie);

  const unsigned rand_cand = cand & ~hard;
  const float t_rand = count_threshold<ITEMS>(red, u, rand_cand, n_rand);
  const unsigned keep = is_pos | hard | above_bits<ITEMS>(u, rand_cand, t_rand);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = j * kThreads + threadIdx.x;
    if (i < p) mask[base + i] = (uint8_t)((keep >> j) & 1u);
  }
}

template <int ITEMS>
void launch(const float* sq, const float* rnd, const uint8_t* pos,
            const uint8_t* ign, uint8_t* mask, int batch, int p, float ratio,
            float hard_frac, int min_neg, cudaStream_t st) {
  ohem_kernel<ITEMS><<<batch, kThreads, 0, st>>>(sq, rnd, pos, ign, mask, p,
                                                 ratio, hard_frac, min_neg);
}

}  // namespace

// sq, rnd (B, P) float32; pos, ign (B, P) bytes (0 or 1); mask (B, P) bytes
// out. All contiguous on the current device; 1 <= P <= 16384. Launches on
// `stream`, does not synchronise; returns the CUDA error code (0 = launched).
extern "C" int densebox_ohem_select(const void* sq, const void* rnd,
                                    const void* pos, const void* ign,
                                    void* mask, int batch, int p, float ratio,
                                    float hard_frac, int min_neg,
                                    void* stream) {
  if (batch < 1 || p < 1 || p > 32 * kThreads || min_neg < 0)
    return (int)cudaErrorInvalidValue;
  const float* a = (const float*)sq;
  const float* r = (const float*)rnd;
  const uint8_t* ps = (const uint8_t*)pos;
  const uint8_t* ig = (const uint8_t*)ign;
  uint8_t* out = (uint8_t*)mask;
  cudaStream_t st = (cudaStream_t)stream;
  const int items = (p + kThreads - 1) / kThreads;
  if (items <= 1)
    launch<1>(a, r, ps, ig, out, batch, p, ratio, hard_frac, min_neg, st);
  else if (items <= 2)
    launch<2>(a, r, ps, ig, out, batch, p, ratio, hard_frac, min_neg, st);
  else if (items <= 4)
    launch<4>(a, r, ps, ig, out, batch, p, ratio, hard_frac, min_neg, st);
  else if (items <= 8)
    launch<8>(a, r, ps, ig, out, batch, p, ratio, hard_frac, min_neg, st);
  else if (items <= 16)
    launch<16>(a, r, ps, ig, out, batch, p, ratio, hard_frac, min_neg, st);
  else
    launch<32>(a, r, ps, ig, out, batch, p, ratio, hard_frac, min_neg, st);
  return (int)cudaGetLastError();
}
