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
// computes. A sort or a radix select would compute something else. Every
// shortening below reproduces the literal sequence of (lo, hi) exactly: it
// only changes who counts what, and counts are integers.
//
// What bounds it on the card: latency, not bytes or operations. A sample
// reads 10 bytes a pixel and writes one (B=32, P=3600: 1.27 MB, under a
// microsecond of HBM time), B blocks leave most of the 132 SMs empty, and a
// bisection is a chain of 40 steps that each wait for a count over the whole
// sample. The time is the length of that chain: block-wide rounds (a warp
// reduction, shared memory, a barrier: 0.07 to 0.1 us each, and with one
// block on an SM the compares of every value before it as well), then
// whatever one warp can do alone. The TPU kernel's unit middle axis and VMEM
// block specs answer TPU constraints and have no counterpart. The design
// takes steps off the chain, and makes those that stay cheaper:
//   - one block per sample, all samples in one launch; each thread keeps its
//     pixels (element j * THREADS + tid, so that loads coalesce) in
//     registers, flags as bits of one word. THREADS and ITEMS are template
//     parameters, picked from P (256 x 16 at P=3600), P <= 16384;
//   - a bisection that can never see a count above its quota (the set holds
//     no more than n_want elements: a sample with few candidates) halves hi
//     40 times in every thread alone, with no count at all; so does a level
//     whose mid is at or above the set's maximum (nothing lies above it);
//   - a block-wide round is one barrier (block_reduce.cuh): per-warp sums
//     go to shared memory as one vector a warp, or, from 8 warps on, through
//     shared-memory atomics into one vector of three taken in turn, so that
//     what follows the barrier does not grow with the warps; the sums and
//     the maximum that open each bisection share a round (four rounds
//     outside the bisections);
//   - a round counts one level. lo and hi move by mid = 0.5f * (lo + hi), so
//     the 2^R - 1 mids of the next R levels could be counted in one round
//     and walked with the counts in hand; timed at B=32, P=3600 on an H100
//     that lost (R = 1, 2, 3: 10.7, 11.1, 12.2 us on the errors of a real
//     forward, 14.3, 16.2, 18.3 us where every candidate ties): with one
//     block on an SM the 2^R - 1 compares of every value sit on the chain
//     too, and once a round costs 0.1 us and the warp takes over after a few
//     levels there is little left to save;
//   - as soon as no more than 256 elements of the set lie in (lo, hi], they
//     are the only ones whose comparison can still change. They are gathered
//     into shared memory and one warp finishes the remaining levels alone,
//     with no block barrier: count(v > mid) is the count above hi, which no
//     longer changes, plus the list's. The warp holds eight values a lane
//     and reduces once a level; at 32 elements it re-gathers to one a lane
//     and counts with a vote; with one element x left a level is
//     "lo = mid if x > mid (and counting x exceeds the quota), else
//     hi = mid", a few dependent operations. With continuous errors and a
//     quota far below P the warp takes over after 3 to 8 levels and is down
//     to one element some 8 levels later; the usual tie class is one pixel
//     and goes to the warp at once. A sample whose candidates all tie never
//     gets there and runs all 40 levels of that bisection as block rounds.
// Counts are integers, so the result does not depend on the order of the
// reduction: the mask equals the plain version's and the TPU kernel's bit
// for bit. Inputs are expected finite with 2 * (max + 1) finite (so that
// lo <= mid <= hi at every level; a NaN error is dropped where jnp.max
// would carry it). densebox_tpu_torch/ops/kernels/ohem.py:staged_threshold
// is this schedule in numpy, held to the literal 40 steps by the CPU tests.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_reduce.cuh"

namespace {

constexpr int kBisectIters = 40;
constexpr int kListPerLane = 8;
constexpr int kListCap = 32 * kListPerLane;

__device__ __forceinline__ float midpoint(float lo, float hi) {
  return __fmul_rn(0.5f, __fadd_rn(lo, hi));
}

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

// max(v over set), `none` for an empty set
template <int ITEMS>
__device__ __forceinline__ float set_max(const float (&v)[ITEMS], unsigned set,
                                         float none) {
  float m = none;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if ((set >> j) & 1u) m = fmaxf(m, v[j]);
  return m;
}

// `left` literal levels when the element x alone decides them: a count
// exceeds the quota exactly where x lies above mid (x = -inf: never). Both
// next mids are formed while x is compared, so a level is a compare and a
// select deep.
__device__ __forceinline__ float walk_to(float x, float lo, float hi,
                                         int left) {
  float mid = midpoint(lo, hi);
#pragma unroll 8
  for (; left > 0; --left) {
    const float up = midpoint(mid, hi), down = midpoint(lo, mid);
    const bool above = x > mid;
    lo = above ? mid : lo;
    hi = above ? hi : mid;
    mid = above ? up : down;
  }
  return hi;
}

struct Scratch {
  float list[kListCap];
  int n_list;  // zero between gathers
  float result;
};

// The threshold of the contract above. `n_set` is the number of elements of
// `set` in the block and `smax` the block's max(v over set), -inf for an
// empty set, both known to every thread.
template <int THREADS, int ITEMS>
__device__ float count_threshold(BlockReducer<THREADS>& red, Scratch& sh,
                                 const float (&v)[ITEMS], unsigned set,
                                 int n_set, float smax, int n_want) {
  const float vmax = fmaxf(smax, 0.f);
  float hi = __fadd_rn(vmax, 1.0f);
  float lo = -1.0f;
  // No count can exceed the quota: hi = mid at every level. A set of one
  // element (the usual tie class) is its maximum: that element decides.
  if (n_set <= n_want) return walk_to(-INFINITY, lo, hi, kBisectIters);
  if (n_set == 1) return walk_to(smax, lo, hi, kBisectIters);
  // counts of set elements above lo (an upper bound until lo first moves)
  // and above hi (exact: nothing lies above max + 1)
  int cnt_lo = n_set, cnt_hi = 0;
  int left = kBisectIters;
  while (left > 0 && cnt_lo - cnt_hi > kListCap) {
    const float mid = midpoint(lo, hi);
    --left;
    if (mid >= vmax) {  // nothing lies above it: no count needed
      hi = mid;
      cnt_hi = 0;
      continue;
    }
    const int c = red.sum(__popc(above_bits<ITEMS>(v, set, mid)));
    if (c > n_want) {
      lo = mid;
      cnt_lo = c;
    } else {
      hi = mid;
      cnt_hi = c;
    }
  }
  if (left == 0) return hi;

  // Gather the set's elements in (lo, hi]: at most kListCap of them.
  unsigned act = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if (v[j] > lo && v[j] <= hi) act |= 1u << j;
  act &= set;
  const int lane = threadIdx.x & 31;
  const int mine = __popc(act);
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  int base = 0;
  if (lane == 31 && incl > 0) base = atomicAdd(&sh.n_list, incl);
  base = __shfl_sync(kFull, base, 31);
  if (act) {
    int slot = base + incl - mine;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      if ((act >> j) & 1u) {
        if (slot < kListCap) sh.list[slot] = v[j];
        ++slot;
      }
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    // One warp walks the remaining levels. The elements above hi stay above
    // every further mid (cnt_hi of them), those at or below lo stay below,
    // so a count is cnt_hi plus the list's. The list shrinks as the interval
    // does: eight values a lane while more than 32 are inside, then one a
    // lane and a vote, then, with one element left inside, no vote at all.
    const int n = min(sh.n_list, kListCap);
    float w[kListPerLane];
    unsigned in = 0;
#pragma unroll
    for (int i = 0; i < kListPerLane; ++i) {
      const int k = lane + 32 * i;
      w[i] = k < n ? sh.list[k] : 0.f;
      if (k < n) in |= 1u << i;
    }
    int a_lo = n, a_hi = 0;  // list elements above lo and above hi
    while (left > 0 && a_lo - a_hi > 32) {
      const float mid = midpoint(lo, hi);
      const int c = (int)__reduce_add_sync(
          kFull, (unsigned)__popc(above_bits<kListPerLane>(w, in, mid)));
      const bool many = cnt_hi + c > n_want;
      lo = many ? mid : lo;
      hi = many ? hi : mid;
      a_lo = many ? c : a_lo;
      a_hi = many ? a_hi : c;
      --left;
    }
    if (left > 0) {
      // the at most 32 elements in (lo, hi], one a lane
      unsigned keep = 0;
#pragma unroll
      for (int i = 0; i < kListPerLane; ++i)
        if (w[i] > lo && w[i] <= hi) keep |= 1u << i;
      keep &= in;
      const int have = __popc(keep);
      int upto = have;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, upto, o);
        if (lane >= o) upto += t;
      }
      __syncwarp();
      int at = upto - have;
#pragma unroll
      for (int i = 0; i < kListPerLane; ++i)
        if ((keep >> i) & 1u) sh.list[at++] = w[i];
      __syncwarp();
      const int inside = a_lo - a_hi;
      const float x = lane < inside ? sh.list[lane] : -INFINITY;
      const int above = cnt_hi + a_hi;  // of the set, above hi
      int b_lo = inside, b_hi = 0;      // of these, above lo and above hi
      while (left > 0 && b_lo - b_hi > 1) {
        const float mid = midpoint(lo, hi);
        const int c = __popc(__ballot_sync(kFull, x > mid));
        const bool many = above + c > n_want;
        lo = many ? mid : lo;
        hi = many ? hi : mid;
        b_lo = many ? c : b_lo;
        b_hi = many ? b_hi : c;
        --left;
      }
      if (left > 0) {
        // at most one element is left in (lo, hi]: a count is the count
        // above hi, plus one where that element lies above mid
        const unsigned who = __ballot_sync(kFull, x > lo && x <= hi);
        const float last = __shfl_sync(kFull, x, who ? __ffs((int)who) - 1 : 0);
        const bool with_it = who != 0 && above + b_hi + 1 > n_want;
        hi = walk_to(with_it ? last : -INFINITY, lo, hi, left);
      }
    }
    if (lane == 0) sh.result = hi;
  }
  __syncthreads();
  hi = sh.result;
  // the next gather's first atomicAdd comes after a round's barrier
  if (threadIdx.x == 0) sh.n_list = 0;
  return hi;
}

template <int THREADS, int ITEMS>
__global__ void __launch_bounds__(THREADS)
ohem_kernel(const float* __restrict__ sq, const float* __restrict__ rnd,
            const uint8_t* __restrict__ pos, const uint8_t* __restrict__ ign,
            uint8_t* __restrict__ mask, int p, float ratio, float hard_frac,
            int min_neg) {
  __shared__ __align__(16) unsigned buf[BlockReducer<THREADS>::kWords];
  __shared__ Scratch sh;
  BlockReducer<THREADS> red{buf, 0};
  if (threadIdx.x == 0) sh.n_list = 0;
  for (int i = threadIdx.x; i < BlockReducer<THREADS>::kWords; i += THREADS)
    buf[i] = 0u;
  __syncthreads();
  const size_t base = (size_t)blockIdx.x * p;
  float v[ITEMS], u[ITEMS];
  unsigned is_pos = 0, cand = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = j * THREADS + threadIdx.x;
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
  // round 1: positives, candidates, the candidates' largest error
  unsigned a[4] = {(unsigned)__popc(is_pos), (unsigned)__popc(cand), 0u, 0u};
  float vmax = set_max<ITEMS>(v, cand, -INFINITY);
  red.template run<2, true>(a, vmax);
  const int n_pos = (int)a[0];
  const int n_cand = (int)a[1];
  int n_neg = n_pos > 0 ? (int)rintf(__fmul_rn(ratio, (float)n_pos)) : min_neg;
  n_neg = min(n_neg, n_cand);
  const int n_hard = (int)floorf(__fmul_rn(hard_frac, (float)n_neg));
  const int n_rand = n_neg - n_hard;

  const float t_hard = count_threshold<THREADS, ITEMS>(
      red, sh, v, cand, n_cand, vmax, n_hard);
  const unsigned above = above_bits<ITEMS>(v, cand, t_hard);
  // round 2: how many lie above, and the largest error of the rest
  float vstar = set_max<ITEMS>(v, cand & ~above, -INFINITY);
  const int n_above = red.sum_max(__popc(above), vstar);
  unsigned ties = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if (v[j] == vstar) ties |= 1u << j;
  ties &= cand;
  // round 3: the tie class and its largest noise
  float umax = set_max<ITEMS>(u, ties, -INFINITY);
  const int n_ties = red.sum_max(__popc(ties), umax);
  const float t_tie = count_threshold<THREADS, ITEMS>(
      red, sh, u, ties, n_ties, umax, n_hard - n_above);
  const unsigned hard = above | above_bits<ITEMS>(u, ties, t_tie);

  // round 4: what is left to draw the random part from
  const unsigned rand_cand = cand & ~hard;
  umax = set_max<ITEMS>(u, rand_cand, -INFINITY);
  const int n_rc = red.sum_max(__popc(rand_cand), umax);
  const float t_rand = count_threshold<THREADS, ITEMS>(
      red, sh, u, rand_cand, n_rc, umax, n_rand);
  const unsigned keep = is_pos | hard | above_bits<ITEMS>(u, rand_cand, t_rand);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = j * THREADS + threadIdx.x;
    if (i < p) mask[base + i] = (uint8_t)((keep >> j) & 1u);
  }
}

struct Args {
  const float* sq;
  const float* rnd;
  const uint8_t* pos;
  const uint8_t* ign;
  uint8_t* mask;
  int batch, p;
  float ratio, hard_frac;
  int min_neg;
  cudaStream_t st;
};

template <int THREADS, int ITEMS>
void launch(const Args& a) {
  ohem_kernel<THREADS, ITEMS><<<a.batch, THREADS, 0, a.st>>>(
      a.sq, a.rnd, a.pos, a.ign, a.mask, a.p, a.ratio, a.hard_frac,
      a.min_neg);
}

// values a thread holds: the smallest power of two that covers P
int items_for(int p, int threads) {
  const int need = (p + threads - 1) / threads;
  int items = 1;
  while (items < need) items *= 2;
  return items;
}

// The block the kernel takes for P pixels: at most 16 values a thread up to
// 256 threads (P=3600 on an H100: 256 x 16 took 10.7 us, 128 x 32 11.3,
// 512 x 8 10.6; where every candidate ties 14.3, 14.7, 14.7), then 32 values
// a thread.
int threads_for(int p) { return p <= 2048 ? 128 : p <= 8192 ? 256 : 512; }

bool dispatch(const Args& a) {
  const int threads = threads_for(a.p);
  const int items = items_for(a.p, threads);
#define OHEM_CASE(T, I)            \
  if (threads == T && items == I) { \
    launch<T, I>(a);               \
    return true;                   \
  }
  OHEM_CASE(128, 1)
  OHEM_CASE(128, 2)
  OHEM_CASE(128, 4)
  OHEM_CASE(128, 8)
  OHEM_CASE(128, 16)
  OHEM_CASE(256, 16)
  OHEM_CASE(256, 32)
  OHEM_CASE(512, 32)
#undef OHEM_CASE
  return false;
}

}  // namespace

// sq, rnd (B, P) float32; pos, ign (B, P) bytes (0 or 1); mask (B, P)
// bytes out. All contiguous on the current device; 1 <= P <= 16384.
// Launches on `stream`, does not synchronise; returns the CUDA error code
// (0 = launched).
extern "C" int densebox_ohem_select(const void* sq, const void* rnd,
                                    const void* pos, const void* ign,
                                    void* mask, int batch, int p, float ratio,
                                    float hard_frac, int min_neg,
                                    void* stream) {
  if (batch < 1 || p < 1 || p > 16384 || min_neg < 0)
    return (int)cudaErrorInvalidValue;
  const Args a{(const float*)sq,    (const float*)rnd, (const uint8_t*)pos,
               (const uint8_t*)ign, (uint8_t*)mask,    batch,
               p,                   ratio,             hard_frac,
               min_neg,             (cudaStream_t)stream};
  if (!dispatch(a)) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Threads of the block (one a sample) that a launch over P pixels takes.
extern "C" int densebox_ohem_block_threads(int p) { return threads_for(p); }
