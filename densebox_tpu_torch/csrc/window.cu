// Landmark window gather from stacked per-scale heatmaps, sm_90a.
//
// Replaces densebox_tpu/ops/pallas/window.py:_kernel (behind
// gather_windows_pallas). Same contract as its plain PyTorch version,
// densebox_tpu_torch/ops/kernels/window.py:gather_windows_reference: for
// maps (B, S, L, Hm, Wm), sel (B, D) and origins y0, x0 (B, D, L) or
// (B, D, 1), out[b, d, l] is the (win, win) window of maps[b, sel[b, d], l]
// at row y0, column x0 (origins of shape (B, D, 1) serve every landmark
// channel). The caller clips origins to the selected scale's map.
//
// What bounds it on the card: bytes, if the copy is written so that the
// memory system and not the address arithmetic is busy. It is a pure copy;
// at the MALF serve shape (B=8, D=64, L=5, win=32, bf16) it reads and writes
// 5.2 MB each, 3.1 us at the HBM rate, next to a few microseconds for the
// launch to fill the card. Moving one element a thread (two integer
// divisions, two origin loads, two clamps per 2 bytes) took four times that.
// The TPU kernel's mechanics (8/128-aligned strip DMAs, one-hot matmuls that
// pick the window out of the strip, indices packed into one SMEM word, the dp
// queue depth) answer TPU constraints and have no counterpart here. The
// design moves rows, not elements:
//   - one block per (image, detection), all of them in one launch; the block
//     reads its sel and its origins once, clamps them into the map and keeps
//     them in shared memory (there is no scalar prefetch);
//   - a window row (win elements: 64 bytes in bf16 at win 32) is written as
//     16-byte vectors, one thread a vector; a thread's row and landmark
//     advance by a fixed stride with a carry, so the loop divides nothing;
//   - a source row starts at any element, so a thread loads the one or two
//     aligned 16-byte words that cover its vector and shifts them together in
//     registers (a word select and a funnel shift); it loads a word only if
//     it holds a byte of the window, so it never leaves the tensor's 16-byte
//     granules;
//   - a thread fetches the words of two rows before it stores the first, and
//     the blocks of a launch are all resident at once (4 per SM at the MALF
//     shape), which keeps about 30 KB of loads in flight per SM.
// TMA is not used: a tensor map needs row pitches that are multiples of 16
// bytes, and a map row is Wm elements (228 bf16 = 456 bytes at the MALF
// shape, odd widths elsewhere); the copy is 10 MB of independent 64-byte
// rows, which plain vector loads already keep in flight.
// Bits move as they are, so the copy is exact in any dtype. Where
// win * elem_size is no multiple of 16 (or the row has more than 256
// vectors) the element kernel below copies one element a thread.
// sel and the origins are clamped into the tensor (the origin, so that the
// whole window lies inside its map, as the plain version clamps it): no
// index can make either kernel read outside `maps`; callers that keep the
// contract (in-range origins, as the detector's clipping gives) never reach
// the clamp. Fusing the peak search
// into the gather would be another function than the TPU kernel's and is not
// done here.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// The 16 bytes at `src` (any element-aligned address) from the aligned
// words that cover them.
struct Covering {
  uint4 a, b;
  unsigned shift;  // bytes of `a` before the first wanted one
};

__device__ __forceinline__ Covering fetch(const uint8_t* src) {
  Covering c;
  c.shift = (unsigned)((uintptr_t)src & 15u);
  const uint4* w = reinterpret_cast<const uint4*>(src - c.shift);
  c.a = __ldg(w);
  c.b = c.shift ? __ldg(w + 1) : make_uint4(0u, 0u, 0u, 0u);
  return c;
}

__device__ __forceinline__ uint4 realign(const Covering& c) {
  const unsigned w[8] = {c.a.x, c.a.y, c.a.z, c.a.w,
                         c.b.x, c.b.y, c.b.z, c.b.w};
  const unsigned ws = c.shift >> 2;         // whole words to skip
  const unsigned bits = (c.shift & 3u) * 8u;  // and bytes of the next one
  unsigned t[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    t[i] = ws == 0 ? w[i] : ws == 1 ? w[i + 1] : ws == 2 ? w[i + 2] : w[i + 3];
  return make_uint4(__funnelshift_r(t[0], t[1], bits),
                    __funnelshift_r(t[1], t[2], bits),
                    __funnelshift_r(t[2], t[3], bits),
                    __funnelshift_r(t[3], t[4], bits));
}

// Rows of `row_bytes` = win * esz bytes, a multiple of 16; `vecs` =
// row_bytes / 16 <= blockDim.x; out 16-byte aligned.
__global__ void __launch_bounds__(kThreads)
window_rows_kernel(const uint8_t* __restrict__ maps,
                   const int* __restrict__ sel, const int* __restrict__ y0,
                   const int* __restrict__ x0, uint8_t* __restrict__ out,
                   int scales, int num_lm, int hm, int wm, int dets, int lo,
                   int win, int esz, int vecs) {
  extern __shared__ int org[];  // y origins [lo], then x origins [lo]
  const int bd = blockIdx.x;    // b * D + d
  for (int i = threadIdx.x; i < lo; i += blockDim.x) {
    org[i] = clampi(y0[(size_t)bd * lo + i], 0, hm - win);
    org[lo + i] = clampi(x0[(size_t)bd * lo + i], 0, wm - win);
  }
  __syncthreads();
  const int vec = threadIdx.x % vecs;
  const int first = threadIdx.x / vecs;
  const int step = blockDim.x / vecs;  // rows the block covers in one pass
  if (first >= step) return;
  const int step_l = step / win, step_r = step % win;
  const int b = bd / dets;
  const int s = clampi(sel[bd], 0, scales - 1);
  const size_t row_bytes = (size_t)win * esz;
  const size_t pitch = (size_t)wm * esz;
  const size_t plane = (size_t)hm * pitch;
  const uint8_t* src = maps + ((size_t)b * scales + s) * num_lm * plane;
  uint8_t* dst = out + (size_t)bd * num_lm * win * row_bytes + 16 * vec;
  const int shared = lo == 1;

  auto source = [&](int l, int row) {
    const int oi = shared ? 0 : l;
    return src + l * plane + (size_t)(org[oi] + row) * pitch +
           (size_t)org[lo + oi] * esz + 16 * vec;
  };
  auto target = [&](int l, int row) {
    return reinterpret_cast<uint4*>(dst + ((size_t)l * win + row) * row_bytes);
  };
  int l = first / win, row = first % win;
  while (l < num_lm) {
    int l2 = l + step_l, row2 = row + step_r;
    if (row2 >= win) {
      row2 -= win;
      ++l2;
    }
    const bool two = l2 < num_lm;
    const Covering c1 = fetch(source(l, row));
    Covering c2;
    if (two) c2 = fetch(source(l2, row2));
    *target(l, row) = realign(c1);
    if (two) *target(l2, row2) = realign(c2);
    l = l2 + step_l;
    row = row2 + step_r;
    if (row >= win) {
      row -= win;
      ++l;
    }
  }
}

// One element a thread: rows whose bytes are no multiple of 16.
template <typename Word>
__global__ void __launch_bounds__(kThreads)
window_elem_kernel(const Word* __restrict__ maps, const int* __restrict__ sel,
                   const int* __restrict__ y0, const int* __restrict__ x0,
                   Word* __restrict__ out, int scales, int num_lm, int hm,
                   int wm, int dets, int lo, int win) {
  const int bd = blockIdx.x;  // b * D + d
  const int b = bd / dets;
  const int s = clampi(sel[bd], 0, scales - 1);
  const int per_lm = win * win;
  const int n = num_lm * per_lm;
  Word* o = out + (size_t)bd * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int l = i / per_lm;
    const int r = i - l * per_lm;
    const int row = r / win;
    const int col = r - row * win;
    const size_t oi = (size_t)bd * lo + (lo == 1 ? 0 : l);
    const int y = clampi(y0[oi], 0, hm - win) + row;
    const int x = clampi(x0[oi], 0, wm - win) + col;
    o[i] = maps[((((size_t)b * scales + s) * num_lm + l) * hm + y) * wm + x];
  }
}

}  // namespace

// maps (B, S, L, Hm, Wm) of elem_size-byte elements (2: bf16, 4: f32);
// sel (B, D), y0 and x0 (B, D, lo) int32 with lo 1 or L; out
// (B, D, L, win, win) like maps. All contiguous on the current device.
// Launches on `stream`, does not synchronise; returns the CUDA error code
// (0 = launched). *vector_rows (may be null) is set to 1 if the 16-byte row
// kernel ran and 0 if the element kernel did.
extern "C" int densebox_gather_windows(const void* maps, const void* sel,
                                       const void* y0, const void* x0,
                                       void* out, int batch, int scales,
                                       int num_lm, int hm, int wm, int dets,
                                       int lo, int win, int elem_size,
                                       int* vector_rows, void* stream) {
  if (batch < 1 || dets < 1 || scales < 1 || num_lm < 1 ||
      (long long)batch * dets > INT_MAX || (lo != 1 && lo != num_lm) ||
      win < 1 || win > hm || win > wm ||
      (long long)num_lm * win * win > INT_MAX ||
      (elem_size != 2 && elem_size != 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = batch * dets;
  const int row_bytes = win * elem_size;
  const bool rows = row_bytes % 16 == 0 && row_bytes / 16 <= kThreads &&
                    ((uintptr_t)out & 15u) == 0 && lo <= 4096;
  if (vector_rows) *vector_rows = rows ? 1 : 0;
  if (rows)
    window_rows_kernel<<<blocks, kThreads, 2 * lo * sizeof(int), st>>>(
        (const uint8_t*)maps, (const int*)sel, (const int*)y0, (const int*)x0,
        (uint8_t*)out, scales, num_lm, hm, wm, dets, lo, win, elem_size,
        row_bytes / 16);
  else if (elem_size == 2)
    window_elem_kernel<uint16_t><<<blocks, kThreads, 0, st>>>(
        (const uint16_t*)maps, (const int*)sel, (const int*)y0,
        (const int*)x0, (uint16_t*)out, scales, num_lm, hm, wm, dets, lo,
        win);
  else
    window_elem_kernel<uint32_t><<<blocks, kThreads, 0, st>>>(
        (const uint32_t*)maps, (const int*)sel, (const int*)y0,
        (const int*)x0, (uint32_t*)out, scales, num_lm, hm, wm, dets, lo,
        win);
  return (int)cudaGetLastError();
}
