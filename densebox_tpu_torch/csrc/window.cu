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
// What bounds it on the card: bytes and the launch. It is a pure copy, no
// arithmetic; at the MALF serve shape (B=8, D=64, L=5, win=32, bf16) it
// reads and writes 5.2 MB each, a few microseconds of HBM time, so one
// launch per call matters as much as the copy itself. The TPU kernel's
// mechanics (8/128-aligned strip DMAs, one-hot matmuls that pick the window
// out of the strip, indices packed into one SMEM word, the dp queue depth)
// answer TPU constraints and have no counterpart here. The design:
//   - one block per (image, detection), all of them in one launch; the block
//     reads its own sel and origins (there is no scalar prefetch);
//   - the block's threads walk its L * win * win outputs in order, so
//     neighbouring threads copy neighbouring columns of one window row: each
//     row is one coalesced read and one coalesced write;
//   - elements move as raw 2-byte (bf16) or 4-byte (f32) words, so the copy
//     is bit-exact by construction;
//   - shared origins (lo == 1) read one origin for all L channels, the TPU
//     kernel's fused-L path.
// The source row, column and scale are clamped into the tensor, so no origin
// can make the kernel read outside `maps`; callers that keep the contract
// (in-range origins, as the detector's clipping gives) never reach the
// clamp. Wider (16-byte) copies and fusing the peak search into the gather
// are left for later.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename Word>
__global__ void __launch_bounds__(kThreads)
window_kernel(const Word* __restrict__ maps, const int* __restrict__ sel,
              const int* __restrict__ y0, const int* __restrict__ x0,
              Word* __restrict__ out, int scales, int num_lm, int hm, int wm,
              int dets, int lo, int win) {
  const int bd = blockIdx.x;  // b * D + d
  const int b = bd / dets;
  const int s = min(max(sel[bd], 0), scales - 1);
  const int per_lm = win * win;
  const int n = num_lm * per_lm;
  Word* o = out + (size_t)bd * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int l = i / per_lm;
    const int r = i - l * per_lm;
    const int row = r / win;
    const int col = r - row * win;
    const size_t oi = (size_t)bd * lo + (lo == 1 ? 0 : l);
    const int y = min(max(y0[oi] + row, 0), hm - 1);
    const int x = min(max(x0[oi] + col, 0), wm - 1);
    o[i] = maps[((((size_t)b * scales + s) * num_lm + l) * hm + y) * wm + x];
  }
}

}  // namespace

// maps (B, S, L, Hm, Wm) of elem_size-byte elements (2: bf16, 4: f32);
// sel (B, D), y0 and x0 (B, D, lo) int32 with lo 1 or L; out
// (B, D, L, win, win) like maps. All contiguous on the current device.
// Launches on `stream`, does not synchronise; returns the CUDA error code
// (0 = launched).
extern "C" int densebox_gather_windows(const void* maps, const void* sel,
                                       const void* y0, const void* x0,
                                       void* out, int batch, int scales,
                                       int num_lm, int hm, int wm, int dets,
                                       int lo, int win, int elem_size,
                                       void* stream) {
  if (batch < 1 || dets < 1 || scales < 1 || num_lm < 1 ||
      (long long)batch * dets > INT_MAX || (lo != 1 && lo != num_lm) ||
      win < 1 || win > hm || win > wm ||
      (long long)num_lm * win * win > INT_MAX ||
      (elem_size != 2 && elem_size != 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = batch * dets;
  if (elem_size == 2)
    window_kernel<uint16_t><<<blocks, kThreads, 0, st>>>(
        (const uint16_t*)maps, (const int*)sel, (const int*)y0,
        (const int*)x0, (uint16_t*)out, scales, num_lm, hm, wm, dets, lo,
        win);
  else
    window_kernel<uint32_t><<<blocks, kThreads, 0, st>>>(
        (const uint32_t*)maps, (const int*)sel, (const int*)y0,
        (const int*)x0, (uint32_t*)out, scales, num_lm, hm, wm, dets, lo,
        win);
  return (int)cudaGetLastError();
}
