// Int8 SAME conv (3x3 or 1x1, stride 1) with int32 accumulation and the
// int8 epilogue, sm_90a.
//
// Replaces densebox_tpu/ops/pallas/qconv.py:_qconv_kernel (behind
// qconv_int8). Same contract as its plain PyTorch version,
// densebox_tpu_torch/ops/kernels/qconv.py:qconv_reference: x (B, H, W, Cin)
// int8, w (Cout, k, k, Cin) int8 (Cin innermost, so a 4-channel word of x
// meets the matching word of w), zero padding of k // 2 on every side;
// the exact int32 sum over taps and channels, then one of three outputs:
// the accumulator itself (mode int32, the hybrid chain's conv), or the
// epilogue of epilogue.cuh as f32 or as int8 codes.
//
// What bounds it on the card: int8 multiply-adds. At DenseBox's widths a
// conv does 9 * Cin multiply-adds per output value and moves 2 bytes per
// value (int8 in, int8 out), far above the card's ratio of operations to
// bytes, so arithmetic bounds it. This first kernel does them on the CUDA
// cores with __dp4a (four int8 products and an int32 add per instruction);
// the int8 tensor cores (mma.sync / wgmma) are a later step.
//
// Design, one block of 256 threads per (image, 8x16 output tile, block of
// COB output channels):
//   * Cin is walked in chunks of 32 channels (8 words). For each chunk the
//     block stages the input tile with its k // 2 halo in shared memory,
//     zero-filled outside the image (SAME padding without a padded copy of
//     x) and past Cin (the channel tail when Cin is not a multiple of 4),
//     and the matching weights as [tap][word][channel].
//   * Each thread owns 4 pixels of one tile row (columns c, c+4, c+8, c+12)
//     and COB/8 channels (cg, cg+8, ...), so that in a warp the 8 channel
//     groups read 8 neighbouring weight words and the 4 pixel groups read 4
//     input words 8 banks apart: no bank conflicts. Per word it does
//     4 * COB/8 __dp4a from 4 + COB/8 shared-memory loads.
//   * The epilogue runs on the int32 registers and writes NHWC directly.
// COB is 16, 32 or 64 by Cout, so that narrow layers (Cout 1, 4, 16) do not
// compute 64 channels. One C call is one launch; it does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTH = 8;           // output tile rows (one per warp)
constexpr int kTW = 16;          // output tile columns
constexpr int kPx = 4;           // pixels per thread
constexpr int kCoGroups = 8;     // channel groups (threads per pixel group)
constexpr int kChunkWords = 8;   // Cin chunk: 8 words = 32 channels

// Four channels c .. c+3 of one pixel (or weight row) as a dp4a word,
// channel c in the low byte; channels at or past Cin read as zero.
__device__ __forceinline__ int load_word(const int8_t* __restrict__ p, int c,
                                         int cin, bool aligned) {
  if (aligned) return *reinterpret_cast<const int*>(p + c);
  int v = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (c + k < cin) v |= (int)(uint8_t)p[c + k] << (8 * k);
  return v;
}

template <int KS, int COB>
__global__ void __launch_bounds__(kThreads)
qconv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
             const float* __restrict__ scale, const float* __restrict__ bias,
             const float* __restrict__ out_scale, void* __restrict__ out,
             int h, int wd, int cin, int cout, int tiles_w, bool aligned,
             int relu, int mode) {
  constexpr int P = KS / 2;
  constexpr int IH = kTH + 2 * P, IW = kTW + 2 * P;
  constexpr int CO_T = COB / kCoGroups;
  __shared__ int in_s[IH * IW * kChunkWords];
  __shared__ int w_s[KS * KS * kChunkWords * COB];

  const int tid = threadIdx.x;
  const int cg = tid % kCoGroups;         // channels co0 + cg + 8 * j
  const int pg = tid / kCoGroups;         // pixel group 0..31
  const int pr = pg / 4;                  // tile row: one per warp
  const int pc = pg % 4;                  // columns pc + 4 * i
  const int y0 = (blockIdx.x / tiles_w) * kTH;
  const int x0 = (blockIdx.x % tiles_w) * kTW;
  const int co0 = blockIdx.y * COB;
  const int b = blockIdx.z;
  const int cin_words = (cin + 3) / 4;
  const int8_t* xb = x + (size_t)b * h * wd * cin;

  int acc[kPx][CO_T];
#pragma unroll
  for (int i = 0; i < kPx; ++i)
#pragma unroll
    for (int j = 0; j < CO_T; ++j) acc[i][j] = 0;

  for (int cw0 = 0; cw0 < cin_words; cw0 += kChunkWords) {
    const int nw = min(kChunkWords, cin_words - cw0);
    for (int e = tid; e < IH * IW * nw; e += kThreads) {
      const int wi = e % nw, pix = e / nw;
      const int gy = y0 + pix / IW - P, gx = x0 + pix % IW - P;
      int v = 0;
      if (gy >= 0 && gy < h && gx >= 0 && gx < wd)
        v = load_word(xb + ((size_t)gy * wd + gx) * cin, (cw0 + wi) * 4, cin,
                      aligned);
      in_s[pix * kChunkWords + wi] = v;
    }
    for (int e = tid; e < KS * KS * nw * COB; e += kThreads) {
      const int co = e % COB, r = e / COB;
      const int wi = r % nw, tap = r / nw;
      int v = 0;
      if (co0 + co < cout)
        v = load_word(w + ((size_t)(co0 + co) * KS * KS + tap) * cin,
                      (cw0 + wi) * 4, cin, aligned);
      w_s[(tap * kChunkWords + wi) * COB + co] = v;
    }
    __syncthreads();
#pragma unroll
    for (int dy = 0; dy < KS; ++dy) {
#pragma unroll
      for (int dx = 0; dx < KS; ++dx) {
        const int* in_row = in_s + ((pr + dy) * IW + pc + dx) * kChunkWords;
        const int* w_tap = w_s + (dy * KS + dx) * kChunkWords * COB + cg;
        for (int wi = 0; wi < nw; ++wi) {
          int a[kPx], bw[CO_T];
#pragma unroll
          for (int i = 0; i < kPx; ++i) a[i] = in_row[4 * i * kChunkWords + wi];
#pragma unroll
          for (int j = 0; j < CO_T; ++j) bw[j] = w_tap[wi * COB + kCoGroups * j];
#pragma unroll
          for (int i = 0; i < kPx; ++i)
#pragma unroll
            for (int j = 0; j < CO_T; ++j)
              acc[i][j] = __dp4a(a[i], bw[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  const int oy = y0 + pr;
  if (oy >= h) return;
#pragma unroll
  for (int i = 0; i < kPx; ++i) {
    const int ox = x0 + pc + 4 * i;
    if (ox >= wd) continue;
    const size_t pix = ((size_t)b * h + oy) * wd + ox;
#pragma unroll
    for (int j = 0; j < CO_T; ++j) {
      const int co = co0 + cg + kCoGroups * j;
      if (co >= cout) continue;
      const size_t o = pix * cout + co;
      if (mode == densebox::kModeInt32) {
        static_cast<int*>(out)[o] = acc[i][j];
        continue;
      }
      const float y = densebox::dequant(acc[i][j], scale[co], bias[co], relu);
      if (mode == densebox::kModeInt8)
        static_cast<int8_t*>(out)[o] = densebox::requant(y, out_scale[co]);
      else
        static_cast<float*>(out)[o] = y;
    }
  }
}

template <int KS, int COB>
void launch(const int8_t* x, const int8_t* w, const float* scale,
            const float* bias, const float* out_scale, void* out, int batch,
            int h, int wd, int cin, int cout, bool aligned, int relu,
            int mode, cudaStream_t s) {
  const int tiles_w = (wd + kTW - 1) / kTW;
  const int tiles_h = (h + kTH - 1) / kTH;
  const dim3 grid(tiles_h * tiles_w, (cout + COB - 1) / COB, batch);
  qconv_kernel<KS, COB><<<grid, kThreads, 0, s>>>(
      x, w, scale, bias, out_scale, out, h, wd, cin, cout, tiles_w, aligned,
      relu, mode);
}

template <int KS>
void dispatch(const int8_t* x, const int8_t* w, const float* scale,
              const float* bias, const float* out_scale, void* out,
              int batch, int h, int wd, int cin, int cout, bool aligned,
              int relu, int mode, cudaStream_t s) {
  if (cout <= 16)
    launch<KS, 16>(x, w, scale, bias, out_scale, out, batch, h, wd, cin, cout,
                   aligned, relu, mode, s);
  else if (cout <= 32)
    launch<KS, 32>(x, w, scale, bias, out_scale, out, batch, h, wd, cin, cout,
                   aligned, relu, mode, s);
  else
    launch<KS, 64>(x, w, scale, bias, out_scale, out, batch, h, wd, cin, cout,
                   aligned, relu, mode, s);
}

}  // namespace

// x (B, H, W, Cin) int8, w (Cout, k, k, Cin) int8, k in {1, 3}; scale and
// bias (Cout,) f32 for modes f32 and int8, out_scale (Cout,) f32 for mode
// int8; out (B, H, W, Cout) int32 (mode 0), f32 (mode 1) or int8 (mode 2).
// All contiguous on the current device. Launches on `stream`, does not
// synchronise; returns the CUDA error code (0 = launched).
extern "C" int densebox_qconv(const void* x, const void* w, const void* scale,
                              const void* bias, const void* out_scale,
                              void* out, int batch, int h, int wd, int cin,
                              int cout, int ksize, int relu, int mode,
                              void* stream) {
  if (batch < 1 || batch > 65535 || h < 1 || wd < 1 || cin < 1 || cout < 1 ||
      (cout + 15) / 16 > 65535 || (ksize != 1 && ksize != 3) ||
      (long long)((h + kTH - 1) / kTH) * ((wd + kTW - 1) / kTW) > 0x7fffffff ||
      mode < densebox::kModeInt32 || mode > densebox::kModeInt8 ||
      (mode != densebox::kModeInt32 && (scale == nullptr || bias == nullptr)) ||
      (mode == densebox::kModeInt8 && out_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  // word loads need every 4-channel group 4-byte aligned
  const bool aligned = cin % 4 == 0 && (uintptr_t)x % 4 == 0 &&
                       (uintptr_t)w % 4 == 0;
  const auto* xs = (const int8_t*)x;
  const auto* ws = (const int8_t*)w;
  cudaStream_t s = (cudaStream_t)stream;
  if (ksize == 3)
    dispatch<3>(xs, ws, (const float*)scale, (const float*)bias,
                (const float*)out_scale, out, batch, h, wd, cin, cout,
                aligned, relu, mode, s);
  else
    dispatch<1>(xs, ws, (const float*)scale, (const float*)bias,
                (const float*)out_scale, out, batch, h, wd, cin, cout,
                aligned, relu, mode, s);
  return (int)cudaGetLastError();
}
