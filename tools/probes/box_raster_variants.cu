// Variants of the box rasterizer's kernel (densebox_tpu_torch/csrc/labels.cu),
// timed side by side by tools/probes/box_raster_variants.py on an NVIDIA
// H100. Not part of the port: a measurement of what bounds that kernel (a
// launch, the stores, the walk over a patch's K rows) and of the designs
// that were tried for it and lost. Every variant keeps the kernel's contract
// (rows (B, K, 8) -> score, loc, ignore, bit-equal to
// rasterize_boxes_reference), except the two floors, which skip work:
//   parent_kernel   a pixel a thread, every row staged in shared memory
//                   (MODE 0), + the exact skip of rows whose discs end above
//                   or below the pixel (1), without the walk (7: launch,
//                   load and stores), without load and walk (8: launch and
//                   stores);
//   shfl_kernel     rows held one a lane and passed by warp shuffles, 1, 2
//                   or 4 pixels a thread with 4-, 8- or 16-byte stores;
//   seq_kernel      rows as float4, the best row's index kept, R pixels a
//                   thread one after the other;
//   split_kernel    S threads a pixel, each walking the rows i = part (mod
//                   S), U rows a step with independent loads and distances.

#include <cuda_runtime.h>
#include <math.h>
__device__ __forceinline__ float dist2(float px, float py, float cx, float cy) {
  const float dx = __fsub_rn(px, cx); const float dy = __fsub_rn(py, cy);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}
// MODE 0: parent; 1: parent + dy2 skip; 7: no loop (n=0); 8: no row load, no loop
template <int T, int MODE>
__global__ void __launch_bounds__(T) parent_kernel(const float* __restrict__ rows, float* __restrict__ score,
    float4* __restrict__ loc, float* __restrict__ ignore, int k, int m, float inv_norm) {
  extern __shared__ float srow[];
  const int b = blockIdx.y;
  if (MODE != 8) {
    const float* r = rows + (size_t)b * k * 8;
    for (int i = threadIdx.x; i < k * 8; i += blockDim.x) srow[i] = r[i];
    __syncthreads();
  }
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= m * m) return;
  const float px = (float)(pix % m), py = (float)(pix / m);
  float best = INFINITY, bx1 = 0.f, by1 = 0.f, bx2 = 0.f, by2 = 0.f;
  bool pos = false, gray = false;
  const int n = (MODE >= 7) ? 0 : k;
  for (int i = 0; i < n; ++i) {
    const float* row = srow + i * 8;
    if (MODE == 1) {
      const float dy = __fsub_rn(py, row[1]);
      if (__fmul_rn(dy, dy) > fmaxf(row[2], row[3])) continue;
    }
    const float d2 = dist2(px, py, row[0], row[1]);
    const bool pos_i = d2 <= row[2];
    gray = gray || (d2 <= row[3]);
    if (pos_i && d2 < best) { best = d2; bx1 = row[4]; by1 = row[5]; bx2 = row[6]; by2 = row[7]; }
    pos = pos || pos_i;
  }
  const float posf = pos ? 1.f : 0.f;
  const size_t o = (size_t)b * m * m + pix;
  score[o] = posf; ignore[o] = (gray && !pos) ? 1.f : 0.f;
  float4 t;
  t.x = __fmul_rn(__fmul_rn(__fsub_rn(px, bx1), inv_norm), posf);
  t.y = __fmul_rn(__fmul_rn(__fsub_rn(py, by1), inv_norm), posf);
  t.z = __fmul_rn(__fmul_rn(__fsub_rn(bx2, px), inv_norm), posf);
  t.w = __fmul_rn(__fmul_rn(__fsub_rn(by2, py), inv_norm), posf);
  loc[o] = t;
}
// rows held one a lane and passed by shuffles (k <= 32): no shared memory, no barrier
template <int T, int PX>
__global__ void __launch_bounds__(T) shfl_kernel(const float* __restrict__ rows, float* __restrict__ score,
    float4* __restrict__ loc, float* __restrict__ ignore, int k, int m, float inv_norm) {
  const int b = blockIdx.y, lane = threadIdx.x & 31;
  const float4* r4 = reinterpret_cast<const float4*>(rows + (size_t)b * k * 8);
  float4 a = make_float4(0.f, 0.f, -1.f, -1.f), c = a;
  if (lane < k) { a = r4[2 * lane]; c = r4[2 * lane + 1]; }
  unsigned mask = __ballot_sync(0xffffffffu, fmaxf(a.z, a.w) >= 0.f);
  const int gpr = m / PX, groups = gpr * m;
  const int g = blockIdx.x * T + threadIdx.x;
  const bool live = g < groups;
  const int y = g / gpr, x0 = (g - y * gpr) * PX;
  const float py = (float)y;
  float best[PX]; int best_i[PX];
#pragma unroll
  for (int j = 0; j < PX; ++j) { best[j] = INFINITY; best_i[j] = -1; }
  unsigned posm = 0u, graym = 0u;
  while (mask) {
    const int i = __ffs(mask) - 1; mask &= mask - 1;
    const float cx = __shfl_sync(0xffffffffu, a.x, i), cy = __shfl_sync(0xffffffffu, a.y, i);
    const float rc2 = __shfl_sync(0xffffffffu, a.z, i), rg2 = __shfl_sync(0xffffffffu, a.w, i);
    const float dy = __fsub_rn(py, cy); const float dy2 = __fmul_rn(dy, dy);
    if (dy2 > fmaxf(rc2, rg2)) continue;
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const float dx = __fsub_rn((float)(x0 + j), cx);
      const float d2 = __fadd_rn(__fmul_rn(dx, dx), dy2);
      if (d2 <= rg2) graym |= 1u << j;
      if (d2 <= rc2) { posm |= 1u << j; if (d2 < best[j]) { best[j] = d2; best_i[j] = i; } }
    }
  }
  float sc[PX], ig[PX]; float4 t[PX];
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const bool pos = (posm >> j) & 1u; const float posf = pos ? 1.f : 0.f;
    sc[j] = posf; ig[j] = (((graym >> j) & 1u) && !pos) ? 1.f : 0.f;
    const int s = best_i[j] & 31; const bool has = best_i[j] >= 0;
    const float x1 = __shfl_sync(0xffffffffu, c.x, s), y1 = __shfl_sync(0xffffffffu, c.y, s);
    const float x2 = __shfl_sync(0xffffffffu, c.z, s), y2 = __shfl_sync(0xffffffffu, c.w, s);
    const float px = (float)(x0 + j);
    t[j].x = __fmul_rn(__fmul_rn(__fsub_rn(px, has ? x1 : 0.f), inv_norm), posf);
    t[j].y = __fmul_rn(__fmul_rn(__fsub_rn(py, has ? y1 : 0.f), inv_norm), posf);
    t[j].z = __fmul_rn(__fmul_rn(__fsub_rn(has ? x2 : 0.f, px), inv_norm), posf);
    t[j].w = __fmul_rn(__fmul_rn(__fsub_rn(has ? y2 : 0.f, py), inv_norm), posf);
  }
  if (!live) return;
  const size_t o = (size_t)b * m * m + (size_t)y * m + x0;
  if (PX == 4) {
    *reinterpret_cast<float4*>(score + o) = make_float4(sc[0], sc[1], sc[PX > 2 ? 2 : 0], sc[PX > 3 ? 3 : 0]);
    *reinterpret_cast<float4*>(ignore + o) = make_float4(ig[0], ig[1], ig[PX > 2 ? 2 : 0], ig[PX > 3 ? 3 : 0]);
  } else if (PX == 2) {
    *reinterpret_cast<float2*>(score + o) = make_float2(sc[0], sc[PX > 1 ? 1 : 0]);
    *reinterpret_cast<float2*>(ignore + o) = make_float2(ig[0], ig[PX > 1 ? 1 : 0]);
  } else { score[o] = sc[0]; ignore[o] = ig[0]; }
#pragma unroll
  for (int j = 0; j < PX; ++j) loc[o + j] = t[j];
}

// rows as float4 in shared memory, the best row's index kept, R pixels a thread one after the other
template <int T, int R, bool SKIP>
__global__ void __launch_bounds__(T) seq_kernel(const float* __restrict__ rows, float* __restrict__ score,
    float4* __restrict__ loc, float* __restrict__ ignore, int k, int m, float inv_norm) {
  extern __shared__ float4 srow4[];
  const int b = blockIdx.y;
  const float4* r4 = reinterpret_cast<const float4*>(rows + (size_t)b * k * 8);
  for (int i = threadIdx.x; i < k * 2; i += T) srow4[i] = r4[i];
  __syncthreads();
#pragma unroll
  for (int rep = 0; rep < R; ++rep) {
    const int pix = (blockIdx.x * R + rep) * T + threadIdx.x;
    if (pix >= m * m) return;
    const int y = pix / m;
    const float px = (float)(pix - y * m), py = (float)y;
    float best = INFINITY; int bi = -1; bool pos = false, gray = false;
    for (int i = 0; i < k; ++i) {
      const float4 a = srow4[2 * i];
      const float dy = __fsub_rn(py, a.y); const float dy2 = __fmul_rn(dy, dy);
      if (SKIP && dy2 > fmaxf(a.z, a.w)) continue;
      const float dx = __fsub_rn(px, a.x);
      const float d2 = __fadd_rn(__fmul_rn(dx, dx), dy2);
      gray = gray || (d2 <= a.w);
      if (d2 <= a.z) { pos = true; if (d2 < best) { best = d2; bi = i; } }
    }
    const float posf = pos ? 1.f : 0.f;
    const size_t o = (size_t)b * m * m + pix;
    score[o] = posf; ignore[o] = (gray && !pos) ? 1.f : 0.f;
    const float4 box = bi >= 0 ? srow4[2 * bi + 1] : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 t;
    t.x = __fmul_rn(__fmul_rn(__fsub_rn(px, box.x), inv_norm), posf);
    t.y = __fmul_rn(__fmul_rn(__fsub_rn(py, box.y), inv_norm), posf);
    t.z = __fmul_rn(__fmul_rn(__fsub_rn(box.z, px), inv_norm), posf);
    t.w = __fmul_rn(__fmul_rn(__fsub_rn(box.w, py), inv_norm), posf);
    loc[o] = t;
  }
}
#define SEQ(T, R, SK) seq_kernel<T, R, SK><<<dim3((m * m + T * R - 1) / (T * R), batch), T, (size_t)k * 32, st>>>(r, s, l, ig, k, m, inv)

// S threads a pixel, each walks the rows i = part (mod S); U rows a step, their distances independent
template <int T, int S, int U>
__global__ void __launch_bounds__(T) split_kernel(const float* __restrict__ rows, float* __restrict__ score,
    float* __restrict__ loc, float* __restrict__ ignore, int k, int m, float inv_norm) {
  extern __shared__ float4 srow4[];
  const int b = blockIdx.y;
  const float4* r4 = reinterpret_cast<const float4*>(rows + (size_t)b * k * 8);
  const int kp = (k + S * U - 1) / (S * U) * (S * U);
  for (int i = threadIdx.x; i < kp * 2; i += T)
    srow4[i] = i < k * 2 ? r4[i] : make_float4(0.f, 0.f, -1.f, -1.f);
  __syncthreads();
  const int gt = blockIdx.x * T + threadIdx.x;
  const int pix = gt / S, part = gt % S;
  const int y = pix / m;
  const float px = (float)(pix - y * m), py = (float)y;
  float best = INFINITY; int bi = -1; unsigned flags = 0u;
  for (int i0 = part * U; i0 < kp; i0 += S * U) {
    float4 a[U]; float d2[U];
#pragma unroll
    for (int u = 0; u < U; ++u) a[u] = srow4[2 * (i0 + u)];
#pragma unroll
    for (int u = 0; u < U; ++u) d2[u] = dist2(px, py, a[u].x, a[u].y);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (d2[u] <= a[u].w) flags |= 2u;
      if (d2[u] <= a[u].z) { flags |= 1u; if (d2[u] < best) { best = d2[u]; bi = i0 + u; } }
    }
  }
#pragma unroll
  for (int off = 1; off < S; off <<= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    flags |= __shfl_xor_sync(0xffffffffu, flags, off);
    if (ob < best || (ob == best && oi >= 0 && oi < bi)) { best = ob; bi = oi; }
  }
  if (pix >= m * m) return;
  const bool pos = flags & 1u; const float posf = pos ? 1.f : 0.f;
  const size_t o = (size_t)b * m * m + pix;
  if (part == 0) score[o] = posf;
  if (part == S - 1) ignore[o] = ((flags & 2u) && !pos) ? 1.f : 0.f;
  const float4 box = bi >= 0 ? srow4[2 * bi + 1] : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 t;
  t.x = __fmul_rn(__fmul_rn(__fsub_rn(px, box.x), inv_norm), posf);
  t.y = __fmul_rn(__fmul_rn(__fsub_rn(py, box.y), inv_norm), posf);
  t.z = __fmul_rn(__fmul_rn(__fsub_rn(box.z, px), inv_norm), posf);
  t.w = __fmul_rn(__fmul_rn(__fsub_rn(box.w, py), inv_norm), posf);
  if (S == 1) *reinterpret_cast<float4*>(loc + o * 4) = t;
  else if (S == 2) *reinterpret_cast<float2*>(loc + o * 4 + part * 2) = part ? make_float2(t.z, t.w) : make_float2(t.x, t.y);
  else loc[o * 4 + part] = part == 0 ? t.x : part == 1 ? t.y : part == 2 ? t.z : t.w;
}
#define SPLIT(T, S, U) split_kernel<T, S, U><<<dim3((m * m * S + T - 1) / T, batch), T, (size_t)(k + S * U) * 32, st>>>(r, s, (float*)l, ig, k, m, inv)
#define PARENT(T, MODE) parent_kernel<T, MODE><<<dim3((m * m + T - 1) / T, batch), T, (size_t)k * 32, st>>>(r, s, l, ig, k, m, inv)
#define SHFL(T, PX) shfl_kernel<T, PX><<<dim3((m / PX * m + T - 1) / T, batch), T, 0, st>>>(r, s, l, ig, k, m, inv)
extern "C" int exp_boxes(int variant, const void* rows, void* score, void* loc, void* ignore, int batch, int k, int m, float inv, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* r = (const float*)rows; float* s = (float*)score; float4* l = (float4*)loc; float* ig = (float*)ignore;
  switch (variant) {
    case 0: PARENT(256, 0); break;
    case 1: PARENT(256, 1); break;
    case 2: PARENT(128, 0); break;
    case 3: PARENT(512, 0); break;
    case 4: SHFL(256, 1); break;
    case 5: SHFL(256, 4); break;
    case 6: SHFL(256, 2); break;
    case 7: PARENT(256, 7); break;
    case 8: PARENT(256, 8); break;
    case 9: SHFL(128, 1); break;
    case 10: SHFL(128, 2); break;
    case 11: SHFL(128, 4); break;
    case 12: SHFL(512, 1); break;
    case 13: PARENT(128, 1); break;
    case 14: SHFL(64, 4); break;
    case 15: PARENT(1024, 0); break;
    case 16: SEQ(256, 1, false); break;
    case 17: SEQ(256, 1, true); break;
    case 18: SEQ(256, 2, false); break;
    case 19: SEQ(256, 2, true); break;
    case 20: SEQ(256, 4, true); break;
    case 24: SEQ(128, 8, true); break;
    case 30: SPLIT(256, 1, 4); break;
    case 31: SPLIT(256, 1, 8); break;
    case 32: SPLIT(256, 2, 1); break;
    case 33: SPLIT(256, 2, 4); break;
    case 34: SPLIT(256, 4, 1); break;
    case 36: SPLIT(256, 4, 4); break;
    case 38: SPLIT(128, 1, 8); break;
    case 41: SPLIT(128, 1, 16); break;
    default: return 1;
  }
  return (int)cudaGetLastError();
}
