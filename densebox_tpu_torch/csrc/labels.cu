// Dense GT label-map rasterizers (boxes and landmarks), sm_90a.
//
// Replace the two kernels of densebox_tpu/ops/pallas/labels.py, _kernel and
// _lm_kernel (both behind rasterize_batch_pallas). Same contracts as their
// plain PyTorch versions, densebox_tpu_torch/ops/kernels/labels.py:
// rasterize_boxes_reference and rasterize_landmarks_reference.
//
// Boxes: rows (B, K, 8) = [cx, cy, rc2, rg2, x1, y1, x2, y2] in map units
// (rc2 < 0: never positive; rg2 < 0: never gray). For pixel (x, y) and each
// box in index order, d2 = (x-cx)^2 + (y-cy)^2; the pixel is positive if any
// d2 <= rc2, gray if any d2 <= rg2 and it is not positive, and its loc
// target is (x-x1, y-y1, x2-x, y2-y) * inv_norm of the positive box with the
// smallest d2. The running minimum is replaced on strict `<` only, so among
// boxes at equal distance the lowest index wins, as argmin does in the JAX
// twin. Landmarks: rows (B, K*L, 3) = [lx, ly, r2]; channel l of a pixel is
// 1 if any box's landmark l has (x-lx)^2 + (y-ly)^2 <= r2.
//
// What bounds them on the card: the bytes written and the launch. At the
// training shape (B=32, K=16, M=60, L=5) the box kernel reads 16 KB and
// writes 2.8 MB (six floats a pixel), the landmark kernel writes 2.3 MB:
// about a microsecond of HBM time each, so they are launch-bound, and one
// launch for the whole batch is the design. The arithmetic (K boxes x 12
// operations a pixel, 22 M operations) is as small. The TPU kernel's
// mechanics (a grid step per patch over whole (M, M) VMEM registers, the
// static unroll over K, the integer iota cast) have no counterpart:
//   - a thread per pixel (boxes) or per (pixel, channel) (landmarks), blocks
//     of 256 threads over a (pixels, patch) grid, so that even a small batch
//     fills the card;
//   - each block stages its patch's rows in shared memory once; every thread
//     then walks them in index order with its running minimum in registers,
//     so no (B, K, M, M) intermediate exists;
//   - outputs are written straight in the NHWC layout the loss reads: loc as
//     one 16-byte store a pixel, landmark channels innermost (neighbouring
//     threads write neighbouring addresses), so no transpose follows.
// Float operations are rounded one by one (_rn intrinsics, and the file is
// built with -fmad=false), as the plain versions and JAX without jit round
// them: one ulp of d2 would flip a pixel on a disc's rim.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 1024;

__device__ __forceinline__ float dist2(float px, float py, float cx,
                                       float cy) {
  const float dx = __fsub_rn(px, cx);
  const float dy = __fsub_rn(py, cy);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

__global__ void __launch_bounds__(kThreads)
boxes_kernel(const float* __restrict__ rows, float* __restrict__ score,
             float4* __restrict__ loc, float* __restrict__ ignore, int k,
             int m, float inv_norm) {
  extern __shared__ float srow[];  // (K, 8)
  const int b = blockIdx.y;
  const float* r = rows + (size_t)b * k * 8;
  for (int i = threadIdx.x; i < k * 8; i += blockDim.x) srow[i] = r[i];
  __syncthreads();
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= m * m) return;
  const float px = (float)(pix % m);
  const float py = (float)(pix / m);
  float best = INFINITY;
  float bx1 = 0.f, by1 = 0.f, bx2 = 0.f, by2 = 0.f;
  bool pos = false, gray = false;
  for (int i = 0; i < k; ++i) {
    const float* row = srow + i * 8;
    const float d2 = dist2(px, py, row[0], row[1]);
    const bool pos_i = d2 <= row[2];
    gray = gray || (d2 <= row[3]);
    if (pos_i && d2 < best) {
      best = d2;
      bx1 = row[4];
      by1 = row[5];
      bx2 = row[6];
      by2 = row[7];
    }
    pos = pos || pos_i;
  }
  const float posf = pos ? 1.f : 0.f;
  const size_t o = (size_t)b * m * m + pix;
  score[o] = posf;
  ignore[o] = (gray && !pos) ? 1.f : 0.f;
  float4 t;
  t.x = __fmul_rn(__fmul_rn(__fsub_rn(px, bx1), inv_norm), posf);
  t.y = __fmul_rn(__fmul_rn(__fsub_rn(py, by1), inv_norm), posf);
  t.z = __fmul_rn(__fmul_rn(__fsub_rn(bx2, px), inv_norm), posf);
  t.w = __fmul_rn(__fmul_rn(__fsub_rn(by2, py), inv_norm), posf);
  loc[o] = t;
}

__global__ void __launch_bounds__(kThreads)
landmarks_kernel(const float* __restrict__ rows, float* __restrict__ lm,
                 int k, int num_lm, int m) {
  extern __shared__ float srow[];  // (K * L, 3)
  const int b = blockIdx.y;
  const int n = k * num_lm * 3;
  const float* r = rows + (size_t)b * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) srow[i] = r[i];
  __syncthreads();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;  // pix * L + l
  const int per = m * m * num_lm;
  if (t >= per) return;
  const int pix = t / num_lm;
  const int l = t - pix * num_lm;
  const float px = (float)(pix % m);
  const float py = (float)(pix / m);
  bool hit = false;
  for (int i = 0; i < k; ++i) {
    const float* row = srow + (i * num_lm + l) * 3;
    hit = hit || (dist2(px, py, row[0], row[1]) <= row[2]);
  }
  lm[(size_t)b * per + t] = hit ? 1.f : 0.f;
}

}  // namespace

// rows (B, K, 8) float32; score and ignore (B, M, M) and loc (B, M, M, 4)
// float32 (loc 16-byte aligned). All contiguous on the current device.
// Launches on `stream`, does not synchronise; returns the CUDA error code
// (0 = launched).
extern "C" int densebox_rasterize_boxes(const void* rows, void* score,
                                        void* loc, void* ignore, int batch,
                                        int k, int m, float inv_norm,
                                        void* stream) {
  if (batch < 1 || batch > 65535 || k < 1 || k > kMaxRows || m < 1 ||
      m > 4096 || ((size_t)loc & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((m * m + kThreads - 1) / kThreads, batch);
  boxes_kernel<<<grid, kThreads, (size_t)k * 8 * sizeof(float),
                 (cudaStream_t)stream>>>(
      (const float*)rows, (float*)score, (float4*)loc, (float*)ignore, k, m,
      inv_norm);
  return (int)cudaGetLastError();
}

// rows (B, K * L, 3) float32; lm (B, M, M, L) float32. As above.
extern "C" int densebox_rasterize_landmarks(const void* rows, void* lm,
                                            int batch, int k, int num_lm,
                                            int m, void* stream) {
  if (batch < 1 || batch > 65535 || k < 1 || num_lm < 1 ||
      (long long)k * num_lm > kMaxRows || m < 1 || m > 4096)
    return (int)cudaErrorInvalidValue;
  const long long per = (long long)m * m * num_lm;
  if (per > INT_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((per + kThreads - 1) / kThreads), batch);
  landmarks_kernel<<<grid, kThreads, (size_t)k * num_lm * 3 * sizeof(float),
                     (cudaStream_t)stream>>>((const float*)rows, (float*)lm,
                                             k, num_lm, m);
  return (int)cudaGetLastError();
}
