// Greedy-NMS keep mask for a batch of score-sorted candidate sets, sm_90a.
//
// Replaces densebox_tpu/ops/pallas/nms.py:_nms_kernel (the Pallas kernel
// behind greedy_keep_pallas / nms_pallas). Same contract as its plain
// PyTorch version, densebox_tpu_torch/ops/kernels/nms.py:
// greedy_keep_reference: for boxes (B, K, 4) xyxy f32 sorted by score
// descending and valid (B, K), keep starts as valid and, for i ascending,
// a kept i suppresses every j > i with IoU(i, j) > thresh.
//
// What bounds it on the card: the K sequential steps of the sweep, each of
// which depends on the one before. Bytes are small (the IoU test for all
// pairs is K*K/8 bytes of bits per image, 128 KB at K = 1024) and the IoU
// arithmetic is K*K/2 independent pair tests spread over the whole card.
// The Pallas design kept a 4 MB f32 (K, K) IoU matrix in VMEM; that does not
// fit a Hopper SM, so the design here is:
//   1. iou_mask_kernel: grid (column block, row block, image) of 64-thread
//      blocks; thread i of a block tests its row box against the block's
//      64 column boxes (staged in shared memory) and writes one 64-bit
//      word, bit j set iff j > i and IoU > thresh. All pairs in parallel.
//   2. sweep_kernel: one block per image. Its threads copy the image's
//      bit rows into shared memory, then one warp walks i = 0..K-1: lane l
//      holds word l of the `removed` set in a register, the word holding
//      bit i is broadcast with a shuffle, and a kept row is OR-ed in by the
//      lanes in parallel (at most 16 words). Each step is then a shuffle, a
//      shared-memory load and an OR, not a pass over K IoU values.
// One C call launches both for the whole batch.
//
// The IoU is computed with the operations, order and f32 rounding of
// densebox_tpu/ops/nms.py:iou_matrix (areas and intersection clamped at 0,
// inter / max(area_i + area_j - inter, 1e-9)), through the _rn intrinsics so
// that no FMA contraction can move a box pair across the threshold (the
// build passes -fmad=false as well): keep masks equal the plain version's
// bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;      // bits per mask word = boxes per block side
constexpr int kMaxK = 1024;     // the wrapper refuses larger K

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

__device__ __forceinline__ float iou(float4 a, float area_a, float4 b,
                                     float area_b) {
  float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  float inter = __fmul_rn(iw, ih);
  float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-9f));
}

__global__ void iou_mask_kernel(const float4* __restrict__ boxes, int k,
                                int words, float thresh,
                                unsigned long long* __restrict__ mask) {
  const int cb = blockIdx.x, rb = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x;
  const float4* bx = boxes + (size_t)b * k;
  __shared__ float4 col[kBlock];
  __shared__ float col_area[kBlock];
  const int j0 = cb * kBlock;
  const int ncol = min(kBlock, k - j0);
  if (t < ncol) {
    col[t] = bx[j0 + t];
    col_area[t] = area(col[t]);
  }
  __syncthreads();
  const int i = rb * kBlock + t;
  if (i >= k) return;
  unsigned long long bits = 0ull;
  if (cb >= rb) {  // a column block left of the row block has no j > i
    const float4 row = bx[i];
    const float row_area = area(row);
    for (int c = (cb == rb) ? t + 1 : 0; c < ncol; ++c) {
      if (iou(row, row_area, col[c], col_area[c]) > thresh) bits |= 1ull << c;
    }
  }
  mask[((size_t)b * k + i) * words + cb] = bits;
}

__global__ void sweep_kernel(const unsigned long long* __restrict__ mask,
                             const uint8_t* __restrict__ valid, int k,
                             int words, uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long rows[];  // k * words
  __shared__ uint8_t ok[kMaxK];
  const int b = blockIdx.x;
  const unsigned long long* m = mask + (size_t)b * k * words;
  for (int e = threadIdx.x; e < k * words; e += blockDim.x) rows[e] = m[e];
  for (int e = threadIdx.x; e < k; e += blockDim.x) ok[e] = valid[(size_t)b * k + e];
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  unsigned long long removed = 0ull;  // lane l holds word l
  for (int i = 0; i < k; ++i) {
    const unsigned long long w = __shfl_sync(0xffffffffu, removed, i >> 6);
    const bool alive = ok[i] && !((w >> (i & 63)) & 1ull);
    if (alive && lane < words) removed |= rows[i * words + lane];
    if (lane == 0) keep[(size_t)b * k + i] = alive;
  }
}

}  // namespace

// boxes (B, K, 4) f32, valid (B, K) u8, mask scratch (B, K, ceil(K/64)) u64,
// keep (B, K) u8 out; all contiguous on the current device. Launches on
// `stream`, does not synchronise; returns the CUDA error code (0 = launched).
extern "C" int densebox_nms_keep(const void* boxes, const void* valid,
                                 void* mask, void* keep, int batch, int k,
                                 float thresh, void* stream) {
  if (batch < 1 || batch > 65535 || k < 1 || k > kMaxK)
    return (int)cudaErrorInvalidValue;
  const int words = (k + kBlock - 1) / kBlock;
  cudaStream_t s = (cudaStream_t)stream;
  iou_mask_kernel<<<dim3(words, words, batch), kBlock, 0, s>>>(
      (const float4*)boxes, k, words, thresh, (unsigned long long*)mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem = k * words * (int)sizeof(unsigned long long);
  err = cudaFuncSetAttribute(sweep_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  sweep_kernel<<<batch, 256, smem, s>>>((const unsigned long long*)mask,
                                        (const uint8_t*)valid, k, words,
                                        (uint8_t*)keep);
  return (int)cudaGetLastError();
}
