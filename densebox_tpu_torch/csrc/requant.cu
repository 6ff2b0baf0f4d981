// Int8 requant epilogue over an int32 accumulator tensor, sm_90a.
//
// Replaces densebox_tpu/ops/pallas/requant.py:_kernel (behind
// requant_epilogue). Same contract as its plain PyTorch version,
// densebox_tpu_torch/ops/kernels/requant.py:requant_reference: for acc
// (..., Cout) int32 and per-channel scale, bias (and out_scale), one pass
// writes int8 codes (or f32 values) with the arithmetic of epilogue.cuh.
//
// What bounds it on the card: bytes. Each element reads 4 bytes and writes
// 1 (int8) or 4 (f32) and costs a handful of float operations, far below
// the card's ratio of operations to bytes. The design is the plainest
// streaming pass: the three per-channel vectors are staged once per block
// in shared memory, and a grid-stride loop walks the elements in order, so
// neighbouring threads read neighbouring words and write neighbouring
// bytes. One launch per call; it does not synchronise.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // enough to fill an H100's 132 SMs

template <typename Index>
__global__ void __launch_bounds__(kThreads)
requant_kernel(const int* __restrict__ acc, const float* __restrict__ scale,
               const float* __restrict__ bias,
               const float* __restrict__ out_scale, void* __restrict__ out,
               Index n, int cout, int relu, int mode) {
  extern __shared__ float vec[];  // scale | bias | out_scale, Cout each
  for (int c = threadIdx.x; c < cout; c += blockDim.x) {
    vec[c] = scale[c];
    vec[cout + c] = bias[c];
    vec[2 * cout + c] = mode == densebox::kModeInt8 ? out_scale[c] : 0.0f;
  }
  __syncthreads();
  const Index step = (Index)gridDim.x * blockDim.x;
  for (Index i = (Index)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const int c = (int)(i % cout);
    const float y = densebox::dequant(acc[i], vec[c], vec[cout + c], relu);
    if (mode == densebox::kModeInt8)
      static_cast<int8_t*>(out)[i] = densebox::requant(y, vec[2 * cout + c]);
    else
      static_cast<float*>(out)[i] = y;
  }
}

}  // namespace

// acc n int32 elements, channel = index % cout; scale, bias (and out_scale
// for mode int8) cout f32; out n int8 (mode 2) or f32 (mode 1). All
// contiguous on the current device. Launches on `stream`, does not
// synchronise; returns the CUDA error code (0 = launched).
extern "C" int densebox_requant(const void* acc, const void* scale,
                                const void* bias, const void* out_scale,
                                void* out, long long n, int cout, int relu,
                                int mode, void* stream) {
  if (n < 1 || cout < 1 || cout > 4096 ||
      (mode != densebox::kModeF32 && mode != densebox::kModeInt8) ||
      (mode == densebox::kModeInt8 && out_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  const size_t smem = 3 * (size_t)cout * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= INT_MAX - (long long)blocks * kThreads)  // i + step fits an int
    requant_kernel<int><<<blocks, kThreads, smem, s>>>(
        (const int*)acc, (const float*)scale, (const float*)bias,
        (const float*)out_scale, out, (int)n, cout, relu, mode);
  else
    requant_kernel<long long><<<blocks, kThreads, smem, s>>>(
        (const int*)acc, (const float*)scale, (const float*)bias,
        (const float*)out_scale, out, n, cout, relu, mode);
  return (int)cudaGetLastError();
}
