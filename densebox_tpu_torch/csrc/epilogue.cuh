// The int8 epilogue shared by csrc/qconv.cu and csrc/requant.cu.
//
// The same per-element arithmetic as the plain PyTorch version
// (densebox_tpu_torch/ops/kernels/requant.py: requant_reference) and as the
// epilogue of the Pallas kernels it replaces (densebox_tpu/ops/pallas/
// qconv.py:_qconv_kernel, requant.py:_kernel):
//   y = relu?(f32(acc) * scale + bias)
//   q = clip(round_half_even(y * out_scale), -127, 127) as int8
// Each operation is rounded on its own (the _rn intrinsics; the build also
// passes -fmad=false), so no fused multiply-add moves a value by an ulp, and
// rintf rounds half to even like jnp.round and torch.round (roundf would
// round half away from zero). __int2float_rn rounds |acc| > 2^24 to f32 as
// the reference's astype(float32) does.

#pragma once

#include <stdint.h>

namespace densebox {

// Output modes of the C interfaces; the Python wrappers use the same numbers.
constexpr int kModeInt32 = 0;  // the raw int32 accumulator (qconv only)
constexpr int kModeF32 = 1;    // y
constexpr int kModeInt8 = 2;   // q

__device__ __forceinline__ float dequant(int acc, float scale, float bias,
                                         bool relu) {
  const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
  return relu ? fmaxf(y, 0.0f) : y;
}

__device__ __forceinline__ int8_t requant(float y, float out_scale) {
  const float q = rintf(__fmul_rn(y, out_scale));
  return (int8_t)(int)fminf(fmaxf(q, -127.0f), 127.0f);
}

}  // namespace densebox
