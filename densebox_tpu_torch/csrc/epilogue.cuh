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
// the rounding is half to even like jnp.round and torch.round (roundf would
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

// rintf and the conversion to an integer, done by the float adder (Hopper
// issues conversions at a quarter of its float rate). For |v| < 2^22, v +
// 1.5 * 2^23 lies in [2^23, 2^24), where floats are the integers, so the
// rounded sum is round_half_even(v) + 1.5 * 2^23 (the constant is even)
// and the subtraction is exact: rintf(v). Where |v| >= 2^22 the result is
// v's sign times at least 2^22 - 1, as rintf(v) is, and the clip gives
// the same code; NaN clips to -127 in both. The clipped integer q then
// sits in the low bits of q + 1.5 * 2^23, whose bit pattern is 0x4B400000
// + q.
__device__ __forceinline__ int8_t requant(float y, float out_scale) {
  constexpr float kRound = 12582912.0f;  // 1.5 * 2^23
  const float v = __fmul_rn(y, out_scale);
  const float q =
      fminf(fmaxf(__fsub_rn(__fadd_rn(v, kRound), kRound), -127.0f), 127.0f);
  return (int8_t)(__float_as_int(__fadd_rn(q, kRound)) - 0x4B400000);
}

}  // namespace densebox
