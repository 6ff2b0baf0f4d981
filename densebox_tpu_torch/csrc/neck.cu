// Int8 neck of the fused int8 chain, sm_90a.
//
// Replaces no TPU kernel: on the TPU, XLA fused the steps of
// densebox_tpu/models/quant.py:_forward_fused that join the int8 trunk to
// the int8 heads, and eager PyTorch ran them as some fifteen elementwise
// passes and two float32 GEMMs. Same contract as its plain PyTorch version,
// densebox_tpu_torch/ops/kernels/neck.py:neck_reference: from f3_q
// (B, H, W, C3) int8 codes at f3_scale and f4 (B, H/2, W/2, C4) float32,
// one pass writes feat_q (B, H, W, C3 + C4) int8 at out_scale, where
//   f3 channels: v = bf16(f32(code) * f3_scale);
//   f4 channels: f4 rounded to bf16, the x2 align-corners upsample along W
//                and then along H, each output the float32 sum of its two
//                exact products (bf16 weight times bf16 value), rounded to
//                bf16;
//   then clip(rint(f32(v) / out_scale), -127, 127) with the correctly
//   rounded quotient of a true division (a product with the reciprocal
//   alone rounds differently).
// Every operation rounds on its own (explicit _rn intrinsics, built with
// -fmad=false), so the kernel and the plain version agree bit for bit. The
// upsample's two taps per output row and column (first input index, and the
// bf16 weights of it and of the next) come from the tables that
// neck.py:interp_taps derives from interp_matrix_align_corners.
//
// What bounds it on the card: bytes, once the arithmetic stays off the
// quarter-rate units. At kitti's shapes an image reads 18.6 MB of f3 codes
// and 37 MB of f4 and writes 55.7 MB, 33 us at 3.35 TB/s; an f4 output
// costs about 18 full-rate instructions. The first version, with the
// division and every conversion on the special-function units (MUFU.RCP,
// F2I, one F2F a rounding), ran at 35% of the bytes bound. The design:
//   - the quotient without a division: y = RN(1 / s) once a thread, q =
//     v * y, then q + (v - s q) y with the remainder exact in a fused
//     multiply-add, which is RN(v / s) (Markstein's theorem) wherever it
//     can move a code; the round half to even and the byte come from adding
//     1.5 * 2^23 (tests/test_torch_neck.py holds a numpy model of this to
//     the division over every bf16 value);
//   - bf16 roundings two at a time (cvt.rn.bf16x2.f32), and the W-pass
//     rows kept as bf16 pairs, which also keeps a thread at 64 registers
//     and four blocks on an SM;
//   - a thread owns V = 16 channels of a position (8 where a width is no
//     multiple of 16), so that every load and store is a 16-byte vector
//     (f4: four a row and tap) and neighbouring threads touch neighbouring
//     vectors;
//   - an f4 thread walks a band of kBand output rows of one column and keeps
//     the W-pass values of the two f4 rows it reads in registers; a new f4
//     row is upsampled along W only when the band's rows move past it, about
//     every second output row, and the bands of one column run side by side,
//     so each f4 row comes from device memory about once (bands of 8 and 16
//     rows, and 2 or 3 blocks an SM, were slower);
//   - the f3 channels take 255 codes to 255 codes: each f3 block computes
//     that table once in shared memory and looks the codes up;
//   - one launch per pyramid scale: blocks [0, blocks_f4) do the f4
//     channels, the rest the f3 channels.
// One launch per call; it does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // = the f3 table's entries, one a thread
constexpr int kBlocksPerSm = 4;
constexpr int kBand = 32;       // output rows an f4 thread walks

// two floats rounded to bf16, as one word (a in the low half)
__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float low_bf16(uint32_t p) {
  return __uint_as_float(p << 16);
}

__device__ __forceinline__ float high_bf16(uint32_t p) {
  return __uint_as_float(p & 0xffff0000u);
}

// clip(rint(v / s), -127, 127) with round half to even, as quant_act, in
// the low byte; y = RN(1 / s). The quotient is clipped to +-128 before the
// correction, so that an overflowing product cannot turn it into a NaN.
__device__ __forceinline__ uint32_t quantise(float v, float s, float y) {
  const float q0 = fminf(fmaxf(__fmul_rn(v, y), -128.0f), 128.0f);
  const float q = __fmaf_rn(__fmaf_rn(-s, q0, v), y, q0);
  const float c = fminf(fmaxf(q, -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(c, 12582912.0f));
}

// the low bytes of a, b, c, d as one little-endian word
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// bf16(wa * x[lo] + wb * x[hi]) over V channels, x rounded to bf16 first,
// as V / 2 bf16 pairs
template <int V>
__device__ __forceinline__ void w_pass(const float* __restrict__ lo,
                                       const float* __restrict__ hi,
                                       float wa, float wb,
                                       uint32_t (&out)[V / 2]) {
#pragma unroll
  for (int i = 0; i < V; i += 4) {
    const float4 a = *reinterpret_cast<const float4*>(lo + i);
    const float4 b = *reinterpret_cast<const float4*>(hi + i);
    const uint32_t ab[4] = {bf16_pair(a.x, b.x), bf16_pair(a.y, b.y),
                            bf16_pair(a.z, b.z), bf16_pair(a.w, b.w)};
    float s[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      s[j] = __fadd_rn(__fmul_rn(wa, low_bf16(ab[j])),
                       __fmul_rn(wb, high_bf16(ab[j])));
    out[i / 2] = bf16_pair(s[0], s[1]);
    out[i / 2 + 1] = bf16_pair(s[2], s[3]);
  }
}

template <int V>
struct Vec;
template <>
struct Vec<16> {
  using T = uint4;
  __device__ static T make(const uint32_t (&w)[4]) {
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static void split(const T& v, uint32_t (&w)[4]) {
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  }
};
template <>
struct Vec<8> {
  using T = uint2;
  __device__ static T make(const uint32_t (&w)[2]) {
    return make_uint2(w[0], w[1]);
  }
  __device__ static void split(const T& v, uint32_t (&w)[2]) {
    w[0] = v.x, w[1] = v.y;
  }
};

template <int V>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
neck_kernel(const int8_t* __restrict__ f3, const float* __restrict__ f4,
            const float* __restrict__ f3_scale,
            const float* __restrict__ out_scale,
            const int* __restrict__ h_taps, const int* __restrict__ w_taps,
            int8_t* __restrict__ out, int b, int h, int w, int c3, int c4,
            long long blocks_f4) {
  using Word = typename Vec<V>::T;
  const int c = c3 + c4;
  const float so = *out_scale, yo = __frcp_rn(so);
  if (blockIdx.x >= blocks_f4) {
    // f3 channels: the table of all 256 codes, then a lookup per byte
    __shared__ int8_t table[kThreads];
    const float v = __fmul_rn((float)((int)threadIdx.x - 128), *f3_scale);
    table[threadIdx.x] = (int8_t)quantise(
        __bfloat162float(__float2bfloat16_rn(v)), so, yo);
    __syncthreads();
    const int groups = c3 / V;
    const long long item =
        (blockIdx.x - blocks_f4) * (long long)kThreads + threadIdx.x;
    if (item >= (long long)b * h * w * groups) return;
    const long long pos = item / groups;
    const int g = (int)(item - pos * groups);
    uint32_t in[V / 4], res[V / 4];
    Vec<V>::split(*reinterpret_cast<const Word*>(f3 + pos * c3 + g * V), in);
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const uint32_t x = in[i];
      res[i] = pack4(table[(int)(int8_t)(x) + 128],
                     table[(int)(int8_t)(x >> 8) + 128],
                     table[(int)(int8_t)(x >> 16) + 128],
                     table[(int)(int8_t)(x >> 24) + 128]);
    }
    *reinterpret_cast<Word*>(out + pos * c + g * V) = Vec<V>::make(res);
    return;
  }
  // f4 channels: one column, channel group and band of output rows
  const int groups = c4 / V, bands = (h + kBand - 1) / kBand;
  long long item = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (item >= (long long)b * bands * w * groups) return;
  const int g = (int)(item % groups);
  item /= groups;
  const int x = (int)(item % w);
  item /= w;
  const int band = (int)(item % bands);
  const int img = (int)(item / bands);
  const int h4 = h / 2, w4 = w / 2;
  const int wlo = w_taps[x], whi = wlo + (w4 > 1);
  const float wwa = __int_as_float(w_taps[w + x]);
  const float wwb = __int_as_float(w_taps[2 * w + x]);
  const float* src = f4 + (long long)img * h4 * w4 * c4 + g * V;
  auto row = [&](int r, uint32_t(&dst)[V / 2]) {
    const float* p = src + (long long)r * w4 * c4;
    w_pass<V>(p + (long long)wlo * c4, p + (long long)whi * c4, wwa, wwb,
              dst);
  };
  uint32_t ra[V / 2], rb[V / 2];
  int ia = -1, ib = -1;   // the f4 rows whose W-pass ra and rb hold
  const int y1 = min(h, (band + 1) * kBand);
  for (int y = band * kBand; y < y1; ++y) {
    const int lo = h_taps[y], hi = lo + (h4 > 1);
    if (lo != ia || hi != ib) {
      if (lo == ib) {
#pragma unroll
        for (int i = 0; i < V / 2; ++i) ra[i] = rb[i];
      } else {
        row(lo, ra);
      }
      row(hi, rb);
      ia = lo, ib = hi;
    }
    const float hwa = __int_as_float(h_taps[h + y]);
    const float hwb = __int_as_float(h_taps[2 * h + y]);
    uint32_t res[V / 4];
#pragma unroll
    for (int i = 0; i < V / 2; i += 2) {
      float s[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[2 * j] = __fadd_rn(__fmul_rn(hwa, low_bf16(ra[i + j])),
                             __fmul_rn(hwb, low_bf16(rb[i + j])));
        s[2 * j + 1] = __fadd_rn(__fmul_rn(hwa, high_bf16(ra[i + j])),
                                 __fmul_rn(hwb, high_bf16(rb[i + j])));
      }
      const uint32_t p0 = bf16_pair(s[0], s[1]), p1 = bf16_pair(s[2], s[3]);
      res[i / 2] = pack4(quantise(low_bf16(p0), so, yo),
                         quantise(high_bf16(p0), so, yo),
                         quantise(low_bf16(p1), so, yo),
                         quantise(high_bf16(p1), so, yo));
    }
    *reinterpret_cast<Word*>(out + (((long long)img * h + y) * w + x) * c +
                             c3 + g * V) = Vec<V>::make(res);
  }
}

}  // namespace

// f3 (b, h, w, c3) int8, f4 (b, h/2, w/2, c4) float32, f3_scale and
// out_scale one float32 each, h_taps (3, h) and w_taps (3, w) int32 (first
// input index, then the bits of the two float32 weights), out (b, h, w,
// c3 + c4) int8; all contiguous on the current device, every pointer
// 16-byte aligned. h and w even, c3 and c4 multiples of 8. Launches on
// `stream`, does not synchronise; returns the CUDA error code (0 =
// launched).
extern "C" int densebox_neck(const void* f3, const void* f4,
                             const void* f3_scale, const void* out_scale,
                             const void* h_taps, const void* w_taps, void* out,
                             int b, int h, int w, int c3, int c4,
                             void* stream) {
  if (b < 1 || h < 2 || w < 2 || h % 2 || w % 2 || c3 < 8 || c4 < 8 ||
      c3 % 8 || c4 % 8)
    return (int)cudaErrorInvalidValue;
  const int v = (c3 % 16 == 0 && c4 % 16 == 0) ? 16 : 8;
  const long long bands = (h + kBand - 1) / kBand;
  const long long n4 = (long long)b * bands * w * (c4 / v);
  const long long n3 = (long long)b * h * w * (c3 / v);
  const long long blocks_f4 = (n4 + kThreads - 1) / kThreads;
  const long long blocks = blocks_f4 + (n3 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (v == 16)
    neck_kernel<16><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int8_t*)f3, (const float*)f4, (const float*)f3_scale,
        (const float*)out_scale, (const int*)h_taps, (const int*)w_taps,
        (int8_t*)out, b, h, w, c3, c4, blocks_f4);
  else
    neck_kernel<8><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int8_t*)f3, (const float*)f4, (const float*)f3_scale,
        (const float*)out_scale, (const int*)h_taps, (const int*)w_taps,
        (int8_t*)out, b, h, w, c3, c4, blocks_f4);
  return (int)cudaGetLastError();
}
