// Int8 SAME conv (3x3 or 1x1, stride 1) with int32 accumulation and the
// int8 epilogue, on the int8 tensor cores of sm_90a.
//
// Replaces densebox_tpu/ops/pallas/qconv.py:_qconv_kernel (behind
// qconv_int8): nine MXU dots of a shifted window, int32 accumulation, fused
// requant. Same contract as its plain PyTorch version,
// densebox_tpu_torch/ops/kernels/qconv.py:qconv_reference: x (B, H, W, Cin)
// int8, w (Cout, k, k, Cin) int8 (Cin innermost), zero padding of k // 2 on
// every side; the exact int32 sum over taps and channels, then one of three
// outputs: the accumulator itself (mode int32, the hybrid chain's conv), or
// the epilogue of epilogue.cuh as f32 or as int8 codes. Integer sums are
// exact in any order, so every variant below gives the same codes.
//
// What bounds it on the card: at the narrow widths this repository serves
// (16 to 128 channels) a layer moves about as many bytes (int8 in, int8
// out, each once) as the tensor cores need time for its operations, so the
// bound is bytes as often as operations; at the paper's widths (256 to 768
// channels) it is operations. Either way the work must go to the tensor
// cores and nothing may be staged twice.
//
// Design of the tensor-core variant (Cin a multiple of 16), an implicit GEMM
// with M = the 8x16 output pixels of a tile, N = a block of NBLK output
// channels, K = taps x Cin:
//   * mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (no .satfinite: the
//     int32 sum never overflows at 9 * 768 * 127^2). Both operands are
//     K-major in memory already, which is what row.col wants. An m16 tile is
//     one row of 16 pixels; a warp owns MT tile rows and NT 8-channel tiles.
//   * The halo tile is the im2col. A stage holds the (8+2P) x (16+2P) input
//     pixels of a tile for one chunk of KC channels; the A fragment of tap
//     (dy, dx) is that tile read at a shifted pixel address, one
//     ldmatrix.x4 with a 16-byte row pointer per lane. Pixels (and the
//     weights' rows) lie an odd number of 16-byte units apart, so the eight
//     rows of an ldmatrix fall into eight different bank groups.
//   * Staging is 16-byte cp.async.cg with the source size set to 0 outside
//     the image (hardware zero fill = SAME padding without a padded copy)
//     and past Cout, through a ring of two to four stages (as many as cost
//     the SM no resident block): the next tiles (or chunks) load while this
//     one multiplies.
//   * Weights stay put: where the block's weights for all taps and all of
//     Cin fit beside two input stages (every layer of the narrow models),
//     they are loaded once and the persistent block walks many tiles
//     (grid = what the card holds at once). Where they do not fit (the
//     paper's conv3_x and conv4_x), weights stream with the input in chunks
//     of KC = 64 or 32 channels through the same ring. A narrow layer's
//     tile is little work, so the walk costs no division: two cursors (the
//     tile being loaded, the tile being multiplied) step by the grid's
//     size in (image, tile row, tile column) with carries.
//   * The epilogue runs on the accumulator registers (epilogue.cuh), goes
//     through a per-warp slice of shared memory one m16 tile at a time, and
//     leaves as 16-byte stores along Cout. Where a pixel's Cout values are
//     not whole 16-byte units (Cout 1, 5, ...) it stores scalars, masked.
// The warpgroup variant (Cin a multiple of 32 and Cout >= 64: the paper's
// widths, conv1_2 to conv4_4, the heads' 1x1 768->512 conv1, refine_conv2)
// is an implicit GEMM on wgmma, the instruction that alone reaches Hopper's
// full int8 rate. At these widths the bound is operations, so the design
// keeps the tensor cores fed and reads both operands from shared memory by
// descriptor:
//   * Persistent, warp-specialised blocks of 384 threads: one producer
//     thread issues TMA loads into rings of stages guarded by mbarriers;
//     two consumer warpgroups (setmaxnreg: 232 registers each, the
//     producer's warpgroup 40) issue wgmma.mma_async m64nNBLKk32 s8.s8.s32,
//     accumulators in registers, each over two m64 blocks of 8 x 8 output
//     pixels (1x1: 64 consecutive pixels). NBLK is 64 at Cout 64, else 128.
//   * A 3x3 tap is a shifted window of the input halo, which TMA loads as a
//     4-D box of the NHWC input at signed coordinates: out-of-bounds zero
//     fill is the SAME padding. The halo's rows are padded to 24 pixels, so
//     that an m64 block is 8 core-matrix groups at one stride, and a tap
//     moves the descriptor's start by (dy rows, dx pixels). A chunk of KC =
//     128, 64 or 32 channels is one swizzle row (128B, 64B, 32B swizzle).
//   * Weights are K-major slices of NBLK x KC bytes, in the same swizzle;
//     rows past Cout are TMA's zero fill. Where all taps' slices of a
//     channel block fit beside two input stages (short K: Cin <= 128 at 3x3,
//     the heads' conv1), they load once a block, and each consumer
//     warpgroup takes its own 8 x 16 tiles from its own input ring, so that
//     one's epilogue overlaps the other's products. Else they stream
//     through a ring of (tap, chunk) slices beside a two-stage input ring,
//     and the two warpgroups share 16 x 16 tiles (256 pixels: half the
//     weight reads of 128), each its 8 rows.
//   * wgmma is asynchronous: a commit group a tap (streamed) or a chunk
//     (resident), its stages freed once the next group is issued and it is
//     done. Nothing between two groups may branch on the thread (the warp
//     and warpgroup indices are broadcast, barrier arrivals predicated):
//     ptxas would otherwise wait for every wgmma before the next.
//   * The epilogue is epilogue.cuh's arithmetic on the accumulator
//     registers, with the channel block's constants staged in shared
//     memory; int8 codes go through a per-warp slice of shared memory to
//     16-byte stores, f32 and int32 values leave as 8-byte pairs.
// The tensor maps are encoded on the host through cudaGetDriverEntryPoint,
// so the library links no libcuda.
// Cin that is not a multiple of 16 (the paper's conv1_1, Cin 3; the refine
// branch's first conv, Cin 1 + the landmarks: 5, 6 or 9) cannot take
// 16-byte copies and is a fraction of a per cent of any model's work: it
// keeps the __dp4a kernel on the CUDA cores. The choice of variant and
// channel block is a rule of (Cin, Cout) alone, mirrored by
// ops/kernels/qconv.py:kernel_variant and reported back at every launch.
// One C call is one launch; it does not synchronise.

#include <cuda.h>  // CUtensorMap and its enums; no libcuda is linked
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"


namespace {

using densebox::kModeF32;
using densebox::kModeInt32;
using densebox::kModeInt8;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTH = 8;           // output tile rows
constexpr int kTW = 16;          // output tile columns: one m16 tile a row
constexpr int kSmemMax = 232448; // shared memory a block may use on sm_90
constexpr int kMaxDevices = 64;

// ---------------------------------------------------------------------------
// The tensor-core variant.

struct Plan {
  int batch, h, wd, cin, cout;
  int tiles_w, tiles_h, tiles_per_img, n_tiles;
  int step_b, step_ty, step_tx;  // the grid's x size as (images, rows, columns)
  int kc, n_chunks;      // channels per input chunk, chunks per tile
  int ushift;            // log2 of a pixel's 16-byte units, rounded up
  int n_stages;          // the ring's depth: 2, 3 or 4
  int pstride, wstride;  // bytes between pixels / between weight rows
  int resident;          // weights loaded once, or a chunk with every stage
  int w_bytes;           // the resident weights' area (0 when streamed)
  int in_bytes;          // the input part of a stage
  int stage_bytes;       // in_bytes plus, when streamed, the weight chunk
  int relu, vec;         // vec: a pixel's outputs are whole 16-byte units
};

// Bytes of a row of `units` 16-byte units, padded to an odd count of units.
__host__ __device__ constexpr int odd_row(int units) { return (units | 1) * 16; }

// How the 8 warps share a tile of 8 rows x NBLK channels: WARPS_M x WARPS_N
// warps of MT rows (m16 tiles) x NT n8 tiles each. Many rows per warp where
// the block is wide, since a warp reads each input row once for all three
// taps above it and each weight fragment once for all its rows.
template <int NBLK>
struct Shape {
  static constexpr int WARPS_N =
      NBLK >= 128 ? 8 : NBLK >= 64 ? 4 : NBLK >= 32 ? 2 : 1;
  static constexpr int WARPS_M = kWarps / WARPS_N;
  static constexpr int WN = NBLK / WARPS_N;   // channels per warp: 16 or 8
  static constexpr int NT = WN / 8;           // n8 tiles per warp
  static constexpr int MT = kTH / WARPS_M;    // m16 tiles (tile rows) per warp
  // blocks per SM the registers must leave room for
  static constexpr int MIN_BLOCKS = NBLK >= 128 ? 2 : 3;
};

// The epilogue's staging: m16 tiles per pass and bytes of one staged row of
// a warp (WN values, padded against bank conflicts).
__host__ __device__ constexpr int out_tiles(int mt, int es) {
  return es == 1 && mt >= 2 ? 2 : 1;
}
__host__ __device__ constexpr int out_row(int wn, int es) {
  return wn * es + (es == 1 ? 16 : 32);
}
template <int NBLK>
constexpr int out_bytes(int es) {
  return kWarps * 16 * out_tiles(Shape<NBLK>::MT, es) *
         out_row(Shape<NBLK>::WN, es);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; `bytes` = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(__cvta_generic_to_global(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, int& r0, int& r1,
                                            int& r2, int& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t addr, int& r0, int& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
}

// c += a (16 x 32, row) * b (32 x 8, col), int8 in, int32 out, wrapping
__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4],
                                       const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The input halo tile of (image b, tile origin y0, x0) for channels
// [c0, c0 + kcb): pixel-major, `pstride` bytes a pixel, zeros off the image.
// A thread keeps one 16-byte unit of the pixels tid >> ushift, + step, ...
template <int KS>
__device__ __forceinline__ void load_input(uint8_t* dst, const int8_t* x,
                                           const Plan& p, int b, int y0,
                                           int x0, int c0, int kcb) {
  constexpr int P = KS / 2, IH = kTH + 2 * P, IW = kTW + 2 * P;
  const int unit = threadIdx.x & ((1 << p.ushift) - 1);
  if (unit * 16 >= kcb) return;
  const uint32_t d0 = smem_u32(dst) + unit * 16;
  const int8_t* xb = x + (size_t)b * p.h * p.wd * p.cin + c0 + unit * 16;
  for (int pix = threadIdx.x >> p.ushift; pix < IH * IW;
       pix += kThreads >> p.ushift) {
    const int iy = pix / IW, ix = pix - iy * IW;
    const int gy = y0 + iy - P, gx = x0 + ix - P;
    const bool ok = gy >= 0 && gy < p.h && gx >= 0 && gx < p.wd;
    const int8_t* src = ok ? xb + ((size_t)gy * p.wd + gx) * p.cin : x;
    cp_async16(d0 + pix * p.pstride, src, ok ? 16 : 0);
  }
}

// The weights of output channels [n0, n0 + NBLK) for all taps and channels
// [c0, c0 + kcb): one row of `wstride` bytes per output channel, laid out
// [tap][channel]; zeros past Cout.
template <int KS, int NBLK>
__device__ __forceinline__ void load_weights(uint8_t* dst, const int8_t* w,
                                             const Plan& p, int n0, int c0,
                                             int kcb) {
  constexpr int TAPS = KS * KS;
  const int u = kcb / 16, row = TAPS * u;
  const uint32_t d0 = smem_u32(dst);
  // all of Cin at once: a channel's row is one run of the source
  const bool whole = kcb == p.cin;
  // unit r of row n, for the units threadIdx.x, + kThreads, ...: stepped
  // with a carry, so that the loop divides only where chunks split a row
  int n = threadIdx.x / row, r = threadIdx.x - n * row;
  const int dn = kThreads / row, dr = kThreads - dn * row;
  while (n < NBLK) {
    const bool ok = n0 + n < p.cout;
    const int off = whole ? r * 16 : (r / u) * p.cin + c0 + (r % u) * 16;
    const int8_t* src = ok ? w + (size_t)(n0 + n) * TAPS * p.cin + off : w;
    cp_async16(d0 + n * p.wstride + r * 16, src, ok ? 16 : 0);
    n += dn, r += dr;
    if (r >= row) r -= row, ++n;
  }
}

template <int MODE>
struct OutType;
template <>
struct OutType<kModeInt32> { using T = int; };
template <>
struct OutType<kModeF32> { using T = float; };
template <>
struct OutType<kModeInt8> { using T = int8_t; };

// One channel's epilogue constants, and one accumulator through the
// epilogue as the bits of the output type (int8 codes in the low byte).
struct Channel { float scale, bias, out_scale; };

template <int MODE>
__device__ __forceinline__ int finish(int acc, const Channel& c, bool relu) {
  if constexpr (MODE == kModeInt32) {
    return acc;
  } else {
    const float y = densebox::dequant(acc, c.scale, c.bias, relu);
    if constexpr (MODE == kModeF32)
      return __float_as_int(y);
    else
      return (int)(uint8_t)densebox::requant(y, c.out_scale);
  }
}

template <int KS, int NBLK, int MODE>
__global__ void __launch_bounds__(kThreads, Shape<NBLK>::MIN_BLOCKS)
qconv_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias,
                 const float* __restrict__ out_scale, void* __restrict__ out,
                 const Plan p) {
  using S = Shape<NBLK>;
  using T = typename OutType<MODE>::T;
  constexpr int P = KS / 2, IW = kTW + 2 * P;
  constexpr int MT = S::MT, NT = S::NT, WN = S::WN;
  constexpr int ES = sizeof(T);
  constexpr int OROW = out_row(WN, ES), OTILES = out_tiles(MT, ES);
  extern __shared__ __align__(128) uint8_t smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / S::WARPS_N, wn = warp % S::WARPS_N;
  const int g = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.y * NBLK;

  uint8_t* stages = smem + p.w_bytes;
  uint8_t* ostage =
      stages + p.n_stages * p.stage_bytes + warp * (16 * OTILES * OROW);

  // the epilogue constants of this thread's 2 * NT channels, in registers
  // for all the tiles the block walks
  Channel ch[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + wn * WN + nt * 8 + tig * 2 + j;
      const bool ok = MODE != kModeInt32 && n < p.cout;
      ch[nt][j].scale = ok ? scale[n] : 0.0f;
      ch[nt][j].bias = ok ? bias[n] : 0.0f;
      ch[nt][j].out_scale = ok && MODE == kModeInt8 ? out_scale[n] : 0.0f;
    }

  const int my_tiles =
      (p.n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int n_items = my_tiles * p.n_chunks;  // (tile, chunk) pairs, >= 1

  // Where a walk over the block's items stands: the tile blockIdx.x + i *
  // gridDim.x as (image, tile row, tile column), the chunk of Cin and the
  // stage of the ring. `next` steps without a division.
  struct Cursor { int b, ty, tx, chunk, stage; };
  auto next = [&](Cursor& c) {
    c.stage = c.stage + 1 == p.n_stages ? 0 : c.stage + 1;
    if (++c.chunk < p.n_chunks) return;
    c.chunk = 0;
    c.b += p.step_b, c.ty += p.step_ty, c.tx += p.step_tx;
    if (c.tx >= p.tiles_w) c.tx -= p.tiles_w, ++c.ty;
    if (c.ty >= p.tiles_h) c.ty -= p.tiles_h, ++c.b;
  };
  Cursor cur{};
  {
    const int t = blockIdx.x;
    cur.b = t / p.tiles_per_img;
    cur.ty = (t - cur.b * p.tiles_per_img) / p.tiles_w;
    cur.tx = t - cur.b * p.tiles_per_img - cur.ty * p.tiles_w;
  }
  Cursor ld = cur;  // runs n_stages - 1 items ahead of cur
  int fetched = 0;
  // one commit group per call, empty past the last item, so that group i
  // always carries item i
  auto prefetch = [&]() {
    if (fetched < n_items) {
      const int c0 = ld.chunk * p.kc;
      const int kcb = min(p.kc, p.cin - c0);
      uint8_t* st = stages + ld.stage * p.stage_bytes;
      load_input<KS>(st, x, p, ld.b, ld.ty * kTH, ld.tx * kTW, c0, kcb);
      if (!p.resident)
        load_weights<KS, NBLK>(st + p.in_bytes, w, p, n0, c0, kcb);
      next(ld);
    }
    ++fetched;
    cp_async_commit();
  };

  if (p.resident) load_weights<KS, NBLK>(smem, w, p, n0, 0, p.cin);
  for (int i = 0; i < p.n_stages - 1; ++i) prefetch();

  // per-lane row pointers of the ldmatrix fragments, relative to a stage:
  // A: lanes 0-15 the 16 pixels of a row at k 0-15, lanes 16-31 at k 16-31;
  // B: 8 channels at k 0-15, the same at k 16-31, then the next 8 channels
  const int a_lane = (wm * MT * IW + (lane & 7) + ((lane >> 3) & 1) * 8) *
                         p.pstride + (lane >> 4) * 16;
  const int b_row = NT >= 2 ? (lane & 7) + ((lane >> 4) & 1) * 8 : (lane & 7);
  const int b_lane = (wn * WN + b_row) * p.wstride + ((lane >> 3) & 1) * 16;

  int acc[MT][NT][4];
  for (int item = 0; item < n_items; ++item) {
    if (p.n_stages == 2) cp_async_wait<0>();
    else if (p.n_stages == 3) cp_async_wait<1>();
    else cp_async_wait<2>();
    // item's stage has landed for every thread, and every warp is done
    // with the stage that the next load overwrites
    __syncthreads();
    prefetch();

    const int chunk = cur.chunk;
    if (chunk == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
    }
    const int kcb = min(p.kc, p.cin - chunk * p.kc);
    const int ksteps = (kcb + 31) / 32;
    const bool tail = kcb % 32 != 0;  // the last k32 step holds 16 channels
    const uint8_t* st = stages + cur.stage * p.stage_bytes;
    const uint32_t a_base = smem_u32(st) + a_lane;
    // a weight row is [tap][Cin] when resident, [tap][this chunk] otherwise
    const int w_tap = p.resident ? p.cin : kcb;
    const uint32_t b_base = smem_u32(p.resident ? smem : st + p.in_bytes) +
                            b_lane + (p.resident ? chunk * p.kc : 0);
#pragma unroll
    for (int dx = 0; dx < KS; ++dx) {
      for (int ks = 0; ks < ksteps; ++ks) {
        const bool half = tail && ks == ksteps - 1;
        int b[KS][NT][2];
#pragma unroll
        for (int dy = 0; dy < KS; ++dy) {
          const uint32_t addr = b_base + (dy * KS + dx) * w_tap + ks * 32;
          if constexpr (NT >= 2)
            ldmatrix_x4(addr, b[dy][0][0], b[dy][0][1], b[dy][1][0],
                        b[dy][1][1]);
          else
            ldmatrix_x2(addr, b[dy][0][0], b[dy][0][1]);
        }
        // input row r of the warp's halo feeds output row r - dy at tap dy
#pragma unroll
        for (int r = 0; r < MT + KS - 1; ++r) {
          int a[4];
          ldmatrix_x4(a_base + (r * IW + dx) * p.pstride + ks * 32, a[0],
                      a[1], a[2], a[3]);
          if (half) a[2] = a[3] = 0;
#pragma unroll
          for (int dy = 0; dy < KS; ++dy) {
            const int mt = r - dy;
            if (mt < 0 || mt >= MT) continue;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_s8(acc[mt][nt], a, b[dy][nt]);
          }
        }
      }
    }

    if (chunk == p.n_chunks - 1) {
      const int x0 = cur.tx * kTW;
      T* ob = static_cast<T*>(out) + (size_t)cur.b * p.h * p.wd * p.cout;
      const int oy0 = cur.ty * kTH + wm * MT;
      if (WN * ES >= 16 && p.vec) {
        // registers -> the warp's slice (16 * OTILES pixels x WN values) ->
        // 16-byte stores, neighbouring lanes on neighbouring units
#pragma unroll
        for (int mt0 = 0; mt0 < MT; mt0 += OTILES) {
#pragma unroll
          for (int mp = 0; mp < OTILES; ++mp)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int hf = 0; hf < 2; ++hf) {
                const int v0 = finish<MODE>(acc[mt0 + mp][nt][2 * hf],
                                            ch[nt][0], p.relu);
                const int v1 = finish<MODE>(acc[mt0 + mp][nt][2 * hf + 1],
                                            ch[nt][1], p.relu);
                uint8_t* dst = ostage + (mp * 16 + g + 8 * hf) * OROW +
                               (nt * 8 + tig * 2) * ES;
                if constexpr (ES == 1)
                  *reinterpret_cast<uint16_t*>(dst) =
                      (uint16_t)(v0 | (v1 << 8));
                else
                  *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
              }
          __syncwarp();
          constexpr int UPR = WN * ES / 16 > 0 ? WN * ES / 16 : 1;
          for (int i = lane; i < 16 * OTILES * UPR; i += 32) {
            const int row = i / UPR, unit = i % UPR;
            const int oy = oy0 + mt0 + row / 16, ox = x0 + row % 16;
            const int n = n0 + wn * WN + unit * (16 / ES);
            if (oy < p.h && ox < p.wd && n < p.cout)
              *reinterpret_cast<int4*>(
                  ob + ((size_t)oy * p.wd + ox) * p.cout + n) =
                  *reinterpret_cast<const int4*>(ostage + row * OROW +
                                                 unit * 16);
          }
          __syncwarp();
        }
      } else {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int oy = oy0 + mt, ox = x0 + g + 8 * (i >> 1);
              const int n = n0 + wn * WN + nt * 8 + tig * 2 + (i & 1);
              if (oy >= p.h || ox >= p.wd || n >= p.cout) continue;
              const int v = finish<MODE>(acc[mt][nt][i], ch[nt][i & 1], p.relu);
              T* o = ob + ((size_t)oy * p.wd + ox) * p.cout + n;
              if constexpr (MODE == kModeF32)
                *o = __int_as_float(v);
              else
                *o = (T)v;
            }
      }
    }
    next(cur);
  }
}

// Blocks of `bytes` of dynamic shared memory that an SM holds (228 KB, 1 KB
// reserved per block), at most 3.
int blocks_fit(int bytes) {
  if (bytes > kSmemMax) return 0;
  const int n = 233472 / (bytes + 1024);
  return n > 3 ? 3 : n;
}

// How a layer is cut. Weights are resident where they fit beside two input
// stages; the input then comes whole (all of Cin a stage) where two blocks
// still fit an SM, else in chunks of 64 channels. Where the weights do not
// fit they stream with the input, in chunks of 64 channels where two blocks
// fit, else 32. The ring is as deep (up to 4 stages) as costs no block.
template <int KS, int NBLK>
Plan make_plan(int batch, int h, int wd, int cin, int cout, int es, int relu) {
  constexpr int P = KS / 2, IH = kTH + 2 * P, IW = kTW + 2 * P;
  constexpr int TAPS = KS * KS;
  const int fixed = out_bytes<NBLK>(es);
  auto in_bytes = [&](int kc) { return IH * IW * odd_row(kc / 16) + 16; };
  auto w_bytes = [&](int kc) { return NBLK * odd_row(TAPS * kc / 16) + 16; };
  const int kc64 = cin < 64 ? cin : 64;
  Plan p{};
  p.batch = batch, p.h = h, p.wd = wd, p.cin = cin, p.cout = cout;
  p.tiles_w = (wd + kTW - 1) / kTW;
  p.tiles_h = (h + kTH - 1) / kTH;
  p.tiles_per_img = p.tiles_w * p.tiles_h;
  p.n_tiles = batch * p.tiles_per_img;
  p.resident = w_bytes(cin) + 2 * in_bytes(kc64) + fixed <= kSmemMax;
  if (p.resident)
    p.kc = blocks_fit(w_bytes(cin) + 2 * in_bytes(cin) + fixed) >= 2 ? cin
                                                                     : kc64;
  else
    p.kc = blocks_fit(2 * (in_bytes(64) + w_bytes(64)) + fixed) >= 2 ? 64 : 32;
  p.n_chunks = (cin + p.kc - 1) / p.kc;
  const int units = p.kc / 16;
  while ((1 << p.ushift) < units) ++p.ushift;
  p.pstride = odd_row(units);
  p.wstride = odd_row(TAPS * (p.resident ? cin : p.kc) / 16);
  p.w_bytes = p.resident ? w_bytes(cin) : 0;
  p.in_bytes = in_bytes(p.kc);
  p.stage_bytes = p.in_bytes + (p.resident ? 0 : w_bytes(p.kc));
  auto total = [&](int s) { return p.w_bytes + s * p.stage_bytes + fixed; };
  p.n_stages = 2;
  while (p.n_stages < 4 &&
         blocks_fit(total(p.n_stages + 1)) == blocks_fit(total(2)))
    ++p.n_stages;
  p.relu = relu;
  p.vec = (cout * es) % 16 == 0;
  return p;
}

int sm_count(int dev) {
  static int sms[kMaxDevices];
  if (!sms[dev] && cudaDeviceGetAttribute(&sms[dev],
                                          cudaDevAttrMultiProcessorCount,
                                          dev) != cudaSuccess)
    return 0;
  return sms[dev];
}

template <int KS, int NBLK, int MODE>
int launch_mma(const int8_t* x, const int8_t* w, const float* scale,
               const float* bias, const float* out_scale, void* out,
               int batch, int h, int wd, int cin, int cout, int relu,
               cudaStream_t s, int* info) {
  constexpr int ES = sizeof(typename OutType<MODE>::T);
  Plan p = make_plan<KS, NBLK>(batch, h, wd, cin, cout, ES, relu);
  info[2] = p.kc, info[3] = p.resident;
  const int smem = p.w_bytes + p.n_stages * p.stage_bytes + out_bytes<NBLK>(ES);
  auto kern = qconv_mma_kernel<KS, NBLK, MODE>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  static bool attr_set[kMaxDevices];  // per instance and device
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = true;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count(dev);
  if (per_sm < 1 || sms < 1) return (int)cudaErrorLaunchOutOfResources;
  // persistent blocks: as many as the card holds at once, each walking the
  // tiles blockIdx.x, blockIdx.x + gridDim.x, ... of its channel block
  const int n_blocks = (cout + NBLK - 1) / NBLK;
  int gx = per_sm * sms / n_blocks;
  gx = gx < 1 ? 1 : gx > p.n_tiles ? p.n_tiles : gx;
  info[4] = gx, info[5] = smem, info[6] = p.n_stages;
  p.step_b = gx / p.tiles_per_img;
  p.step_ty = gx % p.tiles_per_img / p.tiles_w;
  p.step_tx = gx % p.tiles_w;
  kern<<<dim3(gx, n_blocks), kThreads, smem, s>>>(x, w, scale, bias, out_scale,
                                                  out, p);
  return (int)cudaGetLastError();
}

template <int KS, int NBLK>
int launch_mma_mode(int mode, const int8_t* x, const int8_t* w,
                    const float* scale, const float* bias,
                    const float* out_scale, void* out, int batch, int h,
                    int wd, int cin, int cout, int relu, cudaStream_t s,
                    int* info) {
  if (mode == kModeInt8)
    return launch_mma<KS, NBLK, kModeInt8>(x, w, scale, bias, out_scale, out,
                                           batch, h, wd, cin, cout, relu, s,
                                           info);
  if (mode == kModeF32)
    return launch_mma<KS, NBLK, kModeF32>(x, w, scale, bias, out_scale, out,
                                          batch, h, wd, cin, cout, relu, s,
                                          info);
  return launch_mma<KS, NBLK, kModeInt32>(x, w, scale, bias, out_scale, out,
                                          batch, h, wd, cin, cout, relu, s,
                                          info);
}

// ---------------------------------------------------------------------------
// The warpgroup variant.

constexpr int kWgThreads = 384;  // two consumer warpgroups, one producer
constexpr int kWgConsumerWarps = 8;
constexpr int kWgMaxStages = 8;
constexpr int kHaloRow = 24;     // 3x3: halo pixels staged a row (18 read)

struct WgPlan {
  int h, wd, cout;
  int n_nblk, n_tiles;          // channel blocks, output tiles
  int resident;                 // weights loaded once a block, each consumer
                                // warpgroup on its own tiles; else streamed,
                                // both warpgroups on every tile
  int tile_rows, tile_px;       // 3x3: tile rows (of 16 columns); 1x1: pixels
  int tiles_w, tiles_per_img;   // 3x3
  int n_pix;                    // 1x1: B * H * W
  int kc, n_chunks, swz;        // channels a chunk, Cin / kc, swizzle mode
  int a_stages, b_stages;       // input stages; weights' ring (streamed)
  int a_ring;                   // input stages a ring: resident, one ring a
                                // consumer warpgroup; streamed, one ring
  int a_bytes, a_tx, b_bytes;   // stage stride, bytes TMA delivers, slice
  int b_off, epi_off, bar_off;  // offsets from the 1024-aligned base
  int relu, vec;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Arrives on the barrier where `pred` holds: a predicated instruction and
// no branch, so that no divergent path lies between two wgmma groups.
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(bar),
      "r"((uint32_t)pred)
      : "memory");
}

// Until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A shared-memory matrix descriptor of wgmma: K-major, swizzled rows of
// 32, 64 or 128 bytes (layout 3, 2, 1), 8-row groups `sbo` bytes apart.
// The swizzle is a function of the shared-memory address itself, for TMA's
// writes and wgmma's reads alike (every stage is 1024-byte aligned), so a
// window that starts inside the swizzle's pattern (a tap's shift) needs no
// base offset.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, int sbo,
                                              int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(sbo >> 4) << 32 | (uint64_t)layout << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Pins a register between asynchronous wgmma and the code around it.
__device__ __forceinline__ void fence_operand(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// Barrier `id` (1 or 2) of the 128 threads of one consumer warpgroup.
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

// d (+)= a x b for an m64 block, s8 x s8 -> s32 (no .satfinite: the sum
// never overflows); scale_d 0 starts the sum.
__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma(int (&d)[N / 2], uint64_t a, uint64_t b,
                                      int scale_d) {
  if constexpr (N == 64)
    wgmma_n64(d, a, b, scale_d);
  else
    wgmma_n128(d, a, b, scale_d);
}

// The k-th tile of this block and its block of output channels: streamed,
// tile-major over (tile, channel block) by the grid's stride; resident, the
// block's one channel block, its tiles by the stride of the blocks sharing
// it. False past the last tile.
__device__ __forceinline__ bool wg_tile(const WgPlan& p, int k, int& tile,
                                        int& nb) {
  if (p.resident) {
    nb = blockIdx.x % p.n_nblk;
    tile = blockIdx.x / p.n_nblk + k * (gridDim.x / p.n_nblk);
  } else {
    const int item = blockIdx.x + k * gridDim.x;
    tile = item / p.n_nblk;
    nb = item - tile * p.n_nblk;
  }
  return tile < p.n_tiles;
}

// Where a tile lies: image and origin (3x3) or first pixel (1x1).
struct WgItem { int b, y0, x0, p0, nb; };

template <int KS>
__device__ __forceinline__ WgItem wg_item(const WgPlan& p, int tile, int nb) {
  WgItem it{};
  it.nb = nb;
  if constexpr (KS == 3) {
    it.b = tile / p.tiles_per_img;
    const int t = tile - it.b * p.tiles_per_img;
    const int ty = t / p.tiles_w;
    it.y0 = ty * p.tile_rows;
    it.x0 = (t - ty * p.tiles_w) * 16;
  } else {
    it.p0 = tile * p.tile_px;
  }
  return it;
}

// The epilogue of one consumer warp: its 16 rows of each of its two m64
// blocks. Block j starts at tile pixel (r0, 8j) (3x3; row m of the block
// is pixel (m / 8, m % 8) of its 8 x 8) or at tile pixel px0 + 64j (1x1);
// the accumulator's register 4i + 2h + e holds row 16 * warp + g + 8h,
// channel 8i + 2 * tig + e. `cst` holds the block's scale, bias and
// out_scale, NBLK each.
template <int KS, int NBLK, int MODE>
__device__ __forceinline__ void wg_epilogue(
    int (&acc)[2][NBLK / 2], const WgPlan& p, const WgItem& it, int r0,
    int px0, int wq, int lane, uint8_t* slice, const float* cst,
    void* __restrict__ out) {
  using T = typename OutType<MODE>::T;
  constexpr int ES = sizeof(T), ROW = NBLK + 16, UNITS = NBLK / 16;
  const int g = lane >> 2, tig = lane & 3;
  const int n0 = it.nb * NBLK;
  // the constants of channels 8i + 2 * tig + (0, 1) of the block
  auto channels = [&](int i, Channel& ch0, Channel& ch1) {
    const int n = 8 * i + 2 * tig;
    const float2 sc = *reinterpret_cast<const float2*>(cst + n);
    const float2 bi = *reinterpret_cast<const float2*>(cst + NBLK + n);
    const float2 os = *reinterpret_cast<const float2*>(cst + 2 * NBLK + n);
    ch0 = Channel{sc.x, bi.x, os.x};
    ch1 = Channel{sc.y, bi.y, os.y};
  };
  // the global pixel of row q (0..15) of block j, or -1 off the map
  auto pixel = [&](int j, int q) -> long long {
    if constexpr (KS == 3) {
      const int oy = it.y0 + r0 + 2 * wq + (q >> 3);
      const int ox = it.x0 + 8 * j + (q & 7);
      if (oy >= p.h || ox >= p.wd) return -1;
      return ((long long)it.b * p.h + oy) * p.wd + ox;
    } else {
      const int px = it.p0 + px0 + 64 * j + 16 * wq + q;
      return px < p.n_pix ? px : -1;
    }
  };
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if constexpr (ES == 1) {
#pragma unroll
      for (int i = 0; i < NBLK / 8; ++i) {
        Channel ch0, ch1;
        channels(i, ch0, ch1);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int v0 = finish<MODE>(acc[j][4 * i + 2 * hf], ch0, p.relu);
          const int v1 = finish<MODE>(acc[j][4 * i + 2 * hf + 1], ch1, p.relu);
          *reinterpret_cast<uint16_t*>(slice + (g + 8 * hf) * ROW + 8 * i +
                                       2 * tig) = (uint16_t)(v0 | (v1 << 8));
        }
      }
      __syncwarp();
      T* o = static_cast<T*>(out);
#pragma unroll
      for (int u = lane; u < 16 * UNITS; u += 32) {
        const int q = u / UNITS, unit = u % UNITS;
        const long long px = pixel(j, q);
        const int n = n0 + unit * 16;
        if (px < 0 || n >= p.cout) continue;
        const uint8_t* src = slice + q * ROW + unit * 16;
        T* dst = o + px * p.cout + n;
        if (p.vec) {
          *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
        } else {
          for (int e = 0; e < 16 && n + e < p.cout; ++e) dst[e] = (T)src[e];
        }
      }
      __syncwarp();
    } else {
      T* o = static_cast<T*>(out);
      const long long px0 = pixel(j, g), px1 = pixel(j, g + 8);
#pragma unroll
      for (int i = 0; i < NBLK / 8; ++i) {
        const int n = n0 + 8 * i + 2 * tig;
        if (n >= p.cout) continue;
        Channel ch0, ch1;
        channels(i, ch0, ch1);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const long long px = hf ? px1 : px0;
          if (px < 0) continue;
          const int v0 = finish<MODE>(acc[j][4 * i + 2 * hf], ch0, p.relu);
          const int v1 = finish<MODE>(acc[j][4 * i + 2 * hf + 1], ch1, p.relu);
          T* dst = o + px * p.cout + n;
          if (p.vec && n + 1 < p.cout) {
            *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
          } else {
            *reinterpret_cast<int*>(dst) = v0;
            if (n + 1 < p.cout) *reinterpret_cast<int*>(dst + 1) = v1;
          }
        }
      }
    }
  }
}

template <int KS, int NBLK, int MODE>
__global__ void __launch_bounds__(kWgThreads, 1)
qconv_mma_kernel_wg(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    const float* __restrict__ out_scale,
                    void* __restrict__ out, const WgPlan p) {
  constexpr int TAPS = KS * KS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t a0 = base, b0 = base + p.b_off, bars = base + p.bar_off;
  // barriers: A full, B full, A empty, B empty, the resident weights, the
  // two consumer warpgroups' turns (resident)
  const uint32_t a_full = bars, b_full = bars + 8 * kWgMaxStages;
  const uint32_t a_empty = bars + 16 * kWgMaxStages;
  const uint32_t b_empty = bars + 24 * kWgMaxStages;
  const uint32_t w_full = bars + 32 * kWgMaxStages;
  const uint32_t turn = w_full + 8;
  // resident: one warpgroup consumes a stage; streamed: both
  const int consumers = p.resident ? 4 : kWgConsumerWarps;

  // warp and warpgroup as values the compiler knows to be warp-uniform
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffff, tid >> 5, 0);
  if (tid == 0) {
    for (int s = 0; s < p.a_stages; ++s) {
      mbar_init(a_full + 8 * s, 1);
      mbar_init(a_empty + 8 * s, consumers);
    }
    for (int s = 0; s < p.b_stages; ++s) {
      mbar_init(b_full + 8 * s, 1);
      mbar_init(b_empty + 8 * s, kWgConsumerWarps);
    }
    mbar_init(w_full, 1);
    mbar_init(turn, 4);
    mbar_init(turn + 8, 4);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kWgConsumerWarps) {
    // the producer: one thread walks the block's tiles in order and keeps
    // the rings full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == kWgConsumerWarps && lane == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"((uint64_t)&xmap)
                   : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"((uint64_t)&wmap)
                   : "memory");
      int tile, nb;
      if (p.resident && wg_tile(p, 0, tile, nb)) {
        mbar_expect_tx(w_full, TAPS * p.n_chunks * p.b_bytes);
        for (int t = 0; t < TAPS; ++t)
          for (int c = 0; c < p.n_chunks; ++c)
            tma_load_2d(b0 + (t * p.n_chunks + c) * p.b_bytes, &wmap, w_full,
                        (t * p.n_chunks + c) * p.kc, nb * NBLK);
      }
      // input ring positions (resident: warpgroup 0's tiles in ring 0,
      // warpgroup 1's in ring 1)
      int as0 = 0, ap0 = 0, as1 = 0, ap1 = 0, bs = 0, bp = 0;
      for (int k = 0; wg_tile(p, k, tile, nb); ++k) {
        const WgItem it = wg_item<KS>(p, tile, nb);
        const bool ring1 = p.resident && (k & 1);
        int as = ring1 ? as1 : as0, ap = ring1 ? ap1 : ap0;
        for (int c = 0; c < p.n_chunks; ++c) {
          const int st = (ring1 ? p.a_ring : 0) + as;
          mbar_wait(a_empty + 8 * st, ap ^ 1);
          mbar_expect_tx(a_full + 8 * st, p.a_tx);
          const uint32_t dst = a0 + st * p.a_bytes;
          if constexpr (KS == 3)
            tma_load_4d(dst, &xmap, a_full + 8 * st, c * p.kc, it.x0 - 1,
                        it.y0 - 1, it.b);
          else
            tma_load_2d(dst, &xmap, a_full + 8 * st, c * p.kc, it.p0);
          if (++as == p.a_ring) as = 0, ap ^= 1;
          if (p.resident) continue;
          for (int t = 0; t < TAPS; ++t) {
            mbar_wait(b_empty + 8 * bs, bp ^ 1);
            mbar_expect_tx(b_full + 8 * bs, p.b_bytes);
            tma_load_2d(b0 + bs * p.b_bytes, &wmap, b_full + 8 * bs,
                        (t * p.n_chunks + c) * p.kc, it.nb * NBLK);
            if (++bs == p.b_stages) bs = 0, bp ^= 1;
          }
        }
        if (ring1)
          as1 = as, ap1 = ap;
        else
          as0 = as, ap0 = ap;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp >> 2, wq = warp & 3;
    uint8_t* const epi = smem_raw + (base - raw) + p.epi_off;
    uint8_t* slice = epi + warp * 16 * (NBLK + 16);
    float* cst = reinterpret_cast<float*>(epi + kWgConsumerWarps * 16 *
                                          (NBLK + 16)) + wg * 3 * NBLK;
    int cst_nb = -1;  // the channel block whose constants cst holds
    // this warpgroup's two m64 blocks inside a tile: from pixel (r0, 0),
    // block 1 eight pixels on (3x3); from pixel px0, block 1 64 on (1x1)
    const int r0 = p.resident ? 0 : 8 * wg;
    const int px0 = p.resident ? 0 : 128 * wg;
    const int a_sbo = KS == 3 ? kHaloRow * p.kc : 8 * p.kc;
    const int b_sbo = 8 * p.kc, ksteps = p.kc / 32;
    const uint32_t a_block = KS == 3 ? (uint32_t)(r0 * kHaloRow * p.kc)
                                     : (uint32_t)(px0 * p.kc);
    const uint32_t a_next = KS == 3 ? 8 * p.kc : 64 * p.kc;
    int acc[2][NBLK / 2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < NBLK / 2; ++i) acc[j][i] = 0;
    bool weights_ready = !p.resident;
    // the input ring this warpgroup reads, and where it stands
    const int ring0 = p.resident ? wg * p.a_ring : 0;
    int as = 0, ap = 0, bs = 0, bp = 0;
    // Slots of the last two committed groups of wgmma (newest first), -1
    // where none: a group's slots are freed once wgmma_wait says it is
    // done. Streamed: a group a tap; resident: a group a chunk; one left in
    // flight where the ring has a second stage.
    int qb0 = -1, qa0 = -1, qb1 = -1, qa1 = -1;
    auto release = [&](int& b, int& a) {
      mbar_arrive_if(b_empty + 8 * (b < 0 ? 0 : b), lane == 0 && b >= 0);
      mbar_arrive_if(a_empty + 8 * (a < 0 ? 0 : a), lane == 0 && a >= 0);
      b = a = -1;
    };
    auto commit = [&](int b, int a) {
      wgmma_commit();
      qb1 = qb0, qa1 = qa0, qb0 = b, qa0 = a;
      if (p.a_ring > 1 || !p.resident) {
        wgmma_wait<1>();
        release(qb1, qa1);
      } else {
        wgmma_wait<0>();
        release(qb0, qa0);
      }
    };
    const int k0 = p.resident ? wg : 0, dk = p.resident ? 2 : 1;
    int tile, nb, turns = 0;
    for (int k = k0; wg_tile(p, k, tile, nb); k += dk) {
      const WgItem it = wg_item<KS>(p, tile, nb);
      if (!weights_ready) {
        mbar_wait(w_full, 0);
        weights_ready = true;
      }
      // resident: the warpgroups take the tensor cores in turns, a tile
      // each, so that one's epilogue runs under the other's products
      // (warpgroup 0 goes first)
      if (p.resident) mbar_wait(turn + 8 * wg, (turns & 1) ^ (wg == 0));
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < NBLK / 2; ++i) fence_operand(acc[j][i]);
      for (int c = 0; c < p.n_chunks; ++c) {
        const int a_slot = ring0 + as;
        mbar_wait(a_full + 8 * a_slot, ap);
        const uint32_t a_st = a0 + a_slot * p.a_bytes + a_block;
        wgmma_fence();
#pragma unroll 1
        for (int t = 0; t < TAPS; ++t) {
          const int dy = t / KS, dx = t - dy * KS;
          uint32_t b_st;
          if (p.resident) {
            b_st = b0 + (t * p.n_chunks + c) * p.b_bytes;
          } else {
            mbar_wait(b_full + 8 * bs, bp);
            b_st = b0 + bs * p.b_bytes;
          }
          const uint32_t a_tap = a_st + (dy * kHaloRow + dx) * p.kc;
          for (int ks = 0; ks < ksteps; ++ks) {
            const uint64_t db = smem_desc(b_st + 32 * ks, b_sbo, p.swz);
            const int sd = (c | t | ks) != 0;
            wgmma<NBLK>(acc[0], smem_desc(a_tap + 32 * ks, a_sbo, p.swz), db,
                        sd);
            wgmma<NBLK>(acc[1],
                        smem_desc(a_tap + a_next + 32 * ks, a_sbo, p.swz), db,
                        sd);
          }
          if (!p.resident) {
            commit(bs, t == TAPS - 1 ? a_slot : -1);
            if (++bs == p.b_stages) bs = 0, bp ^= 1;
          }
        }
        if (p.resident) commit(-1, a_slot);
        if (++as == p.a_ring) as = 0, ap ^= 1;
      }
      wgmma_wait<0>();
      release(qb1, qa1);
      release(qb0, qa0);
      if (p.resident) {
        mbar_arrive_if(turn + 8 * (1 - wg), lane == 0);
        ++turns;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < NBLK / 2; ++i) fence_operand(acc[j][i]);
      if (it.nb != cst_nb) {  // the block's epilogue constants, once
        warpgroup_sync(1 + wg);  // no warp reads the old ones any more
        const int i = tid & 127, n = it.nb * NBLK + i;
        const bool ok = MODE != kModeInt32 && n < p.cout;
        if (i < NBLK) {
          cst[i] = ok ? scale[n] : 0.0f;
          cst[NBLK + i] = ok ? bias[n] : 0.0f;
          cst[2 * NBLK + i] = ok && MODE == kModeInt8 ? out_scale[n] : 0.0f;
        }
        warpgroup_sync(1 + wg);
        cst_nb = it.nb;
      }
      wg_epilogue<KS, NBLK, MODE>(acc, p, it, r0, px0, wq, lane, slice, cst,
                                  out);
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// A tiled map of int8 data: dims[0] contiguous, `strides` (bytes) for the
// others; zeros outside the tensor.
bool encode_map(CUtensorMap* map, const void* ptr, int rank,
                const cuuint64_t* dims, const cuuint64_t* strides,
                const cuuint32_t* box, int kc) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = kc == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : kc == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(ptr),
            dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int KS, int NBLK, int MODE>
int launch_wg(const int8_t* x, const int8_t* w, const float* scale,
              const float* bias, const float* out_scale, void* out, int batch,
              int h, int wd, int cin, int cout, int relu, cudaStream_t s,
              int* info) {
  constexpr int ES = sizeof(typename OutType<MODE>::T);
  constexpr int TAPS = KS * KS;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const int sms = sm_count(dev);
  if (sms < 1) return (int)cudaErrorLaunchOutOfResources;

  WgPlan p{};
  p.h = h, p.wd = wd, p.cout = cout, p.relu = relu;
  p.n_nblk = (cout + NBLK - 1) / NBLK;
  p.n_pix = batch * h * wd;
  p.tiles_w = (wd + 15) / 16;
  p.kc = cin % 128 == 0 ? 128 : cin % 64 == 0 ? 64 : 32;
  p.n_chunks = cin / p.kc;
  p.swz = p.kc == 128 ? 1 : p.kc == 64 ? 2 : 3;
  p.b_bytes = NBLK * p.kc;
  // tiles of `rows` x 16 pixels (3x3) or 16 * rows pixels (1x1)
  auto tiles = [&](int rows) -> long long {
    return KS == 3 ? (long long)batch * ((h + rows - 1) / rows) * p.tiles_w
                   : ((long long)p.n_pix + 16 * rows - 1) / (16 * rows);
  };
  auto a_tx = [&](int rows) {
    return KS == 3 ? kHaloRow * (rows + 2) * p.kc : 16 * rows * p.kc;
  };
  auto a_bytes = [&](int rows) { return (a_tx(rows) + 1023) & ~1023; };
  // the int8 codes' staging (a slice a warp), then the epilogue constants
  // (a copy a consumer warpgroup)
  const int epi = kWgConsumerWarps * 16 * (NBLK + 16) + 2 * 3 * NBLK * 4;
  const int room = kSmemMax - 1024 - epi - 512;
  const int w_bytes = TAPS * p.n_chunks * p.b_bytes;
  // Weights stay in shared memory, and each consumer warpgroup takes its
  // own 128-pixel tiles, where they fit beside two input stages: short K,
  // whose epilogue would leave the tensor cores idle in turns. Else they
  // stream and both warpgroups share tiles of 256 pixels, or of 128 where
  // that takes under three quarters of the waves of the card (counted in
  // 128-pixel units: ragged maps, small launches).
  p.resident = w_bytes + 2 * a_bytes(8) <= room;
  p.tile_rows = p.resident ? 8 : 16;
  p.tile_px = 16 * p.tile_rows;
  if (tiles(p.tile_rows) * p.n_nblk > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  p.n_tiles = (int)tiles(p.tile_rows);
  p.tiles_per_img = ((h + p.tile_rows - 1) / p.tile_rows) * p.tiles_w;
  p.a_tx = a_tx(p.tile_rows);
  p.a_bytes = a_bytes(p.tile_rows);
  // ring depths: resident, an even number of input stages, half a
  // consumer warpgroup; streamed 3x3, two input stages (a chunk serves nine
  // taps) and the weights' ring; streamed 1x1, as many of each.
  if (p.resident) {
    p.b_stages = 0;
    p.a_stages = (room - w_bytes) / p.a_bytes;
    if (p.a_stages > kWgMaxStages) p.a_stages = kWgMaxStages;
    p.a_stages &= ~1;
    p.a_ring = p.a_stages / 2;
  } else {
    if (KS == 3) {
      p.a_stages = 2;
      p.b_stages = (room - 2 * p.a_bytes) / p.b_bytes;
    } else {
      p.a_stages = p.b_stages = room / (p.a_bytes + p.b_bytes);
    }
    if (p.b_stages > kWgMaxStages) p.b_stages = kWgMaxStages;
    if (p.a_stages > kWgMaxStages) p.a_stages = kWgMaxStages;
    p.a_ring = p.a_stages;
  }
  if (p.a_ring < 1 || (!p.resident && (p.a_stages < 2 || p.b_stages < 2)))
    return (int)cudaErrorInvalidValue;
  p.b_off = p.a_stages * p.a_bytes;
  p.epi_off = p.b_off + (p.resident ? w_bytes : p.b_stages * p.b_bytes);
  p.bar_off = p.epi_off + epi;
  const int smem = 1024 + p.bar_off + 512;
  p.vec = ES == 1 ? cout % 16 == 0 : cout % 2 == 0;

  CUtensorMap xmap, wmap;
  bool ok;
  if (KS == 3) {
    const cuuint64_t dims[4] = {(cuuint64_t)cin, (cuuint64_t)wd,
                                (cuuint64_t)h, (cuuint64_t)batch};
    const cuuint64_t strides[3] = {(cuuint64_t)cin, (cuuint64_t)wd * cin,
                                   (cuuint64_t)h * wd * cin};
    const cuuint32_t box[4] = {(cuuint32_t)p.kc, (cuuint32_t)kHaloRow,
                               (cuuint32_t)p.tile_rows + 2, 1};
    ok = encode_map(&xmap, x, 4, dims, strides, box, p.kc);
  } else {
    const cuuint64_t dims[2] = {(cuuint64_t)cin, (cuuint64_t)p.n_pix};
    const cuuint64_t strides[1] = {(cuuint64_t)cin};
    const cuuint32_t box[2] = {(cuuint32_t)p.kc, (cuuint32_t)p.tile_px};
    ok = encode_map(&xmap, x, 2, dims, strides, box, p.kc);
  }
  {
    const cuuint64_t dims[2] = {(cuuint64_t)TAPS * cin, (cuuint64_t)cout};
    const cuuint64_t strides[1] = {(cuuint64_t)TAPS * cin};
    const cuuint32_t box[2] = {(cuuint32_t)p.kc, (cuuint32_t)NBLK};
    ok = ok && encode_map(&wmap, w, 2, dims, strides, box, p.kc);
  }
  if (!ok) return (int)cudaErrorInvalidValue;

  auto kern = qconv_mma_kernel_wg<KS, NBLK, MODE>;
  static bool attr_set[kMaxDevices];  // per instance and device
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = true;
  }
  // persistent blocks, one an SM; resident, a whole number of blocks for
  // each channel block
  const long long work = (long long)p.n_tiles * p.n_nblk;
  int grid = p.resident ? sms / p.n_nblk * p.n_nblk : sms;
  if (grid < p.n_nblk) grid = p.n_nblk;
  if (work < grid) grid = (int)work;
  info[2] = p.kc, info[3] = p.resident, info[4] = grid, info[5] = smem;
  info[6] = p.a_stages, info[7] = p.b_stages, info[8] = p.tile_px;
  kern<<<grid, kWgThreads, smem, s>>>(xmap, wmap, scale, bias, out_scale, out,
                                      p);
  return (int)cudaGetLastError();
}

template <int KS, int NBLK>
int launch_wg_mode(int mode, const int8_t* x, const int8_t* w,
                   const float* scale, const float* bias,
                   const float* out_scale, void* out, int batch, int h, int wd,
                   int cin, int cout, int relu, cudaStream_t s, int* info) {
  if (mode == kModeInt8)
    return launch_wg<KS, NBLK, kModeInt8>(x, w, scale, bias, out_scale, out,
                                          batch, h, wd, cin, cout, relu, s,
                                          info);
  if (mode == kModeF32)
    return launch_wg<KS, NBLK, kModeF32>(x, w, scale, bias, out_scale, out,
                                         batch, h, wd, cin, cout, relu, s,
                                         info);
  return launch_wg<KS, NBLK, kModeInt32>(x, w, scale, bias, out_scale, out,
                                         batch, h, wd, cin, cout, relu, s,
                                         info);
}

// ---------------------------------------------------------------------------
// The CUDA-core variant, for Cin that is not a multiple of 16. One block of
// 256 threads per (image, 8x16 output tile, block of COB output channels);
// Cin is walked in chunks of 32 channels staged as 4-channel words (zeros
// off the image and past Cin); each thread owns 4 pixels of a tile row and
// COB/8 channels and multiplies with __dp4a.

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
qconv_dp4a_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias,
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
      if (mode == kModeInt32) {
        static_cast<int*>(out)[o] = acc[i][j];
        continue;
      }
      const float y = densebox::dequant(acc[i][j], scale[co], bias[co], relu);
      if (mode == kModeInt8)
        static_cast<int8_t*>(out)[o] = densebox::requant(y, out_scale[co]);
      else
        static_cast<float*>(out)[o] = y;
    }
  }
}

template <int KS, int COB>
int launch_dp4a(const int8_t* x, const int8_t* w, const float* scale,
                const float* bias, const float* out_scale, void* out,
                int batch, int h, int wd, int cin, int cout, int relu,
                int mode, cudaStream_t s) {
  // word loads need every 4-channel group 4-byte aligned
  const bool aligned = cin % 4 == 0 && (uintptr_t)x % 4 == 0 &&
                       (uintptr_t)w % 4 == 0;
  const int tiles_w = (wd + kTW - 1) / kTW;
  const int tiles_h = (h + kTH - 1) / kTH;
  if (batch > 65535 || (cout + COB - 1) / COB > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(tiles_h * tiles_w, (cout + COB - 1) / COB, batch);
  qconv_dp4a_kernel<KS, COB><<<grid, kThreads, 0, s>>>(
      x, w, scale, bias, out_scale, out, h, wd, cin, cout, tiles_w, aligned,
      relu, mode);
  return (int)cudaGetLastError();
}

// The rule of dispatch (ops/kernels/qconv.py:kernel_variant mirrors it):
// the warpgroup variant where Cin is a multiple of 32 and Cout at least 64,
// with a channel block of 64 at Cout 64 and 128 above; else the tensor
// cores of mma.sync whenever Cin is a multiple of 16, with the smallest
// channel block of 8, 16, 32, 64, 128 that holds Cout (128 above that);
// else the CUDA cores with a block of 16, 32 or 64.
constexpr int kPathDp4a = 0, kPathMma = 1, kPathWg = 2;

int path_of(int cin, int cout) {
  return cin % 32 == 0 && cout >= 64 ? kPathWg
         : cin % 16 == 0             ? kPathMma
                                     : kPathDp4a;
}

int channel_block(int cin, int cout) {
  switch (path_of(cin, cout)) {
    case kPathWg: return cout <= 64 ? 64 : 128;
    case kPathMma:
      return cout <= 8 ? 8 : cout <= 16 ? 16 : cout <= 32 ? 32
           : cout <= 64 ? 64 : 128;
    default: return cout <= 16 ? 16 : cout <= 32 ? 32 : 64;
  }
}

template <int KS>
int dispatch(const int8_t* x, const int8_t* w, const float* scale,
             const float* bias, const float* out_scale, void* out, int batch,
             int h, int wd, int cin, int cout, int relu, int mode,
             cudaStream_t s, int* info) {
#define DENSEBOX_MMA(NBLK)                                                   \
  return launch_mma_mode<KS, NBLK>(mode, x, w, scale, bias, out_scale, out,  \
                                   batch, h, wd, cin, cout, relu, s, info)
#define DENSEBOX_WG(NBLK)                                                    \
  return launch_wg_mode<KS, NBLK>(mode, x, w, scale, bias, out_scale, out,   \
                                  batch, h, wd, cin, cout, relu, s, info)
#define DENSEBOX_DP4A(COB)                                                   \
  return launch_dp4a<KS, COB>(x, w, scale, bias, out_scale, out, batch, h,   \
                              wd, cin, cout, relu, mode, s)
  if (info[0] == kPathWg) {
    if (info[1] == 64) DENSEBOX_WG(64);
    DENSEBOX_WG(128);
  }
  if (info[0] == kPathMma) {
    switch (info[1]) {
      case 8: DENSEBOX_MMA(8);
      case 16: DENSEBOX_MMA(16);
      case 32: DENSEBOX_MMA(32);
      case 64: DENSEBOX_MMA(64);
      default: DENSEBOX_MMA(128);
    }
  }
  switch (info[1]) {
    case 16: DENSEBOX_DP4A(16);
    case 32: DENSEBOX_DP4A(32);
    default: DENSEBOX_DP4A(64);
  }
#undef DENSEBOX_WG
#undef DENSEBOX_MMA
#undef DENSEBOX_DP4A
}

}  // namespace

// x (B, H, W, Cin) int8, w (Cout, k, k, Cin) int8, k in {1, 3}; scale and
// bias (Cout,) f32 for modes f32 and int8, out_scale (Cout,) f32 for mode
// int8; out (B, H, W, Cout) int32 (mode 0), f32 (mode 1) or int8 (mode 2).
// All contiguous on the current device; with Cin a multiple of 16, x, w and
// out 16-byte aligned. Launches on `stream`, does not synchronise; returns
// the CUDA error code (0 = launched). `info` (9 ints) receives what was
// chosen: the path (0 the CUDA cores, 1 mma.sync, 2 the warpgroup variant),
// the channel block, and for the tensor-core paths the channels per chunk,
// whether the weights are resident (mma.sync), the grid's x size, the
// dynamic shared memory in bytes and the depth of the (input) ring; for the
// warpgroup variant also the depth of the weights' ring and the output
// pixels a block.
extern "C" int densebox_qconv(const void* x, const void* w, const void* scale,
                              const void* bias, const void* out_scale,
                              void* out, int batch, int h, int wd, int cin,
                              int cout, int ksize, int relu, int mode,
                              void* stream, int* info) {
  if (info == nullptr || batch < 1 || h < 1 || wd < 1 || cin < 1 ||
      cout < 1 || (cout + 7) / 8 > 65535 || (ksize != 1 && ksize != 3) ||
      (long long)batch * ((h + kTH - 1) / kTH) * ((wd + kTW - 1) / kTW) >
          0x7fffffff ||
      mode < kModeInt32 || mode > kModeInt8 ||
      (mode != kModeInt32 && (scale == nullptr || bias == nullptr)) ||
      (mode == kModeInt8 && out_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 9; ++i) info[i] = 0;
  info[0] = path_of(cin, cout);
  info[1] = channel_block(cin, cout);
  if (info[0] != kPathDp4a &&
      ((uintptr_t)x % 16 || (uintptr_t)w % 16 || (uintptr_t)out % 16))
    return (int)cudaErrorMisalignedAddress;
  const auto* xs = (const int8_t*)x;
  const auto* ws = (const int8_t*)w;
  cudaStream_t s = (cudaStream_t)stream;
  if (ksize == 3)
    return dispatch<3>(xs, ws, (const float*)scale, (const float*)bias,
                       (const float*)out_scale, out, batch, h, wd, cin, cout,
                       relu, mode, s, info);
  return dispatch<1>(xs, ws, (const float*)scale, (const float*)bias,
                     (const float*)out_scale, out, batch, h, wd, cin, cout,
                     relu, mode, s, info);
}
