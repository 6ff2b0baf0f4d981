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
// What bounds them on the card: the launch and the stores. At the training
// shape (B=32, K=16, M=60, L=5) the box kernel reads 16 KB and writes 2.8 MB
// (six floats a pixel), the landmark kernel writes 2.3 MB: under a
// microsecond of HBM time each, while an empty launch of their grids takes
// 1.4 to 1.6 us and a kernel that only stores the box maps 2.3 us. What is
// left to design is the work between the launch and the stores, and one
// launch for both maps when a step wants both. The TPU kernels' mechanics (a
// grid step per patch over whole (M, M) VMEM registers, the static unroll
// over K, a dense test of every pixel against every landmark) have no
// counterpart:
//   - boxes: a pixel a thread, a block a tile of 32 x 8 pixels (a warp
//     stores 128 contiguous bytes of score and of ignore and 512 of loc). At
//     staging the block keeps only the rows that can touch its tile (rc2 >= 0
//     or rg2 >= 0, and the larger disc reaching the tile by a test that errs
//     on the wide side), in index order (a ballot and a prefix count), so
//     the strict `<` still gives the lowest index among equals. A thread
//     walks the kept rows four a step: the loads and distances of a step do
//     not wait for each other, only the selects of the running minimum and
//     its row's index do. Timed and dropped (PERF.md): two and four pixels a
//     thread with 8- and 16-byte stores, several pixels a thread one after
//     the other, rows passed by warp shuffles in place of shared memory, and
//     a pixel's rows split over two or four threads; each was slower;
//   - landmarks: scatter, not search. A block owns a contiguous chunk of a
//     patch's (M, M, L) output and zeroes it in shared memory; its threads
//     list the rows with r2 >= 0 whose disc can reach the chunk, with the
//     box of pixels around the disc (at least one pixel wider than sqrt(r2)
//     on every side, clipped to the map and to the chunk's rows); then a
//     warp for each listed row tests only those pixels with the same
//     predicate and writes 1.0 where it holds (several rows writing the same
//     1.0 is benign: the union needs no order). The chunk then leaves in
//     16-byte stores, neighbouring threads to neighbouring addresses. The
//     work falls from B*M*M*L*K tests to a few for each visible landmark;
//   - outputs are written straight in the NHWC layout the loss reads (loc as
//     16-byte stores, landmark channels innermost), so no transpose follows.
// Float operations are rounded one by one (_rn intrinsics, and the file is
// built with -fmad=false), as the plain versions and JAX without jit round
// them: one ulp of d2 would flip a pixel on a disc's rim. Which pixels are
// tested at all is decided with a margin of a whole pixel, and by no float
// arithmetic where a centre or radius is 2^20 or more (or NaN): then every
// pixel is tested.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 1024;
// floats of landmark output one block builds in shared memory: 24 KB, which
// with 24 KB of rows to scatter (kMaxRows * 24 bytes) is the 48 KB a block
// may take without opting in to more
constexpr int kMaxChunk = 6140;
constexpr float kExactBelow = 1048576.f;  // 2^20

__device__ __forceinline__ float dist2(float px, float py, float cx,
                                       float cy) {
  const float dx = __fsub_rn(px, cx);
  const float dy = __fsub_rn(py, cy);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// The integers of [lo_lim, hi_lim] within rad + 1 of c, as [*lo, *hi];
// false if there is none. Below 2^20 a float sum is off by at most 1/8, so
// the margin of 1 covers it and the rounding of the predicate; from there
// on (and for NaN) the whole range is given.
__device__ __forceinline__ bool reach(float c, float rad, int lo_lim,
                                      int hi_lim, int* lo, int* hi) {
  if (!(fabsf(c) < kExactBelow && rad < kExactBelow)) {
    *lo = lo_lim;
    *hi = hi_lim;
    return lo_lim <= hi_lim;
  }
  const float a = fmaxf(floorf(c - rad) - 1.f, (float)lo_lim);
  const float b = fminf(ceilf(c + rad) + 1.f, (float)hi_lim);
  if (!(a <= b)) return false;
  *lo = (int)a;
  *hi = (int)b;
  return true;
}

// A box row's turn at one pixel, in index order: d2 is the pixel's squared
// distance from the row's centre, a = [cx, cy, rc2, rg2].
__device__ __forceinline__ void visit(const float4& a, float d2, int i,
                                      float& best, int& best_i, bool& pos,
                                      bool& gray) {
  gray = gray || (d2 <= a.w);
  if (d2 <= a.z) {
    pos = true;
    if (d2 < best) {
      best = d2;
      best_i = i;
    }
  }
}

// One block's share of one patch's box maps: a tile of 32 x 8 pixels (a warp
// a tile row), tile block_x of the patch's tiles in row-major order. rows,
// score, loc, ignore point at the patch. srow: 2 * k float4 of shared
// memory; wcnt: kWarps ints.
__device__ __forceinline__ void boxes_block(
    const float* __restrict__ rows, float* __restrict__ score,
    float4* __restrict__ loc, float* __restrict__ ignore, int k, int m,
    float inv_norm, int block_x, float4* srow, int* wcnt) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_x = (m + 31) >> 5;
  const int tile_y = block_x / tiles_x;
  const int x0 = (block_x - tile_y * tiles_x) << 5, y0 = tile_y * kWarps;
  const float x_first = (float)x0, x_last = (float)min(x0 + 31, m - 1);
  const float y_first = (float)y0, y_last = (float)min(y0 + kWarps - 1, m - 1);

  // stage the rows that can touch this tile, in index order
  const float4* r4 = reinterpret_cast<const float4*>(rows);
  int n = 0;
  for (int base = 0; base < k; base += kThreads) {
    const int i = base + tid;
    float4 a = make_float4(0.f, 0.f, -1.f, -1.f), c = a;
    bool keep = false;
    if (i < k) {
      a = r4[2 * i];
      c = r4[2 * i + 1];
      const float reach2 = fmaxf(a.z, a.w);
      keep = reach2 >= 0.f;
      if (keep) {
        // the larger disc against the tile, a pixel wider on every side;
        // exact float sums below 2^20, everything kept from there on
        const float rad = sqrtf(reach2) + 1.f;
        if (fabsf(a.x) < kExactBelow && fabsf(a.y) < kExactBelow &&
            rad < kExactBelow)
          keep = a.x + rad >= x_first && a.x - rad <= x_last &&
                 a.y + rad >= y_first && a.y - rad <= y_last;
      }
    }
    const unsigned bal = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) wcnt[warp] = __popc(bal);
    __syncthreads();
    int before = 0, all = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int cnt = wcnt[w];
      if (w < warp) before += cnt;
      all += cnt;
    }
    if (keep) {
      const int o = n + before + __popc(bal & ((1u << lane) - 1u));
      srow[2 * o] = a;
      srow[2 * o + 1] = c;
    }
    n += all;
    __syncthreads();
  }

  const int x = x0 + lane, y = y0 + warp;
  if (x >= m || y >= m) return;
  const int pix = y * m + x;
  const float px = (float)x, py = (float)y;
  float best = INFINITY;
  int best_i = -1;
  bool pos = false, gray = false;
  // four rows a step: their loads and distances do not wait for each other,
  // only the short chain of selects does
  int i = 0;
  for (; i + 4 <= n; i += 4) {
    float4 a[4];
    float d2[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) a[u] = srow[2 * (i + u)];
#pragma unroll
    for (int u = 0; u < 4; ++u) d2[u] = dist2(px, py, a[u].x, a[u].y);
#pragma unroll
    for (int u = 0; u < 4; ++u) visit(a[u], d2[u], i + u, best, best_i, pos, gray);
  }
  for (; i < n; ++i) {
    const float4 a = srow[2 * i];
    visit(a, dist2(px, py, a.x, a.y), i, best, best_i, pos, gray);
  }
  const float posf = pos ? 1.f : 0.f;
  score[pix] = posf;
  ignore[pix] = (gray && !pos) ? 1.f : 0.f;
  const float4 box = best_i >= 0 ? srow[2 * best_i + 1]
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 t;
  t.x = __fmul_rn(__fmul_rn(__fsub_rn(px, box.x), inv_norm), posf);
  t.y = __fmul_rn(__fmul_rn(__fsub_rn(py, box.y), inv_norm), posf);
  t.z = __fmul_rn(__fmul_rn(__fsub_rn(box.z, px), inv_norm), posf);
  t.w = __fmul_rn(__fmul_rn(__fsub_rn(box.w, py), inv_norm), posf);
  loc[pix] = t;
}

// A row of the landmark map that can touch the block's chunk: its disc and
// the box of pixels to test (x_lo | width << 16, y_lo | height << 16).
struct LiveRow {
  float lx, ly, r2;
  int l;
  unsigned xw, yh;
};

// One block's share of one patch's landmark map: floats chunk_i * chunk ..
// + chunk - 1 of its (M, M, L) output. rows and lm point at the patch. tile:
// chunk floats of shared memory; live: n_rows LiveRow; n_live: one int.
__device__ __forceinline__ void landmarks_block(
    const float* __restrict__ rows, float* __restrict__ lm, int n_rows,
    int num_lm, int m, int chunk, int chunk_i, bool vec, float* tile,
    LiveRow* live, int* n_live) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = m * m * num_lm;
  const int start = chunk_i * chunk;
  const int len = min(chunk, per - start);
  const int row_len = m * num_lm;
  const int y_first = start / row_len;
  const int y_last = (start + len - 1) / row_len;
  // this thread's first row, asked for before the tile is zeroed
  float lx = 0.f, ly = 0.f, r2 = -1.f;
  if (tid < n_rows) {
    lx = rows[tid * 3];
    ly = rows[tid * 3 + 1];
    r2 = rows[tid * 3 + 2];
  }
  if (tid == 0) *n_live = 0;
  if (vec) {  // per % 4 == 0 and chunk % 4 == 0, so len % 4 == 0
    float4* t4 = reinterpret_cast<float4*>(tile);
    for (int i = tid; i < (len >> 2); i += kThreads)
      t4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int i = tid; i < len; i += kThreads) tile[i] = 0.f;
  }
  __syncthreads();
  // the rows whose disc can reach the chunk, in any order (the union of the
  // discs needs none)
  for (int r = tid; r < n_rows; r += kThreads) {
    if (r != tid) {
      lx = rows[r * 3];
      ly = rows[r * 3 + 1];
      r2 = rows[r * 3 + 2];
    }
    if (!(r2 >= 0.f)) continue;
    const float rad = sqrtf(r2);
    int x_lo, x_hi, y_lo, y_hi;
    if (!reach(ly, rad, y_first, y_last, &y_lo, &y_hi) ||
        !reach(lx, rad, 0, m - 1, &x_lo, &x_hi))
      continue;
    live[atomicAdd(n_live, 1)] =
        LiveRow{lx, ly, r2, r % num_lm,
                (unsigned)x_lo | ((unsigned)(x_hi - x_lo + 1) << 16),
                (unsigned)y_lo | ((unsigned)(y_hi - y_lo + 1) << 16)};
  }
  __syncthreads();
  const int n = *n_live;
  for (int r = warp; r < n; r += kWarps) {
    const LiveRow v = live[r];
    const int x_lo = v.xw & 0xffffu, w = v.xw >> 16;
    const int y_lo = v.yh & 0xffffu, count = w * (int)(v.yh >> 16);
    for (int i = lane; i < count; i += 32) {
      const int iy = i / w;
      const int x = x_lo + (i - iy * w), y = y_lo + iy;
      if (dist2((float)x, (float)y, v.lx, v.ly) <= v.r2) {
        const int o = (y * m + x) * num_lm + v.l - start;
        if ((unsigned)o < (unsigned)len) tile[o] = 1.f;
      }
    }
  }
  __syncthreads();
  float* out = lm + start;
  if (vec) {
    const float4* t4 = reinterpret_cast<const float4*>(tile);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int i = tid; i < (len >> 2); i += kThreads) o4[i] = t4[i];
  } else {
    for (int i = tid; i < len; i += kThreads) out[i] = tile[i];
  }
}

struct BoxArgs {
  const float* rows;
  float* score;
  float4* loc;
  float* ignore;
  int k, m, blocks;
  float inv_norm;
};

struct LmArgs {
  const float* rows;
  float* lm;
  int n_rows, num_lm, m, chunk, chunks;
  bool vec;
};

__device__ __forceinline__ void run_boxes(const BoxArgs& a, int block_x,
                                          int b, float4* smem) {
  const size_t pix = (size_t)b * a.m * a.m;
  boxes_block(a.rows + (size_t)b * a.k * 8, a.score + pix, a.loc + pix,
              a.ignore + pix, a.k, a.m, a.inv_norm, block_x, smem,
              reinterpret_cast<int*>(smem + 2 * a.k));
}

__device__ __forceinline__ void run_landmarks(const LmArgs& a, int chunk_i,
                                              int b, float4* smem) {
  float* tile = reinterpret_cast<float*>(smem);
  LiveRow* live = reinterpret_cast<LiveRow*>(tile + a.chunk);
  landmarks_block(a.rows + (size_t)b * a.n_rows * 3,
                  a.lm + (size_t)b * a.m * a.m * a.num_lm, a.n_rows, a.num_lm,
                  a.m, a.chunk, chunk_i, a.vec, tile, live,
                  reinterpret_cast<int*>(live + a.n_rows));
}

__global__ void __launch_bounds__(kThreads) boxes_kernel(BoxArgs a) {
  extern __shared__ float4 smem[];
  run_boxes(a, blockIdx.x, blockIdx.y, smem);
}

__global__ void __launch_bounds__(kThreads) landmarks_kernel(LmArgs a) {
  extern __shared__ float4 smem[];
  run_landmarks(a, blockIdx.x, blockIdx.y, smem);
}

// Both maps in one launch: blockIdx.z picks the map, and the blocks beyond
// a map's own count leave at once.
__global__ void __launch_bounds__(kThreads)
maps_kernel(BoxArgs a, LmArgs l) {
  extern __shared__ float4 smem[];
  if (blockIdx.z == 0) {
    if ((int)blockIdx.x < a.blocks) run_boxes(a, blockIdx.x, blockIdx.y, smem);
  } else {
    if ((int)blockIdx.x < l.chunks)
      run_landmarks(l, blockIdx.x, blockIdx.y, smem);
  }
}

bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

size_t box_smem(int k) {
  return (size_t)k * 2 * sizeof(float4) + kWarps * sizeof(int);
}

size_t lm_smem(int n_rows, int chunk) {
  return (size_t)chunk * sizeof(float) + (size_t)n_rows * sizeof(LiveRow) +
         sizeof(int);
}

bool box_args(BoxArgs* a, const void* rows, void* score, void* loc,
              void* ignore, int batch, int k, int m, float inv_norm) {
  if (batch < 1 || batch > 65535 || k < 1 || k > kMaxRows || m < 1 ||
      m > 4096 || !aligned16(loc) || !aligned16(rows))
    return false;
  *a = BoxArgs{(const float*)rows, (float*)score, (float4*)loc,
               (float*)ignore, k, m,
               ((m + 31) / 32) * ((m + kWarps - 1) / kWarps), inv_norm};
  return true;
}

bool lm_args(LmArgs* a, const void* rows, void* lm, int batch, int k,
             int num_lm, int m, int chunk) {
  if (batch < 1 || batch > 65535 || k < 1 || num_lm < 1 ||
      (long long)k * num_lm > kMaxRows || m < 1 || m > 4096 || chunk < 4 ||
      chunk > kMaxChunk || (chunk & 3) != 0)
    return false;
  const long long per = (long long)m * m * num_lm;
  if (per > INT_MAX - kMaxChunk) return false;
  *a = LmArgs{(const float*)rows, (float*)lm, k * num_lm, num_lm, m, chunk,
              (int)((per + chunk - 1) / chunk),
              (per & 3) == 0 && aligned16(lm)};
  return true;
}

}  // namespace

// rows (B, K, 8) float32 (16-byte aligned); score and ignore (B, M, M) and
// loc (B, M, M, 4) float32 (loc 16-byte aligned). All contiguous on the
// current device. Launches on `stream`, does not synchronise; returns the
// CUDA error code (0 = launched).
extern "C" int densebox_rasterize_boxes(const void* rows, void* score,
                                        void* loc, void* ignore, int batch,
                                        int k, int m, float inv_norm,
                                        void* stream) {
  BoxArgs a;
  if (!box_args(&a, rows, score, loc, ignore, batch, k, m, inv_norm))
    return (int)cudaErrorInvalidValue;
  boxes_kernel<<<dim3(a.blocks, batch), kThreads, box_smem(k),
                 (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// rows (B, K * L, 3) float32; lm (B, M, M, L) float32. `chunk`: the floats
// of a patch's output one block builds (a multiple of 4, at most 6140). As
// above.
extern "C" int densebox_rasterize_landmarks(const void* rows, void* lm,
                                            int batch, int k, int num_lm,
                                            int m, int chunk, void* stream) {
  LmArgs a;
  if (!lm_args(&a, rows, lm, batch, k, num_lm, m, chunk))
    return (int)cudaErrorInvalidValue;
  landmarks_kernel<<<dim3(a.chunks, batch), kThreads,
                     lm_smem(a.n_rows, chunk), (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Both of the above for one batch in one launch (the same B and M).
extern "C" int densebox_rasterize_maps(const void* rows, void* score,
                                       void* loc, void* ignore,
                                       const void* lm_rows, void* lm,
                                       int batch, int k, int num_lm, int m,
                                       float inv_norm, int chunk,
                                       void* stream) {
  BoxArgs a;
  LmArgs l;
  if (!box_args(&a, rows, score, loc, ignore, batch, k, m, inv_norm) ||
      !lm_args(&l, lm_rows, lm, batch, k, num_lm, m, chunk))
    return (int)cudaErrorInvalidValue;
  const size_t smem_a = box_smem(k), smem_l = lm_smem(l.n_rows, chunk);
  const dim3 grid(a.blocks > l.chunks ? a.blocks : l.chunks, batch, 2);
  maps_kernel<<<grid, kThreads, smem_a > smem_l ? smem_a : smem_l,
                (cudaStream_t)stream>>>(a, l);
  return (int)cudaGetLastError();
}
