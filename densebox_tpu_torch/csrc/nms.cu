// Greedy-NMS keep mask for a batch of score-sorted candidate sets, sm_90a.
//
// Replaces densebox_tpu/ops/pallas/nms.py:_nms_kernel (the Pallas kernel
// behind greedy_keep_pallas / nms_pallas). Same contract as its plain
// PyTorch version, densebox_tpu_torch/ops/kernels/nms.py:
// greedy_keep_reference: for boxes (B, K, 4) xyxy f32 sorted by score
// descending and valid (B, K), keep starts as valid and, for i ascending,
// a kept i suppresses every j > i with IoU(i, j) > thresh.
//
// What bounds it on the card: latency, not work. An image is K*18 bytes in
// and out and K(K-1)/2 IoU tests (16 f32 operations each, about 35 issued
// instructions with the IEEE division), a few microseconds of the card's
// issue rate; but the greedy order is sequential. The Pallas design kept a
// 4 MB f32 (K, K) IoU matrix in VMEM and walked all K rows; a Hopper SM
// holds neither the matrix nor the time for K dependent steps. This design
// is a single launch, keeps the IoU bits in shared memory, and its
// sequential chain is the depth of suppression within 64-box tiles:
//   1. One cluster of `cluster` CTAs (1, 2, 4 or 8) per image, of 1024
//      threads where the grid fits the card once and of 512 (two CTAs an
//      SM) where it does not; the wrapper chooses both
//      (ops/kernels/nms.py:launch_shape). Every CTA stages the image's
//      boxes, areas and valid bits in its shared memory. The in-edges of
//      box j (the boxes i < j whose IoU with it is above the threshold)
//      belong to CTA j % cluster and, there, to warp (j / cluster) % warps;
//      invalid boxes are skipped (never candidates, their words are never
//      read). A warp builds one 64-bit word of them at a time, over one
//      tile of 64 boxes: each lane tests two and two ballots make the word,
//      which lane 0 stores straight into CTA 0's shared memory (distributed
//      shared memory; word e of box j at e * K + j). In box j's own tile
//      only i < j is tested, and its upper half not at all while
//      j <= 64e + 32.
//   2. Once the cluster's stores are visible, the other CTAs exit and warp
//      0 of CTA 0 resolves tile w = boxes 64w..64w+63 in order, two boxes a
//      lane. A box is a candidate if valid and no kept box of an earlier
//      tile suppresses it (its words e < w AND-ed with tile e's kept bits;
//      one ballot). Then a fixed point over the tile's own words: in each
//      round a candidate that a kept box suppresses is removed, and one
//      that no kept box and no candidate suppresses is kept (two ballots).
//      The lowest candidate is always decided, so the rounds are at most
//      the longest chain of suppressions in the tile: one where no two
//      boxes overlap, two where one box suppresses all the others. Removed
//      and invalid boxes cost nothing.
//   3. The block writes the keep bytes from the tiles' kept words.
// Shared memory is K * ceil(K/64) * 8 bytes of words (32 KB at K = 512,
// 128 KB at K = 1024) plus 20 bytes a box; the dynamic-memory attribute is
// set once per device (densebox_nms_setup), so a call is one launch and no
// other host call, and a CUDA graph can hold it.
//
// The IoU is computed with the operations, order and f32 rounding of
// densebox_tpu/ops/nms.py:iou_matrix (areas and intersection clamped at 0,
// inter / max(area_i + area_j - inter, 1e-9)), through the _rn intrinsics so
// that no FMA contraction can move a box pair across the threshold (the
// build passes -fmad=false as well): keep masks equal the plain version's
// bit for bit. The schedule of steps 1 and 2 is modelled in numpy by
// tests/test_torch_nms_schedule.py; change the two together.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;

constexpr int kMaxK = 1024;     // the wrapper refuses larger K
constexpr int kMaxWords = kMaxK / 64;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr size_t edges_offset(int k) {
  return ((size_t)k * 20 + 7) / 8 * 8;  // after k float4 boxes and k areas
}

__host__ __device__ constexpr size_t smem_bytes(int k, int words) {
  return edges_offset(k) + (size_t)k * words * sizeof(u64);
}

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
  // No overlap gives +0 (or -0), whatever the union: the division is made
  // with a numerator of 1 instead, since a zero one sends the IEEE
  // division down its slow path.
  const bool none = inter == 0.0f;
  const float q = __fdiv_rn(none ? 1.0f : inter, fmaxf(uni, 1e-9f));
  return none ? 0.0f : q;
}

__device__ __forceinline__ u64 ballot64(bool lo, bool hi) {
  return (u64)__ballot_sync(kFull, hi) << 32 | __ballot_sync(kFull, lo);
}

// Cluster barriers. Before any word is stored into CTA 0, only that every
// CTA has started is needed (relaxed); before CTA 0 reads them, the other
// CTAs' stores must be visible (release, acquire).
__device__ __forceinline__ void cluster_started() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n"
               "barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_stored() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// kThreads 1024 (one CTA an SM) where the grid fits the card once, else 512
// (two an SM): ops/kernels/nms.py:launch_shape
template <int kThreads>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
nms_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
           int k, int words, float thresh, uint8_t* __restrict__ keep) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned valid32[2 * kMaxWords];  // bit j % 32 of word j / 32
  __shared__ u64 kept_words[kMaxWords];
  float4* box = reinterpret_cast<float4*>(smem);
  float* box_area = reinterpret_cast<float*>(box + k);
  // edges[e * k + j]: bit r set iff box 64e + r, before j, suppresses j
  u64* edges = reinterpret_cast<u64*>(smem + edges_offset(k));

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int b = blockIdx.y;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;

  for (int j = t; j < k; j += kThreads) {
    const float4 v = boxes[(size_t)b * k + j];
    box[j] = v;
    box_area[j] = area(v);
  }
  for (int j = t; j < 64 * words; j += kThreads) {  // past k: invalid
    const unsigned bits = __ballot_sync(
        kFull, j < k && valid[(size_t)b * k + j] != 0);
    if (lane == 0) valid32[j >> 5] = bits;
  }
  cluster_started();  // CTA 0's shared memory exists

  constexpr int kWarps = kThreads / 32;
  u64* dst = cluster.map_shared_rank(edges, 0);
  for (int j = warp * csize + rank; j < k; j += kWarps * csize) {
    if (!((valid32[j >> 5] >> (j & 31)) & 1u)) continue;  // never a candidate
    const float4 bj = box[j];
    const float aj = box_area[j];
    const int own = j >> 6;
#pragma unroll 2
    for (int e = 0; e < own; ++e) {  // tiles wholly before box j
      const int i = 64 * e + lane;
      const unsigned lo = __ballot_sync(
          kFull, iou(bj, aj, box[i], box_area[i]) > thresh);
      const unsigned hi = __ballot_sync(
          kFull, iou(bj, aj, box[i + 32], box_area[i + 32]) > thresh);
      if (lane == 0) dst[(size_t)e * k + j] = (u64)hi << 32 | lo;
    }
    const int i = 64 * own + lane;  // its own tile: the boxes before it
    const unsigned lo = __ballot_sync(
        kFull, i < j && iou(bj, aj, box[i], box_area[i]) > thresh);
    unsigned hi = 0u;
    if (64 * own + 32 < j)
      hi = __ballot_sync(kFull, i + 32 < j && iou(bj, aj, box[i + 32],
                                                   box_area[i + 32]) > thresh);
    if (lane == 0) dst[(size_t)own * k + j] = (u64)hi << 32 | lo;
  }
  cluster_stored();  // every word is in CTA 0
  if (rank != 0) return;

  if (warp == 0) {
    for (int w = 0; w < words; ++w) {
      // lane l decides boxes 64w + l (a) and 64w + 32 + l (b); past k
      // they read box k - 1's words and are never candidates
      const int ja = min(64 * w + lane, k - 1);
      const int jb = min(64 * w + 32 + lane, k - 1);
      u64 hit_a = 0ull, hit_b = 0ull;  // by kept boxes of earlier tiles
#pragma unroll 4
      for (int e = 0; e < w; ++e) {
        const u64 kept_e = kept_words[e];
        hit_a |= edges[(size_t)e * k + ja] & kept_e;
        hit_b |= edges[(size_t)e * k + jb] & kept_e;
      }
      const unsigned va = (valid32[2 * w] >> lane) & 1u;
      const unsigned vb = (valid32[2 * w + 1] >> lane) & 1u;
      u64 undecided = ballot64(va && !hit_a, vb && !hit_b);
      const u64 own_a = edges[(size_t)w * k + ja];
      const u64 own_b = edges[(size_t)w * k + jb];
      u64 kept = 0ull;
      while (undecided) {
        const bool ua = (undecided >> lane) & 1ull;
        const bool ub = (undecided >> (lane + 32)) & 1ull;
        const u64 open = kept | undecided;
        const u64 gone = ballot64(ua && (own_a & kept), ub && (own_b & kept));
        const u64 stays = ballot64(ua && !(own_a & open),
                                   ub && !(own_b & open));
        kept |= stays;
        undecided &= ~(gone | stays);
      }
      if (lane == 0) kept_words[w] = kept;
      __syncwarp();
    }
  }
  __syncthreads();
  for (int j = t; j < k; j += kThreads)
    keep[(size_t)b * k + j] = (uint8_t)((kept_words[j >> 6] >> (j & 63)) & 1ull);
}

}  // namespace

// Raises the kernel's dynamic shared-memory limit to what K = 1024 needs, on
// the current device. Call once per device before the first launch there.
extern "C" int densebox_nms_setup() {
  const int bytes = (int)smem_bytes(kMaxK, kMaxWords);
  cudaError_t err = cudaFuncSetAttribute(
      nms_kernel<512>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(
      nms_kernel<1024>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// boxes (B, K, 4) f32, valid (B, K) u8, keep (B, K) u8 out; all contiguous
// on the current device, boxes 16-byte aligned; cluster 1, 2, 4 or 8 CTAs
// per image of threads 512 or 1024. One launch on `stream`, no
// synchronisation; returns the CUDA error code (0 = launched).
extern "C" int densebox_nms_keep(const void* boxes, const void* valid,
                                 void* keep, int batch, int k, int cluster,
                                 int threads, float thresh, void* stream) {
  if (batch < 1 || batch > 65535 || k < 1 || k > kMaxK ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      (threads != 512 && threads != 1024))
    return (int)cudaErrorInvalidValue;
  const int words = (k + 63) / 64;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, batch, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes(k, words);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, threads == 1024 ? nms_kernel<1024> : nms_kernel<512>,
      (const float4*)boxes, (const uint8_t*)valid, k, words, thresh,
      (uint8_t*)keep);
  if (err != cudaSuccess) cudaGetLastError();  // clear it: the caller raises
  return (int)err;
}
