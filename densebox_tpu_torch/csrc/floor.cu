// Floors for the latency-bound kernels, sm_90a. Not kernels of any path:
// profile_port.py times them (replayed in a CUDA graph, as it times the
// kernels) to put beside the roofline bound of the kernels whose bytes and
// operations take under a microsecond:
//   - an empty kernel: what a launch of a given grid and block costs on the
//     card before it does any work;
//   - a chain of dependent block-wide rounds and nothing else: what one
//     count of csrc/ohem.cu's bisections costs, through the same reducer
//     (block_reduce.cuh) with the block the kernel takes.

#include <cuda_runtime.h>

#include "block_reduce.cuh"

namespace {

__global__ void empty_kernel() {}

template <int THREADS>
__global__ void __launch_bounds__(THREADS)
round_chain_kernel(int rounds, int* __restrict__ out) {
  using Red = BlockReducer<THREADS>;
  __shared__ __align__(16) unsigned buf[Red::kWords];
  Red red{buf, 0};
  for (int i = threadIdx.x; i < Red::kWords; i += THREADS) buf[i] = 0u;
  __syncthreads();
  int a = threadIdx.x & 1;
  for (int r = 0; r < rounds; ++r)
    a = (red.sum(a) >> 4) & 1;  // the next round waits for this one's total
  if (threadIdx.x == 0) out[blockIdx.x] = a;
}

}  // namespace

// Launches grid (grid_x, grid_y) of `block` threads on `stream`; returns the
// CUDA error code (0 = launched).
extern "C" int densebox_empty_launch(int grid_x, int grid_y, int block,
                                     void* stream) {
  if (grid_x < 1 || grid_y < 1 || block < 1 || block > 1024)
    return (int)cudaErrorInvalidValue;
  empty_kernel<<<dim3(grid_x, grid_y), block, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// `rounds` dependent block-wide rounds in `batch` blocks of `threads` (128,
// 256 or 512) threads; out (batch,) int32 scratch. Returns the CUDA error
// code (0 = launched).
extern "C" int densebox_round_chain(void* out, int batch, int threads,
                                    int rounds, void* stream) {
  if (batch < 1 || rounds < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int* o = (int*)out;
  if (threads == 128)
    round_chain_kernel<128><<<batch, 128, 0, st>>>(rounds, o);
  else if (threads == 256)
    round_chain_kernel<256><<<batch, 256, 0, st>>>(rounds, o);
  else if (threads == 512)
    round_chain_kernel<512><<<batch, 512, 0, st>>>(rounds, o);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
