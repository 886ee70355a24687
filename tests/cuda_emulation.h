// Runs a warp-synchronous CUDA kernel's source on the CPU, for the tests:
// one std::thread per CUDA thread of a block, the blocks one after
// another; __syncwarp() and __syncthreads() are barriers, __shared__
// variables are static (one block runs at a time). Enough for a kernel
// that keeps each warp's control flow uniform at every __syncwarp() and
// communicates through shared memory, as csrc/articulated_step.cu does.
#pragma once
#include <barrier>
#include <cmath>
#include <memory>
#include <thread>
#include <vector>

struct EmulatedIndex {
  unsigned x = 0;
};
inline thread_local EmulatedIndex threadIdx, blockIdx;
inline std::vector<std::unique_ptr<std::barrier<>>> emulated_warps;
inline std::unique_ptr<std::barrier<>> emulated_block;

#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(threads)

inline void __syncwarp(unsigned = 0xffffffffu) {
  emulated_warps[threadIdx.x / 32]->arrive_and_wait();
}
inline void __syncthreads() { emulated_block->arrive_and_wait(); }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }

// body() once per thread of each of `blocks` blocks of `threads` threads.
template <class Body>
void emulate_launch(int blocks, int threads, Body body) {
  for (int b = 0; b < blocks; ++b) {
    emulated_warps.clear();
    for (int w = 0; w < threads / 32; ++w)
      emulated_warps.emplace_back(new std::barrier<>(32));
    emulated_block.reset(new std::barrier<>(threads));
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([=] {
        threadIdx.x = t;
        blockIdx.x = b;
        body();
      });
    for (auto& t : pool) t.join();
  }
}
