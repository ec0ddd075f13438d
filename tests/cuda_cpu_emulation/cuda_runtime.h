// CPU stand-in for the parts of the CUDA runtime that csrc/kstep.cu uses, so that
// its kernel can be compiled with g++ and run on the CPU in tests: one std::thread
// per CUDA thread, thread blocks one after another, __syncthreads() as a barrier
// of the block, and __shared__ as a function-local static shared by the block.
// The kernel launch syntax is rewritten to emu_launch() by the test.
#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <thread>
#include <vector>

using std::isfinite;

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
};
inline thread_local dim3 threadIdx;
inline thread_local dim3 blockIdx;
inline dim3 blockDim;
inline std::barrier<>* emu_barrier = nullptr;
inline std::atomic<int> emu_or{0};

#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)

typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return cudaSuccess; }

inline void __syncthreads() { emu_barrier->arrive_and_wait(); }

inline int __syncthreads_or(int pred) {
  emu_barrier->arrive_and_wait();
  if (pred) emu_or.fetch_or(1);
  emu_barrier->arrive_and_wait();
  const int r = emu_or.load();
  emu_barrier->arrive_and_wait();
  if (threadIdx.x == 0) emu_or.store(0);
  return r;
}

template <class F>
inline void emu_launch(int grid, int block, F body) {
  blockDim.x = block;
  for (int b = 0; b < grid; ++b) {
    std::barrier<> bar(block);
    emu_barrier = &bar;
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([=] {
        threadIdx.x = t;
        blockIdx.x = b;
        body();
      });
    for (auto& th : threads) th.join();
  }
}
