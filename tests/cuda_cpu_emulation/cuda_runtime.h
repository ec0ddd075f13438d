// CPU stand-in for the parts of the CUDA runtime that csrc/kstep.cu,
// csrc/step.cu and the plume's models/csrc/plume.cu use, so that their kernels can be compiled with g++ and run on
// the CPU in tests: one std::thread per CUDA thread, thread blocks one after
// another, __syncthreads() as a barrier of the block, warp shuffles through a
// per-warp exchange buffer between two barriers of the warp's 32 threads, and
// __shared__ as a function-local static shared by the block. The kernel launch
// syntax is rewritten to emu_launch() by the test, which may also follow each
// __shared__ declaration with emu_poison().
#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstring>
#include <memory>
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

// one warp's shuffle exchange: each lane posts its value's bytes, the warp
// meets, each lane reads its partner's, the warp meets again before the buffer
// is reused
struct EmuWarp {
  std::barrier<> bar{32};
  alignas(8) unsigned char val[32][8];
};
inline std::vector<std::unique_ptr<EmuWarp>> emu_warps;

#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)

typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return cudaSuccess; }

// no SM to ask: one block at a time
template <class F>
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 1;
  return cudaSuccess;
}

// block barriers crossed by thread 0 (__syncthreads_or not counted), read by tests
inline long emu_barrier_count = 0;
extern "C" long emu_barriers() { return emu_barrier_count; }

inline void __syncthreads() {
  if (threadIdx.x == 0) ++emu_barrier_count;
  emu_barrier->arrive_and_wait();
}

inline int __syncthreads_or(int pred) {
  emu_barrier->arrive_and_wait();
  if (pred) emu_or.fetch_or(1);
  emu_barrier->arrive_and_wait();
  const int r = emu_or.load();
  emu_barrier->arrive_and_wait();
  if (threadIdx.x == 0) emu_or.store(0);
  return r;
}

// Fill a __shared__ variable with NaN as its block starts: on the card a
// block's shared memory holds what some earlier block left, so a read of an
// entry that no thread of the block wrote reads NaN here. Thread 0 fills it
// and the block meets before any thread goes on (a barrier emu_barriers does
// not count).
template <class T>
inline void emu_poison(T& v) {
  if (threadIdx.x == 0) std::memset(&v, 0xff, sizeof v);
  emu_barrier->arrive_and_wait();
}

// every lane of the warp must call them, as on the card with a full mask
template <class T>
inline T emu_shuffle(T v, unsigned src) {
  static_assert(sizeof(T) <= 8);
  EmuWarp& w = *emu_warps[threadIdx.x / 32];
  std::memcpy(w.val[threadIdx.x % 32], &v, sizeof(T));
  w.bar.arrive_and_wait();
  T r;
  std::memcpy(&r, w.val[src % 32], sizeof(T));
  w.bar.arrive_and_wait();
  return r;
}

template <class T>
inline T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  return emu_shuffle(v, (threadIdx.x % 32) ^ lane_mask);
}

template <class T>
inline T __shfl_sync(unsigned, T v, int src_lane) {
  return emu_shuffle(v, src_lane);
}

template <class F>
inline void emu_launch(int grid, int block, F body) {
  blockDim.x = block;
  emu_warps.clear();
  for (int i = 0; i < block / 32; ++i) emu_warps.push_back(std::make_unique<EmuWarp>());
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
