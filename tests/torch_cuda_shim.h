// A CPU stand-in for the CUDA runtime, for tests/test_torch_csrc_shim.py:
// it compiles the port's kernels (aim_tpu_torch/csrc/*.cu) with g++ and runs
// them with one std::thread a GPU thread, so the CPU tests reach the CUDA
// sources, not only their plain PyTorch versions.
//
// A warp is 32 threads and a std::barrier; the warp collectives the
// kernels use (__syncwarp, __shfl_sync, __ballot_sync, __any_sync,
// __reduce_min/max_sync) meet at that barrier.  A thread that returns drops
// out of it (the kernels return apart only where no collective follows, as
// K1's walk on lane 0).  The test rewrites `extern __shared__` and the
// `<<<...>>>` launches textually; a launch runs its blocks a few at a time,
// each with its own dynamic shared memory, filled with 0xAB so a read of an
// unwritten byte shows.
#pragma once
#include <algorithm>
#include <barrier>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <type_traits>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __align__(x) alignas(x)

struct shim_dim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local shim_dim3 threadIdx, blockIdx, blockDim;

enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
typedef void *cudaStream_t;

// a block's dynamic shared memory on an H100: 227 KB
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int bytes) {
  return bytes <= 232448 ? cudaSuccess : cudaErrorInvalidValue;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char *cudaGetErrorString(cudaError_t) { return "cpu shim"; }

template <class A, class B>
inline auto min(A a, B b) -> std::common_type_t<A, B> {
  return a < b ? a : b;
}
template <class A, class B>
inline auto max(A a, B b) -> std::common_type_t<A, B> {
  return a < b ? b : a;
}
inline int __clz(int x) { return x == 0 ? 32 : __builtin_clz((unsigned)x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __ffsll(long long x) { return __builtin_ffsll(x); }

namespace shim {

struct Warp {
  std::barrier<> bar{32};
  uint64_t slot[32];
};
inline thread_local Warp *warp;
inline thread_local unsigned char *shared;
inline unsigned char *smem() { return shared; }
inline int lane() { return threadIdx.x & 31; }

template <class K, class P>
void launch(K kern, unsigned blocks, unsigned threads, size_t smem_bytes,
            const P &params) {
  const unsigned together = 2;  // blocks run at once
  for (unsigned b0 = 0; b0 < blocks; b0 += together) {
    std::vector<std::thread> ts;
    std::vector<std::unique_ptr<Warp>> warps;
    std::vector<std::vector<unsigned char>> mems;
    for (unsigned b = b0; b < std::min(blocks, b0 + together); ++b) {
      mems.emplace_back(smem_bytes + 16, 0xAB);
      unsigned char *m = mems.back().data();
      m += (16 - ((uintptr_t)m & 15)) & 15;
      const size_t w0 = warps.size();
      for (unsigned w = 0; w < threads / 32; ++w)
        warps.emplace_back(new Warp);
      for (unsigned t = 0; t < threads; ++t) {
        Warp *wp = warps[w0 + t / 32].get();
        ts.emplace_back([=, &params] {
          threadIdx.x = t;
          blockIdx.x = b;
          blockDim.x = threads;
          warp = wp;
          shared = m;
          kern(params);
          warp->bar.arrive_and_drop();
        });
      }
    }
    for (auto &t : ts) t.join();
  }
}

}  // namespace shim

inline void __syncwarp(unsigned = 0xffffffffu) {
  shim::warp->bar.arrive_and_wait();
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src) {
  uint64_t x = 0;
  std::memcpy(&x, &v, sizeof(T));
  shim::warp->slot[shim::lane()] = x;
  __syncwarp();
  const uint64_t y = shim::warp->slot[src & 31];
  __syncwarp();
  T r;
  std::memcpy(&r, &y, sizeof(T));
  return r;
}
inline unsigned __ballot_sync(unsigned, int pred) {
  shim::warp->slot[shim::lane()] = pred != 0;
  __syncwarp();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= (unsigned)shim::warp->slot[i] << i;
  __syncwarp();
  return r;
}
inline int __any_sync(unsigned mask, int pred) {
  return __ballot_sync(mask, pred) != 0;
}
template <class Op>
inline int shim_reduce(int v, Op op) {
  shim::warp->slot[shim::lane()] = (uint64_t)(int64_t)v;
  __syncwarp();
  int r = v;
  for (int i = 0; i < 32; ++i) r = op(r, (int)(int64_t)shim::warp->slot[i]);
  __syncwarp();
  return r;
}
inline int __reduce_min_sync(unsigned, int v) {
  return shim_reduce(v, [](int a, int b) { return a < b ? a : b; });
}
inline int __reduce_max_sync(unsigned, int v) {
  return shim_reduce(v, [](int a, int b) { return a < b ? b : a; });
}
