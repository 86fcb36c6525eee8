// The CUDA features that ops/csrc/projected.cu uses, emulated on the host so
// that g++ can build the kernel source and run it on the CPU: one std::thread
// a CUDA thread, blocks of 128 run one after another, warp collectives
// (__ballot_sync, __shfl_sync, __shfl_xor_sync, __syncwarp) through
// std::barrier.  The test rewrites the source's launches to EMU_LAUNCH and
// its cp.async to a copy (tests/test_torch_projected_rows.py).
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
#define __align__(x) __attribute__((aligned(x)))
#define __restrict__
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct dim3v { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3v threadIdx, blockIdx;
inline dim3v blockDim{128, 1, 1};
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorMisalignedAddress = 74 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emu"; }
template <class T> T __ldg(const T* p) { return *p; }

struct Warp { std::barrier<>* bar; uint32_t slot[32]; };
inline Warp g_warps[4];
inline int lane_id() { return threadIdx.x & 31; }
template <class T> T xchg(T v, int src) {
  Warp& w = g_warps[threadIdx.x / 32];
  uint32_t u; std::memcpy(&u, &v, 4);
  w.slot[lane_id()] = u;
  w.bar->arrive_and_wait();
  uint32_t r = w.slot[src & 31];
  w.bar->arrive_and_wait();
  T out; std::memcpy(&out, &r, 4); return out;
}
template <class T> T __shfl_sync(unsigned, T v, int src) { return xchg(v, src); }
template <class T> T __shfl_xor_sync(unsigned, T v, int off) { return xchg(v, lane_id() ^ off); }
inline unsigned __ballot_sync(unsigned, int p) {
  Warp& w = g_warps[threadIdx.x / 32];
  w.slot[lane_id()] = p ? 1u : 0u;
  w.bar->arrive_and_wait();
  unsigned m = 0;
  for (int l = 0; l < 32; ++l) m |= w.slot[l] << l;
  w.bar->arrive_and_wait();
  return m;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(x); }
inline void __syncwarp() { g_warps[threadIdx.x / 32].bar->arrive_and_wait(); }
inline void emu_launch(long long blocks, std::function<void()> f) {
  for (long long b = 0; b < blocks; ++b) {
    std::barrier<> w0(32), w1(32), w2(32), w3(32);
    std::barrier<>* wb[4] = {&w0, &w1, &w2, &w3};
    for (int w = 0; w < 4; ++w) g_warps[w].bar = wb[w];
    std::vector<std::thread> th;
    for (unsigned t = 0; t < 128; ++t)
      th.emplace_back([&, t, b] { threadIdx.x = t; blockIdx.x = (unsigned)b; f(); });
    for (auto& x : th) x.join();
  }
}
#define EMU_LAUNCH(blocks, fn, ...) emu_launch(blocks, [&] { fn(__VA_ARGS__); })
