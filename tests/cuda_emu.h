// The CUDA features that the kernel sources of ops/csrc/ use, emulated on
// the host so that g++ can build a kernel source and run it on the CPU: one
// std::thread a CUDA thread, blocks of up to 256 threads run one after
// another, warp collectives (__ballot_sync, __match_any_sync, __shfl_sync,
// __shfl_xor_sync, __syncwarp), __syncthreads and __syncthreads_and through
// std::barrier, and integer atomicAdd and __threadfence through the
// compiler's atomic builtins.  The tests rewrite a source's
// launches to EMU_LAUNCH and its cp.async to a copy
// (tests/test_torch_projected_rows.py, tests/test_torch_fused_bounce_bwd.py,
// tests/test_torch_closest_hit_emu.py; tests/test_torch_fused_bounce_emu.py
// calls emu_launch itself and makes K1's dynamic shared table a static
// array).  The card's attributes are those of a
// small one: EMU_SMS multiprocessors, one resident block each.
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(x) __attribute__((aligned(x)))
#define __restrict__
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct dim3v { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3v threadIdx, blockIdx;
inline dim3v blockDim{128, 1, 1}, gridDim{1, 1, 1};
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorMisalignedAddress = 74 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emu"; }
constexpr int EMU_SMS = 2;
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = EMU_SMS;
  return cudaSuccess;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
template <class T> T __ldg(const T* p) { return *p; }

constexpr int EMU_MAX_WARPS = 8;
struct Warp { std::barrier<>* bar; uint64_t slot[32]; };
inline Warp g_warps[EMU_MAX_WARPS];
inline std::barrier<>* g_block_bar;
inline int lane_id() { return threadIdx.x & 31; }
template <class T> T xchg(T v, int src) {  // a 4- or 8-byte T
  static_assert(sizeof(T) <= 8, "a shuffle moves 4 or 8 bytes");
  Warp& w = g_warps[threadIdx.x / 32];
  uint64_t u = 0; std::memcpy(&u, &v, sizeof(T));
  w.slot[lane_id()] = u;
  w.bar->arrive_and_wait();
  uint64_t r = w.slot[src & 31];
  w.bar->arrive_and_wait();
  T out; std::memcpy(&out, &r, sizeof(T)); return out;
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
inline unsigned __match_any_sync(unsigned, int v) {
  Warp& w = g_warps[threadIdx.x / 32];
  w.slot[lane_id()] = (uint32_t)v;
  w.bar->arrive_and_wait();
  unsigned m = 0;
  for (int l = 0; l < 32; ++l) m |= (unsigned)(w.slot[l] == (uint32_t)v) << l;
  w.bar->arrive_and_wait();
  return m;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline void __threadfence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }
inline int __ffs(unsigned x) { return __builtin_ffs(x); }
inline void __syncwarp() { g_warps[threadIdx.x / 32].bar->arrive_and_wait(); }
inline void __syncthreads() { g_block_bar->arrive_and_wait(); }
// Nonzero where p is nonzero on every thread of the block; the third wait
// keeps a fast thread's next call from voting before the reset.
inline int g_vote_and = 1;
inline int __syncthreads_and(int p) {
  static std::mutex m;
  if (!p) { std::lock_guard<std::mutex> g(m); g_vote_and = 0; }
  g_block_bar->arrive_and_wait();
  const int r = g_vote_and;
  g_block_bar->arrive_and_wait();
  if (threadIdx.x == 0) g_vote_and = 1;
  g_block_bar->arrive_and_wait();
  return r;
}
// Runs `blocks` blocks of `threads` threads (a multiple of 32), one block at
// a time.  A barrier waits for every thread of its warp or block, so a
// kernel may return a thread early only where no later collective waits for
// it (both sources return whole warps only).
inline void emu_launch(long long blocks, unsigned threads, std::function<void()> f) {
  const int nw = (int)threads / 32;
  blockDim.x = threads;
  gridDim.x = (unsigned)blocks;
  for (long long b = 0; b < blocks; ++b) {
    std::vector<std::unique_ptr<std::barrier<>>> wb;
    for (int w = 0; w < nw; ++w) {
      wb.push_back(std::make_unique<std::barrier<>>(32));
      g_warps[w].bar = wb.back().get();
    }
    std::barrier<> block_bar((std::ptrdiff_t)threads);
    g_block_bar = &block_bar;
    std::vector<std::thread> th;
    for (unsigned t = 0; t < threads; ++t)
      th.emplace_back([&, t, b] { threadIdx.x = t; blockIdx.x = (unsigned)b; f(); });
    for (auto& x : th) x.join();
  }
}
#define EMU_LAUNCH(blocks, threads, fn, ...) \
  emu_launch(blocks, threads, [&] { fn(__VA_ARGS__); })
