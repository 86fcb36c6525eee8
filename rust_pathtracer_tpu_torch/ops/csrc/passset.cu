// The pass-set keys of the between-bounce reorder, for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel: in the JAX package XLA computes these keys in
// ops/projected.py:793-828 (passset_sort_keys), as ~15 (R, G) f32 planes of
// slab bounds and masks.  The plain PyTorch twin is
// projected.passset_sort_keys_plain (../projected.py); at 1M lanes and the
// 160 clusters of a 20k-triangle mesh its planes move ~10 GB a call, so the
// card computes the words here, one lane a thread, with nothing in between
// in memory.
//
// Per lane i, from its ray (o, d), its alive flag and the cluster AABBs
// (ProjTables.bounds8: per cluster the quads (min xyz, 0), (max xyz, 0)):
//   row 0:     the dead flag, 1 on a dead lane, else 0;
//   row 1 + w: bit g % 32 set where the lane is alive and its slab test
//              passes cluster g = 32 w + bit, for the clusters of word w;
//              all ones on a dead lane.
// The slab test is slab_bounds of ../projected.py (bvh.rs:18-35) in the
// same operations and order: the reciprocal of d with |d| < 1e-30 clamped to
// +-1e-30, then per axis (b - o) * inv_d at both faces, entry = max(t_min,
// the faces' minima), exit = min(T_MISS, their maxima) with NaN-propagating
// max / min (jnp.maximum / jnp.minimum; fmaxf / fminf would drop a NaN), and
// the lane passes where exit >= entry.  It is projected.cu's slab_pass8 at a
// running best of T_MISS.  With --fmad=false every operation rounds as the
// plain version's does, so the words agree bit for bit.
//
// What bounds it on the card: the operations.  A live lane runs 12 f32
// operations a cluster (per axis two subtractions and two products; the
// compares and selects of max / min counted as none), against 25 bytes in
// and 4 (1 + W) out a lane.  Design, simple and right first: one thread a
// lane, a grid of 16 blocks an SM with a grid stride, the bounds read
// through the read-only cache (every lane of a warp reads the same quad),
// rows planar so that a warp's loads and stores are coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 16;
constexpr int MAX_DEVICES = 64;
constexpr int WORD_BITS = 32;
constexpr float T_MISS = 1.0e30f;
constexpr float TINY = 1e-30f;

// jnp.maximum / jnp.minimum: NaN in, NaN out
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

__global__ void __launch_bounds__(THREADS)
passset_keys_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const bool* __restrict__ alive, const float4* __restrict__ bounds8,
                    int G, float t_min, uint32_t* __restrict__ out, long long n) {
  const int n_words = (G + WORD_BITS - 1) / WORD_BITS;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    if (!alive[i]) {
      out[i] = 1u;
      for (int w = 0; w < n_words; ++w) out[(long long)(1 + w) * n + i] = 0xFFFFFFFFu;
      continue;
    }
    out[i] = 0u;
    const float org[3] = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
    float inv_d[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const float x = d[3 * i + ax];
      const float ds = fabsf(x) < TINY ? (x < 0.0f ? -TINY : TINY) : x;
      inv_d[ax] = 1.0f / ds;
    }
    for (int w = 0; w < n_words; ++w) {
      uint32_t word = 0u;
      const int g_end = G < (w + 1) * WORD_BITS ? G : (w + 1) * WORD_BITS;
      for (int g = w * WORD_BITS; g < g_end; ++g) {
        const float4 lo4 = __ldg(bounds8 + 2 * g), hi4 = __ldg(bounds8 + 2 * g + 1);
        const float bl[3] = {lo4.x, lo4.y, lo4.z}, bh[3] = {hi4.x, hi4.y, hi4.z};
        float lo = t_min, hi = T_MISS;
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          const float b0 = (bl[ax] - org[ax]) * inv_d[ax];
          const float b1 = (bh[ax] - org[ax]) * inv_d[ax];
          lo = nan_max(lo, nan_min(b0, b1));
          hi = nan_min(hi, nan_max(b0, b1));
        }
        if (hi >= lo) word |= 1u << (g - w * WORD_BITS);
      }
      out[(long long)(1 + w) * n + i] = word;
    }
  }
}

// Blocks of a launch over `tiles` tiles on the current device: BLOCKS_PER_SM
// times its SMs (asked once a device), at most one a tile.  0 on an error.
long long launch_blocks(long long tiles) {
  static int sm_count[MAX_DEVICES];  // 0: not asked yet
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES) return 0;
  if (sm_count[dev] == 0 &&
      cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 0;
  }
  const long long cap = (long long)BLOCKS_PER_SM * sm_count[dev];
  return tiles < cap ? tiles : cap;
}

}  // namespace

extern "C" {

// Launch the keys on `stream`.  Device pointers: `o`, `d` the rays as (n, 3)
// f32; `alive` n bools; `bounds8` (G, 2) float4 quads; `out` (1 + W, n)
// uint32 rows, W = ceil(G / 32), in the order above.  Returns
// cudaGetLastError() of the launch: nonzero means it never ran.
int passset_keys_launch(const float* o, const float* d, const bool* alive,
                        const void* bounds8, int G, float t_min, unsigned int* out,
                        long long n_lanes, void* stream) {
  if (n_lanes < 0 || G < 0 || !o || !d || !alive || !out || (G > 0 && !bounds8)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_lanes == 0) return (int)cudaSuccess;
  const long long blocks = launch_blocks((n_lanes + THREADS - 1) / THREADS);
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  passset_keys_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
      o, d, alive, static_cast<const float4*>(bounds8), G, t_min, out, n_lanes);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
