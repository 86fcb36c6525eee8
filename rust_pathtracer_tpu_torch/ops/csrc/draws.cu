// The bounce draws: one bounce's scatter uniforms for every lane, for NVIDIA
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: in the JAX package XLA runs threefry in
// sampling.bounce_draws (rust_pathtracer_tpu/sampling.py:212-230, the legacy
// scheme), hoisted for every bounce at once in the chunked renderer
// (integrator._precompute_draws) and at each lane's depth in the regen
// wavefront (wavefront.py:274-276).  On the H100 the same threefry in int64
// tensor ops took ~170 ms of the SphereField frame's ~207 ms of device time,
// so the port's generic and big-scene routes draw here, bounce by bounce,
// and the regen wavefront at each lane's own depth.  The plain PyTorch twin
// is sampling.bounce_draws (draws.bounce_draws_plain in ../draws.py).
//
// Per lane, from its key (k0, k1) and its bounce b (the launch's, or the
// lane's own path depth), the planes sampling.bounce_draws makes, bit for
// bit (threefry.cuh):
//   rows 0-1 sphere_u: the P_LAMBERT key's uniforms 0, 1;
//   rows 2-4 ball_u:   the P_FUZZ key's uniforms 0, 1, 2;
//   row 5    coin:     the P_SCHLICK key's uniform 0;
//   row 6    roulette: the P_ROULETTE key's uniform 0 (with roulette only).
//
// What bounds it on the card: operations.  A lane runs 10 threefry blocks
// (11 with roulette), ~79 int32 operations each, ~890 in all with the
// uniforms' bit work, against 12 bytes in (two key words, a depth) and 28
// out.  At the dispatch limit of 128 lanes a clock an SM (33.4e12 op/s; the
// compiler runs integer adds on the FMA pipe too, so the 64 INT32 units
// an SM are not the limit) and 3.35 TB/s, the integer work takes ~2.2x the
// memory time: 0.027 ms a 1M-lane launch, which measured 0.037 ms of device
// time (chip_smoke.py phase 20; NVIDIA H100 80GB HBM3, 700 W).  Design,
// simple and right first: one thread a lane, a grid of 16 blocks an SM with
// a grid stride, rows planar so that a warp's loads and stores are
// coalesced, no shared memory.  Every operation is an exact integer one
// (the uniform's last step, an f32 subtraction of 1 from a value in [1, 2),
// is exact too), so no build flag can change a bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 16;
constexpr int MAX_DEVICES = 64;
constexpr int N_ROWS = 6;  // rows without roulette's

__global__ void __launch_bounds__(THREADS)
bounce_draws_kernel(const uint32_t* __restrict__ k0s, const uint32_t* __restrict__ k1s,
                    const int* __restrict__ depth, uint32_t bounce, bool roulette,
                    float* __restrict__ out, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const uint32_t k0 = k0s[i], k1 = k1s[i];
    const uint32_t b = depth ? (uint32_t)depth[i] : bounce;
    uint32_t p0, p1;
    rpt::bounce_key(k0, k1, b, rpt::P_LAMBERT, p0, p1);
    out[0 * n + i] = rpt::uniform_at(p0, p1, 0u);
    out[1 * n + i] = rpt::uniform_at(p0, p1, 1u);
    rpt::bounce_key(k0, k1, b, rpt::P_FUZZ, p0, p1);
    out[2 * n + i] = rpt::uniform_at(p0, p1, 0u);
    out[3 * n + i] = rpt::uniform_at(p0, p1, 1u);
    out[4 * n + i] = rpt::uniform_at(p0, p1, 2u);
    rpt::bounce_key(k0, k1, b, rpt::P_SCHLICK, p0, p1);
    out[5 * n + i] = rpt::uniform_at(p0, p1, 0u);
    if (roulette) {
      rpt::bounce_key(k0, k1, b, rpt::P_ROULETTE, p0, p1);
      out[N_ROWS * n + i] = rpt::uniform_at(p0, p1, 0u);
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

// Launch the draws on `stream`.  Device pointers: `keys` the lane keys' two
// uint32 rows of n_lanes; `depth`, NULL for none, an int32 row of each
// lane's own bounce (else every lane draws at `bounce`); `out` (6, n_lanes)
// f32 rows, 7 with `roulette`, in the order above.  Returns
// cudaGetLastError() of the launch: nonzero means it never ran.
int bounce_draws_launch(const unsigned int* keys, const int* depth, unsigned int bounce,
                        int roulette, float* out, long long n_lanes, void* stream) {
  if (n_lanes < 0 || !keys || !out) return (int)cudaErrorInvalidValue;
  if (n_lanes == 0) return (int)cudaSuccess;
  const long long blocks = launch_blocks((n_lanes + THREADS - 1) / THREADS);
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bounce_draws_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
      keys, keys + n_lanes, depth, (uint32_t)bounce, roulette != 0, out, n_lanes);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
