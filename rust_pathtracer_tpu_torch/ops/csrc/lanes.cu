// The camera lanes: every lane's threefry key, pixel jitter and lens-disk
// draw, for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel: in the JAX package XLA fuses the lanes of a
// chunk into one pass (render._make_lanes, rust_pathtracer_tpu/render.py:
// 162-202) and the regen wavefront's refills the same way (spawn,
// wavefront.py:148-171).  In int64 tensor ops the same seven threefry
// blocks a lane took ~1,200 launches a call, 21.09 ms of the bench step's
// 27.97 ms forward on the H100, so the port's render.camera_lanes draws
// here, once a chunk and once a regen spawn.  The plain PyTorch twin is
// lanes.camera_lane_draws_plain in ../lanes.py (the sampling module's
// lane_keys, bounce_keys, uniform2 and in_unit_disk_xy).
//
// Per lane, from the base key (b0, b1), its pixel p and sample s, the
// image's width W and height H and the frame's spp_total S, bit for bit:
//   counter c   = (p * S + s) mod 2**32           (JAX: uint32 arithmetic)
//   lane key    = fold_in(base, c)                 rows 0-1, the key words
//   jitter      = uniforms 0, 1 of fold_in(lane key, 0 * 8 + P_PIXEL_JITTER)
//   s_vp        = (f32(p % W) + j0) / f32(W - 1)   row 2
//   t_vp        = (f32(H - 1 - p / W) + j1) / f32(H - 1)   row 3
//   lens        = uniforms 0, 1 of fold_in(lane key, 0 * 8 + P_LENS)
//   disk        = (r cos(theta), r sin(theta)), r = sqrt(l0),
//                 theta = f32(2 pi) * l1           rows 4-5
// That is seven threefry blocks a lane.  The camera's affine part stays in
// PyTorch (camera.camera_rays_from_disk), so that the camera parameters'
// gradients flow through autograd; these rows carry none, and need none.
//
// Numerics: built with --fmad=false and no fast math (ops/_build.py): the
// divisions are IEEE, sqrtf is correctly rounded (as vecmath.sqrt), and
// sinf / cosf are CUDA's, which PyTorch's CUDA sin / cos also use, so on
// the card the rows equal the plain twin's bit for bit.  The uniforms are
// exact integer work (threefry.cuh).  p and S are int64, as the port's
// pixel ids are; a lane with p and W below 2**32 divides in 32 bits.
//
// What bounds it on the card: operations.  A lane runs 7 threefry blocks,
// 7 x 79 = 553 int32 operations, plus 12 for the uniforms' bits and ~6
// for the counter and the pixel's column and row: ~571 against ~16 f32
// ones (two conversions, the jitter's two adds and two divisions, the four
// uniforms' subtractions, a square root, a product, a cosine, a sine and
// two products), against 16 bytes in (pixel, sample) and 24 out (two key
// words, four f32 rows).  At the dispatch limit of 128 int32 lanes a clock
// an SM (33.4e12 op/s) and 67e12 f32 op/s, the work takes ~0.017 ms for
// 1M lanes, against ~0.012 ms for the bytes at 3.35 TB/s.  The SASS
// (lanes_ab.py, cuobjdump) agrees: 1,224 instructions in all, the sine's
// and cosine's slow argument reduction and the 64-bit division among them,
// 756 of them IMAD, LOP3, SHF and IADD3, most of those the threefry
// rounds' adds, xors and rotations; 32 registers, no spills.  Measured: 0.028 ms of device time for 1M lanes,
// 1.6x the bound (chip_smoke.py phase 46; NVIDIA H100 80GB HBM3, 700 W).
// Design, simple and right first, as
// draws.cu: one thread a lane, a grid of 16 blocks an SM with a grid
// stride, rows planar so that a warp's loads and stores are coalesced, no
// shared memory; the base key is read from device memory, so the launch
// needs no sync.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 16;
constexpr int MAX_DEVICES = 64;
constexpr float TWO_PI = 6.2831855f;  // 2 * pi rounded to f32, as torch takes the scalar

__global__ void __launch_bounds__(THREADS)
camera_lanes_kernel(const long long* __restrict__ base, const long long* __restrict__ pixel,
                    const long long* __restrict__ sample, long long width, long long height,
                    long long spp_total, float w_div, float h_div,
                    uint32_t* __restrict__ keys, float* __restrict__ rows, long long n) {
  const uint32_t b0 = (uint32_t)base[0], b1 = (uint32_t)base[1];
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long p = pixel[i];
    const uint32_t c = (uint32_t)((unsigned long long)p * (unsigned long long)spp_total +
                                  (unsigned long long)sample[i]);
    uint32_t l0 = 0u, l1 = c;
    rpt::threefry2x32(b0, b1, l0, l1);  // the lane key: fold_in(base, c)
    keys[i] = l0;
    keys[n + i] = l1;

    long long col, row;
    if ((unsigned long long)p <= 0xFFFFFFFFull && (unsigned long long)width <= 0xFFFFFFFFull) {
      const uint32_t p32 = (uint32_t)p, w32 = (uint32_t)width;
      col = p32 % w32;
      row = p32 / w32;
    } else {
      col = p % width;
      row = p / width;
    }
    uint32_t k0, k1;
    rpt::bounce_key(l0, l1, 0u, rpt::P_PIXEL_JITTER, k0, k1);
    const float j0 = rpt::uniform_at(k0, k1, 0u), j1 = rpt::uniform_at(k0, k1, 1u);
    rows[i] = ((float)col + j0) / w_div;
    rows[n + i] = ((float)(height - 1 - row) + j1) / h_div;

    rpt::bounce_key(l0, l1, 0u, rpt::P_LENS, k0, k1);
    const float u0 = rpt::uniform_at(k0, k1, 0u), u1 = rpt::uniform_at(k0, k1, 1u);
    const float r = sqrtf(u0);
    const float theta = TWO_PI * u1;
    rows[2 * n + i] = r * cosf(theta);
    rows[3 * n + i] = r * sinf(theta);
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

// Launch the lanes on `stream`.  Device pointers: `base` the base key's two
// words as int64; `pixel`, `sample` int64 rows of n_lanes (pixel >= 0);
// `out` (6, n_lanes) 32-bit rows: the lane keys' two uint32 words, then
// s_vp, t_vp, disk_x and disk_y as f32.  Returns cudaGetLastError() of the
// launch: nonzero means it never ran.
int camera_lanes_launch(const long long* base, const long long* pixel,
                        const long long* sample, long long width, long long height,
                        long long spp_total, unsigned int* out, long long n_lanes,
                        void* stream) {
  if (n_lanes < 0 || width < 1 || height < 1) return (int)cudaErrorInvalidValue;
  if (n_lanes == 0) return (int)cudaSuccess;
  if (!base || !pixel || !sample || !out) return (int)cudaErrorInvalidValue;
  const long long blocks = launch_blocks((n_lanes + THREADS - 1) / THREADS);
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  // the divisors as the plain twin makes them: the f64 W - 1.0 rounded to f32
  const float w_div = (float)((double)width - 1.0), h_div = (float)((double)height - 1.0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  camera_lanes_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
      base, pixel, sample, width, height, spp_total, w_div, h_div, out,
      reinterpret_cast<float*>(out + 2 * n_lanes), n_lanes);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
