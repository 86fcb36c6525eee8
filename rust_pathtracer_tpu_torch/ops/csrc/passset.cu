// The pass-set keys of the between-bounce reorder, for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel: in the JAX package XLA computes these keys in
// ops/projected.py:793-828 (passset_sort_keys), as ~15 (R, G) f32 planes of
// slab bounds and masks.  The plain PyTorch twin is
// projected.passset_sort_keys_plain (../projected.py); at 1M lanes and the
// 160 clusters of a 20k-triangle mesh its planes move ~10 GB a call, so the
// card computes the words here with nothing in between in memory.
//
// Per lane i, from its ray (o, d), its alive flag and the cluster AABBs
// (ProjTables.bounds8: per cluster the quads (min xyz, 0), (max xyz, 0)):
//   row 0:     the dead flag, 1 on a dead lane, else 0;
//   row 1 + w: bit g % 32 set where the lane is alive and its slab test
//              passes cluster g = 32 w + bit, for the clusters of word w;
//              all ones on a dead lane.
// The slab test is slab_bounds of ../projected.py (bvh.rs:18-35): the
// reciprocal of d with |d| < 1e-30 clamped to +-1e-30, then per axis
// (b - o) * inv_d at both faces, entry = max(t_min, the faces' minima),
// exit = min(T_MISS, their maxima) with NaN-propagating max / min
// (jnp.maximum / jnp.minimum), and the lane passes where exit >= entry.
// With --fmad=false every subtraction and product rounds as the plain
// version's does.
//
// What bounds it on the card: the operations, 12 f32 a lane and cluster
// (per axis two subtractions and two products), against 25 bytes in and
// 4 (1 + W) out a lane; the compares and selects of max / min, the loads of
// the boxes and the packing of the bits are what the instructions add
// (~71 SASS instructions a lane and cluster in a loop of one lane a thread
// with two read-only loads a cluster).  The design cuts those to ~28:
//
// * One NaN test a lane.  The NaN-propagating max / min cost two NaN
//   tests, a compare and selects each, 12 a cluster.  On a lane whose o and
//   d are finite, and a box whose bounds are, no operand is ever NaN: inv_d
//   is finite and nonzero after the clamp, b - o is finite or overflows to
//   an infinity, and an infinity times a finite nonzero inv_d is one too.
//   So there fminf / fmaxf (one FMNMX each) give the same values (but
//   perhaps the sign of a zero, which hi >= lo does not see) in any order:
//   the same bit.  The lane's six inputs are tested once; the bounds once a
//   block, while they are staged (__syncthreads_and); a NaN t_min fails
//   both.  A live lane that fails takes exact_word, the NaN-propagating
//   test as the plain version runs it, for the words it writes.
// * The boxes read once a block, not twice a lane and cluster: a block
//   stages up to TILE_G clusters' quads in shared memory, and every thread
//   reads the same quad (a broadcast).
// * LANES lanes a thread, so that one read of a box serves both and their
//   tests interleave; STEP clusters a step, unrolled, so that a bit's
//   position is a constant, and a last step of fewer where G ends a word.
// * A dead lane reads only its flag (its words are all ones), and a thread
//   whose lanes are all dead tests nothing: the reorder sorts dead lanes
//   last, so on a frame's later bounces whole warps skip.
//
// The near and far faces are not picked from the sign of inv_d.  A pick is
// a select a face and cluster, as dear as the FMNMX it saves, unless the
// lanes a thread holds share their signs; a variant that sorted each
// tile's live lanes by octant for that ran 14% faster on 1M lanes of 160
// clusters but slower on 5 clusters, where the sort does not pay (PERF.md
// §6).  So the fast test keeps both faces, which also needs no ordered
// box: an inverted box gives the plain version's bit too.
//
// Rows are planar, so a warp's loads and stores are coalesced (lanes of a
// thread THREADS apart); the grid is BLOCKS_PER_SM blocks an SM with a grid
// stride over tiles of THREADS * LANES lanes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int LANES = 2;
constexpr int TILE_LANES = THREADS * LANES;
constexpr int TILE_G = 512;  // clusters staged at once: 16 KB of quads
constexpr int STEP = 8;
constexpr int BLOCKS_PER_SM = 8;
constexpr int MAX_DEVICES = 64;
constexpr int WORD_BITS = 32;
constexpr float T_MISS = 1.0e30f;
constexpr float TINY = 1e-30f;
constexpr float F32_MAX = 3.402823466e38f;

__device__ __forceinline__ bool finite_f32(float x) { return fabsf(x) <= F32_MAX; }

// jnp.maximum / jnp.minimum: NaN in, NaN out
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

// The slab test on NaN-free operands (see the note above).
__device__ __forceinline__ bool slab_fast(const float4& lo4, const float4& hi4,
                                          const float* org, const float* inv,
                                          float t_min) {
  const float x0 = (lo4.x - org[0]) * inv[0], x1 = (hi4.x - org[0]) * inv[0];
  const float y0 = (lo4.y - org[1]) * inv[1], y1 = (hi4.y - org[1]) * inv[1];
  const float z0 = (lo4.z - org[2]) * inv[2], z1 = (hi4.z - org[2]) * inv[2];
  const float lo = fmaxf(fmaxf(t_min, fminf(x0, x1)), fmaxf(fminf(y0, y1), fminf(z0, z1)));
  const float hi = fminf(fminf(T_MISS, fmaxf(x0, x1)), fminf(fmaxf(y0, y1), fmaxf(z0, z1)));
  return hi >= lo;
}

// The bits of the first nb of the staged clusters at `box` (quads lo, hi
// a cluster), by the plain version's test in its order.
__device__ uint32_t exact_word(const float4* box, int nb, const float* org,
                               const float* inv, float t_min) {
  uint32_t word = 0u;
#pragma unroll 1
  for (int b = 0; b < nb; ++b) {
    const float4 lo4 = box[2 * b], hi4 = box[2 * b + 1];
    const float bl[3] = {lo4.x, lo4.y, lo4.z}, bh[3] = {hi4.x, hi4.y, hi4.z};
    float lo = t_min, hi = T_MISS;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const float b0 = (bl[ax] - org[ax]) * inv[ax];
      const float b1 = (bh[ax] - org[ax]) * inv[ax];
      lo = nan_max(lo, nan_min(b0, b1));
      hi = nan_min(hi, nan_max(b0, b1));
    }
    if (hi >= lo) word |= 1u << b;
  }
  return word;
}

__global__ void __launch_bounds__(THREADS)
passset_keys_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const bool* __restrict__ alive, const float4* __restrict__ bounds8,
                    int G, float t_min, uint32_t* __restrict__ out, long long n) {
  __shared__ float4 box[2 * TILE_G];
  const long long tiles = (n + TILE_LANES - 1) / TILE_LANES;
  const bool t_ok = t_min == t_min;
  bool box_ok = true;  // the staged bounds are finite
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    long long idx[LANES];
    bool live[LANES], fast[LANES];
    float org[LANES][3], inv[LANES][3];
#pragma unroll
    for (int l = 0; l < LANES; ++l) {
      const long long i = tile * TILE_LANES + l * THREADS + threadIdx.x;
      const bool in = i < n;
      idx[l] = i;
      live[l] = in && alive[i];
      bool fin = true;
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        const float x = live[l] ? o[3 * i + ax] : 0.0f;
        const float y = live[l] ? d[3 * i + ax] : 1.0f;
        const float ds = fabsf(y) < TINY ? (y < 0.0f ? -TINY : TINY) : y;
        org[l][ax] = x;
        inv[l][ax] = 1.0f / ds;
        fin = fin && finite_f32(x) && finite_f32(y);
      }
      fast[l] = fin && t_ok;
      if (in) out[i] = live[l] ? 0u : 1u;
    }
    bool any = false;  // a live lane: else only the dead flags and all-ones words
#pragma unroll
    for (int l = 0; l < LANES; ++l) any = any || live[l];
    for (int c0 = 0; c0 < G; c0 += TILE_G) {
      const int gc = G - c0 < TILE_G ? G - c0 : TILE_G;
      if (G > TILE_G || tile == blockIdx.x) {  // stage; a uniform branch
        __syncthreads();  // every read of the previous tile is done
        bool ok = true;
        for (int j = threadIdx.x; j < gc; j += THREADS) {
          const float4 lo4 = __ldg(bounds8 + 2 * (c0 + j));
          const float4 hi4 = __ldg(bounds8 + 2 * (c0 + j) + 1);
          ok = ok && finite_f32(lo4.x) && finite_f32(lo4.y) && finite_f32(lo4.z) &&
               finite_f32(hi4.x) && finite_f32(hi4.y) && finite_f32(hi4.z);
          box[2 * j] = lo4;
          box[2 * j + 1] = hi4;
        }
        box_ok = __syncthreads_and(ok) != 0;
      }
      for (int w0 = 0; w0 < gc; w0 += WORD_BITS) {
        const int nb = gc - w0 < WORD_BITS ? gc - w0 : WORD_BITS;
        uint32_t word[LANES];
#pragma unroll
        for (int l = 0; l < LANES; ++l) word[l] = 0u;
        // clusters s0 .. s0 + k - 1 of the word (k <= STEP) by the fast test
        auto step = [&](int s0, int k) {
          uint32_t bits[LANES];
#pragma unroll
          for (int l = 0; l < LANES; ++l) bits[l] = 0u;
#pragma unroll
          for (int b = 0; b < STEP; ++b) {
            if (b >= k) break;
            const float4 lo4 = box[2 * (w0 + s0 + b)], hi4 = box[2 * (w0 + s0 + b) + 1];
#pragma unroll
            for (int l = 0; l < LANES; ++l) {
              if (slab_fast(lo4, hi4, org[l], inv[l], t_min)) bits[l] |= 1u << b;
            }
          }
#pragma unroll
          for (int l = 0; l < LANES; ++l) word[l] |= bits[l] << s0;
        };
        int s0 = 0;
        for (; s0 + STEP <= nb && any; s0 += STEP) step(s0, STEP);
        if (s0 < nb && any) step(s0, nb - s0);
        const long long row = (long long)(1 + (c0 + w0) / WORD_BITS) * n;
#pragma unroll
        for (int l = 0; l < LANES; ++l) {
          if (idx[l] >= n) continue;
          uint32_t v = word[l];
          if (!live[l]) {
            v = 0xFFFFFFFFu;
          } else if (!(fast[l] && box_ok)) {
            v = exact_word(box + 2 * w0, nb, org[l], inv[l], t_min);
          }
          out[row + idx[l]] = v;
        }
      }
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
  const long long blocks = launch_blocks((n_lanes + TILE_LANES - 1) / TILE_LANES);
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
