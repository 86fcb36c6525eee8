// The regen wavefront's window end in queue mode, on the device, for NVIDIA
// Hopper (sm_90a): three kernels around one library sort.
//
// It replaces no pl.pallas_call.  In the JAX package the window end
// (flush_refill, rust_pathtracer_tpu/wavefront.py:374-409) is XLA: a
// scatter-add of the finished lanes' radiance, a cumsum for their queue
// slots and a spawn of the whole pool.  The port ran it as ~70 tensor ops
// a window (wavefront._flush_refill, which stays as the plain twin and the
// CPU's route): the finished mask, a nonzero and a bincount that the host
// read, gathers, index_put_(accumulate=True) and the respawn's 13-row
// stack and five indexed writes.  On LightTest's 8,388,608-lane pool that
// was ~3.5 ms of device time and 0.63 ms of idle a window (~129 windows, a
// 0.9 s frame; NVIDIA H100 80GB HBM3, 700 W), over 3x K1's time.
//
// A window end, on the stream, sizes read on the device and never on the
// host (the host reads the device block one window late, to end the loop):
//
// 1. window_end_finish_kernel, one coalesced pass over the pool, TILE
//    lanes a block in ITEMS rows of THREADS lanes, one a thread: a lane is
//    finished where alive <= 0.5 and work >= 0; its sort key is its
//    pixel, else the sentinel npix (past every pixel); its value its lane;
//    the finished lanes' depth histogram (clamped to HIST_BINS - 1) in
//    shared memory, added to device memory as integers; each row's count
//    of finished lanes (ballots).  The block that finishes last (a ticket
//    after a fence) scans the rows' counts into each row's first rank,
//    adds the integer histogram to the f32 one (as the twin's bincount is
//    added, once a window) and fills the device block: n_fin, n_take =
//    min(n_fin, total - issued), the window's first work id, issued +
//    n_take, and the lanes alive after the respawn.
// 2. A stable radix sort of (key, lane) pairs over the pool's bits of
//    npix (pool_sort.cu, CUB): every pixel's finished lanes in a run, in
//    lane order, the unfinished ones after them.
// 3. window_end_add_kernel, one thread a sorted position: a block gathers
//    its positions' radiance in parallel into shared memory; the thread at
//    the start of a run adds it to its pixel one f32 add at a time,
//    acc[p] = ((acc[p] + v1) + v2) + ..., in lane order: the order of the
//    twin's index_put_(accumulate=True) on the CPU, so the two agree bit
//    for bit and the card repeats itself (no float atomics).  (CUDA's
//    index_put_ sums a pixel's values first and adds the sum: other bits.)
// 4. window_end_respawn_kernel, one thread a lane, a block a row of the
//    finish: a finished lane's rank is its row's first rank and its place
//    among the row's finished lanes (ballots); below n_take it takes work
//    id first + rank and spawns its camera lane in place (camera_lane.cuh,
//    the lanes kernel's code, then camera.camera_rays_from_disk's affine
//    map in torch's op order): state rows 0-12, key words, depth 0, work,
//    pixel.  The other finished lanes idle (work -1).  No scattered write.
//    One lane a thread: the first design walked a tile's 16 rows in each
//    thread and spilled (80 registers), 0.72 ms a LightTest window.
//
// What bounds it: bytes.  A lane of the pool is read by the finish (alive,
// work, depth, pixel: 20 B) and written as a pair (8 B); the sort moves
// the pairs in three passes of 8 digits (~16 B a lane a pass for 19 bits);
// the add reads the pairs (8 B) and a finished lane's radiance (12 B, at
// 32-byte sectors: gathered) and its pixel's sum; the respawn reads alive
// and work (8 B) and writes a taken lane's 76 B (13 rows, 2 key words,
// depth, work and the int64 pixel).  On LightTest's pool, ~6.36M of 8.4M
// lanes finished a window: ~0.9 GB in the three kernels, ~0.27 ms at 3.35
// TB/s, and ~0.44 GB in the sort.  The work is small but for the
// respawn's seven threefry blocks a taken lane (~0.1 ms at the int32
// rate, the lanes kernel's count), in warps of which only the finished
// lanes spawn.  Measured (a LightTest frame's 130 window ends, NVIDIA H100
// 80GB HBM3, 700 W): 0.663 ms a window in the three kernels (respawn 0.360,
// finish 0.165, add 0.138) and 0.205 ms in CUB's onesweep passes.
//
// Numerics: built with --fmad=false and no fast math (ops/_build.py): the
// adds in the twin's order; the camera lane as the lanes kernel draws it;
// the affine map's products and sums as torch computes them, unfused.

#include <cuda_runtime.h>
#include <stdint.h>

#include "camera_lane.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;  // lanes a thread in the finish and the respawn
constexpr int TILE = THREADS * ITEMS;
constexpr int HIST_BINS = 64;  // integrator.MAX_BOUNCE_STATS

// the device block's int32 words (ops/window_end.py CTL_*)
enum Ctl {
  CTL_HANDED = 0,  // work ids handed out so far
  CTL_WID0 = 1,    // the window's first work id
  CTL_N_FIN = 2,   // lanes finished at the window's end
  CTL_N_TAKE = 3,  // of them, lanes that take work
  CTL_LIVE = 4,    // lanes alive after the respawn
  CTL_DONE = 5,    // the finish's tickets (0 between launches)
  CTL_ALIVE = 6,   // the finish's count of live lanes (0 between launches)
};

// camera parameters (ops/window_end.py camera_params): origin, lower left
// corner, horizontal, vertical, u, v (3 each), the lens radius
enum Cam { CAM_ORIGIN = 0, CAM_LLC = 3, CAM_HOR = 6, CAM_VER = 9, CAM_U = 12, CAM_V = 15,
           CAM_LENS = 18 };

__global__ void __launch_bounds__(THREADS)
window_end_finish_kernel(const float* __restrict__ alive, const int* __restrict__ work,
                         const long long* __restrict__ pixel, const int* __restrict__ depth,
                         long long n, int npix, long long total,
                         unsigned* __restrict__ sort_keys, int* __restrict__ sort_vals,
                         int* row_fin, int* hist_count, float* hist, int* ctl) {
  __shared__ int s_hist[HIST_BINS];
  __shared__ int s_row[ITEMS][WARPS];
  __shared__ int s_alive[WARPS];
  __shared__ int s_scan[THREADS];
  __shared__ int s_last, s_total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int b = tid; b < HIST_BINS; b += THREADS) s_hist[b] = 0;
  __syncthreads();

  // row k of the tile: lanes first + k * THREADS .. + THREADS - 1, one a thread
  const long long first = (long long)blockIdx.x * TILE;
  int n_alive = 0;
#pragma unroll 4
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = first + (long long)k * THREADS + tid;
    bool fin = false;
    if (i < n) {
      const float a = alive[i];
      n_alive += a > 0.5f;
      unsigned key = (unsigned)npix;
      if (a <= 0.5f && work[i] >= 0) {
        fin = true;
        key = (unsigned)pixel[i];
        const int d = depth[i];
        atomicAdd(&s_hist[d < HIST_BINS - 1 ? d : HIST_BINS - 1], 1);
      }
      sort_keys[i] = key;
      sort_vals[i] = (int)i;
    }
    const unsigned vote = __ballot_sync(0xffffffffu, fin);
    if (lane == 0) s_row[k][warp] = __popc(vote);
  }
  for (int off = 16; off > 0; off >>= 1) n_alive += __shfl_xor_sync(0xffffffffu, n_alive, off);
  if (lane == 0) s_alive[warp] = n_alive;
  __syncthreads();
  if (tid < ITEMS) {  // each row's count of finished lanes
    int f = 0;
    for (int w = 0; w < WARPS; ++w) f += s_row[tid][w];
    row_fin[(long long)blockIdx.x * ITEMS + tid] = f;
  }
  if (tid == 0) {
    int a = 0;
    for (int w = 0; w < WARPS; ++w) a += s_alive[w];
    if (a) atomicAdd(&ctl[CTL_ALIVE], a);
  }
  for (int b = tid; b < HIST_BINS; b += THREADS) {
    if (s_hist[b]) atomicAdd(&hist_count[b], s_hist[b]);
  }
  __threadfence();  // this tile's counts before its ticket
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&ctl[CTL_DONE], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;

  // The last block: every other tile's counts are in device memory.
  __threadfence();
  volatile int* rows = row_fin;
  const long long n_rows = (long long)gridDim.x * ITEMS;
  const long long per = (n_rows + THREADS - 1) / THREADS;
  const long long r0 = tid * per < n_rows ? tid * per : n_rows;
  const long long r1 = r0 + per < n_rows ? r0 + per : n_rows;
  int sum = 0;
  for (long long r = r0; r < r1; ++r) sum += rows[r];
  s_scan[tid] = sum;
  __syncthreads();
  if (tid == 0) {  // exclusive, over the threads' runs of rows
    int run = 0;
    for (int t = 0; t < THREADS; ++t) {
      const int v = s_scan[t];
      s_scan[t] = run;
      run += v;
    }
    s_total = run;  // n_fin
  }
  __syncthreads();
  int run = s_scan[tid];
  for (long long r = r0; r < r1; ++r) {  // each row's first rank, in place
    const int v = rows[r];
    rows[r] = run;
    run += v;
  }
  volatile int* hc = hist_count;
  for (int b = tid; b < HIST_BINS; b += THREADS) {
    hist[b] = hist[b] + (float)hc[b];
    hc[b] = 0;
  }
  if (tid == 0) {
    volatile int* c = ctl;
    const int fin = s_total;
    const int issued = c[CTL_HANDED];
    const long long left = total - (long long)issued;
    const int take = (long long)fin < left ? fin : (int)left;
    c[CTL_WID0] = issued;
    c[CTL_N_FIN] = fin;
    c[CTL_N_TAKE] = take;
    c[CTL_LIVE] = c[CTL_ALIVE] + take;
    c[CTL_HANDED] = issued + take;
    c[CTL_ALIVE] = 0;
    c[CTL_DONE] = 0;
  }
}

__global__ void __launch_bounds__(THREADS)
window_end_add_kernel(const unsigned* __restrict__ keys, const int* __restrict__ lanes,
                      const float* __restrict__ rad, long long n, int npix,
                      float* __restrict__ acc) {
  __shared__ unsigned s_key[THREADS];
  __shared__ float s_rad[3][THREADS];
  const int tid = threadIdx.x;
  const long long first = (long long)blockIdx.x * THREADS;
  const long long j = first + tid;
  const unsigned end = (unsigned)npix;
  unsigned key = end;
  if (j < n) {
    key = keys[j];
    if (key != end) {  // gathered by every thread at once
      const long long lane = lanes[j];
      s_rad[0][tid] = rad[lane];
      s_rad[1][tid] = rad[n + lane];
      s_rad[2][tid] = rad[2 * n + lane];
    }
  }
  s_key[tid] = key;
  __syncthreads();
  if (key == end) return;
  const unsigned prev = tid > 0 ? s_key[tid - 1] : (j > 0 ? keys[j - 1] : end);
  if (prev == key) return;  // inside a run: its first thread adds it

  float* a = acc + 3LL * key;
  float x = a[0], y = a[1], z = a[2];
  int t = tid;
  for (; t < THREADS && s_key[t] == key; ++t) {
    x = x + s_rad[0][t];
    y = y + s_rad[1][t];
    z = z + s_rad[2][t];
  }
  if (t == THREADS) {  // the run goes on past the block
    for (long long m = first + THREADS; m < n && keys[m] == key; ++m) {
      const long long lane = lanes[m];
      x = x + rad[lane];
      y = y + rad[n + lane];
      z = z + rad[2 * n + lane];
    }
  }
  a[0] = x;
  a[1] = y;
  a[2] = z;
}

__global__ void __launch_bounds__(THREADS)
window_end_respawn_kernel(float* __restrict__ state, int* __restrict__ key_words,
                          int* __restrict__ depth, int* __restrict__ work,
                          long long* __restrict__ pixel, long long n,
                          const int* __restrict__ row_rank, const int* __restrict__ ctl,
                          const long long* __restrict__ base, const float* __restrict__ cam,
                          int npix, long long width, long long height, long long spp_total,
                          float w_div, float h_div) {
  __shared__ int s_warp[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long i = (long long)blockIdx.x * THREADS + tid;  // a lane of row blockIdx.x
  const bool fin = i < n && state[12 * n + i] <= 0.5f && work[i] >= 0;
  const unsigned vote = __ballot_sync(0xffffffffu, fin);
  if (lane == 0) s_warp[warp] = __popc(vote);
  __syncthreads();
  if (!fin) return;

  int r = row_rank[blockIdx.x] + __popc(vote & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) r += s_warp[w];
  if (r >= ctl[CTL_N_TAKE]) {
    work[i] = -1;
    return;
  }
  const int wid = ctl[CTL_WID0] + r;
  const long long p = wid % npix, s = wid / npix;
  const rpt::CameraLane c = rpt::camera_lane((uint32_t)base[0], (uint32_t)base[1], p, s,
                                             width, height, spp_total, w_div, h_div);
  // camera.camera_rays_from_disk: rng = lens_radius * disk (z = 0),
  // blur = u * rng_x + v * rng_y, o = origin + blur,
  // d = llc + s * horizontal + t * vertical - origin - blur
  const float rx = cam[CAM_LENS] * c.disk_x, ry = cam[CAM_LENS] * c.disk_y;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const float blur = cam[CAM_U + q] * rx + cam[CAM_V + q] * ry;
    state[q * n + i] = cam[CAM_ORIGIN + q] + blur;
    state[(3 + q) * n + i] =
        (((cam[CAM_LLC + q] + c.s_vp * cam[CAM_HOR + q]) + c.t_vp * cam[CAM_VER + q]) -
         cam[CAM_ORIGIN + q]) - blur;
    state[(6 + q) * n + i] = 1.0f;
    state[(9 + q) * n + i] = 0.0f;
  }
  state[12 * n + i] = 1.0f;
  key_words[i] = (int)c.k0;
  key_words[n + i] = (int)c.k1;
  depth[i] = 0;
  work[i] = wid;
  pixel[i] = p;
}

}  // namespace

extern "C" {

// Entries of the rows' counts (int32) for a pool of n_lanes: ITEMS rows of
// THREADS lanes a finish block.
long long window_end_rows(long long n_lanes) { return (n_lanes + TILE - 1) / TILE * ITEMS; }

// The finish on `stream`.  Device pointers: `alive` state row 12, `work`
// and `depth` int32, `pixel` int64, rows of n_lanes; `sort_keys` (uint32)
// and `sort_vals` (int32) n_lanes each, written; `row_fin`
// window_end_rows(n_lanes) int32; `hist_count` HIST_BINS int32, zero between launches; `hist`
// HIST_BINS f32, added to; `ctl` the device block (CTL_*: HANDED set, DONE
// and ALIVE zero between launches).  `npix` the sentinel key, `total` the
// frame's work items.  Returns cudaGetLastError() of the launch.
int window_end_finish_launch(const float* alive, const int* work, const long long* pixel,
                             const int* depth, long long n_lanes, int npix, long long total,
                             unsigned* sort_keys, int* sort_vals, int* row_fin,
                             int* hist_count, float* hist, int* ctl, void* stream) {
  if (n_lanes < 1 || npix < 1 || total < 0 || n_lanes >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (!alive || !work || !pixel || !depth || !sort_keys || !sort_vals || !row_fin ||
      !hist_count || !hist || !ctl)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n_lanes + TILE - 1) / TILE;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  window_end_finish_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
      alive, work, pixel, depth, n_lanes, npix, total, sort_keys, sort_vals, row_fin,
      hist_count, hist, ctl);
  return (int)cudaGetLastError();
}

// The add on `stream`: `keys` / `lanes` the sorted pairs (n_lanes each),
// `rad` state row 9 (rows 9-11 at a stride of n_lanes), `acc` the (npix, 3)
// f32 image sums, added to.
int window_end_add_launch(const unsigned* keys, const int* lanes, const float* rad,
                          long long n_lanes, int npix, float* acc, void* stream) {
  if (n_lanes < 1 || npix < 1 || !keys || !lanes || !rad || !acc)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n_lanes + THREADS - 1) / THREADS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  window_end_add_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(keys, lanes, rad, n_lanes,
                                                              npix, acc);
  return (int)cudaGetLastError();
}

// The respawn on `stream`: the pool's rows in place (`state` (13, n_lanes)
// f32, `key_words` (2, n_lanes) int32, `depth`, `work` int32, `pixel`
// int64), `row_rank` the finish's scanned rows, `ctl` the device block,
// `base` the frame's key (2 int64), `cam` the camera's 19 f32 (Cam), the
// frame's width, height and spp, and npix = width * height.
int window_end_respawn_launch(float* state, int* key_words, int* depth, int* work,
                              long long* pixel, long long n_lanes, const int* row_rank,
                              const int* ctl, const long long* base, const float* cam,
                              long long width, long long height, long long spp_total,
                              void* stream) {
  if (n_lanes < 1 || width < 1 || height < 1 || spp_total < 1 ||
      width * height >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (!state || !key_words || !depth || !work || !pixel || !row_rank || !ctl || !base ||
      !cam)
    return (int)cudaErrorInvalidValue;
  // the divisors as the plain twin makes them: the f64 W - 1.0 rounded to f32
  const float w_div = (float)((double)width - 1.0), h_div = (float)((double)height - 1.0);
  const long long blocks = (n_lanes + THREADS - 1) / THREADS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  window_end_respawn_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
      state, key_words, depth, work, pixel, n_lanes, row_rank, ctl, base, cam,
      (int)(width * height), width, height, spp_total, w_div, h_div);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
