// K2: the backward of one fused bounce, for NVIDIA Hopper (sm_90a).
//
// Replaces rust_pathtracer_tpu/ops/fused_bounce.py::_bwd_kernel (the
// Pallas TPU kernel, launched by _bwd_call) and the reductions of
// _bounce_grads, which the JAX package left to an XLA one-hot einsum.
// Per lane: the closed-form VJP of one bounce under the detached-sampling
// estimator, from K1's residuals (t, flipped normal, texture value,
// dielectric ratio, flip/r, flags), the incoming direction and the
// cotangents of the outgoing (o, d, thr, rad), to the cotangents of the
// incoming (o, d, thr).  The plain PyTorch twin is fused_bounce_bwd_plain
// in ../fused_bounce_bwd.py, which follows the JAX package's _bwd_xla.
//
// The reductions: each hit lane owes its texture-value gradient to one
// colour row (solid, checker-odd or checker-even) of its winning
// primitive, each miss lane its radiance cotangent times its throughput
// to the background.  That is (9P + 3) sums over all lanes, each in a
// fixed order, with no atomics, so a result is the same bit for bit on
// every run on one card (the grid depends on the lane count and the card):
//   * per warp and tile of 32 lanes: __match_any_sync groups the lanes by
//     key (group * P + primitive, -1 without a hit).  Where the whole warp
//     holds one key, a __shfl_xor_sync tree sums its three values; else
//     each group's leader (its lowest lane) adds its peers' values in lane
//     order from the warp's staging row.  The leader adds the sums into
//     the warp's own row of 9P + 3 slots in shared memory: one writer a
//     slot, in tile order.  The three background sums take a
//     __shfl_xor_sync tree, lane 0 the add.  No block barrier a tile;
//   * at the end, the block sums its warps' rows in warp order into its
//     column of the partials, (9P + 3, blocks);
//   * reduce_partials_kernel: one warp a slot, lane l adds the blocks l,
//     l + 32, ... in order, then a __shfl_xor_sync tree.
//
// What bounds it on the card: per lane 28 f32/int32 columns in (112 B)
// and 9 out (36 B), about 155 MB a bounce at 1,048,576 lanes; the
// arithmetic is about 150 flops a lane.  So the design keeps the loads in
// flight: no barrier a tile, MIN_BLOCKS blocks of 8 warps an SM, and a
// grid of WAVES x the card's resident blocks, sized from the card
// (PERF.md gives the times of the grid choices and of the
// one-barrier-a-tile scan by slot that this replaced).
//
// Numerics: build without --use_fast_math and with --fmad=false, so every
// f32 op rounds as the plain version's does (IEEE division and sqrt, no
// contraction), and every expression keeps the plain version's order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// residual flags bits (ops/fused_bounce.py FLG_*)
constexpr int FLG_HIT = 1, FLG_CONT = 4, FLG_REFLECT = 8;
constexpr int FLG_SINES_NEG = 16, FLG_SEL_L = 32, FLG_SEL_M = 64, FLG_SEL_D = 128;
constexpr int FLG_LIGHT_ON = 256, FLG_COS_CLAMP = 512, FLG_REFR_ZERO = 1024;
constexpr int FLG_L_NEG = 2048, FLG_IS_CK = 4096, FLG_ALIVE = 8192;
constexpr int FLG_BESTI_SHIFT = 16;

// flag bits of mat_flags (ops/fused_bounce.py _MAT_BITS)
constexpr int MATF_METAL = 2, MATF_DIELECTRIC = 4;

constexpr float SAFE_EPS = 1e-20f;
constexpr int MAX_PRIMS = 128;
constexpr int THREADS = 256;
constexpr int WARP = 32;
constexpr int WARPS = THREADS / WARP;
constexpr unsigned FULL = 0xffffffffu;
// the grid: this many times the blocks the card holds at once, and the
// blocks an SM should hold (at most 64 registers a thread); PERF.md
constexpr int WAVES = 1;
constexpr int MIN_BLOCKS = 4;

constexpr int N_IN = 28;  // 10 residuals, d (3), thr (3), 12 cotangents
constexpr int N_OUT = 9;  // g_o (3), g_d (3), g_thr (3)

struct Columns {
  // in: t nx ny nz v0 v1 v2 ratio invr flags(int32) | d0 d1 d2 |
  //     thr0 thr1 thr2 | g_o (3) g_d (3) g_thr (3) g_rad (3) of the outgoing state
  const void* in[N_IN];
  // out: g_o (3) g_d (3) g_thr (3) of the incoming state
  float* out[N_OUT];
};

__device__ __forceinline__ float mf(bool m) { return m ? 1.0f : 0.0f; }

// NaN-propagating max / min against a constant, as jnp.maximum / minimum
__device__ __forceinline__ float max_nan(float x, float c) {
  return (x != x || x > c) ? x : c;
}
__device__ __forceinline__ float min_nan(float x, float c) {
  return (x != x || x < c) ? x : c;
}

__device__ __forceinline__ float col(const Columns& c, int k, long long i) {
  return static_cast<const float*>(c.in[k])[i];
}

// The bytes of shared memory the main kernel takes for P primitives: each
// warp's row of 9P + 3 slots.
size_t rows_bytes(int P) { return (size_t)WARPS * (9 * P + 3) * sizeof(float); }

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fused_bounce_bwd_kernel(Columns cols, const float* __restrict__ bg, int mat_flags,
                        int P, float* __restrict__ partials, long long n) {
  extern __shared__ float s_rows[];            // (WARPS, 9P + 3)
  __shared__ float s_val[WARPS][3][WARP];      // a tile's texture values
  const int n_tex = 9 * P;
  const int n_slots = n_tex + 3;
  const int tid = threadIdx.x;
  const int lane = tid & (WARP - 1), w = tid / WARP;
  const float bg0 = bg[0], bg1 = bg[1], bg2 = bg[2];
  const int* flags_col = static_cast<const int*>(cols.in[9]);
  float* row = s_rows + w * n_slots;
  for (int s = lane; s < n_slots; s += WARP) row[s] = 0.0f;
  __syncwarp();

  // every thread of the block runs the same tiles (the warp collectives
  // and the closing barrier need that)
  for (long long base = (long long)blockIdx.x * THREADS; base < n;
       base += (long long)gridDim.x * THREADS) {
    const long long i = base + tid;
    int key = -1;  // hit lanes: group * P + prim, group 0 solid / 1 odd / 2 even
    float gv0 = 0.0f, gv1 = 0.0f, gv2 = 0.0f;
    float gb0 = 0.0f, gb1 = 0.0f, gb2 = 0.0f;

    if (i < n) {
      const int fl = flags_col[i];
      const bool hit = fl & FLG_HIT, cont = fl & FLG_CONT, reflect = fl & FLG_REFLECT;
      const bool sel_l = (fl & FLG_SEL_L) && cont;
      const bool sel_m = (fl & FLG_SEL_M) && cont;
      const bool sel_d = (fl & FLG_SEL_D) && cont;
      const bool light_on = fl & FLG_LIGHT_ON;
      const bool cos_clamp = fl & FLG_COS_CLAMP, refr_zero = fl & FLG_REFR_ZERO;
      const bool l_neg = fl & FLG_L_NEG;
      const bool miss = (fl & FLG_ALIVE) && !hit;

      const float t = col(cols, 0, i);
      const float nx = col(cols, 1, i), ny = col(cols, 2, i), nz = col(cols, 3, i);
      const float v0 = col(cols, 4, i), v1 = col(cols, 5, i), v2 = col(cols, 6, i);
      const float rr = col(cols, 7, i), invr = col(cols, 8, i);
      const float dx = col(cols, 10, i), dy = col(cols, 11, i), dz = col(cols, 12, i);
      const float th0 = col(cols, 13, i), th1 = col(cols, 14, i), th2 = col(cols, 15, i);
      const float go2x = col(cols, 16, i), go2y = col(cols, 17, i), go2z = col(cols, 18, i);
      const float gd2x = col(cols, 19, i), gd2y = col(cols, 20, i), gd2z = col(cols, 21, i);
      const float gt2x = col(cols, 22, i), gt2y = col(cols, 23, i), gt2z = col(cols, 24, i);
      const float gr2x = col(cols, 25, i), gr2y = col(cols, 26, i), gr2z = col(cols, 27, i);

      const float a = dx * dx + dy * dy + dz * dz;
      const float sa = sqrtf(max_nan(a, SAFE_EPS));
      const float ux = dx / sa, uy = dy / sa, uz = dz / sa;

      // ---- scatter direction chains: g_dir -> (g_u, g_n) ------------
      const float gdirx = mf(cont) * gd2x, gdiry = mf(cont) * gd2y,
                  gdirz = mf(cont) * gd2z;
      float gnx = mf(sel_l) * gdirx, gny = mf(sel_l) * gdiry, gnz = mf(sel_l) * gdirz;
      float gux = 0.0f, guy = 0.0f, guz = 0.0f;

      if (mat_flags & (MATF_METAL | MATF_DIELECTRIC)) {  // mirror reflection
        const bool refl_m = sel_m || (sel_d && reflect);
        const float s = ux * nx + uy * ny + uz * nz;
        const float grx = mf(refl_m) * gdirx, gry = mf(refl_m) * gdiry,
                    grz = mf(refl_m) * gdirz;
        const float ngr = nx * grx + ny * gry + nz * grz;
        gux = gux + grx - 2.0f * nx * ngr;
        guy = guy + gry - 2.0f * ny * ngr;
        guz = guz + grz - 2.0f * nz * ngr;
        gnx = gnx - 2.0f * (ux * ngr + s * grx);
        gny = gny - 2.0f * (uy * ngr + s * gry);
        gnz = gnz - 2.0f * (uz * ngr + s * grz);
      }

      if (mat_flags & MATF_DIELECTRIC) {  // refraction
        const bool rm = sel_d && !reflect;
        const float goutx = mf(rm) * gdirx, gouty = mf(rm) * gdiry,
                    goutz = mf(rm) * gdirz;
        const float raw_cos = -(ux * nx + uy * ny + uz * nz);
        const float cs = min_nan(raw_cos, 1.0f);
        const float perpx = rr * (ux + cs * nx);
        const float perpy = rr * (uy + cs * ny);
        const float perpz = rr * (uz + cs * nz);
        const float abs_l = fabsf(1.0f - (perpx * perpx + perpy * perpy + perpz * perpz));
        const float s_par = refr_zero ? 0.0f : sqrtf(abs_l);
        const float g_spar = -(nx * goutx + ny * gouty + nz * goutz);
        gnx = gnx - s_par * goutx;
        gny = gny - s_par * gouty;
        gnz = gnz - s_par * goutz;
        const float g_absl = refr_zero ? 0.0f : g_spar / max_nan(2.0f * s_par, 1e-30f);
        const float sg = (l_neg ? -1.0f : 1.0f) * g_absl;
        const float gpx = goutx - 2.0f * perpx * sg;
        const float gpy = gouty - 2.0f * perpy * sg;
        const float gpz = goutz - 2.0f * perpz * sg;
        gux = gux + rr * gpx;
        guy = guy + rr * gpy;
        guz = guz + rr * gpz;
        gnx = gnx + rr * cs * gpx;
        gny = gny + rr * cs * gpy;
        gnz = gnz + rr * cs * gpz;
        const float g_cos = cos_clamp ? 0.0f : rr * (nx * gpx + ny * gpy + nz * gpz);
        gux = gux - nx * g_cos;
        guy = guy - ny * g_cos;
        guz = guz - nz * g_cos;
        gnx = gnx - ux * g_cos;
        gny = gny - uy * g_cos;
        gnz = gnz - uz * g_cos;
      }

      // ---- u = d/|d| -> d --------------------------------------------
      const float udg = ux * gux + uy * guy + uz * guz;
      float gdx = mf(!cont) * gd2x + (gux - ux * udg) / sa;
      float gdy = mf(!cont) * gd2y + (guy - uy * udg) / sa;
      float gdz = mf(!cont) * gd2z + (guz - uz * udg) / sa;

      // ---- throughput: attenuation, miss background, light emission --
      const bool lm = sel_l || sel_m;
      cols.out[6][i] = (cont ? (lm ? v0 : 1.0f) * gt2x : gt2x) + mf(miss) * bg0 * gr2x +
                       mf(light_on) * v0 * gr2x;
      cols.out[7][i] = (cont ? (lm ? v1 : 1.0f) * gt2y : gt2y) + mf(miss) * bg1 * gr2y +
                       mf(light_on) * v1 * gr2y;
      cols.out[8][i] = (cont ? (lm ? v2 : 1.0f) * gt2z : gt2z) + mf(miss) * bg2 * gr2z +
                       mf(light_on) * v2 * gr2z;

      // ---- normal -> hit point; point = o + t(o, d) d ---------------
      const float gptx = mf(cont) * go2x + invr * gnx;
      const float gpty = mf(cont) * go2y + invr * gny;
      const float gptz = mf(cont) * go2z + invr * gnz;
      const float g_t = dx * gptx + dy * gpty + dz * gptz;
      float gox = mf(!cont) * go2x + gptx;
      float goy = mf(!cont) * go2y + gpty;
      float goz = mf(!cont) * go2z + gptz;
      gdx = gdx + t * gptx;
      gdy = gdy + t * gpty;
      gdz = gdz + t * gptz;
      float den = nx * dx + ny * dy + nz * dz;
      den = fabsf(den) < 1e-30f ? 1.0f : den;
      cols.out[0][i] = gox + g_t * (-nx / den);
      cols.out[1][i] = goy + g_t * (-ny / den);
      cols.out[2][i] = goz + g_t * (-nz / den);
      cols.out[3][i] = gdx + g_t * (-t * nx / den);
      cols.out[4][i] = gdy + g_t * (-t * ny / den);
      cols.out[5][i] = gdz + g_t * (-t * nz / den);

      // ---- this lane's share of the reductions ----------------------
      if (hit) {
        const int group = (fl & FLG_IS_CK) ? ((fl & FLG_SINES_NEG) ? 1 : 2) : 0;
        key = group * P + (fl >> FLG_BESTI_SHIFT);
      }
      gv0 = mf(lm) * th0 * gt2x + mf(light_on) * th0 * gr2x;
      gv1 = mf(lm) * th1 * gt2y + mf(light_on) * th1 * gr2y;
      gv2 = mf(lm) * th2 * gt2z + mf(light_on) * th2 * gr2z;
      gb0 = mf(miss) * th0 * gr2x;
      gb1 = mf(miss) * th1 * gr2y;
      gb2 = mf(miss) * th2 * gr2z;
    }

    // ---- the tile's share of the reductions, per warp ----------------
    // texture slot of colour c: the packed table's row 21 + 3 group + c,
    // primitive p: (3 group + c) P + p
    const unsigned peers = __match_any_sync(FULL, key);
    if (peers == FULL) {  // one key in the whole warp: a shuffle tree
#pragma unroll
      for (int off = WARP / 2; off > 0; off >>= 1) {
        gv0 += __shfl_xor_sync(FULL, gv0, off);
        gv1 += __shfl_xor_sync(FULL, gv1, off);
        gv2 += __shfl_xor_sync(FULL, gv2, off);
      }
      if (lane == 0 && key >= 0) {
        const int group = key / P, prim = key - group * P;
        row[(3 * group) * P + prim] += gv0;
        row[(3 * group + 1) * P + prim] += gv1;
        row[(3 * group + 2) * P + prim] += gv2;
      }
    } else {  // each group's leader adds its peers' values in lane order
      s_val[w][0][lane] = gv0;
      s_val[w][1][lane] = gv1;
      s_val[w][2][lane] = gv2;
      __syncwarp();
      if (key >= 0 && lane == __ffs(peers) - 1) {
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
        for (unsigned m = peers; m; m &= m - 1) {
          const int l = __ffs(m) - 1;
          a0 += s_val[w][0][l];
          a1 += s_val[w][1][l];
          a2 += s_val[w][2][l];
        }
        const int group = key / P, prim = key - group * P;
        row[(3 * group) * P + prim] += a0;
        row[(3 * group + 1) * P + prim] += a1;
        row[(3 * group + 2) * P + prim] += a2;
      }
    }
#pragma unroll
    for (int off = WARP / 2; off > 0; off >>= 1) {
      gb0 += __shfl_xor_sync(FULL, gb0, off);
      gb1 += __shfl_xor_sync(FULL, gb1, off);
      gb2 += __shfl_xor_sync(FULL, gb2, off);
    }
    if (lane == 0) {
      row[n_tex] += gb0;
      row[n_tex + 1] += gb1;
      row[n_tex + 2] += gb2;
    }
    __syncwarp();  // the next tile's leader of a key may be another lane
  }

  // the block's column of partials: its warps' rows summed in warp order
  __syncthreads();
  for (int s = tid; s < n_slots; s += THREADS) {
    float sum = s_rows[s];
    for (int k = 1; k < WARPS; ++k) sum += s_rows[k * n_slots + s];
    partials[(long long)s * gridDim.x + blockIdx.x] = sum;
  }
}

// out[s] = the sum of partials[s, :] (n_blocks a slot): one warp a slot,
// lane l adding the blocks l, l + 32, ... in order, then a shuffle tree
__global__ void __launch_bounds__(THREADS)
reduce_partials_kernel(const float* __restrict__ partials, int n_blocks, int n_slots,
                       float* __restrict__ out) {
  const int s = (blockIdx.x * blockDim.x + threadIdx.x) / WARP;  // the warp's
  const int lane = threadIdx.x & (WARP - 1);
  if (s >= n_slots) return;
  const float* p = partials + (long long)s * n_blocks;
  float sum = 0.0f;
  for (int b = lane; b < n_blocks; b += WARP) sum += p[b];
#pragma unroll
  for (int off = WARP / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(FULL, sum, off);
  if (lane == 0) out[s] = sum;
}

}  // namespace

extern "C" {

// Blocks of the launch for n_lanes lanes and n_prims primitives on the
// current device: WAVES times the blocks it holds at once, at most one a
// tile of 256 lanes; the columns of the partials scratch.  0 on an error.
int fused_bounce_bwd_blocks(long long n_lanes, int n_prims) {
  if (n_lanes <= 0 || n_prims <= 0 || n_prims > MAX_PRIMS) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_bounce_bwd_kernel,
                                                    THREADS, rows_bytes(n_prims)) !=
          cudaSuccess) {
    return 0;
  }
  const long long tiles = (n_lanes + THREADS - 1) / THREADS;
  const long long cap = (long long)WAVES * sms * (per_sm > 0 ? per_sm : 1);
  return (int)(tiles < cap ? tiles : cap);
}

// Launch K2 on `stream`.  `in_ptrs` / `out_ptrs` are HOST arrays of 28 / 9
// device column pointers (see Columns); `bg` (3,) f32, `partials`
// (9 n_prims + 3, fused_bounce_bwd_blocks(n_lanes, n_prims)) f32 scratch
// and `reduced` (9 n_prims + 3,) f32 are device pointers.  `reduced`
// receives the packed table's rows 21-29, row-major (9, n_prims), then the
// 3 background entries.  Returns the first nonzero cudaGetLastError() of
// the two launches: nonzero means the result is not there.
int fused_bounce_bwd_launch(const void* const* in_ptrs, void* const* out_ptrs,
                            const float* bg, int mat_flags, int n_prims, float* partials,
                            float* reduced, long long n_lanes, void* stream) {
  if (n_prims <= 0 || n_prims > MAX_PRIMS || n_lanes < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_lanes == 0) return (int)cudaSuccess;
  Columns cols;
  for (int k = 0; k < N_IN; ++k) cols.in[k] = in_ptrs[k];
  for (int k = 0; k < N_OUT; ++k) cols.out[k] = static_cast<float*>(out_ptrs[k]);
  const int blocks = fused_bounce_bwd_blocks(n_lanes, n_prims);
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  const int n_slots = 9 * n_prims + 3;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  fused_bounce_bwd_kernel<<<blocks, THREADS, rows_bytes(n_prims), s>>>(
      cols, bg, mat_flags, n_prims, partials, n_lanes);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  reduce_partials_kernel<<<(n_slots + WARPS - 1) / WARPS, THREADS, 0, s>>>(
      partials, blocks, n_slots, reduced);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
