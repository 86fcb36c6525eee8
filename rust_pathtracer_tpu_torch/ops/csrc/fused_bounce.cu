// K1: one whole wavefront bounce per launch, for NVIDIA Hopper (sm_90a).
//
// Replaces rust_pathtracer_tpu/ops/fused_bounce.py::_kernel (the Pallas
// TPU kernel, want_residuals=False).  Per lane: closest hit over the
// static primitive list (sphere half-b nearest root in f64, rect plane solve,
// one-sided Moller-Trumbore with det >= TRI_DET_EPS, strict t < best),
// front-face flip, texture (solid / checker sin-product / perlin
// marble), background banking on a miss and emission banking on a
// front-face light, lambertian / metal / dielectric scatter, the state
// commit and, from the trace's rr_start on, russian roulette.  The plain
// PyTorch twin is fused_bounce_keyed_plain in ../fused_bounce.py.
//
// The bounce's uniforms.  A lane reads its threefry key (two uint32 words, made once a trace from
// the lane keys) and draws, in registers, what sampling.bounce_draws
// draws for this bounce (threefry.cuh).  Under the legacy scheme: a
// lambertian lane its two P_LAMBERT uniforms, a metal lane its three P_FUZZ
// uniforms, a dielectric lane its P_SCHLICK coin, a lane that continues
// from rr_start on its P_ROULETTE uniform, each behind a fold.  Under the
// packed scheme (the template flag PACKED, picked at launch) the same
// purposes from counter-mode blocks of the raw lane key: a lambertian lane
// block 0, a metal lane blocks 1-2, a dielectric lane block 2, roulette
// block 3.  A lane draws only what its
// material consumes; the integer arithmetic is exact, so the uniforms
// are the bits integrator._precompute_draws hoists in tensor ops (the
// JAX package hoists them because XLA makes threefry cheap on the TPU;
// on the H100 that int64 tensor-op threefry took 86% of the bench step).
// The regen wavefront (../../wavefront.py) passes a depth row: each lane
// draws at its own path depth, and roulette acts where that depth is at
// least rr_start (JAX wavefront.py:274-331).
//
// What bounds it on the card: a lane reads 13 f32 state columns
// and 2 key words and writes 13 columns, 112 B per lane-bounce, so about
// 0.11 GB per 960k-lane bounce.  The arithmetic is about 20 primitive
// tests per lane on CornellBox plus 2-4 threefry blocks (~80 int32
// operations each; 1-2 under the packed scheme, with roulette's); the
// perlin marble (7 octaves x 8 hashed corners) is
// the heaviest branch.
//
// Design, simple and right first:
// * one thread per lane, a grid-stride loop, the ragged edge masked;
// * the (32, P) table, P <= 128, is copied into shared memory at block
//   start (at most 16 KB);
// * the loop over primitives is the same for every thread, so the switch
//   on the primitive kind does not diverge within a warp;
// * material and texture branches run per lane, behind the scene's
//   material and texture flags, as the Pallas kernel's static ifs do;
// * dead lanes copy their state through; columns are SoA, out of place.
// Later work: in-place columns, fewer bytes, persistent blocks.
//
// Residual outputs (want_residuals=True in the Pallas kernel, :464-485),
// for the backward kernel K2 (fused_bounce_bwd.cu): the RES
// instantiations of the same kernel also write nine f32 planes and an
// int32 flags word, and with roulette the plane p and the flag
// FLG_RR_ACT that the roulette's backward reads.  They must hold on EVERY
// lane the values the Pallas kernel writes, dead and missed lanes
// included, so there dead lanes run the sweep too, and write_residuals
// recomputes the hit record on every lane from the sweep's result.  The
// RES=false instantiations are the serving kernel: no residual work, and
// the same arithmetic for the 13 columns.
//
// Numerics: build without --use_fast_math and with --fmad=false, so every
// f32 op rounds as the plain version's does (IEEE division and sqrt, no
// contraction, no flush to zero).  Integer powers are explicit multiplies,
// as XLA's integer_pow expands them.  A sphere's quadratic runs in f64 and
// its roots round to f32, as closest_hit.sphere_roots has it (in f32 the
// discriminant cancels on rays that meet a sphere near its rim, and the
// root can land inside the surface by more than t_min; the JAX package's
// f32 root differs).  The metal's cube root is the f64
// power rounded to f32, as vecmath.cbrt takes it; sinf / cosf are CUDA's,
// which PyTorch's CUDA sin / cos also use, so on the card the kernel and
// its plain version agree bit for bit, and sin / cos differ from the
// CPU's by an ulp.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int PRIM_SPHERE = 0, PRIM_RECT = 1, PRIM_TRIANGLE = 2;
constexpr int MAT_LAMBERTIAN = 0, MAT_METAL = 1, MAT_DIELECTRIC = 2, MAT_LIGHT = 3;
constexpr int TEX_CHECKER = 1, TEX_PERLIN = 2;

// flag bits of mat_flags / tex_flags (ops/fused_bounce.py _MAT_BITS, _TEX_BITS)
constexpr int MATF_LAMBERTIAN = 1, MATF_METAL = 2, MATF_DIELECTRIC = 4, MATF_LIGHT = 8;
constexpr int TEXF_CHECKER = 2, TEXF_PERLIN = 4;

// shading-table rows (ops/projected.py PAY_*)
constexpr int PAY_KIND = 12, PAY_AUX = 13;
constexpr int PAY_MKIND = 16, PAY_FUZZ = 17, PAY_IR = 18, PAY_TKIND = 19, PAY_TSCALE = 20;
constexpr int PAY_COLOR = 21, PAY_ODD = 24, PAY_EVEN = 27;
constexpr int PAY_W = 32;
constexpr int MAX_PRIMS = 128;

constexpr float T_MISS = 3.0e38f;
constexpr float TRI_DET_EPS = 1e-4f;
constexpr float NEAR_ZERO = 1e-8f;
constexpr float SAFE_EPS = 1e-20f;
constexpr float TWO_PI = 6.2831855f;  // 2 * float32(pi)
constexpr int TURBULENCE_DEPTH = 7;

constexpr int N_IN = 13;   // 13 state columns
constexpr int N_OUT = 13;  // 13 state columns
constexpr int N_RES = 9;   // residual f32 planes
constexpr int THREADS = 256;

// residual flags bits (ops/fused_bounce.py FLG_*)
constexpr int FLG_HIT = 1, FLG_FRONT = 2, FLG_CONT = 4, FLG_REFLECT = 8;
constexpr int FLG_SINES_NEG = 16, FLG_SEL_L = 32, FLG_SEL_M = 64, FLG_SEL_D = 128;
constexpr int FLG_LIGHT_ON = 256, FLG_COS_CLAMP = 512, FLG_REFR_ZERO = 1024;
constexpr int FLG_L_NEG = 2048, FLG_IS_CK = 4096, FLG_ALIVE = 8192;
constexpr int FLG_RR_ACT = 16384;  // roulette kept and boosted the lane
constexpr int FLG_BESTI_SHIFT = 16;

// russian roulette's floor and ceiling of p (integrator.py:845-869)
constexpr float RR_P_MIN = 0.05f, RR_P_MAX = 1.0f;

struct Columns {
  // in: o0 o1 o2 d0 d1 d2 t0 t1 t2 r0 r1 r2 al
  const float* in[N_IN];
  // the lane key's two uint32 words
  const uint32_t* key[2];
  // out: o0 o1 o2 d0 d1 d2 t0 t1 t2 r0 r1 r2 al
  float* out[N_OUT];
  // residuals (RES only): t nx ny nz v0 v1 v2 ratio invr, then flags;
  // rr_p (RES with roulette only): roulette's p
  float* res[N_RES];
  int* flags;
  float* rr_p;
};

// The uniforms of one bounce of one lane, drawn from the lane key,
// purpose by purpose, when asked, under the legacy or the packed scheme.
template <bool PACKED>
struct Draws {
  uint32_t k0, k1, bounce;

  __device__ void lambert(float& u0, float& u1) const {
    uint32_t p0, p1;
    if (PACKED) {
      rpt::packed_block(k0, k1, bounce, 0u, p0, p1);
      u0 = rpt::packed_unit(p0);
      u1 = rpt::packed_unit(p1);
      return;
    }
    rpt::bounce_key(k0, k1, bounce, rpt::P_LAMBERT, p0, p1);
    u0 = rpt::uniform_at(p0, p1, 0u);
    u1 = rpt::uniform_at(p0, p1, 1u);
  }
  __device__ void fuzz(float& u0, float& u1, float& u2) const {
    uint32_t p0, p1;
    if (PACKED) {  // words 2, 3, 4
      rpt::packed_block(k0, k1, bounce, 1u, p0, p1);
      u0 = rpt::packed_unit(p0);
      u1 = rpt::packed_unit(p1);
      rpt::packed_block(k0, k1, bounce, 2u, p0, p1);
      u2 = rpt::packed_unit(p0);
      return;
    }
    rpt::bounce_key(k0, k1, bounce, rpt::P_FUZZ, p0, p1);
    u0 = rpt::uniform_at(p0, p1, 0u);
    u1 = rpt::uniform_at(p0, p1, 1u);
    u2 = rpt::uniform_at(p0, p1, 2u);
  }
  __device__ float coin() const {
    uint32_t p0, p1;
    if (PACKED) {  // word 5
      rpt::packed_block(k0, k1, bounce, 2u, p0, p1);
      return rpt::packed_unit(p1);
    }
    rpt::bounce_key(k0, k1, bounce, rpt::P_SCHLICK, p0, p1);
    return rpt::uniform_at(p0, p1, 0u);
  }
  __device__ float roulette() const {
    uint32_t p0, p1;
    if (PACKED) {  // word 6
      rpt::packed_block(k0, k1, bounce, 3u, p0, p1);
      return rpt::packed_unit(p0);
    }
    rpt::bounce_key(k0, k1, bounce, rpt::P_ROULETTE, p0, p1);
    return rpt::uniform_at(p0, p1, 0u);
  }
};

// NaN-propagating max / min against a constant, as jnp.maximum / minimum
__device__ __forceinline__ float max_nan(float x, float c) {
  return (x != x || x > c) ? x : c;
}
__device__ __forceinline__ float min_nan(float x, float c) {
  return (x != x || x < c) ? x : c;
}
// NaN-propagating max of two lanes' values, as torch.maximum
__device__ __forceinline__ float max2_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// ---- perlin (rust_pathtracer_tpu/perlin.py, bit for bit) -----------------

__device__ __forceinline__ float fade(float t) {
  return t * t * t * (t * (t * 6.0f - 15.0f) + 10.0f);
}

__device__ __forceinline__ uint32_t hash3(int ix, int iy, int iz, uint32_t seed) {
  uint32_t h = (((uint32_t)ix * 0x8DA6B343u) ^ ((uint32_t)iy * 0xD8163841u) ^
                ((uint32_t)iz * 0xCB1AB31Fu)) + seed;
  h = h ^ (h >> 15);
  h = h * 0x2C1B3C6Du;
  h = h ^ (h >> 12);
  h = h * 0x297A2D39u;
  h = h ^ (h >> 15);
  return h;
}

__device__ __forceinline__ float grad(uint32_t hh, float x, float y, float z) {
  const int h = (int)(hh & 15u);
  const float u = h < 8 ? x : y;
  const float v = h < 4 ? y : ((h == 12 || h == 14) ? x : z);
  return ((h & 1) == 0 ? u : -u) + ((h & 2) == 0 ? v : -v);
}

__device__ __forceinline__ float lerp(float t, float lo, float hi) {
  return lo + t * (hi - lo);
}

__device__ float noise3(float px, float py, float pz, uint32_t seed) {
  const float xf = floorf(px), yf = floorf(py), zf = floorf(pz);
  const int ix = (int)xf, iy = (int)yf, iz = (int)zf;
  const float x = px - xf, y = py - yf, z = pz - zf;
  const float u = fade(x), v = fade(y), w = fade(z);
  const float n000 = grad(hash3(ix, iy, iz, seed), x, y, z);
  const float n100 = grad(hash3(ix + 1, iy, iz, seed), x - 1.0f, y, z);
  const float n010 = grad(hash3(ix, iy + 1, iz, seed), x, y - 1.0f, z);
  const float n110 = grad(hash3(ix + 1, iy + 1, iz, seed), x - 1.0f, y - 1.0f, z);
  const float n001 = grad(hash3(ix, iy, iz + 1, seed), x, y, z - 1.0f);
  const float n101 = grad(hash3(ix + 1, iy, iz + 1, seed), x - 1.0f, y, z - 1.0f);
  const float n011 = grad(hash3(ix, iy + 1, iz + 1, seed), x, y - 1.0f, z - 1.0f);
  const float n111 = grad(hash3(ix + 1, iy + 1, iz + 1, seed), x - 1.0f, y - 1.0f, z - 1.0f);
  return lerp(w,
              lerp(v, lerp(u, n000, n100), lerp(u, n010, n110)),
              lerp(v, lerp(u, n001, n101), lerp(u, n011, n111)));
}

__device__ float marble(float px, float py, float pz, uint32_t seed, float scale) {
  const float z0 = pz;
  float acc = 0.0f;
  float weight = 1.0f;
  for (int k = 0; k < TURBULENCE_DEPTH; ++k) {
    acc = acc + weight * noise3(px, py, pz, seed);
    weight *= 0.5f;
    px = px * 2.0f;
    py = py * 2.0f;
    pz = pz * 2.0f;
  }
  const float turb = fabsf(acc);
  return 0.5f * (1.0f - sinf(scale * z0 + 10.0f * turb));
}

// ---- residual outputs ----------------------------------------------------

// The Pallas kernel's residual planes for one lane, op for op from the
// sweep's result (best_t, best_i, the outward normal wn, the winning
// sphere's 1/r): the hit record, texture value, flags and dielectric
// terms as the Pallas kernel computes them on every lane.  A miss reads
// an all-zero shading row (material 0, ir 0, texture 0).
__device__ void write_residuals(const float* tab, int P, uint32_t seed,
                                int mat_flags, int tex_flags, float ox, float oy,
                                float oz, float dx, float dy, float dz, float a,
                                bool alive, float best_t, int best_i, float wnx,
                                float wny, float wnz, float w_invr, float coin,
                                bool cont, int rr_flag, const Columns& cols,
                                long long i) {
  const bool found = best_i >= 0;
  const bool hit = found & alive;
  const float t = found ? best_t : 1.0f;  // finite t for miss lanes
  const bool front = dx * wnx + dy * wny + dz * wnz < 0.0f;
  const float flip = front ? 1.0f : -1.0f;
  const float nx = wnx * flip, ny = wny * flip, nz = wnz * flip;
  const float px = ox + t * dx, py = oy + t * dy, pz = oz + t * dz;

  const int b = found ? best_i : 0;
  const auto row = [&](int r) { return found ? tab[r * P + b] : 0.0f; };
  const float mk = row(PAY_MKIND), tk = row(PAY_TKIND), ts = row(PAY_TSCALE);
  int flags = (hit ? FLG_HIT : 0) | (front ? FLG_FRONT : 0);

  float v0 = row(PAY_COLOR), v1 = row(PAY_COLOR + 1), v2 = row(PAY_COLOR + 2);
  if ((tex_flags & TEXF_CHECKER) && tk == (float)TEX_CHECKER) {
    const bool pick = sinf(ts * px) * sinf(ts * py) * sinf(ts * pz) < 0.0f;
    flags |= FLG_IS_CK | (pick ? FLG_SINES_NEG : 0);
    const int r0 = pick ? PAY_ODD : PAY_EVEN;
    v0 = row(r0);
    v1 = row(r0 + 1);
    v2 = row(r0 + 2);
  } else if ((tex_flags & TEXF_PERLIN) && tk == (float)TEX_PERLIN) {
    v0 = v1 = v2 = marble(px, py, pz, seed, ts);
  }

  if ((mat_flags & MATF_LIGHT) && hit && mk == (float)MAT_LIGHT && front) {
    flags |= FLG_LIGHT_ON;
  }
  if ((mat_flags & MATF_LAMBERTIAN) && mk == (float)MAT_LAMBERTIAN) flags |= FLG_SEL_L;
  if ((mat_flags & MATF_METAL) && mk == (float)MAT_METAL) flags |= FLG_SEL_M;

  float ratio = 1.0f;
  if (mat_flags & MATF_DIELECTRIC) {  // on every lane, as the Pallas kernel
    const float ir = row(PAY_IR);
    ratio = front ? 1.0f / ir : ir;
    const float inv_len = 1.0f / sqrtf(max_nan(a, SAFE_EPS));
    const float ux = dx * inv_len, uy = dy * inv_len, uz = dz * inv_len;
    const float raw_cos = -(ux * nx + uy * ny + uz * nz);
    const float cos_t = min_nan(raw_cos, 1.0f);
    const float sin_t = sqrtf(max_nan(1.0f - cos_t * cos_t, 0.0f));
    const bool cannot = ratio * sin_t > 1.0f;
    float r0 = (1.0f - ratio) / (1.0f + ratio);
    r0 = r0 * r0;
    const float one_c = 1.0f - cos_t;
    const float one_c2 = one_c * one_c;
    const float one_c5 = one_c * (one_c2 * one_c2);
    const float refl_p = r0 + (1.0f - r0) * one_c5;
    const bool choose_reflect = cannot | (refl_p > coin);
    const float opx = ratio * (ux + cos_t * nx);
    const float opy = ratio * (uy + cos_t * ny);
    const float opz = ratio * (uz + cos_t * nz);
    const float raw_l = 1.0f - (opx * opx + opy * opy + opz * opz);
    const float plen = fabsf(raw_l);
    if (mk == (float)MAT_DIELECTRIC) flags |= FLG_SEL_D;
    if (choose_reflect) flags |= FLG_REFLECT;
    if (raw_cos >= 1.0f) flags |= FLG_COS_CLAMP;
    if (plen <= 0.0f) flags |= FLG_REFR_ZERO;
    if (raw_l < 0.0f) flags |= FLG_L_NEG;
  }
  flags |= (cont ? FLG_CONT : 0) | (alive ? FLG_ALIVE : 0) | rr_flag |
           (b << FLG_BESTI_SHIFT);

  cols.res[0][i] = t;
  cols.res[1][i] = nx;
  cols.res[2][i] = ny;
  cols.res[3][i] = nz;
  cols.res[4][i] = v0;
  cols.res[5][i] = v1;
  cols.res[6][i] = v2;
  cols.res[7][i] = ratio;
  cols.res[8][i] = flip * w_invr;
  cols.flags[i] = flags;
}

// ---- the bounce --------------------------------------------------------

template <bool RES, bool PACKED>
__global__ void __launch_bounds__(THREADS)
fused_bounce_kernel(const float* __restrict__ table, int n_prims,
                    const float* __restrict__ bg, uint32_t seed, float t_min,
                    int mat_flags, int tex_flags, uint32_t bounce, bool roulette,
                    const int* __restrict__ depth, int rr_start, Columns cols,
                    int* __restrict__ winner, long long n) {
  __shared__ float tab[PAY_W * MAX_PRIMS];
  for (int i = threadIdx.x; i < PAY_W * n_prims; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
  const int P = n_prims;
  const float bg0 = bg[0], bg1 = bg[1], bg2 = bg[2];

  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float ox = cols.in[0][i], oy = cols.in[1][i], oz = cols.in[2][i];
    const float dx = cols.in[3][i], dy = cols.in[4][i], dz = cols.in[5][i];
    const float thx = cols.in[6][i], thy = cols.in[7][i], thz = cols.in[8][i];
    float rdx = cols.in[9][i], rdy = cols.in[10][i], rdz = cols.in[11][i];
    const bool alive = cols.in[12][i] > 0.5f;

    // a dead lane keeps its state; alive-out is 0.  With residuals it
    // runs the sweep too: the Pallas kernel's residuals cover every lane.
    if (!RES && !alive) {
      cols.out[0][i] = ox; cols.out[1][i] = oy; cols.out[2][i] = oz;
      cols.out[3][i] = dx; cols.out[4][i] = dy; cols.out[5][i] = dz;
      cols.out[6][i] = thx; cols.out[7][i] = thy; cols.out[8][i] = thz;
      cols.out[9][i] = rdx; cols.out[10][i] = rdy; cols.out[11][i] = rdz;
      cols.out[12][i] = 0.0f;
      if (winner) winner[i] = -1;
      continue;
    }

    // the launch's bounce, or the lane's own path depth (the regen pool,
    // whose lanes are at different depths); roulette acts on the lane from
    // rr_start on
    const uint32_t lane_bounce = depth ? (uint32_t)depth[i] : bounce;
    const bool lane_roulette = roulette && (!depth || depth[i] >= rr_start);
    const Draws<PACKED> draws{cols.key[0][i], cols.key[1][i], lane_bounce};
    // the residuals' dielectric terms take the coin on every lane
    const float res_coin = RES && (mat_flags & MATF_DIELECTRIC) ? draws.coin() : 0.0f;

    // ---- closest-hit sweep --------------------------------------------
    const float a = dx * dx + dy * dy + dz * dz;
    float best_t = T_MISS;
    int best_i = -1;
    float wnx = 0.0f, wny = 0.0f, wnz = 0.0f;
    float w_invr = 0.0f;  // the winning sphere's 1/r (RES only)

    for (int p = 0; p < P; ++p) {
      const int kind = (int)tab[PAY_KIND * P + p];
      float t, nx, ny, nz;
      float cand_invr = 0.0f;
      bool valid;
      if (kind == PRIM_SPHERE) {
        const float cx = tab[0 * P + p], cy = tab[1 * P + p], cz = tab[2 * P + p];
        const float r = tab[3 * P + p];
        // the quadratic in f64, as closest_hit.sphere_roots (the plain
        // version) has it: in f32 half_b^2 - a c cancels on rays that meet
        // a sphere near its rim, and the root can land inside the surface
        const double ocx = (double)ox - (double)cx, ocy = (double)oy - (double)cy,
                     ocz = (double)oz - (double)cz;
        const double dx64 = dx, dy64 = dy, dz64 = dz;
        const double half_b = dx64 * ocx + dy64 * ocy + dz64 * ocz;
        const double c = ocx * ocx + ocy * ocy + ocz * ocz - (double)r * (double)r;
        const double a64 = dx64 * dx64 + dy64 * dy64 + dz64 * dz64;
        const double dis = half_b * half_b - a64 * c;
        const double sqrtd = sqrt((dis != dis || dis > 0.0) ? dis : 0.0);  // NaN-propagating max
        const float root1 = (float)((-half_b - sqrtd) / a64);
        const float root2 = (float)((-half_b + sqrtd) / a64);
        const bool ok1 = (root1 >= t_min) & (root1 <= best_t);
        const bool ok2 = (root2 >= t_min) & (root2 <= best_t);
        t = ok1 ? root1 : root2;
        valid = (dis >= 0.0) & (ok1 | ok2);
        const float inv_r = 1.0f / r;
        cand_invr = inv_r;
        nx = (ox + t * dx - cx) * inv_r;
        ny = (oy + t * dy - cy) * inv_r;
        nz = (oz + t * dz - cz) * inv_r;
      } else if (kind == PRIM_RECT) {
        const int aux = (int)tab[PAY_AUX * P + p];
        const float k = tab[0 * P + p];
        const float a0 = tab[1 * P + p], b0 = tab[2 * P + p];
        const float a1 = tab[3 * P + p], b1 = tab[4 * P + p];
        const float sgn = tab[5 * P + p];
        // fixed axis aux; free axes (fa, fb) in ascending order
        float of, df, oa, da, ob, db;
        if (aux == 0) {
          of = ox; df = dx; oa = oy; da = dy; ob = oz; db = dz;
        } else if (aux == 1) {
          of = oy; df = dy; oa = ox; da = dx; ob = oz; db = dz;
        } else {
          of = oz; df = dz; oa = ox; da = dx; ob = oy; db = dy;
        }
        t = (k - of) / df;
        const float av = oa + t * da;
        const float bv = ob + t * db;
        valid = (t >= t_min) & (t <= best_t) & (av >= a0) & (av <= a1) &
                (bv >= b0) & (bv <= b1);
        nx = aux == 0 ? 1.0f * sgn : 0.0f;
        ny = aux == 1 ? 1.0f * sgn : 0.0f;
        nz = aux == 2 ? 1.0f * sgn : 0.0f;
      } else {  // PRIM_TRIANGLE
        const float p1x = tab[0 * P + p], p1y = tab[1 * P + p], p1z = tab[2 * P + p];
        const float e1x = tab[3 * P + p], e1y = tab[4 * P + p], e1z = tab[5 * P + p];
        const float e2x = tab[6 * P + p], e2y = tab[7 * P + p], e2z = tab[8 * P + p];
        const float pvx = dy * e2z - dz * e2y;
        const float pvy = dz * e2x - dx * e2z;
        const float pvz = dx * e2y - dy * e2x;
        const float det = e1x * pvx + e1y * pvy + e1z * pvz;
        const float inv_det = 1.0f / (fabsf(det) > 1e-30f ? det : 1.0f);
        const float tvx = ox - p1x, tvy = oy - p1y, tvz = oz - p1z;
        const float uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
        const float qvx = tvy * e1z - tvz * e1y;
        const float qvy = tvz * e1x - tvx * e1z;
        const float qvz = tvx * e1y - tvy * e1x;
        const float vv = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
        t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
        valid = (det >= TRI_DET_EPS) & (uu >= 0.0f) & (uu <= 1.0f) & (vv >= 0.0f) &
                (uu + vv <= 1.0f) & (t >= t_min) & (t <= best_t);
        nx = 1.0f * tab[9 * P + p];
        ny = 1.0f * tab[10 * P + p];
        nz = 1.0f * tab[11 * P + p];
      }
      if (valid & (t < best_t)) {
        best_t = t;
        best_i = p;
        wnx = nx;
        wny = ny;
        wnz = nz;
        if (RES) w_invr = cand_invr;
      }
    }

    if (winner) winner[i] = alive ? best_i : -1;

    float o_out0 = ox, o_out1 = oy, o_out2 = oz;
    float d_out0 = dx, d_out1 = dy, d_out2 = dz;
    float t_out0 = thx, t_out1 = thy, t_out2 = thz;
    bool cont = false;

    if (RES && !alive) {
      // dead lane with residuals: the state passes through
    } else if (best_i < 0) {  // miss: bank the background, the lane dies
      rdx = rdx + thx * bg0;
      rdy = rdy + thy * bg1;
      rdz = rdz + thz * bg2;
    } else {
      const float t = best_t;
      // ---- hit record (front-face flip, geometry.rs:29-41) ----------
      const bool front = dx * wnx + dy * wny + dz * wnz < 0.0f;
      const float flip = front ? 1.0f : -1.0f;
      const float nx = wnx * flip, ny = wny * flip, nz = wnz * flip;
      const float px = ox + t * dx, py = oy + t * dy, pz = oz + t * dz;

      const int b = best_i;
      const int mk = (int)tab[PAY_MKIND * P + b];
      const int tk = (int)tab[PAY_TKIND * P + b];
      const float ts = tab[PAY_TSCALE * P + b];

      // ---- texture value --------------------------------------------
      float v0 = tab[(PAY_COLOR + 0) * P + b];
      float v1 = tab[(PAY_COLOR + 1) * P + b];
      float v2 = tab[(PAY_COLOR + 2) * P + b];
      if ((tex_flags & TEXF_CHECKER) && tk == TEX_CHECKER) {
        const float sines = sinf(ts * px) * sinf(ts * py) * sinf(ts * pz);
        const int row = sines < 0.0f ? PAY_ODD : PAY_EVEN;
        v0 = tab[(row + 0) * P + b];
        v1 = tab[(row + 1) * P + b];
        v2 = tab[(row + 2) * P + b];
      } else if ((tex_flags & TEXF_PERLIN) && tk == TEX_PERLIN) {
        const float gray = marble(px, py, pz, seed, ts);
        v0 = gray;
        v1 = gray;
        v2 = gray;
      }

      // ---- emission banking (ray.rs:26) -----------------------------
      if ((mat_flags & MATF_LIGHT) && mk == MAT_LIGHT && front) {
        rdx = rdx + thx * v0;
        rdy = rdy + thy * v1;
        rdz = rdz + thz * v2;
      }

      // ---- scatter (materials.py op for op) --------------------------
      float sdx = 0.0f, sdy = 0.0f, sdz = 0.0f;
      float at0 = 0.0f, at1 = 0.0f, at2 = 0.0f;
      if ((mat_flags & MATF_LAMBERTIAN) && mk == MAT_LAMBERTIAN) {
        float su0, su1;
        draws.lambert(su0, su1);
        const float s_z = 2.0f * su0 - 1.0f;
        const float s_phi = TWO_PI * su1;
        const float s_r = sqrtf(max_nan(1.0f - s_z * s_z, 0.0f));
        float dlx = nx + s_r * cosf(s_phi);
        float dly = ny + s_r * sinf(s_phi);
        float dlz = nz + s_z;
        if ((fabsf(dlx) < NEAR_ZERO) & (fabsf(dly) < NEAR_ZERO) & (fabsf(dlz) < NEAR_ZERO)) {
          dlx = nx;
          dly = ny;
          dlz = nz;
        }
        cont = true;
        sdx = dlx; sdy = dly; sdz = dlz;
        at0 = v0; at1 = v1; at2 = v2;
      } else if ((mat_flags & MATF_METAL) && mk == MAT_METAL) {
        const float inv_len = 1.0f / sqrtf(max_nan(a, SAFE_EPS));
        const float ux = dx * inv_len, uy = dy * inv_len, uz = dz * inv_len;
        float bu0, bu1, bu2;
        draws.fuzz(bu0, bu1, bu2);
        const float b_z = 2.0f * bu0 - 1.0f;
        const float b_phi = TWO_PI * bu1;
        const float b_rho = sqrtf(max_nan(1.0f - b_z * b_z, 0.0f));
        // the cube root as the plain version takes it (vecmath.cbrt: the
        // f64 power rounded to f32), where cbrtf may differ by an ulp
        const float b_s = (float)pow((double)bu2, 1.0 / 3.0);
        const float ball_x = b_rho * cosf(b_phi) * b_s;
        const float ball_y = b_rho * sinf(b_phi) * b_s;
        const float ball_z = b_z * b_s;
        const float dn = ux * nx + uy * ny + uz * nz;
        const float rfx = ux - 2.0f * dn * nx;
        const float rfy = uy - 2.0f * dn * ny;
        const float rfz = uz - 2.0f * dn * nz;
        const float fz = tab[PAY_FUZZ * P + b];
        cont = rfx * nx + rfy * ny + rfz * nz > 0.0f;  // absorbed at grazing
        sdx = rfx + fz * ball_x;
        sdy = rfy + fz * ball_y;
        sdz = rfz + fz * ball_z;
        at0 = v0; at1 = v1; at2 = v2;
      } else if ((mat_flags & MATF_DIELECTRIC) && mk == MAT_DIELECTRIC) {
        const float inv_len = 1.0f / sqrtf(max_nan(a, SAFE_EPS));
        const float ux = dx * inv_len, uy = dy * inv_len, uz = dz * inv_len;
        const float ir = tab[PAY_IR * P + b];
        const float ratio = front ? 1.0f / ir : ir;
        const float raw_cos = -(ux * nx + uy * ny + uz * nz);
        const float cos_t = min_nan(raw_cos, 1.0f);
        const float sin_t = sqrtf(max_nan(1.0f - cos_t * cos_t, 0.0f));
        const bool cannot = ratio * sin_t > 1.0f;
        float r0 = (1.0f - ratio) / (1.0f + ratio);
        r0 = r0 * r0;                                  // XLA integer_pow(2)
        const float one_c = 1.0f - cos_t;
        const float one_c2 = one_c * one_c;
        const float one_c5 = one_c * (one_c2 * one_c2);  // XLA integer_pow(5)
        const float refl_p = r0 + (1.0f - r0) * one_c5;
        const bool choose_reflect = cannot | (refl_p > (RES ? res_coin : draws.coin()));
        if (choose_reflect) {
          const float dnu = ux * nx + uy * ny + uz * nz;
          sdx = ux - 2.0f * dnu * nx;
          sdy = uy - 2.0f * dnu * ny;
          sdz = uz - 2.0f * dnu * nz;
        } else {  // refract (vec3.rs:118-127 via vecmath.refract)
          const float opx = ratio * (ux + cos_t * nx);
          const float opy = ratio * (uy + cos_t * ny);
          const float opz = ratio * (uz + cos_t * nz);
          const float plen = fabsf(1.0f - (opx * opx + opy * opy + opz * opz));
          const float par = -(plen <= 0.0f ? 0.0f : sqrtf(plen));  // safe_sqrt
          sdx = opx + par * nx;
          sdy = opy + par * ny;
          sdz = opz + par * nz;
        }
        cont = true;
        at0 = 1.0f; at1 = 1.0f; at2 = 1.0f;
      }
      // a light absorbs: cont stays false

      // ---- state commit ---------------------------------------------
      if (cont) {
        t_out0 = thx * at0; t_out1 = thy * at1; t_out2 = thz * at2;
        o_out0 = px; o_out1 = py; o_out2 = pz;
        d_out0 = sdx; d_out1 = sdy; d_out2 = sdz;
      }
    }

    // ---- russian roulette (integrator.py:845-869), from rr_start on:
    // p = clip(max throughput, 0.05, 1); a continuing lane survives when
    // its uniform is below p, boosted by 1/p, else it dies ----------------
    bool alive_out = cont;
    int rr_flag = 0;
    if (lane_roulette) {
      const float m = max2_nan(max2_nan(t_out0, t_out1), t_out2);
      const float p = m != m ? m : fminf(fmaxf(m, RR_P_MIN), RR_P_MAX);
      const bool act = cont && draws.roulette() < p;
      if (act) {
        t_out0 = t_out0 / p;
        t_out1 = t_out1 / p;
        t_out2 = t_out2 / p;
      }
      alive_out = act;
      if (RES) {
        cols.rr_p[i] = p;
        rr_flag = act ? FLG_RR_ACT : 0;
      }
    }

    cols.out[0][i] = o_out0; cols.out[1][i] = o_out1; cols.out[2][i] = o_out2;
    cols.out[3][i] = d_out0; cols.out[4][i] = d_out1; cols.out[5][i] = d_out2;
    cols.out[6][i] = t_out0; cols.out[7][i] = t_out1; cols.out[8][i] = t_out2;
    cols.out[9][i] = rdx; cols.out[10][i] = rdy; cols.out[11][i] = rdz;
    cols.out[12][i] = alive_out ? 1.0f : 0.0f;

    if (RES) {
      write_residuals(tab, P, seed, mat_flags, tex_flags, ox, oy, oz, dx, dy, dz, a,
                      alive, best_t, best_i, wnx, wny, wnz, w_invr, res_coin, cont,
                      rr_flag, cols, i);
    }
  }
}

}  // namespace

extern "C" {

// Launch K1 on `stream`.  Every pointer is a device pointer to rows of
// n_lanes: `table` (32, n_prims) f32, `bg` (3,) f32; `in` the 13 state
// rows (o0 o1 o2 d0 d1 d2 t0 t1 t2 r0 r1 r2 al); `keys` the lane key's
// two uint32 rows, from which the lanes draw `bounce`'s uniforms;
// `roulette` applies russian roulette after the bounce; `packed` (0 or 1)
// picks the draws' scheme.  `depth`, NULL for
// none, gives each lane its own bounce (an int32 row: the lane's path
// depth), and roulette then acts on the lanes whose depth is at least
// `rr_start`; it takes no `res`.  `out` the 13 new state rows.  `res`,
// NULL for none, receives the nine f32 residual rows (t nx ny nz v0 v1
// v2 ratio invr) and, with `roulette`, roulette's p as a tenth; `flags`
// (with `res`) the int32 flags.  `winner`, optional (NULL for none),
// receives each alive lane's winning primitive, -1 on a miss or a dead
// lane.  Returns cudaGetLastError() of the launch: nonzero means it
// never ran.
int fused_bounce_launch(const float* table, int n_prims, const float* bg,
                        unsigned int seed, float t_min, int mat_flags,
                        int tex_flags, const float* in, const unsigned int* keys,
                        unsigned int bounce, int roulette, int packed, const int* depth,
                        int rr_start, float* out, float* res, int* flags, int* winner,
                        long long n_lanes, void* stream) {
  if (n_prims <= 0 || n_prims > MAX_PRIMS || n_lanes < 0 || !keys || (res && !flags) ||
      (res && depth)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_lanes == 0) return (int)cudaSuccess;
  Columns cols{};
  for (int k = 0; k < N_IN; ++k) cols.in[k] = in + k * n_lanes;
  for (int k = 0; k < 2; ++k) cols.key[k] = keys + k * n_lanes;
  for (int k = 0; k < N_OUT; ++k) cols.out[k] = out + k * n_lanes;
  for (int k = 0; k < N_RES; ++k) cols.res[k] = res ? res + k * n_lanes : nullptr;
  cols.flags = res ? flags : nullptr;
  cols.rr_p = res && roulette ? res + N_RES * n_lanes : nullptr;
  long long blocks = (n_lanes + THREADS - 1) / THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride past 16 blocks per SM
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)blocks);
  const bool rr = roulette != 0;
#define RPT_K1(RES_, PACKED_)                                                     \
  fused_bounce_kernel<RES_, PACKED_><<<grid, THREADS, 0, s>>>(                    \
      table, n_prims, bg, (uint32_t)seed, t_min, mat_flags, tex_flags,            \
      (uint32_t)bounce, rr, depth, rr_start, cols, winner, n_lanes)
  if (res && packed) {
    RPT_K1(true, true);
  } else if (res) {
    RPT_K1(true, false);
  } else if (packed) {
    RPT_K1(false, true);
  } else {
    RPT_K1(false, false);
  }
#undef RPT_K1
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
