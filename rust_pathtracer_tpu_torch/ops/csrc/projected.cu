// K5, K6 and K7: the closest hit over the projected tables of a big scene,
// for NVIDIA Hopper (sm_90a).
//
// The three replace three Pallas kernels that compute one function:
//   K5 (mode 0, "dense")    rust_pathtracer_tpu/ops/projected.py::_kernel
//   K6 (mode 1, "resident") rust_pathtracer_tpu/ops/resident.py::_res_kernel
//   K7 (mode 2, "pairs")    rust_pathtracer_tpu/ops/worklist.py::_pair_kernel
// Per lane: the closest hit over the projected columns, its column (-1 on a
// miss), t (T_MISS on a miss) and the winner's 32-word payload row (zeros on
// a miss).  The plain PyTorch versions are projected_sweep_plain,
// resident_sweep_plain and pair_sweep_plain (../projected.py, ../resident.py,
// ../worklist.py), all three one function, _sweep_plain.
//
// The sweep, one thread per lane: clusters (128-column groups, one primitive
// type each) in ascending order; for each, the lane's slab test against the
// cluster's AABB (entry clamped at t_min, exit at the lane's running best);
// on a pass, the group's own formula on its 128 columns, the group minimum
// at its lowest column, and a strict t < best take.  The modes differ only
// in which clusters a lane visits and in two rules of their Pallas kernels:
//   K5: every cluster; spheres compare in q = t |d|^2 where qflags says so
//       (the slot is sphere or padding in every p-block), else in t;
//   K6: the first counts[block] packed slots (cid * 4 + kind) of the lane's
//       block of rb lanes; spheres always in q; an equal t at a lower column
//       is taken too (resident.py:159);
//   K7: the kcap slots (cid row, kind row, kind -1 empty) of the block;
//       spheres always in q.
// The per-lane cull is conservative and the tie-break a no-op in ascending
// order, so on a single-p-block table the three agree bit for bit.
//
// The projections are the 8-term products [ox oy oz dx dy dz 1 0] . a[j][.][c]
// summed k = 0..7 in order, built with --fmad=false and without fast math, so
// every f32 operation rounds as the plain version's does; max / min
// propagate NaN as jnp.maximum / minimum; sqrtf and the divisions are IEEE.
//
// What bounds it on the card: per lane 24 B of rays in, 136 B out (t,
// column, payload); per visited column a sphere costs about 40 f32
// operations (two projections of 8 products and 7 sums, the half-b
// quadratic), a rect or triangle about 110 (six projections, the plane or
// Woop solve), and each visited cluster a slab test of about 20.  A
// camera-ray sweep of SphereField or ModelTest is bound by its operations.
// Design, simple and right first: the tables stay in global memory (L2-
// resident: 3.6 MB at 10,240 columns; every lane of a warp reads the same
// column, a broadcast); the worklist blocks are warps, so the slot loads are
// uniform.  Later work: stage a cluster's columns in shared memory, sweep
// only the projection rows a type needs, compact the lanes that pass.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GROUP = 128;
constexpr int PAY_W = 32;
constexpr int PRIM_SPHERE = 0, PRIM_RECT = 1;
constexpr int MODE_DENSE = 0, MODE_RESIDENT = 1, MODE_PAIRS = 2;
constexpr int THREADS = 128;

constexpr float T_MISS = 3.0e38f;
constexpr float TRI_DET_EPS = 1e-4f;
constexpr float TINY = 1e-30f;

struct Tables {
  const float* a;        // (3, 8, C) origin projections
  const float* b;        // (3, 8, C) direction projections
  const float* k;        // (8, C) per-column constants
  const float* payload;  // (C, 32)
  const float* bounds;   // (6, G) cluster AABBs: min xyz, max xyz
  const int* kinds;      // (G,) cluster kind, -1 = padding
  const int* qflags;     // (G,) K5: compare this sphere cluster in q
  int C, G;
};

struct Slots {
  const int* words;   // K6: (W,) cid * 4 + kind; K7: (2, W) cid row, kind row
  const int* counts;  // K6: (nblocks,) real slots a block
  int kcap;           // slots a block
  int rb;             // lanes a block
  long long W;
};

// jnp.maximum / jnp.minimum: NaN in, NaN out
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

// rays . m[j][.][c], the 8 terms in order, one multiply and one add each
__device__ __forceinline__ float proj(const float* __restrict__ m, int C, int j, int c,
                                      const float r[8]) {
  const float* p = m + (size_t)j * 8 * C + c;
  float acc = r[0] * p[0];
#pragma unroll
  for (int kk = 1; kk < 8; ++kk) acc = acc + r[kk] * p[(size_t)kk * C];
  return acc;
}

struct Lane {
  float r[8];
  float o[3], inv_d[3];
  float onorm, odot, dnorm, t_min, tmin_a;
};

// The slab test of cluster g at the running best tb.
__device__ __forceinline__ bool slab_pass(const Tables& T, int g, const Lane& L,
                                          float tb) {
  float lo = L.t_min, hi = T_MISS;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float b0 = (T.bounds[ax * T.G + g] - L.o[ax]) * L.inv_d[ax];
    const float b1 = (T.bounds[(3 + ax) * T.G + g] - L.o[ax]) * L.inv_d[ax];
    lo = nan_max(lo, nan_min(b0, b1));
    hi = nan_min(hi, nan_max(b0, b1));
  }
  return nan_min(hi, tb) >= lo;
}

// The group minimum of cluster g (q or t domain) and its lowest column.
__device__ __forceinline__ void sweep_group(const Tables& T, int g, int kind, bool q,
                                            const Lane& L, float& best, int& bj) {
  best = T_MISS;
  bj = 0;
  const int C = T.C;
  for (int j = 0; j < GROUP; ++j) {
    const int c = g * GROUP + j;
    const float k0 = T.k[c];
    float val;
    bool valid;
    if (kind == PRIM_SPHERE) {
      const float O0 = proj(T.a, C, 0, c, L.r);
      const float D0 = proj(T.b, C, 0, c, L.r);
      const float half_b = L.odot - D0;
      const float cterm = L.onorm - 2.0f * O0 + k0;
      const float dis = half_b * half_b - L.dnorm * cterm;
      const float sqrtd = sqrtf((dis != dis || dis > 0.0f) ? dis : 0.0f);
      float r1, r2, lim;
      if (q) {
        r1 = -half_b - sqrtd;
        r2 = -half_b + sqrtd;
        lim = L.tmin_a;
      } else {
        r1 = (-half_b - sqrtd) / L.dnorm;
        r2 = (-half_b + sqrtd) / L.dnorm;
        lim = L.t_min;
      }
      const bool ok1 = r1 >= lim;
      val = ok1 ? r1 : r2;
      valid = (dis >= 0.0f) & (ok1 | (r2 >= lim));
    } else {
      const float O0 = proj(T.a, C, 0, c, L.r), O1 = proj(T.a, C, 1, c, L.r);
      const float O2 = proj(T.a, C, 2, c, L.r);
      const float D0 = proj(T.b, C, 0, c, L.r), D1 = proj(T.b, C, 1, c, L.r);
      const float D2 = proj(T.b, C, 2, c, L.r);
      val = -O0 / D0;  // NaN / inf when parallel: the bounds tests fail
      const float u = O1 + val * D1;
      const float v = O2 + val * D2;
      if (kind == PRIM_RECT) {
        valid = (val >= L.t_min) & (u >= k0) & (u <= T.k[C + c]) &
                (v >= T.k[2 * C + c]) & (v <= T.k[3 * C + c]);
      } else {  // triangle: det = d . -n, the one-sided cull
        const float det = -D0 * k0;
        valid = (det >= TRI_DET_EPS) & (u >= 0.0f) & (u <= 1.0f) & (v >= 0.0f) &
                (u + v <= 1.0f) & (val >= L.t_min);
      }
    }
    const float tv = valid ? val : T_MISS;
    if (tv < best) {
      best = tv;
      bj = j;
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
projected_kernel(Tables T, Slots S, const float* __restrict__ o,
                 const float* __restrict__ d, float t_min, float* __restrict__ t_out,
                 int* __restrict__ c_out, float* __restrict__ pay_out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Lane L;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  L.r[0] = ox; L.r[1] = oy; L.r[2] = oz;
  L.r[3] = dx; L.r[4] = dy; L.r[5] = dz;
  L.r[6] = 1.0f; L.r[7] = 0.0f;
  L.o[0] = ox; L.o[1] = oy; L.o[2] = oz;
  L.onorm = ox * ox + oy * oy + oz * oz;
  L.odot = ox * dx + oy * dy + oz * dz;
  L.dnorm = dx * dx + dy * dy + dz * dz;
  L.t_min = t_min;
  L.tmin_a = t_min * L.dnorm;
  const float dd[3] = {dx, dy, dz};
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float x = dd[ax];
    const float ds = fabsf(x) < TINY ? (x < 0.0f ? -TINY : TINY) : x;
    L.inv_d[ax] = 1.0f / ds;
  }

  float tb = T_MISS;
  int cb = -1;
  auto visit = [&](int g, int kind, bool q) {
    if (!slab_pass(T, g, L, tb)) return;
    float raw;
    int bj;
    sweep_group(T, g, kind, q, L, raw, bj);
    const float gt = q ? (raw >= T_MISS ? T_MISS : raw / L.dnorm) : raw;
    const int gcol = g * GROUP + bj;
    bool take = gt < tb;
    if (MODE == MODE_RESIDENT) take = take | ((gt == tb) & (gcol < cb));
    if (take) {
      tb = gt;
      cb = gcol;
    }
  };

  if (MODE == MODE_DENSE) {
    for (int g = 0; g < T.G; ++g) {
      const int kind = T.kinds[g];
      if (kind >= 0) visit(g, kind, T.qflags[g] != 0);
    }
  } else {
    const long long blk = i / S.rb;
    const long long base = blk * S.kcap;
    if (MODE == MODE_RESIDENT) {
      const int cnt = S.counts[blk];
      for (int j = 0; j < cnt; ++j) {
        const int w = S.words[base + j];
        const int kind = w & 3;
        visit((int)((unsigned)w >> 2), kind, kind == PRIM_SPHERE);
      }
    } else {
      for (int j = 0; j < S.kcap; ++j) {
        const int kind = S.words[S.W + base + j];
        if (kind >= 0) visit(S.words[base + j], kind, kind == PRIM_SPHERE);
      }
    }
  }

  const bool hit = cb >= 0;
  t_out[i] = hit ? tb : T_MISS;
  c_out[i] = cb;
  const float* row = T.payload + (size_t)(hit ? cb : 0) * PAY_W;
  float* out = pay_out + (size_t)i * PAY_W;
#pragma unroll 8
  for (int w = 0; w < PAY_W; ++w) out[w] = hit ? row[w] : 0.0f;
}

}  // namespace

extern "C" {

// Launch K5 (mode 0), K6 (mode 1) or K7 (mode 2) on `stream`.  `tab_ptrs` is
// a HOST array of 7 device pointers: a, b, const, payload, cluster bounds
// (f32), cluster kinds, K5 q flags (int32); C columns, G = C / 128 clusters.
// `words` / `counts` / `kcap` / `rb` / `W`: the worklist of K6 (packed words,
// counts) or K7 (the (2, W) slot table; counts unused); unused by K5.
// `o`, `d`: (n_lanes, 3) f32; outputs t (f32), column (int32), payload
// (n_lanes, 32) f32.  Returns cudaGetLastError() of the launch.
int projected_launch(int mode, void* const* tab_ptrs, int C, int G, const int* words,
                     const int* counts, int kcap, int rb, long long W, const float* o,
                     const float* d, float t_min, float* t_out, int* c_out,
                     float* pay_out, long long n_lanes, void* stream) {
  if (mode < MODE_DENSE || mode > MODE_PAIRS || C <= 0 || C != G * GROUP ||
      n_lanes < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (mode != MODE_DENSE &&
      (words == nullptr || kcap <= 0 || rb <= 0 ||
       (mode == MODE_RESIDENT && counts == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_lanes == 0) return (int)cudaSuccess;
  Tables T;
  T.a = static_cast<const float*>(tab_ptrs[0]);
  T.b = static_cast<const float*>(tab_ptrs[1]);
  T.k = static_cast<const float*>(tab_ptrs[2]);
  T.payload = static_cast<const float*>(tab_ptrs[3]);
  T.bounds = static_cast<const float*>(tab_ptrs[4]);
  T.kinds = static_cast<const int*>(tab_ptrs[5]);
  T.qflags = static_cast<const int*>(tab_ptrs[6]);
  T.C = C;
  T.G = G;
  Slots S{words, counts, kcap, rb, W};
  const long long blocks = (n_lanes + THREADS - 1) / THREADS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == MODE_DENSE) {
    projected_kernel<MODE_DENSE><<<(unsigned)blocks, THREADS, 0, s>>>(
        T, S, o, d, t_min, t_out, c_out, pay_out, n_lanes);
  } else if (mode == MODE_RESIDENT) {
    projected_kernel<MODE_RESIDENT><<<(unsigned)blocks, THREADS, 0, s>>>(
        T, S, o, d, t_min, t_out, c_out, pay_out, n_lanes);
  } else {
    projected_kernel<MODE_PAIRS><<<(unsigned)blocks, THREADS, 0, s>>>(
        T, S, o, d, t_min, t_out, c_out, pay_out, n_lanes);
  }
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
