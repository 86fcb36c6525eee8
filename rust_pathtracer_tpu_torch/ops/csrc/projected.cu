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
// The sweep: clusters (128-column groups, one primitive type each) in
// ascending order; for each, the lane's slab test against the cluster's AABB
// (entry clamped at t_min, exit at the lane's running best); on a pass, the
// group's own formula on its 128 columns, the group minimum at its lowest
// column, and the take.  The modes differ only in which clusters a lane
// visits and in two rules of their Pallas kernels:
//   K5: every cluster; spheres compare in q = t |d|^2 where qflags says so
//       (the slot is sphere or padding in every p-block), else in t;
//   K6: every cluster; spheres always in q; an equal t at a lower column is
//       taken too (resident.py:159; a no-op in ascending order);
//   K7: the kcap slots (cid row, kind row, kind -1 empty) of the block;
//       spheres always in q.
// The TPU's K6 sweeps the slots its block lists, because a grid step needs
// a static slot list; here the warp's ballot below is that list, per warp.
// A lane sweeps a cluster only where its own slab test passes at its
// running best (nan_min(hi, tb) >= lo, which implies hi >= lo, the test
// that lists the cluster for its block), so the block list removed nothing
// the lane's own test keeps: K6 without it is the same sweep bit for bit.
// The per-lane cull is conservative and the tie-break a no-op in ascending
// order, so on a single-p-block table the three agree bit for bit.
//
// The projections are the 8-term products [ox oy oz dx dy dz 1 0] . a[j][.][c]
// summed k = 0..7 in order; the kernels sum only each type's nonzero terms,
// in that order, and add +0: for finite rays the dense sum bit for bit
// (../projected.py, module note).  Built with --fmad=false and without fast
// math, so every f32 operation rounds as the plain version's does; max / min
// propagate NaN as jnp.maximum / minimum; sqrtf and the divisions are IEEE.
// A sphere's quadratic runs in f64 (column_value), rounded to f32 at the
// roots, as the plain version's does.
//
// What bounds it on the card.  Per lane 24 B of rays in and 136 B out (t,
// column, payload); per swept column the operations of its type's
// formula (chip_smoke.cluster_ops: 21 f64 a sphere, ~6 f32 a rect, ~40 a
// triangle), per visited cluster a slab test of 12.  The work depends on
// the data: which clusters each lane's slab test passes.  A dense per-lane
// sweep is bound by instructions: 8 scalar loads a projection
// (17 a sphere column, 49-52 a rect or triangle) and a whole warp on a
// cluster when one lane passes it (on incoherent lanes 1-12 do).  The
// kernels do three things about it:
//   * compact rows: each column's nonzero coefficients in four 16-byte
//     quads (ProjTables.rows, (G, 4, 128, 4): quad q of column j of
//     cluster g at [g][q][j]), one quad a sphere, three a rect, four a
//     triangle; a cluster's AABB as two quads (ProjTables.bounds8).  A
//     column costs a lane 1-4 16-byte loads and only its type's terms; a
//     triangle whose one-sided det test fails skips its division;
//   * the visit, per warp: each lane's slab test at its running best, then
//     __ballot_sync.  A cluster no lane passes is skipped, rows unread.
//     With at least COOP_P lanes passing, each passing lane sweeps the 128
//     columns itself; with fewer, the warp sweeps for one passing lane at
//     a time: its ray broadcast by __shfl_sync, thread j on columns j,
//     j + 32, j + 64, j + 96, then a (value, column) minimum over the warp
//     with ties to the lower column, and the owning lane's take.  No valid
//     value is NaN, so that minimum is the sequential strict-< scan's
//     result bit for bit (tests/test_torch_projected_rows.py emulates it);
//   * where a visit reads the rows: each warp copies the cluster's quads
//     into its own 8 KB of shared memory with cp.async when its ballot
//     passes (16 coalesced 16-byte copies a lane for a triangle cluster),
//     then sweeps from there.  On the card this beat 16-byte loads through
//     L1 and, for K5, a block stage filled a cluster ahead (PERF.md gives
//     the times and the choice of COOP_P).
// No tensor cores: bit parity with the plain version rules out TF32, and a
// projection of 3-4 nonzero coefficients is no matrix product for wgmma.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GROUP = 128;
constexpr int PAY_W = 32;
constexpr int PRIM_SPHERE = 0, PRIM_RECT = 1, PRIM_TRIANGLE = 2;
constexpr int MODE_DENSE = 0, MODE_RESIDENT = 1, MODE_PAIRS = 2;
constexpr int THREADS = 128;
constexpr int WARP = 32;
constexpr int QUADS = 4;  // 16-byte quads of a column's row
constexpr unsigned FULL = 0xffffffffu;
// per-lane sweep from this many passing lanes of a warp, cooperative below
// (the card's choice, PERF.md; projected.COOP_P on the Python side)
constexpr int COOP_P = 24;

constexpr float T_MISS = 3.0e38f;
constexpr float TRI_DET_EPS = 1e-4f;
constexpr float TINY = 1e-30f;

struct Tables {
  const float* payload;  // (C, 32)
  const int* kinds;      // (G,) cluster kind, -1 = padding
  const int* qflags;     // (G,) K5: compare this sphere cluster in q
  const float4* rows;    // (G, 4, 128) quads: the compact rows
  const float4* bounds8; // (G, 2) quads: min xyz, max xyz
  int C, G;
};

struct Slots {          // K7's
  const int* words;     // (2, W): cid row, kind row
  int kcap;             // slots a block
  int rb;               // lanes a block
  long long W;
};

// jnp.maximum / jnp.minimum: NaN in, NaN out
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

// A lane's ray and what its formulas read.
struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float dnorm, tmin_a;
  double dnorm64;  // |d|^2 in f64, a sphere's quadratic's a
};

__device__ __forceinline__ Ray shfl_ray(const Ray& R, int src) {
  Ray S;
  S.ox = __shfl_sync(FULL, R.ox, src);
  S.oy = __shfl_sync(FULL, R.oy, src);
  S.oz = __shfl_sync(FULL, R.oz, src);
  S.dx = __shfl_sync(FULL, R.dx, src);
  S.dy = __shfl_sync(FULL, R.dy, src);
  S.dz = __shfl_sync(FULL, R.dz, src);
  S.dnorm = __shfl_sync(FULL, R.dnorm, src);
  S.tmin_a = __shfl_sync(FULL, R.tmin_a, src);
  S.dnorm64 = __shfl_sync(FULL, R.dnorm64, src);
  return S;
}

// One column's value for one ray: t (q = t |d|^2 for a sphere compared in
// the q domain) where the column is hit, else T_MISS.  ``p`` points at the
// column's quad 0 in the warp's stage; quad q is q * GROUP quads on.  The
// projections sum the nonzero terms in the dense order and add +0; the
// formulas past them are _group_values's (../projected.py), operation for
// operation.
template <int KIND, bool Q>
__device__ __forceinline__ float column_value(const float4* p, const Ray& R,
                                              float t_min) {
  if constexpr (KIND == PRIM_SPHERE) {
    // The quadratic in f64 on the f32 ray and row (its discriminant as
    // ../closest_hit.py sphere_roots takes it; a = |d|^2 once a lane, in
    // the Ray), the q-domain roots rounded to f32; _sphere_values
    // (../projected.py) runs the same operations.  In f32 the expanded
    // |o|^2 - 2 o.c + K0 cancels where a ray leaves a sphere's surface or
    // grazes it, and a root then lands past t_min on a sphere that f64
    // says the ray misses.
    const float4 c = p[0];  // centre, radius (NaN on padding: every test fails)
    const double ocx = (double)R.ox - (double)c.x;
    const double ocy = (double)R.oy - (double)c.y;
    const double ocz = (double)R.oz - (double)c.z;
    const double dx = R.dx, dy = R.dy, dz = R.dz, r = c.w;
    const double half_b = (dx * ocx + dy * ocy) + dz * ocz;
    const double cterm = ((ocx * ocx + ocy * ocy) + ocz * ocz) - r * r;
    const double dis = half_b * half_b - R.dnorm64 * cterm;
    const double sqrtd = sqrt((dis != dis || dis > 0.0) ? dis : 0.0);
    // the q-domain roots; in the t domain each is divided by |d|^2 in f32,
    // as the q domain divides its winner, so both domains give a sphere hit
    // the same bits (K5 compares some streamed clusters in t, K7 in q)
    float r1 = (float)(-half_b - sqrtd), r2 = (float)(-half_b + sqrtd), lim;
    if constexpr (Q) {
      lim = R.tmin_a;
    } else {
      r1 = r1 / R.dnorm;
      r2 = r2 / R.dnorm;
      lim = t_min;
    }
    const bool ok1 = r1 >= lim;
    const float val = ok1 ? r1 : r2;
    const bool valid = (dis >= 0.0) & (ok1 | (r2 >= lim));
    return valid ? val : T_MISS;
  } else if constexpr (KIND == PRIM_RECT) {
    // (f, A[0,6], K0, K1), (K2, K3, A[0,f], A[1,fa]), (A[2,fb], B[0,3+f],
    // B[1,3+fa], B[2,3+fb]); the free axes (fa, fb) of f: (1,2), (0,2), (0,1)
    const float4 q0 = p[0], q1 = p[GROUP];
    const float4 q2 = p[2 * GROUP];
    const int f = (int)q0.x;
    const float of = f == 0 ? R.ox : (f == 1 ? R.oy : R.oz);
    const float df = f == 0 ? R.dx : (f == 1 ? R.dy : R.dz);
    const float oa = f == 0 ? R.oy : R.ox, da = f == 0 ? R.dy : R.dx;
    const float ob = f == 2 ? R.oy : R.oz, db = f == 2 ? R.dy : R.dz;
    const float O0 = (of * q1.z + q0.y) + 0.0f;
    const float O1 = oa * q1.w + 0.0f;
    const float O2 = ob * q2.x + 0.0f;
    const float D0 = df * q2.y + 0.0f;
    const float D1 = da * q2.z + 0.0f;
    const float D2 = db * q2.w + 0.0f;
    const float val = -O0 / D0;  // NaN / inf when parallel: the bounds tests fail
    const float u = O1 + val * D1;
    const float v = O2 + val * D2;
    const bool valid = (val >= t_min) & (u >= q0.z) & (u <= q0.w) & (v >= q1.x) &
                       (v <= q1.y);
    return valid ? val : T_MISS;
  } else {  // triangle: (w_j, c_j) for j = 0, 1, 2, then (K0, 0, 0, 0)
    const float4 w0 = p[0];
    const float k0 = p[3 * GROUP].x;
    const float D0 = ((R.dx * w0.x + R.dy * w0.y) + R.dz * w0.z) + 0.0f;
    const float det = -D0 * k0;  // d . -n, the one-sided cull
    if (!(det >= TRI_DET_EPS)) return T_MISS;
    const float4 w1 = p[GROUP], w2 = p[2 * GROUP];
    const float O0 = (((R.ox * w0.x + R.oy * w0.y) + R.oz * w0.z) + w0.w) + 0.0f;
    const float O1 = (((R.ox * w1.x + R.oy * w1.y) + R.oz * w1.z) + w1.w) + 0.0f;
    const float O2 = (((R.ox * w2.x + R.oy * w2.y) + R.oz * w2.z) + w2.w) + 0.0f;
    const float D1 = ((R.dx * w1.x + R.dy * w1.y) + R.dz * w1.z) + 0.0f;
    const float D2 = ((R.dx * w2.x + R.dy * w2.y) + R.dz * w2.z) + 0.0f;
    const float val = -O0 / D0;
    const float u = O1 + val * D1;
    const float v = O2 + val * D2;
    const bool valid = (u >= 0.0f) & (u <= 1.0f) & (v >= 0.0f) & (u + v <= 1.0f) &
                       (val >= t_min);
    return valid ? val : T_MISS;
  }
}

// The take: the group minimum (in the q domain divided by |d|^2 once)
// replaces the running best on a strictly smaller t (K5, K7), or with TIE
// (K6) also on an equal t at a lower column (resident.py:159; in ascending
// order never true, kept as K6's rule).
template <bool Q, bool TIE>
__device__ __forceinline__ void take(float raw, int bj, int g, const Ray& R, float& tb,
                                     int& cb) {
  const float gt = Q ? (raw >= T_MISS ? T_MISS : raw / R.dnorm) : raw;
  const int gcol = g * GROUP + bj;
  if (gt < tb || (TIE && gt == tb && gcol < cb)) {
    tb = gt;
    cb = gcol;
  }
}

// The warp's visit to cluster g, whose rows start at ``base``: ``mask``
// holds the lanes whose slab test passed (non-zero, the same in every lane).
template <int KIND, bool Q, bool TIE>
__device__ __forceinline__ void visit_cluster(const float4* base, unsigned mask, int lane,
                                              int g, const Ray& R, float t_min,
                                              float& tb, int& cb) {
  if (__popc(mask) >= COOP_P) {  // per lane: each passing lane sweeps the cluster
    if (!((mask >> lane) & 1u)) return;
    float raw = T_MISS;
    int bj = 0;
    for (int j = 0; j < GROUP; ++j) {
      const float v = column_value<KIND, Q>(base + j, R, t_min);
      if (v < raw) {
        raw = v;
        bj = j;
      }
    }
    take<Q, TIE>(raw, bj, g, R, tb, cb);
    return;
  }
  // warp-cooperative: the warp sweeps for one passing lane at a time
  for (unsigned m = mask; m; m &= m - 1) {
    const int src = __ffs(m) - 1;
    const Ray S = shfl_ray(R, src);
    float bv = T_MISS;
    int bc = 0;
#pragma unroll
    for (int k = 0; k < GROUP / WARP; ++k) {
      const int j = lane + WARP * k;
      const float v = column_value<KIND, Q>(base + j, S, t_min);
      if (v < bv) {
        bv = v;
        bc = j;
      }
    }
#pragma unroll
    for (int off = WARP / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(FULL, bv, off);
      const int oc = __shfl_xor_sync(FULL, bc, off);
      if (ov < bv || (ov == bv && oc < bc)) {
        bv = ov;
        bc = oc;
      }
    }
    if (lane == src) take<Q, TIE>(bv, bc, g, R, tb, cb);
  }
}

template <bool TIE>
__device__ __forceinline__ void visit(const float4* base, int kind, bool q, unsigned mask,
                                      int lane, int g, const Ray& R, float t_min,
                                      float& tb, int& cb) {
  if (kind == PRIM_SPHERE) {
    if (q) {
      visit_cluster<PRIM_SPHERE, true, TIE>(base, mask, lane, g, R, t_min, tb, cb);
    } else {
      visit_cluster<PRIM_SPHERE, false, TIE>(base, mask, lane, g, R, t_min, tb, cb);
    }
  } else if (kind == PRIM_RECT) {
    visit_cluster<PRIM_RECT, false, TIE>(base, mask, lane, g, R, t_min, tb, cb);
  } else {
    visit_cluster<PRIM_TRIANGLE, false, TIE>(base, mask, lane, g, R, t_min, tb, cb);
  }
}

// The slab test of cluster g at the running best tb (slab_bounds of
// ../projected.py: bvh.rs:18-35) on the two bound quads.
__device__ __forceinline__ bool slab_pass8(const Tables& T, int g, const Ray& R,
                                           const float inv_d[3], float t_min, float tb) {
  const float4 lo4 = __ldg(T.bounds8 + 2 * g), hi4 = __ldg(T.bounds8 + 2 * g + 1);
  const float bl[3] = {lo4.x, lo4.y, lo4.z}, bh[3] = {hi4.x, hi4.y, hi4.z};
  const float o[3] = {R.ox, R.oy, R.oz};
  float lo = t_min, hi = T_MISS;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float b0 = (bl[ax] - o[ax]) * inv_d[ax];
    const float b1 = (bh[ax] - o[ax]) * inv_d[ax];
    lo = nan_max(lo, nan_min(b0, b1));
    hi = nan_min(hi, nan_max(b0, b1));
  }
  return nan_min(hi, tb) >= lo;
}

__device__ __forceinline__ int row_quads(int kind) {
  return kind == PRIM_SPHERE ? 1 : (kind == PRIM_RECT ? 3 : 4);
}

// The "memory" clobbers tell the compiler that these write the stage: without
// them it may move the stage's loads across the wait (seen on the card).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
sweep_kernel(Tables T, Slots S, const float* __restrict__ o, const float* __restrict__ d,
             float t_min, float* __restrict__ t_out, int* __restrict__ c_out,
             float* __restrict__ pay_out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & (WARP - 1);
  const long long warp0 = i - lane;  // the warp's first lane
  if (warp0 >= n) return;
  const bool active = i < n;

  Ray R;
  float inv_d[3];
  {
    const float ox = active ? o[3 * i] : 0.0f, oy = active ? o[3 * i + 1] : 0.0f;
    const float oz = active ? o[3 * i + 2] : 0.0f;
    const float dx = active ? d[3 * i] : 0.0f, dy = active ? d[3 * i + 1] : 0.0f;
    const float dz = active ? d[3 * i + 2] : 0.0f;
    R.ox = ox; R.oy = oy; R.oz = oz;
    R.dx = dx; R.dy = dy; R.dz = dz;
    R.dnorm = dx * dx + dy * dy + dz * dz;
    R.tmin_a = t_min * R.dnorm;
    R.dnorm64 = ((double)dx * dx + (double)dy * dy) + (double)dz * dz;
    const float dd[3] = {dx, dy, dz};
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const float x = dd[ax];
      const float ds = fabsf(x) < TINY ? (x < 0.0f ? -TINY : TINY) : x;
      inv_d[ax] = 1.0f / ds;
    }
  }

  float tb = T_MISS;
  int cb = -1;
  // K5 and K6 (every real cluster) or K7 (the kcap slots of the warp's
  // block, rb a multiple of 32), each warp on its own: a cluster its ballot
  // passes is staged in the warp's shared memory, then swept from there
  __shared__ __align__(16) float4 wstage[THREADS / WARP][QUADS * GROUP];
  float4* buf = wstage[threadIdx.x / WARP];
  auto visit_rows = [&](int g, int kind, bool q, unsigned mask) {
    const float4* rows = T.rows + (size_t)g * QUADS * GROUP;
    const int nq = row_quads(kind);
    for (int k = 0; k < nq; ++k) {
#pragma unroll
      for (int c = 0; c < GROUP / WARP; ++c) {
        cp_async16(buf + k * GROUP + c * WARP + lane, rows + k * GROUP + c * WARP + lane);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    visit<MODE == MODE_RESIDENT>(buf, kind, q, mask, lane, g, R, t_min, tb, cb);
    __syncwarp();  // the stage is refilled at the next visit
  };
  if constexpr (MODE != MODE_PAIRS) {
    for (int g = 0; g < T.G; ++g) {
      const int kind = T.kinds[g];
      if (kind < 0) continue;
      const unsigned mask =
          __ballot_sync(FULL, active && slab_pass8(T, g, R, inv_d, t_min, tb));
      const bool q = MODE == MODE_DENSE ? T.qflags[g] != 0 : kind == PRIM_SPHERE;
      if (mask) visit_rows(g, kind, q, mask);
    }
  } else {
    const long long base = (warp0 / S.rb) * S.kcap;
    for (int j = 0; j < S.kcap; ++j) {
      const int kind = S.words[S.W + base + j];
      if (kind < 0) continue;
      const int g = S.words[base + j];
      const unsigned mask =
          __ballot_sync(FULL, active && slab_pass8(T, g, R, inv_d, t_min, tb));
      if (mask) visit_rows(g, kind, kind == PRIM_SPHERE, mask);
    }
  }

  if (!active) return;
  const bool hit = cb >= 0;
  t_out[i] = hit ? tb : T_MISS;
  c_out[i] = cb;
  const float4* row =
      reinterpret_cast<const float4*>(T.payload + (size_t)(hit ? cb : 0) * PAY_W);
  float4* out = reinterpret_cast<float4*>(pay_out + (size_t)i * PAY_W);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int w = 0; w < PAY_W / 4; ++w) out[w] = hit ? __ldg(row + w) : zero;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" {

// Launch K5 (mode 0), K6 (mode 1) or K7 (mode 2) on `stream`.  `tab_ptrs` is
// a HOST array of 5 device pointers: the payload (f32), cluster kinds, K5 q
// flags (int32), the compact rows and the bound quads (f32; ProjTables.rows,
// .bounds8); C columns, G = C / 128 clusters.  `words` / `kcap` / `rb` /
// `W`: K7's (2, W) slot table, kcap slots a block of rb lanes (a multiple
// of 32); unused by K5 and K6.  `o`, `d`: (n_lanes, 3) f32; outputs t (f32),
// column (int32), payload (n_lanes, 32) f32.  Returns cudaGetLastError() of
// the launch.
int projected_launch(int mode, void* const* tab_ptrs, int C, int G, const int* words,
                     int kcap, int rb, long long W, const float* o, const float* d,
                     float t_min, float* t_out, int* c_out, float* pay_out,
                     long long n_lanes, void* stream) {
  if (mode < MODE_DENSE || mode > MODE_PAIRS || C <= 0 || C != G * GROUP ||
      n_lanes < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (mode == MODE_PAIRS && (words == nullptr || kcap <= 0 || rb <= 0 || rb % WARP != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  if (!aligned16(tab_ptrs[0]) || !aligned16(tab_ptrs[3]) || !aligned16(tab_ptrs[4]) ||
      !aligned16(pay_out)) {
    return (int)cudaErrorMisalignedAddress;
  }
  if (n_lanes == 0) return (int)cudaSuccess;
  Tables T;
  T.payload = static_cast<const float*>(tab_ptrs[0]);
  T.kinds = static_cast<const int*>(tab_ptrs[1]);
  T.qflags = static_cast<const int*>(tab_ptrs[2]);
  T.rows = static_cast<const float4*>(tab_ptrs[3]);
  T.bounds8 = static_cast<const float4*>(tab_ptrs[4]);
  T.C = C;
  T.G = G;
  Slots S{words, kcap, rb, W};
  const long long blocks = (n_lanes + THREADS - 1) / THREADS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == MODE_DENSE) {
    sweep_kernel<MODE_DENSE><<<(unsigned)blocks, THREADS, 0, s>>>(
        T, S, o, d, t_min, t_out, c_out, pay_out, n_lanes);
  } else if (mode == MODE_RESIDENT) {
    sweep_kernel<MODE_RESIDENT><<<(unsigned)blocks, THREADS, 0, s>>>(
        T, S, o, d, t_min, t_out, c_out, pay_out, n_lanes);
  } else {
    sweep_kernel<MODE_PAIRS><<<(unsigned)blocks, THREADS, 0, s>>>(
        T, S, o, d, t_min, t_out, c_out, pay_out, n_lanes);
  }
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
