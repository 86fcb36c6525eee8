// K3 and K4: closest hit over a static list of at most 128 primitives,
// for NVIDIA Hopper (sm_90a).
//
// K4 (RECORD = false) replaces rust_pathtracer_tpu/ops/pallas_intersect.py::
// _kernel, the detached search of the differentiable generic bounce: per
// lane (hit, t, idx), t = T_MISS and idx = 0 on a miss.  K3 (RECORD = true)
// replaces ::_kernel_shade, the search plus the hit record of the
// non-differentiable generic bounce: per lane (hit, t, idx, point, normal,
// front, u, v, mat), t = 1 on a miss.  K3's record is the Pallas kernel's:
// the sphere normal (o + t d - c) * (1 / r), the front test on the outward
// normal, rect uv at sweep time, and the sphere uv from acosf / atan2f of
// the outward normal, which the TPU left to an XLA epilogue and which runs
// here in the kernel.  The plain PyTorch twins are closest_hit_plain /
// closest_hit_record_plain in ../closest_hit.py.
//
// The sweep is the Pallas kernels': sphere half-b with the nearest root in
// [t_min, best] and true divisions, the rect plane solve, one-sided
// Moller-Trumbore with the |det| > 1e-30 guard, and the strict t < best
// update (the first primitive wins a tie).  Every lane is swept, dead ones
// included, as the JAX package does; the integrator masks them afterwards.
//
// What bounds it on the card: per lane K4 reads 24 B of rays and writes
// 9 B, K3 reads 24 B and writes 46 B; the sweep is about 30 f32 operations
// a primitive (an IEEE division or two and a sqrt among them, each many
// instructions).  At the generic scenes' 2-3 primitives both are bound by
// bytes and run at 1.05-1.35x that bound; from about 7 primitives the
// sweep's instructions take over.
//
// Design (k34_variants.py times the alternatives; PERF.md):
// * one thread a lane; a block of 256 threads walks tiles of 256 lanes
//   (grid stride) in a grid of BLOCKS_PER_SM blocks on each SM of the card
//   (launch_blocks), at most one a tile.  The card holds 5 (K3) or 6 (K4)
//   of these blocks an SM at once, so the grid is 2-3 waves and the block
//   scheduler evens out the last one; one resident wave that loops over
//   tiles measured 1-20% slower, one block a tile 1-6%;
// * the (16, P) table sits in shared memory (at most 8 KB), read as a
//   broadcast; the loop over primitives is the same for every thread, so
//   the switch on the kind does not diverge within a warp;
// * each thread loads its lane's rays from the (R, 3) rows and stores its
//   outputs straight to their planes: the three loads (or stores) of a
//   component triple touch the same 384 bytes a warp, which L1 and L2
//   merge, so a warp moves whole sectors.  Staging a tile's rows through
//   shared memory in 16-byte cp.async copies and float4 stores measured
//   12-30% slower (the barriers a tile hold each block's warps together);
// * the caller hands one buffer for all the outputs, laid out as
//   closest_hit_launch says.
//
// Numerics: build without --use_fast_math and with --fmad=false, so every
// f32 op rounds as the plain version's does.  Only acosf / atan2f differ
// from the CPU's by an ulp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PRIM_SPHERE = 0, PRIM_RECT = 1;
constexpr int TABLE_ROWS = 16;  // rows 0-11 data, 12 kind, 13 aux, 14 mat
constexpr int ROW_KIND = 12, ROW_AUX = 13, ROW_MAT = 14;
constexpr int MAX_PRIMS = 128;
constexpr int THREADS = 256;       // threads a block, lanes a tile
constexpr int BLOCKS_PER_SM = 16;  // the grid's blocks an SM (2-3 waves at 256 lanes)
constexpr int MAX_DEVICES = 64;

constexpr float T_MISS = 3.0e38f;
constexpr float TRI_DET_EPS = 1e-4f;
constexpr float PI_F = 3.14159265358979f;        // float32(pi)
constexpr float INV_TWO_PI = 0.15915494309189535f;  // float32(1 / (2 pi))
constexpr float INV_PI = 0.3183098861837907f;       // float32(1 / pi)

struct Outs {
  // K4: hit (bool), t, idx.  K3: hit, t, idx, point (R, 3), normal
  // (R, 3), front (bool), u, v, mat.
  bool* hit;
  float* t;
  int* idx;
  float* point;
  float* normal;
  bool* front;
  float* u;
  float* v;
  int* mat;
};

template <bool RECORD>
__global__ void __launch_bounds__(THREADS)
closest_hit_kernel(const float* __restrict__ table, int n_prims,
                   const float* __restrict__ o, const float* __restrict__ d,
                   float t_min, Outs outs, long long n) {
  __shared__ float tab[TABLE_ROWS * MAX_PRIMS];
  for (int i = threadIdx.x; i < TABLE_ROWS * n_prims; i += THREADS) tab[i] = table[i];
  __syncthreads();
  const int P = n_prims;

  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
    const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
    const float a = dx * dx + dy * dy + dz * dz;

    float best_t = T_MISS;
    int best_i = -1;
    int wkind = -1;
    float wnx = 0.0f, wny = 0.0f, wnz = 0.0f, wu = 0.0f, wv = 0.0f, wmat = 0.0f;

    for (int p = 0; p < P; ++p) {
      const int kind = (int)tab[ROW_KIND * P + p];
      float t, nx = 0.0f, ny = 0.0f, nz = 0.0f, u = 0.0f, v = 0.0f;
      bool valid;
      if (kind == PRIM_SPHERE) {
        const float cx = tab[0 * P + p], cy = tab[1 * P + p], cz = tab[2 * P + p];
        const float r = tab[3 * P + p];
        const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
        const float half_b = dx * ocx + dy * ocy + dz * ocz;
        const float c = ocx * ocx + ocy * ocy + ocz * ocz - r * r;
        const float dis = half_b * half_b - a * c;
        const float sqrtd = sqrtf((dis != dis || dis > 0.0f) ? dis : 0.0f);  // NaN-propagating max
        const float root1 = (-half_b - sqrtd) / a;
        const float root2 = (-half_b + sqrtd) / a;
        const bool ok1 = (root1 >= t_min) & (root1 <= best_t);
        const bool ok2 = (root2 >= t_min) & (root2 <= best_t);
        t = ok1 ? root1 : root2;
        valid = (dis >= 0.0f) & (ok1 | ok2);
        if (RECORD) {
          const float inv_r = 1.0f / r;
          nx = (ox + t * dx - cx) * inv_r;
          ny = (oy + t * dy - cy) * inv_r;
          nz = (oz + t * dz - cz) * inv_r;
        }
      } else if (kind == PRIM_RECT) {
        const int aux = (int)tab[ROW_AUX * P + p];
        const float k = tab[0 * P + p];
        const float a0 = tab[1 * P + p], b0 = tab[2 * P + p];
        const float a1 = tab[3 * P + p], b1 = tab[4 * P + p];
        // fixed axis aux; free axes (a, b) in ascending order
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
        if (RECORD) {
          const float sgn = tab[5 * P + p];
          nx = aux == 0 ? 1.0f * sgn : 0.0f;
          ny = aux == 1 ? 1.0f * sgn : 0.0f;
          nz = aux == 2 ? 1.0f * sgn : 0.0f;
          u = (av - a0) / (a1 - a0);
          v = (bv - b0) / (b1 - b0);
        }
      } else {  // PRIM_TRIANGLE; uv stays (0, 0) (geometry.rs:553-556)
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
        if (RECORD) {
          nx = 1.0f * tab[9 * P + p];
          ny = 1.0f * tab[10 * P + p];
          nz = 1.0f * tab[11 * P + p];
        }
      }
      if (valid & (t < best_t)) {
        best_t = t;
        best_i = p;
        if (RECORD) {
          wkind = kind;
          wnx = nx;
          wny = ny;
          wnz = nz;
          wu = u;
          wv = v;
          wmat = tab[ROW_MAT * P + p];
        }
      }
    }

    const bool hit = best_i >= 0;
    outs.hit[i] = hit;
    outs.idx[i] = hit ? best_i : 0;
    if (!RECORD) {
      outs.t[i] = best_t;  // T_MISS on a miss
      continue;
    }
    const float t = hit ? best_t : 1.0f;  // finite t for miss lanes
    const bool front = dx * wnx + dy * wny + dz * wnz < 0.0f;  // outward normal
    if (wkind == PRIM_SPHERE) {  // sphere uv (geometry.rs:120-128)
      const float my = -wny;
      const float theta = acosf(my < -1.0f ? -1.0f : (my > 1.0f ? 1.0f : my));
      const float phi = atan2f(-wnz, wnx) + PI_F;
      wu = phi * INV_TWO_PI;
      wv = theta * INV_PI;
    }
    const float flip = front ? 1.0f : -1.0f;
    outs.t[i] = t;
    outs.point[3 * i] = ox + t * dx;
    outs.point[3 * i + 1] = oy + t * dy;
    outs.point[3 * i + 2] = oz + t * dz;
    outs.normal[3 * i] = wnx * flip;
    outs.normal[3 * i + 1] = wny * flip;
    outs.normal[3 * i + 2] = wnz * flip;
    outs.front[i] = front;
    outs.u[i] = wu;
    outs.v[i] = wv;
    outs.mat[i] = (int)wmat;
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

// Launch K4 (record = 0) or K3 (record = 1) on `stream`.  `table`
// (16, n_prims) f32, `o` and `d` (n_lanes, 3) f32 and `out` are device
// pointers.  `out` holds every output plane, each (row-major (R, 3) for
// point and normal) at a multiple of 16 bytes, R rounded up to 16 lanes
// (Rp):
//   K4: t f32 @ 0, idx i32 @ 4 Rp, hit bool @ 8 Rp; 9 Rp bytes;
//   K3: point @ 0, normal @ 12 Rp, t @ 24 Rp, u @ 28 Rp, v @ 32 Rp,
//       idx i32 @ 36 Rp, mat i32 @ 40 Rp, hit @ 44 Rp, front @ 45 Rp;
//       46 Rp bytes
// (closest_hit.py's K4_PLANES / K3_PLANES).  Returns cudaGetLastError() of
// the launch: nonzero means it never ran.
int closest_hit_launch(const float* table, int n_prims, const float* o,
                       const float* d, float t_min, int record, void* out,
                       long long n_lanes, void* stream) {
  if (n_prims <= 0 || n_prims > MAX_PRIMS || n_lanes < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_lanes == 0) return (int)cudaSuccess;
  const long long rp = (n_lanes + 15) / 16 * 16;
  char* base = static_cast<char*>(out);
  Outs outs = {};
  if (record) {
    outs.point = reinterpret_cast<float*>(base);
    outs.normal = reinterpret_cast<float*>(base + 12 * rp);
    outs.t = reinterpret_cast<float*>(base + 24 * rp);
    outs.u = reinterpret_cast<float*>(base + 28 * rp);
    outs.v = reinterpret_cast<float*>(base + 32 * rp);
    outs.idx = reinterpret_cast<int*>(base + 36 * rp);
    outs.mat = reinterpret_cast<int*>(base + 40 * rp);
    outs.hit = reinterpret_cast<bool*>(base + 44 * rp);
    outs.front = reinterpret_cast<bool*>(base + 45 * rp);
  } else {
    outs.t = reinterpret_cast<float*>(base);
    outs.idx = reinterpret_cast<int*>(base + 4 * rp);
    outs.hit = reinterpret_cast<bool*>(base + 8 * rp);
  }
  const long long tiles = (n_lanes + THREADS - 1) / THREADS;
  const long long blocks = launch_blocks(tiles);
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (record) {
    closest_hit_kernel<true><<<(unsigned)blocks, THREADS, 0, s>>>(
        table, n_prims, o, d, t_min, outs, n_lanes);
  } else {
    closest_hit_kernel<false><<<(unsigned)blocks, THREADS, 0, s>>>(
        table, n_prims, o, d, t_min, outs, n_lanes);
  }
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
