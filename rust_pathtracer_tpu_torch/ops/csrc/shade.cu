// The shade kernel: the big-scene forward bounce after the search, in one
// launch, for NVIDIA Hopper (sm_90a).
//
// It replaces no pl.pallas_call.  The JAX package runs this part of the
// bounce in XLA: the tail of integrator._bounce_step (JAX
// rust_pathtracer_tpu/integrator.py:562-631), after the projected search.
// The port ran it as ~250 PyTorch tensor ops a bounce, each over every
// lane, dead or alive: ops/projected.record_from_payload's hit
// record, then integrator._bounce_tail (materials.shade_inputs / emitted /
// scatter, textures.eval_texture_payload, sampling's sphere and ball
// transforms, the state commit, roulette).  That tensor-op route stays as
// this kernel's plain twin (integrator.shade_bounce_plain) and as the
// route of every bounce the kernel does not take.
//
// Per lane, one thread, out of place: the search's t and winning column
// (K5, K6 or K7, ops/projected.py), the winner's payload row read by
// column from the tables (a SphereField table is 640 columns x 128 B: it
// stays in L2), the state (o, d, thr, rad as (R, 3) f32 rows, alive as
// bool), the bounce's uniforms (ops/draws.py: sphere_u, ball_u, the coin;
// roulette's and the roulette lane mask where given) and the background.
// In registers: the hit point; the outward normal by primitive kind (a
// sphere's (p - c) / r, a rect's axis times its sign, a triangle's flat
// normal) and the front-face flip; the texture (solid, or a checker of
// solid children: the tables' shade_ready); emission (a light, front face
// only) and the background on a miss; the sphere and ball transforms of
// the draws; the lambertian / metal / dielectric scatter; the commit and
// roulette.  Out: the new (o, d, thr, rad, alive).  No texture kind it
// takes reads uv, so it computes none (no acos, no atan2).
//
// What bounds it on the card.  A lane reads 48 B of state, its alive byte,
// t and column (8 B), 24 B of uniforms (28 B and a mask byte with
// roulette) and writes 49 B: about 130 B a lane, 6,558,720 lanes (a
// SphereField chunk) in ~0.25 ms at 3.35 TB/s.  The work is ~100-200 f32
// operations a lane, a sine and cosine pair, two square roots, an f64 power
// for a metal and three sines for a checker: under the bytes' time at the
// card's rates.  One thread a lane suffices: a lane needs nothing of
// another (no table sweep, no reduction), the payload row is one 128-byte
// line from L2, and where a warp's lanes take different materials each
// branch body is a few dozen instructions, not K1's threefry or marble.
//
// Numerics: built with --fmad=false and without fast math (ops/_build.py),
// every f32 operation with its operands and order from the tensor ops, so
// that on the card it equals the tensor-op route bit for bit: IEEE
// division (torch divides a tensor by a tensor), sqrtf (vecmath.sqrt's f64
// root rounded is the correctly rounded one), the cube root as the f64
// power rounded to f32 (vecmath.cbrt), sinf / cosf (PyTorch's CUDA sin /
// cos), NaN-propagating clamps and max as torch.clamp and amax have them,
// the zeros the where's add and the signs of zero their products carry.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PRIM_SPHERE = 0, PRIM_RECT = 1;  // else a triangle
constexpr int MAT_LAMBERTIAN = 0, MAT_METAL = 1, MAT_DIELECTRIC = 2, MAT_LIGHT = 3;
constexpr int TEX_CHECKER = 1;

// flag bits of mat_flags / tex_flags (ops/fused_bounce.py _MAT_BITS, _TEX_BITS)
constexpr int MATF_LAMBERTIAN = 1, MATF_METAL = 2, MATF_DIELECTRIC = 4, MATF_LIGHT = 8;
constexpr int TEXF_CHECKER = 2;

// payload columns (ops/projected.py PAY_*)
constexpr int PAY_KIND = 12, PAY_AUX = 13;
constexpr int PAY_MKIND = 16, PAY_FUZZ = 17, PAY_IR = 18, PAY_TKIND = 19, PAY_TSCALE = 20;
constexpr int PAY_COLOR = 21, PAY_ODD = 24, PAY_EVEN = 27;
constexpr int PAY_W = 32;

constexpr float NEAR_ZERO = 1e-8f;    // vecmath.NEAR_ZERO
constexpr float SAFE_EPS = 1e-20f;    // vecmath._SAFE_EPS
constexpr float DIV_EPS = 1e-30f;     // intersect._safe_div
constexpr float TWO_PI = 6.2831855f;  // 2 * math.pi as an f32 scalar
constexpr float RR_P_MIN = 0.05f, RR_P_MAX = 1.0f;  // integrator._bounce_tail

constexpr int THREADS = 256;

// the launch's pointers, in the order of the host array (shade_bounce_launch)
enum Ptr {
  P_PAYLOAD, P_T, P_COL, P_O, P_D, P_THR, P_RAD, P_ALIVE,
  P_SU0, P_SU1, P_BU0, P_BU1, P_BU2, P_COIN, P_RR, P_RR_SEL, P_BG,
  P_O_OUT, P_D_OUT, P_THR_OUT, P_RAD_OUT, P_ALIVE_OUT, N_PTRS
};

struct Args {
  const float* payload;
  const float* t;
  const int* col;
  const float *o, *d, *thr, *rad;
  const bool* alive;
  const float *su0, *su1, *bu0, *bu1, *bu2, *coin;
  const float* rr;      // roulette's uniforms, or NULL: no roulette
  const bool* rr_sel;   // the lanes roulette may act on, or NULL: every lane
  const float* bg;      // (3,)
  float *o_out, *d_out, *thr_out, *rad_out;
  bool* alive_out;
};

// NaN-propagating clamps and max, as torch.clamp and amax have them
__device__ __forceinline__ float max_nan(float x, float c) {
  return (x != x || x > c) ? x : c;
}
__device__ __forceinline__ float min_nan(float x, float c) {
  return (x != x || x < c) ? x : c;
}

struct V3 {
  float x, y, z;
};

// vecmath.dot: (x + y) + z
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return (a.x * b.x + a.y * b.y) + a.z * b.z;
}

// vecmath.normalize: v / sqrt(clamp(|v|^2, min=1e-20))
__device__ __forceinline__ V3 normalize3(V3 v) {
  const float s = sqrtf(max_nan(dot3(v, v), SAFE_EPS));
  return {v.x / s, v.y / s, v.z / s};
}

// vecmath.reflect: v - (2 (v . n)) n
__device__ __forceinline__ V3 reflect3(V3 v, V3 n) {
  const float k = 2.0f * dot3(v, n);
  return {v.x - k * n.x, v.y - k * n.y, v.z - k * n.z};
}

// sampling.on_unit_sphere_from_u's direction from (u0, u1); `in_ball`
// scales it by the cube root of u2 (in_unit_sphere_from_u)
__device__ __forceinline__ V3 sphere_dir(float u0, float u1) {
  const float z = 2.0f * u0 - 1.0f;
  const float phi = TWO_PI * u1;
  const float r = sqrtf(max_nan(1.0f - z * z, 0.0f));
  return {r * cosf(phi), r * sinf(phi), z};
}

__global__ void __launch_bounds__(THREADS)
shade_bounce_kernel(Args a, int mat_flags, int tex_flags, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const V3 o = {a.o[3 * i], a.o[3 * i + 1], a.o[3 * i + 2]};
  const V3 d = {a.d[3 * i], a.d[3 * i + 1], a.d[3 * i + 2]};
  V3 thr = {a.thr[3 * i], a.thr[3 * i + 1], a.thr[3 * i + 2]};
  V3 rad = {a.rad[3 * i], a.rad[3 * i + 1], a.rad[3 * i + 2]};
  const bool alive = a.alive[i];
  const int c = a.col[i];
  const bool hit = c >= 0 && alive;
  const bool miss = alive && !hit;

  // the background on a miss, then emission on a hit; every lane adds,
  // the others a +0 (torch.where's 0.0)
  {
    const float b0 = miss ? thr.x * a.bg[0] : 0.0f;
    const float b1 = miss ? thr.y * a.bg[1] : 0.0f;
    const float b2 = miss ? thr.z * a.bg[2] : 0.0f;
    rad = {rad.x + b0, rad.y + b1, rad.z + b2};
  }

  V3 o_new = o, d_new = d;
  bool cont = false;
  V3 e = {0.0f, 0.0f, 0.0f};  // thr * emitted, or the +0 of a lane without a hit
  if (hit) {
    const float4* row4 = reinterpret_cast<const float4*>(a.payload + (size_t)c * PAY_W);
    float row[PAY_W];
#pragma unroll
    for (int q = 0; q < PAY_W / 4; ++q) {
      const float4 v = __ldg(row4 + q);
      row[4 * q] = v.x;
      row[4 * q + 1] = v.y;
      row[4 * q + 2] = v.z;
      row[4 * q + 3] = v.w;
    }
    // ---- the hit record (intersect.record_from_rows) -------------------
    const float t = a.t[i];
    const V3 p = {o.x + t * d.x, o.y + t * d.y, o.z + t * d.z};
    const int kind = (int)rintf(row[PAY_KIND]);
    V3 w;  // the outward normal
    if (kind == PRIM_SPHERE) {
      const float r = row[3];
      const float den = fabsf(r) < DIV_EPS ? 1.0f : r;
      w = {(p.x - row[0]) / den, (p.y - row[1]) / den, (p.z - row[2]) / den};
    } else if (kind == PRIM_RECT) {
      const int aux = (int)rintf(row[PAY_AUX]);
      const float s = row[5];
      w = {(aux == 0 ? 1.0f : 0.0f) * s, (aux == 1 ? 1.0f : 0.0f) * s,
           (aux == 2 ? 1.0f : 0.0f) * s};
    } else {
      w = {row[9], row[10], row[11]};
    }
    const bool front = dot3(d, w) < 0.0f;
    const V3 nrm = front ? w : V3{-w.x, -w.y, -w.z};

    // ---- the texture (textures.eval_texture_payload) -------------------
    V3 value = {row[PAY_COLOR], row[PAY_COLOR + 1], row[PAY_COLOR + 2]};
    if ((tex_flags & TEXF_CHECKER) && (int)rintf(row[PAY_TKIND]) == TEX_CHECKER) {
      const float sc = row[PAY_TSCALE];
      const float sines = sinf(sc * p.x) * sinf(sc * p.y) * sinf(sc * p.z);
      value = sines < 0.0f ? V3{row[PAY_ODD], row[PAY_ODD + 1], row[PAY_ODD + 2]}
                           : V3{row[PAY_EVEN], row[PAY_EVEN + 1], row[PAY_EVEN + 2]};
    }

    // ---- emission (materials.emitted) ----------------------------------
    const int mk = (int)rintf(row[PAY_MKIND]);
    const bool lit = (mat_flags & MATF_LIGHT) && mk == MAT_LIGHT && front;
    e = {thr.x * (lit ? value.x : 0.0f), thr.y * (lit ? value.y : 0.0f),
         thr.z * (lit ? value.z : 0.0f)};

    // ---- the scatter (materials.scatter) --------------------------------
    V3 dir = {0.0f, 0.0f, 0.0f}, att = {0.0f, 0.0f, 0.0f};
    if ((mat_flags & MATF_LAMBERTIAN) && mk == MAT_LAMBERTIAN) {
      const V3 sd = sphere_dir(a.su0[i], a.su1[i]);
      dir = {nrm.x + sd.x, nrm.y + sd.y, nrm.z + sd.z};
      if (fabsf(dir.x) < NEAR_ZERO && fabsf(dir.y) < NEAR_ZERO && fabsf(dir.z) < NEAR_ZERO) {
        dir = nrm;
      }
      att = value;
      cont = true;
    } else if ((mat_flags & MATF_METAL) && mk == MAT_METAL) {
      const V3 refl = reflect3(normalize3(d), nrm);
      const V3 sd = sphere_dir(a.bu0[i], a.bu1[i]);
      const float cb = (float)pow((double)a.bu2[i], 1.0 / 3.0);
      const V3 ball = {sd.x * cb, sd.y * cb, sd.z * cb};
      const float fuzz = row[PAY_FUZZ];
      dir = {refl.x + fuzz * ball.x, refl.y + fuzz * ball.y, refl.z + fuzz * ball.z};
      att = value;
      cont = dot3(refl, nrm) > 0.0f;  // absorbed below the surface
    } else if ((mat_flags & MATF_DIELECTRIC) && mk == MAT_DIELECTRIC) {
      const float ir = row[PAY_IR];
      const float ratio = front ? 1.0f / ir : ir;
      const V3 ud = normalize3(d);
      const V3 neg = {-ud.x, -ud.y, -ud.z};
      const float cos_t = min_nan(dot3(neg, nrm), 1.0f);
      const float sin_t = sqrtf(max_nan(1.0f - cos_t * cos_t, 0.0f));
      const bool cannot_refract = ratio * sin_t > 1.0f;
      // Schlick on the eta ratio, the integer powers as XLA expands them
      float r0 = (1.0f - ratio) / (1.0f + ratio);
      r0 = r0 * r0;
      const float one_c = 1.0f - cos_t;
      const float one_c2 = one_c * one_c;
      const float schlick = r0 + (1.0f - r0) * (one_c * (one_c2 * one_c2));
      if (cannot_refract | (schlick > a.coin[i])) {
        dir = reflect3(ud, nrm);
      } else {  // vecmath.refract
        const V3 perp = {ratio * (ud.x + cos_t * nrm.x), ratio * (ud.y + cos_t * nrm.y),
                         ratio * (ud.z + cos_t * nrm.z)};
        const float l = fabsf(1.0f - dot3(perp, perp));
        const float s = -(l <= 0.0f ? 0.0f : sqrtf(l));  // -safe_sqrt
        dir = {perp.x + s * nrm.x, perp.y + s * nrm.y, perp.z + s * nrm.z};
      }
      att = {1.0f, 1.0f, 1.0f};
      cont = true;
    }

    // ---- the commit -------------------------------------------------------
    if (cont) {
      thr = {thr.x * att.x, thr.y * att.y, thr.z * att.z};
      o_new = p;
      d_new = dir;
    }
  }
  rad = {rad.x + e.x, rad.y + e.y, rad.z + e.z};

  // ---- russian roulette (no reference counterpart) ----------------------
  bool alive_new = cont;
  if (a.rr) {
    const float m = max_nan(max_nan(thr.x, thr.y), thr.z);
    const float pr = min_nan(max_nan(m, RR_P_MIN), RR_P_MAX);
    const bool live = alive_new && (a.rr_sel == nullptr || a.rr_sel[i]);
    const bool survive = a.rr[i] < pr;
    if (live && survive) thr = {thr.x / pr, thr.y / pr, thr.z / pr};
    alive_new = alive_new && (survive || !live);
  }

  a.o_out[3 * i] = o_new.x;
  a.o_out[3 * i + 1] = o_new.y;
  a.o_out[3 * i + 2] = o_new.z;
  a.d_out[3 * i] = d_new.x;
  a.d_out[3 * i + 1] = d_new.y;
  a.d_out[3 * i + 2] = d_new.z;
  a.thr_out[3 * i] = thr.x;
  a.thr_out[3 * i + 1] = thr.y;
  a.thr_out[3 * i + 2] = thr.z;
  a.rad_out[3 * i] = rad.x;
  a.rad_out[3 * i + 1] = rad.y;
  a.rad_out[3 * i + 2] = rad.z;
  a.alive_out[i] = alive_new;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" {

// Launch the shade kernel on `stream`.  `ptrs` is a HOST array of N_PTRS
// device pointers, in the order of enum Ptr: the (C, 32) f32 payload
// table; the search's t (f32) and column (int32, -1 on a miss); the state
// o, d, thr, rad ((n_lanes, 3) f32) and alive (bool); the uniforms'
// sphere_u (two f32 rows), ball_u (three), coin, roulette (or NULL), the
// roulette lane mask (bool, or NULL: every lane); the (3,) f32
// background; the outputs o, d, thr, rad ((n_lanes, 3) f32) and alive
// (bool).  `mat_flags` / `tex_flags`: the scene's material and texture
// kinds (fused_bounce._type_flags).  Returns cudaGetLastError() of the
// launch: nonzero means it never ran.
int shade_bounce_launch(void* const* ptrs, int mat_flags, int tex_flags, long long n_lanes,
                        void* stream) {
  if (n_lanes < 0) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < N_PTRS; ++k) {
    if (ptrs[k] == nullptr && k != P_RR && k != P_RR_SEL) return (int)cudaErrorInvalidValue;
  }
  if (!aligned16(ptrs[P_PAYLOAD])) return (int)cudaErrorMisalignedAddress;
  if (n_lanes == 0) return (int)cudaSuccess;
  Args a;
  a.payload = static_cast<const float*>(ptrs[P_PAYLOAD]);
  a.t = static_cast<const float*>(ptrs[P_T]);
  a.col = static_cast<const int*>(ptrs[P_COL]);
  a.o = static_cast<const float*>(ptrs[P_O]);
  a.d = static_cast<const float*>(ptrs[P_D]);
  a.thr = static_cast<const float*>(ptrs[P_THR]);
  a.rad = static_cast<const float*>(ptrs[P_RAD]);
  a.alive = static_cast<const bool*>(ptrs[P_ALIVE]);
  a.su0 = static_cast<const float*>(ptrs[P_SU0]);
  a.su1 = static_cast<const float*>(ptrs[P_SU1]);
  a.bu0 = static_cast<const float*>(ptrs[P_BU0]);
  a.bu1 = static_cast<const float*>(ptrs[P_BU1]);
  a.bu2 = static_cast<const float*>(ptrs[P_BU2]);
  a.coin = static_cast<const float*>(ptrs[P_COIN]);
  a.rr = static_cast<const float*>(ptrs[P_RR]);
  a.rr_sel = static_cast<const bool*>(ptrs[P_RR_SEL]);
  a.bg = static_cast<const float*>(ptrs[P_BG]);
  a.o_out = static_cast<float*>(ptrs[P_O_OUT]);
  a.d_out = static_cast<float*>(ptrs[P_D_OUT]);
  a.thr_out = static_cast<float*>(ptrs[P_THR_OUT]);
  a.rad_out = static_cast<float*>(ptrs[P_RAD_OUT]);
  a.alive_out = static_cast<bool*>(ptrs[P_ALIVE_OUT]);
  const long long blocks = (n_lanes + THREADS - 1) / THREADS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  shade_bounce_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(a, mat_flags, tex_flags, n_lanes);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
