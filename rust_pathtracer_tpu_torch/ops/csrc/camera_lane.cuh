// One camera lane's draws: its threefry key, pixel jitter and lens-disk
// point, shared by the lanes kernel (lanes.cu, every chunk and the regen
// wavefront's first spawn) and the window end's respawn (window_end.cu), so
// that the two cannot drift.  lanes.cu's header comment gives the formulas
// and their numerics; the plain PyTorch twin is lanes.camera_lane_draws_plain
// in ../lanes.py.

#pragma once

#include <math.h>
#include <stdint.h>

#include "threefry.cuh"

namespace rpt {

constexpr float TWO_PI = 6.2831855f;  // 2 * pi rounded to f32, as torch takes the scalar

// What one (pixel, sample) lane draws: the lane key's two words, the
// jittered viewport coordinates (rows counted from the bottom) and the
// point in the unit lens disk.
struct CameraLane {
  uint32_t k0, k1;
  float s_vp, t_vp, disk_x, disk_y;
};

// The lane of pixel p >= 0 and sample s of a W x H frame at S samples a
// pixel, from the base key (b0, b1); w_div and h_div are the f32 W - 1 and
// H - 1 as the plain twin rounds them.
RPT_HD CameraLane camera_lane(uint32_t b0, uint32_t b1, long long p, long long s,
                              long long width, long long height, long long spp_total,
                              float w_div, float h_div) {
  CameraLane out;
  const uint32_t c = (uint32_t)((unsigned long long)p * (unsigned long long)spp_total +
                                (unsigned long long)s);
  uint32_t l0 = 0u, l1 = c;
  threefry2x32(b0, b1, l0, l1);  // the lane key: fold_in(base, c)
  out.k0 = l0;
  out.k1 = l1;

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
  bounce_key(l0, l1, 0u, P_PIXEL_JITTER, k0, k1);
  const float j0 = uniform_at(k0, k1, 0u), j1 = uniform_at(k0, k1, 1u);
  out.s_vp = ((float)col + j0) / w_div;
  out.t_vp = ((float)(height - 1 - row) + j1) / h_div;

  bounce_key(l0, l1, 0u, P_LENS, k0, k1);
  const float u0 = uniform_at(k0, k1, 0u), u1 = uniform_at(k0, k1, 1u);
  const float r = sqrtf(u0);
  const float theta = TWO_PI * u1;
  out.disk_x = r * cosf(theta);
  out.disk_y = r * sinf(theta);
  return out;
}

}  // namespace rpt
