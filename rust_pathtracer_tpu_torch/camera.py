"""Thin-lens camera and batched ray generation.

Counterpart of ``rust_pathtracer_tpu/camera.py``; plain tensor code.
``make_camera`` precomputes the frame of ``Camera::new``
(camera.rs:14-44); ``camera_rays`` is the batched ``ray_at``
(camera.rs:46-56).  Ray directions are **not** normalized: the shadow
epsilon t_min = 0.001 (ray.rs:25) is in units of |direction|, as in
the reference.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from rust_pathtracer_tpu_torch import sampling
from rust_pathtracer_tpu_torch import vecmath as vm


@dataclasses.dataclass(frozen=True)
class Camera:
    """Precomputed camera frame (f32 tensors of shape (3,) or ())."""

    origin: torch.Tensor
    lower_left_corner: torch.Tensor
    horizontal: torch.Tensor
    vertical: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    lens_radius: torch.Tensor

    def to(self, device) -> "Camera":
        return Camera(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })


def make_camera(
    lookfrom,
    lookat,
    up,
    vertical_fov_deg,
    aspect_ratio,
    aperture=0.0,
    focus_dist=1.0,
    device="cpu",
) -> Camera:
    """Build a Camera (camera.rs:14-44), in f32 as the JAX package does."""

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    lookfrom, lookat, up = f32(lookfrom), f32(lookat), f32(up)
    vfov, aspect = f32(vertical_fov_deg), f32(aspect_ratio)

    h = torch.tan(vfov * (math.pi / 180.0) / f32(2.0))
    viewport_w = aspect * 2.0 * h
    viewport_h = 2.0 * h

    w = vm.normalize(lookfrom - lookat)
    u = vm.normalize(vm.cross(up, w))
    v = vm.cross(w, u)

    focus_dist = f32(focus_dist)
    horizontal = focus_dist * viewport_w * u
    vertical = focus_dist * viewport_h * v
    lower_left = (lookfrom - horizontal / f32(2.0) - vertical / f32(2.0)
                  - focus_dist * w)

    return Camera(
        origin=lookfrom,
        lower_left_corner=lower_left,
        horizontal=horizontal,
        vertical=vertical,
        u=u,
        v=v,
        lens_radius=f32(aperture) / f32(2.0),
    )


def camera_rays(camera: Camera, s, t, lens_keys):
    """Batched ``ray_at`` (camera.rs:46-56).

    s, t: (R,) viewport coordinates in [0,1]; lens_keys: (R, 2) lane
    keys for the aperture-disk sample.  Returns (origins (R, 3),
    directions (R, 3)); directions are unnormalized.
    """
    rng = camera.lens_radius * sampling.in_unit_disk_xy(lens_keys)
    blur = camera.u * rng[..., 0:1] + camera.v * rng[..., 1:2]
    origin = camera.origin + blur
    direction = (
        camera.lower_left_corner
        + s[..., None] * camera.horizontal
        + t[..., None] * camera.vertical
        - camera.origin
        - blur
    )
    return origin, direction
