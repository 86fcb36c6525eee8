"""Differentiable rendering API.

Counterpart of ``rust_pathtracer_tpu/grad.py``; plain tensor code.
Image gradients with respect to the texture colours (albedo and
emission both live in the texture table), the image texels, the
background and the seven camera parameters, by the detached-sampling
estimator of the
integrator: random decisions and the discrete hit search are fixed,
while radiance stays differentiable through

  camera params -> ray origin/direction -> hit point -> texture value ->
  attenuation/emission products -> pixel radiance.

The parameters are frozen dataclasses of tensors (not ``nn.Module``s):
set ``requires_grad`` on the leaves, or let ``render_loss_and_grad``
do it.

Typical use::

    params = DiffParams.from_scene(scene, CameraParams.create(...), background)
    loss, grads = render_loss_and_grad(params, scene, settings, key, target,
                                       device="cuda")
    # grads.tex_color, grads.tex_images, grads.background, grads.camera.*
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import numpy as np
import torch

from rust_pathtracer_tpu_torch.camera import Camera, make_camera
from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance

_CAMERA_FIELDS = ("lookfrom", "lookat", "up", "vfov_deg", "aspect",
                  "aperture", "focus_dist")


def _f32(x, device="cpu") -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class CameraParams:
    """The 7 constructor parameters of Camera::new (camera.rs:14-22),
    kept unresolved so gradients reach each of them."""

    lookfrom: torch.Tensor
    lookat: torch.Tensor
    up: torch.Tensor
    vfov_deg: torch.Tensor
    aspect: torch.Tensor
    aperture: torch.Tensor
    focus_dist: torch.Tensor

    @classmethod
    def create(cls, lookfrom, lookat, up, vfov_deg, aspect, aperture=0.0,
               focus_dist=1.0, device="cpu") -> "CameraParams":
        return cls(*(_f32(x, device) for x in (lookfrom, lookat, up, vfov_deg,
                                               aspect, aperture, focus_dist)))

    def build(self) -> Camera:
        return make_camera(
            self.lookfrom, self.lookat, self.up, self.vfov_deg, self.aspect,
            self.aperture, self.focus_dist, device=self.lookfrom.device,
        )


@dataclasses.dataclass(frozen=True)
class DiffParams:
    """The differentiable leaves: texture colours, image texels,
    background, camera (the JAX ``DiffParams``, field for field)."""

    tex_color: torch.Tensor   # Textures.color, (T, 3)
    tex_images: torch.Tensor  # Textures.images, (I, Hmax, Wmax, 3)
    background: torch.Tensor  # (3,)
    camera: CameraParams

    @classmethod
    def from_scene(cls, scene, camera: CameraParams, background) -> "DiffParams":
        return cls(tex_color=scene.textures.color,
                   tex_images=scene.textures.images,
                   background=_f32(background, scene.device), camera=camera)

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        """tex_color, tex_images, background, then the camera's 7, in
        field order."""
        return (self.tex_color, self.tex_images, self.background,
                *(getattr(self.camera, f) for f in _CAMERA_FIELDS))

    @classmethod
    def from_leaves(cls, leaves) -> "DiffParams":
        tex_color, tex_images, background, *cam = leaves
        return cls(tex_color=tex_color, tex_images=tex_images,
                   background=background, camera=CameraParams(*cam))


def diff_params_from_numpy(arrays: Mapping[str, np.ndarray],
                           device="cpu") -> DiffParams:
    """The port's DiffParams from the JAX package's, leaf for leaf.

    ``arrays`` maps ``"tex_color"``, ``"tex_images"``, ``"background"``
    and ``"camera.<field>"`` to numpy arrays (the JAX ``DiffParams`` leaf
    paths); an unknown or a missing leaf raises."""
    known = {"tex_color", "tex_images", "background",
             *(f"camera.{f}" for f in _CAMERA_FIELDS)}
    unknown = set(arrays) - known
    missing = known - set(arrays)
    if unknown or missing:
        raise ValueError(f"DiffParams leaves: unknown {sorted(unknown)}, "
                         f"missing {sorted(missing)}")

    def t(path):  # a copy: the JAX package's arrays are read-only
        return torch.tensor(np.asarray(arrays[path], np.float32), device=device)

    return DiffParams(
        tex_color=t("tex_color"), tex_images=t("tex_images"),
        background=t("background"),
        camera=CameraParams(*(t(f"camera.{f}") for f in _CAMERA_FIELDS)),
    )


def apply_params(scene, params: DiffParams):
    """Swap the differentiable leaves into the scene."""
    textures = dataclasses.replace(scene.textures, color=params.tex_color,
                                   images=params.tex_images)
    return dataclasses.replace(scene, textures=textures)


def render_radiance_diff(params: DiffParams, scene, settings: RenderSettings,
                         key, *, device) -> torch.Tensor:
    """Differentiable radiance image (H, W, 3) as a function of ``params``."""
    settings = dataclasses.replace(settings, differentiable=True)
    img, _ = render_radiance(apply_params(scene, params), params.camera.build(),
                             settings, key, background=params.background,
                             device=device)
    return img


def l2_loss(params: DiffParams, scene, settings, key, target, *,
            device) -> torch.Tensor:
    img = render_radiance_diff(params, scene, settings, key, device=device)
    target = torch.as_tensor(target, dtype=torch.float32, device=img.device)
    return 0.5 * torch.mean((img - target) ** 2)


def render_loss_and_grad(params: DiffParams, scene, settings, key, target, *,
                         device) -> Tuple[torch.Tensor, DiffParams]:
    """(loss, dloss/dparams), the inverse-rendering training step.  The
    gradients come as a DiffParams on the leaves' devices."""
    leaves = [x.detach().requires_grad_(True) for x in params.leaves()]
    loss = l2_loss(DiffParams.from_leaves(leaves), scene, settings, key,
                   target, device=device)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    return loss.detach(), DiffParams.from_leaves(grads)
