"""Material dispatch for the ray wavefront: emission and scatter.

Counterpart of ``rust_pathtracer_tpu/materials.py``; plain tensor code.
Every material branch of the scene runs on every lane and ``where``
picks by material kind, as in the JAX package:

* lambertian: normal + a point on the unit sphere; a near-zero
  direction falls back to the normal (material.rs:41-47);
* metal: mirror reflection of the unit incident direction plus fuzz;
  the ray is absorbed when the unfuzzed reflection points below the
  surface (material.rs:77-93, the test runs before the fuzz is added);
* dielectric: the eta ratio flips with the face, total internal
  reflection or a Schlick coin picks reflect over refract, attenuation
  exactly 1 (material.rs:117-143).  Quirk kept: Schlick takes the eta
  ratio, not the index (material.rs:109-113, 128);
* diffuse light: never scatters, emits on its front face only
  (material.rs:159-166).

``shade_inputs`` reads the material and texture tables, or, for a big
scene's forward route, the winner's payload shading row.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rust_pathtracer_tpu_torch import vecmath as vm
from rust_pathtracer_tpu_torch.ops.intersect import HitRecord
from rust_pathtracer_tpu_torch.scene.types import (
    MAT_DIELECTRIC,
    MAT_LAMBERTIAN,
    MAT_LIGHT,
    MAT_METAL,
)
from rust_pathtracer_tpu_torch.textures import eval_texture, eval_texture_payload


class ScatterResult(NamedTuple):
    did_scatter: torch.Tensor  # bool (R,)
    direction: torch.Tensor    # f32 (R, 3), unnormalized like the reference
    attenuation: torch.Tensor  # f32 (R, 3)


class ShadeInputs(NamedTuple):
    """Per-lane material parameters and the texture value at the hit,
    computed once a bounce (one texture serves emission and albedo)."""

    kind: torch.Tensor   # int (R,) material kind
    fuzz: torch.Tensor   # f32 (R,)
    ir: torch.Tensor     # f32 (R,)
    value: torch.Tensor  # f32 (R, 3) texture value at the hit


def shade_inputs(scene, hit: HitRecord, shade_row=None) -> ShadeInputs:
    """ShadeInputs from the material and texture tables, or from a
    payload ``shade_row`` (R, 16): payload columns 16-31 of the
    projected sweep (``materials.shade_inputs``)."""
    if shade_row is not None:
        kind = torch.round(shade_row[:, 0]).to(torch.int32)
        value = eval_texture_payload(scene.textures, shade_row, hit.u, hit.v,
                                     hit.point, scene.tex_types)
        return ShadeInputs(kind, shade_row[:, 1], shade_row[:, 2], value)
    mats = scene.materials
    m = hit.mat.long()
    kind, tex, fuzz, ir = mats.kind[m], mats.tex[m], mats.fuzz[m], mats.ir[m]
    # a dielectric-only scene has no texture consumer (attenuation is 1)
    needs_value = bool({MAT_LAMBERTIAN, MAT_METAL, MAT_LIGHT} & set(scene.mat_types))
    value = (eval_texture(scene.textures, tex, hit.u, hit.v, hit.point,
                          scene.tex_types, checker_depth=scene.checker_depth,
                          valid=hit.valid)
             if needs_value else torch.zeros_like(hit.point))
    return ShadeInputs(kind, fuzz, ir, value)


def emitted(scene, hit: HitRecord, si: ShadeInputs) -> torch.Tensor:
    """Emitted radiance at the hit: light material only, front face only."""
    if MAT_LIGHT not in scene.mat_types:
        return torch.zeros_like(hit.point)
    on = (si.kind == MAT_LIGHT) & hit.front_face
    return torch.where(on[..., None], si.value, torch.zeros_like(si.value))


def scatter(scene, hit: HitRecord, d_in, sphere_dir, ball_dir, coin,
            si: ShadeInputs) -> ScatterResult:
    """Scatter the wavefront off its hit materials.

    d_in: incident (unnormalized) directions; sphere_dir: points ON the
    unit sphere; ball_dir: points IN the unit ball; coin: U[0,1) for the
    dielectric's reflect-or-refract choice."""
    kind, fuzz, ir, albedo = si.kind, si.fuzz, si.ir, si.value
    n = hit.normal
    did = torch.zeros(kind.shape, dtype=torch.bool, device=kind.device)
    direction = torch.zeros_like(d_in)
    attenuation = torch.zeros_like(albedo)

    if MAT_LAMBERTIAN in scene.mat_types:
        d_l = n + sphere_dir
        d_l = vm.where(vm.near_zero(d_l), n, d_l)  # material.rs:44-47
        sel = kind == MAT_LAMBERTIAN
        did = did | sel
        direction = vm.where(sel, d_l, direction)
        attenuation = vm.where(sel, albedo, attenuation)

    if MAT_METAL in scene.mat_types:
        refl = vm.reflect(vm.normalize(d_in), n)
        ok = vm.dot(refl, n) > 0.0  # absorbed below the surface (material.rs:80, 91)
        d_m = refl + fuzz[..., None] * ball_dir
        sel = kind == MAT_METAL
        did = did | (sel & ok)
        direction = vm.where(sel, d_m, direction)
        attenuation = vm.where(sel, albedo, attenuation)

    if MAT_DIELECTRIC in scene.mat_types:
        ratio = torch.where(hit.front_face, torch.reciprocal(ir), ir)  # material.rs:118-122
        ud = vm.normalize(d_in)
        cos_t = torch.clamp(vm.dot(-ud, n), max=1.0)
        sin_t = vm.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        cannot_refract = ratio * sin_t > 1.0
        # material.rs:126-131
        choose_reflect = cannot_refract | (_schlick(cos_t, ratio) > coin)
        d_d = vm.where(choose_reflect, vm.reflect(ud, n), vm.refract(ud, n, ratio))
        sel = kind == MAT_DIELECTRIC
        did = did | sel
        direction = vm.where(sel, d_d, direction)
        attenuation = vm.where(sel, torch.ones_like(attenuation), attenuation)

    # MAT_LIGHT: no scatter (material.rs:16-18)
    return ScatterResult(did_scatter=did, direction=direction, attenuation=attenuation)


def _schlick(cosine, refraction_index):
    """Schlick's r0 + (1 - r0)(1 - cos)^5 (material.rs:109-113), the
    integer powers as XLA expands them."""
    r0 = (1.0 - refraction_index) / (1.0 + refraction_index)
    r0 = r0 * r0
    one_c = 1.0 - cosine
    one_c2 = one_c * one_c
    return r0 + (1.0 - r0) * (one_c * (one_c2 * one_c2))
