"""Flattened SoA scene tables as dataclasses of tensors.

Counterpart of ``rust_pathtracer_tpu/scene/types.py``; plain tensor
code.  The layout of every table is the JAX package's, so that
``scene_from_numpy`` can carry a JAX ``SceneData`` across leaf for
leaf and the tests can compare the two builders table for table.

Primitive ``data`` layout (float32[P, 12]):
  sphere   (kind 0): cx cy cz r  .  .  .  .  .  .  .  .
  rect     (kind 1): k a0 b0 a1 b1 dir .  .  .  .  .  .
      aux = fixed axis (0: YZ-rect, 1: XZ, 2: XY); (a, b) are the two
      free axes in ascending order; dir = outward-normal sign.
  triangle (kind 2): p1(3) e1(3) e2(3) n(3)

Not ported yet: the BVH arrays and the projected-sweep tables (ROADMAP
queue 1 items 10 and 11).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

PRIM_SPHERE = 0
PRIM_RECT = 1
PRIM_TRIANGLE = 2

MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_LIGHT = 3

TEX_SOLID = 0
TEX_CHECKER = 1
TEX_PERLIN = 2
TEX_IMAGE = 3


def _to(obj, device):
    return dataclasses.replace(
        obj,
        **{
            f.name: getattr(obj, f.name).to(device)
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)
        },
    )


@dataclasses.dataclass(frozen=True)
class Primitives:
    kind: torch.Tensor  # int32[P]
    mat: torch.Tensor   # int32[P]
    aux: torch.Tensor   # int32[P]   (rect fixed axis)
    data: torch.Tensor  # float32[P, 12]

    def to(self, device) -> "Primitives":
        return _to(self, device)


@dataclasses.dataclass(frozen=True)
class Materials:
    kind: torch.Tensor  # int32[M]
    tex: torch.Tensor   # int32[M]   albedo / emission texture id
    fuzz: torch.Tensor  # float32[M] metal fuzz (material.rs:60)
    ir: torch.Tensor    # float32[M] dielectric index of refraction

    def to(self, device) -> "Materials":
        return _to(self, device)


@dataclasses.dataclass(frozen=True)
class Textures:
    kind: torch.Tensor   # int32[T]
    color: torch.Tensor  # float32[T, 3] solid color
    child: torch.Tensor  # int32[T, 2]  checker (odd, even) leaf ids
    scale: torch.Tensor  # float32[T]   perlin scale / checker frequency
    image_id: torch.Tensor  # int32[T]    row into ``images``
    images: torch.Tensor    # float32[I, Hmax, Wmax, 3] padded image stack
    image_hw: torch.Tensor  # int32[I, 2]  valid (h, w) per image
    perlin_seed: int = 0  # perlin hash-stream seed (uint32)

    def to(self, device) -> "Textures":
        return _to(self, device)


@dataclasses.dataclass(frozen=True)
class SceneData:
    """Complete scene: three tables plus the static routing fields.

    ``kinds_static`` is the per-primitive (kind, aux) tuple for scenes
    of at most 128 primitives; ``shade_static`` is True when every
    texture is solid, perlin or a checker of two solids, so that the
    whole bounce fits the fused-bounce kernel; ``checker_depth`` is the
    deepest checker nesting, the child resolutions ``eval_texture``
    unrolls.
    """

    prims: Primitives
    materials: Materials
    textures: Textures
    prim_types: Tuple[int, ...] = (PRIM_SPHERE, PRIM_RECT, PRIM_TRIANGLE)
    tex_types: Tuple[int, ...] = (TEX_SOLID, TEX_CHECKER, TEX_PERLIN)
    mat_types: Tuple[int, ...] = (
        MAT_LAMBERTIAN, MAT_METAL, MAT_DIELECTRIC, MAT_LIGHT,
    )
    kinds_static: Optional[Tuple[Tuple[int, int], ...]] = None
    shade_static: bool = False
    checker_depth: int = 1

    @property
    def num_prims(self) -> int:
        return self.prims.kind.shape[0]

    @property
    def device(self) -> torch.device:
        return self.prims.data.device

    def to(self, device) -> "SceneData":
        return dataclasses.replace(
            self,
            prims=self.prims.to(device),
            materials=self.materials.to(device),
            textures=self.textures.to(device),
        )


def scene_from_numpy(arrays: Mapping[str, np.ndarray], static: Mapping,
                     device="cpu") -> SceneData:
    """The port's SceneData from the JAX package's, carried across.

    ``arrays`` maps the JAX ``SceneData`` leaf paths (``"prims.kind"``,
    ``"materials.fuzz"``, ``"textures.perlin_seed"``, ...) to numpy
    arrays; ``static`` holds its static fields ``prim_types``,
    ``tex_types``, ``mat_types``, ``kinds_static``, ``shade_static`` and
    ``checker_depth``.  Raises ValueError for an unknown or a missing
    leaf, and NotImplementedError for what the port cannot render yet:
    a BVH, or more than 128 primitives.
    """
    if any(k.startswith("bvh.") for k in arrays):
        raise NotImplementedError(
            "BVH scenes are not ported yet (ROADMAP queue 1 item 10)")
    if static["kinds_static"] is None:
        raise NotImplementedError(
            "scenes of more than 128 primitives are not ported yet "
            "(ROADMAP queue 1 item 11)")
    known = {
        f"{group}.{f.name}"
        for group, cls in (("prims", Primitives), ("materials", Materials),
                           ("textures", Textures))
        for f in dataclasses.fields(cls)
    }
    unknown, missing = set(arrays) - known, known - set(arrays)
    if unknown or missing:
        raise ValueError(f"SceneData leaves: unknown {sorted(unknown)}, "
                         f"missing {sorted(missing)}")

    def t(path, dtype):
        return torch.tensor(np.asarray(arrays[path]), dtype=dtype,
                            device=device)

    i32, f32 = torch.int32, torch.float32
    return SceneData(
        prims=Primitives(
            kind=t("prims.kind", i32), mat=t("prims.mat", i32),
            aux=t("prims.aux", i32), data=t("prims.data", f32),
        ),
        materials=Materials(
            kind=t("materials.kind", i32), tex=t("materials.tex", i32),
            fuzz=t("materials.fuzz", f32), ir=t("materials.ir", f32),
        ),
        textures=Textures(
            kind=t("textures.kind", i32), color=t("textures.color", f32),
            child=t("textures.child", i32), scale=t("textures.scale", f32),
            image_id=t("textures.image_id", i32), images=t("textures.images", f32),
            image_hw=t("textures.image_hw", i32),
            perlin_seed=int(np.asarray(arrays["textures.perlin_seed"])),
        ),
        prim_types=tuple(int(k) for k in static["prim_types"]),
        tex_types=tuple(int(k) for k in static["tex_types"]),
        mat_types=tuple(int(k) for k in static["mat_types"]),
        kinds_static=tuple(
            (int(k), int(a)) for k, a in static["kinds_static"]
        ),
        shade_static=bool(static["shade_static"]),
        checker_depth=int(static["checker_depth"]),
    )
