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

A scene of more than 64 primitives is permuted into BVH-leaf order and
carries the threaded BVH (``BvhArrays``); one of more than 128 carries
the projected-sweep tables (``ops.projected.ProjTables``) instead of the
static kind list.
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
class BvhArrays:
    """Threaded (skip-link) flattened BVH in DFS order (``bvh.FlatBvh``
    without the permutation, which the primitives already carry): node
    i's first child is i + 1, ``miss[i]`` jumps over its subtree, a leaf
    holds ``leaf_count`` primitives from ``leaf_first``."""

    bbox_min: torch.Tensor    # float32[N, 3]
    bbox_max: torch.Tensor    # float32[N, 3]
    miss: torch.Tensor        # int32[N]  (-1 ends the traversal)
    leaf_first: torch.Tensor  # int32[N]
    leaf_count: torch.Tensor  # int32[N]  (0: interior node)

    def to(self, device) -> "BvhArrays":
        return _to(self, device)


@dataclasses.dataclass(frozen=True)
class SceneData:
    """Complete scene: three tables plus the static routing fields.

    ``kinds_static`` is the per-primitive (kind, aux) tuple for scenes
    of at most 128 primitives (None beyond, where ``proj`` holds the
    projected-sweep tables); ``bvh`` and ``leaf_size`` (0 without one)
    describe the BVH the primitives were permuted by; ``shade_static`` is True when every
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
    bvh: Optional[BvhArrays] = None
    leaf_size: int = 0
    proj: Optional[object] = None  # ops.projected.ProjTables

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
            bvh=None if self.bvh is None else self.bvh.to(device),
            proj=None if self.proj is None else self.proj.to(device),
        )


_PROJ_ARRAYS = ("a", "b", "const", "payload", "cluster_bounds", "cluster_bounds_v")
_PROJ_STATIC = ("group_kinds", "shade_ready", "col_block")


def scene_from_numpy(arrays: Mapping[str, np.ndarray], static: Mapping,
                     device="cpu") -> SceneData:
    """The port's SceneData from the JAX package's, carried across.

    ``arrays`` maps the JAX ``SceneData`` leaf paths (``"prims.kind"``,
    ``"materials.fuzz"``, ``"textures.perlin_seed"``, ``"bvh.miss"``,
    ``"proj.payload"``, ...) to numpy arrays; the five ``bvh.*`` leaves
    come all or none, and so do the six ``proj.*`` ones.  ``static``
    holds the static fields ``prim_types``, ``tex_types``,
    ``mat_types``, ``kinds_static`` (None beyond 128 primitives),
    ``shade_static``, ``checker_depth``, ``leaf_size`` (default 0) and,
    with the ``proj.*`` leaves, ``proj.group_kinds``,
    ``proj.shade_ready`` and ``proj.col_block``.  Raises ValueError for
    an unknown or a missing leaf.
    """
    groups = [("prims", Primitives), ("materials", Materials),
              ("textures", Textures)]
    if any(k.startswith("bvh.") for k in arrays):
        groups.append(("bvh", BvhArrays))
    known = {f"{group}.{f.name}" for group, cls in groups
             for f in dataclasses.fields(cls)}
    if any(k.startswith("proj.") for k in arrays):
        known |= {f"proj.{name}" for name in _PROJ_ARRAYS}
    unknown, missing = set(arrays) - known, known - set(arrays)
    if unknown or missing:
        raise ValueError(f"SceneData leaves: unknown {sorted(unknown)}, "
                         f"missing {sorted(missing)}")

    def t(path, dtype):
        return torch.tensor(np.asarray(arrays[path]), dtype=dtype,
                            device=device)

    i32, f32 = torch.int32, torch.float32
    bvh = proj = None
    if "bvh.miss" in arrays:
        bvh = BvhArrays(
            bbox_min=t("bvh.bbox_min", f32), bbox_max=t("bvh.bbox_max", f32),
            miss=t("bvh.miss", i32), leaf_first=t("bvh.leaf_first", i32),
            leaf_count=t("bvh.leaf_count", i32),
        )
    if "proj.a" in arrays:
        from rust_pathtracer_tpu_torch.ops.projected import ProjTables

        proj = ProjTables(
            **{name: t(f"proj.{name}", f32) for name in _PROJ_ARRAYS},
            group_kinds=tuple(int(k) for k in static["proj.group_kinds"]),
            shade_ready=bool(static["proj.shade_ready"]),
            col_block=int(static["proj.col_block"]),
        )
    kinds = static["kinds_static"]
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
        kinds_static=(None if kinds is None
                      else tuple((int(k), int(a)) for k, a in kinds)),
        shade_static=bool(static["shade_static"]),
        checker_depth=int(static["checker_depth"]),
        bvh=bvh,
        leaf_size=int(static.get("leaf_size", 0)),
        proj=proj,
    )
