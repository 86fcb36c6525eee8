"""Host-side scene assembly: Python API -> ``SceneData`` tables.

Counterpart of ``rust_pathtracer_tpu/scene/builder.py``; plain host
code (numpy, then tensors on the requested device).  Boxes are lowered
to 6 rects exactly as ``AABox::new`` does (geometry.rs:391-446); OBJ
meshes to triangle rows (``obj_loader.py``).

Each primitive's AABB follows the reference's padding: a sphere's
center +/- |r| (geometry.rs:165-170), a rect +/- 1e-4 on its thin axis
(geometry.rs:232-242), a triangle +/- 1e-3 on a flat axis
(geometry.rs:573-585).  Past BVH_AUTO_THRESHOLD primitives (or with
``use_bvh=True``) the BVH (``bvh.build_bvh``: the native builder, else
the numpy one) permutes the primitives into leaf order; past 128, the projected-sweep tables
(``ops/projected.build_projected``) replace the static kind list.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from rust_pathtracer_tpu_torch.bvh import build_bvh
from rust_pathtracer_tpu_torch.scene.types import (
    MAT_DIELECTRIC,
    MAT_LAMBERTIAN,
    MAT_LIGHT,
    MAT_METAL,
    PRIM_RECT,
    PRIM_SPHERE,
    PRIM_TRIANGLE,
    TEX_CHECKER,
    TEX_IMAGE,
    TEX_PERLIN,
    TEX_SOLID,
    BvhArrays,
    Materials,
    Primitives,
    SceneData,
    Textures,
)

# fixed-axis codes for rects; the two free axes (a, b) in ascending order
_RECT_FREE_AXES = {0: (1, 2), 1: (0, 2), 2: (0, 1)}
_RECT_NAME_TO_AXIS = {"yz": 0, "xz": 1, "xy": 2}

ColorLike = Union[Sequence[float], np.ndarray]

# use_bvh="auto" builds a BVH past this many primitives
BVH_AUTO_THRESHOLD = 64
# largest static primitive list (the table width of K1, K3 and K4);
# bigger scenes carry the projected tables
MAX_STATIC_PRIMS = 128


class SceneBuilder:
    def __init__(self, perlin_seed: int = 0):
        self._tex_kind: List[int] = []
        self._tex_color: List[np.ndarray] = []
        self._tex_child: List[tuple] = []
        self._tex_scale: List[float] = []
        self._tex_image: List[int] = []
        self._images: List[np.ndarray] = []

        self._mat_kind: List[int] = []
        self._mat_tex: List[int] = []
        self._mat_fuzz: List[float] = []
        self._mat_ir: List[float] = []

        self._prim_kind: List[int] = []
        self._prim_mat: List[int] = []
        self._prim_aux: List[int] = []
        self._prim_data: List[np.ndarray] = []
        self._bbox_min: List[np.ndarray] = []
        self._bbox_max: List[np.ndarray] = []

        self.perlin_seed = perlin_seed

    # ------------------------------------------------------------------
    # textures
    # ------------------------------------------------------------------
    def solid_texture(self, color: ColorLike) -> int:
        """SolidColorTexture (texture.rs:9-23)."""
        return self._push_tex(TEX_SOLID, color=color)

    def checker_texture(self, odd: int, even: int, frequency: float = 10.0) -> int:
        """CheckerTexture over two texture ids (texture.rs:25-45):
        sign(sin(f x) sin(f y) sin(f z)) < 0 selects ``odd``."""
        for child in (odd, even):
            if not 0 <= child < len(self._tex_kind):
                raise ValueError(f"unknown child texture id {child}")
        return self._push_tex(TEX_CHECKER, child=(odd, even), scale=frequency)

    def perlin_texture(self, scale: float) -> int:
        """PerlinNoiseTexture marble pattern (texture.rs:47-81)."""
        return self._push_tex(TEX_PERLIN, scale=scale)

    def image_texture(self, image: np.ndarray) -> int:
        """Image texture sampled at (u, v) with bilinear filtering; no
        reference counterpart (the JAX package's differentiable-texel
        texture).  ``image``: float (H, W, 3) in linear colour."""
        img = np.asarray(image, np.float32)
        if img.ndim != 3 or img.shape[-1] != 3:
            raise ValueError("image must be (H, W, 3)")
        self._images.append(img)
        return self._push_tex(TEX_IMAGE, image=len(self._images) - 1)

    def _push_tex(self, kind, color=(0, 0, 0), child=(0, 0), scale=0.0,
                  image=0) -> int:
        self._tex_kind.append(kind)
        self._tex_color.append(np.asarray(color, np.float32))
        self._tex_child.append(tuple(child))
        self._tex_scale.append(float(scale))
        self._tex_image.append(int(image))
        return len(self._tex_kind) - 1

    # ------------------------------------------------------------------
    # materials
    # ------------------------------------------------------------------
    def _tex_or_color(self, tex: Union[int, ColorLike]) -> int:
        if isinstance(tex, (int, np.integer)):
            return int(tex)
        return self.solid_texture(tex)

    def lambertian(self, albedo: Union[int, ColorLike]) -> int:
        """LambertianMaterial (material.rs:24-56); albedo = texture id or color."""
        return self._push_mat(MAT_LAMBERTIAN, tex=self._tex_or_color(albedo))

    def metal(self, albedo: Union[int, ColorLike], fuzz: float) -> int:
        """MetalMaterial (material.rs:58-94)."""
        return self._push_mat(MAT_METAL, tex=self._tex_or_color(albedo), fuzz=fuzz)

    def dielectric(self, index_of_refraction: float) -> int:
        """DielectricMaterial (material.rs:96-144)."""
        return self._push_mat(MAT_DIELECTRIC, ir=index_of_refraction)

    def diffuse_light(self, emit: Union[int, ColorLike]) -> int:
        """DiffuseLightMaterial, one-sided emitter (material.rs:146-167)."""
        return self._push_mat(MAT_LIGHT, tex=self._tex_or_color(emit))

    def _push_mat(self, kind, tex=0, fuzz=0.0, ir=1.0) -> int:
        self._mat_kind.append(kind)
        self._mat_tex.append(int(tex))
        self._mat_fuzz.append(float(fuzz))
        self._mat_ir.append(float(ir))
        return len(self._mat_kind) - 1

    # ------------------------------------------------------------------
    # primitives
    # ------------------------------------------------------------------
    def add_sphere(self, center: ColorLike, radius: float, material: int) -> int:
        """Sphere; a negative radius gives a hollow-glass inner shell whose
        normals point inward (geometry.rs:104-171)."""
        c = np.asarray(center, np.float32)
        data = np.zeros(12, np.float32)
        data[0:3] = c
        data[3] = float(radius)
        ar = abs(float(radius))
        return self._push_prim(PRIM_SPHERE, material, 0, data, c - ar, c + ar)

    def add_rect(
        self, plane: str, start: ColorLike, end: ColorLike, direction: float, material: int
    ) -> int:
        """Axis-aligned rectangle; ``plane`` in {"xy", "xz", "yz"}
        (RectangleXY/XZ/YZ::new, geometry.rs:189-207): min/max corners
        canonicalized, sign(direction) stored as the outward-normal sign."""
        start = np.asarray(start, np.float64)
        end = np.asarray(end, np.float64)
        fixed = _RECT_NAME_TO_AXIS[plane.lower()]
        a_ax, b_ax = _RECT_FREE_AXES[fixed]
        if start[fixed] != end[fixed]:
            raise ValueError(f"rectangle is not axis aligned on {'xyz'[fixed]}")
        a0, a1 = sorted((float(start[a_ax]), float(end[a_ax])))
        b0, b1 = sorted((float(start[b_ax]), float(end[b_ax])))
        k = float(start[fixed])
        data = np.zeros(12, np.float32)
        data[0] = k
        data[1], data[2] = a0, b0
        data[3], data[4] = a1, b1
        data[5] = np.sign(direction) if direction != 0 else 0.0
        bmin = np.zeros(3, np.float32)
        bmax = np.zeros(3, np.float32)
        bmin[a_ax], bmax[a_ax] = a0, a1
        bmin[b_ax], bmax[b_ax] = b0, b1
        bmin[fixed], bmax[fixed] = k - 1e-4, k + 1e-4  # geometry.rs:236-241
        return self._push_prim(PRIM_RECT, material, fixed, data, bmin, bmax)

    def add_box(self, start: ColorLike, end: ColorLike, material: int) -> List[int]:
        """Axis-aligned box lowered to 6 outward-facing rects
        (AABox::new, geometry.rs:391-446)."""
        start = np.asarray(start, np.float64)
        end = np.asarray(end, np.float64)
        mn = np.minimum(start, end)
        mx = np.maximum(start, end)
        return [
            self.add_rect("xy", (mn[0], mn[1], mn[2]), (mx[0], mx[1], mn[2]), -1.0, material),
            self.add_rect("xy", (mn[0], mn[1], mx[2]), (mx[0], mx[1], mx[2]), 1.0, material),
            self.add_rect("xz", (mn[0], mn[1], mn[2]), (mx[0], mn[1], mx[2]), -1.0, material),
            self.add_rect("xz", (mn[0], mx[1], mn[2]), (mx[0], mx[1], mx[2]), 1.0, material),
            self.add_rect("yz", (mn[0], mn[1], mn[2]), (mn[0], mx[1], mx[2]), -1.0, material),
            self.add_rect("yz", (mx[0], mn[1], mn[2]), (mx[0], mx[1], mx[2]), 1.0, material),
        ]

    def add_triangle(
        self,
        p1: ColorLike,
        p2: ColorLike,
        p3: ColorLike,
        material: int,
        normal: Optional[ColorLike] = None,
    ) -> int:
        """One-sided triangle (geometry.rs:466-589).  ``normal`` defaults
        to the normalized geometric normal (p2-p1)x(p3-p1)."""
        p1 = np.asarray(p1, np.float64)
        p2 = np.asarray(p2, np.float64)
        p3 = np.asarray(p3, np.float64)
        if normal is None:
            n = np.cross(p2 - p1, p3 - p1)
            n = n / max(np.linalg.norm(n), 1e-30)
        else:
            n = np.asarray(normal, np.float64)
        data = np.zeros(12, np.float32)
        data[0:3] = p1
        data[3:6] = p2 - p1
        data[6:9] = p3 - p1
        data[9:12] = n
        bmin = np.minimum(np.minimum(p1, p2), p3)
        bmax = np.maximum(np.maximum(p1, p2), p3)
        flat = bmin == bmax
        bmin = np.where(flat, bmin - 1e-3, bmin)  # geometry.rs:573-585
        bmax = np.where(flat, bmax + 1e-3, bmax)
        return self._push_prim(PRIM_TRIANGLE, material, 0, data,
                               bmin.astype(np.float32), bmax.astype(np.float32))

    def add_triangles(self, vertices: np.ndarray, materials: np.ndarray,
                      normals: Optional[np.ndarray] = None) -> None:
        """Triangles in bulk (OBJ meshes): ``vertices`` (T, 3, 3),
        ``materials`` (T,) ids, ``normals`` (T, 3) or None for the
        normalized geometric normals."""
        vertices = np.asarray(vertices, np.float64)
        tcount = vertices.shape[0]
        if normals is None:
            n = np.cross(vertices[:, 1] - vertices[:, 0], vertices[:, 2] - vertices[:, 0])
            n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
        else:
            n = np.asarray(normals, np.float64)
        data = np.zeros((tcount, 12), np.float32)
        data[:, 0:3] = vertices[:, 0]
        data[:, 3:6] = vertices[:, 1] - vertices[:, 0]
        data[:, 6:9] = vertices[:, 2] - vertices[:, 0]
        data[:, 9:12] = n
        bmin = vertices.min(axis=1)
        bmax = vertices.max(axis=1)
        flat = bmin == bmax
        bmin = np.where(flat, bmin - 1e-3, bmin)
        bmax = np.where(flat, bmax + 1e-3, bmax)
        for i in range(tcount):
            self._push_prim(PRIM_TRIANGLE, int(materials[i]), 0, data[i],
                            bmin[i].astype(np.float32), bmax[i].astype(np.float32))

    def add_obj(self, path: str, default_material: Optional[int] = None) -> None:
        """Load a Wavefront OBJ (+ MTL) as triangles, materials mapped as
        obj_model.rs:28-50 does (``obj_loader.load_obj_into``)."""
        from rust_pathtracer_tpu_torch.scene.obj_loader import load_obj_into

        load_obj_into(self, path, default_material=default_material)

    def _push_prim(self, kind, mat, aux, data, bmin, bmax) -> int:
        self._prim_kind.append(kind)
        self._prim_mat.append(int(mat))
        self._prim_aux.append(int(aux))
        self._prim_data.append(np.asarray(data, np.float32))
        self._bbox_min.append(np.asarray(bmin, np.float32))
        self._bbox_max.append(np.asarray(bmax, np.float32))
        return len(self._prim_kind) - 1

    # ------------------------------------------------------------------
    # build
    # ------------------------------------------------------------------
    @property
    def num_prims(self) -> int:
        return len(self._prim_kind)

    def build(self, use_bvh: Union[str, bool] = "auto", leaf_size: int = 4,
              device="cpu") -> SceneData:
        """Tables on ``device``, with the JAX builder's static fields.
        ``use_bvh``: True, False, or "auto" (a BVH past
        BVH_AUTO_THRESHOLD primitives); ``leaf_size``: primitives a BVH
        leaf."""
        if not self._prim_kind:
            raise ValueError("scene has no primitives")
        if not self._mat_kind:
            raise ValueError("scene has no materials")

        prim_kind = np.asarray(self._prim_kind, np.int32)
        prim_mat = np.asarray(self._prim_mat, np.int32)
        prim_aux = np.asarray(self._prim_aux, np.int32)
        prim_data = np.stack(self._prim_data)

        if use_bvh == "auto":
            use_bvh = len(prim_kind) > BVH_AUTO_THRESHOLD
        bvh = None
        if use_bvh:
            flat = build_bvh(np.stack(self._bbox_min), np.stack(self._bbox_max),
                             leaf_size=leaf_size)
            order = flat.prim_order
            prim_kind, prim_mat = prim_kind[order], prim_mat[order]
            prim_aux, prim_data = prim_aux[order], prim_data[order]
            bvh = BvhArrays(
                bbox_min=torch.as_tensor(flat.bbox_min, device=device),
                bbox_max=torch.as_tensor(flat.bbox_max, device=device),
                miss=torch.as_tensor(flat.miss, device=device),
                leaf_first=torch.as_tensor(flat.leaf_first, device=device),
                leaf_count=torch.as_tensor(flat.leaf_count, device=device),
            )

        # the padded (N, Hmax, Wmax, 3) image stack and each image's (h, w)
        if self._images:
            hmax = max(im.shape[0] for im in self._images)
            wmax = max(im.shape[1] for im in self._images)
            images = np.zeros((len(self._images), hmax, wmax, 3), np.float32)
            image_hw = np.zeros((len(self._images), 2), np.int32)
            for i, im in enumerate(self._images):
                images[i, : im.shape[0], : im.shape[1]] = im
                image_hw[i] = im.shape[:2]
        else:
            images = np.zeros((1, 1, 1, 3), np.float32)
            image_hw = np.ones((1, 2), np.int32)

        # the deepest checker nesting (texture ids only reference earlier
        # ids); eval_texture unrolls that many child resolutions
        checker_depth = 0
        depth_of: List[int] = []
        for k, (c0, c1) in zip(self._tex_kind, self._tex_child):
            depth_of.append(1 + max(depth_of[c0], depth_of[c1])
                            if k == TEX_CHECKER else 0)
            checker_depth = max(checker_depth, depth_of[-1])

        # shading is table-free (fused-bounce eligible) when every
        # texture is solid / perlin / a checker of two solid leaves
        shade_static = all(
            k in (TEX_SOLID, TEX_PERLIN)
            or (
                k == TEX_CHECKER
                and self._tex_kind[c0] == TEX_SOLID
                and self._tex_kind[c1] == TEX_SOLID
            )
            for k, (c0, c1) in zip(self._tex_kind, self._tex_child)
        )

        mats = (np.asarray(self._mat_kind, np.int32), np.asarray(self._mat_tex, np.int32),
                np.asarray(self._mat_fuzz, np.float32), np.asarray(self._mat_ir, np.float32))
        texs = (
            np.asarray(self._tex_kind, np.int32),
            np.stack(self._tex_color) if self._tex_color else np.zeros((1, 3), np.float32),
            np.asarray(self._tex_child, np.int32).reshape(-1, 2)
            if self._tex_child else np.zeros((1, 2), np.int32),
            np.asarray(self._tex_scale, np.float32)
            if self._tex_scale else np.zeros(1, np.float32),
            np.asarray(self._tex_image, np.int32)
            if self._tex_image else np.zeros(1, np.int32),
        )
        big = len(prim_kind) > MAX_STATIC_PRIMS
        proj = None
        if big:
            from rust_pathtracer_tpu_torch.ops.projected import build_projected

            proj = build_projected(prim_kind, prim_aux, prim_data, prim_mat,
                                   mats=mats, texs=texs, device=device)

        def t(x, dtype):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

        i32, f32 = torch.int32, torch.float32
        return SceneData(
            prims=Primitives(kind=t(prim_kind, i32), mat=t(prim_mat, i32),
                             aux=t(prim_aux, i32), data=t(prim_data, f32)),
            materials=Materials(kind=t(mats[0], i32), tex=t(mats[1], i32),
                                fuzz=t(mats[2], f32), ir=t(mats[3], f32)),
            textures=Textures(
                kind=t(texs[0], i32), color=t(texs[1], f32), child=t(texs[2], i32),
                scale=t(texs[3], f32), image_id=t(texs[4], i32),
                images=t(images, f32), image_hw=t(image_hw, i32),
                perlin_seed=int(self.perlin_seed),
            ),
            prim_types=tuple(sorted(set(int(k) for k in prim_kind))),
            tex_types=tuple(sorted(set(self._tex_kind))) if self._tex_kind else (),
            mat_types=tuple(sorted(set(self._mat_kind))),
            kinds_static=None if big else tuple(
                (int(k), int(a)) for k, a in zip(prim_kind, prim_aux)),
            shade_static=shade_static,
            checker_depth=checker_depth,
            bvh=bvh,
            leaf_size=int(leaf_size) if use_bvh else 0,
            proj=proj,
        )
