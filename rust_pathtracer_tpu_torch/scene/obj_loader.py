"""Wavefront OBJ + MTL -> triangle rows in a SceneBuilder.

Counterpart of ``rust_pathtracer_tpu/scene/obj_loader.py`` (its Python
parser); plain host code, a copy of the JAX package's rules, which
follow obj_model.rs:19-111 (tobj with triangulate=true,
single_index=false):

* faces of more than 3 vertices are fan-triangulated;
* MTL materials (obj_model.rs:28-50): illum 7 -> dielectric(Ni),
  illum 5 -> metal(Kd, fuzz = 1 / Ns, so ``Ns 0`` gives an infinite
  fuzz), else lambertian(Kd); faces without a material ->
  lambertian(0.2, 0.7, 0.2), added only when some face needs it
  (obj_model.rs:82-84);
* a triangle's normal is the raw ``vn`` array indexed by its first
  vertex's POSITION index whenever the file has any ``vn`` line
  (obj_model.rs:87-96), else the geometric normal.

Not ported: the native C++ parser (``native.load_obj``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np


def parse_mtl(path: str) -> Dict[str, dict]:
    """The MTL fields the reference reads: Kd, Ns, Ni, illum.  Values
    round through f32, as the reference's tobj fields do."""
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    materials: Dict[str, dict] = {}
    cur: Optional[dict] = None
    if not os.path.exists(path):
        return materials
    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "newmtl":
                cur = dict(kd=(0.8, 0.8, 0.8), ns=1.0, ni=1.0, illum=2)
                materials[parts[1]] = cur
            elif cur is None:
                continue
            elif tag == "Kd":
                cur["kd"] = tuple(f32(x) for x in parts[1:4])
            elif tag == "Ns":
                cur["ns"] = f32(parts[1])
            elif tag == "Ni":
                cur["ni"] = f32(parts[1])
            elif tag == "illum":
                cur["illum"] = int(parts[1])
    return materials


def parse_obj(path: str):
    """OBJ geometry.

    ``usemtl`` binds against the materials loaded so far (unknown names
    -> -1; a re-declared name appends and rebinds); triangles with an
    out-of-range vertex index are dropped.  Returns (vertices (T, 3, 3)
    f64, vn array (N, 3) f64, first-vertex POSITION index per triangle
    (T,), material index per triangle (T,), list of material dicts).
    """
    positions: List[Tuple[float, float, float]] = []
    vnormals: List[Tuple[float, float, float]] = []
    tris: List[Tuple[int, int, int]] = []
    tri_mat: List[int] = []
    materials: List[dict] = []
    name_to_idx: Dict[str, int] = {}
    current_mat = -1

    base = os.path.dirname(os.path.abspath(path))
    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "v":
                positions.append(tuple(float(x) for x in parts[1:4]))
            elif tag == "vn":
                vnormals.append(tuple(float(x) for x in parts[1:4]))
            elif tag == "mtllib":
                for name, mdef in parse_mtl(os.path.join(base, parts[1])).items():
                    materials.append(mdef)
                    name_to_idx[name] = len(materials) - 1
            elif tag == "usemtl":
                current_mat = name_to_idx.get(parts[1], -1)
            elif tag == "f":
                corners = []
                nv = len(positions)
                for vspec in parts[1:]:
                    vi = int(vspec.split("/")[0])
                    corners.append(vi - 1 if vi > 0 else nv + vi)
                for i in range(1, len(corners) - 1):  # fan triangulation
                    v0, v1, v2 = corners[0], corners[i], corners[i + 1]
                    if not (0 <= v0 < nv and 0 <= v1 < nv and 0 <= v2 < nv):
                        continue
                    tris.append((v0, v1, v2))
                    tri_mat.append(current_mat)

    pos = np.asarray(positions, np.float64)
    verts = pos[np.asarray(tris, np.int64)] if tris else np.zeros((0, 3, 3))
    v0_idx = (np.asarray([t[0] for t in tris], np.int64)
              if tris else np.zeros(0, np.int64))
    mat_index = np.asarray(tri_mat, np.int32) if tris else np.zeros(0, np.int32)
    vns = (np.asarray(vnormals, np.float64) if vnormals
           else np.zeros((0, 3), np.float64))
    return verts, vns, v0_idx, mat_index, materials


def parse_obj_arrays(path: str):
    """(verts (T, 3, 3) f64, normals (T, 3) f64 (the first vertex's vn,
    or 0), has_normal (T,) bool, mat_index (T,) int32 (-1: none),
    material dicts with kd / ns / ni / illum)."""
    verts, vns, v0_idx, mat_index, materials = parse_obj(path)
    t = verts.shape[0]
    # the reference's rule: position-indexed into the raw vn array,
    # whenever the file has any vn (obj_model.rs:87-96)
    if t and vns.shape[0]:
        has_n = v0_idx < vns.shape[0]
    else:
        has_n = np.zeros(t, bool)
    normals = np.zeros((t, 3), np.float64)
    if vns.shape[0] and t:
        normals[has_n] = vns[v0_idx[has_n]]
    return verts, normals, has_n, mat_index, materials


def load_obj_into(builder, path: str, default_material: Optional[int] = None) -> int:
    """Append an OBJ's triangles to ``builder``; returns their count."""
    verts, vnorms, has_n, mat_index, materials = parse_obj_arrays(path)
    tcount = verts.shape[0]
    if tcount == 0:
        raise ValueError(f"OBJ {path!r} contains no triangles")

    mat_ids = []
    for m in materials:  # obj_model.rs:28-50
        if m["illum"] == 7:
            mat_ids.append(builder.dielectric(m["ni"]))
        elif m["illum"] == 5:
            # Ns 0 -> an infinite fuzz, as the reference's f64 division
            with np.errstate(divide="ignore"):
                fuzz = float(np.float64(1.0) / np.float64(m["ns"]))
            mat_ids.append(builder.metal(m["kd"], fuzz))
        else:
            mat_ids.append(builder.lambertian(m["kd"]))
    if default_material is not None:
        missing = default_material
    elif (mat_index < 0).any() or not mat_ids:
        # the reference's missing-material default, only when some
        # triangle needs it (obj_model.rs:82-84)
        missing = builder.lambertian((0.2, 0.7, 0.2))
    else:
        missing = 0  # unused: every triangle has a material
    mat_lut = np.asarray(mat_ids + [missing], np.int32)
    tri_mats = mat_lut[np.where(mat_index >= 0, mat_index, len(mat_ids))]

    e1 = verts[:, 1] - verts[:, 0]
    e2 = verts[:, 2] - verts[:, 0]
    geo_n = np.cross(e1, e2)
    geo_n = geo_n / np.maximum(np.linalg.norm(geo_n, axis=-1, keepdims=True), 1e-30)
    normals = np.where(has_n[:, None], vnorms, geo_n)

    builder.add_triangles(verts, tri_mats, normals)
    return tcount


def write_test_obj(path: str, with_mtl: bool = True) -> None:
    """A small asset (a pyramid and a cube) that exercises the MTL
    mapping."""
    base = os.path.dirname(os.path.abspath(path))
    os.makedirs(base, exist_ok=True)
    stem = os.path.splitext(os.path.basename(path))[0]
    mtl_name = stem + ".mtl"
    if with_mtl:
        with open(os.path.join(base, mtl_name), "w") as f:
            f.write(
                "newmtl body\nKd 0.7 0.3 0.2\nNs 10.0\nNi 1.0\nillum 2\n"
                "newmtl shiny\nKd 0.9 0.9 0.6\nNs 50.0\nNi 1.0\nillum 5\n"
                "newmtl glassy\nKd 1.0 1.0 1.0\nNs 100.0\nNi 1.5\nillum 7\n"
            )
    with open(path, "w") as f:
        if with_mtl:
            f.write(f"mtllib {mtl_name}\n")
        # pyramid (4 side faces + a quad base), apex up
        f.write("v 0 2 0\nv -1 0 -1\nv 1 0 -1\nv 1 0 1\nv -1 0 1\n")
        if with_mtl:
            f.write("usemtl body\n")
        f.write("f 1 3 2\nf 1 4 3\nf 1 5 4\nf 1 2 5\nf 2 3 4 5\n")
        # a small cube to the side (quads, fan-triangulated by the loader)
        f.write(
            "v 1.5 0 -0.5\nv 2.5 0 -0.5\nv 2.5 1 -0.5\nv 1.5 1 -0.5\n"
            "v 1.5 0 0.5\nv 2.5 0 0.5\nv 2.5 1 0.5\nv 1.5 1 0.5\n"
        )
        if with_mtl:
            f.write("usemtl shiny\n")
        # windings so that (p2-p1)x(p3-p1) points outward on every face
        f.write(
            "f 6 9 8 7\nf 10 11 12 13\nf 6 7 11 10\nf 9 13 12 8\n"
            "f 6 10 13 9\nf 7 8 12 11\n"
        )


def write_benchmark_obj(path: str, rows: int = 71, cols: int = 72,
                        with_mtl: bool = True) -> int:
    """A displaced-sphere "rock" of 2 * cols * (rows - 1) one-sided
    triangles, all wound outward, with smooth per-vertex normals: the
    reproducible ModelTest asset (the reference loads a user's
    ``model.obj``, main.rs:20-22).  The defaults give 10,080 triangles;
    ``rows=101, cols=100`` gives 20,000.  Returns the triangle count."""
    cy, base_r = 1.5, 1.3
    theta = np.linspace(0.0, np.pi, rows + 1)  # 0 = top pole
    phi = np.linspace(0.0, 2 * np.pi, cols, endpoint=False)

    def radius(t, p):
        return base_r * (
            1.0
            + 0.14 * np.sin(5 * t) * np.sin(4 * p)
            + 0.07 * np.sin(9 * t + 1.3) * np.sin(7 * p + 0.7)
            + 0.04 * np.sin(13 * t + 2.1) * np.cos(11 * p)
        )

    def vert(t, p):
        r = radius(t, p)
        return np.array(
            [r * np.sin(t) * np.cos(p), cy + r * np.cos(t), r * np.sin(t) * np.sin(p)]
        )

    verts = [vert(0.0, 0.0)]  # top pole
    for i in range(1, rows):
        for j in range(cols):
            verts.append(vert(theta[i], phi[j]))
    verts.append(vert(np.pi, 0.0))  # bottom pole
    verts = np.asarray(verts)
    top, bot = 0, len(verts) - 1

    def ring(i, j):  # i in [1, rows-1]
        return 1 + (i - 1) * cols + (j % cols)

    faces = []
    for j in range(cols):
        faces.append((top, ring(1, j), ring(1, j + 1)))
        faces.append((bot, ring(rows - 1, j + 1), ring(rows - 1, j)))
    for i in range(1, rows - 1):
        for j in range(cols):
            a, b = ring(i, j), ring(i, j + 1)
            c, d = ring(i + 1, j), ring(i + 1, j + 1)
            faces.append((a, c, b))
            faces.append((b, c, d))

    center = np.array([0.0, cy, 0.0])
    fixed = []
    for f in faces:
        p1, p2, p3 = verts[f[0]], verts[f[1]], verts[f[2]]
        n = np.cross(p2 - p1, p3 - p1)
        if np.dot(n, (p1 + p2 + p3) / 3.0 - center) < 0:
            f = (f[0], f[2], f[1])
        fixed.append(f)
    faces = fixed

    # smooth vertex normals by area-weighted face accumulation
    vnorm = np.zeros_like(verts)
    for f in faces:
        p1, p2, p3 = verts[f[0]], verts[f[1]], verts[f[2]]
        n = np.cross(p2 - p1, p3 - p1)
        for vi in f:
            vnorm[vi] += n
    vnorm /= np.maximum(np.linalg.norm(vnorm, axis=1, keepdims=True), 1e-12)

    base = os.path.dirname(os.path.abspath(path))
    os.makedirs(base, exist_ok=True)
    stem = os.path.splitext(os.path.basename(path))[0]
    mtl_name = stem + ".mtl"
    if with_mtl:
        with open(os.path.join(base, mtl_name), "w") as f:
            f.write(
                "newmtl rock\nKd 0.55 0.45 0.35\nNs 10.0\nNi 1.0\nillum 2\n"
                "newmtl vein\nKd 0.85 0.8 0.7\nNs 40.0\nNi 1.0\nillum 5\n"
            )
    with open(path, "w") as f:
        if with_mtl:
            f.write(f"mtllib {mtl_name}\n")
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for n in vnorm:
            f.write(f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}\n")
        if with_mtl:
            f.write("usemtl rock\n")
        switched = False
        for k, fa in enumerate(faces):
            if with_mtl and not switched and k >= 9 * len(faces) // 10:
                f.write("usemtl vein\n")  # the metal mapping at scale
                switched = True
            f.write("f {0}//{0} {1}//{1} {2}//{2}\n".format(
                fa[0] + 1, fa[1] + 1, fa[2] + 1))
    return len(faces)
