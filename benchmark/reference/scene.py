"""A scene as plain tensors, built from a configuration file's own data.

The configuration (``benchmark/configs/<config>.json``) lists the scene
as scene.rs writes it: textures (solid, checker of two non-checker
children, perlin marble with its ``scale``; the marble's hash seed is
the top-level ``perlin_seed``, default 0), materials, primitives
(spheres, axis rectangles, boxes, triangles), the camera and, for
SphereField, the rule of its random ball field (``field``: numpy's
``default_rng(seed)`` draws in scene.rs's order).  A kind the reference
cannot render raises.  Nothing here reads the program's tables.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root in ``x``'s type (the f64 root
    rounded: a CPU's f32 ``sqrt`` is not always correctly rounded)."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


MAT_KINDS = {"lambertian": 0, "metal": 1, "dielectric": 2, "light": 3}
TEX_SOLID, TEX_CHECKER, TEX_PERLIN = 0, 1, 2
TEX_KINDS = {"solid": TEX_SOLID, "checker": TEX_CHECKER, "perlin": TEX_PERLIN}
PRIM_KINDS = ("sphere", "rect", "box", "triangle", "field")
_AXIS = {"yz": 0, "xz": 1, "xy": 2}


class _Lists:
    """Textures, materials and primitives, appended in scene order."""

    def __init__(self):
        self.textures: List[dict] = []
        self.materials: List[dict] = []
        self.prims: List[dict] = []

    def solid(self, color) -> int:
        self.textures.append({"kind": "solid", "color": [float(c) for c in color]})
        return len(self.textures) - 1

    def material(self, kind, texture=0, fuzz=0.0, ir=1.0) -> int:
        self.materials.append({"kind": kind, "texture": int(texture),
                               "fuzz": float(fuzz), "ir": float(ir)})
        return len(self.materials) - 1

    def sphere(self, center, radius, material):
        self.prims.append({"kind": "sphere", "center": [float(c) for c in center],
                           "radius": float(radius), "material": int(material)})


def _sphere_field(field: dict, out: _Lists) -> None:
    """The random balls of SphereField (scene.rs:91-140): a grid of
    centres skipping the camera corridor, each ball lambertian, metal or
    glass by one draw, half the glass ones hollow."""
    rng = np.random.default_rng(int(field["seed"]))
    lo, hi = field["grid"]
    skip_a, skip_b = field["corridor_a"], field["corridor_b"]
    radius, y = field["radius"], field["y"]
    for a in range(lo, hi):
        for b in range(lo, hi):
            if skip_b[0] < b < skip_b[1] and skip_a[0] < a < skip_a[1]:
                continue
            center = (a + 0.5 * rng.random(), y, b + 0.9 * rng.random())
            choice = rng.random()
            if choice < field["p_lambertian"]:
                color = rng.random(3).astype(np.float32)
                mat = out.material("lambertian", out.solid(color))
                glass = False
            elif choice < field["p_metal"]:
                albedo = (0.5 + 0.5 * rng.random(3)).astype(np.float32)
                mat = out.material("metal", out.solid(albedo), fuzz=rng.random())
                glass = False
            else:
                mat = out.material("dielectric", ir=field["ir"])
                glass = True
            out.sphere(center, radius, mat)
            if glass and rng.random() < field["p_hollow"]:
                out.sphere(center, field["hollow_radius"], mat)


def _box_rects(p: dict) -> List[dict]:
    """A box as its six outward-facing rectangles (geometry.rs:391-446)."""
    mn = np.minimum(p["start"], p["end"])
    mx = np.maximum(p["start"], p["end"])
    m = p["material"]
    out = []
    for axis in (2, 1, 0):  # AABox::new's order: xy, xz, yz, near face first
        for k, sign in ((mn[axis], -1.0), (mx[axis], 1.0)):
            a, b = [i for i in range(3) if i != axis]
            out.append({"kind": "rect", "axis": axis, "k": float(k), "a0": float(mn[a]),
                        "a1": float(mx[a]), "b0": float(mn[b]), "b1": float(mx[b]),
                        "sign": sign, "material": m})
    return out


def _rect(p: dict) -> dict:
    axis = _AXIS[p["plane"]]
    a, b = [i for i in range(3) if i != axis]
    s, e = p["start"], p["end"]
    return {"kind": "rect", "axis": axis, "k": float(s[axis]),
            "a0": float(min(s[a], e[a])), "a1": float(max(s[a], e[a])),
            "b0": float(min(s[b], e[b])), "b1": float(max(s[b], e[b])),
            "sign": float(np.sign(p["direction"])), "material": int(p["material"])}


def scene_lists(config: dict) -> _Lists:
    """The configuration's textures, materials and primitives: boxes
    lowered to rectangles, and a ``field`` entry replaced by the field's
    random balls (with their own materials and textures appended)."""
    out = _Lists()
    out.textures = [dict(t) for t in config["textures"]]
    out.materials = [dict(m) for m in config["materials"]]
    for p in config["primitives"]:
        if p["kind"] not in PRIM_KINDS:
            raise ValueError(f"{config['name']}: the reference renders no {p['kind']!r} "
                             f"primitive; it knows {list(PRIM_KINDS)}")
        if p["kind"] == "box":
            out.prims.extend(_box_rects(p))
        elif p["kind"] == "rect":
            out.prims.append(_rect(p))
        elif p["kind"] == "field":
            _sphere_field(config["field"], out)
        else:
            out.prims.append(dict(p))
    _known_kinds(config["name"], out)
    return out


def _known_kinds(name: str, lists: _Lists) -> None:
    """Raise on a texture or material the reference cannot render."""
    for t in lists.textures:
        if t["kind"] not in TEX_KINDS:
            raise ValueError(f"{name}: the reference renders no {t['kind']!r} texture; "
                             f"it knows {list(TEX_KINDS)}")
        if t["kind"] == "perlin" and "scale" not in t:
            raise ValueError(f"{name}: a perlin texture needs its scale")
        if t["kind"] == "checker":
            for child in (t["odd"], t["even"]):
                if lists.textures[child]["kind"] == "checker":
                    raise ValueError(f"{name}: the reference renders no checker whose "
                                     "child is a checker")
    for m in lists.materials:
        if m["kind"] not in MAT_KINDS:
            raise ValueError(f"{name}: the reference renders no {m['kind']!r} material; "
                             f"it knows {list(MAT_KINDS)}")


def scene_tensors(config: dict, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The scene as tensors on ``device``: spheres, rectangles, triangles,
    materials and textures, floats in ``dtype``.  Primitive index order is
    the configuration's (``prim`` columns), so that a tie goes to the
    first primitive as scene.rs's list walk does."""
    lists = scene_lists(config)
    f = dict(dtype=dtype, device=device)
    i64 = dict(dtype=torch.int64, device=device)

    def pick(kind):
        return [(i, p) for i, p in enumerate(lists.prims) if p["kind"] == kind]

    sph, rec, tri = pick("sphere"), pick("rect"), pick("triangle")
    out = {
        "sph_c": torch.tensor([p["center"] for _, p in sph], **f).reshape(-1, 3),
        "sph_r": torch.tensor([p["radius"] for _, p in sph], **f),
        "sph_m": torch.tensor([p["material"] for _, p in sph], **i64),
        "sph_i": torch.tensor([i for i, _ in sph], **i64),
        "rect_axis": torch.tensor([p["axis"] for _, p in rec], **i64),
        "rect_v": torch.tensor([[p["k"], p["a0"], p["a1"], p["b0"], p["b1"], p["sign"]]
                                for _, p in rec], **f).reshape(-1, 6),
        "rect_m": torch.tensor([p["material"] for _, p in rec], **i64),
        "rect_i": torch.tensor([i for i, _ in rec], **i64),
        "tri_p": torch.tensor([[p["p1"], p["p2"], p["p3"]] for _, p in tri],
                              **f).reshape(-1, 3, 3),
        "tri_m": torch.tensor([p["material"] for _, p in tri], **i64),
        "tri_i": torch.tensor([i for i, _ in tri], **i64),
    }
    mats = lists.materials
    out["mat_kind"] = torch.tensor([MAT_KINDS[m["kind"]] for m in mats], **i64)
    out["mat_tex"] = torch.tensor([m.get("texture", 0) for m in mats], **i64)
    out["mat_fuzz"] = torch.tensor([m.get("fuzz", 0.0) for m in mats], **f)
    out["mat_ir"] = torch.tensor([m.get("ir", 1.0) for m in mats], **f)
    texs = lists.textures
    out["tex_kind"] = torch.tensor([TEX_KINDS[t["kind"]] for t in texs], **i64)
    out["tex_color"] = torch.tensor([t.get("color", [0.0, 0.0, 0.0]) for t in texs], **f)
    out["tex_odd"] = torch.tensor([t.get("odd", 0) for t in texs], **i64)
    out["tex_even"] = torch.tensor([t.get("even", 0) for t in texs], **i64)
    out["tex_scale"] = torch.tensor([t.get("scale", 0.0) for t in texs], **f)
    out["perlin_seed"] = int(config.get("perlin_seed", 0))
    out["n_prims"] = len(lists.prims)
    out["mat_types"] = {MAT_KINDS[m["kind"]] for m in mats}
    return out


def texture_index(config: dict, name: str) -> int:
    """The index of the texture a configuration names ``name``."""
    for i, t in enumerate(config["textures"]):
        if t.get("name") == name:
            return i
    raise KeyError(f"no texture named {name!r} in {config['name']}")


def camera_params(config: dict, t: float = 0.0) -> dict:
    """The camera's seven parameters at animation time ``t``: fixed, or
    the orbit of ``camera.orbit`` (scene.rs:61-89: radius R, height h0 +
    amp sin(pi t), angle 2 pi t)."""
    cam = dict(config["camera"])
    orbit = cam.pop("orbit", None)
    if orbit is not None:
        r, h0, amp = orbit["radius"], orbit["height"], orbit["height_amp"]
        cam["lookfrom"] = [r * math.cos(2.0 * math.pi * t),
                           h0 + amp * math.sin(math.pi * t),
                           r * math.sin(2.0 * math.pi * t)]
    return cam


def camera_frame(cam: dict, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The thin-lens camera's frame (camera.rs:14-44), in ``dtype``."""
    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    lookfrom, lookat, up = t(cam["lookfrom"]), t(cam["lookat"]), t(cam["vup"])
    h = torch.tan(t(cam["vfov"]) * (math.pi / 180.0) / t(2.0))
    viewport_h = 2.0 * h
    viewport_w = t(cam["aspect"]) * 2.0 * h

    def unit(v):
        return v / sqrt(torch.clamp((v[0] * v[0] + v[1] * v[1]) + v[2] * v[2], min=1e-20))

    def cross(a, b):
        return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                            a[0] * b[1] - a[1] * b[0]])

    w = unit(lookfrom - lookat)
    u = unit(cross(up, w))
    v = cross(w, u)
    focus = t(cam["focus_dist"])
    horizontal = focus * viewport_w * u
    vertical = focus * viewport_h * v
    llc = lookfrom - horizontal / t(2.0) - vertical / t(2.0) - focus * w
    return {"origin": lookfrom, "llc": llc, "horizontal": horizontal,
            "vertical": vertical, "u": u, "v": v,
            "lens_radius": t(cam["aperture"]) / t(2.0)}
