"""Scene JSON: declarative scenes for the CLI.

Counterpart of ``rust_pathtracer_tpu/scene/json_io.py``, the same
schema; plain host code.  The reference has no config system (a scene
is a source edit, main.rs:20); here every construct it can express
round-trips through one document::

    {
      "perlin_seed": 0,
      "textures":   [{"type": "solid", "color": [r,g,b]},
                     {"type": "checker", "odd": ti, "even": ti, "frequency": 10.0},
                     {"type": "perlin", "scale": 4.0},
                     {"type": "image", "path": "tex.png"} |
                     {"type": "image", "data": [[[...]]]}],
      "materials":  [{"type": "lambertian", "texture": ti} |
                     {"type": "metal", "texture": ti, "fuzz": f} |
                     {"type": "dielectric", "ir": n} |
                     {"type": "light", "texture": ti}],
      "primitives": [{"type": "sphere", "center": [..], "radius": r, "material": mi} |
                     {"type": "rect", "plane": "xy|xz|yz", "start": [..], "end": [..],
                      "direction": +-1, "material": mi} |
                     {"type": "box", "start": [..], "end": [..], "material": mi} |
                     {"type": "triangle", "p1": [..], "p2": [..], "p3": [..],
                      "normal": [..]?, "material": mi} |
                     {"type": "obj", "path": "model.obj"}],
      "camera":     {"type": "static", "lookfrom": [..], "lookat": [..], "up": [..],
                     "vfov": deg, "aperture": a, "focus_dist": d}
                  | {"type": "orbit", ...SphereField orbit parameters...},
      "image":      {"width": w, "height": h, "samples_per_pixel": s,
                     "max_bounces": b, "background": [r,g,b]},
      "animation":  {"fps": 30.0, "duration": 10.0}?   // omitted: a static image
    }

Paths (image textures, OBJ files) are relative to the document's
directory.  An image texture's PNG is read with ``utils.image.read_png``
and taken to linear colour as ``(rgb / 255) ** 2`` in f32 numpy, so its
texels equal the JAX package's bit for bit.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

from rust_pathtracer_tpu_torch.camera import make_camera
from rust_pathtracer_tpu_torch.models.scenes import SceneDef
from rust_pathtracer_tpu_torch.render import OutputSettings, RenderSettings
from rust_pathtracer_tpu_torch.scene.builder import SceneBuilder


def _build_textures(b: SceneBuilder, specs, base_dir: str):
    ids = []
    for spec in specs:
        kind = spec["type"]
        if kind == "solid":
            ids.append(b.solid_texture(spec["color"]))
        elif kind == "checker":
            ids.append(b.checker_texture(ids[spec["odd"]], ids[spec["even"]],
                                         frequency=spec.get("frequency", 10.0)))
        elif kind == "perlin":
            ids.append(b.perlin_texture(spec["scale"]))
        elif kind == "image":
            if "data" in spec:
                img = np.asarray(spec["data"], np.float32)
            else:
                from rust_pathtracer_tpu_torch.utils.image import read_png

                img = read_png(os.path.join(base_dir, spec["path"])).astype(np.float32)
                img = (img / 255.0) ** 2.0  # sRGB-ish -> linear (gamma 2)
            ids.append(b.image_texture(img))
        else:
            raise ValueError(f"unknown texture type {kind!r}")
    return ids


def _build_materials(b: SceneBuilder, specs, tex_ids):
    ids = []
    for spec in specs:
        kind = spec["type"]
        if kind == "lambertian":
            ids.append(b.lambertian(tex_ids[spec["texture"]]))
        elif kind == "metal":
            ids.append(b.metal(tex_ids[spec["texture"]], spec["fuzz"]))
        elif kind == "dielectric":
            ids.append(b.dielectric(spec["ir"]))
        elif kind == "light":
            ids.append(b.diffuse_light(tex_ids[spec["texture"]]))
        else:
            raise ValueError(f"unknown material type {kind!r}")
    return ids


def _build_primitives(b: SceneBuilder, specs, mat_ids, base_dir: str):
    for spec in specs:
        kind = spec["type"]
        if kind == "sphere":
            b.add_sphere(spec["center"], spec["radius"], mat_ids[spec["material"]])
        elif kind == "rect":
            b.add_rect(spec["plane"], spec["start"], spec["end"],
                       spec.get("direction", 1.0), mat_ids[spec["material"]])
        elif kind == "box":
            b.add_box(spec["start"], spec["end"], mat_ids[spec["material"]])
        elif kind == "triangle":
            b.add_triangle(spec["p1"], spec["p2"], spec["p3"], mat_ids[spec["material"]],
                           normal=spec.get("normal"))
        elif kind == "obj":
            b.add_obj(os.path.join(base_dir, spec["path"]))
        else:
            raise ValueError(f"unknown primitive type {kind!r}")


def _camera_fn(spec, aspect):
    """``camera_at(t, device="cpu", make=make_camera)`` for a camera spec."""
    kind = spec.get("type", "static")
    if kind == "static":
        args = (spec["lookfrom"], spec["lookat"], spec.get("up", (0.0, 1.0, 0.0)),
                spec["vfov"], aspect)
        lens = dict(aperture=spec.get("aperture", 0.0),
                    focus_dist=spec.get("focus_dist", 10.0))

        def static_at(_t: float, device="cpu", make=make_camera):
            return make(*args, **lens, device=device)

        return static_at
    if kind == "orbit":
        # the SphereField orbit (scene.rs:61-89): lookfrom =
        # (R cos 2 pi t, y0 + y1 sin pi t, R sin 2 pi t)
        radius = spec.get("radius", 12.0)
        y0 = spec.get("y_base", 1.0)
        y1 = spec.get("y_amp", 2.0)
        lookat = spec.get("lookat", (0.0, 0.5, 0.0))
        up = spec.get("up", (0.0, 1.0, 0.0))
        vfov = spec.get("vfov", 20.0)
        lens = dict(aperture=spec.get("aperture", 0.1),
                    focus_dist=spec.get("focus_dist", 10.0))

        def orbit_at(t: float, device="cpu", make=make_camera):
            lookfrom = (
                radius * math.cos(2.0 * math.pi * t),
                y0 + y1 * math.sin(math.pi * t),
                radius * math.sin(2.0 * math.pi * t),
            )
            return make(lookfrom, lookat, up, vfov, aspect, **lens, device=device)

        return orbit_at
    raise ValueError(f"unknown camera type {kind!r}")


def scene_def_from_dict(doc: dict, base_dir: str = ".", name: str = "json",
                        use_bvh="auto", leaf_size: int = 4) -> SceneDef:
    """A ``SceneDef`` from a scene document: ``build(device="cpu")`` and
    ``camera_at(t, device="cpu", make=make_camera)`` as the built-in
    scenes'; ``use_bvh`` and ``leaf_size`` go to the builder."""
    img = doc["image"]
    settings = RenderSettings(
        width=int(img["width"]),
        height=int(img["height"]),
        samples_per_pixel=int(img["samples_per_pixel"]),
        max_bounces=int(img["max_bounces"]),
        background=tuple(img["background"]),
    )
    anim = doc.get("animation")
    output = OutputSettings(
        image=settings,
        fps=float(anim["fps"]) if anim else 0.0,
        duration=float(anim["duration"]) if anim else 0.0,
    )

    def build(device="cpu"):
        b = SceneBuilder(perlin_seed=int(doc.get("perlin_seed", 0)))
        tex_ids = _build_textures(b, doc.get("textures", []), base_dir)
        mat_ids = _build_materials(b, doc.get("materials", []), tex_ids)
        _build_primitives(b, doc["primitives"], mat_ids, base_dir)
        return b.build(use_bvh=use_bvh, leaf_size=leaf_size, device=device)

    camera_at = _camera_fn(doc["camera"], settings.width / settings.height)
    return SceneDef(name=name, build=build, camera_at=camera_at, output=output)


def load_scene_json(path: str, use_bvh="auto", leaf_size: int = 4) -> SceneDef:
    """``scene_def_from_dict`` of a file, its paths relative to the file's
    directory, named after the file."""
    with open(path) as f:
        doc = json.load(f)
    return scene_def_from_dict(
        doc,
        base_dir=os.path.dirname(os.path.abspath(path)),
        name=os.path.splitext(os.path.basename(path))[0],
        use_bvh=use_bvh,
        leaf_size=leaf_size,
    )


def save_scene_json(path: str, doc: dict) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
