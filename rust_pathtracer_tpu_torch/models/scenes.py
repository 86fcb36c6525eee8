"""The six reference scenes (scene.rs:44-658).

Counterpart of ``rust_pathtracer_tpu/models/scenes.py``; plain host
code.  Geometry, materials, cameras and image settings are the JAX
package's value for value; SphereField's ball field takes the same
``np.random.default_rng(seed)`` draws in the same order, and ModelTest
loads an OBJ (``scene/obj_loader.write_benchmark_obj`` writes the
reproducible 10,080-triangle asset).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

import numpy as np

from rust_pathtracer_tpu_torch.camera import Camera, make_camera
from rust_pathtracer_tpu_torch.render import OutputSettings, RenderSettings
from rust_pathtracer_tpu_torch.scene.builder import SceneBuilder
from rust_pathtracer_tpu_torch.scene.types import SceneData


@dataclasses.dataclass(frozen=True)
class SceneDef:
    """Counterpart of the Scene trait (scene.rs:38-42).

    ``build(device="cpu")`` returns the scene tables on ``device``;
    ``camera_at(t, device="cpu", make=make_camera)`` the camera at
    animation time t, ``make`` applied to its seven parameters (pass
    ``grad.CameraParams.create`` for differentiable ones).  Each factory
    takes ``use_bvh`` ("auto", True, False) and ``leaf_size`` for the
    builder.
    """

    name: str
    build: Callable[..., SceneData]
    camera_at: Callable[..., Camera]
    output: OutputSettings


def _static(width, height, spp, bounces, background) -> OutputSettings:
    return OutputSettings(
        image=RenderSettings(
            width=width,
            height=height,
            samples_per_pixel=spp,
            max_bounces=bounces,
            background=background,
        )
    )


# ----------------------------------------------------------------------
# SphereField (scene.rs:44-171): the animated 500-ball field
# ----------------------------------------------------------------------
def sphere_field_scene(seed: int = 0, use_bvh="auto",
                       leaf_size: int = 4) -> SceneDef:
    def build(device="cpu") -> SceneData:
        rng = np.random.default_rng(seed)
        b = SceneBuilder()
        checker = b.checker_texture(
            b.solid_texture((0.2, 0.3, 0.1)), b.solid_texture((0.9, 0.9, 0.9))
        )
        b.add_sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian(checker))
        for a in range(-11, 11):
            for bb in range(-11, 11):
                if -1 < bb < 1 and -6 < a < 6:  # the camera corridor (scene.rs:107-109)
                    continue
                center = (a + 0.5 * rng.random(), 0.2, bb + 0.9 * rng.random())
                choice = rng.random()
                if choice < 0.6:
                    mat = b.lambertian(rng.random(3).astype(np.float32))
                    glass = False
                elif choice < 0.8:
                    albedo = (0.5 + 0.5 * rng.random(3)).astype(np.float32)
                    mat = b.metal(albedo, rng.random())
                    glass = False
                else:
                    mat = b.dielectric(1.5)
                    glass = True
                b.add_sphere(center, 0.2, mat)
                if glass and rng.random() < 0.5:
                    # a hollow shell: inner radius -0.2 + 0.02 (scene.rs:133)
                    b.add_sphere(center, -0.18, mat)
        big_glass = b.dielectric(1.5)
        b.add_sphere((-4.0, 1.0, 0.0), 1.0, big_glass)
        b.add_sphere((-4.0, 1.0, 0.0), -0.95, big_glass)
        b.add_sphere((4.0, 1.0, 0.0), 1.0, b.dielectric(1.5))
        b.add_sphere((0.0, 1.0, 0.0), 1.0, b.metal((0.7, 0.6, 0.5), 0.0))
        return b.build(use_bvh=use_bvh, leaf_size=leaf_size, device=device)

    def camera_at(t: float, device="cpu", make=make_camera) -> Camera:
        # the orbiting camera (scene.rs:61-89); lens aperture 0.1
        lookfrom = (
            12.0 * math.cos(2.0 * math.pi * t),
            1.0 + 2.0 * math.sin(math.pi * t),
            12.0 * math.sin(2.0 * math.pi * t),
        )
        return make(
            lookfrom, (0.0, 0.5, 0.0), (0.0, 1.0, 0.0),
            20.0, 854.0 / 480.0, aperture=0.1, focus_dist=10.0, device=device,
        )

    return SceneDef(
        name="SphereField",
        build=build,
        camera_at=camera_at,
        output=OutputSettings(
            image=RenderSettings(854, 480, 250, 20, (1.0, 1.0, 1.0)),
            fps=30.0,
            duration=10.0,
        ),
    )


# ----------------------------------------------------------------------
# TwoSphereCheckers (scene.rs:173-236)
# ----------------------------------------------------------------------
def two_sphere_checkers_scene(use_bvh="auto", leaf_size: int = 4) -> SceneDef:
    def build(device="cpu") -> SceneData:
        b = SceneBuilder()
        checker = b.checker_texture(
            b.solid_texture((0.2, 0.3, 0.1)), b.solid_texture((0.9, 0.9, 0.9))
        )
        b.add_sphere((0.0, -10.0, 0.0), 10.0, b.lambertian(checker))
        b.add_sphere((0.0, 10.0, 0.0), 10.0, b.lambertian(b.perlin_texture(4.0)))
        return b.build(use_bvh=use_bvh, leaf_size=leaf_size, device=device)

    def camera_at(_t: float, device="cpu", make=make_camera) -> Camera:
        return make(
            (13.0, 2.0, 3.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
            20.0, 854.0 / 480.0, aperture=0.0, focus_dist=10.0, device=device,
        )

    return SceneDef(
        name="TwoSphereCheckers",
        build=build,
        camera_at=camera_at,
        output=_static(854, 480, 250, 20, (1.0, 1.0, 1.0)),
    )


# ----------------------------------------------------------------------
# LightTest (scene.rs:238-326)
# ----------------------------------------------------------------------
def light_test_scene(use_bvh="auto", leaf_size: int = 4) -> SceneDef:
    def build(device="cpu") -> SceneData:
        b = SceneBuilder()
        perlin_mat = b.lambertian(b.perlin_texture(4.0))
        b.add_sphere((0.0, -1000.0, 0.0), 1000.0, perlin_mat)
        b.add_sphere((0.0, 2.0, 0.0), 2.0, perlin_mat)
        light = b.diffuse_light((4.0, 4.0, 4.0))
        b.add_rect("xy", (3.0, 1.0, -2.0), (5.0, 3.0, -2.0), 1.0, light)
        b.add_rect("xz", (-1.0, 6.0, -1.0), (1.0, 6.0, 1.0), -1.0, light)
        b.add_rect("yz", (-6.0, 1.0, -2.0), (-6.0, 3.0, 2.0), 1.0, light)
        return b.build(use_bvh=use_bvh, leaf_size=leaf_size, device=device)

    def camera_at(_t: float, device="cpu", make=make_camera) -> Camera:
        return make(
            (26.0, 3.0, 6.0), (0.0, 2.0, 0.0), (0.0, 1.0, 0.0),
            20.0, 854.0 / 480.0, aperture=0.0, focus_dist=10.0, device=device,
        )

    return SceneDef(
        name="LightTest",
        build=build,
        camera_at=camera_at,
        output=_static(854, 480, 2000, 50, (0.0, 0.0, 0.0)),
    )


# ----------------------------------------------------------------------
# Cornell walls shared by CornellBox + TriangleTest (scene.rs:384-439, 523-578)
# ----------------------------------------------------------------------
def _cornell_walls(b: SceneBuilder):
    red = b.lambertian((0.65, 0.05, 0.05))
    white = b.lambertian((0.73, 0.73, 0.73))
    green = b.lambertian((0.12, 0.45, 0.15))
    light = b.diffuse_light((15.0, 15.0, 15.0))
    b.add_rect("yz", (555.0, 0.0, 0.0), (555.0, 555.0, 555.0), -1.0, green)
    b.add_rect("yz", (0.0, 0.0, 0.0), (0.0, 555.0, 555.0), 1.0, red)
    b.add_rect("xz", (0.0, 555.0, 0.0), (555.0, 555.0, 555.0), -1.0, white)
    b.add_rect("xz", (0.0, 0.0, 0.0), (555.0, 0.0, 555.0), 1.0, white)
    b.add_rect("xz", (213.0, 554.0, 227.0), (343.0, 554.0, 332.0), -1.0, light)
    b.add_rect("xy", (0.0, 0.0, 555.0), (555.0, 555.0, 555.0), -1.0, white)
    return white


def _cornell_camera(_t: float, device="cpu", make=make_camera) -> Camera:
    return make(
        (278.0, 278.0, -800.0), (278.0, 278.0, 0.0), (0.0, 1.0, 0.0),
        40.0, 1.0, aperture=0.0, focus_dist=10.0, device=device,
    )


def cornell_box_scene(use_bvh="auto", leaf_size: int = 4) -> SceneDef:
    """CornellBox (scene.rs:328-465): walls + two white boxes + two glass
    spheres."""

    def build(device="cpu") -> SceneData:
        b = SceneBuilder()
        white = _cornell_walls(b)
        b.add_box((130.0, 0.0, 65.0), (295.0, 165.0, 230.0), white)
        b.add_box((265.0, 0.0, 295.0), (430.0, 330.0, 460.0), white)
        glass = b.dielectric(1.5)
        b.add_sphere((212.5, 255.0, 147.5), 90.0, glass)
        b.add_sphere((347.5, 420.0, 377.5), 90.0, glass)
        return b.build(use_bvh=use_bvh, leaf_size=leaf_size, device=device)

    return SceneDef(
        name="CornellBox",
        build=build,
        camera_at=_cornell_camera,
        output=_static(400, 400, 1000, 20, (0.0, 0.0, 0.0)),
    )


def triangle_test_scene(use_bvh="auto", leaf_size: int = 4) -> SceneDef:
    """TriangleTest (scene.rs:467-595): Cornell walls + glass & white
    triangles."""

    def build(device="cpu") -> SceneData:
        b = SceneBuilder()
        white = _cornell_walls(b)
        glass = b.dielectric(1.5)
        b.add_triangle(
            (200.0, 100.0, 100.0), (300.0, 300.0, 500.0), (400.0, 100.0, 100.0), glass
        )
        b.add_triangle(
            (100.0, 300.0, 100.0), (150.0, 400.0, 250.0), (100.0, 300.0, 400.0), white
        )
        return b.build(use_bvh=use_bvh, leaf_size=leaf_size, device=device)

    return SceneDef(
        name="TriangleTest",
        build=build,
        camera_at=_cornell_camera,
        output=_static(400, 400, 1000, 20, (0.0, 0.0, 0.0)),
    )


# ----------------------------------------------------------------------
# ModelTest (scene.rs:597-658): checker ground + an OBJ mesh
# ----------------------------------------------------------------------
def model_test_scene(obj_path: str = "./model.obj", use_bvh="auto",
                     leaf_size: int = 4) -> SceneDef:
    def build(device="cpu") -> SceneData:
        b = SceneBuilder()
        checker = b.checker_texture(
            b.solid_texture((0.2, 0.3, 0.1)), b.solid_texture((0.9, 0.9, 0.9))
        )
        b.add_sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian(checker))
        b.add_obj(obj_path)
        return b.build(use_bvh=use_bvh, leaf_size=leaf_size, device=device)

    def camera_at(_t: float, device="cpu", make=make_camera) -> Camera:
        return make(
            (0.0, 2.5, -7.0), (0.0, 1.5, 0.0), (0.0, 1.0, 0.0),
            60.0, 1.0, aperture=0.0, focus_dist=10.0, device=device,
        )

    return SceneDef(
        name="ModelTest",
        build=build,
        camera_at=camera_at,
        output=_static(800, 800, 250, 20, (1.0, 1.0, 1.0)),
    )


SCENES: Dict[str, Callable[..., SceneDef]] = {
    "SphereField": sphere_field_scene,
    "TwoSphereCheckers": two_sphere_checkers_scene,
    "LightTest": light_test_scene,
    "CornellBox": cornell_box_scene,
    "TriangleTest": triangle_test_scene,
    "ModelTest": model_test_scene,
}


def get_scene(name: str, **kwargs) -> SceneDef:
    try:
        factory = SCENES[name]
    except KeyError:
        raise KeyError(f"unknown scene {name!r}; available: {sorted(SCENES)}")
    return factory(**kwargs)
