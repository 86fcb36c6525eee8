"""Inverse rendering: recover a sphere's albedo from a target image.

Counterpart of the JAX package's ``examples/inverse_rendering.py``, the
same scene, camera, settings, key and unknown: render a target with the
known materials, forget the sphere's albedo (texture row 0 set to 0.5),
and recover it by gradient descent through the path tracer
(``grad.render_loss_and_grad``; on the card the fused route, K1 with
residuals and K2).  Adam at 3e-2 (``torch.optim.Adam``: optax's
``adam`` defaults, eps outside the square root) on the gradient of the
unknown row alone; after each step the row is clipped to [0, 1] (a
clip of every row would clamp the light's emission of 4 to 1).

    python -m rust_pathtracer_tpu_torch.examples.inverse_rendering \\
        [--device cuda|cpu] [--steps 150] [--output-dir ./output]

The default device is ``cuda``, with no CPU fallback.  Writes
``inverse_target.png`` and ``inverse_recovered.png``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import torch

from rust_pathtracer_tpu_torch.grad import (
    CameraParams,
    DiffParams,
    render_loss_and_grad,
    render_radiance_diff,
)
from rust_pathtracer_tpu_torch.render import RenderSettings, resolve_device
from rust_pathtracer_tpu_torch.sampling import prng_key
from rust_pathtracer_tpu_torch.scene.builder import SceneBuilder

SETTINGS = RenderSettings(64, 64, 16, 5, (0.6, 0.7, 0.9))
TRUE_ALBEDO = (0.8, 0.2, 0.5)
GUESS = 0.5
LEARNING_RATE = 3e-2
SEED = 0


def build_scene(device="cpu"):
    """The sphere of unknown albedo (texture row 0) on a green ground,
    lit from above."""
    b = SceneBuilder()
    b.add_sphere((0.0, 0.2, -3.0), 1.0, b.lambertian(TRUE_ALBEDO))
    b.add_sphere((0.0, -101.0, -3.0), 100.0, b.lambertian((0.4, 0.6, 0.3)))
    b.add_rect("xz", (-3.0, 4.0, -6.0), (3.0, 4.0, 0.0), -1.0,
               b.diffuse_light((4.0, 4.0, 4.0)))
    return b.build(device=device)


def setup(settings: RenderSettings = SETTINGS, *, device):
    """(scene, true parameters, target image, starting parameters) on
    ``device``; the start is the truth with texture row 0 at GUESS."""
    dev = resolve_device(device)
    scene = build_scene(dev)
    cam = CameraParams.create((0, 0.5, 0.5), (0, 0, -3), (0, 1, 0), 55.0,
                              settings.width / settings.height, device=dev)
    truth = DiffParams.from_scene(scene, cam, settings.background)
    with torch.no_grad():
        target = render_radiance_diff(truth, scene, settings, prng_key(SEED, device=dev),
                                      device=dev)
    tex = truth.tex_color.detach().clone()
    tex[0] = GUESS
    return scene, truth, target, dataclasses.replace(truth, tex_color=tex)


def recover(scene, params: DiffParams, target, steps: int,
            settings: RenderSettings = SETTINGS, *, device, on_step=None):
    """``steps`` Adam steps on texture row 0; returns (parameters, the loss
    before each step).  ``on_step(i, loss, tex_color)`` is called after
    each, with the texture colours the step left."""
    dev = resolve_device(device)
    key = prng_key(SEED, device=dev)
    tex = params.tex_color.detach().clone().requires_grad_(True)
    unknown = torch.zeros_like(tex)
    unknown[0] = 1.0
    opt = torch.optim.Adam([tex], lr=LEARNING_RATE)
    losses = []
    for i in range(steps):
        loss, grads = render_loss_and_grad(dataclasses.replace(params, tex_color=tex),
                                           scene, settings, key, target, device=dev)
        opt.zero_grad()
        tex.grad = grads.tex_color * unknown
        opt.step()
        with torch.no_grad():
            tex[0].clamp_(0.0, 1.0)
        losses.append(float(loss))
        if on_step is not None:
            on_step(i, losses[-1], tex.detach().clone())
    return dataclasses.replace(params, tex_color=tex.detach()), losses


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--output-dir", default="./output")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda, but torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from rust_pathtracer_tpu_torch.utils.image import to_rgb8, write_png

    scene, truth, target, params = setup(device=args.device)
    write_png(os.path.join(args.output_dir, "inverse_target.png"),
              to_rgb8(target.cpu().numpy()))

    def log(i, loss, _tex):
        if i % 25 == 0:
            print(f"step {i:3d}  loss {loss:.3e}", flush=True)

    t0 = time.perf_counter()
    params, _ = recover(scene, params, target, args.steps, device=args.device,
                        on_step=log)
    seconds = time.perf_counter() - t0
    print("true sphere albedo:", truth.tex_color[0].cpu().numpy())
    print("recovered        :", params.tex_color[0].cpu().numpy().round(3))
    print(f"{args.steps} steps in {seconds:.3f} s ({seconds / max(args.steps, 1):.4f} s "
          "a step)")
    with torch.no_grad():
        final = render_radiance_diff(params, scene, SETTINGS,
                                     prng_key(SEED, device=args.device), device=args.device)
    write_png(os.path.join(args.output_dir, "inverse_recovered.png"),
              to_rgb8(final.cpu().numpy()))
    print(f"wrote {args.output_dir}/inverse_target.png and "
          f"{args.output_dir}/inverse_recovered.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
