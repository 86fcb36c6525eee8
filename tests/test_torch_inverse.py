"""The inverse-rendering example of the port
(``rust_pathtracer_tpu_torch/examples/inverse_rendering.py``) against
the JAX package's (``examples/inverse_rendering.py``: the same scene,
camera, key and unknown, optax's ``adam``), at 16x16, 2 spp, 3 bounces.

Tolerances: the loss before each of the first 3 steps within 1e-4
relative of JAX's, and the unknown texture row after each within 1e-4
absolute (the two renders round differently: the image contract of
``utils/image.py``; torch's Adam is optax's formula, eps outside the
square root).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rust_pathtracer_tpu.grad import CameraParams as JCameraParams
from rust_pathtracer_tpu.grad import DiffParams as JDiffParams
from rust_pathtracer_tpu.grad import l2_loss as j_l2_loss
from rust_pathtracer_tpu.grad import render_radiance_diff as j_render_radiance_diff
from rust_pathtracer_tpu.render import RenderSettings as JRenderSettings
from rust_pathtracer_tpu.scene.builder import SceneBuilder as JSceneBuilder
from rust_pathtracer_tpu_torch.examples import inverse_rendering as inv
from rust_pathtracer_tpu_torch.render import RenderSettings
from rust_pathtracer_tpu_torch.utils.image import image_agreement

torch.set_num_threads(2)

SMALL = dict(width=16, height=16, samples_per_pixel=2, max_bounces=3,
             background=inv.SETTINGS.background)
STEPS = 3


def _jax_steps(steps):
    """JAX's example loop at SMALL: (target, losses, row 0 after each step)."""
    b = JSceneBuilder()
    b.add_sphere((0.0, 0.2, -3.0), 1.0, b.lambertian((0.8, 0.2, 0.5)))
    b.add_sphere((0.0, -101.0, -3.0), 100.0, b.lambertian((0.4, 0.6, 0.3)))
    b.add_rect("xz", (-3.0, 4.0, -6.0), (3.0, 4.0, 0.0), -1.0,
               b.diffuse_light((4.0, 4.0, 4.0)))
    scene = b.build()
    cam = JCameraParams.create((0, 0.5, 0.5), (0, 0, -3), (0, 1, 0), 55.0, 1.0)
    settings = JRenderSettings(**SMALL)
    key = jax.random.PRNGKey(0)
    truth = JDiffParams.from_scene(scene, cam, settings.background)
    target = j_render_radiance_diff(truth, scene, settings, key)
    params = truth._replace(tex_color=truth.tex_color.at[0].set(jnp.full(3, 0.5)))
    unknown = jnp.zeros_like(params.tex_color).at[0].set(1.0)
    opt = optax.adam(3e-2)
    state = opt.init(params.tex_color)
    grad_fn = jax.jit(lambda p: jax.value_and_grad(j_l2_loss)(p, scene, settings, key,
                                                              target))
    losses, rows = [], []
    for _ in range(steps):
        loss, grads = grad_fn(params)
        updates, state = opt.update(grads.tex_color * unknown, state)
        tex = optax.apply_updates(params.tex_color, updates)
        tex = jnp.where(unknown > 0, jnp.clip(tex, 0.0, 1.0), tex)
        params = params._replace(tex_color=tex)
        losses.append(float(loss))
        rows.append(np.asarray(tex[0]))
    return np.asarray(target), losses, rows


def test_first_steps_match_jax():
    settings = RenderSettings(**SMALL)
    scene, truth, target, params = inv.setup(settings, device="cpu")
    assert torch.equal(params.tex_color[1:], truth.tex_color[1:])
    assert params.tex_color[0].tolist() == [inv.GUESS] * 3
    rows = []
    final, losses = inv.recover(scene, params, target, STEPS, settings, device="cpu",
                                on_step=lambda i, loss, tex: rows.append(tex[0].numpy()))
    jtarget, jlosses, jrows = _jax_steps(STEPS)
    agree = image_agreement(target.numpy(), jtarget)
    assert agree["ok"], agree
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    for i, (row, jrow) in enumerate(zip(rows, jrows)):
        np.testing.assert_allclose(row, jrow, rtol=0, atol=1e-4, err_msg=f"step {i}")
    # only the unknown row moved, and it moved towards the truth's
    assert torch.equal(final.tex_color[1:], truth.tex_color[1:])
    moved = np.abs(rows[-1] - inv.TRUE_ALBEDO) < np.abs(inv.GUESS - np.array(inv.TRUE_ALBEDO))
    assert moved[[0, 1]].all(), rows[-1]


def test_example_needs_the_card_where_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    assert inv.main(["--device", "cuda", "--steps", "1"]) == 2
    with pytest.raises(RuntimeError, match="cuda"):
        inv.setup(device="cuda")
