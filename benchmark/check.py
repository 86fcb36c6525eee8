"""The comparison that decides ``correct``.

Frames: a sample of the frames completed in the window, drawn from the
seed, and in each the pixels ``loops.check_pixels`` drew; the plain
reference (``reference/pathtracer.py``) renders those pixels from the
configuration's own scene data with the frame's key and camera, and the
numbers are

* ``pixel_mae``: the mean absolute gap over the sampled pixels' channels,
  as a share of the reference's mean absolute value;
* ``pixel_max``: the widest gap of one channel of one pixel.

Steps: the reference follows the program's first steps (its own target,
its own loss and gradient in blocks of pixels, its own Adam and clip),
and the numbers are

* ``loss_gap``: the worst step's |program loss - reference loss| over
  the reference loss;
* ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient (the program's worked out from Adam's first moment after one
  step) over the larger of its reference norm and the median leaf's;
* ``change_gap``: the same for the norm of each leaf's change over the
  first steps, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone).

The control computes the same numbers with the reference, at a lower
precision, in the program's place (``control.py``).
"""

from __future__ import annotations

import random
import statistics

import torch

from benchmark.loops import TARGET_INDEX, image
from benchmark.reference import pathtracer as pt
from benchmark.reference import scene as rs
from benchmark.reference.threefry import frame_key

F32 = (torch.float32, torch.float64)
BF16 = (torch.bfloat16, torch.float32)


def sampled_frames(seed: int, n_answers: int, n_checked: int) -> list:
    """Which of the window's answers the check compares, from the seed."""
    rng = random.Random(int(seed) * 104729 + 3)
    return sorted(rng.sample(range(n_answers), min(n_checked, n_answers)))


def reference_pixels(cell, key, t, pixels, img, device, precision=F32, block_lanes=1 << 22):
    """The reference's mean radiance of ``pixels`` of the frame (key, t)."""
    dtype, root = precision
    cfg = cell.config
    sc = rs.scene_tensors(cfg, device, dtype=dtype)
    cam = rs.camera_frame(rs.camera_params(cfg, t), device, dtype=dtype)
    with torch.no_grad():
        return pt.render_pixels(
            sc, cam, key, pixels.to(device), width=img["width"], height=img["height"],
            spp=img["samples_per_pixel"], spp_chunk=img["spp_chunk"],
            max_bounces=img["max_bounces"], background=cfg["background"], dtype=dtype,
            root_dtype=root, block_lanes=block_lanes).float()


def frame_numbers(got: list, want: list) -> dict:
    """``pixel_mae`` and ``pixel_max`` of the program's sampled pixels
    ``got`` against the reference's ``want`` (lists of (P, 3) tensors)."""
    g = torch.cat([x.float().cpu() for x in got])
    w = torch.cat([x.float().cpu() for x in want])
    gap = (g - w).abs()
    if not bool(torch.isfinite(g).all()):
        return {"pixel_mae": float("inf"), "pixel_max": float("inf")}
    return {"pixel_mae": float(gap.sum() / w.abs().sum().clamp(min=1e-30)),
            "pixel_max": float(gap.max())}


def check_frames(cell, seed, answers, pixels, device, toy=False, precision=F32):
    """(numbers, frames checked) for a window's ``answers`` ((index, orbit
    time, sampled pixels) each)."""
    img = image(cell, toy)
    n = 1 if toy else cell.traffic["check"]["frames"]
    picked = sampled_frames(seed, len(answers), n)
    got, want = [], []
    for j in picked:
        i, t, px = answers[j]
        got.append(px)
        want.append(reference_pixels(cell, frame_key(seed, i), t, pixels, img, device,
                                     precision))
    return frame_numbers(got, want), len(picked)


def reference_steps(cell, seed, device, toy=False, precision=F32, block_lanes=1 << 22,
                    stride=1):
    """The reference's first steps: (losses, first gradients, leaves after
    the steps, the leaves' start) on the configuration's own scene.
    ``stride`` 2 is a fault: every other pixel, the loss their mean."""
    dtype, root = precision
    cfg, tr = cell.config, cell.traffic
    img = image(cell, toy)
    sc = rs.scene_tensors(cfg, device, dtype=dtype)
    cam = rs.camera_frame(rs.camera_params(cfg), device, dtype=dtype)
    W, H = img["width"], img["height"]
    pixels = torch.arange(W * H, device=device)[::stride]
    kw = dict(width=W, height=H, spp=img["samples_per_pixel"], spp_chunk=img["spp_chunk"],
              max_bounces=img["max_bounces"], background=cfg["background"], dtype=dtype,
              root_dtype=root, block_lanes=block_lanes)
    with torch.no_grad():
        target = pt.render_pixels(sc, cam, frame_key(seed, TARGET_INDEX), pixels, **kw)
    rows = [rs.texture_index(cfg, n) for n in tr["unknown"]]
    leaves = [torch.full((3,), float(tr["guess"]), dtype=dtype, device=device)
              for _ in rows]
    start = [x.clone() for x in leaves]
    m = [torch.zeros_like(x, dtype=torch.float32) for x in leaves]
    v = [torch.zeros_like(x, dtype=torch.float32) for x in leaves]
    lr, b1, b2, eps = float(tr["learning_rate"]), 0.9, 0.999, 1e-8
    losses, first_grads = [], None
    n_el = float(pixels.shape[0] * 3)
    for k in range(tr["first_steps"]):
        colors = sc["tex_color"].clone()
        for r, x in zip(rows, leaves):
            colors[r] = x
        colors.requires_grad_(True)
        total = torch.zeros((), dtype=torch.float64, device=device)

        def on_block(block, sl):
            nonlocal total
            part = 0.5 * ((block - target[sl]) ** 2).sum() / n_el
            part.backward()
            total = total + part.detach().to(torch.float64)

        pt.render_pixels(sc, cam, frame_key(seed, k), pixels, colors=colors,
                         on_block=on_block, **kw)
        grads = [colors.grad[r].float() for r in rows]
        losses.append(float(total))
        if k == 0:
            first_grads = [g.clone() for g in grads]
        # Adam (optax's defaults, as torch.optim.Adam), then the clip
        for j, g in enumerate(grads):
            m[j] = b1 * m[j] + (1.0 - b1) * g
            v[j] = b2 * v[j] + (1.0 - b2) * g * g
            mh = m[j] / (1.0 - b1 ** (k + 1))
            vh = v[j] / (1.0 - b2 ** (k + 1))
            leaves[j] = torch.clamp(leaves[j].float() - lr * mh / (vh.sqrt() + eps),
                                    0.0, 1.0).to(dtype)
    return losses, first_grads, leaves, start


def step_numbers(prog, ref) -> dict:
    """``loss_gap``, ``grad_gap`` and ``change_gap`` of the program's
    first steps ``prog`` against the reference's ``ref``, each (losses,
    first gradients, leaves after, leaves at the start)."""
    p_loss, p_grad, p_after, p_start = prog
    r_loss, r_grad, r_after, r_start = ref
    loss_gap = max(abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
                   for a, b in zip(p_loss, r_loss))
    r_gn = [float(g.float().norm()) for g in r_grad]
    med_g = statistics.median(r_gn)
    grad_gap = max(abs(float(pg.float().norm()) - rn) / max(rn, med_g, 1e-30)
                   for pg, rn in zip(p_grad, r_gn))
    p_ch = [float((a.float() - s.float()).norm()) for a, s in zip(p_after, p_start)]
    r_ch = [float((a.float() - s.float()).norm()) for a, s in zip(r_after, r_start)]
    counted = [j for j, rn in enumerate(r_gn) if rn >= 1e-3 * med_g]
    med_c = statistics.median([r_ch[j] for j in counted]) if counted else 0.0
    change_gap = max((abs(p_ch[j] - r_ch[j]) / max(r_ch[j], med_c, 1e-30) for j in counted),
                     default=0.0)
    finite = all(map(lambda x: x == x and abs(x) != float("inf"),
                     [*map(float, p_loss), *p_ch]))
    if not finite:
        return {"loss_gap": float("inf"), "grad_gap": float("inf"),
                "change_gap": float("inf")}
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}


def judge(numbers: dict, limits: dict):
    """(correct, lines): each number beside its limit; correct when every
    number is at or under its limit."""
    lines, ok = [], True
    for name, value in numbers.items():
        lim = float(limits[name]["limit"])
        good = value <= lim
        ok = ok and good
        lines.append((name, value, lim, good))
    return ok, lines
