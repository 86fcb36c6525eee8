"""Texture evaluation for a whole wavefront.

Counterpart of ``rust_pathtracer_tpu/textures.py``; plain tensor code.
Every texture kind of the scene is evaluated on every lane and ``where``
picks by kind, as in the JAX package; the table lookups are gathers.
Checker resolves its child ``checker_depth`` times (texture.rs:25-45
children may themselves be checkers).

Differentiable in the texture colours, the image texels, the hit point
(perlin, and the image through u and v) and u, v.  On CUDA the backward
of a gather accumulates in a fixed order (PyTorch sorts the indices),
so the texture gradients repeat bit for bit.  It runs each row's lanes
in sequence, so ``eval_texture`` keeps the lanes that carry no gradient
off the colour rows in use (``_color_rows``).

``eval_texture_payload`` reads a big scene's texture from the winner's
projected-sweep payload row instead (no table lookups).
"""

from __future__ import annotations

import torch

from rust_pathtracer_tpu_torch.perlin import marble
from rust_pathtracer_tpu_torch.scene.types import (
    TEX_CHECKER,
    TEX_IMAGE,
    TEX_PERLIN,
    TEX_SOLID,
    Textures,
)


# zero rows that the lanes without a hit read the colour from, lane i
# row i % SPARE_ROWS
SPARE_ROWS = 1024


def _color_rows(color, tex_id, valid):
    """``color[tex_id]`` on the ``valid`` lanes, 0 on the others, which
    read zero rows appended to the table.  A lane without a hit (a miss
    or a dead lane, its winner clamped to primitive 0) carries no
    gradient, but in the gather's backward it would join the sequential
    run of its row: every miss on one row in use made the SphereField
    step's backward twice as long.  Spread over SPARE_ROWS rows of their
    own, such lanes join no run in use and make no long one."""
    if valid is None:
        return color[tex_id]
    spare = color.shape[0] + torch.arange(
        tex_id.shape[0], device=tex_id.device) % SPARE_ROWS
    table = torch.cat([color, color.new_zeros(SPARE_ROWS, color.shape[1])])
    return table[torch.where(valid, tex_id, spare)]


def eval_texture(textures: Textures, tex_id, u, v, point, tex_types=None,
                 checker_depth=1, valid=None):
    """value(u, v, p) for per-lane texture ids.

    tex_id: (R,) int; u, v: (R,); point: (R, 3).  Returns (R, 3).
    ``tex_types`` (the scene's static field) skips the kinds the scene
    does not have; ``checker_depth`` is its deepest checker nesting.
    ``valid``, an optional (R,) bool mask of the lanes with a hit: the
    solid colour of the others is 0 (``_color_rows``)."""
    types = tex_types if tex_types is not None else (0, 1, 2, 3)
    tex_id = tex_id.long()
    kind, scale = textures.kind[tex_id], textures.scale[tex_id]

    if TEX_CHECKER in types:
        child = textures.child.long()
        for _ in range(max(checker_depth, 1)):
            # sines = sin(f x) sin(f y) sin(f z) < 0 picks the odd child
            s = torch.sin(scale[..., None] * point)
            sines = s[..., 0] * s[..., 1] * s[..., 2]
            picked = torch.where(sines < 0.0, child[tex_id, 0], child[tex_id, 1])
            tex_id = torch.where(kind == TEX_CHECKER, picked, tex_id)
            kind, scale = textures.kind[tex_id], textures.scale[tex_id]

    out = torch.zeros_like(point)
    if TEX_SOLID in types:
        color = _color_rows(textures.color, tex_id, valid)
        out = torch.where((kind == TEX_SOLID)[..., None], color, out)
    if TEX_PERLIN in types:
        gray = marble(point, textures.perlin_seed, scale)
        out = torch.where((kind == TEX_PERLIN)[..., None], gray[..., None], out)
    if TEX_IMAGE in types:
        img = sample_image(textures, textures.image_id[tex_id].long(), u, v)
        out = torch.where((kind == TEX_IMAGE)[..., None], img, out)
    return out


def eval_texture_payload(textures: Textures, row, u, v, point, tex_types=None):
    """The texture value from a projected-payload shading row
    (``ops/projected.py`` payload columns 16-31: material kind, fuzz,
    ir, texture kind, scale, color x3, odd x3, even x3, image id,
    spare).  The same values as ``eval_texture`` where every checker's
    children are solid (the tables' ``shade_ready``)."""
    types = tex_types if tex_types is not None else (0, 1, 2, 3)
    kind = torch.round(row[:, 3]).to(torch.int32)
    scale = row[:, 4]
    out = row[:, 5:8]  # TEX_SOLID color
    if TEX_CHECKER in types:
        s = torch.sin(scale[..., None] * point)
        sines = s[..., 0] * s[..., 1] * s[..., 2]
        picked = torch.where((sines < 0.0)[..., None], row[:, 8:11], row[:, 11:14])
        out = torch.where((kind == TEX_CHECKER)[..., None], picked, out)
    if TEX_PERLIN in types:
        gray = marble(point, textures.perlin_seed, scale)
        out = torch.where((kind == TEX_PERLIN)[..., None], gray[..., None], out)
    if TEX_IMAGE in types:
        img_id = torch.round(row[:, 14]).to(torch.int64).clamp(min=0)
        img = sample_image(textures, img_id, u, v)
        out = torch.where((kind == TEX_IMAGE)[..., None], img, out)
    return out


def sample_image(textures: Textures, img_id, u, v):
    """Bilinear sample of the padded image stack (``_sample_image_by_id``):
    x = u (w - 1), y = (1 - v) (h - 1), u and v clamped to [0, 1].
    Differentiable in the texels and in u, v."""
    hw = textures.image_hw[img_id].long()
    h = hw[..., 0].to(u.dtype)
    w = hw[..., 1].to(u.dtype)
    x = torch.clamp(u, 0.0, 1.0) * (w - 1.0)
    y = (1.0 - torch.clamp(v, 0.0, 1.0)) * (h - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    x1i = torch.minimum(x0i + 1, hw[..., 1] - 1)
    y1i = torch.minimum(y0i + 1, hw[..., 0] - 1)
    images = textures.images
    c00 = images[img_id, y0i, x0i]
    c01 = images[img_id, y0i, x1i]
    c10 = images[img_id, y1i, x0i]
    c11 = images[img_id, y1i, x1i]
    top = c00 * (1.0 - fx) + c01 * fx
    bot = c10 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy
