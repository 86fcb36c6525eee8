"""The plain path tracer that decides ``correct``.

Ray.color of ray.rs:20-41 over a batch of lanes, in plain tensor ops:
camera lanes (renderer.rs:16-25, camera.rs:46-56), the closest hit over
every primitive (geometry.rs: spheres with their quadratic in float64
as the configuration states, axis rectangles, one-sided triangles),
the texture (solid, the sine checker of texture.rs:25-45, the perlin
marble of ``perlin.py`` in all three channels), emission on
a light's front face, the background on a miss, and the lambertian,
metal and dielectric scatter of material.rs, each lane drawing the
stream of ``threefry.py``.  Lanes that stop are dropped, so each bounce
works on the live lanes only.  No kernels, no tables, no BVH.

``dtype`` and ``root_dtype`` set the precision: float32 with float64
sphere roots is the configuration's; bfloat16 with float32 roots is the
control, the step below.  A colour table that requires grad makes the
radiance differentiable in it (throughput and emission products; the
paths themselves are detached, the estimator the program differentiates).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from benchmark.reference import threefry as tf
from benchmark.reference.perlin import marble
from benchmark.reference.scene import TEX_PERLIN, sqrt

T_MIN = 1e-3     # ray.rs:25
T_MISS = 3.0e38  # no hit
NEAR_ZERO = 1e-8  # vec3.rs:7
SAFE_EPS = 1e-20
MAT_L, MAT_M, MAT_D, MAT_E = 0, 1, 2, 3
SEARCH_ELEMENTS = 1 << 25  # (lane, primitive) pairs a step of the search holds


def _dot(a, b):
    return (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]) + a[:, 2] * b[:, 2]


def _sphere_t(o, d, c, r, root_dtype):
    """(n, S) sphere hit distances: the nearest root in [T_MIN, inf),
    T_MISS where none; the quadratic and each root divided by |d|^2 in
    ``root_dtype`` (geometry.rs:132-163 in f64), then rounded."""
    o64, d64 = o.to(root_dtype)[:, None, :], d.to(root_dtype)[:, None, :]
    c64, r64 = c.to(root_dtype)[None], r.to(root_dtype)[None]
    oc = o64 - c64
    half_b = (d64[..., 0] * oc[..., 0] + d64[..., 1] * oc[..., 1]) + d64[..., 2] * oc[..., 2]
    cc = (oc[..., 0] * oc[..., 0] + oc[..., 1] * oc[..., 1]) + oc[..., 2] * oc[..., 2] - r64 * r64
    a = (d64[..., 0] * d64[..., 0] + d64[..., 1] * d64[..., 1]) + d64[..., 2] * d64[..., 2]
    dis = half_b * half_b - a * cc
    sq = torch.sqrt(torch.clamp(dis, min=0.0))
    r1 = ((-half_b - sq) / a).to(o.dtype)
    r2 = ((-half_b + sq) / a).to(o.dtype)
    ok1, ok2 = r1 >= T_MIN, r2 >= T_MIN
    t = torch.where(ok1, r1, r2)
    return torch.where((dis >= 0.0) & (ok1 | ok2), t, torch.full_like(t, T_MISS))


def _rect_t(o, d, axis, v):
    """(n, Q) rectangle hit distances (geometry.rs:210-231)."""
    free = torch.tensor([[1, 2], [0, 2], [0, 1]], device=o.device)[axis]  # (Q, 2)
    o_k = o[:, axis]
    d_k = d[:, axis]
    t = (v[None, :, 0] - o_k) / d_k
    av = o[:, free[:, 0]] + t * d[:, free[:, 0]]
    bv = o[:, free[:, 1]] + t * d[:, free[:, 1]]
    ok = ((t >= T_MIN) & (t <= T_MISS) & (av >= v[None, :, 1]) & (av <= v[None, :, 2])
          & (bv >= v[None, :, 3]) & (bv <= v[None, :, 4]))
    return torch.where(ok, t, torch.full_like(t, T_MISS))


def _tri_t(o, d, p):
    """(n, T) one-sided triangle hit distances (geometry.rs:519-549)."""
    p1, e1, e2 = p[None, :, 0], p[None, :, 1] - p[None, :, 0], p[None, :, 2] - p[None, :, 0]
    dd, oo = d[:, None, :], o[:, None, :]

    def cross(a, b):
        return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)

    def dot(a, b):
        return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]

    pvec = cross(dd, e2)
    det = dot(e1, pvec)
    inv = 1.0 / torch.where(det.abs() > 1e-30, det, torch.ones_like(det))
    tvec = oo - p1
    u = dot(tvec, pvec) * inv
    qvec = cross(tvec, e1)
    v = dot(dd, qvec) * inv
    t = dot(e2, qvec) * inv
    ok = ((det >= 1e-4) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t >= T_MIN))
    return torch.where(ok, t, torch.full_like(t, T_MISS))


def closest_hit(sc, o, d, root_dtype):
    """(t, primitive index in scene order, -1 on a miss) for every lane:
    the first primitive at the least distance."""
    n, dev = o.shape[0], o.device
    best_t = torch.full((n,), T_MISS, dtype=o.dtype, device=dev)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=dev)
    step = max(1, SEARCH_ELEMENTS // max(sc["n_prims"], 1))
    idx = torch.cat([sc["sph_i"], sc["rect_i"], sc["tri_i"]])
    order = torch.argsort(idx)  # scene order, so that the first primitive wins a tie
    idx = idx[order]
    for s in range(0, n, step):
        oo, dd = o[s:s + step], d[s:s + step]
        ts = []
        if sc["sph_r"].numel():
            ts.append(_sphere_t(oo, dd, sc["sph_c"], sc["sph_r"], root_dtype))
        if sc["rect_m"].numel():
            ts.append(_rect_t(oo, dd, sc["rect_axis"], sc["rect_v"]))
        if sc["tri_m"].numel():
            ts.append(_tri_t(oo, dd, sc["tri_p"]))
        t_all = torch.cat(ts, dim=1)[:, order]
        t_min = t_all.amin(dim=1)
        first = (t_all == t_min[:, None]).to(torch.int8).argmax(dim=1)
        best_t[s:s + step] = t_min
        best_i[s:s + step] = torch.where(t_min < T_MISS, idx[first], -1)
    return best_t, best_i


class _Prims:
    """Per-primitive lookups in scene order: kind, material, geometry."""

    def __init__(self, sc):
        n, dev = sc["n_prims"], sc["mat_kind"].device
        f = sc["sph_c"].dtype
        self.kind = torch.full((n,), -1, dtype=torch.int64, device=dev)
        self.mat = torch.zeros(n, dtype=torch.int64, device=dev)
        self.center = torch.zeros((n, 3), dtype=f, device=dev)
        self.radius = torch.ones(n, dtype=f, device=dev)
        self.normal = torch.zeros((n, 3), dtype=f, device=dev)
        self.kind[sc["sph_i"]] = 0
        self.mat[sc["sph_i"]] = sc["sph_m"]
        self.center[sc["sph_i"]] = sc["sph_c"]
        self.radius[sc["sph_i"]] = sc["sph_r"]
        self.kind[sc["rect_i"]] = 1
        self.mat[sc["rect_i"]] = sc["rect_m"]
        onehot = torch.nn.functional.one_hot(sc["rect_axis"], 3).to(f)
        self.normal[sc["rect_i"]] = onehot * sc["rect_v"][:, 5:6]
        self.kind[sc["tri_i"]] = 2
        self.mat[sc["tri_i"]] = sc["tri_m"]
        p = sc["tri_p"]
        e1, e2 = p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
        cr = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                          e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                          e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], dim=-1)
        if cr.numel():
            cr = cr / sqrt(torch.clamp((cr * cr).sum(-1, keepdim=True), min=1e-30))
        self.normal[sc["tri_i"]] = cr


def camera_lanes(cam, key, pixel, sample, *, width, height, spp, dtype):
    """Lane keys (k0, k1), origins and directions of (pixel, sample)
    lanes (renderer.rs:16-25, camera.rs:46-56)."""
    k = torch.tensor(key, dtype=torch.int64, device=pixel.device)
    k0, k1 = tf.fold_in(k[0].expand_as(pixel), k[1].expand_as(pixel),
                        (pixel * spp + sample) & tf.M32)
    jit = tf.purpose_uniforms(k0, k1, 0, tf.P_JITTER, 2).to(dtype)
    col = (pixel % width).to(dtype)
    y = (height - 1 - pixel // width).to(dtype)
    s = (col + jit[:, 0]) / torch.tensor(width - 1.0, dtype=dtype, device=pixel.device)
    t = (y + jit[:, 1]) / torch.tensor(height - 1.0, dtype=dtype, device=pixel.device)
    lu = tf.purpose_uniforms(k0, k1, 0, tf.P_LENS, 2).to(dtype)
    r = sqrt(lu[:, 0])
    theta = (2.0 * math.pi) * lu[:, 1]
    dx, dy = r * torch.cos(theta), r * torch.sin(theta)
    lr = cam["lens_radius"]
    rx, ry = lr * dx, lr * dy
    blur = cam["u"] * rx[:, None] + cam["v"] * ry[:, None]
    origin = cam["origin"] + blur
    direction = (cam["llc"] + s[:, None] * cam["horizontal"] + t[:, None] * cam["vertical"]
                 - cam["origin"] - blur)
    return k0, k1, origin, direction


def trace(sc, cam, key, pixel, sample, *, width, height, spp, max_bounces, background,
          colors: Optional[torch.Tensor] = None, dtype=torch.float32,
          root_dtype=torch.float64):
    """Radiance (R, 3) of the (pixel, sample) lanes.  ``colors``: the
    texture colour table to read (default the scene's); if it requires
    grad, so does the radiance."""
    dev = pixel.device
    colors = sc["tex_color"] if colors is None else colors
    prims = _Prims(sc)
    bg = torch.as_tensor(background, dtype=dtype, device=dev)
    k0, k1, o, d = camera_lanes(cam, key, pixel, sample, width=width, height=height,
                                spp=spp, dtype=dtype)
    R = pixel.shape[0]
    rad = torch.zeros((R, 3), dtype=dtype, device=dev)
    if colors.requires_grad:
        rad = rad + 0.0 * colors.sum()
    thr = torch.ones((R, 3), dtype=dtype, device=dev)
    lane = torch.arange(R, device=dev)
    two_pi = 2.0 * math.pi
    for bounce in range(max_bounces):
        if lane.numel() == 0:
            break
        t, pid = closest_hit(sc, o, d, root_dtype)
        hit = pid >= 0
        miss = ~hit
        if bool(miss.any()):
            rad = rad.index_add(0, lane[miss], thr[miss] * bg)
        lane, o, d, thr, t, pid = lane[hit], o[hit], d[hit], thr[hit], t[hit], pid[hit]
        k0, k1 = k0[hit], k1[hit]
        if lane.numel() == 0:
            break
        point = o + t[:, None] * d
        kind = prims.kind[pid]
        outward = prims.normal[pid]
        sph = kind == 0
        if bool(sph.any()):
            r = prims.radius[pid][:, None]
            n_s = (point - prims.center[pid]) / r  # geometry.rs: (p - c) / r
            outward = torch.where(sph[:, None], n_s, outward)
        front = _dot(d, outward) < 0.0
        n = torch.where(front[:, None], outward, -outward)
        mat = prims.mat[pid]
        mkind = sc["mat_kind"][mat]
        tex = sc["mat_tex"][mat]
        ck = sc["tex_kind"][tex] == 1
        if bool(ck.any()):
            f = sc["tex_scale"][tex][:, None]
            sn = torch.sin(f * point)
            neg = (sn[:, 0] * sn[:, 1]) * sn[:, 2] < 0.0
            tex = torch.where(ck, torch.where(neg, sc["tex_odd"][tex], sc["tex_even"][tex]),
                              tex)
        value = colors[tex]
        pl = sc["tex_kind"][tex] == TEX_PERLIN
        if bool(pl.any()):
            gray = marble(point[pl], sc["perlin_seed"], sc["tex_scale"][tex[pl]])
            value = value.clone()
            value[pl] = gray[:, None].expand(-1, 3)
        em = (mkind == MAT_E) & front
        if bool(em.any()):
            rad = rad.index_add(0, lane[em], thr[em] * value[em])
        did = torch.zeros_like(front)
        nd = torch.zeros_like(d)
        att = torch.ones_like(value)
        a = _dot(d, d)
        length = sqrt(torch.clamp(a, min=SAFE_EPS))[:, None]
        ud = d / length  # unit_vector, vec3.rs:101-103
        sel = mkind == MAT_L
        if bool(sel.any()):
            u = tf.purpose_uniforms(k0[sel], k1[sel], bounce, tf.P_LAMBERT, 2).to(dtype)
            z = 2.0 * u[:, 0] - 1.0
            phi = two_pi * u[:, 1]
            rr = sqrt(torch.clamp(1.0 - z * z, min=0.0))
            s_dir = torch.stack([rr * torch.cos(phi), rr * torch.sin(phi), z], dim=-1)
            dl = n[sel] + s_dir
            tiny = (dl.abs() < NEAR_ZERO).all(dim=-1)
            dl = torch.where(tiny[:, None], n[sel], dl)
            nd[sel] = dl
            did = did | sel
        sel_m = mkind == MAT_M
        if bool(sel_m.any()):
            u = tf.purpose_uniforms(k0[sel_m], k1[sel_m], bounce, tf.P_FUZZ, 3).to(dtype)
            bz = 2.0 * u[:, 0] - 1.0
            phi = two_pi * u[:, 1]
            rho = sqrt(torch.clamp(1.0 - bz * bz, min=0.0))
            cb = torch.pow(u[:, 2].to(root_dtype), 1.0 / 3.0).to(dtype)
            ball = torch.stack([rho * torch.cos(phi) * cb, rho * torch.sin(phi) * cb,
                                bz * cb], dim=-1)
            um, nm = ud[sel_m], n[sel_m]
            refl = um - (2.0 * _dot(um, nm))[:, None] * nm
            ok = _dot(refl, nm) > 0.0
            nd[sel_m] = refl + sc["mat_fuzz"][mat[sel_m]][:, None] * ball
            absorbed = torch.zeros_like(sel_m)
            absorbed[sel_m] = ~ok  # material.rs:80, 91: below the surface
            did = did | (sel_m & ~absorbed)
        sel_d = mkind == MAT_D
        if bool(sel_d.any()):
            coin = tf.purpose_uniforms(k0[sel_d], k1[sel_d], bounce, tf.P_SCHLICK, 1)[:, 0]
            coin = coin.to(dtype)
            ir = sc["mat_ir"][mat[sel_d]]
            fr = front[sel_d]
            ratio = torch.where(fr, torch.reciprocal(ir), ir)
            uu, nn = ud[sel_d], n[sel_d]
            cos_t = torch.clamp(-_dot(uu, nn), max=1.0)
            sin_t = sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
            cannot = ratio * sin_t > 1.0
            r0 = (1.0 - ratio) / (1.0 + ratio)
            r0 = r0 * r0
            oc = 1.0 - cos_t
            oc2 = oc * oc
            schlick = r0 + (1.0 - r0) * (oc * (oc2 * oc2))
            reflect = cannot | (schlick > coin)
            refl = uu - (2.0 * _dot(uu, nn))[:, None] * nn
            perp = ratio[:, None] * (uu + cos_t[:, None] * nn)
            par = -sqrt(torch.abs(1.0 - _dot(perp, perp)))[:, None] * nn
            nd[sel_d] = torch.where(reflect[:, None], refl, perp + par)
            did = did | sel_d
        att = torch.where((sel | sel_m)[:, None], value, att)
        lane, o, d = lane[did], point[did], nd[did]
        thr = (thr * att)[did]
        k0, k1 = k0[did], k1[did]
    return rad


def render_pixels(sc, cam, key, pixels, *, width, height, spp, spp_chunk, max_bounces,
                  background, colors=None, dtype=torch.float32, root_dtype=torch.float64,
                  block_lanes=1 << 20, on_block=None):
    """The mean radiance (P, 3) of ``pixels`` at ``spp`` samples, summed
    as the renderer sums them: each chunk's samples, then the chunks in
    order, over ``spp``.  Runs in blocks of whole pixels of at most
    ``block_lanes`` lanes; ``on_block(img_block, rows)``, where given,
    receives each block's (p, 3) means (a differentiable caller's loss
    and backward) and the result is then detached."""
    dev = pixels.device
    per = max(1, block_lanes // spp)
    out = []
    for s in range(0, pixels.shape[0], per):
        pix = pixels[s:s + per]
        lanes_pix = pix.repeat_interleave(spp)
        lanes_smp = torch.arange(spp, device=dev).repeat(pix.shape[0])
        rad = trace(sc, cam, key, lanes_pix, lanes_smp, width=width, height=height,
                    spp=spp, max_bounces=max_bounces, background=background,
                    colors=colors, dtype=dtype, root_dtype=root_dtype)
        rad = rad.reshape(pix.shape[0], spp, 3)
        acc = None
        for c0 in range(0, spp, spp_chunk):
            part = rad[:, c0:c0 + spp_chunk].sum(dim=1)
            acc = part if acc is None else acc + part
        img = acc / torch.tensor(float(spp), dtype=dtype, device=dev)
        if on_block is not None:
            on_block(img, slice(s, s + pix.shape[0]))
            img = img.detach()
        out.append(img)
    return torch.cat(out)
