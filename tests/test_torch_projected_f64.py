"""The projected route's f32 sphere quadratic against f64, on the CPU.

K5-K7 and their plain sweep (``ops/projected.py``) solve a sphere's
quadratic in f32, in the expanded form of the projected tables, as the
JAX package does.  K1, K3 and K4 once landed a root inside a glass
sphere by more than t_min, so that the reflected ray met it again
(CornellBox key 7, ``tests/test_torch_oracle.py``).  This module hunts
for that class of fault on the projected route: it renders SphereField
(64x36, 2 spp, 6 bounces), takes the lanes each bounce hands the
projected search, and holds the port's winning sphere and t against an
f64 closest hit of the same rays over the scene's spheres, written here
in numpy, and against JAX's ``closest_hit_projected`` (its Pallas kernel
in the interpreter) on the same lanes.  A lane is listed where the
port's winner is not the f64 one, or where the port's root lies off the
sphere by more than t_min (``inside`` when it lies inside).  A fault of
the port is a lane where the port's winner differs from f64 and JAX's
follows f64.

    python tests/test_torch_projected_f64.py [FIRST_KEY LAST_KEY [VARIANT]]

runs the hunt (keys 0-31 by default) and prints the counts and every
listed lane; the test runs keys 0-31 and asserts that none is listed.
VARIANT runs it with one of the cheaper sphere formulas of ``VARIANTS``
in the plain sweep instead of ``projected._sphere_values``.
"""

import os
import sys

import numpy as np
import pytest
import torch

from rust_pathtracer_tpu_torch.integrator import PARKED_ORIGIN, T_MIN
from rust_pathtracer_tpu_torch.models import get_scene
from rust_pathtracer_tpu_torch.ops import projected as P
from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
from rust_pathtracer_tpu_torch.sampling import prng_key

torch.set_num_threads(2)

WIDTH, HEIGHT, SPP, BOUNCES = 64, 36, 2, 6


def capture_searches(scene, cam, seed):
    """Render one key and return, for each call of the projected search,
    the live lanes' (o, d) and the port's (t, column, prim index)."""
    calls = []
    routed = P.closest_hit_routed

    def spy(tables, o, d, t_min, route=None):
        t, col, pay = routed(tables, o, d, t_min, route)
        live = o[:, 0] < PARKED_ORIGIN * 0.5
        calls.append(tuple(x[live].numpy().copy() for x in (
            o, d, t, col, torch.round(pay[:, P.PAY_IDX]).to(torch.int32))))
        return t, col, pay

    P.closest_hit_routed = spy
    try:
        render_radiance(scene, cam, RenderSettings(WIDTH, HEIGHT, SPP, BOUNCES,
                                                   (0.7, 0.8, 1.0)),
                        prng_key(seed), device="cpu")
    finally:
        P.closest_hit_routed = routed
    return calls


def f64_closest_sphere(o, d, centers, radii, t_min=T_MIN, chunk=2048):
    """(t, sphere index, -1 on a miss) of each ray's closest hit over the
    spheres, in f64 from the f32 inputs: the smaller root at or past
    t_min, else the larger."""
    o, d = o.astype(np.float64), d.astype(np.float64)
    c, r = centers.astype(np.float64), radii.astype(np.float64)
    t_best = np.full(o.shape[0], np.inf)
    i_best = np.full(o.shape[0], -1, np.int64)
    a = np.einsum("ij,ij->i", d, d)[:, None]
    for s in range(0, o.shape[0], chunk):
        oc = o[s:s + chunk, None, :] - c[None]
        dd = d[s:s + chunk, None, :]
        half_b = np.einsum("ijk,ijk->ij", oc, dd)
        cc = np.einsum("ijk,ijk->ij", oc, oc) - r[None] ** 2
        dis = half_b * half_b - a[s:s + chunk] * cc
        sq = np.sqrt(np.maximum(dis, 0.0))
        r1 = (-half_b - sq) / a[s:s + chunk]
        r2 = (-half_b + sq) / a[s:s + chunk]
        t = np.where(r1 >= t_min, r1, r2)
        t = np.where((dis >= 0.0) & (t >= t_min), t, np.inf)
        i_best[s:s + chunk] = np.where(np.isfinite(t).any(1), t.argmin(1), -1)
        t_best[s:s + chunk] = t.min(1)
    return t_best, i_best


def jax_search(jtables, o, d):
    """JAX's K5 in the Pallas interpreter: (t, prim index, -1 on a miss)."""
    import jax.numpy as jnp

    from rust_pathtracer_tpu.ops import projected as jproj

    hit, t, pay = jproj.closest_hit_projected(jtables, jnp.asarray(o), jnp.asarray(d),
                                              T_MIN, interpret=True)
    idx = np.where(np.asarray(hit), np.rint(np.asarray(pay)[:, P.PAY_IDX]), -1)
    return np.asarray(t), idx.astype(np.int64)


def hunt(keys, with_jax=True):
    """Every listed lane over ``keys``: dicts with the key, bounce call,
    the three winners and t, and the port's root's distance off the
    sphere.  Also returns the number of lanes searched."""
    sd = get_scene("SphereField")
    scene, cam = sd.build(), sd.camera_at(0.0)
    data = scene.prims.data.numpy()
    assert (scene.prims.kind.numpy() == 0).all()  # spheres only
    centers, radii = data[:, 0:3], data[:, 3]
    jtables = []  # JAX's tables, built at the first listed lane

    def jax_tables():
        if not jtables:
            from rust_pathtracer_tpu.models import get_scene as j_get_scene

            jtables.append(j_get_scene("SphereField").build().proj)
        return jtables[0]

    found, n_lanes = [], 0
    for key in keys:
        for call, (o, d, t, col, idx) in enumerate(capture_searches(scene, cam, key)):
            n_lanes += o.shape[0]
            port_idx = np.where(col >= 0, idx, -1)
            t64, i64 = f64_closest_sphere(o, d, centers, radii)
            # the port's root against f64's on the port's own sphere
            hitp = port_idx >= 0
            off = np.zeros(o.shape[0])
            if hitp.any():
                p = o[hitp].astype(np.float64) + t[hitp, None].astype(np.float64) * d[hitp]
                dist = np.linalg.norm(p - centers[port_idx[hitp]], axis=1)
                off[hitp] = dist - np.abs(radii[port_idx[hitp]].astype(np.float64))
            odd = (port_idx != i64) | (np.abs(off) > T_MIN)
            if not odd.any():
                continue
            lanes = np.nonzero(odd)[0]
            jt, ji = (jax_search(jax_tables(), o[lanes], d[lanes]) if with_jax
                      else (np.full(lanes.size, np.nan), np.full(lanes.size, -2)))
            for k, lane in enumerate(lanes):
                found.append(dict(
                    key=key, call=call, lane=int(lane), port=int(port_idx[lane]),
                    port_t=float(t[lane]), f64=int(i64[lane]), f64_t=float(t64[lane]),
                    jax=int(ji[k]), jax_t=float(jt[k]), off=float(off[lane]),
                    inside=bool(off[lane] < -T_MIN)))
    return found, n_lanes


def port_faults(found):
    """Lanes where the port's winner differs from f64's and JAX's
    follows f64."""
    return [f for f in found if f["port"] != f["f64"] and f["jax"] == f["f64"]]


def _f32_tail(q, hb, dis, dnorm, tmin):
    """A sphere column's value from f32 half_b and discriminant: the
    root, the roots and the tests in f32, as ``_sphere_values`` does
    them past its f64 roots."""
    sqrtd = torch.sqrt(torch.where((dis > 0.0) | torch.isnan(dis), dis, torch.zeros_like(dis)))
    r1, r2 = -hb - sqrtd, -hb + sqrtd
    lim = tmin * dnorm if q else tmin
    if not q:
        r1, r2 = r1 / dnorm, r2 / dnorm
    ok1 = r1 >= lim
    valid = (dis >= 0.0) & (ok1 | (r2 >= lim))
    return torch.where(valid, torch.where(ok1, r1, r2), torch.full_like(r1, P.T_MISS))


def _oc64(o, quad):
    f64 = torch.float64
    cx, cy, cz, r = (x.to(f64) for x in quad.unbind(1))
    return [o[:, i:i + 1].to(f64) - c for i, c in enumerate((cx, cy, cz))], r


def sphere_f32_roots(q, o, d, quad, dnorm, dnorm64, tmin):
    """o - c, half_b, |o - c|^2 - r^2 and the discriminant in f64, its
    root and the two roots in f32."""
    (ocx, ocy, ocz), r = _oc64(o, quad)
    dx, dy, dz = (d[:, i:i + 1].to(torch.float64) for i in range(3))
    half_b = (dx * ocx + dy * ocy) + dz * ocz
    cterm = ((ocx * ocx + ocy * ocy) + ocz * ocz) - r * r
    dis = half_b * half_b - dnorm64 * cterm
    return _f32_tail(q, half_b.to(torch.float32), dis.to(torch.float32), dnorm, tmin)


def sphere_f32_discriminant(q, o, d, quad, dnorm, dnorm64, tmin):
    """Only the terms that cancel on the surface in f64: o - c and
    |o - c|^2 - r^2; half_b, the discriminant and the roots in f32."""
    (ocx, ocy, ocz), r = _oc64(o, quad)
    cterm = (((ocx * ocx + ocy * ocy) + ocz * ocz) - r * r).to(torch.float32)
    fx, fy, fz = (x.to(torch.float32) for x in (ocx, ocy, ocz))
    hb = (d[:, 0:1] * fx + d[:, 1:2] * fy) + d[:, 2:3] * fz
    return _f32_tail(q, hb, hb * hb - dnorm * cterm, dnorm, tmin)


# cheaper sphere formulas for the plain sweep, each held to the hunt
VARIANTS = {"f32_roots": sphere_f32_roots, "f32_discriminant": sphere_f32_discriminant}


def hunt_variant(name, keys):
    """``hunt`` (without JAX) with the plain sweep's sphere formula
    replaced by ``VARIANTS[name]``."""
    real = P._sphere_values
    P._sphere_values = VARIANTS[name]
    try:
        return hunt(keys, with_jax=False)
    finally:
        P._sphere_values = real


@pytest.mark.parametrize("name,key,listed", [("f32_roots", 19, 1),
                                             ("f32_discriminant", 0, 2)])
def test_cheaper_sphere_formulas_leave_f64(name, key, listed):
    """Taking less of the quadratic in f64 lists lanes again (keys 0-31:
    1 lane with the roots in f32, 12 with half_b and the discriminant in
    f32 too), so the sweep keeps the whole quadratic in f64.  With the
    roots in f32, key 19's lane at its third search meets sphere 1 in
    f64 at t = 0.0010007, 6.6e-7 past t_min, and misses it in f32."""
    found, _ = hunt_variant(name, [key])
    assert len(found) == listed, found
    assert all(f["port"] != f["f64"] for f in found)


def test_projected_route_follows_f64():
    """Keys 0-31: on every lane the projected search is handed, the
    port's winner is the f64 winner and its root lies within t_min of
    the sphere.  Before the sphere's quadratic went to f64 the hunt
    listed 130 lanes, 13 of them where JAX's winner followed f64 and
    the port's did not (ROADMAP queue 3)."""
    found, n_lanes = hunt(range(32))
    assert n_lanes > 300_000
    assert not port_faults(found), port_faults(found)
    assert not found, found


# key 7, pixel 1200, sample 0: the camera ray grazes sphere 313 (the
# prim index in BVH order).  f64 misses it and meets sphere 298 at t =
# 2.0395624; JAX's f32 (fused multiply-adds) does the same, at 2.0395539;
# the port's f32 expanded form met 313 at t = 1.9695812
PINNED = dict(key=7, pixel=1200, sample=0, sphere=298, t=2.0395624423465213)


def test_pinned_lane_follows_f64():
    """The pinned camera ray: the port's projected search (the plain
    sweep of K5, K6 and K7) and JAX's K5 both take the f64 winner, and
    the port's t is the f64 root rounded to f32."""
    from rust_pathtracer_tpu_torch.render import _make_lanes

    sd = get_scene("SphereField")
    scene = sd.build()
    _, o, d, _ = _make_lanes(sd.camera_at(0.0), prng_key(PINNED["key"]),
                             torch.tensor([PINNED["pixel"]]), 0, width=WIDTH,
                             height=HEIGHT, spp_chunk=SPP, spp_total=SPP)
    o, d = o[PINNED["sample"]:PINNED["sample"] + 1], d[PINNED["sample"]:PINNED["sample"] + 1]
    data = scene.prims.data.numpy()
    t64, i64 = f64_closest_sphere(o.numpy(), d.numpy(), data[:, 0:3], data[:, 3])
    assert (int(i64[0]), float(t64[0])) == (PINNED["sphere"], PINNED["t"])
    for route in P.ROUTES:
        t, col, pay = P.closest_hit_routed(scene.proj, o, d, T_MIN, route)
        assert int(torch.round(pay[0, P.PAY_IDX])) == PINNED["sphere"], route
        assert float(t[0]) == float(np.float32(PINNED["t"])), route
    from rust_pathtracer_tpu.models import get_scene as j_get_scene

    jt, ji = jax_search(j_get_scene("SphereField").build().proj, o.numpy(), d.numpy())
    assert int(ji[0]) == PINNED["sphere"]


def test_f64_search_matches_plain_sweep_on_easy_rays():
    """The numpy f64 search is the plain sweep's closest hit where no
    ray grazes: rays aimed at the centres of a few spheres."""
    sd = get_scene("SphereField")
    scene = sd.build()
    data = scene.prims.data.numpy()
    rng = np.random.default_rng(3)
    pick = rng.choice(np.nonzero(data[:, 3] > 0)[0], 64)
    o = (data[pick, 0:3] + rng.normal(size=(64, 3)) * 3 + [0, 4, 0]).astype(np.float32)
    d = (data[pick, 0:3] - o).astype(np.float32)
    t64, i64 = f64_closest_sphere(o, d, data[:, 0:3], data[:, 3])
    t, col, pay = P.closest_hit_routed(scene.proj, torch.from_numpy(o),
                                       torch.from_numpy(d), T_MIN)
    idx = torch.round(pay[:, P.PAY_IDX]).numpy().astype(np.int64)
    assert (col.numpy() >= 0).all()
    np.testing.assert_array_equal(idx, i64)
    np.testing.assert_allclose(t.numpy(), t64, rtol=1e-4)


def test_sphere_q_and_t_domains_agree():
    """A sphere column's t-domain value is its q-domain value divided by
    |d|^2 in f32, bit for bit, and both domains accept the same columns
    where t_min is not at stake: the group's winner then has the same t
    whichever domain a kernel compares in (K5 compares a streamed
    table's mixed slots in t, K7 in q; the cascade hands a lane to
    either, and its image equals the chunked one bit for bit)."""
    scene = get_scene("SphereField").build()
    rng = np.random.default_rng(9)
    o = torch.from_numpy(rng.uniform(-11, 11, (4096, 3)).astype(np.float32))
    o[:, 1] = torch.from_numpy(rng.uniform(0.05, 3, 4096).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(4096, 3)).astype(np.float32))
    dnorm, dnorm64 = P._dnorms(d)
    tmin = torch.tensor(T_MIN)
    for g in range(scene.proj.num_groups):
        if scene.proj.group_kinds[g] != 0:
            continue
        quad = scene.proj.rows[g, 0]
        q = P._sphere_values(True, o, d, quad, dnorm, dnorm64, tmin)
        t = P._sphere_values(False, o, d, quad, dnorm, dnorm64, tmin)
        both = (q < P.T_MISS) & (t < P.T_MISS)
        assert both.any()
        assert torch.equal((q / dnorm)[both].view(torch.int32), t[both].view(torch.int32))
        far = (t > 1.0) | (q >= P.T_MISS) & (t >= P.T_MISS)
        assert torch.equal((q < P.T_MISS)[far], (t < P.T_MISS)[far])


if __name__ == "__main__":
    first, last = (int(a) for a in sys.argv[1:3]) if len(sys.argv) > 2 else (0, 31)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if len(sys.argv) > 3:
        found, n_lanes = hunt_variant(sys.argv[3], range(first, last + 1))
    else:
        found, n_lanes = hunt(range(first, last + 1))
    faults = port_faults(found)
    print(f"keys {first}-{last}: {n_lanes} lanes searched, {len(found)} listed, "
          f"{sum(f['port'] != f['f64'] for f in found)} with another winner than "
          f"f64, {sum(abs(f['off']) > T_MIN for f in found)} roots off the sphere "
          f"by more than t_min ({sum(f['inside'] for f in found)} inside), "
          + ("JAX not run" if len(sys.argv) > 3 else
             f"{len(faults)} where JAX follows f64 and the port does not"))
    for f in found:
        print(f)
