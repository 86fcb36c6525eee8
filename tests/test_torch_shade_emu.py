"""The shade kernel (``ops/shade.py``, ``ops/csrc/shade.cu``) on the CPU,
and which bounces take it.

The source is built with g++ against ``tests/cuda_emu.h`` (one
std::thread a CUDA thread) and held against its plain twin,
``integrator.shade_bounce_plain`` (the tensor-op route:
``record_from_payload`` and ``integrator._bounce_tail``), on the same CPU
tensors: the search's (t,
column, payload) from the plain sweep, random state and uniforms.  Two
tables: SphereField's (the checker ground, lambertian, metal and
dielectric balls, hollow glass of negative radius) and a mixed table of
spheres, rects and triangles with every material (a light among them)
and checker textures.  Lanes: camera-like rays, rays from inside the
hollow spheres, misses that bank the background, a tenth dead (their
origins parked at PARKED_ORIGIN for the search, as the route parks
them); roulette off, on, and on the lanes of a mask only.

Two builds of the source, as ``test_torch_fused_bounce_emu.py`` holds
K1:

* as it is: every output of every lane bit for bit, but the floats of a
  lane whose value passes through a sine, a cosine or the cube root (a
  hit on a lambertian or a metal, a checker texture), which agree within
  1e-5 rel + 1e-6 abs: the host's libm and torch's CPU sin / cos differ
  by an ulp or two;
* with ``sinf(x)`` as ``x``, ``cosf(x)`` as ``1 - x`` and the cube root as
  its argument, against the plain twin with ``torch.sin``, ``torch.cos``
  and ``sampling.cbrt`` replaced the same way: every output of every lane
  bit for bit.

The routing: ``shade_kernel_ok`` admits SphereField's and ModelTest's
forward bounces on a CUDA device, and no bounce on the CPU, no perlin,
image or nested-checker scene and no scene of up to 128 primitives.  With
the CPU's bounces routed as the card's (the predicate asked for a CUDA
device, ``shade_bounce`` the emulated kernel), a forward frame takes the
kernel once a bounce where the predicate admits the scene and a
differentiable frame never, and the frames that take it equal the
tensor-op frames bit for bit (chunked, with roulette, and the regen
wavefront, in the build without trigonometry; on the card
``tests/test_torch_cuda.py`` holds the kernel's frames to the tensor
ops').
"""

import ctypes
import re
import shutil

import numpy as np
import pytest
import torch

from rust_pathtracer_tpu_torch import integrator, sampling
from rust_pathtracer_tpu_torch.integrator import PARKED_ORIGIN, T_MIN
from rust_pathtracer_tpu_torch.models import SCENES, get_scene
from rust_pathtracer_tpu_torch.ops import fused_bounce as fb
from rust_pathtracer_tpu_torch.ops import projected as P
from rust_pathtracer_tpu_torch.ops import shade
from rust_pathtracer_tpu_torch.ops._build import CSRC
from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
from rust_pathtracer_tpu_torch.scene import SceneBuilder
from rust_pathtracer_tpu_torch.scene.obj_loader import write_benchmark_obj
from rust_pathtracer_tpu_torch.scene.types import (
    MAT_LAMBERTIAN,
    MAT_METAL,
    PRIM_RECT,
    PRIM_SPHERE,
    PRIM_TRIANGLE,
    TEX_CHECKER,
)
from rust_pathtracer_tpu_torch.wavefront import render_radiance_regen

torch.set_num_threads(2)

N_LANES = 2048
RTOL, ATOL = 1e-5, 1e-6  # trigonometry's lanes, in the source as it is
BG = (0.3, 0.5, 0.9)
NAN_BITS = 0x7FC00001  # outputs start as NaN: a lane the launch skips shows
BUILDS = {"source": True, "no_trig": False}  # name -> trigonometry kept
ROULETTE = ("off", "on", "on_mask")
CUDA = torch.device("cuda")  # the predicate asked for the card (no tensor made there)


def _mixed_scene(extra=None, n=70, seed=3):
    """Spheres (some hollow glass of negative radius), rects and triangles
    in a 16-unit box, more than 128 primitives, so that the scene has
    projected tables.  Materials in turn: lambertian on a solid colour and
    on a checker, metal, dielectric, light; ``extra(b)`` gives one more
    material id, put on every fifth primitive (a perlin or image texture,
    a nested checker)."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    ck = b.checker_texture(b.solid_texture((0.9, 0.1, 0.1)),
                           b.solid_texture((0.1, 0.8, 0.2)), 3.0)
    mats = [b.lambertian((0.5, 0.6, 0.7)), b.lambertian(ck), b.metal((0.8, 0.7, 0.6), 0.3),
            b.dielectric(1.5), b.diffuse_light((4.0, 3.0, 2.0))]
    if extra is not None:
        mats[0] = extra(b)
    for i in range(n):
        c, r = rng.uniform(-8, 8, 3), rng.uniform(0.4, 1.2)
        b.add_sphere(c, r, mats[i % 5])
        if i % 7 == 0:
            b.add_sphere(c, -0.9 * r, mats[3])
    for i in range(n):
        plane = ["xy", "xz", "yz"][rng.integers(3)]
        fixed = {"xy": 2, "xz": 1, "yz": 0}[plane]
        s = rng.uniform(-8, 8, 3)
        e = s + rng.uniform(0.5, 3.0, 3)
        e[fixed] = s[fixed]
        b.add_rect(plane, s, e, 1.0 if rng.random() < 0.5 else -1.0, mats[(i + 1) % 5])
    for i in range(n):
        p0 = rng.uniform(-8, 8, 3)
        b.add_triangle(p0, p0 + rng.uniform(-2, 2, 3), p0 + rng.uniform(-2, 2, 3),
                       mats[(i + 2) % 5])
    return b.build(use_bvh=False)


def _scene(name):
    return get_scene("SphereField").build() if name == "spherefield" else _mixed_scene()


def _inputs(scene, name, seed):
    """(state, search, draws, rr_u, rr_sel) of N_LANES CPU lanes."""
    rng = np.random.default_rng(seed)
    n = N_LANES
    if name == "spherefield":
        lo, hi = np.array([-12.0, 0.05, -12.0]), np.array([12.0, 4.0, 12.0])
    else:
        lo, hi = np.full(3, -9.0), np.full(3, 9.0)
    o = rng.uniform(lo, hi, (n, 3))
    d = rng.normal(size=(n, 3)) * rng.uniform(0.5, 2.0, (n, 1))  # unnormalized
    # an eighth from inside the hollow spheres, an eighth up into the sky
    data = scene.prims.data.numpy()
    hollow = data[(scene.prims.kind.numpy() == PRIM_SPHERE) & (data[:, 3] < 0)]
    k = n // 8
    pick = hollow[rng.integers(len(hollow), size=k)]
    o[:k] = pick[:, :3] + rng.uniform(-0.4, 0.4, (k, 3)) * np.abs(pick[:, 3:4])
    d[k:2 * k, 1] = np.abs(d[k:2 * k, 1]) + 2.0
    o[k:2 * k, 1] = hi[1] + 1.0
    f32 = torch.float32
    o, d = torch.tensor(o, dtype=f32), torch.tensor(d, dtype=f32)
    # throughputs over three decades, so that roulette's p is clamped at
    # both ends
    thr = torch.tensor(rng.uniform(0.01, 1.5, (n, 3)) * 10.0 ** rng.uniform(-2, 0.3, (n, 1)),
                       dtype=f32)
    rad = torch.tensor(rng.uniform(0.0, 2.0, (n, 3)), dtype=f32)
    alive = torch.tensor(rng.random(n) >= 0.1)
    o_live = torch.where(alive[:, None], o, torch.full_like(o, PARKED_ORIGIN))
    search = P.closest_hit_routed(scene.proj, o_live, d, T_MIN)
    u = torch.tensor(rng.random((7, n)), dtype=f32)
    draws = dict(sphere_u=u[0:2].T, ball_u=u[2:5].T, coin=u[5])
    return (o, d, thr, rad, alive), search, draws, u[6], torch.tensor(rng.random(n) < 0.5)


def launch_emulated(lib, scene, search, state, draws, bg, rr_u=None, rr_sel=None):
    """``shade._launch``'s call, on CPU tensors."""
    R = state[0].shape[0]
    su, bu = draws["sphere_u"], draws["ball_u"]
    ins = [scene.proj.payload, search[0], search[1], *state,
           su[:, 0], su[:, 1], bu[:, 0], bu[:, 1], bu[:, 2], draws["coin"], rr_u, rr_sel,
           torch.as_tensor(bg, dtype=torch.float32)]
    ins = [None if x is None else x.contiguous() for x in ins]
    outs = [torch.full((R, 3), NAN_BITS, dtype=torch.int32).view(torch.float32)
            for _ in range(4)]
    alive = torch.ones(R, dtype=torch.bool)
    ptrs = (ctypes.c_void_p * shade.N_PTRS)(
        *(None if x is None else x.data_ptr() for x in ins + outs + [alive]))
    err = lib.shade_bounce_launch(ptrs, fb._type_flags(scene.mat_types, fb._MAT_BITS, "m"),
                                  fb._type_flags(scene.tex_types, fb._TEX_BITS, "t"), R, None)
    assert err == 0
    return (*outs, alive)


_LIBS = {}


def _emu_lib(tmp_path_factory, build):
    """``shade.cu`` built by ``emu_build``, as it is or with its
    trigonometry and cube root replaced (``BUILDS``), once a session."""
    from test_torch_projected_rows import emu_build

    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    if build in _LIBS:
        return _LIBS[build]
    src = (CSRC / "shade.cu").read_text()
    if not BUILDS[build]:
        n_trig = len(re.findall(r"\b(?:sinf|cosf)\(", src))
        src = re.sub(r"\bsinf\(", "emu_sin(", src)
        src = re.sub(r"\bcosf\(", "emu_cos(", src)
        src, n_pow = re.subn(r"\(float\)pow\(\(double\)a\.bu2\[i\], 1\.0 / 3\.0\)", "a.bu2[i]",
                             src)
        assert n_pow == 1 and n_trig == 5, (n_pow, n_trig)
        src = src.replace("#include <stdint.h>", "#include <stdint.h>\n"
                          "inline float emu_sin(float x) { return x; }\n"
                          "inline float emu_cos(float x) { return 1.0f - x; }")
    lib, n_launch = emu_build(tmp_path_factory.mktemp("shade"), "shade", src)
    assert n_launch == 1
    _LIBS[build] = lib
    return lib


@pytest.fixture(scope="module", params=list(BUILDS))
def emu_lib(request, tmp_path_factory):
    """(build, library) of each of ``BUILDS``."""
    return request.param, _emu_lib(tmp_path_factory, request.param)


def _no_trig_twin(monkeypatch):
    """The plain twin's sine, cosine and cube root replaced as the no_trig
    build replaces them."""
    monkeypatch.setattr(torch, "sin", lambda x: x)
    monkeypatch.setattr(torch, "cos", lambda x: 1.0 - x)
    monkeypatch.setattr(sampling, "cbrt", lambda x: x)


@pytest.fixture
def plain_like_build(emu_lib, monkeypatch):
    """The plain twin with the no_trig build's replacements."""
    if not BUILDS[emu_lib[0]]:
        _no_trig_twin(monkeypatch)
    return emu_lib


def _bits(x):
    return x.contiguous().view(torch.int32).numpy() if x.dtype == torch.float32 else x.numpy()


@pytest.mark.parametrize("roulette", ROULETTE)
@pytest.mark.parametrize("name", ["spherefield", "mixed"])
def test_emulated_kernel_matches_plain(name, roulette, plain_like_build):
    variant, lib = plain_like_build
    scene = _scene(name)
    assert shade.shade_kernel_ok(scene, CUDA)
    state, search, draws, rr_u, rr_sel = _inputs(scene, name, seed=22 + len(roulette))
    rr = None if roulette == "off" else rr_u
    sel = rr_sel if roulette == "on_mask" else None
    got = launch_emulated(lib, scene, search, state, draws, BG, rr, sel)
    want = integrator.shade_bounce_plain(scene, search, state, draws, torch.tensor(BG), rr,
                                         sel)

    t, col, pay = search
    hit = (col >= 0) & state[4]
    mk, tk = pay[:, P.PAY_MKIND], pay[:, P.PAY_TKIND]
    trig = (hit & ((mk == MAT_LAMBERTIAN) | (mk == MAT_METAL) | (tk == TEX_CHECKER))).numpy()
    exact = not BUILDS[variant]
    np.testing.assert_array_equal(got[4].numpy(), want[4].numpy(), err_msg="alive")
    for what, g, w in zip(("o", "d", "thr", "rad"), got, want):
        same = (_bits(g) == _bits(w)).all(axis=1)
        if exact:
            bad = ~same
        else:
            close = np.isclose(g.numpy(), w.numpy(), rtol=RTOL, atol=ATOL).all(axis=1)
            bad = ~same & (~trig | ~close)
        lanes = np.nonzero(bad)[0]
        assert lanes.size == 0, (f"{what}: {lanes.size} lanes differ, first {lanes[:5]}; "
                                 f"kernel {g[lanes[0]].tolist()}, plain {w[lanes[0]].tolist()}")

    # the lanes reach what they are meant to: every material of the table,
    # checkers, hollow glass, misses, dead lanes, continuing lanes
    kinds = {int(k) for k in mk[hit].round()}
    assert kinds == set(scene.mat_types), kinds
    assert bool((hit & (tk == TEX_CHECKER)).any())
    assert bool((hit & (pay[:, P.PAY_KIND] == PRIM_SPHERE) & (pay[:, 3] < 0)).any())
    if name == "mixed":
        assert {int(k) for k in pay[hit, P.PAY_KIND]} == {PRIM_SPHERE, PRIM_RECT,
                                                         PRIM_TRIANGLE}
    assert bool((state[4] & (col < 0)).any()) and not bool(state[4].all())
    assert bool(want[4].any())
    if rr is not None:  # roulette killed some lanes and boosted some
        free = integrator.shade_bounce_plain(scene, search, state, draws, torch.tensor(BG),
                                             None)
        assert bool((free[4] & ~want[4]).any())
        assert bool((want[4] & (want[2] != free[2]).any(dim=1)).any())
        p = free[2].amax(dim=1)
        assert bool((free[4] & (p < 0.05)).any()) and bool((free[4] & (p > 1.0)).any())
        if sel is not None:  # and spared the lanes outside the mask
            assert torch.equal(want[4][~sel], free[4][~sel])


# ---------------------------------------------------------------------------
# the routing
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def obj_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("model") / "model.obj"
    write_benchmark_obj(str(path))
    return str(path)


def _nested_checker(b):
    inner = b.checker_texture(b.solid_texture((1.0, 1.0, 1.0)),
                              b.solid_texture((0.0, 0.0, 0.0)), 2.0)
    return b.lambertian(b.checker_texture(inner, b.solid_texture((0.2, 0.2, 0.9)), 5.0))


OTHERS = {
    "perlin": lambda b: b.lambertian(b.perlin_texture(4.0)),
    "image": lambda b: b.lambertian(b.image_texture(np.full((4, 6, 3), 0.5, np.float32))),
    "nested_checker": _nested_checker,
}


def test_predicate_admits_the_big_forward_scenes(obj_path):
    for name in ("SphereField", "ModelTest"):
        kw = {"obj_path": obj_path} if name == "ModelTest" else {}
        scene = get_scene(name, **kw).build()
        assert shade.shade_kernel_ok(scene, CUDA), name
        assert not shade.shade_kernel_ok(scene, "cpu"), name
    assert shade.shade_kernel_ok(_mixed_scene(), CUDA)


@pytest.mark.parametrize("kind", list(OTHERS))
def test_predicate_refuses_other_textures(kind):
    scene = _mixed_scene(OTHERS[kind])
    assert scene.kinds_static is None
    assert not shade.shade_kernel_ok(scene, CUDA)


@pytest.mark.parametrize("name", sorted(set(SCENES) - {"SphereField", "ModelTest"}))
def test_predicate_refuses_small_scenes(name):
    scene = get_scene(name).build()
    assert scene.kinds_static is not None
    assert not shade.shade_kernel_ok(scene, CUDA)


def _as_on_the_card(monkeypatch, lib=None):
    """Routes the CPU's forward bounces as the card's: the predicate asked
    for a CUDA device, and ``shade_bounce`` the emulated kernel ``lib``
    (or, without one, the plain twin).  Returns the lanes of each call."""
    calls = []

    def kernel(scene, search, state, draws_b, background, rr_u=None, rr_sel=None):
        calls.append(state[0].shape[0])
        if lib is None:
            return integrator.shade_bounce_plain(scene, search, state, draws_b, background,
                                                 rr_u, rr_sel)
        return launch_emulated(lib, scene, search, state, draws_b, background, rr_u, rr_sel)

    monkeypatch.setattr(integrator, "shade_kernel_ok",
                        lambda scene, device: shade.shade_kernel_ok(scene, CUDA))
    monkeypatch.setattr(integrator, "shade_bounce", kernel)
    return calls


@pytest.mark.parametrize("kind", ["SphereField", "perlin"])
def test_routes_take_shade_bounce_where_admitted(kind, monkeypatch):
    """Routed as on the card, a forward frame calls ``shade_bounce`` once a
    bounce where the predicate admits the scene, never for a perlin scene;
    a differentiable one never."""
    if kind == "SphereField":
        sd = get_scene("SphereField")
        scene, cam = sd.build(), sd.camera_at(0.0)
    else:
        scene, cam = _mixed_scene(OTHERS["perlin"]), get_scene("SphereField").camera_at(0.0)
    calls = _as_on_the_card(monkeypatch)
    s = RenderSettings(8, 6, 2, 4, (1.0, 1.0, 1.0))
    img, st = render_radiance(scene, cam, s, sampling.prng_key(1), device="cpu")
    assert torch.isfinite(img).all()
    assert calls == ([96] * st.bounces if kind == "SphereField" else [])
    calls.clear()
    s = RenderSettings(8, 6, 2, 4, (1.0, 1.0, 1.0), differentiable=True)
    render_radiance(scene, cam, s, sampling.prng_key(1), device="cpu")
    assert calls == []


@pytest.fixture(scope="module")
def no_trig_lib(tmp_path_factory):
    return _emu_lib(tmp_path_factory, "no_trig")


@pytest.mark.parametrize("path", ["chunked", "roulette", "regen"])
def test_shade_route_equals_tensor_route(path, monkeypatch, no_trig_lib):
    """SphereField frames through the emulated kernel (routed as on the
    card) against the same frames on the tensor ops, bit for bit: chunked
    with the reorder, with roulette from bounce 2, and the regen wavefront
    (roulette on its per-lane mask).  The build without trigonometry, the
    tensor ops' sine, cosine and cube root replaced the same way."""
    _no_trig_twin(monkeypatch)
    sd = get_scene("SphereField")
    scene, cam = sd.build(), sd.camera_at(0.0)
    s = RenderSettings(16, 10, 2, 6, (0.8, 0.9, 1.0), russian_roulette_start=(
        2 if path != "chunked" else None))
    runs = []
    for on_card in (True, False):
        with monkeypatch.context() as m:
            calls = _as_on_the_card(m, no_trig_lib) if on_card else []
            if path == "regen":
                img, st = render_radiance_regen(scene, cam, s, sampling.prng_key(4),
                                                lanes=128, device="cpu")
            else:
                img, st = render_radiance(scene, cam, s, sampling.prng_key(4), device="cpu")
        assert bool(calls) == on_card
        if on_card and path != "regen":
            assert len(calls) == st.bounces
        runs.append((img, st))
    (a, sa), (b, sb) = runs
    assert torch.isfinite(a).all()
    assert torch.equal(a, b)
    assert torch.equal(sa.segments, sb.segments) and torch.equal(sa.occupancy, sb.occupancy)
