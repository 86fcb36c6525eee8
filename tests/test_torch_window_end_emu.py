"""The regen window end's kernels (``ops/window_end.py``,
``ops/csrc/window_end.cu``) on the CPU, and the frames that take them.

The source is built with g++ against ``tests/cuda_emu.h`` (one
std::thread a CUDA thread, blocks one after another) with
``camera_lane.cuh`` and ``threefry.cuh`` beside it; torch's stable sort
stands in for the CUB sort (``pool_sort.cu``: a stable sort has one
result).  The finish, the sort, the add and the respawn, run by
``WindowEnd`` on CPU tensors, are held against their plain twin
``wavefront._flush_refill`` on copies of the same pools: the image sums,
the length histogram, the state rows, key words, depth, work, pixel and
the work handed out, bit for bit.  Pools of 9,000 lanes (three finish
tiles, the last one ragged) of a 24x16 frame whose camera has a lens:
none finished, all finished, the queue running out mid-window, a spent
queue, idle lanes (work -1), depths past the histogram's cap, and pixels
shared by up to ~40 lanes with one shared by 300 (a run across the
add's blocks).  Three builds of the source:

* ``no_trig``: the disk's cosine and sine replaced by 1 and theta (the
  twin's ``torch.cos`` / ``torch.sin`` by the same), every output bit for
  bit;
* ``small_tiles``: the same with one lane a thread, tiles of 256 lanes
  (36 tiles: the last block scans many);
* ``source``: as it is; every output bit for bit but a respawned lane's
  origin and direction, within 1e-5 rel + 1e-6 abs: the host's libm
  cosf / sinf against torch's CPU cos / sin.

The frames: with the CPU routed as the card (``window_end_ok`` asked for
a CUDA device, the wrapper launching the emulated kernels), regen queue
frames equal the tensor-op frames bit for bit: image, segments,
occupancy and bounces, the extra window after the deciding one included;
LightTest at the benchmark's toy size (16x9, 8 spp, 50 bounces, 256
lanes), CornellBox on a pool of 24 lanes (many refills) and SphereField
(the generic route with the reorder).  On the card
``tests/test_torch_cuda.py`` holds the kernels' frames to the CPU's.
"""

import re
import shutil

import numpy as np
import pytest
import torch

from rust_pathtracer_tpu_torch import integrator, wavefront
from rust_pathtracer_tpu_torch.camera import make_camera
from rust_pathtracer_tpu_torch.models import get_scene
from rust_pathtracer_tpu_torch.ops import window_end as W
from rust_pathtracer_tpu_torch.ops._build import CSRC
from rust_pathtracer_tpu_torch.render import RenderSettings
from rust_pathtracer_tpu_torch.sampling import prng_key

torch.set_num_threads(2)

WIDTH, HEIGHT, SPP = 24, 16, 64
NPIX = WIDTH * HEIGHT
N_LANES = 9000
RTOL, ATOL = 1e-5, 1e-6  # a respawned lane's ray, in the build with trigonometry
BUILDS = ("no_trig", "small_tiles", "source")
CAMERA = ((1.0, 2.0, 6.0), (0.0, 0.5, -1.0), (0.0, 1.0, 0.0), 40.0, 1.5, 0.5, 5.0)


def test_histogram_bins_match():
    assert W.HIST_BINS == integrator.MAX_BOUNCE_STATS
    src = (CSRC / "window_end.cu").read_text()
    assert re.search(rf"constexpr int HIST_BINS = {W.HIST_BINS};", src)


def test_predicate():
    assert W.window_end_ok("cuda", "queue")
    assert W.window_end_ok(torch.device("cuda", 1), "queue")
    assert not W.window_end_ok("cuda", "stripe")
    assert not W.window_end_ok("cpu", "queue")


_LIBS = {}


def _emu_lib(tmp_path_factory, build):
    """``window_end.cu`` built by ``emu_build``, once a build variant."""
    from test_torch_projected_rows import emu_build

    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    if build in _LIBS:
        return _LIBS[build]
    tmp = tmp_path_factory.mktemp(f"window_end_{build}")
    src = (CSRC / "window_end.cu").read_text()
    lane = (CSRC / "camera_lane.cuh").read_text()
    if build != "source":
        lane, n = re.subn(r"r \* cosf\(theta\)", "r * 1.0f", lane)
        lane, m = re.subn(r"r \* sinf\(theta\)", "r * theta", lane)
        assert n == m == 1
    if build == "small_tiles":
        src, n = re.subn(r"constexpr int ITEMS = \d+;", "constexpr int ITEMS = 1;", src)
        assert n == 1
    (tmp / "camera_lane.cuh").write_text(lane)
    shutil.copy(CSRC / "threefry.cuh", tmp / "threefry.cuh")
    lib, n_launch = emu_build(tmp, "window_end", src)
    assert n_launch == 3
    _LIBS[build] = lib
    return lib


def torch_sort_pairs(keys, vals, end_bit, scratch):
    """``window_end.sort_pairs`` by torch's stable sort."""
    assert int(keys[0].min()) >= 0 and int(keys[0].max()) < 2 ** end_bit
    k, order = torch.sort(keys[0], stable=True)
    keys[1].copy_(k)
    vals[1].copy_(vals[0][order])
    return 1


def _no_trig_twin(monkeypatch):
    monkeypatch.setattr(torch, "cos", lambda x: torch.ones_like(x))
    monkeypatch.setattr(torch, "sin", lambda x: x)


def _route_emulated(monkeypatch, lib):
    """``WindowEnd`` on CPU tensors: the emulated kernels, torch's sort."""
    monkeypatch.setattr(W, "_library", lambda name: lib)
    monkeypatch.setattr(W, "sort_pairs", torch_sort_pairs)
    monkeypatch.setattr(W, "sort_scratch", lambda n, end_bit, device: torch.empty(0))


@pytest.fixture(scope="module", params=BUILDS)
def emu_lib(request, tmp_path_factory):
    return request.param, _emu_lib(tmp_path_factory, request.param)


@pytest.fixture
def routed(emu_lib, monkeypatch):
    """(build, library), routed; the twin's trigonometry as the build's."""
    build, lib = emu_lib
    _route_emulated(monkeypatch, lib)
    if build != "source":
        _no_trig_twin(monkeypatch)
    return emu_lib


# ---------------------------------------------------------------------------
# one window end against its twin
# ---------------------------------------------------------------------------

CASES = ("mixed", "none_finished", "all_finished", "queue_runs_out", "queue_spent")


def _pool(case, seed):
    """A pool of N_LANES lanes and the work issued so far."""
    rng = np.random.default_rng(seed)
    n = N_LANES
    state = rng.normal(size=(13, n)).astype(np.float32)
    state[9:12] = rng.uniform(0.0, 4.0, (3, n))
    alive = rng.random(n) < 0.3
    work = rng.integers(0, NPIX * SPP, n)
    work[rng.random(n) < 0.15] = -1  # idle lanes
    if case == "none_finished":
        work[~alive] = -1
    elif case == "all_finished":
        alive[:] = False
        work = rng.integers(0, NPIX * SPP, n)
    state[12] = alive
    depth = rng.integers(0, 80, n)  # past the histogram's 64 bins too
    depth[rng.random(n) < 0.05] = 63
    # pixels: most lanes spread (~20 a pixel), 300 on one pixel, some
    # consecutive lanes on one pixel
    pixel = rng.integers(0, NPIX, n)
    pixel[rng.choice(n, 300, replace=False)] = 77
    pixel[4000:4040] = 5
    issued = {"queue_runs_out": NPIX * SPP - 1234, "queue_spent": NPIX * SPP}.get(
        case, NPIX * SPP // 3)
    pool = wavefront._Pool(
        state=torch.from_numpy(state), keys=torch.from_numpy(
            rng.integers(-2 ** 31, 2 ** 31, (2, n)).astype(np.int32)),
        depth=torch.from_numpy(depth.astype(np.int32)),
        work=torch.from_numpy(work.astype(np.int32)), pixel=torch.from_numpy(pixel))
    return pool, issued


def _frame(key):
    cam = make_camera(*CAMERA)
    return wavefront._Frame(scene=None, table=None, fused=True, cam=cam, key=key,
                            bg=None, width=WIDTH, height=HEIGHT, spp=SPP, max_bounces=50,
                            rr_start=None, stripe=False)


def _clone(pool):
    return wavefront._Pool(**{k: v.clone() for k, v in vars(pool).items() if v is not None})


def _bits(x):
    return x.contiguous().view(torch.int32).numpy() if x.dtype == torch.float32 else x.numpy()


@pytest.mark.parametrize("case", CASES)
def test_window_end_matches_twin(case, routed):
    build, _ = routed
    key = prng_key(11 + len(case))
    fr = _frame(key)
    pool, issued = _pool(case, seed=len(case))
    rng = np.random.default_rng(5)
    acc0 = torch.from_numpy(rng.uniform(0.0, 9.0, (NPIX, 3)).astype(np.float32))
    hist0 = torch.from_numpy(rng.integers(0, 1000, W.HIST_BINS).astype(np.float32))

    twin = _clone(pool)
    acc_t = acc0.clone()
    hist_t, issued_t, take_t = wavefront._flush_refill(fr, twin, acc_t, hist0.clone(), issued,
                                                       NPIX * SPP)
    got = _clone(pool)
    acc_k, hist_k = acc0.clone(), hist0.clone()
    we = W.WindowEnd(N_LANES, width=WIDTH, height=HEIGHT, spp=SPP, cam=fr.cam, key=key,
                     device="cpu")
    we.ctl[W.CTL_HANDED] = issued
    before = W.launches
    we(got, acc_k, hist_k)
    assert W.launches - before == 3

    finished = (pool.state[12] <= 0.5) & (pool.work >= 0)
    n_fin = int(finished.sum())
    assert {"none_finished": n_fin == 0, "all_finished": n_fin == N_LANES,
            "queue_runs_out": 0 < take_t < n_fin, "queue_spent": take_t == 0 < n_fin,
            "mixed": 0 < take_t == n_fin}[case]
    ctl = we.ctl.tolist()
    assert ctl[W.CTL_N_FIN] == n_fin and ctl[W.CTL_N_TAKE] == take_t
    assert ctl[W.CTL_HANDED] == issued_t and ctl[W.CTL_WID0] == issued
    assert ctl[W.CTL_LIVE] == int((pool.state[12] > 0.5).sum()) + take_t
    assert ctl[5:7] == [0, 0]  # the tickets and the live count, reset
    assert int(we.hist_count.abs().sum()) == 0

    np.testing.assert_array_equal(_bits(acc_k), _bits(acc_t), err_msg="acc")
    np.testing.assert_array_equal(_bits(hist_k), _bits(hist_t), err_msg="hist")
    for name in ("keys", "depth", "work", "pixel"):
        np.testing.assert_array_equal(_bits(getattr(got, name)), _bits(getattr(twin, name)),
                                      err_msg=name)
    same = _bits(got.state) == _bits(twin.state)
    if build == "source":  # a respawned lane's ray: the disk's trigonometry
        close = np.isclose(got.state.numpy(), twin.state.numpy(), rtol=RTOL, atol=ATOL)
        same[:6] |= close[:6]
    rows, lanes = np.nonzero(~same)
    assert rows.size == 0, (f"{rows.size} state words differ, first rows {rows[:5]} lanes "
                            f"{lanes[:5]}")
    if take_t:  # the lanes that took work spawned, on the lens too
        spawned = finished & (got.work >= 0)
        assert int(spawned.sum()) == take_t
        assert not torch.equal(got.state[0:3, spawned],
                               fr.cam.origin[:, None].expand(3, take_t))


def test_previous_reads_the_window_before(routed):
    """``previous`` reads the device block of the call before the last."""
    key = prng_key(3)
    fr = _frame(key)
    pool, _ = _pool("mixed", seed=9)
    we = W.WindowEnd(N_LANES, width=WIDTH, height=HEIGHT, spp=SPP, cam=fr.cam, key=key,
                     device="cpu")
    acc, hist = torch.zeros((NPIX, 3)), torch.zeros(W.HIST_BINS)
    we(pool, acc, hist)
    with pytest.raises(RuntimeError, match="no earlier window"):
        we.previous()
    first = we.ctl.tolist()
    we(pool, acc, hist)
    assert we.previous() == (first[W.CTL_N_TAKE], first[W.CTL_LIVE])


def test_wrapper_checks_its_tensors(routed):
    key = prng_key(3)
    fr = _frame(key)
    pool, _ = _pool("mixed", seed=9)
    we = W.WindowEnd(N_LANES, width=WIDTH, height=HEIGHT, spp=SPP, cam=fr.cam, key=key,
                     device="cpu")
    acc, hist = torch.zeros((NPIX, 3)), torch.zeros(W.HIST_BINS)
    for name, bad in (("pixel", pool.pixel.to(torch.int32)), ("depth", pool.depth[:-1]),
                      ("state", pool.state.T.contiguous().T)):
        broken = _clone(pool)
        setattr(broken, name, bad)
        with pytest.raises(ValueError, match=name):
            we(broken, acc, hist)
    with pytest.raises(ValueError, match="acc"):
        we(pool, acc[:-1], hist)
    assert we.windows == 0


# ---------------------------------------------------------------------------
# frames routed as on the card
# ---------------------------------------------------------------------------

FRAMES = {  # scene: (width, height, spp, bounces, background, roulette, pool)
    "LightTest": (16, 9, 8, 50, (0.0, 0.0, 0.0), None, 256),
    "CornellBox": (12, 8, 4, 10, (0.0, 0.0, 0.0), 3, 24),
    "SphereField": (8, 6, 4, 4, (1.0, 1.0, 1.0), None, 32),
}


@pytest.fixture(scope="module")
def no_trig_lib(tmp_path_factory):
    return _emu_lib(tmp_path_factory, "no_trig")


@pytest.mark.parametrize("name", list(FRAMES))
def test_routed_frames_equal_tensor_frames(name, monkeypatch, no_trig_lib):
    _no_trig_twin(monkeypatch)
    w, h, spp, nb, bg, rr, lanes = FRAMES[name]
    sd = get_scene(name)
    scene, cam = sd.build(), sd.camera_at(0.0)
    s = RenderSettings(w, h, spp, nb, bg, russian_roulette_start=rr)
    runs = []
    for on_card in (True, False):
        with monkeypatch.context() as m:
            spans, reorders = [], []
            real_span, real_reorder = wavefront.span, wavefront._reorder_pool
            m.setattr(wavefront, "span",
                      lambda what, *a: (spans.append(what), real_span(what, *a))[1])
            m.setattr(wavefront, "_reorder_pool",
                      lambda *a: (reorders.append(1), real_reorder(*a))[1])
            if on_card:
                _route_emulated(m, no_trig_lib)
                m.setattr(wavefront, "window_end_ok", lambda dev, mode: mode == "queue")
            before = W.launches
            img, st = wavefront.render_radiance_regen(scene, cam, s, prng_key(4),
                                                      lanes=lanes, device="cpu")
            windows = (W.launches - before) // 3
        runs.append((img, st))
        assert bool(reorders) == (name == "SphereField")
        if on_card:
            # every window end took the kernels, one window past the deciding one
            assert W.launches - before == 3 * windows and windows == st.bounces // 2 + 1
            assert spans.count("rpt.flush") == windows
            # one host read a window end, the window before's, but at the first;
            # the reorder reads its live count before a bounce
            assert spans.count("rpt.sync") == windows - 1 + len(reorders)
        else:
            assert W.launches == before
    (a, sa), (b, sb) = runs
    assert torch.isfinite(a).all() and float(a.sum()) > 0
    np.testing.assert_array_equal(_bits(a), _bits(b))
    assert sa.bounces == sb.bounces
    assert torch.equal(sa.segments, sb.segments) and torch.equal(sa.occupancy, sb.occupancy)
    assert lanes < w * h * spp // 4  # many refills
