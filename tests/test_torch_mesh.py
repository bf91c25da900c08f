"""Meshes above 128 triangles in the PyTorch port against the JAX package:
the paged build, the paged walk, the dispatch in ``ops/geometry.py``, the
whole slice (pass body and Renderer), and the 8-slot light window.

Both packages run on the CPU on the same inputs, made with numpy from a
seed.  The JAX paged walk is run three ways: its dense sweep
(``bvh.traverse_triangles_paged`` on plain arrays), its per-lane gather
walk (``bvh._traverse_gather`` called directly, as tests/test_bvh.py does),
and both again under ``jax.jit``.

Tolerances:

* host build (``PagedBvh`` fields, page tiles, page boxes, pack arrays):
  bit-equal;
* the port's walk against eager JAX (``jax.disable_jit``): winner key's
  object, exact t, normal, material and ``blocked`` bit-equal on every ray.
  The port's walk tests a page only for rays that enter it (the gather
  walk's contract), the dense sweep for every ray once any ray entered it;
  the two are equal on these rays, which the test asserts rather than
  assumes;
* against jitted JAX: XLA's CPU backend fuses the plane-form dot products
  into FMAs, so t moves in the last bits: same hit and same winner on
  >= 99.9% of rays, t within rel 1e-5 (measured on an x86-64 CPU: the same
  winner on all 256 rays, t within rel 7.9e-7);
* paged walk against the port's own lockstep walk on the same triangles:
  same hits and winners, t within rel 1e-5, normals abs 1e-5 (the plane
  form rounds differently from Moeller-Trumbore);
* ``intersect_world`` / ``occluded`` on a mesh scene: the bands of
  tests/test_torch_ops.py;
* the 8-slot light window (``estimate_direct_light`` on 10 lights) against
  jitted JAX: >= 97% of lanes within rel 2e-4, lane mean within 0.5%;
* pass body: >= 95% of lanes within |a-b| <= 1e-3|b| + 1e-3, segments
  within 2%, channel means within 1% (measured: 99.5% of lanes, segments
  equal); Renderer images within the golden
  bands (mean rel 1.5% / abs 1.0, std rel 6% / abs 1.5) of the JAX
  Renderer, whose statistics are recorded in tests/torch_goldens.json.

JAX renders of meshes stay at 2 pages (a 240-triangle smooth sphere): the
JAX page prepass is a static unroll per page and the first jit of a pass
body takes minutes on one core.  bench_mesh (80 pages) is built on the
host here and never compiled through JAX.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import path_trace_golang_tpu as jpt
from path_trace_golang_tpu import integrator as JI
from path_trace_golang_tpu import render as JR
from path_trace_golang_tpu import scene as JS
from path_trace_golang_tpu import soa as jsoa
from path_trace_golang_tpu.ops import bvh as jbvh
from path_trace_golang_tpu.ops import geometry as jgeo
from path_trace_golang_tpu.ops import lights as jlights
from path_trace_golang_tpu.ops.rng import LaneRng as JLaneRng
from path_trace_golang_tpu.ops.vec import V3 as JV3
from path_trace_golang_tpu.scene import builtin as JB

import path_trace_golang_tpu_torch as tpt
from path_trace_golang_tpu_torch import integrator as TI
from path_trace_golang_tpu_torch import render as TR
from path_trace_golang_tpu_torch import scene as TS
from path_trace_golang_tpu_torch import soa as tsoa
from path_trace_golang_tpu_torch.ops import bvh as tbvh
from path_trace_golang_tpu_torch.ops import cuda_trace
from path_trace_golang_tpu_torch.ops import geometry as tgeo
from path_trace_golang_tpu_torch.ops import lights as tlights
from path_trace_golang_tpu_torch.ops.rng import LaneRng as TLaneRng
from path_trace_golang_tpu_torch.ops.vec import V3 as TV3
from path_trace_golang_tpu_torch.scene import builtin as TB

RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_goldens.json")
N = 256
SHAPE = (2, 128)  # the JAX gather walk takes (rows, 128) lane grids
# the slice: 24x16 image, 2-pass window, depth 4
W, H, SPP, DEPTH, SEED, CHUNK = 24, 16, 2, 4, 5, 384
MESH_KEY = f"mesh2page:gpu:{W}x{H}:spp{SPP}:d{DEPTH}:seed{SEED}"
LIGHTS_KEY = f"lights10:gpu:{W}x{H}:spp{SPP}:d3:seed{SEED}"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain walk runs thousands of (128, N) tensor ops that are just
    large enough for PyTorch to split across threads; beside other test
    workers on the same cores that splitting costs far more than it saves
    (a pass that takes 2 s alone took minutes).  One thread for this file."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# scenes, built alike in both packages
# ---------------------------------------------------------------------------


def _mesh_scene(S, B):
    """A 2-page mesh scene: a smooth rough-metal sphere of 240 triangles
    and one loose matte triangle over a floor, one sphere light."""
    C, V = S.Color, S.Vec3
    tri = S.Object(id="tri", type="triangle", material_id="clay",
                   vertices=[V(0.6, 0.1, 1.2), V(1.8, 0.1, 0.9), V(1.2, 1.3, 0.6)])
    return S.Scene(
        name="mesh2page",
        camera=S.Camera(position=V(0.0, 1.5, 4.2), target=V(0.0, 0.9, 0.0), up=V(0, 1, 0), fov=50.0),
        materials=[
            S.Material(id="floor", type="lambert", albedo=C(0.5, 0.5, 0.55)),
            S.Material(id="steel", type="metal", albedo=C(0.85, 0.8, 0.6), smoothness=0.6),
            S.Material(id="clay", type="lambert", albedo=C(0.75, 0.4, 0.3)),
            S.Material(id="sun", type="emissive", emit=C(1.0, 0.95, 0.85), power=3.0),
        ],
        objects=[
            S.Object(id="ground", type="plane", position=V(0, 0, 0), size=V(0, 0, 0), material_id="floor"),
            B._uv_sphere_mesh("blob", "steel", pos=(-0.4, 1.0, 0.0), scale=1.0, n_lat=10, n_lon=12),
            tri,
            S.Object(id="lamp", type="sphere_light", position=V(2.4, 4.0, 2.2), size=V(0.7, 0.7, 0.7),
                     material_id="sun"),
        ],
        sky=S.Sky(type="gradient", horizon=C(0.16, 0.17, 0.2), zenith=C(0.02, 0.04, 0.09)),
    )


def _lights_scene(S):
    """The 10-light scene of tests/test_goldens.py::test_many_lights_subset_path."""
    C, V = S.Color, S.Vec3
    mats = [S.Material(id="floor", type="lambert", albedo=C(0.8, 0.8, 0.8))]
    objs = [S.Object(id="p", type="plane", position=V(0, 0, 0), size=V(0, 0, 0), material_id="floor")]
    for i in range(10):
        mats.append(S.Material(id=f"L{i}", type="emissive", emit=C(1, 1, 1), power=2.0 + i * 0.1))
        objs.append(S.Object(id=f"l{i}", type="sphere_light", position=V(i - 5, 4, -2), size=V(0.3, 0, 0),
                             material_id=f"L{i}"))
    return S.Scene(
        name="lights10",
        camera=S.Camera(position=V(0, 1, 5), target=V(0, 1, 0), up=V(0, 1, 0), fov=60),
        sky=S.Sky(type="solid", color=C(0, 0, 0)), materials=mats, objects=objs,
    )


def _soup(S, t, seed):
    """Random triangle soup (the fixture of tests/test_bvh.py)."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-4, 4, size=(t, 3))
    e1 = rng.normal(size=(t, 3)) * 0.6
    e2 = rng.normal(size=(t, 3)) * 0.6
    C, V = S.Color, S.Vec3
    mats = [S.Material(id="a", type="lambert", albedo=C(0.6, 0.3, 0.2)),
            S.Material(id="b", type="lambert", albedo=C(0.2, 0.6, 0.3))]
    objs = [
        S.Object(id=f"t{i}", type="triangle", material_id="a" if i % 2 else "b",
                 vertices=[V(*v0[i]), V(*(v0[i] + e1[i])), V(*(v0[i] + e2[i]))])
        for i in range(t)
    ]
    return S.Scene(
        camera=S.Camera(position=V(0, 1, 5), target=V(0, 1, 0), up=V(0, 1, 0), fov=60),
        sky=S.Sky(type="solid", color=C(0.6, 0.7, 0.9)), materials=mats, objects=objs,
    )


def _carry(jp):
    """A JAX pack as a pack of the port (arrays through numpy)."""
    arrays = {f: np.asarray(getattr(jp, f)) for f in tsoa.ARRAY_FIELDS}
    static = {f: getattr(jp, f) for f in tsoa.STATIC_FIELDS}
    return tsoa.pack_from_numpy(arrays, static, device="cpu")


@pytest.fixture(scope="module")
def soup_packs():
    """A 424-triangle soup (4 pages) packed by both packages, and rays."""
    jp = jsoa.pack_scene(_soup(JS, 3 * 128 + 40, seed=13))
    tp = tsoa.pack_scene(_soup(TS, 3 * 128 + 40, seed=13), device="cpu")
    assert jp.paged.n_pages == tp.paged.n_pages == 4
    return jp, tp, _rays(17, 6.0)


def _rays(seed, box):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-box, box, size=(N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _jv(a):
    return JV3(*(jnp.asarray(a[:, k].reshape(SHAPE)) for k in range(3)))


def _tv(a):
    return TV3(*(torch.from_numpy(a[:, k].reshape(SHAPE).copy()) for k in range(3)))


def _jax_state():
    fz, iz = jnp.zeros(SHAPE, jnp.float32), jnp.zeros(SHAPE, jnp.int32)
    z3 = JV3(fz, fz, fz)
    return dict(
        best_t=fz + 1e20, best_m=iz - 1, best_type=iz, best_mat=iz, best_mtyp=iz, b_rough=fz, b_ior=fz,
        b_smooth=fz, b_refl=fz, b_abss=fz, b_albedo=z3, b_emit=z3, b_absorb=z3, b_tint=z3, nx=fz, ny=fz, nz=fz,
    )


# ---------------------------------------------------------------------------
# host build and pack
# ---------------------------------------------------------------------------


def _build_inputs(name):
    if name == "soup":
        sc = _soup(TS, 300, seed=3)
    else:
        sc = getattr(TB, name)()
    t_count, blocks = tsoa._mesh_blocks(sc, sc.material_index())
    v0, e1, e2, mats, smooth, vn = blocks
    n_solid = sum(o.type not in ("triangle", "mesh") for o in sc.objects)
    return v0, e1, e2, mats, np.arange(n_solid, n_solid + t_count), smooth, vn


@pytest.mark.parametrize("name", ["demo_mesh", "bench_mesh", "soup"])
def test_build_paged_bvh_bit_equal(name):
    args = _build_inputs(name)
    jpaged, jtiles, jbbox = jbvh.build_paged_bvh(*args)
    tpaged, ttiles, tbbox = tbvh.build_paged_bvh(*args)
    for f in dataclasses.fields(tbvh.PagedBvh):
        assert getattr(jpaged, f.name) == getattr(tpaged, f.name), f.name
    assert jpaged.mask_words == tpaged.mask_words
    assert jtiles.dtype == ttiles.dtype and np.array_equal(jtiles.view(np.uint32), ttiles.view(np.uint32))
    assert np.array_equal(jbbox.view(np.uint32), tbbox.view(np.uint32))
    # the port's box table holds the float32 immediates of the JAX prepass
    boxes = tbvh.page_boxes_table(tpaged)
    assert boxes.shape == (tpaged.n_pages, tbvh.N_SUB_BOXES, 6) and boxes.dtype == np.float32
    for p in range(tpaged.n_pages):
        want = {tuple(np.float32(x) for x in b) for b in jbvh._page_boxes(jpaged, p)}
        assert {tuple(b) for b in boxes[p]} == want, p


@pytest.mark.parametrize("name", ["demo_mesh", "bench_mesh"])
def test_pack_scene_mesh_bit_equal(name):
    jp = jsoa.pack_scene(getattr(JB, name)(), 64, 36)
    tp = tsoa.pack_scene(getattr(TB, name)(), 64, 36, device="cpu")
    assert tp.paged is not None and tp.bvh is None and tp.n_triangles > tbvh.STATIC_TRI_MAX
    for field in tsoa.ARRAY_FIELDS:
        a, b = np.asarray(getattr(jp, field)), getattr(tp, field).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), field
    for field in tsoa.STATIC_FIELDS:
        if field == "paged":
            for f in dataclasses.fields(tbvh.PagedBvh):
                assert getattr(jp.paged, f.name) == getattr(tp.paged, f.name), f.name
        else:
            assert tuple(np.atleast_1d(getattr(jp, field))) == tuple(np.atleast_1d(getattr(tp, field))), field
    assert jp.tri_any_emissive == tp.tri_any_emissive
    # a second pack of the same mesh reuses the tables (content-keyed cache)
    again = tsoa.pack_scene(getattr(TB, name)(), 48, 48, device="cpu")
    assert again.page_tiles.data_ptr() == tp.page_tiles.data_ptr()


def test_pack_from_numpy_mesh_roundtrip():
    jp = jsoa.pack_scene(JB.demo_mesh(), 64, 36)
    carried, own = _carry(jp), tsoa.pack_scene(TB.demo_mesh(), 64, 36, device="cpu")
    for f in tsoa.ARRAY_FIELDS + ("page_boxes",):
        assert torch.equal(getattr(carried, f), getattr(own, f)), f
    for f in tsoa.STATIC_FIELDS:
        assert getattr(carried, f) == getattr(own, f), f
    assert isinstance(carried.paged, tbvh.PagedBvh)


def test_use_dynamic_walk_override(monkeypatch):
    assert not tbvh.use_dynamic_walk(128) and tbvh.use_dynamic_walk(129)
    monkeypatch.setenv("PATHTRACER_BVH_DYNAMIC", "1")
    assert tbvh.use_dynamic_walk(4) and jbvh.use_dynamic_walk(4)
    tp = tsoa.pack_scene(_soup(TS, 20, seed=1), device="cpu")
    assert tp.paged is not None and tp.paged.n_pages == 1


# ---------------------------------------------------------------------------
# the paged walk
# ---------------------------------------------------------------------------


def _walk_args(case, n_tris, first_tri):
    rng = np.random.default_rng(23)
    if case == "open":
        return {}
    return dict(
        t_max=rng.uniform(2.0, 50.0, size=SHAPE).astype(np.float32),
        excl=rng.integers(first_tri, first_tri + n_tris, size=SHAPE).astype(np.int32),
        skip=rng.random(SHAPE) < 0.2,
    )


def _port_walk(tp, o, d, kw):
    before = cuda_trace.WALK_PLAIN_CALLS
    w = cuda_trace.paged_traverse(  # CPU tensors: the wrapper takes the plain version
        _tv(o), _tv(d), tp, 1e-3, torch.full(SHAPE, 1e20),
        exclude_obj=None if "excl" not in kw else torch.from_numpy(kw["excl"]),
        t_max=None if "t_max" not in kw else torch.from_numpy(kw["t_max"]),
        skip=None if "skip" not in kw else torch.from_numpy(kw["skip"]),
    )
    assert cuda_trace.WALK_PLAIN_CALLS == before + 1
    return w


def _jax_walk(fn, jp, o, d, kw, jit):
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}

    def run(o, d, jkw):
        if fn is jbvh._traverse_gather:
            return fn(o, d, jp, 1e-3, _jax_state(), jkw.get("excl"), jkw.get("t_max"), False, skip=jkw.get("skip"))[0]
        return fn(o, d, jp, 1e-3, _jax_state(), exclude_obj=jkw.get("excl"), t_max=jkw.get("t_max"),
                  skip=jkw.get("skip"))[0]

    if jit:
        return jax.jit(run)(_jv(o), _jv(d), jkw)
    with jax.disable_jit():
        return run(_jv(o), _jv(d), jkw)


def _compare_walk(w, st, live, exact):
    """Port winner ``w`` against a JAX winner-chain dict on ``live`` rays.
    Returns (share of rays with the same hit and winner, largest rel t gap)."""
    jt = np.asarray(st["best_t"])
    jhit = jt < 1e19
    thit = (w.hit & (w.t < 1e20)).numpy()
    same = (jhit == thit) & (~jhit | (np.asarray(st["best_m"]) == w.obj.numpy().astype(np.int32)))
    both = live & same & jhit
    assert both.sum() > 10
    if exact:
        assert same[live].all()
        assert np.array_equal(jt[both].view(np.uint32), w.t.numpy()[both].view(np.uint32))
        for k in ("nx", "ny", "nz"):
            assert np.array_equal(np.asarray(st[k])[both], getattr(w, k).numpy()[both]), k
        assert np.array_equal(np.asarray(st["best_mat"])[both], w.mat.numpy().astype(np.int32)[both])
    rel = np.abs(jt[both] - w.t.numpy()[both]) / np.abs(jt[both])
    return same[live].mean(), rel.max()


@pytest.mark.parametrize("case", ["open", "bounded"])
def test_paged_walk_bit_equal_to_eager_jax(soup_packs, case):
    jp, tp, (o, d) = soup_packs
    kw = _walk_args(case, jp.n_triangles, jp.n_objects)
    w = _port_walk(tp, o, d, kw)
    live = ~kw["skip"] if "skip" in kw else np.ones(SHAPE, bool)
    for fn in (jbvh.traverse_triangles_paged, jbvh._traverse_gather):
        _compare_walk(w, _jax_walk(fn, jp, o, d, kw, jit=False), live, exact=True)
    assert w.visits == 4 and w.hit.sum() > 10
    # rays without a hit carry the documented empty record
    miss = ~w.hit
    assert (w.page[miss] == -1).all() and (w.t[miss] == tbvh._BIG_T).all() and (w.nx[miss] == 0).all()


def test_paged_walk_smooth_bit_equal_to_eager_jax():
    """A smooth mesh: the winner's interpolated normal, bit for bit."""
    jp = jsoa.pack_scene(_mesh_scene(JS, JB), W, H)
    tp = tsoa.pack_scene(_mesh_scene(TS, TB), W, H, device="cpu")
    assert tp.paged.n_pages == 2 and tp.paged.any_smooth
    rng = np.random.default_rng(31)
    o = (rng.uniform(-2.5, 2.5, size=(N, 3)) + [0, 1, 0]).astype(np.float32)
    d = (np.array([-0.4, 1.0, 0.0]) - o + rng.normal(scale=0.5, size=(N, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    w = _port_walk(tp, o, d, {})
    live = np.ones(SHAPE, bool)
    for fn in (jbvh.traverse_triangles_paged, jbvh._traverse_gather):
        st = _jax_walk(fn, jp, o, d, {}, jit=False)
        _compare_walk(w, st, live, exact=True)
    # smooth normals differ from the flat ones on the sphere's rows
    row = tp.page_tiles[w.page.clamp_min(0).long(), (w.key & 127).long()]
    on_sphere = w.hit & (row[..., 14] > 0.5)
    assert on_sphere.sum() > 20 and (w.nx[on_sphere] != row[..., 0][on_sphere]).any()


def test_paged_walk_band_under_jit(soup_packs):
    jp, tp, (o, d) = soup_packs
    kw = _walk_args("bounded", jp.n_triangles, jp.n_objects)
    w = _port_walk(tp, o, d, kw)
    for fn in (jbvh.traverse_triangles_paged, jbvh._traverse_gather):
        share, rel = _compare_walk(w, _jax_walk(fn, jp, o, d, kw, jit=True), ~kw["skip"], exact=False)
        print(f"{fn.__name__} under jit: same winner on {share:.4%} of rays, t within rel {rel:.3g}")
        assert share >= 0.999 and rel <= 1e-5


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_occluded_paged_matches_jax(soup_packs, jit):
    jp, tp, (o, d) = soup_packs
    rng = np.random.default_rng(29)
    t_max = rng.uniform(1.0, 9.0, size=SHAPE).astype(np.float32)
    blocked0 = rng.random(SHAPE) < 0.2
    got = cuda_trace.paged_occluded(_tv(o), _tv(d), tp, 1e-3, torch.from_numpy(t_max), torch.from_numpy(blocked0))
    assert got[torch.from_numpy(blocked0)].all() and not got.all() and got.sum() > blocked0.sum()
    for fn in (jbvh.occluded_triangles_paged, jbvh._occluded_gather):
        run = lambda o, d, t, b: fn(o, d, jp, 1e-3, t, b)  # noqa: E731
        if jit:
            want = jax.jit(run)(_jv(o), _jv(d), jnp.asarray(t_max), jnp.asarray(blocked0))
        else:
            with jax.disable_jit():
                want = run(_jv(o), _jv(d), jnp.asarray(t_max), jnp.asarray(blocked0))
        same = np.asarray(want) == got.numpy()
        assert same.all() if not jit else same.mean() >= 0.999, fn.__name__


def test_paged_walk_matches_lockstep_walk(monkeypatch):
    """The port's two walks on the same 120 triangles find the same hits."""
    sc = _soup(TS, 120, seed=7)
    static = tsoa.pack_scene(sc, device="cpu")
    monkeypatch.setenv("PATHTRACER_BVH_DYNAMIC", "1")
    paged = tsoa.pack_scene(sc, device="cpu")
    assert static.paged is None and paged.paged is not None
    o, d = _rays(3, 6.0)
    hs = tgeo.intersect_world(_tv(o), _tv(d), static, 0.001)
    hp = tgeo.intersect_world(_tv(o), _tv(d), paged, 0.001)
    hit = hs.hit.numpy()
    assert hit.sum() > 15 and np.array_equal(hit, hp.hit.numpy())
    assert torch.equal(hs.obj_idx, hp.obj_idx) and torch.equal(hs.mat_idx, hp.mat_idx)
    np.testing.assert_allclose(hs.t.numpy()[hit], hp.t.numpy()[hit], rtol=1e-5)
    for a, b in zip(hs.normal, hp.normal):
        np.testing.assert_allclose(a.numpy()[hit], b.numpy()[hit], atol=1e-5)
    t_max = torch.full(SHAPE, 8.0)
    assert torch.equal(tgeo.occluded(_tv(o), _tv(d), static, 1e-3, t_max), tgeo.occluded(_tv(o), _tv(d), paged, 1e-3, t_max))


# ---------------------------------------------------------------------------
# geometry dispatch on a mesh scene
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh_packs():
    jp = jsoa.pack_scene(_mesh_scene(JS, JB), W, H)
    tp = tsoa.pack_scene(_mesh_scene(TS, TB), W, H, device="cpu")
    rng = np.random.default_rng(41)
    o = np.concatenate([
        np.array([0.0, 1.5, 4.2], np.float32) + rng.normal(scale=0.2, size=(N // 2, 3)).astype(np.float32),
        rng.uniform([-3, 0.05, -3], [3, 3, 3], size=(N // 2, 3)).astype(np.float32),
    ])
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d[: N // 2] = np.array([0.0, 0.9, 0.0], np.float32) - o[: N // 2] + rng.normal(scale=0.8, size=(N // 2, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jp, tp, o, d.astype(np.float32)


@pytest.mark.parametrize("lite", [False, True], ids=["full", "lite"])
def test_intersect_world_mesh(mesh_packs, lite):
    jp, tp, o, d = mesh_packs
    jh = jax.jit(lambda a, b: jgeo.intersect_world(a, b, jp, 0.001, lite=lite))(_jv(o), _jv(d))
    th = tgeo.intersect_world(_tv(o), _tv(d), tp, 0.001, lite=lite)
    jhit, thit = np.asarray(jh.hit), th.hit.numpy()
    same = (jhit == thit) & (np.asarray(jh.mtyp) == th.mtyp.numpy())
    if not lite:
        same &= (np.asarray(jh.obj_idx) == th.obj_idx.numpy()) & (np.asarray(jh.obj_type) == th.obj_type.numpy())
        assert (th.obj_type.numpy() == tbvh.OBJ_TRIANGLE).sum() > 20  # the rays do hit the mesh
    assert same.mean() >= 0.999
    both = same & jhit
    np.testing.assert_allclose(np.asarray(jh.t)[both], th.t.numpy()[both], atol=0, rtol=1e-5)
    for jc, tc in zip(jh.normal, th.normal):
        np.testing.assert_allclose(np.asarray(jc)[both], tc.numpy()[both], atol=5e-4, rtol=1e-5)
    for jc, tc in zip(jh.emit, th.emit):
        assert np.array_equal(np.asarray(jc)[both], tc.numpy()[both])


def test_occluded_mesh(mesh_packs):
    jp, tp, o, d = mesh_packs
    rng = np.random.default_rng(43)
    t_max = rng.uniform(0.1, 12.0, size=SHAPE).astype(np.float32)
    skip = rng.random(SHAPE) < 0.2
    jb = jax.jit(lambda a, b, t, s: jgeo.occluded(a, b, jp, 0.001, t, skip=s))(
        _jv(o), _jv(d), jnp.asarray(t_max), jnp.asarray(skip))
    tb = tgeo.occluded(_tv(o), _tv(d), tp, 0.001, torch.from_numpy(t_max), skip=torch.from_numpy(skip))
    live = ~skip
    assert (np.asarray(jb)[live] == tb.numpy()[live]).mean() >= 0.999 and tb.numpy()[live].any()


# ---------------------------------------------------------------------------
# the light window (more than 8 lights)
# ---------------------------------------------------------------------------


def test_direct_light_window_matches_jax():
    jp = jsoa.pack_scene(_lights_scene(JS), W, H)
    tp = tsoa.pack_scene(_lights_scene(TS), W, H, device="cpu")
    assert jp.n_lights == tp.n_lights == 10
    rng = np.random.default_rng(47)
    p = np.stack([rng.uniform(-6, 6, N), np.zeros(N), rng.uniform(-5, 3, N)], axis=1).astype(np.float32)
    n = np.tile(np.array([0.0, 1.0, 0.0], np.float32), (N, 1))
    albedo = rng.uniform(0.2, 0.9, size=(N, 3)).astype(np.float32)
    state = rng.integers(0, 2**32, size=SHAPE, dtype=np.uint64)
    jr, tr = JLaneRng(jnp.asarray(state.astype(np.uint32))), TLaneRng(torch.from_numpy(state.astype(np.int64)))
    want = jax.jit(lambda a, b, c, s: jlights.estimate_direct_light(a, b, c, jp, JLaneRng(s)))(
        _jv(p), _jv(n), _jv(albedo), jr.state)
    got = tlights.estimate_direct_light(_tv(p), _tv(n), _tv(albedo), tp, tr)
    assert tr.state.ne(torch.from_numpy(state.astype(np.int64))).all()  # 17 draws were made
    # a shadow ray that grazes one of the light spheres flips under jit's
    # FMA fusion, and the lane then lacks one slot's share: >= 97% of lanes
    # within rel 2e-4, the mean over lanes within 0.5% (measured: 98.0%)
    jr_, tr_ = np.stack([np.asarray(c) for c in want]), np.stack([c.numpy() for c in got])
    ok = (np.abs(jr_ - tr_) <= 2e-4 * np.abs(jr_) + 1e-6).all(axis=0)
    assert ok.mean() >= 0.97, ok.mean()
    np.testing.assert_allclose(tr_.mean(axis=(1, 2)), jr_.mean(axis=(1, 2)), rtol=5e-3)
    assert float(got.x.mean()) > 0.001


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


def _kw(sc, n_passes):
    return dict(width=W, height=H, n_strata=4, samples=16, has_aperture=sc.camera.aperture > 0, n_passes=n_passes)


def _stats(img):
    f = np.asarray(img).astype(np.float64)
    return {"mean": [round(float(x), 4) for x in f.mean(axis=(0, 1))],
            "std": [round(float(x), 4) for x in f.std(axis=(0, 1))]}


def _record(key, got):
    """The recorded statistics of a JAX Renderer image, held to ``got`` (abs
    0.1 of a u8 level); PATHTRACER_RECORD_GOLDENS=1 rewrites the record."""
    if os.environ.get("PATHTRACER_RECORD_GOLDENS", "") in ("1", "true", "on"):
        record = json.load(open(RECORD)) if os.path.exists(RECORD) else {}
        record[key] = got
        with open(RECORD, "w") as f:
            json.dump(record, f, indent=1, sort_keys=True)
    want = json.load(open(RECORD))[key]
    for k in ("mean", "std"):
        np.testing.assert_allclose(got[k], want[k], atol=0.1, rtol=0, err_msg=f"{k}: {got}")


def _in_bands(img, key):
    want = json.load(open(RECORD))[key]
    got = _stats(img)
    for ch in range(3):
        assert got["mean"][ch] == pytest.approx(want["mean"][ch], rel=0.015, abs=1.0), (key, got)
        assert got["std"][ch] == pytest.approx(want["std"][ch], rel=0.06, abs=1.5), (key, got)


@pytest.fixture(scope="module")
def jax_mesh_pass():
    """Every lane of the mesh image through the JAX Renderer's own program
    (``render._render_pass_chunk`` at its arguments), compiled once."""
    sc = _mesh_scene(JS, JB)
    jp = jsoa.pack_scene(sc, W, H)
    tcfg = JI.trace_config_for_scene(jp, sc, DEPTH, "gpu")
    accum, segs = JR._render_pass_chunk(
        jnp.zeros((W * H, 3), jnp.float32), jp, jnp.uint32(SEED), jnp.int32(0), tcfg=tcfg, chunk=CHUNK,
        normalize_pass=False, **_kw(sc, SPP))
    return np.asarray(accum), int(segs)


def test_pass_body_mesh(jax_mesh_pass):
    jc, js = jax_mesh_pass
    sc = _mesh_scene(TS, TB)
    tp = tsoa.pack_scene(sc, W, H, device="cpu")
    tcfg = TI.trace_config_for_scene(tp, sc, DEPTH, "gpu")
    assert tcfg.has_rough_metal and tcfg.enable_nee and not tp.tri_any_emissive  # all three walks run
    idx = torch.arange(W * H, dtype=torch.int32)
    col, segs = TR.pass_body_grid(tp, SEED, idx % W, idx // W, tcfg=tcfg, normalize_pass=False, **_kw(sc, SPP))
    tc = col.to_rows().numpy()
    assert np.isfinite(tc).all()
    ok = (np.abs(tc - jc) <= 1e-3 * np.abs(jc) + 1e-3).all(axis=-1)
    print(f"mesh pass body: {ok.mean():.4%} of lanes in the band, segments {int(segs)} vs {js}")
    assert ok.mean() >= 0.95
    assert abs(int(segs) - js) <= 0.02 * js
    mt, mj = tc.astype(np.float64).mean(0), jc.astype(np.float64).mean(0)
    assert np.all(np.abs(mt - mj) <= 0.01 * np.abs(mj)), (mt, mj)


def test_jax_renderer_mesh_record(jax_mesh_pass):
    img = jpt.Renderer(contract="gpu", seed=SEED, chunk=CHUNK).render(
        _mesh_scene(JS, JB), jpt.RenderConfig(W, H, SPP, DEPTH))
    _record(MESH_KEY, _stats(img))


def test_renderer_mesh_within_golden_bands():
    r = tpt.Renderer(contract="gpu", seed=SEED, device="cpu")
    img = r.render(_mesh_scene(TS, TB), tpt.RenderConfig(W, H, SPP, DEPTH))
    assert img.shape == (H, W, 3) and r.stats.nonfinite == 0 and r.stats.passes == SPP
    _in_bands(img, MESH_KEY)


def test_renderer_demo_mesh_cpu():
    """demo_mesh (788 triangles, 7 pages, smooth normals, disk lens) renders
    through the normal entry point on the CPU."""
    r = tpt.Renderer(contract="gpu", seed=2, device="cpu")
    img = r.render(TB.demo_mesh(), tpt.RenderConfig(24, 16, 1, 3))
    again = tpt.Renderer(contract="gpu", seed=2, device="cpu").render(TB.demo_mesh(), tpt.RenderConfig(24, 16, 1, 3))
    assert img.shape == (16, 24, 3) and r.stats.nonfinite == 0 and 5.0 < img.mean() < 250.0
    assert np.array_equal(img, again)


def test_jax_renderer_lights_record():
    img = jpt.Renderer(contract="gpu", seed=SEED, chunk=CHUNK).render(
        _lights_scene(JS), jpt.RenderConfig(W, H, SPP, 3))
    _record(LIGHTS_KEY, _stats(img))


def test_renderer_lights_within_golden_bands():
    r = tpt.Renderer(contract="gpu", seed=SEED, device="cpu")
    img = r.render(_lights_scene(TS), tpt.RenderConfig(W, H, SPP, 3))
    assert r.stats.nonfinite == 0 and img.mean() > 5.0
    _in_bands(img, LIGHTS_KEY)


# ---------------------------------------------------------------------------
# on the card: kernel = plain version
# ---------------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["demo_mesh", "bench_mesh"])
def test_walk_kernel_matches_plain_on_card(name):
    _need_card()
    pack = tsoa.pack_scene(getattr(TB, name)(), 64, 64, device="cuda")
    o, d = _rays(5, 2.5)
    o[:, 1] += 1.0
    to = TV3(*(torch.from_numpy(o[:, k].copy()).cuda() for k in range(3)))
    td = TV3(*(torch.from_numpy(d[:, k].copy()).cuda() for k in range(3)))
    far = torch.full((N,), 1e20, device="cuda")
    k = cuda_trace.paged_traverse(to, td, pack, 1e-3, far)
    p = tbvh.traverse_triangles_paged(to, td, pack, 1e-3, far)
    assert k.hit.sum() > 10
    for f in ("hit", "key", "page", "t", "nx", "ny", "nz", "mat", "obj"):
        a, b = getattr(k, f), getattr(p, f)
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b), f
    t_max = torch.full((N,), 6.0, device="cuda")
    assert torch.equal(cuda_trace.paged_occluded(to, td, pack, 1e-3, t_max, far < 0),
                       tbvh.occluded_triangles_paged(to, td, pack, 1e-3, t_max, far < 0))


PARTIAL_N = 2048 + 17  # the last warp of the walk's launch holds 17 rays: a partial working set


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["partial_warp", "every_other_skipped"])
def test_cooperative_walk_partial_sets_on_card(case):
    """The warp-cooperative walk (csrc/paged_walk.cuh) against the plain
    version bit for bit where its working set is not a whole warp: a ray
    count that is not a multiple of 32, and (closest hit) every other ray
    skipped, which still helps its warp, or (any hit) every other ray come
    in blocked, which does not enter the walk at all."""
    _need_card()
    pack = tsoa.pack_scene(TB.bench_mesh(), 64, 64, device="cuda")
    rng = np.random.default_rng(2065)
    o = (rng.uniform(-2.5, 2.5, (PARTIAL_N, 3)) + [0.0, 1.0, 0.0]).astype(np.float32)
    d = rng.normal(size=(PARTIAL_N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cu = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    to, td = TV3(*(cu(o[:, k]) for k in range(3))), TV3(*(cu(d[:, k]) for k in range(3)))
    start = cu(np.where(rng.random(PARTIAL_N) < 0.5, rng.uniform(0.5, 6.0, PARTIAL_N), 1e20).astype(np.float32))
    every_other = cu(np.arange(PARTIAL_N) % 2 == 1)
    skip = every_other if case == "every_other_skipped" else None
    k = cuda_trace.paged_traverse(to, td, pack, 1e-3, start, skip=skip)
    p = tbvh.traverse_triangles_paged(to, td, pack, 1e-3, start, skip=skip)
    assert p.hit.sum() > 10
    for f in ("hit", "key", "page", "t", "nx", "ny", "nz", "mat", "obj"):
        a, b = getattr(k, f), getattr(p, f)
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b), f
    t_max = cu(rng.uniform(0.5, 8.0, PARTIAL_N).astype(np.float32))
    blocked0 = every_other if case == "every_other_skipped" else torch.zeros_like(every_other)
    kb = cuda_trace.paged_occluded(to, td, pack, 1e-3, t_max, blocked0)
    assert kb.sum() > blocked0.sum()
    assert torch.equal(kb, tbvh.occluded_triangles_paged(to, td, pack, 1e-3, t_max, blocked0))


def _glowing_mesh_scene(n_lat=12, n_lon=16):
    """A rough-metal sphere mesh beside an emissive icosahedron: with
    emissive triangles the specular-NEE ray takes the full closest-hit walk."""
    S, C, V = TS, TS.Color, TS.Vec3
    return S.Scene(
        name="glowing_mesh",
        camera=S.Camera(position=V(0.0, 1.5, 4.5), target=V(0.0, 1.0, 0.0), up=V(0, 1, 0), fov=50.0),
        materials=[
            S.Material(id="floor", type="lambert", albedo=C(0.5, 0.5, 0.55)),
            S.Material(id="steel", type="metal", albedo=C(0.85, 0.8, 0.6), smoothness=0.6),
            S.Material(id="glow", type="emissive", emit=C(1.0, 0.6, 0.3), power=6.0),
            S.Material(id="sun", type="emissive", emit=C(1.0, 0.95, 0.85), power=10.0),
        ],
        objects=[
            S.Object(id="ground", type="plane", position=V(0, 0, 0), size=V(0, 0, 0), material_id="floor"),
            TB._uv_sphere_mesh("blob", "steel", pos=(-0.5, 1.0, 0.0), scale=1.0, n_lat=n_lat, n_lon=n_lon,
                               smooth=False),
            TB._icosahedron("ico", "glow", pos=(1.3, 0.7, 0.4), scale=0.6),
            S.Object(id="lamp", type="sphere_light", position=V(2.4, 4.0, 2.2), size=V(0.7, 0.7, 0.7),
                     material_id="sun"),
        ],
        sky=S.Sky(type="gradient", horizon=C(0.16, 0.17, 0.2), zenith=C(0.02, 0.04, 0.09)),
    )


def _pass_on_card(sc, w, h, depth, n_strata, n_passes):
    pack = tsoa.pack_scene(sc, w, h, device="cuda")
    tcfg = TI.trace_config_for_scene(pack, sc, depth, "gpu")
    idx = torch.arange(w * h, dtype=torch.int32, device="cuda")
    kw = dict(tcfg=tcfg, width=w, height=h, n_strata=n_strata, samples=n_strata * n_strata,
              has_aperture=sc.camera.aperture > 0, normalize_pass=False, n_passes=n_passes)
    ck, sk = cuda_trace.render_pass_cuda(pack, 3, idx % w, idx // w, **kw)
    cp, sp = cuda_trace.render_pass_plain(pack, 3, idx % w, idx // w, **kw)
    a, b = ck.to_rows(), cp.to_rows()
    ok = ((a - b).abs() <= 1e-3 * b.abs() + 1e-3).all(dim=-1)
    assert torch.isfinite(a).all() and float(a.mean()) > 0
    assert ok.double().mean().item() >= 0.95 and abs(int(sk) - int(sp)) <= 0.02 * int(sp)
    return pack


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["demo_mesh", "lights10", "glowing_mesh"])
def test_pass_kernel_matches_plain_on_card_mesh_and_lights(name):
    _need_card()
    sc = {"lights10": lambda: _lights_scene(TS), "demo_mesh": TB.demo_mesh, "glowing_mesh": _glowing_mesh_scene}[name]()
    pack = _pass_on_card(sc, 32, 32, 4, 4, 2)
    if name == "glowing_mesh":
        assert pack.paged is not None and pack.tri_any_emissive


@pytest.mark.cuda
def test_large_mesh_tables_beyond_48k_shared_memory_on_card():
    """160,000 triangles: 1,250 pages, whose boxes (60 KB) take the scene
    tables past the 48 KB of shared memory a kernel gets without asking."""
    _need_card()
    pack = _pass_on_card(_glowing_mesh_scene(n_lat=400, n_lon=200), 16, 16, 2, 2, 1)
    assert pack.paged.n_pages >= 1250 and pack.page_boxes.numel() * 4 > 48 * 1024
