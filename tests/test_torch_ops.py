"""Parity of the PyTorch port's scene, pack and lane-math modules with the
JAX package (both on the CPU, same inputs made with numpy from a seed).

Tolerances: integer paths (RNG, pack tables) bit-exact; element-wise float
ops abs 1e-6 / rel 1e-5; intersection hit masks and winners equal on
>= 99.9% of lanes with t within rel 1e-5; fog medium coefficients abs 5e-3.

The fog noise ``hash31`` is fract(sin(q) * 43758.5453) with |q| ~ 6e3.  Two
effects move it, and test_hash31_fma_witness shows both: one ulp of sin
(libm's against XLA's) moves it by up to ~4e-3, hence the 5e-3 band where
JAX runs op by op (medium_coeffs below); and under jax.jit XLA's CPU
backend fuses q's multiply-adds into FMAs, which changes q's last bit and
the noise outright on about a quarter of the positions.  The port rounds
every operation once, as JAX does op by op.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_trace_golang_tpu import scene as JS
from path_trace_golang_tpu import soa as jsoa
from path_trace_golang_tpu.ops import camera as jcam
from path_trace_golang_tpu.ops import fog as jfog
from path_trace_golang_tpu.ops import geometry as jgeo
from path_trace_golang_tpu.ops import optics as jopt
from path_trace_golang_tpu.ops import rng as jrng
from path_trace_golang_tpu.ops import sampling as jsmp
from path_trace_golang_tpu.ops import sky as jsky
from path_trace_golang_tpu.ops.rng import LaneRng as JLaneRng
from path_trace_golang_tpu.ops.vec import V3 as JV3
from path_trace_golang_tpu.scene import builtin as JB

from path_trace_golang_tpu_torch import scene as TS
from path_trace_golang_tpu_torch import soa as tsoa
from path_trace_golang_tpu_torch.ops import camera as tcam
from path_trace_golang_tpu_torch.ops import fog as tfog
from path_trace_golang_tpu_torch.ops import geometry as tgeo
from path_trace_golang_tpu_torch.ops import optics as topt
from path_trace_golang_tpu_torch.ops import rng as trng
from path_trace_golang_tpu_torch.ops import sampling as tsmp
from path_trace_golang_tpu_torch.ops import sky as tsky
from path_trace_golang_tpu_torch.ops.rng import LaneRng as TLaneRng
from path_trace_golang_tpu_torch.ops.vec import V3 as TV3
from path_trace_golang_tpu_torch.scene import builtin as TB

SMALL_SCENES = ["demo_cornell", "demo_showcase"]
MESH_SCENES = ["demo_mesh", "bench_mesh"]
N = 512


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _close(a, b, atol=1e-6, rtol=1e-5):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=rtol)


def _close3(a, b, **kw):
    for ca, cb in zip(a, b):
        _close(ca, cb, **kw)


def _u(rng, n=N):
    return rng.random(n).astype(np.float32)


def _unit(rng, n=N):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v


def _jv(a):
    return JV3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]), jnp.asarray(a[:, 2]))


def _tv(a):
    return TV3(torch.from_numpy(a[:, 0].copy()), torch.from_numpy(a[:, 1].copy()), torch.from_numpy(a[:, 2].copy()))


# ---------------------------------------------------------------------------
# scene + pack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", SMALL_SCENES + MESH_SCENES)
def test_scene_json_roundtrip_matches_jax(name, tmp_path):
    jsc, tsc = getattr(JB, name)(), getattr(TB, name)()
    assert JS.dumps(jsc) == TS.dumps(tsc)
    path = tmp_path / "s.json"
    TS.save(path, tsc)
    back = TS.load(path)
    assert back.to_json() == tsc.to_json()
    assert dataclasses.asdict(back) == dataclasses.asdict(TS.loads(JS.dumps(jsc)))
    assert JS.dumps(JS.load(path)) == TS.dumps(TS.load(path))


@pytest.mark.parametrize("name", SMALL_SCENES)
def test_pack_scene_bit_equal(name):
    jp = jsoa.pack_scene(getattr(JB, name)(), 64, 36)
    tp = tsoa.pack_scene(getattr(TB, name)(), 64, 36, device="cpu")
    for field in tsoa.ARRAY_FIELDS:
        a, b = np.asarray(getattr(jp, field)), getattr(tp, field).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), field
    for field in tsoa.STATIC_FIELDS:
        if field == "bvh":
            jt, tt = jp.bvh, tp.bvh
            assert (jt is None) == (tt is None)
            if jt is not None:
                assert (jt.miss, jt.first, jt.count, jt.order) == (tt.miss, tt.first, tt.count, tt.order)
        else:
            assert tuple(np.atleast_1d(getattr(jp, field))) == tuple(np.atleast_1d(getattr(tp, field))), field


@pytest.mark.parametrize("name", SMALL_SCENES)
def test_pack_from_numpy_roundtrip(name):
    jp = jsoa.pack_scene(getattr(JB, name)(), 64, 36)
    arrays = {f: np.asarray(getattr(jp, f)) for f in tsoa.ARRAY_FIELDS}
    static = {f: getattr(jp, f) for f in tsoa.STATIC_FIELDS}
    carried = tsoa.pack_from_numpy(arrays, static, device="cpu")
    own = tsoa.pack_scene(getattr(TB, name)(), 64, 36, device="cpu")
    for f in tsoa.ARRAY_FIELDS:
        assert torch.equal(getattr(carried, f), getattr(own, f)), f
    for f in tsoa.STATIC_FIELDS:
        assert getattr(carried, f) == getattr(own, f), f


# ---------------------------------------------------------------------------
# RNG: bit-exact
# ---------------------------------------------------------------------------


def _u32_samples():
    rng = np.random.default_rng(1)
    edge = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1, 0x9E3779B9], np.uint32)
    return np.concatenate([edge, rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)])


def test_hash_u_bit_exact():
    x = _u32_samples()
    want = np.asarray(jrng.hash_u(jnp.asarray(x)))
    got = trng.hash_u(torch.from_numpy(x.astype(np.int64))).numpy()
    assert np.array_equal(want.astype(np.int64), got)


@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1, 0x9E3779B9])
def test_seed_lanes_bit_exact(seed):
    rng = np.random.default_rng(2)
    px = rng.integers(0, 1920, 2048).astype(np.int32)
    py = rng.integers(0, 1080, 2048).astype(np.int32)
    want = np.asarray(jrng.seed_lanes(jnp.asarray(px), jnp.asarray(py), jnp.uint32(seed)))
    got = trng.seed_lanes(torch.from_numpy(px), torch.from_numpy(py), seed).numpy()
    assert np.array_equal(want.astype(np.int64), got)


def test_uniform_bit_exact_over_a_chain():
    x = _u32_samples()
    js, ts = jnp.asarray(x), torch.from_numpy(x.astype(np.int64))
    for _ in range(4):
        js, ju = jrng.uniform(js)
        ts, tu = trng.uniform(ts)
        assert np.array_equal(np.asarray(js).astype(np.int64), ts.numpy())
        assert np.array_equal(np.asarray(ju).view(np.uint32), tu.numpy().view(np.uint32))


# ---------------------------------------------------------------------------
# element-wise lane math
# ---------------------------------------------------------------------------


def test_sincos_2pi():
    u = np.concatenate([_u(np.random.default_rng(3)), np.array([0.0, 0.125, 0.25, 0.5, 1.0], np.float32)])
    js, jc = jsmp.sincos_2pi(jnp.asarray(u))
    ts, tc = tsmp.sincos_2pi(torch.from_numpy(u))
    _close(js, ts)
    _close(jc, tc)


def test_samplers():
    rng = np.random.default_rng(4)
    u1, u2, u3 = _u(rng), _u(rng), _u(rng)
    n = _unit(rng)
    j = lambda a: jnp.asarray(a)  # noqa: E731
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    _close3(jsmp.unit_ball(j(u1), j(u2), j(u3)), tsmp.unit_ball(t(u1), t(u2), t(u3)))
    _close3(jsmp.unit_disk(j(u1), j(u2)), tsmp.unit_disk(t(u1), t(u2)))
    _close3(jsmp.sphere_surface(j(u1), j(u2)), tsmp.sphere_surface(t(u1), t(u2)))
    _close3(jsmp.cosine_direction(_jv(n), j(u1), j(u2)), tsmp.cosine_direction(_tv(n), t(u1), t(u2)))
    inc = _unit(rng)
    rough = rng.uniform(0.01, 1.0, N).astype(np.float32)
    _close3(
        jsmp.sample_ggx(_jv(inc), _jv(n), j(rough), j(u1), j(u2)),
        tsmp.sample_ggx(_tv(inc), _tv(n), t(rough), t(u1), t(u2)),
    )


def test_optics():
    rng = np.random.default_rng(5)
    v, n = _unit(rng), _unit(rng)
    flip = (v * n).sum(1) > 0
    n[flip] = -n[flip]  # normal toward the incident side
    eta = rng.uniform(0.5, 1.6, N).astype(np.float32)
    _close3(jopt.reflect(_jv(v), _jv(n)), topt.reflect(_tv(v), _tv(n)))
    _close3(
        jopt.refract(_jv(v), _jv(n), jnp.asarray(eta)),
        topt.refract(_tv(v), _tv(n), torch.from_numpy(eta)),
    )
    cosine = _u(rng)
    _close(jopt.schlick(jnp.asarray(cosine), jnp.asarray(eta)), topt.schlick(torch.from_numpy(cosine), torch.from_numpy(eta)))


@pytest.mark.parametrize("name", SMALL_SCENES)
def test_camera_and_sky(name):
    rng = np.random.default_rng(6)
    jp = jsoa.pack_scene(getattr(JB, name)(), 64, 36)
    tp = tsoa.pack_scene(getattr(TB, name)(), 64, 36, device="cpu")
    u, v = _u(rng), _u(rng)
    seeds = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    for aperture in (False, True):
        jr, tr = JLaneRng(jnp.asarray(seeds)), TLaneRng(torch.from_numpy(seeds.astype(np.int64)))
        jo, jd = jcam.camera_rays(jnp.asarray(u), jnp.asarray(v), jp.cam, 64, 36, jr, aperture, jp.lens_disk)
        to, td = tcam.camera_rays(torch.from_numpy(u), torch.from_numpy(v), tp.cam, 64, 36, tr, aperture, tp.lens_disk)
        _close3(jo, to)
        _close3(jd, td)
        assert np.array_equal(np.asarray(jr.state).astype(np.int64), tr.state.numpy())
    d = _unit(rng)
    _close3(jsky.background_color(_jv(d), jp.sky), tsky.background_color(_tv(d), tp.sky))


# ---------------------------------------------------------------------------
# intersection and fog on the demo_showcase pack
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def showcase_rays():
    """Rays from around the camera and from random points in the scene."""
    rng = np.random.default_rng(7)
    o = np.concatenate([
        np.array([0.0, 2.8, 11.0], np.float32) + rng.normal(scale=0.3, size=(N // 2, 3)).astype(np.float32),
        rng.uniform([-8, 0.05, -6], [8, 7, 6], size=(N // 2, 3)).astype(np.float32),
    ])
    d = _unit(rng)
    d[: N // 2, 2] = -np.abs(d[: N // 2, 2])  # camera rays look into the scene
    jp = jsoa.pack_scene(JB.demo_showcase(), 64, 36)
    tp = tsoa.pack_scene(TB.demo_showcase(), 64, 36, device="cpu")
    return o, d, jp, tp


def test_intersect_world_showcase(showcase_rays):
    o, d, jp, tp = showcase_rays
    jh = jax.jit(lambda a, b: jgeo.intersect_world(a, b, jp, 0.001))(_jv(o), _jv(d))
    th = tgeo.intersect_world(_tv(o), _tv(d), tp, 0.001)
    jhit, thit = np.asarray(jh.hit), th.hit.numpy()
    same = (jhit == thit) & (np.asarray(jh.obj_idx) == th.obj_idx.numpy())
    assert same.mean() >= 0.999
    assert jhit.mean() > 0.5  # the rays do hit things
    both = same & jhit
    _close(np.asarray(jh.t)[both], th.t.numpy()[both], atol=0, rtol=1e-5)
    # p = o + d t inherits t's relative error at |p| up to ~40 (abs 2e-4);
    # a sphere's normal (p - c) / r inherits p's error over r >= 0.4
    for field, atol in (("normal", 5e-4), ("p", 2e-4)):
        _close3([c[both] for c in getattr(jh, field)], [c.numpy()[both] for c in getattr(th, field)], atol=atol, rtol=1e-5)
    assert np.array_equal(np.asarray(jh.mtyp)[both], th.mtyp.numpy()[both])
    assert np.array_equal(np.asarray(jh.obj_type)[both], th.obj_type.numpy()[both])


def test_occluded_showcase(showcase_rays):
    o, d, jp, tp = showcase_rays
    t_max = np.random.default_rng(8).uniform(0.1, 30.0, N).astype(np.float32)
    jb = jax.jit(lambda a, b, t: jgeo.occluded(a, b, jp, 0.001, t))(_jv(o), _jv(d), jnp.asarray(t_max))
    tb = tgeo.occluded(_tv(o), _tv(d), tp, 0.001, torch.from_numpy(t_max))
    assert (np.asarray(jb) == tb.numpy()).mean() >= 0.999


def test_fog_medium_coeffs(showcase_rays):
    o, _d, jp, tp = showcase_rays
    j = jfog.medium_coeffs(_jv(o), jp.fog)
    t = tfog.medium_coeffs(_tv(o), tp.host("fog"))
    for a, b in zip(j, t):
        _close(a, b, atol=5e-3, rtol=0)


def _hash31_np(p, fused):
    """fog.hash31 in numpy float32, one rounding per operation (``fused``
    False) or with each dot product's two multiply-adds fused, x*a + (y*b +
    z*c) as fma(z, c, fma(x, a, y*b)) evaluated exactly in float64; sin
    evaluated in float64 and rounded."""
    f, f64 = np.float32, np.float64
    x, y, z = p[:, 0], p[:, 1], p[:, 2]

    def dot(a, b, c):
        a, b, c = f(a), f(b), f(c)
        if not fused:
            return (x * a + y * b) + z * c
        t1 = (x.astype(f64) * f64(a) + (y * b).astype(f64)).astype(f)
        return (z.astype(f64) * f64(c) + t1.astype(f64)).astype(f)

    q = (dot(127.1, 311.7, 74.7) + dot(269.5, 183.3, 246.1)) + dot(113.5, 271.9, 124.6)
    s = np.sin(q.astype(f64)).astype(f) * f(43758.5453)
    return s - np.floor(s)


def _circ(a, b):
    """Distance between two noise values in [0, 1) on the unit circle."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)) % 1.0
    return np.minimum(d, 1.0 - d)


def test_hash31_fma_witness(showcase_rays):
    """Where the port's fog noise parts from JAX's, at fog-march positions.

    The port, and JAX run op by op, round every multiply and add once: both
    agree with numpy's one-rounding evaluation to within sin's last bit
    (up to ~4e-3 of noise after the * 43758.5453).  Under jax.jit, XLA's CPU
    backend fuses the multiply-adds of q = the three dot products into FMAs;
    q then changes in its last bit and, at |q| ~ 6e3, the noise outright.
    Every jitted lane agrees with either the one-rounding or the fused numpy
    evaluation.  Measured on this input (x86-64 CPU, jax 0.9.0): jitted JAX
    gives the fused value on 27% of lanes and agrees with the one-rounding
    value on the rest; the port and eager JAX part from the one-rounding
    value by at most 3.9e-3 on every lane.  This is the gap that
    tests/test_torch_integrator.py finds on demo_showcase with the noise on.
    """
    o, d, _jp, tp = showcase_rays
    t = np.random.default_rng(9).uniform(0.0, 40.0, size=(N, 1)).astype(np.float32)
    p = ((o + d * t) * np.float32(tp.host("fog")[12])).astype(np.float32)  # first octave
    one_rounding, fused = _hash31_np(p, False), _hash31_np(p, True)
    port = tfog.hash31(_tv(p)).numpy()
    eager = np.asarray(jfog.hash31(_jv(p)))
    jitted = np.asarray(jax.jit(jfog.hash31)(_jv(p)))
    sin_ulp = 5e-3
    assert (_circ(port, one_rounding) <= sin_ulp).all()
    assert (_circ(eager, one_rounding) <= sin_ulp).all()
    assert (_circ(port, eager) <= sin_ulp).all()
    assert ((_circ(jitted, one_rounding) <= sin_ulp) | (_circ(jitted, fused) <= sin_ulp)).all()
    print(f"hash31 on {N} fog-march positions: jitted JAX outright off the one-rounding value on "
          f"{(_circ(jitted, one_rounding) > sin_ulp).mean():.2%}, on the fused value on "
          f"{(_circ(jitted, fused) <= sin_ulp).mean():.2%}; port off the one-rounding value by at most "
          f"{_circ(port, one_rounding).max():.3g}, eager JAX by at most {_circ(eager, one_rounding).max():.3g}")
    # the two numpy evaluations do part on this input, so the check above sees both
    assert (_circ(fused, one_rounding) > 1e-2).mean() > 0.05
