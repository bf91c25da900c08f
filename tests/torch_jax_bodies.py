"""One pass body of each package on every lane of a small frame, for the
knob tests (tests/test_torch_knobs.py, tests/test_torch_noregen.py).

The JAX side is ``render.trace_pass_lanes`` traced afresh for every call
(a new ``jax.jit``), because the JAX package reads its profiling knobs
while it traces; the port's is ``render.pass_body_grid`` on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from path_trace_golang_tpu import integrator as JI
from path_trace_golang_tpu import render as JR
from path_trace_golang_tpu import soa as jsoa

from path_trace_golang_tpu_torch import integrator as TI
from path_trace_golang_tpu_torch import render as TR
from path_trace_golang_tpu_torch import soa as tsoa

DEPTH = 4


def band(got, want, *, lanes=True):
    """tests/test_torch_integrator.py's band: >= 95% of lanes within |a-b| <=
    1e-3|b| + 1e-3 on all channels, segments within 2%, channel means within 1%."""
    (tc, ts), (jc, js) = got, want
    assert np.isfinite(tc).all()
    ok = (np.abs(tc - jc) <= 1e-3 * np.abs(jc) + 1e-3).all(axis=-1)
    if lanes:
        assert ok.mean() >= 0.95, f"lanes matching {ok.mean():.4f}"
    assert abs(ts - js) <= 0.02 * js, (ts, js)
    mt, mj = tc.astype(np.float64).mean(0), jc.astype(np.float64).mean(0)
    assert np.all(np.abs(mt - mj) <= 0.01 * np.abs(mj) + 1e-6), (mt, mj)


def pass_kw(sc, w, h, contract):
    n_strata, samples = (4, 16) if contract == "gpu" else (1, 1)
    return dict(width=w, height=h, n_strata=n_strata, samples=samples, has_aperture=sc.camera.aperture > 0,
                normalize_pass=False, n_passes=1)


def with_fog(jp, edits):
    """A JAX pack with fog-block slots replaced."""
    fog = np.asarray(jp.fog).copy()
    for slot, value in edits:
        fog[slot] = value
    return dataclasses.replace(jp, fog=jnp.asarray(fog))


def jax_body(jsc, w, h, seed, contract):
    """(f32[w*h, 3], segments) of JAX ``render.trace_pass_lanes``, one pass."""
    jp = jsoa.pack_scene(jsc, w, h)
    jcfg = JI.trace_config_for_scene(jp, jsc, DEPTH, contract)
    kw = pass_kw(jsc, w, h, contract)
    col, segs = jax.jit(lambda p, idx: JR.trace_pass_lanes(p, jnp.uint32(seed), idx, tcfg=jcfg, **kw))(
        jp, jnp.arange(w * h, dtype=jnp.int32))
    return np.asarray(col), int(segs)


def port_body(tsc, w, h, seed, contract, fog_edits=()):
    """(f32[w*h, 3], segments) of the port's ``render.pass_body_grid``, one pass."""
    tp = tsoa.pack_scene(tsc, w, h, device="cpu")
    for slot, value in fog_edits:
        tp.fog[slot] = value
    tcfg = TI.trace_config_for_scene(tp, tsc, DEPTH, contract)
    idx = torch.arange(w * h, dtype=torch.int32)
    col, segs = TR.pass_body_grid(tp, seed, idx % w, idx // w, tcfg=tcfg, **pass_kw(tsc, w, h, contract))
    return col.to_rows().numpy(), int(segs)
