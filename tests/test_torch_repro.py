"""The Mosaic repros T5-T8 of the PyTorch port against the JAX package's TPU
repros, and on a card only their CUDA kernels against their plain versions.

The JAX repros (``tools/repro/window_slice_probe.py``,
``mosaic_cond_skip.py``, ``mosaic_reshape_repro.py``,
``group_rows_relayout.py``) are imported as they are, with ``pallas_call``
in interpret mode for the length of a test, and their own kernel functions
run on the scripts' own inputs (numpy seeds): ``_kernel_a``/``_kernel_b``,
``cond_kernel``/``ctrl_kernel``, ``_body`` through ``run_stage``, and
``body`` inside the kernel that T8's ``main`` builds (its ``main`` cannot
run on the CPU: it asks for the compiled kernel).  The port's plain
versions (``ops/repro.py``) get the same inputs.

Tolerances:

* T5: the bf16 table and both layouts' outputs bit-equal; on the special
  values (``window_slice_probe.special_inputs``) bit-equal where a number
  and NaN where NaN, as is the CPU mirror of the kernel's closed form
  against the plain version;
* T6, 2 rounds (64 products), cond true, cond false and the control, on the
  script's ones: bit-equal (checksum 16384: ``a @ ones == ones``).  On a
  random ``b`` (``RandomState(0)``, uniform in [-1, 1)) the port's plain
  version differs between cond true and cond false, equals an unfused numpy
  chain bit for bit, and is within ``max|a-b| <= 1e-5 * max|b|`` of the
  JAX chain.  Not bit-equal, and not element by element: XLA's CPU dot
  computes each row's two-term sum as a fused multiply-add in ascending
  order (this test asserts that the JAX chain equals that fused numpy chain
  or the unfused one), and it does so also in a process under
  ``--xla_cpu_max_isa=AVX``, so no subprocess gives the unfused sum.  After
  64 steps the fused and unfused chains are 4.6e-7 of the largest entry
  apart, and entries near zero (cancellation of 0.9x + 0.1y) up to 2.9e-4
  relative (measured, x86-64);
* T7 stages 1-4 and T8, G in {1, 2, 4, 8}: bit-equal;
* T7 stage 5, G in {1, 2, 4, 8}: within rel 1e-6 in this process, where XLA
  may contract ``acc + contrib*row`` into a fused multiply-add, and
  bit-equal to the JAX kernel run in a process under
  ``--xla_cpu_max_isa=AVX`` (no FMA).

On a card, each kernel against its plain version, bit for bit (T6 on T6's
own ``a``, whose rows have two nonzero entries).
"""

import functools
import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from path_trace_golang_tpu_torch.ops import repro
from path_trace_golang_tpu_torch.tools.repro import group_rows_relayout as t8
from path_trace_golang_tpu_torch.tools.repro import mosaic_cond_skip as t6
from path_trace_golang_tpu_torch.tools.repro import mosaic_reshape_repro as t7
from path_trace_golang_tpu_torch.tools.repro import window_slice_probe as t5

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPRO = os.path.join(REPO, "tools", "repro")
GROUPS = (1, 2, 4, 8)
T6_ROUNDS = 2
T6_TOL = 1e-5  # max |port - jax| over max |jax|, T6 on a random b
T7_STAGE5_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Beside other test workers on the same cores one PyTorch thread is faster."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def jax_repro(monkeypatch):
    """Import one of the JAX package's repro scripts with ``pallas_call`` in
    interpret mode (for this test only); the module leaves sys.modules after."""
    monkeypatch.syspath_prepend(REPRO)
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    loaded = []

    def load(name):
        sys.modules.pop(name, None)
        mod = importlib.import_module(name)
        loaded.append(name)
        return mod

    yield load
    for name in loaded:
        sys.modules.pop(name, None)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a.view(np.uint16)


def _random_b():
    return np.random.RandomState(0).uniform(-1, 1, (t6.N, t6.N)).astype(np.float32)


# ---------------------------------------------------------------------------
# T5: the windowed one-hot gather
# ---------------------------------------------------------------------------


def _jax_window_inputs():
    """window_slice_probe.main's inputs, as it draws them."""
    rng = np.random.default_rng(0)
    gt = rng.standard_normal((t5.R, t5.P)).astype(jnp.bfloat16)
    p_l = rng.integers(100, 220, size=(1, t5.LANE)).astype(np.int32)
    p_l[0, 7] = -1
    return gt, p_l


def test_window_table_bit_equal():
    gt, p_l = _jax_window_inputs()
    table, tp_l, want = t5.make_inputs("cpu")
    assert np.array_equal(_bits(gt), table.view(torch.int16).numpy().view(np.uint16))
    assert np.array_equal(p_l, tp_l.numpy())
    assert (want[:, 7] == 0).all() and want.any()


@pytest.mark.parametrize("layout", repro.LAYOUTS)
def test_window_slice_matches_jax(jax_repro, layout):
    ws = jax_repro("window_slice_probe")
    gt, p_l = _jax_window_inputs()
    kern, table = (ws._kernel_a, jnp.asarray(gt)) if layout == "A" else (ws._kernel_b, jnp.asarray(gt).T)
    vm = functools.partial(pl.BlockSpec, memory_space=pltpu.VMEM)
    want = np.asarray(pl.pallas_call(kern, in_specs=[vm(), vm()], out_specs=vm(),
                                     out_shape=jax.ShapeDtypeStruct((t5.R, t5.LANE), jnp.float32))(
        table, jnp.asarray(p_l)))
    ttable, tp_l, _ = t5.make_inputs("cpu")
    got = repro.window_slice(t5.layout_table(ttable, layout), tp_l, layout).numpy()
    assert np.array_equal(_bits(got), _bits(want))


def _window_pages():
    """The tool's pages and two sets whose window starts past 0, as
    chip_smoke.py phase 24 draws them: floored to 128, and clamped to
    P - W = 256 with pages outside the window; every ninth lane dead."""
    _table, p_l, _want = t5.make_inputs("cpu")
    rs = np.random.RandomState(24)
    sets = {"tool": p_l}
    for label, lo, hi in (("floored", 130, 450), ("clamped", 300, 512)):
        p = rs.randint(lo, hi, (1, t5.LANE)).astype(np.int32)
        p[0, ::9] = -1
        sets[label] = torch.from_numpy(p)
    return sets


def _window_closed_form(table, p_l, layout):
    """T5's closed form, as window_slice_kernel computes it (csrc/repro.cu):
    for each row r of the window, NaN where the row holds a non-finite bf16
    entry other than lane i's column, else that column's value + 0.0 where
    lane i's page lies in the window, else +0."""
    _r, p = repro._table_dims("window_slice", table, layout)
    lanes = p_l.reshape(-1).to(torch.int64)
    base = repro.window_base(lanes, p)
    sl = (table[:, base:base + repro.WINDOW] if layout == "A" else table[base:base + repro.WINDOW, :].T).float()
    bad = ~torch.isfinite(sl)
    col = lanes - base
    sel = (col >= 0) & (col < repro.WINDOW)
    t = sl[:, col.clamp(0, repro.WINDOW - 1)]  # (R, N)
    others = bad.sum(1, keepdim=True) - (sel[None, :] & ~torch.isfinite(t)).to(torch.int64)
    return torch.where(others > 0, torch.full_like(t, float("nan")),
                       torch.where(sel[None, :], t + 0.0, torch.zeros_like(t)))


T5_SPECIAL = ("zeros", "-0 in a negative row", "inf at a page", "-inf off the pages", "inf past the window",
              "nan off the pages", "bf16 overflow", "dead lanes", "pages past the window")


def test_window_special_inputs_are_the_named_cases():
    """The special inputs hold what their names say, in the plain version's
    output: a selected -0 in a negative row gives +0, a selected +inf gives
    +inf beside NaN for every other lane of its row, an inf outside the
    window changes nothing, a dead lane or a page past the window gives +0."""
    cases = t5.special_inputs("cpu")
    assert tuple(cases) == T5_SPECIAL
    tool_table, tool_pages, want = t5.make_inputs("cpu")
    out = {c: repro.window_slice_plain(t, p, "A") for c, (t, p) in cases.items()}
    pages = tool_pages[0].tolist()
    neg = cases["-0 in a negative row"][0][5].float()
    win = neg[:repro.WINDOW]
    assert bool((torch.signbit(win) & ((win < 0) | (win == 0))).all()) and float(neg[pages[0]]) == 0
    assert out["-0 in a negative row"][5, 0].item() == 0 and not torch.signbit(out["-0 in a negative row"][5, 0])
    assert not torch.signbit(out["-0 in a negative row"][6, 7])  # the dead lane of an all-negative row: +0
    assert not bool(torch.signbit(out["zeros"][:8, :2]).any()) and bool((out["zeros"][:8, :2] == 0).all())
    for c, row, lane in (("inf at a page", 9, 2), ("bf16 overflow", 17, 3)):
        assert out[c][row, lane].item() == float("inf")
        others = [i for i in range(t5.LANE) if pages[i] != pages[lane]]
        assert bool(torch.isnan(out[c][row, others]).all())
    for c, row in (("-inf off the pages", 11), ("nan off the pages", 15), ("bf16 overflow", 19)):
        assert bool(torch.isnan(out[c][row]).all()) and int(torch.isnan(out[c]).sum()) >= t5.LANE
    assert torch.equal(out["inf past the window"], torch.from_numpy(want))
    assert bool((out["dead lanes"][:, :4] == 0).all()) and bool((out["pages past the window"][:, 9:12] == 0).all())


@pytest.mark.parametrize("layout", repro.LAYOUTS)
@pytest.mark.parametrize("case", ["tool", "floored", "clamped", *T5_SPECIAL])
def test_window_closed_form_equals_plain(case, layout):
    """The closed form that the kernel writes equals window_slice_plain's
    contraction: bit for bit on the tool's table with the tool's, floored
    and clamped pages, and on the special values bit for bit where a number
    and NaN where NaN."""
    if case in T5_SPECIAL:
        table, pages = t5.special_inputs("cpu")[case]
    else:
        table, pages = t5.make_inputs("cpu")[0], _window_pages()[case]
    tab = t5.layout_table(table, layout)
    got, want = _window_closed_form(tab, pages, layout), repro.window_slice_plain(tab, pages, layout)
    assert _same_or_both_nan(got, want)
    if case not in T5_SPECIAL:
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("case", T5_SPECIAL)
def test_window_slice_special_matches_jax(jax_repro, case):
    """The JAX kernels (_kernel_a, _kernel_b, interpret mode) and the port's
    plain version agree on the special values in both layouts: bit for bit
    where a number, NaN where NaN."""
    ws = jax_repro("window_slice_probe")
    table, pages = t5.special_inputs("cpu")[case]
    gt = jnp.asarray(table.float().numpy()).astype(jnp.bfloat16)
    vm = functools.partial(pl.BlockSpec, memory_space=pltpu.VMEM)
    for layout in repro.LAYOUTS:
        kern, jt = (ws._kernel_a, gt) if layout == "A" else (ws._kernel_b, gt.T)
        want = np.array(pl.pallas_call(kern, in_specs=[vm(), vm()], out_specs=vm(),
                                       out_shape=jax.ShapeDtypeStruct((t5.R, t5.LANE), jnp.float32))(
            jt, jnp.asarray(pages.numpy())))
        got = repro.window_slice(t5.layout_table(table, layout), pages, layout)
        assert _same_or_both_nan(got, torch.from_numpy(want)), layout


def test_window_base_floors_and_clamps():
    p = torch.tensor([300, 290, -1], dtype=torch.int32)
    assert repro.window_base(p, 512) == 256  # floor(290) = 256, clamp to P - W = 256
    assert repro.window_base(torch.tensor([-1, -1], dtype=torch.int32), 512) == 256  # no live lane
    assert repro.window_base(torch.tensor([130, 400], dtype=torch.int32), 1024) == 128


# ---------------------------------------------------------------------------
# T6: the guarded chain
# ---------------------------------------------------------------------------

T6_RUNS = {"true": (1, False), "false": (0, False), "ctrl": (1, True)}


def _jax_chain(cs, name, b, rounds=T6_ROUNDS):
    flag, control = T6_RUNS[name]
    kern = (cs.ctrl_kernel if control else cs.cond_kernel)(rounds)
    fn = pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct((t6.N, t6.N), jnp.float32))
    return np.asarray(fn(jnp.full((1,), flag, jnp.int32), cs._mk_a(), jnp.asarray(b)))


def _port_chain(name, b, rounds=T6_ROUNDS):
    flag, control = T6_RUNS[name]
    a, _ = t6.make_inputs("cpu")
    return repro.cond_chain(torch.tensor([flag], dtype=torch.int32), a, torch.from_numpy(b), rounds, control).numpy()


def _numpy_chain(a, b, steps, fused):
    """``steps`` products c <- a @ c in float32: each row's sum unfused (a
    product rounded, then the sum), or with each further term as a fused
    multiply-add in ascending column order (XLA's CPU dot)."""
    c = b.copy()
    nz = [np.nonzero(a[k])[0] for k in range(len(a))]
    for _ in range(steps):
        if not fused:
            c = (a[:, :, None] * c[None]).sum(1, dtype=np.float32)
            continue
        out = np.empty_like(c)
        for k, ms in enumerate(nz):
            acc = (a[k, ms[0]] * c[ms[0]]).astype(np.float32)
            for m in ms[1:]:
                acc = (acc.astype(np.float64) + np.float64(a[k, m]) * c[m].astype(np.float64)).astype(np.float32)
            out[k] = acc
        c = out
    return c


def test_cond_chain_inputs_equal_jax(jax_repro):
    cs = jax_repro("mosaic_cond_skip")
    assert np.array_equal(_bits(np.asarray(cs._mk_a())), _bits(t6.make_a()))
    assert all(len(np.nonzero(r)[0]) <= 2 for r in t6.make_a())  # what the kernel's bit-equality rests on


@pytest.mark.parametrize("name", T6_RUNS)
def test_cond_chain_matches_jax_on_ones(jax_repro, name):
    """The JAX script's own b: every output is ones, checksum 16384, in all
    three runs (the script's fold WARNING always fires)."""
    cs = jax_repro("mosaic_cond_skip")
    ones = np.ones((t6.N, t6.N), np.float32)
    want = _jax_chain(cs, name, ones)
    got = _port_chain(name, ones)
    assert np.array_equal(_bits(got), _bits(want))
    assert float(np.abs(got).sum()) == 16384.0


def test_cond_chain_random_b(jax_repro):
    """On a random b the chain moves: true differs from false, equals an
    unfused numpy chain bit for bit, and the JAX chain within T6_TOL."""
    cs = jax_repro("mosaic_cond_skip")
    b = _random_b()
    got = {name: _port_chain(name, b) for name in T6_RUNS}
    assert not np.array_equal(got["true"], got["false"])
    assert np.array_equal(_bits(got["false"]), _bits(b))
    assert np.array_equal(_bits(got["true"]), _bits(got["ctrl"]))
    a = t6.make_a()
    steps = T6_ROUNDS * repro.INNER
    assert np.array_equal(_bits(got["true"]), _bits(_numpy_chain(a, b, steps, fused=False)))
    want = _jax_chain(cs, "true", b)
    err = float(np.abs(got["true"] - want).max() / np.abs(want).max())
    print(f"T6 random b: port vs JAX max|a-b|/max|b| {err:.3g}, bit-equal {np.array_equal(got['true'], want)}")
    assert err <= T6_TOL
    assert any(np.array_equal(_bits(want), _bits(_numpy_chain(a, b, steps, fused))) for fused in (True, False))


def test_cond_chain_random_b_without_contraction(jax_no_fma):
    """Under --xla_cpu_max_isa=AVX the JAX chain is still a fused or an
    unfused chain, and within T6_TOL of the port's."""
    want = jax_no_fma["t6:true"]
    b = _random_b()
    a = t6.make_a()
    steps = T6_ROUNDS * repro.INNER
    assert any(np.array_equal(_bits(want), _bits(_numpy_chain(a, b, steps, fused))) for fused in (True, False))
    got = _port_chain("true", b)
    assert float(np.abs(got - want).max() / np.abs(want).max()) <= T6_TOL


# ---------------------------------------------------------------------------
# T7 and T8: the regrouping repros
# ---------------------------------------------------------------------------


def _t7_inputs():
    x, w = t7.make_inputs("cpu")
    return x, w, jnp.asarray(x.numpy()), jnp.asarray(w.numpy())


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("stage", (1, 2, 3, 4))
def test_reshape_stage_matches_jax(jax_repro, stage, g):
    rr = jax_repro("mosaic_reshape_repro")
    x, w, jx, jw = _t7_inputs()
    kernel_out, xla_out = rr.run_stage(stage, g, jx, jw)
    got = repro.reshape_stage(x, w, stage, g).numpy()
    assert np.array_equal(_bits(got), _bits(kernel_out))
    assert np.array_equal(_bits(got), _bits(xla_out))


@pytest.mark.parametrize("g", GROUPS)
def test_reshape_stage5_matches_jax(jax_repro, g):
    """In this process XLA may fuse ``acc + contrib*row``: rel 1e-6."""
    rr = jax_repro("mosaic_reshape_repro")
    x, w, jx, jw = _t7_inputs()
    kernel_out, _ = rr.run_stage(5, g, jx, jw)
    got = repro.reshape_stage(x, w, 5, g).numpy()
    err = float(np.max(np.abs(got - kernel_out) / np.abs(kernel_out)))
    print(f"T7 stage 5 G={g}: max rel err {err:.3g}, bit-equal {np.array_equal(got, kernel_out)}")
    assert err <= T7_STAGE5_RTOL


@pytest.mark.parametrize("g", GROUPS)
def test_reshape_stage5_matches_jax_without_contraction(jax_no_fma, g):
    x, w, _, _ = _t7_inputs()
    got = repro.reshape_stage(x, w, 5, g).numpy()
    assert np.array_equal(_bits(got), _bits(jax_no_fma[f"t7:{g}"]))


def test_reshape_stages_ignore_g():
    """The regrouping is an index map: no stage's output depends on G."""
    x, w, _, _ = _t7_inputs()
    for stage in repro.STAGES:
        outs = [repro.reshape_stage_plain(x, w, stage, g) for g in GROUPS]
        assert all(torch.equal(o, outs[0]) for o in outs), stage


def _stage5_table(w):
    """Stage 5's 129 answers by the column-minimum identity that
    reshape_stage5_kernel builds its table by (csrc/repro.cu): for pop p,
    the NaN-propagating minimum over the rows of NaN where the row's other
    entries hold a non-finite bf16, else +0 + bf16(w[r, p]); for p = 128
    (an empty word) NaN where any row holds a non-finite bf16, else +0."""
    b = w.to(torch.bfloat16).float()
    bad = ~torch.isfinite(b)
    others = bad.sum(1, keepdim=True) - bad.to(torch.int64)
    gth = torch.where(others > 0, torch.full_like(b, float("nan")), b + 0.0)
    empty = torch.full((1,), float("nan") if bool(bad.any()) else 0.0)
    return torch.cat([gth.amin(0), empty])


def _stage5_by_table(x, w):
    """Stage 5's lanes with each pop's contraction read from the table."""
    table = _stage5_table(w)
    acc = x * 0.0
    words = (x * 0.0).to(torch.int32) | repro.STAGE45_WORDS
    for _ in range(repro.TRIPS):
        p, words = repro._pop(words)
        acc = acc + table[p.to(torch.int64)] * x
    return acc


def _same_or_both_nan(a, b):
    """Bit for bit where either is a number, NaN where either is NaN (the
    payload of a NaN is the CPU's choice, not the algorithm's)."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def _t7_cases():
    x, w = t7.make_inputs("cpu")
    return {"tool": (x, w), **t7.special_inputs("cpu")}


@pytest.mark.parametrize("case", ["tool", "zeros", "inf at a pop", "inf off the pops", "nan", "bf16 overflow"])
def test_stage5_table_equals_the_contraction(case):
    """For every pop p = 0..128 the identity's entry equals the minimum of
    the plain version's contraction bf16(w) @ onehot(p), bit for bit (NaN
    where it is NaN), on the tool's w and on w with special values."""
    _x, w = _t7_cases()[case]
    wb = w.to(torch.bfloat16).float()
    onehot = (torch.arange(repro.LANE)[:, None] == torch.arange(repro.LANE + 1)[None, :]).to(torch.bfloat16).float()
    want = (wb[:, :, None] * onehot[None, :, :]).sum(1).amin(0)
    got = _stage5_table(w)
    assert _same_or_both_nan(got, want)
    assert not bool((got == 0).logical_and(torch.signbit(got)).any())  # no -0 in the table
    if case == "tool":
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("case", ["tool", "zeros", "inf at a pop", "inf off the pops", "nan", "bf16 overflow"])
def test_stage5_by_table_equals_plain(case, g):
    """The lanes run on the table equal reshape_stage_plain's stage 5 at
    every G: bit for bit on the tool's x and w, and on the special-value
    inputs (a NaN and negative entries in x) bit for bit where a number."""
    x, w = _t7_cases()[case]
    got, want = _stage5_by_table(x, w), repro.reshape_stage_plain(x, w, 5, g)
    assert _same_or_both_nan(got, want)
    if case == "tool":
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if case == "zeros":  # the lanes of negative x end at -0: a zero's sign in the table shows
        assert bool(torch.signbit(want[1, :16]).all()) and bool((want[1, :16] == 0).all())


@pytest.mark.parametrize("g", GROUPS)
def test_group_rows_matches_jax(jax_repro, g):
    gr = jax_repro("group_rows_relayout")
    x = t8.make_input("cpu")

    def kernel(x_ref, o_ref):
        o_ref[:] = gr.body(x_ref[:], g)

    want = np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((t8.ROWS, t8.LANE), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)], out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
    )(jnp.asarray(x.numpy())))
    got = repro.group_rows(x, g).numpy()
    assert np.array_equal(_bits(got), _bits(want))
    assert np.array_equal(_bits(got), _bits(np.asarray(jax.jit(lambda a: gr.body(a, g))(jnp.asarray(x.numpy())))))


# ---------------------------------------------------------------------------
# the JAX repros in a process whose XLA does not contract multiply-adds
# ---------------------------------------------------------------------------


def _jax_no_fma_outputs(out_path):
    """Run T7's stage 5 for every G and T6's cond-true chain on the random b
    (interpret mode) and save them; run in a process under
    ``--xla_cpu_max_isa=AVX``, which has no FMA."""
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPRO)
    pl.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    rr = importlib.import_module("mosaic_reshape_repro")
    _, _, jx, jw = _t7_inputs()
    outs = {f"t7:{g}": np.asarray(rr.run_stage(5, g, jx, jw)[0]) for g in GROUPS}
    outs["t6:true"] = _jax_chain(importlib.import_module("mosaic_cond_skip"), "true", _random_b())
    np.savez(out_path, **outs)


@pytest.fixture(scope="module")
def jax_no_fma(tmp_path_factory):
    out = tmp_path_factory.mktemp("no_fma") / "outputs.npz"
    path = os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX", PYTHONPATH=path)
    r = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return dict(np.load(out))


# ---------------------------------------------------------------------------
# the wrappers and the tools on the CPU
# ---------------------------------------------------------------------------


def test_repro_tools_import_without_jax():
    code = ("import sys\n"
            "import path_trace_golang_tpu_torch.tools.repro.window_slice_probe, path_trace_golang_tpu_torch.tools."
            "repro.mosaic_cond_skip, path_trace_golang_tpu_torch.tools.repro.mosaic_reshape_repro, "
            "path_trace_golang_tpu_torch.tools.repro.group_rows_relayout\n"
            "assert 'jax' not in sys.modules and not any(m.startswith('path_trace_golang_tpu.') or "
            "m == 'path_trace_golang_tpu' for m in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


def test_repro_tools_run_on_cpu(capsys):
    """Each tool's entry point runs the plain versions with --device cpu and
    prints the JAX script's lines (T6's fold WARNING included)."""
    assert t5.main(["--device", "cpu"]) == 0
    assert t6.main(["1", "--device", "cpu"]) == 0
    assert t7.main(["2", "--device", "cpu"]) == 0
    assert t8.main(["8", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for line in ("A lane-dim dslice: compiled, correct=True", "B transposed sublane dslice: compiled, correct=True",
                 "WARNING: cond-true and cond-false agree", "true/false", "stage 5: ok", "plain-vs-kernel",
                 "no mismatch", "host clock"):
        assert line in out, line


def test_repro_wrappers_dispatch_and_check():
    before = dict(repro.REPRO_PLAIN_CALLS)
    x = torch.zeros((8, 128))
    repro.group_rows(x, 2)
    repro.reshape_stage(x, torch.zeros((128, 128)), 1, 4)
    assert repro.REPRO_PLAIN_CALLS["group_rows"] == before["group_rows"] + 1
    assert repro.REPRO_PLAIN_CALLS["reshape_stage"] == before["reshape_stage"] + 1
    with pytest.raises(NotImplementedError):
        repro.group_rows(torch.zeros((8, 128), device="meta"), 2)
    with pytest.raises(ValueError):
        repro.group_rows_cuda(x, 2)  # a kernel takes CUDA tensors only
    with pytest.raises(ValueError):
        repro.group_rows(x, 3)  # G must divide the rows
    with pytest.raises(ValueError):
        repro.reshape_stage(x, torch.zeros((128, 128)), 6, 1)
    with pytest.raises(ValueError):
        repro.window_slice(torch.zeros((96, 128), dtype=torch.bfloat16), torch.zeros(4, dtype=torch.int32), "A")


# ---------------------------------------------------------------------------
# on a card: kernel = plain version, bit for bit
# ---------------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")


def _same(a, b):
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


@pytest.mark.cuda
def test_window_slice_kernel_matches_plain_on_card():
    _need_card()
    table, p_l, want = t5.make_inputs("cuda")
    for layout in repro.LAYOUTS:
        tab = t5.layout_table(table, layout)
        k = repro.window_slice(tab, p_l, layout)
        assert _same(k, repro.window_slice_plain(tab, p_l, layout)), layout
        assert np.array_equal(k.cpu().numpy(), want), layout


@pytest.mark.cuda
def test_window_slice_kernel_special_inputs_on_card():
    """T5's closed form on the card against the plain version on the special
    values, both layouts: bit for bit where a number, NaN where NaN; and on
    the floored and clamped pages bit for bit."""
    _need_card()
    for case, (table, pages) in t5.special_inputs("cuda").items():
        for layout in repro.LAYOUTS:
            tab = t5.layout_table(table, layout)
            assert _same_or_both_nan(repro.window_slice(tab, pages, layout),
                                     repro.window_slice_plain(tab, pages, layout)), (case, layout)
    table = t5.make_inputs("cuda")[0]
    for label, pages in _window_pages().items():
        for layout in repro.LAYOUTS:
            tab, pg = t5.layout_table(table, layout), pages.cuda()
            assert _same(repro.window_slice(tab, pg, layout), repro.window_slice_plain(tab, pg, layout)), label


@pytest.mark.cuda
def test_cond_chain_kernel_matches_plain_on_card():
    """T6's kernel (its threads sharing each row of a) against the plain
    version: bit for bit on the tool's a, with its ones and with a random b;
    on a dense random a within the rounding of the sums' order (128 terms,
    the chain's 64 products: at most 1e-4 of the largest entry)."""
    _need_card()
    a, ones = t6.make_inputs("cuda")
    for b in (ones, torch.from_numpy(_random_b()).cuda()):
        for name, (flag, control) in T6_RUNS.items():
            f = torch.tensor([flag], dtype=torch.int32, device="cuda")
            assert _same(repro.cond_chain(f, a, b, 2, control), repro.cond_chain_plain(f, a, b, 2, control)), name
    rng = np.random.RandomState(7)
    dense = torch.from_numpy((rng.uniform(-1, 1, (t6.N, t6.N)) / t6.N ** 0.5).astype(np.float32)).cuda()
    b = torch.from_numpy(_random_b()).cuda()
    f = torch.ones(1, dtype=torch.int32, device="cuda")
    k, p = repro.cond_chain(f, dense, b, 2), repro.cond_chain_plain(f, dense, b, 2)
    assert not _same(k, b) and float((k - p).abs().max()) <= 1e-4 * float(p.abs().max())


@pytest.mark.cuda
def test_reshape_stage_kernel_matches_plain_on_card():
    _need_card()
    x, w = t7.make_inputs("cuda")
    for g in GROUPS:
        for stage in repro.STAGES:
            assert _same(repro.reshape_stage(x, w, stage, g), repro.reshape_stage_plain(x, w, stage, g)), (stage, g)
    for case, (xs, ws) in t7.special_inputs("cuda").items():
        for g in GROUPS:
            assert _same(repro.reshape_stage(xs, ws, 5, g), repro.reshape_stage_plain(xs, ws, 5, g)), (case, g)


@pytest.mark.cuda
def test_group_rows_kernel_matches_plain_on_card():
    _need_card()
    x = t8.make_input("cuda")
    for g in GROUPS:
        assert _same(repro.group_rows(x, g), repro.group_rows_plain(x, g)), g


if __name__ == "__main__":
    _jax_no_fma_outputs(sys.argv[1])
