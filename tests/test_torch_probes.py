"""The perf probes T1-T4 of the PyTorch port against the JAX package's TPU
probes, and on a card only their CUDA kernels against their plain versions.

The JAX probes (``tools/perf/microbench.py``, ``paged_probe.py``,
``fetch_probe.py``, ``fetch_probe2.py``) are run as they are, with
``pallas_call`` in interpret mode for the length of a test and their
module constants shrunk (``ITERS``, ``CHAIN``, ``ROWS``, ``N_BLOCKS``,
``REPS``); the port's plain versions (``ops/probes.py``) get the same
inputs.  T1's outputs are taken from the jitted calls of ``_bench`` (the
probe returns only a rate); T3's and T4's tables come from numpy's global
generator, seeded here before the probe draws them.

Tolerances:

* the probes' mesh (``uv_sphere``), paged table, boxes and rays: bit-equal;
* T1 (2 iterations: 128 ops a class, the hash 32 rounds): hash, select,
  sqrt and divide bit-equal; the JAX fma chain run where XLA contracts its
  multiply-add (this test process, an x86-64 host with FMA) bit-equal to
  the port's ``ffma`` class, and run where it does not (a process of its
  own under ``--xla_cpu_max_isa=AVX``) bit-equal to the port's ``fma``
  class; rsqrt, exp and sin within rel 1e-5 (the libraries' last bits may
  differ);
* T2 (a 512-triangle sphere, 4 pages, 1,024 rays, 2 chained traversals):
  ``fetch``, ``all`` and ``dense`` keys and the ``real`` distance bits
  equal the JAX probe's bit for bit, and the port's ``gather`` keys equal
  them too.  The JAX probe runs for that in a process of its own whose XLA
  does not contract multiply-adds (``--xla_cpu_max_isa=AVX``, an x86-64
  host): contraction moves its distances in the last bits;
* T3, all four layouts: bit-equal (a sum in page order on both sides),
  also at page counts around the kernel's ring of stages;
* T4: ``loop_only``, ``dyn_row`` and ``dyn_scalar`` bit-equal; the column
  sums of ``dyn_vec`` and ``static_vec`` within rel 1e-6 (XLA's reduction
  order over the 32 rows is its own; the port sums rows in order).

On a card, each kernel against its plain version: T1 at a short length
(the hash, select, sqrt, divide and unfused fma bit-equal, the others within
rel 1e-5), T2-T4 bit for bit.
"""

import functools
import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from path_trace_golang_tpu_torch.ops import bvh as tbvh
from path_trace_golang_tpu_torch.ops import probes
from path_trace_golang_tpu_torch.tools.perf import bvh_bench as tbench
from path_trace_golang_tpu_torch.tools.perf import fetch_probe as tfetch
from path_trace_golang_tpu_torch.tools.perf import fetch_probe2 as tfetch2
from path_trace_golang_tpu_torch.tools.perf import microbench as tmicro
from path_trace_golang_tpu_torch.tools.perf import paged_probe as tpaged
from path_trace_golang_tpu_torch.tools.perf import timing as ttiming

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERF = os.path.join(REPO, "tools", "perf")
SMALL_MESH = (16, 16)  # 512 triangles: 4 pages
SMALL_ROWS, SMALL_BLOCKS = 8, 1  # 1,024 rays
SMALL_REPS = 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain sweeps run many small tensor ops; beside other test workers
    on the same cores one PyTorch thread is faster."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def jax_probe(monkeypatch):
    """Import one of the JAX package's probe scripts with ``pallas_call`` in
    interpret mode (for this test only); the module leaves sys.modules after."""
    monkeypatch.syspath_prepend(PERF)
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
    return a.view(np.int32) if a.dtype == np.float32 else a


# ---------------------------------------------------------------------------
# inputs: mesh, paged table, rays
# ---------------------------------------------------------------------------


def test_uv_sphere_bit_equal(jax_probe):
    jb = jax_probe("bvh_bench")
    for n_lat, n_lon in ((80, 64), SMALL_MESH):
        jv, jf = jb.uv_sphere(n_lat, n_lon)
        tv, tf = tbench.uv_sphere(n_lat, n_lon)
        assert tf == jf
        assert np.array_equal(np.asarray(tv, np.float64), np.asarray(jv, np.float64))


@pytest.mark.parametrize("mesh", [(80, 64), SMALL_MESH])
def test_paged_table_bit_equal(jax_probe, mesh):
    """The probe's tiles and boxes, and the boxes of the scene pack that the
    ``real`` variant walks, equal the JAX probe's (its ``page_bounds`` /
    ``sub_bounds``, rounded to float32 as the JAX code bakes them in)."""
    jp = jax_probe("paged_probe")
    paged, tiles, _gather = jp.build_table(*mesh)
    tpg, ttiles, tboxes, treal = tpaged.build_table(*mesh, device="cpu")
    assert tpg.n_pages == paged.n_pages
    assert np.array_equal(_bits(ttiles.numpy()), _bits(np.asarray(tiles)))
    assert np.array_equal(_bits(tboxes.numpy()), _bits(tbvh.page_boxes_table(paged)))
    assert np.array_equal(_bits(treal.numpy()), _bits(tbvh.page_boxes_table(jp.PROBE_PACK.paged)))


@pytest.mark.parametrize("kind", tpaged.KINDS)
def test_packets_bit_equal(jax_probe, kind):
    jp = jax_probe("paged_probe")
    o, d = jp.packets(kind)
    rays = tpaged.packets(kind, device="cpu")
    want = np.stack([np.asarray(c).reshape(-1) for c in (o.x, o.y, o.z, d.x, d.y, d.z)])
    assert rays.shape == (6, tpaged.ROWS * tpaged.N_BLOCKS * tpaged.LANE)
    assert np.array_equal(_bits(rays.numpy()), _bits(want))


# ---------------------------------------------------------------------------
# T1: op chains
# ---------------------------------------------------------------------------

T1_JAX_ORDER = ("fma", "sqrt", "rsqrt", "divide", "exp", "sin", "hash", "select")  # microbench.main's order
T1_EXACT = ("hash", "select", "sqrt", "divide")
T1_RTOL = {"rsqrt": 1e-5, "exp": 1e-5, "sin": 1e-5}


class _JitSpy:
    """Stands in for the ``jax`` module inside microbench.py: every jitted
    call's concrete result is recorded beside the function it came from."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        f = jax.jit(fn, **kw)

        def call(*args):
            out = f(*args)
            self.calls.append((f, np.asarray(out)))
            return out

        return call


def _jax_op_chains(mb):
    """Run the JAX T1 probe module ``mb`` for 2 iterations and one call a
    class; returns {class: its chain's output from the block of 0.73}."""
    spy = _JitSpy()
    mb.ITERS, mb.CHAIN, mb.jax = 2, 1, spy
    mb.main()
    firsts, seen = [], set()
    for f, out in spy.calls:  # each _bench's first call starts from the block of 0.73
        if id(f) not in seen:
            seen.add(id(f))
            firsts.append(out)
    assert len(firsts) == len(T1_JAX_ORDER)
    return dict(zip(T1_JAX_ORDER, firsts))


def _t1_block():
    return torch.full((tmicro.ROWS, tmicro.LANE), 0.73)


def test_op_chains_match_jax(jax_probe):
    """In this process XLA contracts the fma chain's ``x * a + b`` into one
    fused multiply-add, so the JAX fma chain equals the port's ``ffma``
    class bit for bit, and not its ``fma`` (two roundings; held to the JAX
    chain without contraction by the next test).  Measured (x86-64): the
    other classes bit-equal too; the two multiply-add chains 1.04e-5 apart
    after 128 ops."""
    chains = _jax_op_chains(jax_probe("microbench"))  # the module leaves sys.modules after the test
    x = _t1_block()
    plain = probes.PROBE_PLAIN_CALLS["op_chain"]
    for kind, want in chains.items():
        if kind == "fma":
            assert np.array_equal(_bits(probes.op_chain("ffma", x, 2).numpy()), _bits(want))
            assert not np.array_equal(_bits(probes.op_chain("fma", x, 2).numpy()), _bits(want))
            continue
        got = probes.op_chain(kind, x, 2).numpy()
        assert got.shape == want.shape and np.isfinite(got).all()
        err = float(np.max(np.abs(got.astype(np.float64) - want) / np.abs(want)))
        print(f"T1 {kind}: max rel err {err:.3g}, bit-equal {np.array_equal(_bits(got), _bits(want))}")
        if kind in T1_EXACT:
            assert np.array_equal(_bits(got), _bits(want)), kind
        else:
            assert err <= T1_RTOL[kind], kind
    assert probes.PROBE_PLAIN_CALLS["op_chain"] >= plain + len(T1_JAX_ORDER)


def test_fma_chain_matches_jax_without_contraction(jax_no_fma):
    """The port's ``fma`` class (a multiply and an add, each rounded, as
    every multiply-add of the port's kernels under ``--fmad=false``) against
    the JAX fma chain run where XLA cannot contract it: bit-equal, and not
    equal to the fused ``ffma`` class."""
    want = jax_no_fma["t1:fma"]
    x = _t1_block()
    assert np.array_equal(_bits(probes.op_chain("fma", x, 2).numpy()), _bits(want))
    assert not np.array_equal(_bits(probes.op_chain("ffma", x, 2).numpy()), _bits(want))


# ---------------------------------------------------------------------------
# T2: the paged sweep
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_paged():
    return tpaged.build_table(*SMALL_MESH, device="cpu")


JAX_VARIANTS = ("fetch", "all", "dense", "real")  # the JAX probe's gather variant no longer runs


def _jax_no_fma_outputs(out_path):
    """Run the JAX T2 probe (interpret mode, the small shapes) on both
    packets, and the JAX T1 probe (2 iterations), and save the T2 keys and
    the T1 chains; run in a process whose XLA may not contract multiply-adds
    (``--xla_cpu_max_isa=AVX`` has no FMA), as neither the port's plain
    versions nor the JAX package's op-by-op semantics do."""
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, PERF)
    pl.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    keys = {f"t1:{k}": v for k, v in _jax_op_chains(importlib.import_module("microbench")).items()}
    jp = importlib.import_module("paged_probe")
    jp.ROWS, jp.N_BLOCKS, jp.REPS = SMALL_ROWS, SMALL_BLOCKS, SMALL_REPS
    paged, tiles, gather = jp.build_table(*SMALL_MESH)
    for kind in tpaged.KINDS:
        o, d = jp.packets(kind)
        for variant in JAX_VARIANTS:
            fn = jp.make_fn(variant, paged, gather if variant == "real" else tiles)
            keys[f"{kind}:{variant}"] = np.asarray(fn(o, d)).reshape(-1)
    np.savez(out_path, **keys)


@pytest.fixture(scope="module")
def jax_no_fma(tmp_path_factory):
    out = tmp_path_factory.mktemp("no_fma") / "outputs.npz"
    path = os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX", PYTHONPATH=path)
    r = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return dict(np.load(out))


@pytest.mark.parametrize("kind", tpaged.KINDS)
def test_paged_probe_matches_jax(jax_no_fma, monkeypatch, small_paged, kind):
    """Every variant against the JAX probe on its own rays (shrunk to one
    block of 8x128) and table; ``gather`` (the port's per-ray walk, whose
    JAX variant no longer runs) against the JAX ``all`` keys.  With XLA's
    multiply-add contraction on, as in this test process, the JAX keys and
    distances move in the last bits on a few rays (measured: 1 of 1,024
    coherent ``all`` keys, 2.6% of incoherent and 24% of coherent ``real``
    distances).  Measured without it: every variant bit-equal; 67 of 1,024
    incoherent rays hit, 1,023 coherent."""
    monkeypatch.setattr(tpaged, "ROWS", SMALL_ROWS)
    monkeypatch.setattr(tpaged, "N_BLOCKS", SMALL_BLOCKS)
    _tpg, ttiles, tboxes, treal = small_paged
    rays = tpaged.packets(kind, device="cpu")
    for variant in probes.PAGED_VARIANTS:
        got = probes.paged_probe(variant, ttiles, treal if variant == "real" else tboxes, rays, SMALL_REPS)
        want = jax_no_fma[f"{kind}:{'all' if variant == 'gather' else variant}"]
        assert got.dtype == torch.int32
        same = got.numpy() == want
        print(f"T2 {kind} {variant}: {same.mean():.4%} of rays bit-equal, "
              f"{int((want != want.max()).sum())} improved")
        assert same.all(), variant
    hits = jax_no_fma[f"{kind}:real"] != np.float32(1e20).view(np.int32)
    assert hits.sum() > (50 if kind == "incoherent" else 1000)


def test_paged_probe_chains_traversals(small_paged):
    """The traversals of one call are chained: a ray whose key came back as
    PROBE_MAGIC starts its next traversal 1e-6 further in x, and ``fetch``
    then reads the tile's next element."""
    _tpg, ttiles, tboxes, _ = small_paged
    rays = tpaged.packets("coherent", device="cpu")[:, :64].contiguous()
    one = probes.paged_probe_plain("fetch", ttiles, tboxes, rays, 1)
    key0 = (torch.tensor(3e38, dtype=torch.float32).view(torch.int32) | 127).item()
    assert torch.equal(one, key0 + ttiles[:, 0, 0].to(torch.int32).sum().to(torch.int32).expand(64))
    assert torch.equal(probes.paged_probe_plain("all", ttiles, tboxes, rays, 3),
                       probes.paged_probe_plain("all", ttiles, tboxes, rays, 1))


# ---------------------------------------------------------------------------
# T3 and T4: tile fetches
# ---------------------------------------------------------------------------

T3_SEED, T4_SEED = 5, 7


@pytest.mark.parametrize("layout", probes.TILE_LAYOUTS)
def test_tile_fetch_matches_jax(jax_probe, monkeypatch, layout):
    jf = jax_probe("fetch_probe")
    monkeypatch.setattr(jf, "N_BLOCKS", 2)
    np.random.seed(T3_SEED)
    run = jf.make_fn(layout)  # draws its table from the global generator
    x = np.random.RandomState(1).uniform(-1, 1, (jf.ROWS * 2, jf.LANE)).astype(np.float32)
    want = np.asarray(run(x))
    table = tfetch.make_table(layout, T3_SEED, device="cpu")
    got = probes.tile_fetch(layout, table, torch.from_numpy(x), tfetch.P)
    assert np.array_equal(_bits(got.numpy()), _bits(want))


T3_RING_PAGES = {"1": lambda k: 1, "K-1": lambda k: k - 1, "K": lambda k: k, "K+1": lambda k: k + 1}


@pytest.mark.parametrize("at", T3_RING_PAGES)
@pytest.mark.parametrize("layout", ["a", "d"])
def test_tile_fetch_matches_jax_around_the_ring(jax_probe, monkeypatch, layout, at):
    """The plain version against the JAX probe at page counts around the
    kernel's ring of K tiles (the probe's P set to p): bit-equal."""
    p = T3_RING_PAGES[at](probes.TILE_STAGES)
    jf = jax_probe("fetch_probe")
    monkeypatch.setattr(jf, "N_BLOCKS", 2)
    monkeypatch.setattr(jf, "P", p)
    monkeypatch.setattr(tfetch, "SHAPES", {k: (v[0] * p // tfetch.P, *v[1:]) for k, v in tfetch.SHAPES.items()})
    np.random.seed(T3_SEED)
    run = jf.make_fn(layout)
    x = np.random.RandomState(p).uniform(-1, 1, (jf.ROWS * 2, jf.LANE)).astype(np.float32)
    want = np.asarray(run(x))
    table = tfetch.make_table(layout, T3_SEED, device="cpu")
    assert table.numel() == p * probes.TILE_ELEMS[layout]
    got = probes.tile_fetch(layout, table, torch.from_numpy(x), p)
    assert np.array_equal(_bits(got.numpy()), _bits(want))


def test_tile_fetch_ring_matches_probes_cu():
    """The ring's depth and the split's clock slots that ops/probes.py uses
    are csrc/probes.cu's constants."""
    src = (Path(probes.__file__).resolve().parent.parent / "csrc" / "probes.cu").read_text()
    assert f"constexpr int TILE_STAGES = {probes.TILE_STAGES};" in src
    assert f"constexpr int T3_SLOTS = {probes.T3_SLOTS};" in src
    loop = src[src.index("__global__ void __launch_bounds__(PROBE_BLOCK) tile_fetch_kernel"):]
    for slot, step in enumerate(probes.T3_STEPS + ("loop",)):
        assert f"T3_ADD({slot}, " in loop, step


@pytest.fixture
def jax_fetch2(jax_probe):
    """fetch_probe2.py draws its table and runs its benchmark when imported;
    import it under the interpret patch from a seeded global generator."""
    np.random.seed(T4_SEED)
    return jax_probe("fetch_probe2")


def test_fetch_attrib_matches_jax(jax_fetch2, monkeypatch):
    """Measured (x86-64): every variant bit-equal, the two row sums too."""
    jf = jax_fetch2
    table = tfetch2.make_table(T4_SEED, device="cpu")
    assert np.array_equal(_bits(np.asarray(jf.table)), _bits(table.numpy()))
    monkeypatch.setattr(jf, "N_BLOCKS", 2)
    x = np.random.RandomState(2).uniform(-1, 1, (jf.ROWS * 2, jf.LANE)).astype(np.float32)
    for variant in probes.FETCH_VARIANTS:
        want = np.asarray(jf.make_fn(variant)(x))
        got = probes.fetch_attrib(variant, table, torch.from_numpy(x), tfetch2.P).numpy()
        err = float(np.max(np.abs(got.astype(np.float64) - want) / np.abs(want)))
        print(f"T4 {variant}: max rel err {err:.3g}, bit-equal {np.array_equal(_bits(got), _bits(want))}")
        if variant in ("dyn_vec", "static_vec"):
            assert err <= 1e-6, variant
        else:
            assert np.array_equal(_bits(got), _bits(want)), variant


# ---------------------------------------------------------------------------
# the wrappers and the tools on the CPU
# ---------------------------------------------------------------------------


def test_probe_tools_import_without_jax():
    code = ("import sys\n"
            "import path_trace_golang_tpu_torch.tools.perf.microbench, path_trace_golang_tpu_torch.tools.perf."
            "paged_probe, path_trace_golang_tpu_torch.tools.perf.fetch_probe, "
            "path_trace_golang_tpu_torch.tools.perf.fetch_probe2\n"
            "assert 'jax' not in sys.modules and not any(m.startswith('path_trace_golang_tpu.') or "
            "m == 'path_trace_golang_tpu' for m in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


def test_probe_tools_run_on_cpu(monkeypatch, capsys):
    """Each tool's entry point runs the plain versions with --device cpu."""
    monkeypatch.setattr(tpaged, "ROWS", 1)
    monkeypatch.setattr(tpaged, "N_BLOCKS", 1)
    assert tmicro.main(["--device", "cpu", "--iters", "1"]) == 0
    assert tpaged.main(["16", "16", "--device", "cpu"]) == 0
    assert tfetch.main(["--device", "cpu"]) == 0
    assert tfetch2.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for line in ("fma-slot equivalents", "cursor+carry overhead", "layout d:", "dyn_scalar"):
        assert line in out
    assert "host clock" in out


def test_probe_wrappers_dispatch_and_check():
    x = torch.zeros((probes.ROWS, probes.LANE))
    before = dict(probes.PROBE_PLAIN_CALLS)
    probes.tile_fetch("a", torch.zeros(4096 * 2), x, 2)
    probes.fetch_attrib("dyn_row", torch.zeros((64, 128)), x, 2)
    assert probes.PROBE_PLAIN_CALLS["tile_fetch"] == before["tile_fetch"] + 1
    assert probes.PROBE_PLAIN_CALLS["fetch_attrib"] == before["fetch_attrib"] + 1
    with pytest.raises(NotImplementedError):
        probes.op_chain("fma", torch.zeros(4, device="meta"), 1)
    with pytest.raises(ValueError):
        probes.op_chain_cuda("fma", torch.zeros(4), 1)  # a kernel takes CUDA tensors only
    with pytest.raises(ValueError):
        probes.tile_fetch("a", torch.zeros(4096), x, 2)  # fewer tiles than asked for
    with pytest.raises(ValueError):
        probes.op_chain("tan", torch.zeros(4), 1)


# ---------------------------------------------------------------------------
# on a card: kernel = plain version
# ---------------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("ilp", [1, 4])
def test_op_chain_kernel_matches_plain_on_card(ilp):
    _need_card()
    x = torch.from_numpy(np.random.RandomState(4).uniform(0.1, 2.0, 8192).astype(np.float32)).cuda()
    for kind in probes.OP_KINDS:
        k = probes.op_chain(kind, x, 4, ilp)
        p = probes.op_chain_plain(kind, x, 4)
        if kind in ("hash", "select", "sqrt", "divide", "fma"):
            assert torch.equal(k.view(torch.int32), p.view(torch.int32)), kind
        else:
            assert torch.allclose(k, p, rtol=1e-5, atol=0), kind


@pytest.mark.cuda
@pytest.mark.parametrize("kind", tpaged.KINDS)
def test_paged_probe_kernel_matches_plain_on_card(kind):
    _need_card()
    _pg, tiles, boxes, real = tpaged.build_table(device="cuda")
    rays = tpaged.packets(kind, device="cuda")[:, :8192].contiguous()
    for variant in probes.PAGED_VARIANTS:
        bx = real if variant == "real" else boxes
        assert torch.equal(probes.paged_probe(variant, tiles, bx, rays, 2),
                           probes.paged_probe_plain(variant, tiles, bx, rays, 2)), variant


@pytest.mark.cuda
def test_fetch_kernels_match_plain_on_card():
    _need_card()
    x = torch.from_numpy(np.random.RandomState(1).uniform(-1, 1, (64, 128)).astype(np.float32)).cuda()
    for layout in probes.TILE_LAYOUTS:
        table = tfetch.make_table(layout, device="cuda")
        assert torch.equal(probes.tile_fetch(layout, table, x, 80), probes.tile_fetch_plain(layout, table, x, 80))
    table = tfetch2.make_table(device="cuda")
    for variant in probes.FETCH_VARIANTS:
        assert torch.equal(probes.fetch_attrib(variant, table, x, 80),
                           probes.fetch_attrib_plain(variant, table, x, 80)), variant



@pytest.mark.cuda
def test_tile_fetch_kernel_around_the_ring_on_card():
    """T3's ring bit for bit at p = 0, 1, K - 1, K, K + 1 and 80, every
    layout, on the TPU grid and the full-card grid."""
    _need_card()
    k = probes.TILE_STAGES
    for blocks in (16, ttiming.full_card_blocks(torch.device("cuda"))):
        x = torch.from_numpy(np.random.RandomState(blocks).uniform(-1, 1, (32 * blocks, 128)).astype(np.float32)).cuda()
        for layout in probes.TILE_LAYOUTS:
            table = tfetch.make_table(layout, device="cuda")
            for p in sorted({0, 1, k - 1, k, k + 1, tfetch.P}):
                got, want = probes.tile_fetch(layout, table, x, p), probes.tile_fetch_plain(layout, table, x, p)
                assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (layout, blocks, p)


@pytest.mark.cuda
def test_tile_fetch_misaligned_table_raises_on_card():
    """A table view offset by one float is not 16-byte aligned: the launch
    is refused and the wrapper raises; offset by four floats it runs."""
    _need_card()
    x = torch.zeros((32 * 16, 128), device="cuda")
    buf = torch.from_numpy(np.random.RandomState(3).rand(tfetch.P * 4096 + 4).astype(np.float32)).cuda()
    with pytest.raises(RuntimeError, match="tile_fetch"):
        probes.tile_fetch("a", buf[1:1 + tfetch.P * 4096], x, tfetch.P)
        torch.cuda.synchronize()
    view = buf[4:]
    assert torch.equal(probes.tile_fetch("a", view, x, tfetch.P), probes.tile_fetch_plain("a", view, x, tfetch.P))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["dyn_vec", "static_vec"])
def test_fetch_colsum_kernel_matches_plain_on_card(variant):
    """T4's column-slice kernel bit for bit at the TPU probe's 16 blocks, at
    a full-card grid (several output row groups, each re-reading its slab)
    and, for dyn_vec, at page counts below and above one staged slab."""
    _need_card()
    table = tfetch2.make_table(device="cuda")
    big = torch.cat([table, table.flip(0)])  # 160 tiles
    cases = [(table, 80, 16), (table, 80, ttiming.full_card_blocks(torch.device("cuda")))]
    if variant == "dyn_vec":
        cases += [(table, 0, 3), (table, 7, 16), (big, 160, 5), (big, 123, 200)]
    for tab, pages, blocks in cases:
        x = torch.from_numpy(np.random.RandomState(blocks).uniform(-1, 1, (32 * blocks, 128)).astype(np.float32)).cuda()
        k = probes.fetch_attrib(variant, tab, x, pages)
        p = probes.fetch_attrib_plain(variant, tab, x, pages)
        assert torch.equal(k.view(torch.int32), p.view(torch.int32)), (pages, blocks)

if __name__ == "__main__":
    _jax_no_fma_outputs(sys.argv[1])
