"""The page-want statistics recast for the warp sweep, against the JAX package.

* The port's per-ray page masks (``page_stats.page_masks``, the port's own
  page-entry test) equal the bits of JAX ``ops/bvh.py::_page_prepass`` on
  the four ray populations of the JAX ``tools/perf/union_stats.py`` at 80
  pages, exactly; the shadow rays also with their far limit.
* The k columns (pages a ray enters: mean, p95, max) are the JAX tool's
  arithmetic on those bits.
* The warp model on hand-made masks: visits, nw, lane slots (ceil(128 / s)
  rounds of the warp's lanes, s = width // nw) and pairs, a short last
  warp included.
* build_probe's aligned-median partition is ``ops/bvh.build_paged_bvh``'s
  pages and entry boxes.
* The three tools run with ``--device cpu`` at their smallest arguments.
On the card the counting build's sweep counts equal the model's
(``chip_smoke.py`` phase 38).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_trace_golang_tpu.ops import bvh as JBVH
from path_trace_golang_tpu.ops.vec import V3 as JV3

from path_trace_golang_tpu_torch.ops import bvh as TBVH
from path_trace_golang_tpu_torch.tools.perf import build_probe, page_stats, union_stats, want_stats

ROWS = 64  # the JAX tool's rows of 128 rays


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The plain versions here run on tensors of a few hundred lanes, where more threads only contend with
    the other test workers; the worker's count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    """The bench mesh's pages, built by each package from the same UV sphere."""
    v0, e1, e2 = build_probe.mesh(80, 64)
    t = len(v0)
    args = (v0, e1, e2, np.zeros(t, np.int64), np.arange(t), np.zeros(t, bool), None)
    jpaged, _tiles, _bbox = JBVH.build_paged_bvh(*args)
    tpaged, _tiles, _bbox = TBVH.build_paged_bvh(*args)
    return jpaged, torch.from_numpy(TBVH.page_boxes_table(tpaged))


@pytest.fixture(scope="module")
def pops():
    return page_stats.populations(ROWS)


def _jax_bits(jpaged, o, d, t_max):
    """JAX's prepass mask words as bool[P, N], as union_stats.py makes them."""
    g = lambda a: jnp.asarray(a.reshape(ROWS, 128))  # noqa: E731
    ov, dv = JV3(g(o[:, 0]), g(o[:, 1]), g(o[:, 2])), JV3(g(d[:, 0]), g(d[:, 1]), g(d[:, 2]))
    inv = JV3(1.0 / dv.x, 1.0 / dv.y, 1.0 / dv.z)
    big = jnp.full(ov.x.shape, 3e38)
    words = JBVH._page_prepass(ov, dv, inv, jpaged, jnp.float32(1e-3), big,
                               t_max=None if t_max is None else g(t_max))
    ws = np.stack([np.asarray(w).astype(np.uint32).reshape(-1) for w in words])
    bits = np.stack([(ws[p // JBVH.MASK_BITS] >> (p % JBVH.MASK_BITS)) & 1 for p in range(jpaged.n_pages)])
    return bits.astype(bool), ws


# (population, with its far limit): the shadow rays both ways, the others have none
@pytest.mark.parametrize("which,far", [(0, False), (1, False), (2, False), (2, True), (3, False)])
def test_page_masks_equal_jax_prepass(mesh, pops, which, far):
    jpaged, boxes = mesh
    name, o, d, t_max = pops[which]
    if not far:
        t_max = None
    want, _ws = _jax_bits(jpaged, o, d, t_max)
    ov, dv, tm = page_stats.rays_on(o, d, t_max, torch.device("cpu"))
    got = page_stats.page_masks(ov, dv, boxes, tm).numpy()
    assert got.shape == want.shape == (80, ROWS * 128)
    assert np.array_equal(got, want), f"{name}: {int((got != want).sum())} bits differ"
    assert want.any()


@pytest.mark.parametrize("which", range(4))
def test_k_columns_are_the_jax_tools_arithmetic(mesh, pops, which):
    jpaged, boxes = mesh
    _name, o, d, _t_max = pops[which]
    _bits, ws = _jax_bits(jpaged, o, d, None)
    pop = sum(np.bitwise_count(ws[j]) for j in range(ws.shape[0]))  # union_stats.py's k/lane
    ov, dv, _tm = page_stats.rays_on(o, d, None, torch.device("cpu"))
    got = page_stats.k_stats(page_stats.page_masks(ov, dv, boxes).sum(0).numpy())
    assert got == {"mean": float(pop.mean()), "p95": float(np.percentile(pop, 95)), "max": int(pop.max())}


def test_populations_are_the_jax_tools():
    """The camera, bounce and shadow rays of the JAX build_probe.py's
    populations (union_stats.py's, with the shadow rays' far limit), bit for
    bit; the JAX tool's random rays come after them in the same stream."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("jax_build_probe", os.path.join(root, "tools", "perf",
                                                                                  "build_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jpops = mod.populations(np.random.RandomState(3), 8)
    tpops = page_stats.populations(8)
    for (jn, jo, jd, jt), (tn, to, td, tt) in zip(jpops, tpops):
        assert tn.startswith(jn)
        assert np.array_equal(jo.reshape(-1, 3), to) and np.array_equal(jd.reshape(-1, 3), td)
        assert (jt is None) == (tt is None) and (jt is None or np.array_equal(jt.reshape(-1), tt))


def test_warp_model_on_hand_masks():
    # 40 rays: a full warp and a warp of 8; 3 pages
    m = torch.zeros(3, 40, dtype=torch.bool)
    m[0, :3] = True  # warp 0: nw 3 -> s 10, 13 rounds
    m[1, 5] = True  # warp 0: nw 1 -> s 32, 4 rounds
    m[1, 32:40] = True  # warp 1 (8 lanes): nw 8 -> s 1, 128 rounds
    model = page_stats.warp_model(m, n_sub=2)
    assert model["sets"] == 2 and model["pages_visited"] == 3 and model["want_sum"] == 12
    assert model["lane_slots"] == 13 * 32 + 4 * 32 + 128 * 8
    assert model["pairs"] == 12 * 128 and model["box_tests"] == 40 * 3 * 2
    assert list(model["union"]) == [2, 1] and model["nw_hist"][1] == 1 and model["nw_hist"][3] == 1
    assert model["nw_hist"][8] == 1 and sum(model["nw_hist"]) == 3


@pytest.mark.parametrize("n_lat,n_lon", [(80, 64), (20, 16)])
def test_aligned_median_is_build_paged_bvh(n_lat, n_lon):
    v0, e1, e2 = build_probe.mesh(n_lat, n_lon)
    lo, hi, cent = TBVH.tri_bounds(v0, e1, e2)
    pages, boxes = build_probe.layout(TBVH.aligned_median_pages(cent), lo, hi, cent)
    ship_pages, ship_boxes = build_probe.shipped_pages(v0, e1, e2)
    dead = build_probe.degenerate(e1, e2)
    assert [[-1 if dead[i] else int(i) for i in m] for m in pages] == ship_pages
    assert np.array_equal(boxes, ship_boxes)


@pytest.mark.parametrize("tool,args", [
    (union_stats, ["--sizes", "12x8", "--rows", "2"]),
    (want_stats, ["--sizes", "12x8", "--rows", "2"]),
    (build_probe, ["12", "8", "--rows", "2"]),
])
def test_tools_run_on_cpu(capsys, tool, args):
    assert tool.main(args + ["--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["device"] == "cpu" and line["rows"]
    if tool is build_probe:
        assert line["aligned_median_is_shipped"] and [r["partition"] for r in line["rows"]] == [
            n for n, _ in build_probe.STRATEGIES]
    else:
        assert [r["population"] for r in line["rows"]] == [p[0] for p in page_stats.populations(1)]
