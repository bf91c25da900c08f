"""The perf probes T1-T4 as CUDA kernels, with their plain PyTorch versions.

Counterparts of the JAX package's TPU probes under ``tools/perf/``, each a
Pallas kernel there and a kernel of ``csrc/probes.cu`` here:

* :func:`op_chain` (T1, ``microbench.py::_bench``): a long dependent chain
  of one op class per element, ``iters`` iterations of ``OP_INNER[kind]``
  ops, so that its time is the op's throughput (or latency);
* :func:`paged_probe` (T2, ``paged_probe.py::make_fn``): per-ray winner
  keys over a paged triangle table, ``reps`` traversals chained through the
  key, in five variants that split the paged walk's time;
* :func:`tile_fetch` (T3, ``fetch_probe.py::make_fn``): the cost of
  fetching one page tile, by table layout;
* :func:`fetch_attrib` (T4, ``fetch_probe2.py::make_fn``): that cost
  taken apart, in five variants.

Each wrapper launches its kernel on a CUDA tensor (or raises) and runs its
plain version on a CPU tensor; nothing falls back.  ``PROBE_LAUNCHES``
counts kernel launches and ``PROBE_PLAIN_CALLS`` calls of the plain
versions, keyed by probe (``op_chain``, ``paged_probe``, ``tile_fetch``,
``fetch_attrib``).  The kernels are built with the renderer's into
``build/torch_kernels/`` (``cuda_trace.build(source="probes")``), with the
same ``--fmad=false``.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace

import numpy as np
import torch

from . import bvh as bvh_mod
from . import cuda_trace
from ._launch import check, on_device, raise_on, stream
from .rng import MASK32, hash_u
from .vec import V3

__all__ = [
    "OP_KINDS", "OP_INNER", "PAGED_VARIANTS", "TILE_LAYOUTS", "TILE_ELEMS", "TILE_STAGES", "FETCH_VARIANTS", "ROWS",
    "LANE",
    "PROBE_MAGIC", "PROBE_LAUNCHES", "PROBE_PLAIN_CALLS",
    "op_chain", "op_chain_plain", "op_chain_cuda",
    "paged_probe", "paged_probe_plain", "paged_probe_cuda", "paged_probe_count_ops",
    "tile_fetch", "tile_fetch_plain", "tile_fetch_cuda", "tile_fetch_split",
    "fetch_attrib", "fetch_attrib_plain", "fetch_attrib_cuda",
]

# T1: op classes (csrc/probes.cu OpKind, in this order) and ops per iteration
OP_KINDS = ("fma", "ffma", "sqrt", "rsqrt", "divide", "exp", "sin", "hash", "select")
OP_INNER = {k: (16 if k == "hash" else 64) for k in OP_KINDS}
# T2 variants (csrc/probes.cu, in this order)
PAGED_VARIANTS = ("fetch", "all", "dense", "gather", "real")
PROBE_MAGIC = 0x12345678  # a key that chains one traversal to the next (never met in practice)
# T3 layouts: a (P,128,32), b (P,32,128), c (P*32,128), d (P*8,128); floats in one page tile
TILE_LAYOUTS = ("a", "b", "c", "d")
TILE_ELEMS = {"a": 4096, "b": 4096, "c": 4096, "d": 1024}
TILE_STAGES = 3  # T3's ring: whole tiles in flight a block (csrc/probes.cu's TILE_STAGES)
T3_STEPS = ("wait", "read", "fence", "issue")  # T3's split: thread 0's loop by step (csrc/probes.cu, g_t3_clocks)
T3_SLOTS = len(T3_STEPS) + 1  # the steps, then the whole loop
# T4 variants (csrc/probes.cu, in this order)
FETCH_VARIANTS = ("loop_only", "dyn_row", "dyn_vec", "static_vec", "dyn_scalar")
ROWS, LANE = 32, 128  # one block of T3/T4: ROWS x LANE outputs, as a TPU block
STATIC_PAGES = 80  # static_vec unrolls its page loop over exactly this many tiles

PROBE_LAUNCHES = {"op_chain": 0, "paged_probe": 0, "tile_fetch": 0, "fetch_attrib": 0}
PROBE_PLAIN_CALLS = dict.fromkeys(PROBE_LAUNCHES, 0)

_F32 = torch.float32


_BOUND: set[bool] = set()  # the builds whose entry points have their ctypes signatures


def _lib(counting: bool = False):
    lib = cuda_trace._lib(counting, "probes")
    if counting not in _BOUND:
        _bind(lib)
        _BOUND.add(counting)
    return lib


def _c(v: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant as a 0-d tensor (true division needs a tensor numerator)."""
    return torch.tensor(v, dtype=_F32, device=like.device)


# ---------------------------------------------------------------------------
# T1: op throughput
# ---------------------------------------------------------------------------


def _hash_draw(x: torch.Tensor) -> torch.Tensor:
    """microbench.py's hash class: 16 rounds of the renderer's RNG hash on
    the float's bits, then the draw's int32 -> float conversion."""
    s = x.contiguous().view(torch.int32).to(torch.int64) & MASK32
    for _ in range(OP_INNER["hash"]):
        s = hash_u(s)
    i = torch.where(s >= 2**31, s - 2**32, s)
    return i.to(_F32) * (2.0**-32) + 0.5


def _op_step(kind: str, x: torch.Tensor) -> torch.Tensor:
    """One op of class ``kind`` (the hash class goes through _hash_draw)."""
    if kind == "fma":  # two roundings, as the kernels' multiply-adds under --fmad=false
        return x * 1.000001 + 1e-7
    if kind == "ffma":  # one rounding: the product is exact in float64, the sum rounds to float64 then float32
        return (x.double() * float(np.float32(1.000001)) + float(np.float32(1e-7))).float()
    if kind == "sqrt":
        return torch.sqrt(x + 0.31)
    if kind == "rsqrt":
        return torch.rsqrt(x + 0.77)
    if kind == "divide":
        return _c(1.37, x) / (x + 1.11)
    if kind == "exp":
        return torch.exp(-x) + 0.1
    if kind == "sin":
        return torch.sin(x) + 0.7
    if kind == "select":
        return torch.where(x > 0.5, x * 0.731, x + 0.31)
    raise ValueError(f"unknown op class {kind!r}")


def op_chain(kind: str, x: torch.Tensor, iters: int, ilp: int = 1) -> torch.Tensor:
    """Run ``iters`` iterations of ``OP_INNER[kind]`` dependent ops of one
    class on every element of ``x`` (f32); returns the chain's end values.
    ``ilp``: independent chains a CUDA thread interleaves (1 or 4; the
    plain version ignores it)."""
    return on_device("op_chain", x, op_chain_plain, op_chain_cuda, kind, x, iters, ilp)


def op_chain_plain(kind: str, x: torch.Tensor, iters: int, ilp: int = 1) -> torch.Tensor:
    """The plain version: the same chain, one tensor op after another."""
    PROBE_PLAIN_CALLS["op_chain"] += 1
    if kind not in OP_KINDS:
        raise ValueError(f"unknown op class {kind!r}")
    x = x.to(_F32)
    for _ in range(iters):
        if kind == "hash":
            x = _hash_draw(x)
        else:
            for _ in range(OP_INNER[kind]):
                x = _op_step(kind, x)
    return x


def op_chain_cuda(kind: str, x: torch.Tensor, iters: int, ilp: int = 1) -> torch.Tensor:
    """Launch T1's kernel (csrc/probes.cu, op_chain_kernel) on the current stream."""
    check("op_chain", (x, _F32))
    if kind not in OP_KINDS:
        raise ValueError(f"unknown op class {kind!r}")
    n = x.numel()
    if ilp not in (1, 4) or n % ilp:
        raise ValueError(f"op_chain: ilp must be 1 or 4 and divide the {n} elements")
    out = torch.empty_like(x)
    lib = _lib()
    err = lib.pt_op_chain(OP_KINDS.index(kind), x.data_ptr(), out.data_ptr(), n, int(iters), OP_INNER[kind], ilp,
                          stream(x))
    raise_on(err, lib, "op_chain")
    PROBE_LAUNCHES["op_chain"] += 1
    return out


# ---------------------------------------------------------------------------
# T2: the paged sweep
# ---------------------------------------------------------------------------


def paged_probe(variant: str, tiles, boxes, rays, reps: int, t_min: float = 1e-3, best_t=None):
    """Per-ray result of ``reps`` chained traversals of a paged table.

    ``tiles`` f32[P,128,32] and ``boxes`` f32[P,k,6] as ``ops/bvh.py``
    builds them; ``rays`` f32[6,N] (origin, direction).  Each traversal
    starts from the origin plus 1e-6 in x if the previous one returned
    ``PROBE_MAGIC`` (the data dependency that keeps a compiler from
    hoisting the repeated traversal), else 0.  Returns int32[N]: the winner
    key for ``fetch`` (the start key plus the sum of one truncated tile
    element per page), ``all``, ``dense`` and ``gather``; the bits of the
    merged closest-hit distance for ``real``.  ``best_t``: the distance a
    ray comes in with (default 3e38, and 1e20 for ``real``)."""
    return on_device("paged_probe", rays, paged_probe_plain, paged_probe_cuda, variant, tiles, boxes, rays, reps,
                     t_min, best_t)


def _default_best_t(variant: str, best_t) -> float:
    """The start distance, rounded to float32 as the kernel takes it."""
    if best_t is None:
        best_t = 1e20 if variant == "real" else bvh_mod._BIG_T
    return float(np.float32(best_t))


def _sweep(tiles, o, d, t_min, best_key, pages, want):
    """The walk's key loop over ``pages`` in ascending order; ``want``
    bool[P, N] (None: every lane sweeps every listed page)."""
    big = torch.tensor(bvh_mod._BIG_KEY, dtype=torch.int32, device=best_key.device)
    for p in pages:
        keys = bvh_mod._mt_key(tiles[p], o, d, t_min, bvh_mod._key_upper_t(best_key), None, None)
        page_key = keys.min(dim=0).values
        if want is not None:
            page_key = torch.where(want[p], page_key, big)
        best_key = torch.minimum(best_key, page_key)
    return best_key


def paged_probe_plain(variant: str, tiles, boxes, rays, reps: int, t_min: float = 1e-3, best_t=None):
    """The plain version: ``ops/bvh.py``'s ``_page_wants`` and ``_mt_key``
    swept over pages as each variant sweeps them (``dense``: a page is
    swept by all 32 rays of a warp, the rays i with the same i // 32, once
    any of them enters it; ``real``: ``traverse_triangles_paged`` and the
    merge of its winner)."""
    PROBE_PLAIN_CALLS["paged_probe"] += 1
    if variant not in PAGED_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    best_t = _default_best_t(variant, best_t)
    t_min = float(np.float32(t_min))
    n = rays.shape[1]
    best_lanes = torch.full((n,), best_t, dtype=_F32, device=rays.device)
    d = tuple(rays[3 + c] for c in range(3))
    inv = tuple(1.0 / c for c in d)
    n_pages = tiles.shape[0]
    key = torch.zeros(n, dtype=torch.int32, device=rays.device)
    for _ in range(reps):
        eps = torch.where(key == PROBE_MAGIC, 1e-6, 0.0).to(_F32)
        o = (rays[0] + eps, rays[1], rays[2])
        key0 = (o[0] * 0.0 + best_t).view(torch.int32) | bvh_mod._KEY_SLOT_MASK
        if variant == "fetch":
            sel = (key == PROBE_MAGIC).to(torch.int64)
            acc = tiles[:, 0, :2].to(torch.int32).sum(dim=0, dtype=torch.int32)[sel]
            key = key0 + acc
        elif variant == "all":
            key = _sweep(tiles, o, d, t_min, key0, range(n_pages), None)
        elif variant in ("dense", "gather"):
            want = bvh_mod._page_wants(o, inv, boxes, t_min, best_lanes, None, None)
            if variant == "dense":
                pad = -n % 32
                w = torch.nn.functional.pad(want, (0, pad)).reshape(n_pages, -1, 32).any(dim=2)
                want = w.repeat_interleave(32, dim=1)[:, :n]
            pages = torch.nonzero(want.any(dim=1)).reshape(-1).tolist()
            key = _sweep(tiles, o, d, t_min, key0, pages, want)
        else:
            pack = SimpleNamespace(page_tiles=tiles, page_boxes=boxes)
            w = bvh_mod.traverse_triangles_paged(V3(*o), V3(*d), pack, t_min, best_lanes)
            key = torch.where(w.hit & (w.t < best_lanes), w.t, best_lanes).view(torch.int32)
    return key


def paged_probe_cuda(variant: str, tiles, boxes, rays, reps: int, t_min: float = 1e-3, best_t=None):
    """Launch T2's kernel (csrc/probes.cu, paged_probe_kernel) on the current stream."""
    out, _ = _launch_paged(False, variant, tiles, boxes, rays, reps, t_min, best_t)
    PROBE_LAUNCHES["paged_probe"] += 1
    return out


def paged_probe_count_ops(variant: str, tiles, boxes, rays, reps: int, t_min: float = 1e-3, best_t=None) -> int:
    """The f32 operations that T2's kernel does on these inputs, tallied by
    the counting build (the C_PAGE_* table of csrc/paged_walk.cuh).  Not a
    launch of the probe: ``PROBE_LAUNCHES`` does not change."""
    return _launch_paged(True, variant, tiles, boxes, rays, reps, t_min, best_t)[1]


def _launch_paged(counting, variant, tiles, boxes, rays, reps, t_min, best_t):
    check("paged_probe", (rays, _F32), (tiles, _F32), (boxes, _F32))
    if variant not in PAGED_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if tiles.dim() != 3 or tuple(tiles.shape[1:]) != (bvh_mod.PAGE_TRIS, bvh_mod.N_PAGE_ATTRS):
        raise ValueError(f"paged_probe: tiles must be f32[P, 128, 32], got {tuple(tiles.shape)}")
    if boxes.dim() != 3 or boxes.shape[0] != tiles.shape[0] or boxes.shape[2] != 6:
        raise ValueError(f"paged_probe: boxes must be f32[P, k, 6], got {tuple(boxes.shape)}")
    if rays.dim() != 2 or rays.shape[0] != 6:
        raise ValueError(f"paged_probe: rays must be f32[6, N], got {tuple(rays.shape)}")
    n = rays.shape[1]
    out = torch.empty(n, dtype=torch.int32, device=rays.device)
    ops = torch.zeros(1, dtype=torch.int64, device=rays.device)
    lib = _lib(counting)
    err = lib.pt_paged_probe(
        PAGED_VARIANTS.index(variant), tiles.data_ptr(), boxes.data_ptr(), tiles.shape[0], boxes.shape[1],
        rays.data_ptr(), n, int(reps), float(t_min), _default_best_t(variant, best_t), out.data_ptr(),
        ops.data_ptr(), stream(rays),
    )
    raise_on(err, lib, "paged_probe")
    return out, (int(ops) if counting else None)


# ---------------------------------------------------------------------------
# T3: one page tile's fetch, by layout
# ---------------------------------------------------------------------------


def _blocks(what: str, x: torch.Tensor) -> int:
    if x.dim() != 2 or x.shape[1] != LANE or x.shape[0] % ROWS:
        raise ValueError(f"{what}: x must be f32[{ROWS}*blocks, {LANE}], got {tuple(x.shape)}")
    return x.shape[0] // ROWS


def _pages(what: str, table: torch.Tensor, tile_elems: int, p: int) -> int:
    if p < 0 or table.numel() < p * tile_elems:
        raise ValueError(f"{what}: the table holds {table.numel() // tile_elems} tiles, {p} asked for")
    return p


def tile_fetch(layout: str, table, x, p: int):
    """``x + sum_q (tile_q's first element + its last)`` over the first
    ``p`` page tiles of ``table``, summed in page order; a tile is
    ``TILE_ELEMS[layout]`` contiguous floats (layouts a, b and c: the same
    16 KB; d: 4 KB)."""
    return on_device("tile_fetch", x, tile_fetch_plain, tile_fetch_cuda, layout, table, x, p)


def tile_fetch_plain(layout: str, table, x, p: int):
    """The plain version: tensor indexing and a sum in page order."""
    PROBE_PLAIN_CALLS["tile_fetch"] += 1
    e = TILE_ELEMS[layout]
    flat = table.reshape(-1)
    first = torch.arange(_pages("tile_fetch", table, e, p), device=table.device) * e
    v = flat[first] + flat[first + (e - 1)]
    acc = torch.zeros((), dtype=_F32, device=table.device)
    for q in range(p):
        acc = acc + v[q]
    return x + acc


def tile_fetch_cuda(layout: str, table, x, p: int):
    """Launch T3's kernel (csrc/probes.cu, tile_fetch_kernel) on the current stream."""
    out = _launch_tile_fetch(False, layout, table, x, p)
    PROBE_LAUNCHES["tile_fetch"] += 1
    return out


def tile_fetch_split(layout: str, table, x, p: int) -> dict:
    """T3's split: the counting build of its kernel on the same inputs, one
    launch, thread 0's clock cycles in the ring's loop summed over the
    blocks: by step (``wait`` for the tile, ``read`` its two elements and
    the add, the proxy ``fence``, ``issue`` the tile three pages on) and
    ``loop`` (the whole loop, the first tiles' issue included); and
    ``blocks``.  Not a launch of the probe: ``PROBE_LAUNCHES`` does not
    change."""
    lib = _lib(True)
    lib.pt_t3_clocks.argtypes, lib.pt_t3_clocks.restype = [ctypes.c_void_p], ctypes.c_int
    clocks = (ctypes.c_ulonglong * (T3_SLOTS + 1))()
    raise_on(lib.pt_t3_clocks(clocks), lib, "tile_fetch_split")  # reset what earlier launches left
    _launch_tile_fetch(True, layout, table, x, p)
    torch.cuda.synchronize(x.device)
    raise_on(lib.pt_t3_clocks(clocks), lib, "tile_fetch_split")
    c = [int(v) for v in clocks]
    split = dict(zip(T3_STEPS + ("loop",), c[:T3_SLOTS]))
    split["blocks"] = c[T3_SLOTS]
    return split


def _launch_tile_fetch(counting, layout, table, x, p):
    check("tile_fetch", (x, _F32), (table, _F32))
    blocks = _blocks("tile_fetch", x)
    _pages("tile_fetch", table, TILE_ELEMS[layout], p)
    out = torch.empty_like(x)
    lib = _lib(counting)
    err = lib.pt_tile_fetch(TILE_LAYOUTS.index(layout), table.data_ptr(), x.data_ptr(), out.data_ptr(), int(p),
                            blocks, stream(x))
    raise_on(err, lib, "tile_fetch")
    return out


# ---------------------------------------------------------------------------
# T4: the fetch's cost taken apart
# ---------------------------------------------------------------------------


def fetch_attrib(variant: str, table, x, p: int):
    """T4 on ``table`` f32[R,128], read as tiles of 32 rows, over its first
    ``p`` tiles: ``loop_only`` x + sum of q; ``dyn_row`` x + sum of each
    tile's first row; ``dyn_vec`` and ``static_vec`` x + the column sums of
    the elementwise sum of the tiles; ``dyn_scalar`` x + sum of each tile's
    first element.  Sums over tiles run in page order; the column sum runs
    over rows 0..31 in order."""
    return on_device("fetch_attrib", x, fetch_attrib_plain, fetch_attrib_cuda, variant, table, x, p)


def fetch_attrib_plain(variant: str, table, x, p: int):
    """The plain version: tensor indexing and sums in the kernel's order."""
    PROBE_PLAIN_CALLS["fetch_attrib"] += 1
    if variant not in FETCH_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    _pages("fetch_attrib", table, ROWS * LANE, p)
    tiles = table.reshape(-1, ROWS, LANE)
    if variant in ("loop_only", "dyn_scalar"):
        acc = torch.zeros((), dtype=_F32, device=table.device)
        for q in range(p):
            acc = acc + (float(q) if variant == "loop_only" else tiles[q, 0, 0])
        return x + acc
    acc = torch.zeros((ROWS, LANE) if variant != "dyn_row" else (LANE,), dtype=_F32, device=table.device)
    for q in range(p):
        acc = acc + (tiles[q, 0] if variant == "dyn_row" else tiles[q])
    if variant != "dyn_row":
        col = torch.zeros(LANE, dtype=_F32, device=table.device)
        for r in range(ROWS):
            col = col + acc[r]
        acc = col
    return x + acc


def fetch_attrib_cuda(variant: str, table, x, p: int):
    """Launch T4's kernel (csrc/probes.cu, fetch_attrib_kernel) on the current stream."""
    check("fetch_attrib", (x, _F32), (table, _F32))
    if variant not in FETCH_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if table.dim() != 2 or table.shape[1] != LANE:
        raise ValueError(f"fetch_attrib: table must be f32[R, {LANE}], got {tuple(table.shape)}")
    if variant == "static_vec" and p != STATIC_PAGES:
        raise ValueError(f"fetch_attrib: static_vec is unrolled over {STATIC_PAGES} tiles, {p} asked for")
    blocks = _blocks("fetch_attrib", x)
    _pages("fetch_attrib", table, ROWS * LANE, p)
    out = torch.empty_like(x)
    lib = _lib()
    err = lib.pt_fetch_attrib(FETCH_VARIANTS.index(variant), table.data_ptr(), x.data_ptr(), out.data_ptr(), int(p),
                              blocks, stream(x))
    raise_on(err, lib, "fetch_attrib")
    PROBE_LAUNCHES["fetch_attrib"] += 1
    return out


def _bind(lib) -> None:
    """Set the ctypes signatures of csrc/probes.cu's entry points."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.pt_op_chain.argtypes = [i, p, p, i, i, i, i, p]
    lib.pt_paged_probe.argtypes = [i, p, p, i, i, p, i, i, f, f, p, p, p]
    lib.pt_tile_fetch.argtypes = [i, p, p, p, i, i, p]
    lib.pt_fetch_attrib.argtypes = [i, p, p, p, i, i, p]
    for fn in (lib.pt_op_chain, lib.pt_paged_probe, lib.pt_tile_fetch, lib.pt_fetch_attrib):
        fn.restype = i
