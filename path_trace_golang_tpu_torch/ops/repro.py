"""The Mosaic repros T5-T8 as CUDA kernels, with their plain PyTorch versions.

Counterparts of the JAX package's small TPU kernels under ``tools/repro/``,
each a Pallas kernel there and a kernel of ``csrc/repro.cu`` here:

* :func:`window_slice` (T5, ``window_slice_probe.py::_kernel_a`` /
  ``_kernel_b``): a one-hot gather through a data-dependent window of a
  bf16 table, in the table's two layouts;
* :func:`cond_chain` (T6, ``mosaic_cond_skip.py::cond_kernel`` /
  ``ctrl_kernel``): ``rounds`` rounds of 32 serial products ``c <- a @ c``,
  guarded by a flag read from device memory (or unguarded: the control);
* :func:`reshape_stage` (T7, ``mosaic_reshape_repro.py::_body``): five
  staged computations on x regrouped to (rows/G, G*128);
* :func:`group_rows` (T8, ``group_rows_relayout.py::body``): x regrouped to
  (rows/G, G*128), a 3-trip loop that folds each wide row's minimum back in,
  and the regrouping undone.

Each wrapper launches its kernel on a CUDA tensor (or raises) and runs its
plain version on a CPU tensor; nothing falls back.  ``REPRO_LAUNCHES``
counts kernel launches and ``REPRO_PLAIN_CALLS`` calls of the plain
versions, keyed by repro (``window_slice``, ``cond_chain``,
``reshape_stage``, ``group_rows``).  The kernels are built with the
renderer's into ``build/torch_kernels/`` (``cuda_trace.build(source=
"repro")``), with the same ``--fmad=false``: every product and sum below is
rounded on its own, as in the plain versions' separate tensor ops.

Where the kernels and the plain versions agree bit for bit: T5 wherever the
plain version gives a number, and NaN where it gives NaN (the kernel writes
the contraction's closed form, proof in ``csrc/repro.cu``; a NaN's payload
may differ); T6 where each row of ``a`` has at most two nonzero
entries, as T6's own matrix (the order of a sum of two terms and zeros does
not change it; for a denser ``a`` the two sum in other orders); T7 and T8
always (stage 5's contraction has one nonzero term a sum, its minimum and
T8's are exact).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_trace
from ._launch import check, on_device, raise_on, stream

__all__ = [
    "LANE", "WINDOW", "INNER", "STAGES", "LAYOUTS", "REPRO_LAUNCHES", "REPRO_PLAIN_CALLS",
    "window_slice", "window_slice_plain", "window_slice_cuda", "window_base", "window_slice_split",
    "cond_chain", "cond_chain_plain", "cond_chain_cuda", "cond_chain_split",
    "reshape_stage", "reshape_stage_plain", "reshape_stage_cuda",
    "group_rows", "group_rows_plain", "group_rows_cuda",
]

LANE = 128
WINDOW = 256  # T5's window of table columns (pages)
INNER = 32  # T6: serial products inside the guarded branch
STAGES = (1, 2, 3, 4, 5)  # T7
TRIPS = 3  # T7's and T8's loop trips
LAYOUTS = ("A", "B")  # T5: A the table bf16[R, P], B its transpose bf16[P, R]
STAGE45_WORDS = 0b10110  # T7 stages 4/5: each lane's mask word before the first pop

REPRO_LAUNCHES = {"window_slice": 0, "cond_chain": 0, "reshape_stage": 0, "group_rows": 0}
REPRO_PLAIN_CALLS = dict.fromkeys(REPRO_LAUNCHES, 0)

_F32 = torch.float32


_BOUND: set = set()  # the builds whose entry points have their ctypes signatures


def _lib():
    lib = cuda_trace._lib(False, "repro")
    if not _BOUND:
        _bind(lib)
        _BOUND.add(True)
    return lib


# ---------------------------------------------------------------------------
# T5: the windowed one-hot gather
# ---------------------------------------------------------------------------


def _table_dims(what: str, table: torch.Tensor, layout: str):
    """(R, P) of the table in either layout."""
    if layout not in LAYOUTS:
        raise ValueError(f"{what}: unknown layout {layout!r}")
    if table.dim() != 2:
        raise ValueError(f"{what}: the table must be 2-d, got {tuple(table.shape)}")
    r, p = table.shape if layout == "A" else (table.shape[1], table.shape[0])
    if p < WINDOW:
        raise ValueError(f"{what}: the table has {p} pages, fewer than the window's {WINDOW}")
    return r, p


def window_base(p_l: torch.Tensor, pages: int) -> int:
    """The window's first page: the smallest live page (a page < 0 is a dead
    lane; none live: ``pages``), floored to a multiple of 128 and clamped to
    [0, pages - WINDOW]."""
    live = p_l >= 0
    big = torch.where(live, p_l, torch.full_like(p_l, pages))
    base = int(big.min())
    return max(min((base // 128) * 128, pages - WINDOW), 0)


def window_slice(table: torch.Tensor, p_l: torch.Tensor, layout: str) -> torch.Tensor:
    """T5: ``out[:, i] = sum_w table[:, base + w] * [base + w == p_l[i]]``
    over the window w < WINDOW at :func:`window_base`, for each lane i of
    ``p_l`` (int32[1, N] or [N]); ``table`` bf16[R, P] (layout ``A``) or its
    transpose bf16[P, R] (layout ``B``).  Returns f32[R, N]: each lane's
    table column where its page lies in the window, else 0."""
    return on_device("window_slice", table, window_slice_plain, window_slice_cuda, table, p_l, layout)


def window_slice_plain(table: torch.Tensor, p_l: torch.Tensor, layout: str) -> torch.Tensor:
    """The plain version: the window sliced out, the one-hot built, and the
    contraction written out as a product and a sum over the window, in f32."""
    REPRO_PLAIN_CALLS["window_slice"] += 1
    _r, p = _table_dims("window_slice", table, layout)
    lanes = p_l.reshape(-1)
    base = window_base(lanes, p)
    sl = table[:, base:base + WINDOW] if layout == "A" else table[base:base + WINDOW, :].T  # (R, W)
    pages = torch.arange(WINDOW, device=table.device, dtype=torch.int32)[:, None] + base
    onehot = (pages == lanes[None, :]).to(torch.bfloat16)  # (W, N)
    return (sl.float()[:, :, None] * onehot.float()[None, :, :]).sum(1)


def window_slice_cuda(table: torch.Tensor, p_l: torch.Tensor, layout: str) -> torch.Tensor:
    """Launch T5's kernel (csrc/repro.cu, window_slice_kernel<layout>: 8 table rows a block, each staging its
    rows of the window and writing the contraction's closed form) on the current stream."""
    check("window_slice", (table, torch.bfloat16), (p_l, torch.int32))
    r, p = _table_dims("window_slice", table, layout)
    n = p_l.numel()
    out = torch.empty((r, n), dtype=_F32, device=table.device)
    lib = _lib()
    err = lib.pt_window_slice(LAYOUTS.index(layout), table.data_ptr(), r, p, WINDOW, p_l.data_ptr(), n,
                              out.data_ptr(), stream(table))
    raise_on(err, lib, "window_slice")
    REPRO_LAUNCHES["window_slice"] += 1
    return out


T5_STAGES = ("base", "copy", "compute", "store", "tail")  # the split's stages, in window_slice_kernel's order


def window_slice_split(table: torch.Tensor, p_l: torch.Tensor, layout: str) -> dict:
    """T5's split: the counting build of its kernel (``-DPT_COUNT_OPS``) on
    the same inputs, one launch, each block's clock cycles by stage (timed by
    its thread 0) summed over the blocks: ``base`` (the window's base, a
    block minimum over the lanes), ``copy`` (the block's rows of the window
    staged in shared memory), ``compute`` (the rows' non-finite counts; in
    the first design the one-hot contraction), ``store`` (the outputs'
    selects and writes) and ``tail`` (the wait for the block's last
    thread); ``blocks``; and by %globaltimer ``end_spread_us`` (first to
    last block end) and ``span_us`` (first block start to last end).  Not
    a launch of the repro's path: ``REPRO_LAUNCHES`` does not change."""
    check("window_slice", (table, torch.bfloat16), (p_l, torch.int32))
    r, p = _table_dims("window_slice", table, layout)
    lib = cuda_trace._lib(True, "repro")
    _bind(lib)
    lib.pt_t5_clocks.argtypes, lib.pt_t5_clocks.restype = [ctypes.c_void_p], ctypes.c_int
    clocks = (ctypes.c_ulonglong * 9)()
    raise_on(lib.pt_t5_clocks(clocks), lib, "window_slice_split")  # reset what earlier launches left
    n = p_l.numel()
    out = torch.empty((r, n), dtype=_F32, device=table.device)
    err = lib.pt_window_slice(LAYOUTS.index(layout), table.data_ptr(), r, p, WINDOW, p_l.data_ptr(), n,
                              out.data_ptr(), stream(table))
    raise_on(err, lib, "window_slice_split")
    torch.cuda.synchronize(table.device)
    raise_on(lib.pt_t5_clocks(clocks), lib, "window_slice_split")
    c = [int(v) for v in clocks]
    split = dict(zip(T5_STAGES, c[:5]))
    split.update(blocks=c[5], end_spread_us=(c[8] - c[7]) / 1e3, span_us=(c[8] - c[6]) / 1e3)
    return split


# ---------------------------------------------------------------------------
# T6: a guarded chain of matrix products
# ---------------------------------------------------------------------------


def _square(what: str, a: torch.Tensor, b: torch.Tensor) -> int:
    n = a.shape[0] if a.dim() == 2 else -1
    if a.dim() != 2 or tuple(a.shape) != (n, n) or tuple(b.shape) != (n, n):
        raise ValueError(f"{what}: a and b must be f32[n, n] alike, got {tuple(a.shape)} and {tuple(b.shape)}")
    return n


def cond_chain(flag: torch.Tensor, a: torch.Tensor, b: torch.Tensor, rounds: int, control: bool = False):
    """T6: from ``c = b``, ``rounds`` rounds that each, if ``flag[0] > 0``
    (always, for the ``control`` chain), do INNER products ``c <- a @ c``;
    returns c.  ``flag`` int32[1] stays on the device: the kernel reads it
    there."""
    return on_device("cond_chain", a, cond_chain_plain, cond_chain_cuda, flag, a, b, rounds, control)


def cond_chain_plain(flag: torch.Tensor, a: torch.Tensor, b: torch.Tensor, rounds: int, control: bool = False):
    """The plain version: each product as ``(a[:, :, None] * c[None]).sum(1)``,
    products and sums rounded on their own."""
    REPRO_PLAIN_CALLS["cond_chain"] += 1
    _square("cond_chain", a, b)
    c = b.to(_F32)
    if not (control or int(flag.reshape(-1)[0]) > 0):
        return c.clone()
    for _ in range(rounds * INNER):
        c = (a[:, :, None] * c[None]).sum(1)
    return c


def cond_chain_cuda(flag: torch.Tensor, a: torch.Tensor, b: torch.Tensor, rounds: int, control: bool = False):
    """Launch T6's kernel (csrc/repro.cu, cond_chain_kernel or, for the
    control, ctrl_chain_kernel) on the current stream."""
    check("cond_chain", (a, _F32), (b, _F32), (flag, torch.int32))
    n = _square("cond_chain", a, b)
    if n != LANE or rounds < 0:
        raise ValueError(f"cond_chain: the kernel takes f32[{LANE}, {LANE}] and rounds >= 0, got n={n}, {rounds}")
    out = torch.empty_like(b)
    lib = _lib()
    err = lib.pt_cond_chain(int(control), flag.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), int(rounds),
                            INNER, stream(a))
    raise_on(err, lib, "cond_chain")
    REPRO_LAUNCHES["cond_chain"] += 1
    return out


def cond_chain_split(flag: torch.Tensor, a: torch.Tensor, b: torch.Tensor, rounds: int, control: bool = False):
    """T6's step split: the counting build of its kernel (``-DPT_COUNT_OPS``)
    on the same inputs, its clock cycles summed over threads and taken a
    step and thread: ``products`` (the step's shared-memory reads, products
    and sums), ``barrier`` (the write and the barrier wait), ``rest`` (the
    rest of the chain: loads of a and b, loop control, the output), and
    ``steps``.  Not a launch of the repro's path: ``REPRO_LAUNCHES`` does
    not change."""
    check("cond_chain", (a, _F32), (b, _F32), (flag, torch.int32))
    if _square("cond_chain", a, b) != LANE or rounds < 0:
        raise ValueError(f"cond_chain_split: the kernel takes f32[{LANE}, {LANE}] and rounds >= 0")
    lib = cuda_trace._lib(True, "repro")
    _bind(lib)
    lib.pt_t6_clocks.argtypes, lib.pt_t6_clocks.restype = [ctypes.c_void_p], ctypes.c_int
    clocks = (ctypes.c_ulonglong * 4)()
    raise_on(lib.pt_t6_clocks(clocks), lib, "cond_chain_split")  # zero what earlier launches left
    out = torch.empty_like(b)
    err = lib.pt_cond_chain(int(control), flag.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), int(rounds),
                            INNER, stream(a))
    raise_on(err, lib, "cond_chain_split")
    torch.cuda.synchronize(a.device)
    raise_on(lib.pt_t6_clocks(clocks), lib, "cond_chain_split")
    prod, bar, whole, steps = (int(c) for c in clocks)
    per = max(steps, 1)
    return {"products": prod / per, "barrier": bar / per, "rest": (whole - prod - bar) / per, "steps": steps,
            "threads": LANE * LANE}


# ---------------------------------------------------------------------------
# T7 and T8: x regrouped to (rows/G, G*128)
# ---------------------------------------------------------------------------


def _grouped(what: str, x: torch.Tensor, g: int) -> int:
    if x.dim() != 2 or x.shape[1] != LANE:
        raise ValueError(f"{what}: x must be f32[rows, {LANE}], got {tuple(x.shape)}")
    if g < 1 or x.shape[0] % g:
        raise ValueError(f"{what}: G={g} must divide the {x.shape[0]} rows")
    return x.shape[0] // g


def _pop(words: torch.Tensor):
    """The walk's pop, as the JAX code writes it: the lowest set bit's index
    through the float bits of ``w & -w`` (LANE for an empty word), and the
    word without that bit."""
    low = words & (-words)
    idx = (low.to(_F32).view(torch.int32) >> 23) - 127
    return torch.where(words > 0, idx, torch.full_like(idx, LANE)), words & ~low


def reshape_stage_plain(x: torch.Tensor, w: torch.Tensor, stage: int, g: int) -> torch.Tensor:
    """The plain version: a real reshape to (rows/G, G*128), each wide row
    through the stage (stage 5's one-hot product written out as a product
    and a sum in f32 over bf16 inputs), and the reshape undone."""
    REPRO_PLAIN_CALLS["reshape_stage"] += 1
    if stage not in STAGES:
        raise ValueError(f"reshape_stage: unknown stage {stage}")
    grows = _grouped("reshape_stage", x, g)
    xf = x.reshape(grows, g * LANE)
    if stage == 1:
        return xf.reshape(x.shape).clone()
    if stage == 2:
        return (xf * 2.0 + 1.0).reshape(x.shape)
    out = torch.empty_like(xf)
    wb = w.to(torch.bfloat16).float()
    iota = torch.arange(LANE, dtype=torch.int32, device=x.device)[:, None]
    for s in range(grows):
        row = xf[s]
        acc = row * 0.0
        words = (row * 0.0).to(torch.int32) | STAGE45_WORDS
        for _ in range(TRIPS):
            if stage == 3:
                acc = acc * 0.5 + row
                continue
            p_l, words = _pop(words)
            if stage == 5:
                onehot = (iota == p_l[None, :]).to(torch.bfloat16).float()  # (LANE, G*128)
                gth = (wb[:, :, None] * onehot[None, :, :]).sum(1)  # (LANE, G*128)
                contrib = gth.amin(0)
            else:
                contrib = p_l.to(_F32)
            acc = acc + contrib * row
        out[s] = acc
    return out.reshape(x.shape)


def reshape_stage(x: torch.Tensor, w: torch.Tensor, stage: int, g: int) -> torch.Tensor:
    """T7: stage ``stage`` (1-5) of the relayout repro on x f32[rows, 128]
    regrouped to (rows/G, G*128): 1 the identity; 2 ``x*2 + 1``; 3 a 3-trip
    carry ``acc <- acc*0.5 + row`` from 0; 4 ``acc <- acc + p*row`` over 3
    pops ``p`` of the lane's mask word 0b10110; 5 as 4 with ``p`` replaced by
    the minimum over the rows of ``bf16(w) @ onehot(p)``, w f32[128, 128].
    Returns f32[rows, 128] in x's layout."""
    return on_device("reshape_stage", x, reshape_stage_plain, reshape_stage_cuda, x, w, stage, g)


def reshape_stage_cuda(x: torch.Tensor, w: torch.Tensor, stage: int, g: int) -> torch.Tensor:
    """Launch T7's kernel on the current stream (csrc/repro.cu: reshape_stage_kernel<stage>, stage 5
    reshape_stage5_kernel, which looks each pop's contraction up in a table that each block builds from w)."""
    check("reshape_stage", (x, _F32), (w, _F32))
    if stage not in STAGES:
        raise ValueError(f"reshape_stage: unknown stage {stage}")
    if tuple(w.shape) != (LANE, LANE):
        raise ValueError(f"reshape_stage: w must be f32[{LANE}, {LANE}], got {tuple(w.shape)}")
    grows = _grouped("reshape_stage", x, g)
    out = torch.empty_like(x)
    lib = _lib()
    err = lib.pt_reshape_stage(stage, x.data_ptr(), w.data_ptr(), out.data_ptr(), grows, g, stream(x))
    raise_on(err, lib, "reshape_stage")
    REPRO_LAUNCHES["reshape_stage"] += 1
    return out


def group_rows(x: torch.Tensor, g: int) -> torch.Tensor:
    """T8: x f32[rows, 128] regrouped to (rows/G, G*128); each wide row
    starts as ``2*row`` and takes 3 trips of ``acc <- acc + (acc > min(acc))``
    (the minimum over the wide row, NaN-propagating); returns f32[rows, 128]
    in x's layout."""
    return on_device("group_rows", x, group_rows_plain, group_rows_cuda, x, g)


def group_rows_plain(x: torch.Tensor, g: int) -> torch.Tensor:
    """The plain version: a real reshape, the loop on the wide rows, the reshape undone."""
    REPRO_PLAIN_CALLS["group_rows"] += 1
    grows = _grouped("group_rows", x, g)
    acc = x.reshape(grows, g * LANE) * 2.0
    for _ in range(TRIPS):
        m = acc.amin(dim=1, keepdim=True)
        acc = acc + torch.where(acc > m, 1.0, 0.0)
    return acc.reshape(x.shape)


def group_rows_cuda(x: torch.Tensor, g: int) -> torch.Tensor:
    """Launch T8's kernel (csrc/repro.cu, group_rows_kernel) on the current stream."""
    check("group_rows", (x, _F32))
    grows = _grouped("group_rows", x, g)
    if g * LANE > 1024:
        raise ValueError(f"group_rows: a wide row of {g * LANE} lanes is one block, at most 1024 threads")
    out = torch.empty_like(x)
    lib = _lib()
    err = lib.pt_group_rows(x.data_ptr(), out.data_ptr(), grows, g, stream(x))
    raise_on(err, lib, "group_rows")
    REPRO_LAUNCHES["group_rows"] += 1
    return out


def _bind(lib) -> None:
    """Set the ctypes signatures of csrc/repro.cu's entry points."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pt_window_slice.argtypes = [i, p, i, i, i, p, i, p, p]
    lib.pt_cond_chain.argtypes = [i, p, p, p, p, i, i, p]
    lib.pt_reshape_stage.argtypes = [i, p, p, p, i, i, p]
    lib.pt_group_rows.argtypes = [p, p, i, i, p]
    for fn in (lib.pt_window_slice, lib.pt_cond_chain, lib.pt_reshape_stage, lib.pt_group_rows):
        fn.restype = i
