"""The one-hot gather probe: the plain versions of scripts/probe_gather.py's
one-hot kernels and the wrapper of their Hopper kernel,
csrc/onehot_gather.cu.

Each form gathers rows of a node table [n_pad, 256] into an edge stream of
`rows` rows as a one-hot matrix product, `iters` times, and folds each
product's full sum into a carry (probe_gather.py's `_acc_update`); the
table gets the carry's data-dependent zero first (`_dep_scalar`: 1 once
the carry passes 1e30, else 0). The forms (FORMS):

* "bf16" (kernel_onehot, probe_gather.py:66): a bf16 one-hot times the
  bf16 table, fp32 accumulation;
* "int8_bf16" and "int8_int8" (kernel_onehot_int8 :84): an int8 one-hot
  times the bf16 table, or times an int8 table with s32 accumulation;
* "band256" and "band208" (kernel_onehot_banded :113): tiles of
  rows / len(starts) rows, each a one-hot over `band` table rows from
  starts[tile], the carry taking each tile's sum in turn.

onehot_gather is the entry: a CPU tensor runs the plain version
(onehot_gather_reference: float32 matmuls of the 0/1 one-hot and the
table's values, which are exact, and float32 sums); a CUDA tensor makes one
launch of the form's kernel and one of the partials' total, or raises,
counted in onehot_gather.launches[form]. Both return the carry [8, 128]
(every element the total), and with product=True also the last
iteration's product [rows, 256] fp32 (the gathered rows).

The other three forms, csrc/gather_forms.cu, gather without a product
and fold the full sum of each iteration's result into the carry, with
the dependent zero added to the indices (lane, sublane) or to the table
(transpose):

* lane_gather (kernel_lane, probe_gather.py:147): out[d, e] = TT[d,
  idx[e]] over the transposed table TT [256, n_pad], width 384 across the
  whole row or width 128 from three sub-tables and two selects;
* sublane_gather (kernel_sublane :178): out[e, :] = T[idx[e], :] over the
  table T [n_pad, 256];
* transpose_probe (kernel_transpose :196): (TT + dep).T, `copies` times
  an iteration (the script's 34 blocks).

Each has its plain version beside it (*_reference), runs it for a CPU
tensor, launches its kernel (and the partials' total) for a CUDA tensor
or raises, and counts its launches (lane_gather.launches[width],
sublane_gather.launches, transpose_probe.launches). With product=True
each also returns the last iteration's result: [256, rows], [rows, 256]
or [n_pad, 256] fp32.
"""

import ctypes

import torch

from gamd_tpu_torch.ops.mega import _check
from gamd_tpu_torch.ops.mxu_probe import fp32_matmul

#: Forms, by their code in the C entry (the bands share one code).
FORMS = {"bf16": 0, "int8_bf16": 1, "int8_int8": 2, "band256": 3,
         "band208": 3}
LANES = 256        # table lanes (hi|lo packed)
BLOCK_ROWS = 32    # edge rows of one block of the kernel
DEP_LIMIT = 1e30   # _dep_scalar's threshold
#: Lane gather widths, by their code in gather_forms.cu's C entry.
LANE_WIDTHS = {384: 0, 128: 1}
SUBLANE, TRANSPOSE = 2, 3      # the other codes of that entry
SUB_WIDTH = 128                # the width-128 form's sub-tables
LANE_EDGES = 256               # edges of a lane block (rows: a multiple)
SUBLANE_EDGES = 32             # edges of a sublane block
TILE = 32                      # transpose tile
COPIES = 34                    # transposes an iteration (the script's)


def band_of(form):
    """The band of a banded form, else None."""
    return int(form[4:]) if form.startswith("band") else None


def _dep_table(tbl, acc):
    """tbl + _dep_scalar(acc) in the table's dtype, as float32."""
    dep = (acc > DEP_LIMIT).to(tbl.dtype)
    return (tbl + dep).float()


def onehot_gather_reference(idx, tbl, iters, form, starts=None,
                            product=False):
    """Plain version of onehot_gather (probe_gather.py's loops)."""
    rows = idx.shape[0]
    col = idx.reshape(rows, 1).long()
    band = band_of(form)
    if band is None:
        tiles = [(0, rows, 0, tbl.shape[0])]
    else:
        n_tiles = starts.shape[0]
        size = rows // n_tiles
        tiles = [(t * size, size, int(s), band)
                 for t, s in enumerate(starts.tolist())]
    onehots = [(torch.arange(k, device=idx.device)[None, :]
                == col[r0:r0 + n] - s).float() for r0, n, s, k in tiles]
    acc = torch.zeros((), device=idx.device)
    gs = []
    with fp32_matmul():
        for _ in range(iters):
            table = _dep_table(tbl, acc)
            gs = []
            for oh, (_, _, s, k) in zip(onehots, tiles):
                g = oh @ table[s:s + k]
                acc = acc + g.sum()
                gs.append(g)
    out = acc.expand(8, 128).contiguous()
    if not product:
        return out
    g = torch.cat(gs) if gs else torch.zeros((rows, LANES),
                                             device=idx.device)
    return out, g


def declare(lib):
    """Set argtypes/restype of the library's one-hot gather entry."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gamd_onehot_gather.argtypes = [
        i, p, p, p,                   # form, idx, starts, tbl
        i, i, i, i, i,                # rows n_pad band tile_rows iters
        p, p, p, p]                   # partials, out, g_out, stream
    lib.gamd_onehot_gather.restype = ctypes.c_int
    lib.gamd_gather_form_partials.argtypes = [i, i, i, i]
    lib.gamd_gather_form_partials.restype = ctypes.c_int
    lib.gamd_gather_form.argtypes = [
        i, p, p,                      # form, idx, tbl
        i, i, i, i,                   # rows n_pad copies iters
        p, p, p, p]                   # partials, out, g_out, stream
    lib.gamd_gather_form.restype = ctypes.c_int


def onehot_gather(idx, tbl, iters, form, starts=None, product=False):
    """`iters` one-hot gathers of form `form` with their sums folded into
    the carry; returns the carry [8, 128] (and the last product).

    Args:
        idx: [rows, 1] int32 table row of each edge (banded forms: inside
            its tile's window).
        tbl: [n_pad, 256] bf16 (int8 for "int8_int8").
        iters: iterations in the call (>= 0).
        form: one of FORMS.
        starts: banded forms: [n_tiles] int32 window starts, 16-aligned.
        product: also return the last iteration's product [rows, 256]
            fp32 (a check; timed calls leave it off).

    A CPU `idx` runs onehot_gather_reference. A CUDA `idx` launches
    csrc/onehot_gather.cu's kernel (rows a multiple of 32; the one-hot's
    width, n_pad or the band, a multiple of 16, of 32 for the int8 forms)
    or raises.
    """
    fn = "onehot_gather"
    if form not in FORMS:
        raise ValueError(f"{fn}: form must be one of {sorted(FORMS)}, not "
                         f"{form!r}")
    band = band_of(form)
    if (band is None) != (starts is None):
        raise ValueError(f"{fn}: starts are given with the banded forms "
                         "and only with them")
    if int(iters) < 0:
        raise ValueError(f"{fn}: iters must be >= 0, not {iters}")
    if idx.device.type == "cpu":
        return onehot_gather_reference(idx, tbl, int(iters), form, starts,
                                       product)
    if idx.device.type != "cuda":
        raise ValueError(f"{fn} runs on cuda or cpu, not {idx.device}")
    dev = idx.device
    rows = idx.shape[0] if idx.ndim == 2 else 0
    n_pad = tbl.shape[0] if tbl.ndim == 2 else 0
    _check(fn, "idx", idx, dev, torch.int32, (rows, 1))
    tdtype = torch.int8 if form == "int8_int8" else torch.bfloat16
    _check(fn, "tbl", tbl, dev, tdtype, (n_pad, LANES))
    k = n_pad if band is None else band
    step = 32 if form.startswith("int8") else 16
    tile_rows = rows
    if band is not None:
        n_tiles = starts.shape[0] if starts.ndim == 1 else 0
        _check(fn, "starts", starts, dev, torch.int32, (n_tiles,))
        tile_rows = rows // n_tiles if n_tiles else 0
        if not n_tiles or rows % n_tiles or tile_rows % BLOCK_ROWS:
            raise ValueError(f"{fn}: {rows} rows in {n_tiles} tiles: each "
                             f"tile must hold a multiple of {BLOCK_ROWS}")
    if rows <= 0 or rows % BLOCK_ROWS or not 0 < k <= n_pad or k % step:
        raise ValueError(f"{fn}: {form} needs rows a positive multiple of "
                         f"{BLOCK_ROWS} and a one-hot width (n_pad or the "
                         f"band) in (0, n_pad], a multiple of {step}; got "
                         f"rows {rows}, n_pad {n_pad}, width {k}")
    f32 = dict(device=dev, dtype=torch.float32)
    partials = torch.empty((rows // BLOCK_ROWS) * 2, **f32)
    out = torch.empty((8, 128), **f32)
    g = torch.empty((rows, LANES), **f32) if product else None
    from gamd_tpu_torch.ops.build import load_library
    err = load_library().gamd_onehot_gather(
        FORMS[form], idx.data_ptr(),
        None if starts is None else starts.data_ptr(), tbl.data_ptr(),
        rows, n_pad, k, tile_rows, int(iters), partials.data_ptr(),
        out.data_ptr(), None if g is None else g.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with cudaError {err}")
    onehot_gather.launches[form] += 1
    return (out, g) if product else out


onehot_gather.launches = dict.fromkeys(FORMS, 0)


# ---------------------------------------------------------------------------
# The lane, sublane and transpose forms (csrc/gather_forms.cu).
# ---------------------------------------------------------------------------

def _carry(acc, g, product):
    out = acc.expand(8, 128).contiguous()
    return (out, g) if product else out


def _lane_values(tblt, j, width):
    """TT[:, j] as kernel_lane's form of `width` computes it."""
    if width == tblt.shape[1]:
        return tblt[:, j]
    parts = [tblt[:, s * SUB_WIDTH:(s + 1) * SUB_WIDTH][
        :, torch.clamp(j - s * SUB_WIDTH, 0, SUB_WIDTH - 1)]
        for s in range(3)]
    blk = (j // SUB_WIDTH)[None, :]
    return torch.where(blk == 0, parts[0],
                       torch.where(blk == 1, parts[1], parts[2]))


def lane_gather_reference(idx, tblt, iters, width=384, product=False):
    """Plain version of lane_gather (probe_gather.py:147-175)."""
    col = idx.reshape(-1).long()
    acc = torch.zeros((), device=idx.device)
    g = torch.zeros((tblt.shape[0], col.shape[0]), device=idx.device)
    for _ in range(iters):
        g = _lane_values(tblt, col + (acc > DEP_LIMIT).long(), width)
        acc = acc + g.sum()
    return _carry(acc, g, product)


def sublane_gather_reference(idx, tbl, iters, product=False):
    """Plain version of sublane_gather (probe_gather.py:178-193)."""
    col = idx.reshape(-1).long()
    acc = torch.zeros((), device=idx.device)
    g = torch.zeros((col.shape[0], tbl.shape[1]), device=idx.device)
    for _ in range(iters):
        g = tbl[col + (acc > DEP_LIMIT).long()]
        acc = acc + g.sum()
    return _carry(acc, g, product)


def transpose_probe_reference(tblt, iters, copies=COPIES, product=False):
    """Plain version of transpose_probe (probe_gather.py:196-203): each
    iteration sums `copies` transposes of TT + dep."""
    acc = torch.zeros((), device=tblt.device)
    g = torch.zeros((tblt.shape[1], tblt.shape[0]), device=tblt.device)
    for _ in range(iters):
        g = (tblt + (acc > DEP_LIMIT).float()).t().contiguous()
        acc = acc + g.unsqueeze(0).expand(copies, -1, -1).sum()
    return _carry(acc, g, product)


def _form_call(fn, code, idx, tbl, rows, n_pad, copies, iters, g_shape):
    """One launch of gather_forms.cu's form `code` and the partials'
    total; returns (carry, product or None)."""
    from gamd_tpu_torch.ops.build import load_library
    lib = load_library()
    dev = tbl.device
    f32 = dict(device=dev, dtype=torch.float32)
    partials = torch.empty(
        lib.gamd_gather_form_partials(code, rows, n_pad, copies), **f32)
    out = torch.empty((8, 128), **f32)
    g = torch.empty(g_shape, **f32) if g_shape is not None else None
    err = lib.gamd_gather_form(
        code, None if idx is None else idx.data_ptr(), tbl.data_ptr(), rows,
        n_pad, copies, int(iters), partials.data_ptr(), out.data_ptr(),
        None if g is None else g.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with cudaError {err}")
    return out, g


def _check_iters(fn, iters):
    if int(iters) < 0:
        raise ValueError(f"{fn}: iters must be >= 0, not {iters}")


def _on_card(fn, t):
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{fn} runs on cuda or cpu, not {t.device}")
    return t.device.type == "cuda"


def _check_idx(fn, idx, tbl, multiple):
    rows = idx.shape[0] if idx.ndim == 2 else 0
    _check(fn, "idx", idx, tbl.device, torch.int32, (rows, 1))
    if rows <= 0 or rows % multiple:
        raise ValueError(f"{fn}: rows must be a positive multiple of "
                         f"{multiple}, not {rows}")
    return rows


def lane_gather(idx, tblt, iters, width=384, product=False):
    """`iters` lane gathers TT[:, idx + dep] with their sums folded into
    the carry; returns the carry [8, 128] (and the last result [256,
    rows]).

    Args:
        idx: [rows, 1] int32 table column of each edge, in [0, n_pad).
        tblt: [256, n_pad] float32 transposed table TT.
        iters: iterations in the call (>= 0).
        width: 384, a gather across the whole row (n_pad wide), or 128,
            three 128-wide sub-table gathers and two selects (n_pad 384).
        product: also return the last iteration's result (a check).

    A CPU `idx` runs lane_gather_reference. A CUDA `idx` launches
    csrc/gather_forms.cu's lane kernel (rows a multiple of 256, n_pad of
    4) or raises.
    """
    fn = "lane_gather"
    if width not in LANE_WIDTHS:
        raise ValueError(f"{fn}: width must be one of "
                         f"{sorted(LANE_WIDTHS)}, not {width!r}")
    _check_iters(fn, iters)
    n_pad = tblt.shape[1] if tblt.ndim == 2 else 0
    if width == SUB_WIDTH and n_pad != 3 * SUB_WIDTH:
        raise ValueError(f"{fn}: width 128 takes three 128-wide "
                         f"sub-tables: n_pad 384, not {n_pad}")
    if width != SUB_WIDTH and width != n_pad:
        raise ValueError(f"{fn}: width {width} gathers across the whole "
                         f"row: n_pad must be {width}, not {n_pad}")
    if not _on_card(fn, idx):
        return lane_gather_reference(idx, tblt, int(iters), width, product)
    _check(fn, "tblt", tblt, idx.device, torch.float32, (LANES, n_pad))
    rows = _check_idx(fn, idx, tblt, LANE_EDGES)
    if n_pad % 4:
        raise ValueError(f"{fn}: n_pad must be a multiple of 4, not {n_pad}")
    out, g = _form_call(fn, LANE_WIDTHS[width], idx, tblt, rows, n_pad, 1,
                        iters, (LANES, rows) if product else None)
    lane_gather.launches[width] += 1
    return (out, g) if product else out


lane_gather.launches = dict.fromkeys(LANE_WIDTHS, 0)


def sublane_gather(idx, tbl, iters, product=False):
    """`iters` sublane gathers T[idx + dep, :] with their sums folded into
    the carry; returns the carry [8, 128] (and the last result [rows,
    256]).

    Args:
        idx: [rows, 1] int32 table row of each edge, in [0, n_pad).
        tbl: [n_pad, 256] float32 table T.

    A CPU `idx` runs sublane_gather_reference. A CUDA `idx` launches
    csrc/gather_forms.cu's sublane kernel (rows a multiple of 32) or
    raises.
    """
    fn = "sublane_gather"
    _check_iters(fn, iters)
    if not _on_card(fn, idx):
        return sublane_gather_reference(idx, tbl, int(iters), product)
    n_pad = tbl.shape[0] if tbl.ndim == 2 else 0
    _check(fn, "tbl", tbl, idx.device, torch.float32, (n_pad, LANES))
    rows = _check_idx(fn, idx, tbl, SUBLANE_EDGES)
    out, g = _form_call(fn, SUBLANE, idx, tbl, rows, n_pad, 1, iters,
                        (rows, LANES) if product else None)
    sublane_gather.launches += 1
    return (out, g) if product else out


sublane_gather.launches = 0


def transpose_probe(tblt, iters, copies=COPIES, product=False):
    """`iters` iterations of `copies` transposes of TT + dep with their
    sums folded into the carry; returns the carry [8, 128] (and the last
    transpose [n_pad, 256]).

    Args:
        tblt: [256, n_pad] float32 transposed table TT.
        copies: transposes an iteration (the script's 34 blocks).

    A CPU `tblt` runs transpose_probe_reference. A CUDA `tblt` launches
    csrc/gather_forms.cu's transpose kernel (n_pad a multiple of 32) or
    raises.
    """
    fn = "transpose_probe"
    _check_iters(fn, iters)
    if int(copies) < 1:
        raise ValueError(f"{fn}: copies must be >= 1, not {copies}")
    if not _on_card(fn, tblt):
        return transpose_probe_reference(tblt, int(iters), int(copies),
                                         product)
    n_pad = tblt.shape[1] if tblt.ndim == 2 else 0
    _check(fn, "tblt", tblt, tblt.device, torch.float32, (LANES, n_pad))
    if n_pad <= 0 or n_pad % TILE:
        raise ValueError(f"{fn}: n_pad must be a positive multiple of "
                         f"{TILE}, not {n_pad}")
    out, g = _form_call(fn, TRANSPOSE, None, tblt, 0, n_pad, int(copies),
                        iters, (n_pad, LANES) if product else None)
    transpose_probe.launches += 1
    return (out, g) if product else out


transpose_probe.launches = 0
