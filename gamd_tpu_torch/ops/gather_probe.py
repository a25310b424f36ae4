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
