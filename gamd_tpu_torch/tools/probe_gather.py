"""The gather probe on the card: the port of scripts/probe_gather.py, with
its constants, inputs, JSON lines, collapse check and SUMMARY line.

The probe asks what a gather of node-table rows into the LJ-258 edge
stream costs in each form the chip can express: an edge stream of 13,056
rows (272 padded atoms x K=48) from a table of 384 rows (258 live) x 256
lanes (hi|lo packed), the node row of each edge from RandomState(0). The
one-hot forms run here as ops.gather_probe.onehot_gather, the hand-written
CUDA kernel csrc/onehot_gather.cu (mma.sync): the bf16 one-hot (the
baseline), the int8 one-hot against the bf16 table (Hopper has no int8 x
bf16 mma: the one-hot goes to bf16 fragments in registers) and against an
int8 table (s32), and the banded one-hot over 256 or 208 table rows from
16-aligned window starts, indices clipped into their tile's window. The
lane, sublane and transpose forms run as the hand-written CUDA kernels of
csrc/gather_forms.cu, on the script's float32 table: lane_gather over the
transposed table [256, 384] (across the whole row, or from three 128-wide
sub-tables and two selects), sublane_gather (row loads; at max(200,
iters // 10) iterations, as the script) and transpose_probe (34
transposes of [256, 384] an iteration).

Per variant one JSON line: iters, per_edge_stream_us (one call's device
time by CUDA events, median of 5, over iters), calib_ratio (the call at
iters over the call at iters/4; status OK when 2.8 < ratio < 5.2, else
the loop collapsed), compile_s (the first call's wall time, the library's load
included) and parity (|carry - iters sum T[idx]| / (iters sum |T[idx]|),
T[idx] gathered by index; for the transpose, 34 sums of the table an
iteration). The lane, sublane and transpose lines also carry a library
yardstick for the same work, iters calls replayed from a CUDA graph:
torch.gather(TT, 1, idx), torch.index_select(T, 0, idx) and one copy of
34 transposed views of TT. Then SUMMARY with the us per edge stream.

    python3 -m gamd_tpu_torch.tools.probe_gather [--iters 2000]

Needs a CUDA card; `--cpu` runs the plain versions on the CPU and prints
parity, not times.
"""

import argparse
import json
import time

import numpy as np
import torch

from gamd_tpu_torch.ops import gather_probe
from gamd_tpu_torch.ops.gather_probe import band_of, onehot_gather
from gamd_tpu_torch.tools.bench_mxu import call_ms, graph_ms

ROWS = 13056          # 272 padded atoms x K=48
N_PAD = 384           # 128-aligned node table rows
N_LIVE = 258
LANES = 256           # hi|lo packed feature lanes
EB = 384              # edges per dynamic-gather block
N_BLOCKS = ROWS // EB  # 34
BAND_TILE = 1632      # rows of a banded tile (8 tiles)
CALIB = (2.8, 5.2)
PARITY_RTOL = 1e-5
#: The forms of gather_forms.cu, by the form name of VARIANTS.
LANE_FORMS = {"lane384": 384, "lane128x3": 128}
GATHER_FORMS = (*LANE_FORMS, "sublane", "transpose")
MIXED_NOTE = ("Hopper has no int8 x bf16 mma: the int8 one-hot is "
              "converted to bf16 fragments in registers for the bf16 mma")

#: (SUMMARY key, the script's variant name, form).
VARIANTS = (
    ("onehot_dot", "onehot_dot (baseline)", "bf16"),
    ("onehot_int8_mixed", "one-hot int8 x bf16 table (rate probe)",
     "int8_bf16"),
    ("onehot_int8_int8", "one-hot int8 x int8 table (rate probe)",
     "int8_int8"),
    ("onehot_banded_256", "banded one-hot K=256 (2 MXU passes vs 3)",
     "band256"),
    ("onehot_banded_208", "banded one-hot K=208 (x-sort tight band)",
     "band208"),
    ("lane_384", "lane dynamic_gather width=384", "lane384"),
    ("lane_128x3", "lane dynamic_gather 3x128 + select", "lane128x3"),
    ("sublane", "sublane dynamic_gather", "sublane"),
    ("transpose", "tpu.transpose 256x384 blocks", "transpose"),
)


def probe_inputs():
    """(idx [ROWS, 1] int32, table [N_PAD, LANES] float32) as numpy, the
    script's RandomState(0) draws."""
    rng = np.random.RandomState(0)
    idx = rng.randint(0, N_LIVE, (ROWS, 1)).astype(np.int32)
    tbl = rng.randn(N_PAD, LANES).astype(np.float32)
    return idx, tbl


def form_inputs(form, idx, tbl, device):
    """{"idx", "tbl", "starts"} of one form on `device`, as the script
    builds them: the int8 table is (tbl * 8) truncated to int8; a band's
    tiles start at linspace(0, N_PAD - band, 8) aligned down to 16, each
    tile's indices clipped into its window; the lane and transpose forms
    take the float32 table transposed, [LANES, N_PAD], the sublane form the
    float32 table, the other forms the bf16 table."""
    if form in GATHER_FORMS:
        table = tbl if form == "sublane" else np.ascontiguousarray(tbl.T)
        return {"idx": None if form == "transpose"
                else torch.as_tensor(idx, device=device),
                "tbl": torch.as_tensor(table, device=device),
                "starts": None}
    band = band_of(form)
    starts = None
    if band is not None:
        n_bt = ROWS // BAND_TILE
        starts = (np.linspace(0, N_PAD - band, n_bt) // 16 * 16
                  ).astype(np.int32)
        idx = np.clip(idx.reshape(n_bt, BAND_TILE, 1),
                      starts[:, None, None],
                      starts[:, None, None] + band - 1).reshape(ROWS, 1)
        starts = torch.as_tensor(starts, device=device)
    if form == "int8_int8":
        table = torch.as_tensor((tbl * 8).astype(np.int8), device=device)
    else:
        table = torch.as_tensor(tbl, device=device).to(torch.bfloat16)
    return {"idx": torch.as_tensor(np.ascontiguousarray(idx),
                                   device=device),
            "tbl": table, "starts": starts}


def call(inputs, form, iters, product=False):
    """One call of `form` on its inputs (form_inputs)."""
    if form in LANE_FORMS:
        return gather_probe.lane_gather(inputs["idx"], inputs["tbl"], iters,
                                        LANE_FORMS[form], product)
    if form == "sublane":
        return gather_probe.sublane_gather(inputs["idx"], inputs["tbl"],
                                           iters, product)
    if form == "transpose":
        return gather_probe.transpose_probe(inputs["tbl"], iters, N_BLOCKS,
                                            product)
    return onehot_gather(inputs["idx"], inputs["tbl"], iters, form,
                         inputs["starts"], product)


def launches(form):
    """The launches so far of a form's kernel (its wrapper's count)."""
    if form in LANE_FORMS:
        return gather_probe.lane_gather.launches[LANE_FORMS[form]]
    if form == "sublane":
        return gather_probe.sublane_gather.launches
    if form == "transpose":
        return gather_probe.transpose_probe.launches
    return onehot_gather.launches[form]


def gathered(inputs, form):
    """(total, sum of magnitudes) of one iteration's result in float64:
    the rows T[idx] gathered by index, or N_BLOCKS copies of the table for
    the transpose."""
    table = inputs["tbl"].double()
    if form == "transpose":
        return (N_BLOCKS * float(table.sum()),
                N_BLOCKS * float(table.abs().sum()))
    if form in LANE_FORMS:
        table = table.t()
    rows = table[inputs["idx"][:, 0].long()]
    return float(rows.sum()), float(rows.abs().sum())


def parity(carry, inputs, iters, form):
    """|carry - iters * total| / (iters * sum of magnitudes)."""
    total, scale = gathered(inputs, form)
    return abs(float(carry[0, 0]) - iters * total) / max(iters * scale,
                                                         1e-30)


def form_iters(form, iters):
    """The iterations a variant runs at: the script runs the sublane
    gather at max(200, iters // 10)."""
    return max(200, iters // 10) if form == "sublane" else iters


def library_call(form, inputs):
    """(name, fn) of the PyTorch call that does one iteration's work of a
    gather_forms.cu form: torch.gather over the rows of TT, index_select of
    rows of T, or one copy of N_BLOCKS transposed views of TT."""
    tbl = inputs["tbl"]
    if form in LANE_FORMS:
        cols = inputs["idx"][:, 0].long()[None, :].expand(
            LANES, -1).contiguous()
        return "torch.gather(TT, 1, idx)", lambda: torch.gather(tbl, 1, cols)
    if form == "sublane":
        rows = inputs["idx"][:, 0].long()
        return ("torch.index_select(T, 0, idx)",
                lambda: torch.index_select(tbl, 0, rows))
    return (f"TT.expand({N_BLOCKS}, ...).transpose(1, 2).contiguous()",
            lambda: tbl.expand(N_BLOCKS, -1, -1).transpose(1, 2)
            .contiguous())


def run_variant(name, form, inputs, iters, on_card):
    """One variant's JSON line (printed) as a dict."""
    line = {"variant": name, "iters": iters}
    if form == "int8_bf16":
        line["note"] = MIXED_NOTE
    t0 = time.perf_counter()
    out = call(inputs, form, iters)
    if on_card:
        torch.cuda.synchronize()
    line["compile_s"] = time.perf_counter() - t0
    line["parity"] = parity(out, inputs, iters, form)
    if on_card:
        full = call_ms(lambda: call(inputs, form, iters), tuple)
        quarter = call_ms(lambda: call(inputs, form, max(1, iters // 4)),
                          tuple)
        calib = full / max(quarter, 1e-9)
        line.update(per_edge_stream_us=full * 1e3 / iters,
                    calib_ratio=calib, ms=full, quarter_ms=quarter,
                    status="OK" if CALIB[0] < calib < CALIB[1]
                    else "LOOP-COLLAPSED?")
        if form in GATHER_FORMS:
            name, fn = library_call(form, inputs)
            lib_ms = graph_ms(fn, iters)
            line.update(library=name, library_ms=lib_ms,
                        library_us_per_iter=lib_ms * 1e3 / iters)
    else:
        line["status"] = ("OK" if line["parity"] <= PARITY_RTOL
                          else "PARITY-FAIL")
    print(json.dumps(line), flush=True)
    return line


def parse_args(argv=None):
    """The script's flags: --iters 2000 --cpu."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--cpu", action="store_true",
                    help="the plain versions on the CPU: parity only")
    return ap.parse_args(argv)


def main(argv=None):
    """Runs the probe; returns {SUMMARY key: the variant's line}."""
    args = parse_args(argv)
    from gamd_tpu_torch.core.device import resolve_device
    dev = resolve_device("cpu" if args.cpu else "cuda")
    on_card = dev.type == "cuda"
    if on_card:
        from gamd_tpu_torch.core.device import card_line
        print(card_line(), flush=True)
    print(f"backend: {torch.cuda.get_device_name(dev) if on_card else 'cpu'}",
          flush=True)
    print(f"shapes: edge stream {ROWS}x{LANES}, table {N_PAD}({N_LIVE} "
          f"live)x{LANES}", flush=True)
    idx, tbl = probe_inputs()
    results = {}
    for key, name, form in VARIANTS:
        results[key] = run_variant(name, form,
                                   form_inputs(form, idx, tbl, dev),
                                   form_iters(form, args.iters), on_card)
    print("SUMMARY " + json.dumps(
        {key: line.get("per_edge_stream_us")
         for key, line in results.items()}), flush=True)
    return results


if __name__ == "__main__":
    main()
