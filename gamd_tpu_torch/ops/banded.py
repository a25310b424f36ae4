"""Large-N GNN force path on an x-sorted frame with per-tile source bands:
the host side of gamd_tpu/ops/banded.py and the wrapper of its Hopper
kernel csrc/banded_msg.cu.

Each force call sorts the atoms by x, so a tile of tile_n consecutive rows
finds all its neighbours in one contiguous arc of the circular row index
(the band); the conv layers' edge pipelines then read their source rows
from that band.

* band_layout: per-tile band starts and band-local neighbour indices
  (integer work, equal to the JAX package's bit for bit).
* banded_msg_reference: the plain version of the kernel.
* banded_conv_message: the wrapper. A CPU tensor runs the plain version, a
  CUDA tensor launches csrc/banded_msg.cu (the live-edge tensor-core tiles
  of csrc/conv_tc.cuh, ops/edge_tiles.py) or raises. It counts its calls
  in `banded_conv_message.launches`.
* banded_forward: the GAMD forward in the sorted frame, from banded_edges
  (geometry and true-cutoff mask, banded_geometry; encoder; band layout),
  band_nodes (a layer's node rows) and node_update. All but the encoder
  and the message are plain PyTorch (ops.mega), as the JAX package leaves
  them to XLA; the message and node update use silu whatever
  conv_activation says, as JAX's do. On the card the live-edge layout of
  the mask is computed once a call (edge_tiles.mask_layout); the encoder
  runs over its live slots (ops.encoder.live_edge_encoder, where JAX
  encodes every slot in XLA: the same rows) and every layer's message
  reads it. The card takes the LJ encoder (no bond channel, gelu) and
  refuses another.
* make_banded_force_fn: (pos, idx, mask) -> (forces, overflow) with the
  per-call x-sort (sort_by_x), the neighbour-id remap into the sorted
  frame and the unsort.

The TPU kernel's grid runs over whole tiles, so JAX pads e, idx_loc, mask
and dst_code to a multiple of tile_n. The CUDA kernel runs over the live
edges, and row i finds its band start at lo[i // tile_n], so nothing is
padded or copied here.
"""

import ctypes

import torch

from gamd_tpu_torch.core import space
from gamd_tpu_torch.ops import edge_tiles
from gamd_tpu_torch.ops.conv_gather import conv_msg_gather_reference
from gamd_tpu_torch.ops.encoder import live_edge_encoder
from gamd_tpu_torch.ops.mega import (KERNEL_WIDTH, MegaParams, _check,
                                     _silu, _weights, decode_nodes,
                                     encode_edges, layout_capacity,
                                     node_norm)
from gamd_tpu_torch.ops.mxu_probe import sm_count


def _round_up(x, m):
    return -(-x // m) * m


def auto_band(n_atoms, box, cutoff, tile_n=64):
    """make_banded_force_fn's default band (before its cap at
    round_up(N, 16)): the atoms within 2 cutoffs of a plane plus the
    tile's own extent, with 30% margin for density fluctuations, at least
    256, rounded up to 128."""
    frac = min(2.0 * float(cutoff) / float(box), 1.0)
    return int(_round_up(
        max(int(n_atoms * frac * 1.3) + tile_n + 16, 256), 128))


def band_layout(idx, mask, n, band, tile_n):
    """Per-tile CIRCULAR band starts and band-local indices for a
    sorted-frame list.

    The x-sort is periodic: a tile at the box face has neighbours at both
    index extremes, so each tile's sources form an arc of the circular
    index space. lo is the arc start, 16-aligned and taken mod the padded
    row count np_rows = round_up(n, 16); consumers read rows [lo, lo+band)
    of the node array extended by a band-row replica of its head, and
    idx_loc = (idx - lo) mod np_rows, clipped to [0, band - 1].

    Returns (idx_loc [N, K] int32, lo [T] int32, overflow 0-d bool):
    overflow flags a live edge whose source falls outside its tile's band.
    """
    n_tiles = _round_up(n, tile_n) // tile_n
    np_rows = _round_up(n, 16)
    pad_rows = n_tiles * tile_n - idx.shape[0]
    idx_t = torch.cat([idx.long(), idx.new_zeros((pad_rows, idx.shape[1]),
                                                 dtype=torch.long)])
    mask_t = torch.cat([mask, mask.new_zeros((pad_rows, mask.shape[1]))])
    idx_tiles = idx_t.reshape(n_tiles, -1)
    mask_tiles = mask_t.reshape(n_tiles, -1)

    centers = torch.arange(n_tiles, device=idx.device) * tile_n + tile_n // 2
    # Signed circular offset of each source from the tile centre.
    rel = torch.remainder(idx_tiles - centers[:, None] + n // 2, n) - n // 2
    rel_lo = torch.where(mask_tiles, rel, n).amin(dim=1)
    rel_hi = torch.where(mask_tiles, rel, -n).amax(dim=1)
    # The arc's first source row is (centre + rel_lo) mod n: rows n..np_rows
    # hold no atom. (JAX aligns first and takes the result mod np_rows,
    # which for an arc that starts below row 0 at n % 16 != 0 lands up to
    # 15 rows past its first source: ROADMAP Queue 3.)
    start = torch.remainder(centers + rel_lo, n)
    lo = torch.div(start, 16, rounding_mode="floor") * 16
    # Margin: up to 15 rows of lo's 16-alignment and up to 15 dead pad rows
    # when the arc crosses the n -> np_rows seam.
    overflow = torch.any(rel_hi - rel_lo + 32 > band)

    idx_loc = torch.remainder(
        idx_t - lo.repeat_interleave(tile_n)[:, None], np_rows)
    # Out of band only where overflow is flagged, or on masked slots.
    idx_loc = torch.clamp(idx_loc, 0, band - 1)[:idx.shape[0]]
    return idx_loc.to(torch.int32), lo.to(torch.int32), overflow


def layer_weights(mp: MegaParams, layer):
    """The edge pipeline's weights of one layer: w1, b1, ..., w4, b4."""
    return (mp.w_e1[layer], mp.b_e1[layer, 0], mp.w_e2[layer],
            mp.b_e2[layer, 0], mp.w_t1[layer], mp.b_t1[layer, 0],
            mp.w_t2[layer], mp.b_t2[layer, 0])


def banded_msg_reference(e, idx_loc, mask, lo, nodes, dst_code,
                         w1, b1, w2, b2, w3, b3, w4, b4, tile_n=64):
    """Plain version of the kernel: conv_msg_gather_reference with source
    row lo[i // tile_n] + idx_loc[i, k] of the extended node array, hn its
    first D columns and src_code its last D. e [N, K, E], idx_loc and mask
    [N, K], lo [ceil(N / tile_n)], nodes [rows, 2D], dst_code [N, H]."""
    n = e.shape[0]
    d = nodes.shape[1] // 2
    rows = lo.long().repeat_interleave(tile_n)[:n, None] + idx_loc.long()
    return conv_msg_gather_reference(e, rows, mask, nodes[:, :d],
                                     nodes[:, d:], dst_code,
                                     w1, b1, w2, b2, w3, b3, w4, b4)


def declare(lib):
    """Set argtypes/restype of the library's banded entry."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gamd_banded_msg.argtypes = [
        p, p, p, p, p,                                # e idx_loc lo nodes dst
        p, p, p, p, p, p, p, p,                       # w1 b1 ... w4 b4
        i, i, i, ctypes.POINTER(edge_tiles._SlotLayout),  # m k tile layout
        p, p,                                         # wsplit part
        i, i, i, i,                                   # the plan
        p, p]                                         # agg stream
    lib.gamd_banded_msg.restype = ctypes.c_int


def _check_inputs(e, idx_loc, mask, lo, nodes, dst_code, weights, band,
                  tile_n, layout):
    """The kernel's checks on a CUDA device: widths 128, float32 (indices
    int32, mask bool), contiguous, one device; lo one start per tile and
    nodes np_rows + band rows, so that every row the layout can name
    (lo < np_rows, idx_loc in [0, band)) lies inside it; a given live-edge
    layout of one replica of N atoms of K slots."""
    fn = "banded_conv_message"
    if e.device.type != "cuda":
        raise ValueError(f"{fn} runs on cuda or cpu, not {e.device}")
    dev = e.device
    n, k = idx_loc.shape
    w = KERNEL_WIDTH
    _check(fn, "e", e, dev, torch.float32, (n, k, w))
    _check(fn, "idx_loc", idx_loc, dev, torch.int32, (n, k))
    _check(fn, "mask", mask, dev, torch.bool, (n, k))
    _check(fn, "lo", lo, dev, torch.int32, (_round_up(n, tile_n) // tile_n,))
    _check(fn, "nodes", nodes, dev, torch.float32,
           (_round_up(n, 16) + band, 2 * w))
    _check(fn, "dst_code", dst_code, dev, torch.float32, (n, w))
    names = ("w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4")
    for name, t in zip(names, weights):
        shape = (w,) if name.startswith("b") else (w, w)
        _check(fn, name, t, dev, torch.float32, shape)
    if layout is not None:
        shapes = ((1, layout_capacity(n, k)), (1, n), (1, n), (1,))
        for name, t, shape in zip(layout._fields, layout, shapes):
            _check(fn, f"layout.{name}", t, dev, torch.int32, shape)


def banded_conv_message(e, idx_loc, mask, lo, nodes, dst_code, layer,
                        mp: MegaParams, band: int, tile_n: int = 64,
                        layout=None):
    """Masked sum_k hn[src] * theta(e, src, dst) with the source rows read
    from a per-tile band of `nodes`.

    Args:
        e:       [N, K, E] encoder output (sorted frame).
        idx_loc: [N, K] int32 band-local neighbour ids (band_layout).
        mask:    [N, K] bool validity.
        lo:      [T] int32 band start row per tile (band_layout).
        nodes:   [round_up(N, 16) + band, 2D] float32 [hn | src_affine(hn)]
                 in sorted order, zero past N, extended by a replica of
                 its first `band` rows.
        dst_code:[N, H] dst affine rows.
        layer:   conv layer index (selects mp's weights).
        layout:  the live-edge layout of `mask` (edge_tiles.mask_layout),
                 which every layer of a force call shares; computed here
                 when not given.
    Returns agg [N, D] float32. A CPU `e` runs banded_msg_reference (the
    layout unread), a CUDA `e` launches the kernel (every width 128) or
    raises.
    """
    d = nodes.shape[1] // 2
    if d != mp.w_e1.shape[-1]:
        raise ValueError(f"banded_conv_message: the [hn | src] pack needs "
                         f"equal node and hidden widths, got {d} and "
                         f"{mp.w_e1.shape[-1]}")
    weights = layer_weights(mp, layer)
    if e.device.type == "cpu":
        return banded_msg_reference(e, idx_loc, mask, lo, nodes, dst_code,
                                    *weights, tile_n=tile_n)
    _check_inputs(e, idx_loc, mask, lo, nodes, dst_code, weights, band,
                  tile_n, layout)
    if layout is None:
        layout = edge_tiles.mask_layout(mask)
    from gamd_tpu_torch.ops.build import load_library

    n, k = idx_loc.shape
    dev = e.device
    plan = edge_tiles.launch_plan(n, k, sm_count(dev))
    buf, _, _, wsplit, part = edge_tiles.call_scratch(n, k, plan, dev,
                                                      layout=False)
    agg = torch.empty((n, KERNEL_WIDTH), device=dev, dtype=torch.float32)
    err = load_library().gamd_banded_msg(
        *[t.data_ptr() for t in (e, idx_loc, lo, nodes, dst_code,
                                 *weights)],
        n, k, tile_n, ctypes.byref(edge_tiles.slot_struct(layout)),
        wsplit.data_ptr(), part.data_ptr(), *plan[:4], agg.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    edge_tiles.raise_on("banded_msg", err)
    banded_conv_message.launches += 1
    return agg


banded_conv_message.launches = 0


def sort_by_x(pos, idx):
    """The x-sorted frame: (perm, inv, idx_s) with pos[perm] sorted by x
    (stable), inv its inverse and idx_s = inv[idx[perm]] the list in
    sorted row ids (int64)."""
    perm = torch.argsort(pos[:, 0], stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(pos.shape[0], device=perm.device)
    return perm, inv, inv[idx[perm].long()]


def banded_geometry(pos_s, idx_s, mask, box, cutoff):
    """The sorted frame's edge geometry and true-cutoff mask, as JAX's
    banded_forward computes them (gamd_tpu/ops/banded.py:283-289): (rel
    [N, K, 3] in the remainder-form minimum image, dist [N, K], mask AND
    dist * dist < cutoff * cutoff; cutoff None keeps the mask)."""
    rel = space.min_image(pos_s[idx_s.long()] - pos_s[:, None, :], box)
    dist = torch.sqrt(torch.sum(rel * rel, dim=-1))
    if cutoff is not None:
        mask = mask & (dist * dist < cutoff * cutoff)
    return rel, dist, mask


def banded_edges(pos_s, idx_s, mask, mp: MegaParams, box, cutoff,
                 length_mean, length_std, band, tile_n=64, bond=None,
                 rbf_gap=0.025, flip_dir=False, mlp_act="gelu", e_out=None):
    """What every layer's banded_conv_message shares, in the sorted frame:
    the geometry, the true-cutoff mask (banded_geometry), the encoded
    edges, the band layout and, on the card, the live-edge layout of the
    mask. Returns (e [N, K, E], idx_loc, mask, lo, overflow, layout), with
    layout None on the CPU.

    On the CPU e is encode_edges over every slot, as JAX's. On the card
    the layout (edge_tiles.mask_layout) is made once and the encoder runs
    as the kernel ops.encoder.live_edge_encoder over its live slots, into
    e_out if given: e's rows of dead slots are never written, and no layer
    reads them. The kernel takes the LJ encoder (no bond channel, gelu):
    another raises NotImplementedError there, before any work."""
    if pos_s.is_cuda and (bond is not None or mlp_act != "gelu"):
        raise NotImplementedError(
            "the CUDA banded_edges takes the LJ encoder: no bond channel "
            "and the gelu MLP activation")
    rel, dist, mask = banded_geometry(pos_s, idx_s, mask, box, cutoff)
    if pos_s.is_cuda:
        layout = edge_tiles.mask_layout(mask)
        e = live_edge_encoder(
            pos_s, idx_s.to(torch.int32), layout, mp, box, length_mean,
            length_std, rbf_gap=rbf_gap, flip_dir=flip_dir,
            n_rbf=_weights("banded_edges", mp, pos_s.device)[1], out=e_out)
    else:
        layout = None
        unit = rel / (dist[..., None] + 1e-8)
        if flip_dir:
            unit = -unit
        std = (dist - length_mean) / length_std
        e = encode_edges(mp, unit, std, bond, mlp_act, rbf_gap=rbf_gap)
    idx_loc, lo, overflow = band_layout(idx_s, mask, idx_s.shape[0], band,
                                        tile_n)
    return e, idx_loc, mask, lo, overflow, layout


def band_nodes(mp: MegaParams, layer, h, band, use_ln=True):
    """One layer's node rows: (hn, nodes, dst_code) with nodes =
    [hn | src_affine(hn)] zero-padded to round_up(N, 16) rows and extended
    by a replica of its first `band` rows, where circular arcs read past
    the last row."""
    n = h.shape[0]
    hn = node_norm(mp, layer, h, use_ln)
    src_nodes = hn @ mp.w_src[layer] + mp.b_src[layer, 0]
    dst_code = hn @ mp.w_dst[layer] + mp.b_dst[layer, 0]
    pad = hn.new_zeros((_round_up(n, 16) - n, 2 * hn.shape[-1]))
    nodes = torch.cat([torch.cat([hn, src_nodes], dim=1), pad])
    return hn, torch.cat([nodes, nodes[:band]]), dst_code


def node_update(mp: MegaParams, layer, h, hn, agg):
    """h + phi(hn, agg), the conv layer's node update (silu)."""
    pre = hn @ mp.w_pd[layer] + mp.b_pd[layer, 0] \
        + agg @ mp.w_pe[layer] + mp.b_pe[layer, 0]
    return h + _silu(pre) @ mp.w_p[layer] + mp.b_p[layer, 0]


def banded_forward(pos_s, idx_s, mask, h0_s, mp: MegaParams, box, cutoff,
                   length_mean, length_std, band, tile_n=64, bond=None,
                   rbf_gap=0.025, flip_dir=False, use_ln=True,
                   mlp_act="gelu", e_out=None):
    """The GAMD forward in the SORTED frame with banded source rows.

    pos_s/idx_s/h0_s are in x-sorted order (idx_s references sorted rows);
    the true-cutoff mask is redone from pos_s. e_out, on the card, is a
    [N, K, 128] buffer for the live rows of e (banded_edges). Returns
    (forces_sorted [N, 3], overflow 0-d bool).
    """
    e, idx_loc, mask, lo, overflow, layout = banded_edges(
        pos_s, idx_s, mask, mp, box, cutoff, length_mean, length_std, band,
        tile_n, bond, rbf_gap, flip_dir, mlp_act, e_out)
    h = h0_s
    for layer in range(mp.w_src.shape[0]):
        hn, nodes, dst_code = band_nodes(mp, layer, h, band, use_ln)
        agg = banded_conv_message(e, idx_loc, mask, lo, nodes, dst_code,
                                  layer, mp, band, tile_n, layout)
        h = node_update(mp, layer, h, hn, agg)
    return decode_nodes(mp, h, mlp_act), overflow


def make_banded_force_fn(mp: MegaParams, box, cutoff, n_atoms, h0,
                         length_mean, length_std, band=None, tile_n=64,
                         use_bond=False, flip_dir=False, use_ln=True,
                         mlp_act="gelu", force_unit=1.0):
    """(pos, idx, mask) -> (forces, overflow) for md.simulate.Simulation at
    large N: per-call x-sort, neighbour-id remap into the sorted frame,
    banded_forward, unsort.

    h0: [N, D] initial node features in ORIGINAL atom order. band defaults
    to auto_band(n_atoms, box, cutoff, tile_n) and is capped at
    round_up(n_atoms, 16); the closure carries it as `banded_band`.
    use_bond (the water O-H channel) raises NotImplementedError.
    """
    if use_bond:
        raise NotImplementedError(
            "the banded path's water bond channel comes with a later water "
            "slice of the port (ROADMAP Queue 2 item 6b, the banded bond); "
            "water runs on force_fn and force_fn(megakernel=True)")
    if band is None:
        band = auto_band(n_atoms, box, cutoff, tile_n)
    band = min(band, _round_up(n_atoms, 16))

    def fn(pos, idx, mask):
        perm, inv, idx_s = sort_by_x(pos, idx)
        f_s, ovf = banded_forward(
            pos[perm], idx_s, mask[perm], h0[perm], mp, box, cutoff,
            length_mean, length_std, band, tile_n, flip_dir=flip_dir,
            use_ln=use_ln, mlp_act=mlp_act)
        return f_s[inv] * force_unit, ovf

    fn.banded_band = band
    return fn
