"""A GAMD model as a force provider for md.simulate.Simulation (port of
gamd_tpu/train/forcefield.py::GNNForceField: the eager force_fn, the
megakernel force path, the large-N banded force path, the fused MD window
megastep_fn and the offline predict / predict_batch; LJ and water).

A water system (species "water") feeds the model its one-hot species
feature, and with has_bonds the O-H bond channel of every list
(neighbors.topology.neighbor_bond_channel), on every path; its megakernel
forward runs with edge_hilo=True, as JAX's water deployment does; its
banded path takes the channel in the sorted frame (ops.banded). The
analytic long-range channel (make_longrange_force_fn, the envelopes with
`longrange` set) comes with a later slice and raises NotImplementedError.
"""

import torch

from gamd_tpu_torch.core import space
from gamd_tpu_torch.core.config import ModelConfig, SystemConfig
from gamd_tpu_torch.core.device import resolve_device
from gamd_tpu_torch.models.gnn import GAMDNet
from gamd_tpu_torch.models.normalizer import denormalize
from gamd_tpu_torch.neighbors.dense import dense_neighbor_list
from gamd_tpu_torch.neighbors.topology import neighbor_bond_channel
from gamd_tpu_torch.ops.banded import make_banded_force_fn
from gamd_tpu_torch.ops.mega import (ablate_set, mega_forward, mega_md_steps,
                                     pack_params)
from gamd_tpu_torch.train.loop import search_batch
from gamd_tpu_torch.train.state import ForceFieldState


class GNNForceField:
    """Trained (or seeded) GAMD weights wrapped as a force provider.

    Args:
        state: ForceFieldState (params, batch_stats, force/length stats).
        system: SystemConfig (box, cutoff, species, units).
        model_cfg: architecture of the weights.
        device: "cuda" unless the caller asks for the CPU; raises if CUDA
            is asked for and absent.
    """

    def __init__(self, state: ForceFieldState, system: SystemConfig,
                 model_cfg: ModelConfig, device="cuda"):
        self.device = resolve_device(device)
        if getattr(model_cfg, "longrange", ""):
            raise NotImplementedError(
                "the analytic long-range channel (longrange="
                f"{model_cfg.longrange!r}: physics/ewald.py, "
                "make_longrange_force_fn) comes with the next water slice of "
                "the port (ROADMAP Queue 1 item 5)")
        if system.species not in ("lj", "water"):
            raise ValueError(f"unknown species {system.species!r}")
        self.system = system
        self.model_cfg = model_cfg
        self.params = state.params
        self.batch_stats = state.batch_stats
        self.force_stat = state.force_stat
        self.length_stat = state.length_stat
        self.species = system.species
        self.use_bond = system.has_bonds
        self.model = GAMDNet(model_cfg, self.species,
                             self.use_bond).load_params(
            state.params, state.batch_stats).to(self.device).eval()
        feat = system.species_onehot()
        self._feat = None if feat is None else torch.as_tensor(
            feat, device=self.device)[None]           # [1, N, F]

    def _length_scale(self):
        return (self.length_stat.safe_mean,
                max(self.length_stat.std, 1e-12))

    def _bond(self, idx):
        """The bond channel of lists idx [..., N, K] (None without
        has_bonds)."""
        return neighbor_bond_channel(idx) if self.use_bond else None

    def _model(self, pos, idx, mask, box):
        """The model's normalised forces of frames pos [B, N, 3] with their
        lists, with the water inputs (species feature, bond) added."""
        mean, std = self._length_scale()
        feat = None if self._feat is None else self._feat.expand(
            pos.shape[0], -1, -1)
        return self.model(pos, idx, mask, box, mean, std, node_feat=feat,
                          bond=self._bond(idx))

    @torch.no_grad()
    def _forward(self, pos, idx, mask, box):
        """Normalised force prediction for one frame."""
        return self._model(pos[None], idx[None], mask[None], box)[0]

    def force_fn(self, megakernel: bool = False):
        """(pos, idx, mask) -> force in kJ/mol/A, for md.simulate.Simulation.

        megakernel=True returns the ops.mega path: positions to forces in
        one CUDA forward (plain version on the CPU; positions [N, 3], or
        [R, N, 3] replicas with [R, N, K] lists), with the true-cutoff
        mask refresh inside (the closure carries handles_refresh=True, so
        Simulation passes the build-time mask) and the force
        denormalisation folded into the decoder weights.
        """
        if megakernel:
            return self._megakernel_force_fn()
        unit = self.system.force_unit_to_internal

        def fn(pos, idx, mask):
            pred = self._forward(pos, idx, mask, self.system.box)
            return denormalize(pred, self.force_stat) * unit
        return fn

    def _node_h0(self):
        """Initial node features [N, D]: the LJ embedding on every atom, or
        the water node encoder of the (constant) one-hot species, feat @
        kernel + bias, as elementwise products and sums (F is 1: one
        product a value, as the matmul's)."""
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                         device=self.device)
        if self.species == "lj":
            return as_t(self.params["node_emb"]).expand(
                self.system.n_atoms,
                self.model_cfg.encoding_size).contiguous()
        enc = self.params["node_encoder"]
        kernel, bias = as_t(enc["kernel"]), as_t(enc["bias"])
        h = torch.sum(self._feat[0][:, :, None] * kernel[None], dim=1)
        return (h + bias).contiguous()

    def _kernel_params(self, path):
        """MegaParams with the force denormalisation and the unit folded in,
        after the refusals the kernel paths share with the JAX package, and
        a compute dtype other than float32, which the kernels would
        ignore."""
        cfg = self.model_cfg
        if self.system.box is None or not cfg.expand_edge \
                or cfg.update_edge:
            raise ValueError(f"the {path} path requires a fixed scalar box, "
                             "expand_edge=True, update_edge=False")
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                f"the {path} path computes in float32: compute_dtype="
                f"{cfg.compute_dtype!r} runs on the plain force_fn only")
        return pack_params(self.params, cfg, batch_stats=self.batch_stats,
                           force_std=max(self.force_stat.std, 1e-12),
                           force_mean=self.force_stat.safe_mean,
                           unit=self.system.force_unit_to_internal,
                           device=self.device)

    def _replica_h0(self):
        """h0 for positions [N, 3] or [R, N, 3]: the [N, D] rows, or them
        broadcast to [R, N, D] (made once per R and kept), as JAX's force
        paths broadcast them (gamd_tpu/train/forcefield.py:161-163)."""
        h0 = self._node_h0()
        by_r = {}

        def of(pos):
            if pos.ndim != 3:
                return h0
            r = pos.shape[0]
            if r not in by_r:
                by_r[r] = h0.expand(r, -1, -1).contiguous()
            return by_r[r]
        return of

    def _megakernel_force_fn(self):
        cfg = self.model_cfg
        system = self.system
        mp = self._kernel_params("megakernel")
        h0_of = self._replica_h0()
        length_mean, length_std = self._length_scale()

        # Water deployment takes the hi/lo edge stream, as JAX's
        # (gamd_tpu/train/forcefield.py:159); the port's kernels compute it
        # on every system.
        edge_hilo = self.species == "water"

        @torch.no_grad()
        def fn(pos, idx, mask):
            return mega_forward(
                pos, idx, mask, h0_of(pos), mp, system.box, system.cutoff,
                length_mean, length_std, bond=self._bond(idx),
                rbf_gap=cfg.rbf_gap, flip_dir=cfg.flip_dir,
                use_ln=cfg.use_layer_norm, conv_act=cfg.conv_activation,
                mlp_act=cfg.mlp_activation, edge_hilo=edge_hilo)

        fn.handles_refresh = True     # true-cutoff mask redone in the kernel
        return fn

    def megastep_fn(self, ablate=()):
        """Fused MD window for Simulation(megastep_fn=...): (pos, vel,
        force, idx, mask, seed, *, n_steps, c1, hdt, c2col, masses) ->
        (pos', vel', force', ke [n_steps]); a state with a leading replica
        axis [R, N, 3] runs all replicas in one call (ke [R, n_steps]).

        One call of ops.mega.mega_md_steps runs the whole neighbour-reuse
        window of BAOAB Langevin steps (one CUDA library call on the card,
        the plain version on the CPU), with the weights packed once here
        and the force denormalisation folded into the decoder. ablate
        (tools/bench_ablate.py's stage switches, ops.mega.ABLATE_STAGES)
        is passed on; an unknown name raises ValueError here.
        """
        ablate = ablate_set(ablate)
        cfg = self.model_cfg
        system = self.system
        if getattr(cfg, "longrange", ""):
            raise ValueError("a megastep window cannot add the analytic "
                             "long-range term between steps; use the "
                             "per-step force_fn paths")
        mp = self._kernel_params("megastep")
        h0_of = self._replica_h0()
        length_mean, length_std = self._length_scale()

        @torch.no_grad()
        def fn(pos, vel, force, idx, mask, seed, *, n_steps, c1, hdt,
               c2col, masses):
            return mega_md_steps(
                pos, vel, force, idx, mask, h0_of(pos), mp, system.box,
                system.cutoff, length_mean, length_std, masses,
                n_steps=n_steps, c1=c1, hdt=hdt, c2col=c2col, seed=seed,
                bond=self._bond(idx), rbf_gap=cfg.rbf_gap,
                flip_dir=cfg.flip_dir,
                use_ln=cfg.use_layer_norm, conv_act=cfg.conv_activation,
                mlp_act=cfg.mlp_activation, ablate=ablate)

        return fn

    def banded_force_fn(self, band: int = None, tile_n: int = 64):
        """(pos, idx, mask) -> force for LARGE N: x-sorted frames whose conv
        layers read their source rows from per-tile bands (ops.banded; the
        CUDA kernel banded_msg on the card, its plain version on the CPU).
        The true-cutoff mask refresh is inside (handles_refresh) and the
        force denormalisation and unit are folded into the decoder, as on
        the megakernel path. The closure carries the band as
        `banded_band`."""
        cfg = self.model_cfg
        system = self.system
        mp = self._kernel_params("banded")
        length_mean, length_std = self._length_scale()
        fn0 = make_banded_force_fn(
            mp, system.box, system.cutoff, system.n_atoms, self._node_h0(),
            length_mean, length_std, band=band, tile_n=tile_n,
            use_bond=self.use_bond, flip_dir=cfg.flip_dir, use_ln=cfg.use_layer_norm,
            mlp_act=cfg.mlp_activation)

        @torch.no_grad()
        def fn(pos, idx, mask):
            f, ovf = fn0(pos, idx, mask)
            # The force contract has no overflow channel; a band overflow
            # (a tile's neighbour arc wider than the band) would silently
            # drop real edges, so poison the output instead, on the device.
            return torch.where(ovf, torch.nan, 1.0) * f

        fn.handles_refresh = True
        fn.banded_band = fn0.banded_band
        return fn

    @torch.no_grad()
    def predict(self, pos, box=None):
        """Forces [N, 3] of one frame in DATASET units (kJ/mol/nm for LJ):
        positions wrapped, the dense list at the system's cutoff (no skin),
        the model forward and the force denormalisation, with no unit
        conversion (force_fn returns kJ/mol/A)."""
        box = self.system.box if box is None else box
        pos = space.wrap(torch.as_tensor(pos, dtype=torch.float32,
                                         device=self.device), box)
        idx, mask, _ = dense_neighbor_list(pos, box, self.system.cutoff,
                                           self.system.nbr_capacity)
        return denormalize(self._forward(pos, idx, mask, box),
                           self.force_stat)

    @torch.no_grad()
    def predict_batch(self, pos_all, batch_size: int = 16):
        """Forces [M, N, 3] in dataset units of M frames [M, N, 3] (fixed
        box): batches of batch_size frames, each one [B, N, K] forward, the
        last batch padded by repeating the last frame and the result
        trimmed to M."""
        if self.system.box is None:
            raise ValueError("predict_batch requires a fixed box")
        box = self.system.box
        pos_all = torch.as_tensor(pos_all, dtype=torch.float32,
                                  device=self.device)
        m = pos_all.shape[0]
        pad = -(-m // batch_size) * batch_size - m
        if pad:
            pos_all = torch.cat([pos_all, pos_all[-1:].expand(pad, -1, -1)])
        out = []
        for batch in pos_all.split(batch_size):
            posw = space.wrap(batch, box)
            idx, mask, _ = search_batch(posw, box, self.system.cutoff,
                                        self.system.nbr_capacity)
            pred = self._model(posw, idx, mask, box)
            out.append(denormalize(pred, self.force_stat))
        return torch.cat(out)[:m]
