"""Configuration dataclasses and system presets (a copy of
gamd_tpu/core/config.py: the port imports nothing of the JAX package).

The reference scatters its physics constants over module-level literals in
four near-identical training scripts (reference:
code/LJ/train_network_lj.py:26-35,
code/water/train_network_tip3p.py:24-35,
code/water/train_network_tip4p.py:25-33,
code/water/train_network_real_large.py:21-30) and argparse
flags (train_network_lj.py:386-403). Here one config system covers system
presets + model + training + MD parameters.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from gamd_tpu_torch.core import units


@dataclass(frozen=True)
class SystemConfig:
    """A physical system preset.

    Attributes:
        name: preset id.
        n_atoms: number of (real) atoms per frame.
        box: cubic box edge length in angstrom, or None for per-sample boxes
            (the RPBE/DFT config feeds the box as a traced input).
        cutoff: GNN edge cutoff radius in angstrom.
        nbr_capacity: fixed K for the padded [N, K] neighbor list, chosen so
            cutoff+skin neighborhoods fit with margin; overflow is detected
            and reported at runtime.
        skin: Verlet skin in angstrom added to the cutoff when building the
            neighbor list so it stays valid between rebuilds (the reference
            uses jax-md's dr_threshold = cutoff/6,
            code/graph_utils.py:24).
        species: 'lj' (single species, no node features), 'water'
            (O,H,H repeating; one-hot node feature O=1/H=0), or 'dft'
            (per-frame atom_type array from the dataset).
        has_bonds: whether the model's edge features carry the intra-molecular
            O-H bond channel (reference: code/nn_module.py:510-511).
        masses: per-species masses (amu) used by the MD integrators.
        temperature: NVT target temperature (K).
        dt_fs: MD timestep in femtoseconds.
        friction_per_ps: Langevin collision rate (1/ps).
        force_unit_to_internal: multiply dataset forces by this to get
            kJ/mol/A (dataset forces are kJ/mol/nm; DFT data is Hartree/bohr).
        length_unit_to_angstrom: multiply dataset positions by this to get A.
    """

    name: str
    n_atoms: int
    box: Optional[float]
    cutoff: float
    nbr_capacity: int
    skin: float
    species: str = "lj"
    has_bonds: bool = False
    masses: Tuple[float, ...] = (39.948,)
    temperature: float = 100.0
    dt_fs: float = 2.0
    friction_per_ps: float = 25.0
    force_unit_to_internal: float = units.KJ_MOL_NM_TO_INTERNAL
    length_unit_to_angstrom: float = 1.0

    def atom_masses(self) -> np.ndarray:
        """Per-atom masses [N] expanded from the species pattern."""
        if self.species == "lj":
            return np.full((self.n_atoms,), self.masses[0], dtype=np.float32)
        if self.species == "water":
            # O,H,H repeating (reference: code/train_utils.py:24-30)
            pattern = np.array(self.masses, dtype=np.float32)
            return np.tile(pattern, self.n_atoms // 3)
        raise ValueError(f"masses undefined for species={self.species}")

    def species_onehot(self) -> Optional[np.ndarray]:
        """[N, 1] one-hot node feature (O=1, H=0), or None for LJ."""
        if self.species == "lj":
            return None
        idx = np.arange(self.n_atoms)
        return (idx % 3 == 0).astype(np.float32).reshape(-1, 1)


@dataclass(frozen=True)
class ModelConfig:
    """GNN force-field architecture (GAMD-small defaults).

    Matches the rollout configuration of the reference
    (reference: code/LJ/test_script/test_langevin.py:63-73).
    """

    encoding_size: int = 128
    hidden_dim: int = 128
    edge_embedding_dim: int = 128
    conv_layers: int = 4
    dropout: float = 0.1
    drop_edge: bool = False
    use_layer_norm: bool = True
    update_edge: bool = False
    expand_edge: bool = True      # RBF expansion on/off (DFT flag)
    rbf_low: float = 0.0
    rbf_high: float = 1.0
    rbf_gap: float = 0.025        # -> 40 centers (reference: nn_module.py:295)
    in_node_feats: int = 1        # one-hot width for water/dft variants
    out_feats: int = 3
    flip_dir: bool = False        # dynamic-box model negates the unit direction
                                  # (reference: code/nn_module.py:327)
    conv_activation: str = "silu"
    mlp_activation: str = "gelu"
    use_pallas: bool = False        # fused Pallas kernel for the conv-layer
                                    # edge pipeline (ops.pallas_mp)
    use_pallas_encoder: bool = False  # fused feature+encoder kernel
                                      # (measured ~even with XLA at N=258;
                                      # off by default, see ops/pallas_encoder)
    compute_dtype: str = "float32"  # 'bfloat16' runs matmuls on the MXU in
                                    # bf16 with fp32 params/accumulation —
                                    # the TPU-native replacement for the
                                    # reference's apex AMP O1
                                    # (train_network_lj.py:378-379)
    longrange: str = ""             # '' (pure GNN, reference parity) or
                                    # 'ewald_recip': the GNN was trained on
                                    # label - analytic k-space Ewald force;
                                    # GNNForceField adds the analytic term
                                    # back at eval/deploy (physics/ewald.py
                                    # recip_energy). Self-describing via the
                                    # checkpoint envelope.

    @property
    def n_rbf(self) -> int:
        return int(np.ceil((self.rbf_high - self.rbf_low) / self.rbf_gap))


@dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters (reference: train_network_lj.py:386-403, 251-254)."""

    lr: float = 3e-4
    min_epoch: int = 30
    max_epoch: int = 30
    batch_size: int = 1
    loss: str = "mae"                 # 'mae' | 'mse' | 'relmae'
                                      # (magnitude-normalized MAE)
    lambda_net_force: float = 1e-3    # LAMBDA2 net-force regularizer
    lambda_cosine: float = 0.0        # angular fine-tune term (0 = the
                                      # reference loss; see loop.py loss_fn)
    rotate_aug: bool = True
    rotate_prob: float = 0.3
    jitter_sigma: float = 0.005
    rigid_jitter: bool = False        # rigid per-molecule jitter instead of
                                      # per-atom (keeps O-H geometry exact;
                                      # see augment.rigid_jitter_positions)
    lr_step_epochs: int = 5
    lr_total_decay: float = 0.001     # StepLR gamma = decay**(step/epochs)
    checkpoint_every: int = 5
    start_epoch: int = 0              # resume: first epoch index to run
                                      # (LR schedule continues from the
                                      # restored opt_state step count)
    seed: int = 0
    precompute_nbrs: bool = False     # per-frame lists built once (exact:
                                      # search precedes jitter, and the
                                      # rotation aug preserves distances)


@dataclass(frozen=True)
class MDConfig:
    """Fused GNN-MD simulation parameters."""

    integrator: str = "langevin"      # 'nve' | 'langevin' | 'nose_hoover' | 'andersen'
    n_steps: int = 25_000
    temperature: float = 100.0
    dt_fs: float = 2.0
    friction_per_ps: float = 25.0
    chain_length: int = 10
    chain_mts: int = 5                # Nose-Hoover multi-timestep loops (n_c)
    chain_ys: int = 5                 # Yoshida-Suzuki order (n_ys)
    rebuild_every: int = 20           # neighbor-list refresh cadence (steps)
    report_every: int = 100
    seed: int = 0


# ---------------------------------------------------------------------------
# Presets mirroring the reference's four system configurations.
# ---------------------------------------------------------------------------

_LJ_SKIN = 7.5 / 6.0      # reference dr_threshold = cutoff/6 (graph_utils.py:24)
_WATER_SKIN = 4.2 / 6.0

PRESETS = {
    # LJ fluid: 258 argon atoms, rho* = 0.5, box 27.27 A, cutoff 7.5 A
    # (reference: train_network_lj.py:26-29; generate_lj_data.py:56-77)
    # K=96: at T*=0.83 the LJ-258 testsystem is in the two-phase region and
    # forms dense liquid droplets (~rho*=0.8) where cutoff+skin neighborhoods
    # reach ~70 atoms; 64 overflows during equilibration.
    "lj": SystemConfig(
        name="lj",
        n_atoms=258,
        box=27.27,
        cutoff=7.5,
        nbr_capacity=96,
        skin=_LJ_SKIN,
        species="lj",
        has_bonds=False,
        masses=(39.948,),
        temperature=100.0,
        dt_fs=2.0,
        friction_per_ps=25.0,
    ),
    # TIP3P water: 258 molecules = 774 atoms, box 20 A, cutoff 4.2 A
    # (reference: train_network_tip3p.py:24-30; generate_tip3p_data.py:55-78)
    # K=96: liquid-density water has ~48 atoms inside cutoff+skin on
    # average with peaks past 64 (measured overflow during generation).
    "tip3p": SystemConfig(
        name="tip3p",
        n_atoms=774,
        box=20.0,
        cutoff=4.2,
        nbr_capacity=96,
        skin=_WATER_SKIN,
        species="water",
        has_bonds=True,
        masses=(15.9994, 1.008, 1.008),
        temperature=300.0,
        dt_fs=2.0,
        friction_per_ps=1.0,
    ),
    # TIP4P-Ew water: 251 molecules = 753 real atoms (M-sites dropped by the
    # loader), box 20 A, cutoff 4.2 A (reference: train_network_tip4p.py:25-30;
    # train_utils.py:58-64)
    "tip4p": SystemConfig(
        name="tip4p",
        n_atoms=753,
        box=20.0,
        cutoff=4.2,
        nbr_capacity=96,
        skin=_WATER_SKIN,
        species="water",
        has_bonds=True,
        masses=(15.9994, 1.008, 1.008),
        temperature=300.0,
        dt_fs=2.0,
        friction_per_ps=1.0,
    ),
    # RPBE/DFT water: 64 molecules = 192 atoms, per-sample (possibly rotated
    # 3-vector) box, cutoff 9.5 bohr; positions bohr, forces Hartree/bohr
    # (reference: train_network_real_large.py:21-30,358;
    # test_langevin_hb.py:105-125)
    "dft": SystemConfig(
        name="dft",
        n_atoms=192,
        box=None,
        cutoff=9.5,
        nbr_capacity=192,      # cutoff ~ box/2: nearly all-pairs
        skin=0.0,
        species="water",
        has_bonds=False,
        masses=(15.9994, 1.008, 1.008),
        temperature=300.0,
        dt_fs=2.0,
        friction_per_ps=1.0,
        force_unit_to_internal=units.HARTREE_PER_BOHR_TO_INTERNAL,
        length_unit_to_angstrom=1.0,   # kept in bohr end-to-end like the reference
    ),
}


def get_preset(name: str, **overrides) -> SystemConfig:
    cfg = PRESETS[name]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def lj_model_config(**overrides) -> ModelConfig:
    """GAMD-small rollout config for LJ (test_langevin.py:63-73)."""
    base = dict(encoding_size=128, hidden_dim=128, edge_embedding_dim=128,
                conv_layers=4, use_layer_norm=True, drop_edge=False)
    base.update(overrides)
    return ModelConfig(**base)


def dft_model_config(**overrides) -> ModelConfig:
    """Dynamic-box RPBE config (train_network_real_large.py:346-370)."""
    base = dict(encoding_size=256, hidden_dim=128, edge_embedding_dim=256,
                conv_layers=5, use_layer_norm=True, flip_dir=True)
    base.update(overrides)
    return ModelConfig(**base)
