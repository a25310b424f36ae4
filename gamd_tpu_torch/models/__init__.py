from gamd_tpu_torch.models.mlp import MLP
from gamd_tpu_torch.models.gnn import (
    RBFExpansion,
    EdgeGatedConv,
    ConvBlock,
    GAMDNet,
    cubic_kernel,
)
from gamd_tpu_torch.models.normalizer import (RunningStat, update_stat,
                                              merge_stats)

__all__ = [
    "MLP",
    "RBFExpansion",
    "EdgeGatedConv",
    "ConvBlock",
    "GAMDNet",
    "cubic_kernel",
    "RunningStat",
    "update_stat",
    "merge_stats",
]
