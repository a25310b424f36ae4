from gamd_tpu_torch.ops.aggregate import gather_multiply_aggregate
from gamd_tpu_torch.ops.message import pallas_gather_multiply_aggregate

__all__ = [
    "gather_multiply_aggregate",
    "pallas_gather_multiply_aggregate",
]
