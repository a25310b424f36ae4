from gamd_tpu_torch.neighbors.dense import dense_neighbor_list
from gamd_tpu_torch.neighbors.cell_list import cell_list_neighbor_list
from gamd_tpu_torch.neighbors.search import (NeighborList, NeighborSearcher,
                                             edge_mask_fn)

__all__ = [
    "dense_neighbor_list",
    "cell_list_neighbor_list",
    "NeighborList",
    "NeighborSearcher",
    "edge_mask_fn",
]
