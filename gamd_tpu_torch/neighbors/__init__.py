from gamd_tpu_torch.neighbors.dense import (dense_neighbor_list,
                                            all_pairs_edges)
from gamd_tpu_torch.neighbors.cell_list import cell_list_neighbor_list
from gamd_tpu_torch.neighbors.search import (NeighborList, NeighborSearcher,
                                             edge_mask_fn)
from gamd_tpu_torch.neighbors.topology import water_bond_mask, edge_type_water

__all__ = [
    "dense_neighbor_list",
    "all_pairs_edges",
    "cell_list_neighbor_list",
    "NeighborList",
    "NeighborSearcher",
    "edge_mask_fn",
    "water_bond_mask",
    "edge_type_water",
]
