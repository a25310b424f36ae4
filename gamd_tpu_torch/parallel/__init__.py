from gamd_tpu_torch.parallel.mesh import make_mesh, dp_sharding

__all__ = ["make_mesh", "dp_sharding"]
