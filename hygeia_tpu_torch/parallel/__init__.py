from hygeia_tpu_torch.parallel.mesh import make_mesh
from hygeia_tpu_torch.parallel.sharded import sharded_two_group_inference

__all__ = ["make_mesh", "sharded_two_group_inference"]
