from rust_pathtracer_tpu_torch.parallel.mesh import Mesh, distributed_init, make_mesh
from rust_pathtracer_tpu_torch.parallel.shard import (
    reduce_replicated_grads,
    render_loss_and_grad_sharded,
    render_radiance_sharded,
)

__all__ = ["Mesh", "distributed_init", "make_mesh", "reduce_replicated_grads",
           "render_loss_and_grad_sharded", "render_radiance_sharded"]
