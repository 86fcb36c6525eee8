"""Faults planted under the timed path, for the tests that see ``correct``
come out false.  ``plant(name)`` patches the program in this process; a
``sitecustomize`` that calls it carries a fault into the ranks of a
sharded run."""

import torch

FRAME_FAULTS = ("half", "altered")
MESH_FAULTS = ("half", "altered", "no_exchange")
STEP_FAULTS = ("frozen", "half_loss", "altered_step")
PERLIN_FAULTS = ("perlin_seed", "perlin_solid")


def plant(name: str) -> None:
    import rust_pathtracer_tpu_torch.grad as grad
    import rust_pathtracer_tpu_torch.parallel.shard as shard
    import rust_pathtracer_tpu_torch.render as render

    if name == "half":  # half the samples left out, the mean over the rest
        real = render.trace

        def trace(*a, **kw):
            rad, stats = real(*a, **kw)
            keep = torch.ones_like(rad)
            keep[1::2] = 0.0
            return rad * keep * 2.0, stats
        render.trace = trace
    elif name == "altered":  # the frame altered where it is produced
        real_one, real_mesh = render.render_radiance, shard.render_radiance_sharded

        def one(*a, **kw):
            img, stats = real_one(*a, **kw)
            return img * 1.01, stats

        def mesh(*a, **kw):
            img, stats = real_mesh(*a, **kw)
            return img * 1.01, stats
        render.render_radiance, shard.render_radiance_sharded = one, mesh
    elif name == "no_exchange":  # every rank's own slot, no all-reduce
        def slots(x, index, size, group):
            return torch.stack([x if i == index else torch.zeros_like(x)
                                for i in range(size)])
        shard._slot_all_reduce = slots
    elif name == "frozen":  # a step that leaves the parameters as they were
        torch.optim.Adam.step = lambda self, closure=None: None
    elif name == "half_loss":  # half the pixels left out of the loss
        def l2_loss(params, scene, settings, key, target, *, device):
            img = grad.render_radiance_diff(params, scene, settings, key, device=device)
            target = torch.as_tensor(target, dtype=torch.float32, device=img.device)
            return 0.5 * torch.mean(((img - target) ** 2).reshape(-1, 3)[::2])
        grad.l2_loss = l2_loss
    elif name == "altered_step":  # the loss and gradient altered where produced
        real = grad.render_loss_and_grad

        def loss_and_grad(*a, **kw):
            loss, g = real(*a, **kw)
            return loss * 1.01, type(g).from_leaves([x * 1.01 for x in g.leaves()])
        grad.render_loss_and_grad = loss_and_grad
    elif name == "perlin_seed":  # the marble hashed with the seed + 1
        from rust_pathtracer_tpu_torch.scene import builder

        real_init = builder.SceneBuilder.__init__

        def init(self, perlin_seed=0):
            real_init(self, perlin_seed + 1)
        builder.SceneBuilder.__init__ = init
    elif name == "perlin_solid":  # a perlin texture read as a solid one
        from rust_pathtracer_tpu_torch.scene import builder
        from rust_pathtracer_tpu_torch.scene.types import TEX_SOLID

        builder.SceneBuilder.perlin_texture = (
            lambda self, scale: self._push_tex(TEX_SOLID, scale=scale))
    else:
        raise ValueError(f"unknown fault {name!r}")
