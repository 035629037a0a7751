"""Frame-parallel execution over a mesh (``kangaroo_tpu/parallel/batch.py``).

Independent frames sharded across the devices: each device runs the whole
single-device pipeline on its share of the batch. The JAX package vmaps the
pipeline over a shard's frames; ``torch.vmap`` cannot see into the kernel
wrappers, so each shard loops over its frames instead, in order, on its
device (on a card every frame launches its path's kernels).
"""
from __future__ import annotations

import torch

from .mesh import Mesh, shard

AXIS = "shard"


def frame_parallel(fn, mesh: Mesh, n_outputs: int = 1):
    """Lift ``fn(*frame_args) -> out`` to a batch whose leading axis is
    sharded over the mesh: shard k runs ``fn`` on each of its frames on
    ``mesh.devices[k]``. The mesh must divide the batch (``ValueError``).
    Returns the (B, ...) batch of outputs on ``mesh.devices[0]``, or a tuple
    of ``n_outputs`` batches.

    Example::

        f = frame_parallel(lambda l, r: sgm_pipeline(l, r, cfg), mesh)
        disp_batch = f(left_batch, right_batch)   # (B, H, W)
    """

    def wrapper(*args):
        B = args[0].shape[0]
        if any(a.shape[0] != B for a in args) or B % mesh.size:
            raise ValueError(f"frame_parallel: batches of {[a.shape[0] for a in args]} frames; "
                             f"the {mesh.size}-way mesh must divide one common batch size")
        shards = [shard(a, mesh, 0) for a in args]
        outs = [fn(*frame) for k in range(mesh.size)
                for frame in zip(*(s[k] for s in shards))]
        dev0 = mesh.devices[0]
        if n_outputs == 1:
            return torch.stack([o.to(dev0) for o in outs])
        return tuple(torch.stack([o[i].to(dev0) for o in outs]) for i in range(n_outputs))

    return wrapper
