"""Device meshes (``kangaroo_tpu/parallel/mesh.py``).

The JAX package runs a mesh as one program over a list of devices; so does
the port, with no process group: a ``Mesh`` is a tuple of ``torch.device``s
along one axis, and the sharded functions (``parallel.sharding``) loop over
its shards from one host thread, moving tensors between them with ``.to``.
A mesh may name one device several times: its shards are then virtual
shards of that device, run one after another (the counterpart of the JAX
package's virtual CPU devices). A virtual mesh is asked for explicitly
(``devices=``); ``make_mesh`` never falls back to one.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A one-axis mesh: shard k runs on ``devices[k]``."""

    devices: tuple[torch.device, ...]
    axis: str = "shard"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, axis: str = "shard", devices=None) -> Mesh:
    """A mesh over CUDA cards 0 .. n_devices - 1 (every card by default),
    or over ``devices`` as given (e.g. ``["cuda:0"] * 4`` or
    ``["cpu"] * 8`` for virtual shards). Raises if there are fewer cards
    than asked for."""
    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)
        if n_devices is not None and n_devices != len(devs):
            raise ValueError(f"make_mesh: n_devices={n_devices} but {len(devs)} devices given")
    else:
        have = torch.cuda.device_count()
        n = have if n_devices is None else int(n_devices)
        if not 1 <= n <= have:
            raise RuntimeError(f"make_mesh: asked for {n_devices if n_devices else 'every'} CUDA "
                               f"device(s), found {have}; pass devices= for a virtual mesh")
        devs = tuple(torch.device("cuda", i) for i in range(n))
    if not devs:
        raise ValueError("make_mesh: a mesh needs at least one device")
    return Mesh(devs, axis)


def shard(x: torch.Tensor, mesh: Mesh, dim: int) -> list[torch.Tensor]:
    """Axis ``dim`` of ``x`` cut into ``mesh.size`` equal blocks, block k on
    ``mesh.devices[k]`` (a view where it is already there)."""
    if x.shape[dim] % mesh.size:
        raise ValueError(f"shard: axis {dim} of length {x.shape[dim]} does not divide the "
                         f"{mesh.size}-way mesh")
    return [b.to(d) for b, d in zip(x.chunk(mesh.size, dim=dim), mesh.devices)]


def shard_leading(x: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """The leading axis of ``x`` cut into ``mesh.size`` equal blocks."""
    return shard(x, mesh, 0)


def replicate(x: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """``x`` on every device of the mesh (itself where it already is)."""
    return [x.to(d) for d in mesh.devices]
