"""Production mesh construction (port of the JAX package's
``repro.launch.mesh``).

The reference builds a ``jax.sharding.Mesh`` of 256 or 512 devices.  The
port has no device mesh: as in ``repro_torch.core.distributed``, a
``torch.distributed`` process group of P ranks stands for the mesh's P
devices, rank ``w`` for device ``w`` of the flattened mesh.  So a
:class:`Mesh` here is the mesh's shape and axis names, and the world size
they imply.

:func:`fake_world` opens the ``fake`` backend's default group: one
process is rank ``rank`` of ``world_size``, and every collective returns
at once (an ``all_to_all_single`` copies its send buffer into its
receive buffer).  That lets one rank of a 256- or 512-device mesh run its
real superstep, on the card, at the production shapes.  The group is
process-global but open only inside the ``with`` block, so the dry run
runs its cells one after another in one process, each under a group of
its own.

Nothing here touches the process group at import.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh's shape and axis names; ``size`` ranks stand for it."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axis names "
                             f"{self.axis_names} differ in length")

    @property
    def size(self) -> int:
        """The world size: the product of the axes."""
        return math.prod(self.shape)

    @property
    def tag(self) -> str:
        """``16x16``, ``2x16x16``: the record files' mesh name."""
        return "x".join(str(d) for d in self.shape)


def production_mesh(multi_pod: bool = False) -> Mesh:
    """``(16, 16)`` over ``("data", "model")``, 256 ranks; or with
    ``multi_pod`` ``(2, 16, 16)`` over ``("pod", "data", "model")``, 512."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def host_world() -> Mesh:
    """The process group that exists, as a ``(data, model)`` mesh with
    ``model`` the largest of 4, 2, 1 that divides the world size (the
    reference's ``make_host_mesh``).  Raises without a group."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no torch.distributed process group is open")
    n = dist.get_world_size()
    model = next(m for m in (4, 2, 1) if n % m == 0)
    return Mesh((n // model, model), ("data", "model"))


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """Open the ``fake`` backend's default group as rank ``rank`` of
    ``world_size`` for the ``with`` block, and destroy it on exit.
    Refuses to replace a group that is already open."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is outside a world of {world_size}")
    if dist.is_initialized():
        raise RuntimeError(
            "a process group is already open in this process; the fake "
            "world cannot replace it")
    # the testing module registers the fake backend with its store
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
