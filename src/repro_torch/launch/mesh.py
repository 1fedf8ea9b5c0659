"""Joining the CAD process group.

The counterpart of ``repro.launch.mesh``.  The reference builds a
256- or 512-device ``("pod", "data", "model")`` mesh for its AOT dry-run
(lowering and compiling without allocating).  Nothing of that carries
over: a torch program has no ahead-of-time mesh, and a run on several
cards is one process per card started by a launcher (``torchrun``), each
joining one ``torch.distributed`` process group whose ranks are the
attention servers.  :func:`join_group` is that join: a function, so that
importing this module creates no group and touches no device.
:func:`join_grid` joins the same way and lays the ranks out as the
reference's ``("data", "model")`` mesh (``init_device_mesh``): the CAD
group is a rank's ``"data"`` sub-group, the tensor-parallel collectives
run on its ``"model"`` sub-group.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class RankInfo:
    """This process's place in the group, and the group itself."""
    rank: int
    world: int
    device: torch.device
    group: object


def launched_by_torchrun() -> bool:
    """True when the environment names this process's rank and world."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def join_group(device: str = "cuda", *, backend: Optional[str] = None,
               rank: Optional[int] = None, world: Optional[int] = None,
               local_rank: Optional[int] = None,
               init_method: Optional[str] = None,
               timeout_s: float = 600.0) -> RankInfo:
    """Join the default process group and return this rank's
    :class:`RankInfo`.

    ``rank``, ``world`` and ``local_rank`` default to ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK`` from the environment (what
    ``torchrun`` sets; ``init_method`` then defaults to ``env://``, which
    reads ``MASTER_ADDR`` and ``MASTER_PORT``).  A caller that starts its
    own processes passes them, with ``init_method``
    (``tcp://localhost:<port>`` or ``file://<path>``).  The backend is
    ``nccl`` for ``cuda`` and ``gloo`` for ``cpu`` unless ``backend``
    names one; the device is ``cuda:LOCAL_RANK`` unless the caller asks
    for the CPU.  A ``cuda`` request without a card raises.  Every rank
    of the group holds every head; :func:`join_grid` adds a ``"model"``
    axis."""
    import torch.distributed as dist
    env = os.environ
    rank = int(env["RANK"]) if rank is None else int(rank)
    world = int(env["WORLD_SIZE"]) if world is None else int(world)
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    dev_type = torch.device(device).type
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("join_group: device 'cuda' asked for, but "
                               "there is no CUDA device")
        dev = torch.device("cuda", int(local_rank))
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(dev_type)
    backend = backend or default_backend(dev_type)
    kw = dict(backend=backend, rank=rank, world_size=world,
              init_method=init_method or "env://",
              timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "nccl":
        kw["device_id"] = dev
    if not dist.is_initialized():
        dist.init_process_group(**kw)
    return RankInfo(rank=rank, world=world, device=dev,
                    group=dist.group.WORLD)


@dataclasses.dataclass(frozen=True)
class GridInfo:
    """This process's place in a ``("data", "model")`` grid: its rank,
    its data and model indices, both sub-groups (``data_group`` is the
    CAD group) and the ``DeviceMesh``."""
    rank: int
    world: int
    device: torch.device
    data: int
    model: int
    data_index: int
    model_index: int
    data_group: object
    model_group: object
    mesh: object

    @property
    def sizes(self):
        return {"data": self.data, "model": self.model}


def join_grid(data: int, model: int, device: str = "cuda", *,
              backend: Optional[str] = None, rank: Optional[int] = None,
              world: Optional[int] = None, local_rank: Optional[int] = None,
              init_method: Optional[str] = None,
              timeout_s: float = 600.0) -> GridInfo:
    """Join the default process group as :func:`join_group` does and lay
    its ranks out as a ``data x model`` grid (rank ``d * model + m`` has
    data index ``d`` and model index ``m``, the reference mesh's
    row-major order).  The world size (``WORLD_SIZE`` under ``torchrun``)
    must equal ``data * model``."""
    from torch.distributed.device_mesh import init_device_mesh
    env = os.environ
    world = int(env["WORLD_SIZE"]) if world is None else int(world)
    if world != data * model:
        raise ValueError(f"a {data} x {model} grid needs {data * model} "
                         f"ranks, the world has {world}")
    info = join_group(device, backend=backend, rank=rank, world=world,
                      local_rank=local_rank, init_method=init_method,
                      timeout_s=timeout_s)
    mesh = init_device_mesh(info.device.type, (data, model),
                            mesh_dim_names=("data", "model"))
    d, m = divmod(info.rank, model)
    return GridInfo(rank=info.rank, world=world, device=info.device,
                    data=data, model=model, data_index=d, model_index=m,
                    data_group=mesh.get_group("data"),
                    model_group=mesh.get_group("model"), mesh=mesh)


def leave_group() -> None:
    """Destroy the default process group, if one was joined."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
