"""Process groups for data parallelism over the ray axis (port of
pvd_tpu/parallel/mesh.py).

The JAX package runs one program over a 1-D device mesh ("rays"); the
port runs one process per device, as `torchrun` starts them:

    torchrun --nproc_per_node N -m pvd_tpu_torch.cli.distill ... \
        --n_devices N

Each process holds a replica of the parameters, the optimizer state and
the occupancy grid, and works on its own share of each ray batch.
`RayGroup` carries the rank, the world size and the collectives the data-
parallel steps need (`parallel/dp.py`): a mean over ranks in place (the
JAX package's `pmean`), an all-gather that concatenates the ranks' rows
in rank order (its `P("rays")` outputs), a max over ranks, and a row
slice per rank (`shard_batch`).  NCCL is the backend on CUDA and gloo on
the CPU; gloo can also be asked for on CUDA tensors (several ranks on one
card, which NCCL refuses), and then every collective goes through host
memory.  Every group gets a finite timeout, so a rank that dies fails
the others instead of hanging them.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# seconds a collective may wait for the other ranks before the run fails
DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class RayGroup:
    """The ranks of the default process group, which share each ray
    batch: `rank` of `world`, over `backend` ("nccl" or "gloo")."""

    rank: int
    world: int
    backend: str

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor a collective works on: gloo takes host memory."""
        if self.backend == "gloo" and t.device.type != "cpu":
            return t.cpu()
        return t

    def _reduce_(self, tensors: Sequence[torch.Tensor], op):
        """One all-reduce of the tensors' concatenation (their common
        dtype), written back in place."""
        tensors = list(tensors)
        if not tensors:
            return
        flat = self._staged(torch.cat([t.reshape(-1) for t in tensors]))
        dist.all_reduce(flat, op=op)
        off = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n

    def mean_(self, tensors: Sequence[torch.Tensor]):
        """Replace each float tensor by its mean over the ranks, in place:
        one all-reduce of their concatenation, then / world (pmean)."""
        self._reduce_(tensors, dist.ReduceOp.SUM)
        for t in tensors:
            t.div_(self.world)

    def mean_dict(self, values: dict) -> dict:
        """{name: 0-d tensor} averaged over the ranks (one all-reduce)."""
        names = list(values)
        vals = [values[k].detach().float().reshape(()).clone()
                for k in names]
        self.mean_(vals)
        return dict(zip(names, vals))

    def sum_(self, tensors: Sequence[torch.Tensor]):
        """Replace each tensor by its sum over the ranks, in place."""
        self._reduce_(tensors, dist.ReduceOp.SUM)

    def max_(self, tensors: Sequence[torch.Tensor]):
        """Replace each tensor by its maximum over the ranks, in place."""
        self._reduce_(tensors, dist.ReduceOp.MAX)

    def agree(self, flag: bool, device) -> bool:
        """True when any rank says True: a host decision (the wall
        budget) that every rank then takes together."""
        t = torch.tensor([1.0 if flag else 0.0], device=device)
        self.max_([t])
        return bool(t.item() > 0)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' tensors (equal shapes) concatenated along dim 0 in
        rank order, on `t`'s device."""
        src = self._staged(t.contiguous())
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src)
        return torch.cat(parts).to(t.device)

    def ray_slice(self, n: int) -> slice:
        """This rank's rows of an n-row batch (n a multiple of world)."""
        if n % self.world:
            raise ValueError(f"{n} rows do not split over {self.world} ranks")
        k = n // self.world
        return slice(self.rank * k, (self.rank + 1) * k)

    def local_rays(self, num_rays: int) -> int:
        """Each rank's share of a batch of `num_rays` rays."""
        if num_rays % self.world:
            raise ValueError(
                f"num_rays {num_rays} is not a multiple of the {self.world}"
                " ranks (the Trainer rounds it up)")
        return num_rays // self.world


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def env_world_size() -> int:
    """The world size torchrun set (WORLD_SIZE), or 1."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def rank_device(device="cuda") -> torch.device:
    """This rank's device: a bare "cuda" becomes cuda:LOCAL_RANK (one
    process per card, as torchrun starts them); an explicit index or the
    CPU stays as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def init_ray_group(device="cuda", backend: Optional[str] = None,
                   init_method: Optional[str] = None,
                   rank: Optional[int] = None,
                   world_size: Optional[int] = None,
                   timeout_s: float = DEFAULT_TIMEOUT_S) -> RayGroup:
    """The default process group as a RayGroup, started here when it is
    not yet: rank, world size and address from the arguments or from
    torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT;
    `init_method` "env://"), the backend NCCL for a CUDA device and gloo
    for the CPU unless `backend` says otherwise.  A NCCL rank binds its
    card (`rank_device`)."""
    if not dist.is_initialized():
        backend = backend or default_backend(device)
        if rank is None:
            rank = int(os.environ.get("RANK", "0"))
        if world_size is None:
            world_size = env_world_size()
        if backend == "nccl":
            torch.cuda.set_device(rank_device(device))
        dist.init_process_group(
            backend=backend, init_method=init_method or "env://",
            rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
    return RayGroup(rank=dist.get_rank(), world=dist.get_world_size(),
                    backend=str(dist.get_backend()))


def ray_group_for(n_devices: int, device) -> Optional[RayGroup]:
    """The group a run of `n_devices` devices trains over (JAX's
    make_ray_mesh at trainer.py:119-140): None for one device; 0 means
    the world size (one device without torchrun).  n_devices must equal
    the world size; a run with more than one device and no process group
    needs torchrun's environment."""
    if n_devices == 1:
        return None
    if dist.is_initialized():
        world = dist.get_world_size()
    else:
        world = env_world_size()
    if n_devices == 0:
        n_devices = world
        if n_devices == 1:
            return None
    if n_devices != world:
        raise ValueError(
            f"n_devices={n_devices} but the world size is {world}: start "
            f"one process per device (torchrun --nproc_per_node "
            f"{n_devices} ... --n_devices {n_devices})")
    return init_ray_group(device)


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s own stream of draws, mixed from both (JAX
    folds every device index into the key), so that no rank's stream,
    rank 0's included, replays the one seeded `seed`."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))
