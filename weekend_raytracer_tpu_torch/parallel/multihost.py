"""Multi-process initialization and frame assembly over torch.distributed.

Counterpart of weekend_raytracer_tpu/parallel/multihost.py, which starts
``jax.distributed``: here ``initialize`` starts a torch.distributed world
(NCCL between cards, gloo between CPU processes), one process per card,
launched by ``torchrun`` or given its rendezvous explicitly. Pixels are
independent, so the only traffic between ranks is each frame's all_reduce
of sample shards inside a tile and the assembly of the frame for display.

No cluster means a single-process run; an explicitly configured cluster
that fails to start raises; a cluster that is detected (torchrun's
``WORLD_SIZE``) is started or fails loudly, never silently turned into a
single-process run that would render a fraction of the work.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.log import get_logger
from .sharding import Mesh, gather_accumulator, make_mesh


def local_rank() -> int:
    """This process's card on its host: torchrun's ``LOCAL_RANK``, else the
    global rank modulo the host's cards, else 0."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if dist.is_available() and dist.is_initialized() and torch.cuda.is_available():
        return dist.get_rank() % torch.cuda.device_count()
    return 0


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    timeout: Optional[timedelta] = None,
) -> None:
    """Start the torch.distributed world when running multi-process.

    No-ops for ``num_processes <= 1`` and when no launcher set
    ``WORLD_SIZE`` (the common case for tests and one-card development).
    ``coordinator_address`` is ``host:port`` (a ``tcp://`` rendezvous) or a
    full init URL such as ``file:///path``; with it or ``num_processes``
    the cluster is explicit and its ``process_id`` (or ``RANK``) is
    required. Otherwise torchrun's ``env://`` variables are read.
    ``backend`` defaults to NCCL when a card is present, else gloo; with
    NCCL the process's card (``local_rank()``) is made current first.
    """
    if num_processes is not None and num_processes <= 1:
        return
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    kw = {} if timeout is None else {"timeout": timeout}
    if coordinator_address or num_processes:
        # Explicitly configured cluster: failures are real errors and
        # propagate — degrading to single-process here would silently
        # render 1/num_processes of the work.
        world = num_processes or os.environ.get("WORLD_SIZE")
        rank = process_id if process_id is not None else os.environ.get("RANK")
        if world is None or rank is None or not coordinator_address:
            raise ValueError(
                "an explicit cluster needs coordinator_address, num_processes "
                f"and process_id (got {coordinator_address!r}, {num_processes!r}, "
                f"{process_id!r})")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", int(rank)))
                                  % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=url, world_size=int(world),
                                rank=int(rank), **kw)
        return
    if "WORLD_SIZE" not in os.environ:
        get_logger(__name__).info(
            "no multi-process cluster detected (WORLD_SIZE unset); running "
            "single-process")
        return
    # A launcher configured this process: start the world or fail loudly.
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend, init_method="env://", **kw)


def global_mesh(spp_shards: int = 1) -> Mesh:
    """Mesh over every rank of the world (tiles x spp); every rank calls it."""
    return make_mesh(spp_shards=spp_shards)


def gather_frame(accum: torch.Tensor, width: int, height: int,
                 mesh: Optional[Mesh] = None) -> Optional[np.ndarray]:
    """Assemble the [height * width, 3] accumulator on rank 0.

    ``accum`` is this rank's block of ``mesh`` (the whole accumulator
    without a mesh); rows past ``height`` (mesh padding) are dropped.
    Every rank of the mesh must call it; ranks other than 0 get None.
    """
    whole = accum if mesh is None else gather_accumulator(accum, mesh)
    if dist.is_initialized() and dist.get_rank() != 0:
        return None
    return whole[: height * width].cpu().numpy()
