"""Multi-process runtime initialization.

Counterpart of ``rrmpg_tpu/parallel/distributed.py``: call
:func:`initialize` once in every process before building meshes.
:func:`~.mesh.default_mesh` then spans every process's devices in rank
order, and the shared evaluator (:func:`~.mesh.sharded_call`) runs each
process's own shards and ``all_gather``s the results, so that every rank
holds the whole result.  A tool seeded alike on every rank (DE, SCE,
DE-MC) then keeps the same bookkeeping on every rank.

The layout is ``torchrun``'s on an H100 node: one process per GPU, NCCL
between them; CPU meshes (``devices=['cpu', ...]``) take gloo.
"""

import os

import torch


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, **kwargs):
    """Initialize the process group (a no-op in a single process).

    Args:
        coordinator_address: ``host:port`` of rank 0 (``tcp://`` is
            prepended), or an init-method URL (``tcp://...``,
            ``file://...``); default ``env://`` (``MASTER_ADDR`` /
            ``MASTER_PORT``, as ``torchrun`` sets them).
        num_processes: world size (default ``WORLD_SIZE`` from the
            environment).
        process_id: this process's rank (default ``RANK``).
        **kwargs: forwarded to ``torch.distributed.init_process_group``
            (``backend`` defaults to NCCL where CUDA is available, else
            gloo; ``timeout``).

    Only JAX's two benign cases pass quietly: a process group that is
    already initialized, and a single process with nothing to detect
    (no ``coordinator_address``, no ``num_processes`` and no
    ``WORLD_SIZE``).  Anything else that fails raises; a coordinator with
    no world size raises ``ValueError``.  With NCCL, each process takes the GPU of its local rank
    (``LOCAL_RANK``, else its rank modulo the visible GPUs) as its current
    device.

    Returns:
        (process_index, process_count, global_device_count): this
        process's rank, the world size, and the devices of every process
        together (this process's visible GPUs, or 1 for a CPU process,
        times the world size; one per process under NCCL).
    """
    import torch.distributed as dist

    if not dist.is_initialized():
        if num_processes is None and "WORLD_SIZE" in os.environ:
            num_processes = int(os.environ["WORLD_SIZE"])
        if process_id is None and "RANK" in os.environ:
            process_id = int(os.environ["RANK"])
        if num_processes is None and coordinator_address is not None:
            raise ValueError(
                f"initialize({coordinator_address!r}) has a coordinator to "
                "join but no world size: pass num_processes or set "
                "WORLD_SIZE.")
        if num_processes == 1 and process_id is None:
            process_id = 0
        # One process with no coordinator has nothing to join.
        if num_processes is not None and (
                num_processes > 1 or coordinator_address is not None):
            kwargs.setdefault("backend", "nccl" if torch.cuda.is_available()
                              else "gloo")
            if kwargs["backend"] == "nccl":
                torch.cuda.set_device(int(os.environ.get(
                    "LOCAL_RANK", (process_id or 0)
                    % torch.cuda.device_count())))
            dist.init_process_group(
                init_method=_init_method(coordinator_address),
                world_size=num_processes, rank=process_id, **kwargs)
    if not dist.is_initialized():
        return 0, 1, _local_count()
    world = dist.get_world_size()
    if dist.get_backend() == "nccl":
        return dist.get_rank(), world, world
    return dist.get_rank(), world, world * _local_count()


def _init_method(address):
    if address is None:
        return "env://"
    if "://" in address:
        return address
    return f"tcp://{address}"


def _local_count():
    return torch.cuda.device_count() if torch.cuda.is_available() else 1
