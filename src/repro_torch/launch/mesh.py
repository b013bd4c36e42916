"""Meshes over ``torch.distributed`` process groups (``repro.launch.mesh``).

Nothing here runs at import.  A mesh needs a default process group of as
many ranks as it has devices; :func:`open_group` opens one with the backend
the caller names and never guesses: ``"nccl"`` on the card, ``"gloo"`` on
the CPU, ``"fake"`` for the dry run (``torch.testing._internal``'s fake
backend: every rank of a 256- or 512-rank group in one process, collectives
that move nothing).  A one-rank group needs no network: its store is a
``HashStore``.

The reference's ``use_mesh`` is a shim over JAX versions (``set_mesh``,
``sharding.use_mesh``, the ``Mesh`` context); a ``DeviceMesh`` is passed
explicitly to whatever uses it, so it has no counterpart here.
"""

from __future__ import annotations

import torch.distributed as dist

BACKENDS = ("nccl", "gloo", "fake")


def open_group(backend: str, world_size: int = 1, rank: int = 0, store=None) -> None:
    """Open the default process group: ``backend`` is ``"nccl"``, ``"gloo"``
    or ``"fake"``.  ``store`` is the ranks' rendezvous (a ``FileStore`` or a
    ``TCPStore`` on localhost for several processes); a one-rank group and
    the fake backend need none."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: choose from {BACKENDS}")
    if dist.is_initialized():
        raise RuntimeError("a default process group is already open")
    if backend == "fake":
        try:
            from torch.testing._internal.distributed.fake_pg import FakeStore
        except ImportError as e:  # no fallback: the dry run needs the fake backend
            raise RuntimeError("the dry run needs torch's fake process-group backend "
                               "(torch.testing._internal.distributed.fake_pg), which this torch lacks") from e
        store = FakeStore()
    elif store is None:
        if world_size != 1:
            raise ValueError(f"{world_size} ranks need a store to meet at")
        store = dist.HashStore()
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)


def close_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(shape, axes, device_type: str = "cuda"):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16 x 16 ``("data", "model")`` (256 devices) or 2 x 16 x 16 ``("pod",
    "data", "model")`` (512) over the open default group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(n_data: int = 1, n_model: int = 1, device_type: str = "cuda"):
    """A small ``("data", "model")`` mesh for examples and tests."""
    return make_mesh((n_data, n_model), ("data", "model"), device_type)


def mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape)
