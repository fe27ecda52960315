"""The device mesh of the multi-GPU paths, on ``torch.distributed``.

Counterpart of ``parallel/mesh.py`` in the JAX package.  JAX names a mesh
axis and ``shard_map`` runs one program per device; here a job runs one
process per rank, and each axis of a ``DeviceMesh`` (``dp`` data, ``tp``
tensor, ``sp`` sequence) hands out the ``ProcessGroup`` of this rank's
row along it.  Every collective of the port takes such a group where the
JAX package takes an axis name.  The group runs NCCL for CUDA tensors
and gloo for CPU tensors; neither stands in for the other.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from exploring_flash_attention_tpu_torch.configs import MeshConfig

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_distributed(rank: int, world_size: int, init_method: str,
                     device_type: str = "cuda") -> None:
    """Join this process to a job of ``world_size`` ranks: the process
    group on NCCL for ``"cuda"`` (one card a rank: rank ``r`` takes card
    ``r % device_count``) or gloo for ``"cpu"``.  ``init_method`` is the
    rendezvous, ``tcp://localhost:<port>`` or ``file://<path>``."""
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(BACKENDS[device_type], init_method=init_method,
                            rank=rank, world_size=world_size)


def make_mesh(config: MeshConfig, device_type: str = "cuda"):
    """The ``DeviceMesh`` of ``config.shape`` over the job's ranks, with
    the axis names ``("dp", "tp", "sp")``: rank ``r`` sits at
    ``np.unravel_index(r, config.shape)``, as the JAX package reshapes its
    device list.  The process group must be initialised, on the backend
    of ``device_type`` (NCCL for ``"cuda"``, gloo for ``"cpu"``), with
    ``config.n_devices`` ranks; otherwise it raises."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialised process group "
            "(torch.distributed.init_process_group, or init_distributed)")
    if dist.get_world_size() != config.n_devices:
        raise ValueError(
            f"MeshConfig wants {config.n_devices} ranks {config.shape}, the "
            f"process group has {dist.get_world_size()}")
    backend = dist.get_backend()
    if backend != BACKENDS[device_type]:
        raise ValueError(f"a {device_type} mesh runs on "
                         f"{BACKENDS[device_type]}, the process group on "
                         f"{backend}")
    return init_device_mesh(device_type, config.shape,
                            mesh_dim_names=config.axis_names)


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along ``axis`` (``mesh.get_group(axis)`` is
    their ``ProcessGroup``, ``mesh.get_local_rank(axis)`` this rank's
    coordinate)."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def check_mesh(mesh) -> None:
    """Raise ``TypeError`` unless ``mesh`` is a ``DeviceMesh`` with the
    axes ``dp``, ``tp`` and ``sp``."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or set(
            mesh.mesh_dim_names or ()) != {"dp", "tp", "sp"}:
        raise TypeError("the sharded step takes a DeviceMesh with the axes "
                        "('dp', 'tp', 'sp') (parallel.make_mesh), got "
                        f"{type(mesh).__name__}")


def shard(x: torch.Tensor, mesh, axis: Optional[str], dim: int
          ) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` when ``axis`` shards it:
    of ``axis_size`` equal parts, the one at this rank's coordinate along
    ``axis`` (all of ``x`` for ``axis`` None)."""
    if axis is None:
        return x
    n = axis_size(mesh, axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} {axis} ranks")
    return x.chunk(n, dim)[mesh.get_local_rank(axis)].contiguous()


def _zip_map(fn: Callable[[Any, Any], Any], tree: Any, spec: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _zip_map(fn, tree[k], spec[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, t, s) for t, s in zip(tree, spec))
    return fn(tree, spec)


def shard_tree(params: Any, spec: Any, mesh) -> Any:
    """This rank's tp slices of full parameters: each leaf split along the
    dim its ``spec`` leaf names (an int; None keeps it whole), as
    ``jax.device_put`` places a ``PartitionSpec`` over ``tp``.  Slices are
    copies, so each rank's leaves own their memory."""
    return _zip_map(lambda x, dim: shard(x, mesh, None if dim is None
                                         else "tp", dim).clone(),
                    params, spec)


def gather_tree(params: Any, spec: Any, mesh) -> Any:
    """The full parameters from every rank's tp slices (the inverse of
    :func:`shard_tree`), detached, on every rank."""
    group, n = mesh.get_group("tp"), axis_size(mesh, "tp")

    def gather(x, dim):
        x = x.detach().contiguous()
        if dim is None or n == 1:
            return x.clone()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    return _zip_map(gather, params, spec)
