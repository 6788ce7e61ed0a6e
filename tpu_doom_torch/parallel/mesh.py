"""Mesh construction and shardings for the batched simulator: the port's
twin of `tpu_doom/parallel/mesh.py`.

JAX runs one controller over every device of a mesh; PyTorch runs one
process per device (SPMD). Each rank here owns one device and holds only
its own blocks: the env axis is data-parallel over the mesh's "dp" axis,
scene arrays are replicated (each rank keeps its copy), and the
framebuffer's row axis can shard over "tp". There is no partitioner: a
collective runs where the code calls one (`mean_metric`, `gather_envs`)
over the process group of its mesh axis. Tensors stay plain local
tensors, not DTensors, because the kernels and `graphs.CapturedTick`
take plain tensors.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .._numerics import div

AXES = ("dp", "tp")


def make_mesh(dp: int | None = None, tp: int = 1, device="cuda") -> DeviceMesh:
    """('dp', 'tp') mesh over the ranks of the initialized world (dp
    major: rank = dp index * tp + tp index), each rank on one device of
    `device`'s type (`distributed.initialize` chose which)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call"
                           " tpu_doom_torch.parallel.initialize first")
    n = dist.get_world_size()
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp ({dp}*{tp}) != world size {n}")
    return init_device_mesh(torch.device(device).type, (dp, tp), mesh_dim_names=AXES)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(AXES.index(axis))


def block(n: int, mesh: DeviceMesh, axis: str) -> slice:
    """This rank's block of an axis of length `n` split over mesh axis
    `axis` in equal shards (unequal shards raise: `mean_metric` relies on
    equal ones)."""
    k = axis_size(mesh, axis)
    if n % k:
        raise ValueError(f"an axis of {n} does not split into {k} equal shards over {axis!r}")
    m, i = n // k, mesh.get_local_rank(axis)
    return slice(i * m, (i + 1) * m)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Which block of a global array this rank holds: `spec` names, per
    axis, the mesh axis it is split over (None: kept whole), as JAX's
    PartitionSpec does."""

    mesh: DeviceMesh
    spec: tuple

    def index(self, shape) -> tuple:
        """This rank's slices of a global array of `shape`."""
        return tuple(slice(None) if a is None else block(n, self.mesh, a)
                     for n, a in zip(shape, self.spec))


def tree_map(fn, tree):
    """`fn` over the tensors of a tensor, NamedTuple, tuple, list or dict;
    other leaves (a portal scene's Python ints) are kept as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    return tree


def shard_batch_pytree(tree, mesh: DeviceMesh, axis: int = 0):
    """Every leaf's env axis (`axis`; the leading one, as in JAX) cut to
    this rank's 'dp' block, on this rank's device; 0-d leaves are
    replicated."""
    dev = mesh_device(mesh)

    def put(x):
        if x.dim() <= axis:
            return x.to(dev)
        spec = (None,) * axis + ("dp",)
        return x[Sharding(mesh, spec).index(x.shape)].to(dev).contiguous()

    return tree_map(put, tree)


def replicate_pytree(tree, mesh: DeviceMesh):
    """Every leaf whole on this rank's device (scene and level data)."""
    dev = mesh_device(mesh)
    return tree_map(lambda x: x.to(dev), tree)


def shard_sim(scene, state, actions, mesh: DeviceMesh):
    """Standard placement: scene replicated, state and actions sharded
    over 'dp' on the env axis."""
    return (replicate_pytree(scene, mesh), shard_batch_pytree(state, mesh),
            shard_batch_pytree(actions, mesh))


def frame_sharding(mesh: DeviceMesh) -> Sharding:
    """(B, H, W) framebuffer: envs over 'dp', rows over 'tp'.
    `.index((B, H, W))` gives this rank's (env, row, column) slices."""
    return Sharding(mesh, ("dp", "tp", None))


def mean_metric(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Global mean (a 0-d tensor on every rank) of a per-env metric whose
    env axis is sharded over 'dp' (replicated over 'tp'): the mean of
    this rank's shard, summed over the 'dp' group by one all-reduce and
    divided by the group's size. The shards are equal in size, so the
    mean of their means is the global mean."""
    m = x.to(torch.float32).mean()
    dist.all_reduce(m, op=dist.ReduceOp.SUM, group=mesh.get_group("dp"))
    return div(m, float(axis_size(mesh, "dp")))


def gather_envs(x: torch.Tensor, mesh: DeviceMesh, axis: int = 0) -> torch.Tensor:
    """The global tensor of one sharded over 'dp' on `axis`: every dp
    block in dp order, from one all-gather over the 'dp' group. The
    output is made where the call is, which inside a CUDA graph capture
    is the graph's own memory, so the gather replays in place."""
    k = axis_size(mesh, "dp")
    # The blocks land one after another on the leading axis (the layout
    # both NCCL and gloo take).
    out = torch.empty((k * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=mesh.get_group("dp"))
    return out.view((k,) + tuple(x.shape)).movedim(0, axis).flatten(axis, axis + 1)
