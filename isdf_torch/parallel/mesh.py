"""Multi-device placement of a scenario batch over torch.distributed
(counterpart of ``make_mesh``/``shard_batch`` in
``isdf_tpu/parallel/batch.py``).

The mesh has two axes, as the JAX one does: scenarios split over "dp", and
each scenario's obstacle points split over "sp".  JAX places arrays with
``NamedSharding`` and lets XLA insert the collectives; here every rank is a
process that holds its own block, and the code places the collectives
itself:

  * the swept penalty's point sum over "sp" (``copy_to_sp`` before the
    sweep, ``reduce_from_sp`` after it: opt/backend.swept_penalty), so that
    cost and gradient come out whole and identical on every "sp" rank;
  * every decision the host takes on device values (``global_all``,
    ``global_sum``, ``global_min``): a rank that decided alone would leave a
    loop while another waits in the next collective;
  * the gathering of results over "dp" in scenario order (``gather_dp``).

Every rank builds the same global batch from the same seed and keeps its
block (``shard_batch``).  The groups come from
``torch.distributed.device_mesh.init_device_mesh``, PyTorch's counterpart of
``jax.sharding.Mesh``; ranks may share a card (gloo stages CUDA tensors
through the host).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from isdf_torch.device import resolve_device
from isdf_torch.utils import obs

AXES = ("dp", "sp")


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (dp, sp) mesh of world-size ranks, rank =
    dp_idx·sp + sp_idx (JAX's ``devices.reshape(dp, sp)``)."""

    shape: tuple            # (dp, sp)
    dp_idx: int
    sp_idx: int
    dp_group: object        # the ranks of this rank's sp column
    sp_group: object        # the ranks of this rank's dp row
    device: torch.device

    @property
    def dp(self) -> int:
        return self.shape[0]

    @property
    def sp(self) -> int:
        return self.shape[1]

    def group(self, axis: Optional[str] = None):
        """The process group of ``axis`` ("dp" or "sp"); None: the whole
        mesh."""
        if axis is None:
            return dist.group.WORLD
        return {"dp": self.dp_group, "sp": self.sp_group}[axis]

    def block(self, n: int, axis: str) -> slice:
        """This rank's rows of an axis of n entries split over ``axis``."""
        k = self.shape[AXES.index(axis)]
        i = self.dp_idx if axis == "dp" else self.sp_idx
        if n % k:
            raise ValueError(f"{n} entries do not split over {k} ranks of "
                             f"the {axis!r} axis")
        return slice(i * n // k, (i + 1) * n // k)


def make_mesh(n_devices: Optional[int] = None, sp: int = 1,
              device=None) -> Mesh:
    """The (n_devices/sp, sp) mesh of an initialised process group of
    n_devices ranks (default: its world size).  Collective: every rank
    calls it.  ``device`` None means the card, ``cuda:{rank mod cards}``
    (ranks share a card when there are more ranks than cards)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed "
                           "process group")
    world, rank = dist.get_world_size(), dist.get_rank()
    n_devices = world if n_devices is None else n_devices
    if n_devices != world:
        raise ValueError(f"a mesh of {n_devices} ranks in a world of {world}")
    if n_devices % sp:
        raise ValueError(f"{n_devices} ranks do not split into sp = {sp}")
    if device is None:
        resolve_device(None)
        device = torch.device("cuda", rank % torch.cuda.device_count())
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    dm = init_device_mesh(dev.type, (n_devices // sp, sp),
                          mesh_dim_names=AXES)
    dp_idx, sp_idx = dm.get_coordinate()
    return Mesh(shape=(n_devices // sp, sp), dp_idx=dp_idx, sp_idx=sp_idx,
                dp_group=dm.get_group("dp"), sp_group=dm.get_group("sp"),
                device=dev)


def shard_batch(batch, mesh: Mesh):
    """This rank's block of the global batch: scenarios [dp_idx·B/dp, …),
    points and mask [sp_idx·P/sp, …), on the mesh's device, with the mesh
    recorded on the batch.  Raises when B % dp or P % sp is not 0."""
    if batch.mesh is not None:
        raise ValueError("the batch is already placed on a mesh")
    B, P = batch.mask.shape
    b, p = mesh.block(B, "dp"), mesh.block(P, "sp")

    def put(t):
        return t.to(mesh.device).contiguous()

    return replace(batch, head=put(batch.head[b]), tail=put(batch.tail[b]),
                   q0=put(batch.q0[b]), T0=put(batch.T0[b]),
                   points=put(batch.points[b, p]),
                   mask=put(batch.mask[b, p]), mesh=mesh)


class _CopyToSP(torch.autograd.Function):
    """Forward the identity; backward the sum over "sp" of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromSP(torch.autograd.Function):
    """Forward the sum over "sp"; backward the identity: every rank computes
    the same loss from the sum, so each passes its own upstream gradient
    on (an all-reduce there would multiply it by the group's size)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_sp(x: torch.Tensor, group) -> torch.Tensor:
    """Enter an "sp" region: x as it is; its gradient summed over the group
    (each rank's penalty sees only its own points).  group None: x."""
    return x if group is None else _CopyToSP.apply(x, group)


def reduce_from_sp(x: torch.Tensor, group) -> torch.Tensor:
    """Leave an "sp" region: x summed over the group, gradient passed on as
    it is.  group None: x."""
    return x if group is None else _ReduceFromSP.apply(x, group)


def _all_reduce(x: torch.Tensor, mesh: Optional[Mesh], op,
                axis: Optional[str]) -> torch.Tensor:
    if mesh is None:
        return x
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op, group=mesh.group(axis))
    return y


def global_sum(x: torch.Tensor, mesh: Optional[Mesh],
               axis: Optional[str] = None) -> torch.Tensor:
    """x summed elementwise over the mesh (or over ``axis`` of it)."""
    return _all_reduce(x, mesh, dist.ReduceOp.SUM, axis)


def global_min(x: torch.Tensor, mesh: Optional[Mesh],
               axis: Optional[str] = None) -> torch.Tensor:
    """x's elementwise minimum over the mesh (or over ``axis`` of it)."""
    return _all_reduce(x, mesh, dist.ReduceOp.MIN, axis)


def global_all(x: torch.Tensor, mesh: Optional[Mesh]) -> bool:
    """Whether x holds on every element of every rank (``jnp.all`` of a
    sharded array)."""
    ok = x.all().to(torch.int32)
    return obs.host_read(global_min(ok, mesh), bool)


def gather_dp(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The (B, …) whole of the (B/dp, …) blocks of the "dp" ranks, in
    scenario order, on every rank."""
    if mesh is None or mesh.dp == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.dp)]
    dist.all_gather(parts, x, group=mesh.dp_group)
    return torch.cat(parts, dim=0)
