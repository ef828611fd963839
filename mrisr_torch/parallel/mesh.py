"""Device meshes and sharding over ``torch.distributed`` (port of ``mrisr_tpu/parallel/mesh.py``).

One process a rank: the caller starts the processes and calls
``torch.distributed.init_process_group`` in each (gloo on the CPU, NCCL on
GPUs; ``parallel/dryrun.py`` does both).  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over every rank, with the axis
``"data"`` (and ``"model"`` for ``make_mesh_2d``).

* Data parallelism: a batch's dim 0 is cut over ``"data"``; each rank takes
  its rows (:func:`shard_batch`, :class:`BatchSharding`), parameters are
  broadcast from rank 0 (:func:`replicate_params`), and a training step
  averages its loss and gradients over ``"data"`` (:func:`average_gradients`,
  which the step factories apply when given ``mesh=``; one all-reduce of a
  flat buffer, which a CUDA graph can capture).
* Tensor parallelism (:func:`shard_params_tp`): each Conv2d and Linear whose
  output channels (dim 0 of the weight) number at least ``min_channels`` and
  divide by the ``"model"`` size keeps its rank's slice of them; the layer
  computes that slice and all-gathers the channels.  Its input passes an
  identity whose backward all-reduces the input gradient over ``"model"``
  (each rank's slice gives part of it), and the gather's backward keeps the
  rank's slice of the (replicated) output gradient, so every gradient equals
  the unsharded one.  ``torch.distributed.nn.functional.all_gather`` is not
  used: its backward sums the replicated output gradients over the ranks
  (the gradient times the ``"model"`` size), and its gloo form fails in a
  subgroup that lacks global rank 0.  DTensor's rules are not used either.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: int | None = None, axis: str = "data") -> DeviceMesh:
    """A 1-D mesh over the ``n_devices`` ranks of the process group (all of them by default)."""
    n = dist.get_world_size() if n_devices is None else n_devices
    if n != dist.get_world_size():
        raise ValueError(f"a mesh spans the whole process group: {n} devices asked, world size "
                         f"{dist.get_world_size()}")
    return init_device_mesh(_device_type(), (n,), mesh_dim_names=(axis,))


def make_mesh_2d(dp: int, mp: int, axes: tuple[str, str] = ("data", "model")) -> DeviceMesh:
    """A ``dp x mp`` mesh: ranks ``r`` at (``r // mp``, ``r % mp``)."""
    return init_device_mesh(_device_type(), (dp, mp), mesh_dim_names=axes)


def _axis(mesh: DeviceMesh, axis: str) -> tuple[int, int]:
    """(size, this rank's coordinate) of ``axis``."""
    return mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(axis)


@dataclass(frozen=True)
class BatchSharding:
    """Dim 0 cut over ``axis`` (the rest replicated): rank ``i`` of the axis holds rows ``[i n / k, (i + 1) n /
    k)`` of an ``n``-row batch."""

    mesh: DeviceMesh
    axis: str = "data"

    def rows(self, n: int) -> slice:
        k, i = _axis(self.mesh, self.axis)
        if n % k:
            raise ValueError(f"a batch of {n} rows does not split over {k} ranks of {self.axis!r}")
        return slice(i * n // k, (i + 1) * n // k)

    def shard(self, x):
        return torch.as_tensor(x)[self.rows(len(x))]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows, in rank order: the whole batch on every rank."""
        parts = [torch.empty_like(x) for _ in range(_axis(self.mesh, self.axis)[0])]
        dist.all_gather(parts, x.contiguous(), group=self.mesh.get_group(self.axis))
        return torch.cat(parts)


def batch_sharding(mesh: DeviceMesh, ndim: int | None = None, axis: str = "data") -> BatchSharding:
    """Shard dim 0 over ``axis``, replicate the rest (``ndim`` is the reference's and is not needed)."""
    return BatchSharding(mesh, axis)


def shard_batch(mesh: DeviceMesh, batch: Any, axis: str = "data") -> Any:
    """This rank's rows of every array in ``batch`` (a tensor or array, or a dict, list or tuple of them)."""
    sh = batch_sharding(mesh, axis=axis)
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v, axis) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v, axis) for v in batch)
    return sh.shard(batch)


@dataclass(frozen=True)
class Replicated:
    """Every rank holds the same tensor, rank 0's."""

    mesh: DeviceMesh

    def apply(self, t: torch.Tensor) -> torch.Tensor:
        src = int(self.mesh.mesh.flatten()[0])
        with torch.no_grad():
            dist.broadcast(t.data if isinstance(t, nn.Parameter) else t, src=src)
        return t


def replicated(mesh: DeviceMesh) -> Replicated:
    return Replicated(mesh)


def replicate_params(mesh: DeviceMesh, params):
    """Broadcast rank 0's parameters to every rank, in place: a module's parameters and buffers, or a
    ``name -> tensor`` dict.  Returns ``params``."""
    rep = replicated(mesh)
    tensors = list(params.values()) if isinstance(params, dict) else [*params.parameters(), *params.buffers()]
    for t in tensors:
        rep.apply(t)
    return params


def average_gradients(mesh: DeviceMesh, loss: torch.Tensor, grads: dict[str, torch.Tensor], axis: str = "data"):
    """``(loss, grads)`` averaged over ``axis`` (one all-reduce of a flat buffer): each rank's step on its
    rows then equals one step on the whole batch."""
    k, _ = _axis(mesh, axis)
    flat = torch.cat([loss.reshape(1).to(torch.float32)] + [g.reshape(-1).to(torch.float32) for g in grads.values()])
    dist.all_reduce(flat, group=mesh.get_group(axis))
    flat = flat / k
    out, at = {}, 1
    for name, g in grads.items():
        out[name] = flat[at : at + g.numel()].view_as(g).to(g.dtype)
        at += g.numel()
    return flat[0].to(loss.dtype), out


# ---------------------------------------------------------------------------
# Tensor parallelism over "model": output channels split
# ---------------------------------------------------------------------------


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward all-reduces the input gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherChannels(torch.autograd.Function):
    """All-gather the channel slices along ``dim``; the backward keeps this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, y, dim, group):
        ctx.dim, ctx.group = dim, group
        parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, y.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(n, ctx.dim)[r].contiguous(), None, None


def tp_param_sharding(mesh: DeviceMesh, min_channels: int = 64, axis: str = "model"):
    """The reference's rule as ``rule(weight) -> bool``: split a weight of two or more dims over ``axis`` when
    its output channels (dim 0 in torch) number at least ``min_channels`` and divide by the axis size."""
    mp, _ = _axis(mesh, axis)

    def rule(w: torch.Tensor) -> bool:
        return w.ndim >= 2 and w.shape[0] >= min_channels and w.shape[0] % mp == 0

    return rule


def shard_params_tp(mesh: DeviceMesh, module: nn.Module, min_channels: int = 64, axis: str = "model") -> list[str]:
    """Split ``module``'s Conv2d and Linear layers over ``axis`` by :func:`tp_param_sharding`, in place: each
    keeps its rank's slice of the output channels (weight and bias) and gathers its output.  Returns the names
    of the split layers."""
    rule = tp_param_sharding(mesh, min_channels, axis)
    mp, r = _axis(mesh, axis)
    group = mesh.get_group(axis)
    split = []
    for name, m in module.named_modules():
        if not isinstance(m, (nn.Conv2d, nn.Linear)) or not rule(m.weight):
            continue
        with torch.no_grad():
            m.weight = nn.Parameter(m.weight.chunk(mp, 0)[r].clone(), m.weight.requires_grad)
            if m.bias is not None:
                m.bias = nn.Parameter(m.bias.chunk(mp, 0)[r].clone(), m.bias.requires_grad)
        dim = 1 if isinstance(m, nn.Conv2d) else -1
        m.register_forward_pre_hook(lambda mod, args: (_CopyToModel.apply(args[0], group), *args[1:]))
        m.register_forward_hook(lambda mod, args, out, dim=dim: _GatherChannels.apply(out, dim, group))
        split.append(name)
    return split
