"""Differentiable collectives over one axis of a mesh.

The JAX package's parallel modules run inside ``shard_map``, where
``lax.psum``, ``all_gather``, ``all_to_all``, ``ppermute`` and
``axis_index`` are traced and transposed by JAX (``parallel/_compat.py``
holds the version shims). The port's ranks are processes, so these are
``torch.autograd.Function``s over a process group, for the collectives that
sit inside a forward pass (BatchNorm statistics, tensor-parallel products,
MoE dispatch, the sequence-parallel rings).

Two conventions of what a gradient means, and an op for each:

- **Per-rank objectives** (data parallelism: each rank's loss is its own
  batch's, and the step averages the gradients): :func:`psum` sends its
  gradient back through a second sum, its transpose.
- **A replicated objective** (every rank computes the same loss from the
  same replicated tensors, as a ``shard_map`` with replicated in and out
  specs does): :func:`shard` takes this rank's slice and gathers the slices'
  gradients back; :func:`all_gather` gathers and gives back this rank's
  slice of the gradient; :func:`psum_replicated` sums partial results with
  the gradient passed through (Megatron's row all-reduce);
  :func:`replicate_grad` passes a replicated input through and sums the
  ranks' partial gradients (Megatron's column input).

:func:`all_to_all` and :func:`rotate` move each element to exactly one
place, so their transposes are the reverse moves under either convention.
A group of one rank still runs every collective but :func:`rotate`, which
has no neighbour to send to.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def axis_group(mesh, axis: str):
    """The process group of ``axis`` of a port ``DeviceMesh`` or a torch
    ``DeviceMesh`` (``multi_slice_mesh``)."""
    if hasattr(mesh, "get_group"):
        return mesh.get_group(axis)
    return mesh.group(axis)


def mesh_device(mesh) -> torch.device:
    """The rank's device of a port or torch ``DeviceMesh``."""
    if hasattr(mesh, "get_group"):
        return (torch.device("cuda", torch.cuda.current_device())
                if mesh.device_type == "cuda" else torch.device("cpu"))
    return mesh.device


def axis_size(mesh, axis: str) -> int:
    return dist.get_world_size(axis_group(mesh, axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return dist.get_rank(axis_group(mesh, axis))


def _slice(x, group, dim):
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"over {n} ranks")
    return x.chunk(n, dim)[r].contiguous()


def _gather(x, group, dim):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def _sum(x, group):
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _PSumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReplicateGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.group, ctx.dim), None, None


def _all_to_all(x, group, split_dim, concat_dim):
    n = dist.get_world_size(group)
    parts = [p.contiguous() for p in x.chunk(n, split_dim)]
    inp = torch.stack(parts)
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return torch.cat(out.unbind(0), concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, concat_dim, split_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None


def _rotate(x, group, shift):
    n = dist.get_world_size(group)
    if n == 1:
        return x
    r = dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    to = dist.get_global_rank(group, (r + shift) % n)
    frm = dist.get_global_rank(group, (r - shift) % n)
    ops = [dist.P2POp(dist.isend, x, to, group),
           dist.P2POp(dist.irecv, out, frm, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _rotate(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _rotate(g, ctx.group, -ctx.shift), None, None


def psum(x, group):
    """Sum over the group; the gradient is summed too (per-rank
    objectives: ``lax.psum`` transposed)."""
    return _PSum.apply(x, group)


def pmean(x, group):
    return psum(x, group) / dist.get_world_size(group)


def psum_replicated(x, group):
    """Sum of the ranks' partial results, used replicated: the gradient
    passes through."""
    return _PSumReplicated.apply(x, group)


def replicate_grad(x, group):
    """``x`` as it is; its gradient is the sum of the ranks' partial
    gradients (a replicated input used on each rank's part of the work)."""
    return _ReplicateGrad.apply(x, group)


def shard(x, group, dim: int):
    """This rank's slice of a replicated ``x`` along ``dim``; the gradient
    gathers the slices' gradients."""
    return _Shard.apply(x, group, dim)


def all_gather(x, group, dim: int):
    """The ranks' ``x`` concatenated along ``dim`` in rank order, used
    replicated: the gradient is this rank's slice."""
    return _AllGather.apply(x, group, dim)


def all_to_all(x, group, split_dim: int, concat_dim: int):
    """``lax.all_to_all(tiled=True)``: ``x`` split into group-size chunks
    along ``split_dim``, chunk j sent to rank j, the received chunks
    concatenated along ``concat_dim`` in rank order."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def rotate(x, group, shift: int = 1):
    """The ring step: ``x`` sent to rank ``index + shift`` and the tensor
    of rank ``index - shift`` received (``batch_isend_irecv``)."""
    return _Rotate.apply(x, group, shift)
