"""Pipeline parallelism: GPipe's microbatched stage loop.

Counterpart of ``deeplearning4j_tpu/parallel/pipeline.py``. The JAX package
runs one SPMD program over the "pipe" axis: each device holds one stage's
parameters, the microbatch activations rotate stage to stage with
``lax.ppermute`` inside a ``lax.fori_loop``, and ``jax.grad`` of the
pipelined forward is the pipelined backward (the transpose of the rotation
is the reverse rotation). Here each stage is a rank, and the same schedule
runs as a Python loop of ticks:

- ``n_micro + n_stages - 1`` ticks. At tick t stage 0 takes microbatch t
  (its index clipped, as JAX clips it) and every other stage takes the
  carry; the last stage has finished microbatch ``t - (n_stages - 1)``.
  Every stage computes at every tick, bubbles included: a bubble computes
  on a clipped feed or on the carry and its result is never written, as in
  JAX. :func:`gpipe_tick` and :func:`hetero_tick` are one stage's tick:
  (stage, t, the carry in, the stage's params) -> (out, write index).
- Between ticks the outputs rotate one rank on over "pipe"
  (``collectives.rotate``, differentiable; the rotation after the last tick
  is dropped on every rank, as its result is never read). After the last
  tick the last stage's outputs reach every rank through a sum of the
  ranks' masked outputs (``collectives.psum_replicated``: JAX's masked
  ``lax.psum``), so the output is replicated.
- The params enter replicated: every rank passes the whole stacked (or
  packed) tree and takes its own stage's slice; the backward gathers the
  stages' gradients into the whole tree on every rank (one all-gather a
  dtype), so ``torch.autograd.grad`` of a replicated loss gives what
  ``jax.grad`` gives.

The backward runs every rank's rotations in reverse tick order, one chain
per rank, so every rank reaches its collectives in the same order. Stage 0
takes the carry through ``torch.where`` (JAX's ``jnp.where(stage == 0,
feed, carry)``), and a non-last stage's final output through a ``where``
that never selects it: both keep what a rank receives on its own autograd
graph, so the rotation's backward runs on every rank.

``mesh=None`` replays every stage on the calling device, tick by tick: the
same ticks, the rotation as a move between the stages' carries, and the
broadcast as the same masked sum. That is the pipeline on one card, where
NCCL refuses two ranks.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.common.trees import (
    tree_leaves, tree_map, tree_unflatten,
)
from deeplearning4j_tpu_torch.parallel import collectives


def stack_stage_params(stage_params_list):
    """Per-stage param trees stacked along a new leading axis (one row a
    stage). All stages must share a param structure."""
    return tree_map(lambda *xs: torch.stack([torch.as_tensor(x)
                                             for x in xs]),
                    *stage_params_list)


class _TakeStage(torch.autograd.Function):
    """This rank's row of every stacked leaf; the backward gathers the
    rows' gradients into whole leaves on every rank (one all-gather a
    dtype, over a flat buffer)."""

    @staticmethod
    def forward(ctx, group, *leaves):
        ctx.group, ctx.device = group, leaves[0].device
        ctx.shapes = [tuple(a.shape) for a in leaves]
        ctx.dtypes = [a.dtype for a in leaves]
        r = dist.get_rank(group)
        return tuple(a[r].clone() for a in leaves)

    @staticmethod
    def backward(ctx, *grads):
        n = dist.get_world_size(ctx.group)
        grads = [torch.zeros(s[1:], dtype=d, device=ctx.device)
                 if g is None else g.contiguous()
                 for g, s, d in zip(grads, ctx.shapes, ctx.dtypes)]
        out = [None] * len(grads)
        by_dtype: dict = {}
        for i, g in enumerate(grads):
            by_dtype.setdefault(g.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = torch.cat([grads[i].reshape(-1) for i in idx])
            rows = [torch.empty_like(flat) for _ in range(n)]
            dist.all_gather(rows, flat, group=ctx.group)
            whole = torch.stack(rows)
            sizes = [grads[i].numel() for i in idx]
            for i, part in zip(idx, whole.split(sizes, dim=1)):
                out[i] = part.reshape(ctx.shapes[i])
        return (None,) + tuple(out)


def take_stage(tree, group):
    """This rank's stage of a stacked (or packed) tree, differentiable:
    the gradient is the whole tree's, gathered from every stage."""
    leaves = tree_leaves(tree)
    return tree_unflatten(tree, _TakeStage.apply(group, *leaves))


def _flags(stage: int, n_stages: int, device):
    """(stage == 0, False) as device scalars: ``torch.where`` selectors
    that keep both operands on the autograd graph."""
    first = torch.full((), stage == 0, dtype=torch.bool, device=device)
    return first, torch.zeros((), dtype=torch.bool, device=device)


def _write(outs, out, widx, t, total, n_stages, n_micro, never):
    """Store a tick's output: the last stage's finished microbatch at its
    index; any stage's output at the final tick, otherwise, through a
    ``where`` that never selects it (JAX's ``jnp.where(write, out,
    prev)``), so it stays on the rank's graph."""
    if widx is not None:
        outs[widx] = out
    elif t == total - 1:
        i = min(max(t - (n_stages - 1), 0), n_micro - 1)
        outs[i] = torch.where(never, out, outs[i])


def gpipe_tick(stage_fn: Callable, params, stage: int, n_stages: int,
               t: int, carry, micro, first):
    """One tick of stage ``stage`` of a GPipe: ``stage_fn`` on microbatch
    t (stage 0, its index clipped) or on ``carry`` (every other stage).
    ``micro`` is [n_micro, mb, ...]; ``first`` is ``stage == 0`` as a
    device bool scalar. Returns (out, the microbatch index the last stage
    writes, or None)."""
    n_micro = micro.shape[0]
    feed = micro[min(max(t, 0), n_micro - 1)]
    out = stage_fn(params, torch.where(first, feed, carry))
    widx = t - (n_stages - 1)
    return out, (widx if stage == n_stages - 1 and widx >= 0 else None)


def _run_rank(tick, group, n_micro, blank):
    """This rank's ticks: ``tick(stage, t, carry, first) -> (out, write
    index)``, the outputs rotated one rank on between ticks, the last
    stage's written outputs broadcast by a masked sum. ``blank`` is a zero
    carry."""
    stage, n_stages = dist.get_rank(group), dist.get_world_size(group)
    first, never = _flags(stage, n_stages, blank.device)
    carry = blank
    outs = [torch.zeros_like(blank) for _ in range(n_micro)]
    total = n_micro + n_stages - 1
    for t in range(total):
        out, widx = tick(stage, t, carry, first)
        _write(outs, out, widx, t, total, n_stages, n_micro, never)
        if t < total - 1:
            carry = collectives.rotate(out, group)
    last = float(stage == n_stages - 1)
    return collectives.psum_replicated(torch.stack(outs) * last, group)


def _replay(tick, n_stages, n_micro, blank):
    """Every stage's ticks of :func:`_run_rank` on this device, in the
    ranks' order: the rotation a move between the stages' carries, the
    broadcast the same masked sum."""
    flags = [_flags(s, n_stages, blank.device) for s in range(n_stages)]
    carries = [blank] * n_stages
    outs = [[torch.zeros_like(blank) for _ in range(n_micro)]
            for _ in range(n_stages)]
    total = n_micro + n_stages - 1
    for t in range(total):
        ticks = []
        for s in range(n_stages):
            out, widx = tick(s, t, carries[s], flags[s][0])
            _write(outs[s], out, widx, t, total, n_stages, n_micro,
                   flags[s][1])
            ticks.append(out)
        carries = [ticks[(s - 1) % n_stages] for s in range(n_stages)]
    return sum(torch.stack(o) * float(s == n_stages - 1)
               for s, o in enumerate(outs))


def _check_batch(x, n_micro):
    if x.shape[0] % n_micro:
        raise ValueError(f"batch {x.shape[0]} not divisible by "
                         f"{n_micro} microbatches")


class GPipe:
    """Microbatched pipeline over the mesh "pipe" axis.

    ``stage_fn(stage_params, x) -> y`` with ``y.shape == x.shape``;
    ``params`` stacked on a leading n_stages axis
    (:func:`stack_stage_params`), the same whole tree on every rank::

        pipe = GPipe(stage_fn, mesh, n_microbatches=4)
        y = pipe(stacked_params, x)        # every rank, the same x
        torch.autograd.grad(loss(y), ...)  # the pipelined backward

    ``mesh=None`` replays every stage on the calling device (one card).
    """

    def __init__(self, stage_fn: Callable, mesh, n_microbatches: int = 4,
                 axis: str = "pipe"):
        self.stage_fn = stage_fn
        self.mesh = mesh
        self.n_micro = n_microbatches
        self.axis = axis

    def __call__(self, stacked_params, x):
        lead = tree_leaves(stacked_params)[0].shape[0]
        n_stages = (lead if self.mesh is None
                    else collectives.axis_size(self.mesh, self.axis))
        if lead != n_stages:
            raise ValueError(f"params stacked for {lead} stages but mesh "
                             f"'{self.axis}' axis has {n_stages}")
        _check_batch(x, self.n_micro)
        micro = x.reshape((self.n_micro, x.shape[0] // self.n_micro)
                          + tuple(x.shape[1:]))
        blank = torch.zeros_like(micro[0])
        if self.mesh is None:
            params = [tree_map(lambda p, _s=s: p[_s], stacked_params)
                      for s in range(n_stages)]
            y = _replay(lambda s, t, c, f: gpipe_tick(
                self.stage_fn, params[s], s, n_stages, t, c, micro, f),
                n_stages, self.n_micro, blank)
        else:
            group = collectives.axis_group(self.mesh, self.axis)
            params = take_stage(stacked_params, group)
            y = _run_rank(lambda s, t, c, f: gpipe_tick(
                self.stage_fn, params, s, n_stages, t, c, micro, f),
                group, self.n_micro, blank)
        return y.reshape(x.shape)

    def sequential_reference(self, stacked_params, x):
        """The unpipelined equivalent: the stages in order on the whole
        batch."""
        n_stages = tree_leaves(stacked_params)[0].shape[0]
        for i in range(n_stages):
            x = self.stage_fn(tree_map(lambda q, _i=i: q[_i],
                                       stacked_params), x)
        return x


def pipeline_train_step(pipe, loss_fn: Callable, updater,
                        head_fn: Optional[Callable] = None):
    """A pipelined train step.

    ``loss_fn(y_pred, y) -> scalar``; ``head_fn(head_params, activations)
    -> y_pred`` (e.g. the output projection, run replicated after the
    pipeline). ``updater`` is any framework updater. Returns
    ``step(params, opt_state, step_i, x, y) -> (params, opt_state, loss)``
    with ``params = {"stages": stacked, "head": head_params or {}}`` and
    ``opt_state = updater.init_state(params)``; every rank runs it with the
    same arguments and holds the same result."""
    from deeplearning4j_tpu_torch.optimize.updaters import get_updater

    updater = get_updater(updater)

    def step(params, opt_state, step_i, x, y):
        leaves = [a.detach().requires_grad_(True)
                  for a in tree_leaves(params)]
        p = tree_unflatten(params, leaves)
        h = pipe(p["stages"], x)
        pred = head_fn(p.get("head", {}), h) if head_fn is not None else h
        loss = loss_fn(pred, y)
        grads = tree_unflatten(params, list(torch.autograd.grad(
            loss, leaves, allow_unused=True)))
        grads = tree_map(lambda g, a: torch.zeros_like(a) if g is None
                         else g, grads, params)
        with torch.no_grad():
            upd, opt_state = updater.update(grads, opt_state, params,
                                            int(step_i))
            params = tree_map(lambda a, d: a - d, params, upd)
        return params, opt_state, loss.detach()

    return step


# ------------------------------------------------------------ HeteroPipe
# Stages whose activation shapes and param structures differ (ResNet-50's
# four stage groups). Activations travel one f32 buffer padded to the
# largest microbatch activation, and each rank unpacks only its own row of
# a [n_stages, max_flat] f32 param buffer.


def _sorted_items(tree, path=()):
    """(path, leaf) in ``ravel_pytree``'s order: dict keys sorted, lists
    and tuples in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _sorted_items(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _sorted_items(v, path + (i,))
    else:
        yield path, tree


def _sorted_specs(template):
    """The (shape, dtype) leaves of a :func:`_template` in sorted order."""
    if _is_spec(template):
        return [template]
    if isinstance(template, dict):
        return [s for k in sorted(template)
                for s in _sorted_specs(template[k])]
    return [s for v in template for s in _sorted_specs(v)]


def _template(tree):
    """``tree``'s structure with each leaf replaced by (shape, dtype)."""
    return tree_map(lambda a: (tuple(a.shape), a.dtype), tree)


def _is_spec(t):
    return (isinstance(t, tuple) and len(t) == 2
            and isinstance(t[1], torch.dtype))


def _rebuild(template, values):
    """``template`` with its (shape, dtype) leaves taken, in sorted order,
    from the ``values`` iterator."""
    if _is_spec(template):
        return next(values)
    if isinstance(template, dict):
        out = {}
        for k in sorted(template):
            out[k] = _rebuild(template[k], values)
        return {k: out[k] for k in template}
    return type(template)(_rebuild(v, values) for v in template)


def pack_stage_params(stage_params_list):
    """Heterogeneous per-stage param trees packed into ([S, Lmax] f32
    buffer, metadata for :func:`unpack_stage_params`). Row s holds stage
    s's leaves raveled in ``ravel_pytree``'s order (dict keys sorted) and
    cast to f32, zero-padded to the longest row."""
    metas, vecs = [], []
    for p in stage_params_list:
        leaves = [torch.as_tensor(a) for _, a in _sorted_items(p)]
        dtype = (functools.reduce(torch.promote_types,
                                  [a.dtype for a in leaves])
                 if leaves else torch.float32)
        vec = (torch.cat([a.reshape(-1).to(dtype) for a in leaves])
               if leaves else torch.zeros(0))
        metas.append((_template(p), dtype, int(vec.numel())))
        vecs.append(vec.to(torch.float32))
    lmax = max((v.numel() for v in vecs), default=0)
    packed = torch.stack([torch.nn.functional.pad(v, (0, lmax - v.numel()))
                          for v in vecs])
    return packed, metas


def unpack_stage_params(row, meta):
    """One stage's tree rebuilt from its packed row (differentiable)."""
    template, dtype, size = meta
    specs = _sorted_specs(template)
    vec = row[:size].to(dtype)
    sizes = [math.prod(shape) for shape, _ in specs]
    parts = iter(part.reshape(shape).to(dt) for part, (shape, dt) in zip(
        vec.split(sizes), specs))
    return _rebuild(template, parts)


def hetero_tick(stage_fns, metas, shapes, row, stage: int, t: int, carry,
                micro_buf, first, mb: int):
    """One tick of stage ``stage`` of a HeteroPipe: its params unpacked
    from its ``row``, its input cut from the f32 buffer (microbatch t for
    stage 0, clipped, else ``carry``) and reshaped to ``shapes[stage]``,
    its output raveled to f32 and zero-padded to the buffer's length.
    Returns (out buffer, the index the last stage writes, or None)."""
    n_stages = len(stage_fns)
    flat = [mb * math.prod(s) for s in shapes]
    n_micro = micro_buf.shape[0]
    feed = micro_buf[min(max(t, 0), n_micro - 1)]
    buf = torch.where(first, feed, carry)
    p = unpack_stage_params(row, metas[stage])
    y = stage_fns[stage](p, buf[:flat[stage]].reshape(
        (mb,) + tuple(shapes[stage])))
    out = torch.nn.functional.pad(y.reshape(-1).to(torch.float32),
                                  (0, buf.numel() - flat[stage + 1]))
    widx = t - (n_stages - 1)
    return out, (widx if stage == n_stages - 1 and widx >= 0 else None)


class HeteroPipe:
    """Microbatched pipeline over "pipe" with heterogeneous stages.

    ``stage_fns``: one ``fn(stage_params, x) -> y`` a stage, each with its
    own param structure and activation shapes. ``shapes``: the
    per-microbatch-row activation shapes (no batch dim), ``shapes[s]`` the
    input of stage s and the last one the pipeline's output, n_stages + 1
    of them. Params come from :func:`pack_stage_params`, the whole packed
    buffer on every rank::

        packed, metas = pack_stage_params([p0, p1, p2, p3])
        pipe = HeteroPipe(stage_fns, metas, shapes, mesh, n_microbatches=4)
        y = pipe(packed, x)

    As in JAX, the packed params and the activations between stages are
    f32 whatever the net's type: a stage receives its params cast back to
    each leaf's own type and its input as the f32 buffer's values (a bf16
    activation becomes f32 exactly; a stage that computes in bf16 casts it
    back, as ``graph_stage_fn`` does), and the output is f32.
    ``mesh=None`` replays every stage on the calling device.
    """

    def __init__(self, stage_fns, metas, shapes, mesh,
                 n_microbatches: int = 4, axis: str = "pipe"):
        if len(shapes) != len(stage_fns) + 1:
            raise ValueError(f"shapes must list n_stages+1 activation "
                             f"shapes, got {len(shapes)} for "
                             f"{len(stage_fns)} stages")
        self.stage_fns = list(stage_fns)
        self.metas = list(metas)
        self.shapes = [tuple(s) for s in shapes]
        self.mesh = mesh
        self.n_micro = n_microbatches
        self.axis = axis

    def _buffers(self, x):
        mb = x.shape[0] // self.n_micro
        flat = [mb * math.prod(s) for s in self.shapes]
        bmax = max(flat)
        micro = x.reshape(self.n_micro, flat[0]).to(torch.float32)
        return mb, flat, torch.nn.functional.pad(micro, (0, bmax - flat[0]))

    def __call__(self, packed, x):
        n_stages = (collectives.axis_size(self.mesh, self.axis)
                    if self.mesh is not None else len(self.stage_fns))
        if len(self.stage_fns) != n_stages:
            raise ValueError(f"{len(self.stage_fns)} stages but mesh "
                             f"'{self.axis}' axis has {n_stages}")
        _check_batch(x, self.n_micro)
        mb, flat, micro = self._buffers(x)
        out_shape = (self.n_micro * mb,) + self.shapes[-1]

        def tick(rows):
            return lambda s, t, c, f: hetero_tick(
                self.stage_fns, self.metas, self.shapes, rows(s), s, t, c,
                micro, f, mb)

        blank = torch.zeros_like(micro[0])
        if self.mesh is None:
            y = _replay(tick(lambda s: packed[s]), n_stages, self.n_micro,
                        blank)
        else:
            group = collectives.axis_group(self.mesh, self.axis)
            (row,) = take_stage([packed], group)
            y = _run_rank(tick(lambda s: row), group, self.n_micro, blank)
        return y[:, :flat[-1]].reshape(out_shape)

    def sequential_reference(self, packed, x):
        """The unpipelined equivalent."""
        for s, fn in enumerate(self.stage_fns):
            x = fn(unpack_stage_params(packed[s], self.metas[s]), x)
        return x


def graph_stage_fn(model, names, entry):
    """``stage_fn(stage_params, x)`` applying a ComputationGraph vertex
    subsequence in topological order (the ResNet-50 pipeline's stages).

    ``names``: a contiguous topological slice whose only external
    dependency is ``entry`` (the previous stage's output vertex or a graph
    input); the stage returns the last name's activation. The network state
    (BatchNorm running statistics) is closed over: stages run
    inference-mode normalization. As ``output()`` does, the params are
    cast to the net's compute type, and so is a floating input (a bf16
    net's stage takes its f32 pipeline buffer back to bf16, exactly)."""
    from deeplearning4j_tpu_torch.common.dtypes import cast_floating

    conf = model.conf
    state = model.state
    compute = model._policy.compute_dtype
    names = list(names)
    name_set = set(names)
    for n in names:
        for dep in conf.vertex_inputs.get(n, []):
            if dep not in name_set and dep != entry:
                raise ValueError(
                    f"stage vertex '{n}' depends on '{dep}' outside the "
                    f"stage (entry is '{entry}'): stages must be "
                    f"contiguous cuts of the graph")

    def stage_fn(stage_params, x):
        if x.is_floating_point():
            x = x.to(compute)
        params = cast_floating(stage_params, compute)
        acts = {entry: x}
        for n in names:
            v = conf.vertices[n]
            ins = [acts[d] for d in conf.vertex_inputs.get(n, [])]
            if n in conf.preprocessors:
                ins = [conf.preprocessors[n](ins[0])]
            out, _ = v.apply(params.get(n, {}), state.get(n, {}), ins,
                             train=False)
            acts[n] = out
        return acts[names[-1]]

    return stage_fn


__all__ = ["GPipe", "HeteroPipe", "graph_stage_fn", "gpipe_tick",
           "hetero_tick", "pack_stage_params", "pipeline_train_step",
           "stack_stage_params", "take_stage", "unpack_stage_params"]
