"""Tensor (model) parallelism: Megatron-style parameter sharding.

Counterpart of ``deeplearning4j_tpu/parallel/tensor_parallel.py``. The JAX
class gives each parameter a PartitionSpec over the mesh's "model" axis and
lets GSPMD partition the unchanged step: the specs are layout hints and the
result never depends on them. The rule table (:func:`default_rules`,
``_MEGATRON_ROLES``) is the JAX package's, verbatim, with specs as tuples
(``(None, "model")`` for ``P(None, "model")``, ``()`` replicated).

Here each rank of the "model" axis keeps its shard of each parameter
(:meth:`TensorParallel.place`: the slice along the spec's "model" dim, and
the updater state likewise), the updaters run on the shards, and the
forward computes from them so that the result does not depend on the specs
either:

- the role-table layers compute Megatron-style: the attention heads and the
  MLP's hidden units on the local column shards (the input's gradient
  summed over the ranks), one differentiable all-reduce after each
  row-parallel product (``Wo``, ``W2``), the row bias added after it; conv
  kernels split by output channel compute their channels and gather them
  (BatchNorm replicated);
- every other sharded parameter is all-gathered before use (its gradient is
  this rank's slice of the replicated gradient);
- the global-norm clip is over every shard: the "model" ranks sum their
  shards' squares.

A "data" axis beside "model" splits the batch, as ``ParallelWrapper``'s.
While a step runs the network's layers are wrapped (:class:`_ShardedLayer`)
and the step is under the tensor axis (``nn/replicas.py``).
"""

from __future__ import annotations

import contextlib
import copy
from typing import Callable, Optional

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.common.trees import tree_leaves, tree_unflatten
from deeplearning4j_tpu_torch.nn import replicas
from deeplearning4j_tpu_torch.nn.layers.attention import _attn_mask
from deeplearning4j_tpu_torch.nn.layers.base import resolve_activation
from deeplearning4j_tpu_torch.ops.registry import op
from deeplearning4j_tpu_torch.parallel.collectives import (
    all_gather, psum_replicated, replicate_grad,
)
from deeplearning4j_tpu_torch.parallel.data_parallel import DataAxis
from deeplearning4j_tpu_torch.parallel.mesh import DeviceMesh


def _col(ndim):  # shard last dim over "model"
    return (None,) * (ndim - 1) + ("model",)


def _row(ndim):  # shard first dim over "model"
    return ("model",) + (None,) * (ndim - 1)


# Structure-based Megatron role tables, keyed on the layer class and its
# own parameter roles (the JAX package's): QKV projections and the MLP
# up-projection column-parallel (their biases split with the columns), the
# attention output projection and the MLP down-projection row-parallel
# (their biases replicate: they add after the row all-reduce), norms
# replicated; conv kernels [kh, kw, cin, cout] split by output channel.
_MEGATRON_ROLES = {
    "TransformerEncoderLayer": {
        "Wq": "col", "Wk": "col", "Wv": "col", "W1": "col",
        "bq": "col", "bk": "col", "bv": "col", "b1": "col",
        "Wo": "row", "W2": "row", "bo": "rep", "b2": "rep",
        "ln1_g": "rep", "ln1_b": "rep", "ln2_g": "rep", "ln2_b": "rep",
    },
    "SelfAttentionLayer": {
        "Wq": "col", "Wk": "col", "Wv": "col", "Wo": "row",
    },
    "LearnedSelfAttentionLayer": {
        "Wq": "col", "Wk": "col", "Wv": "col", "Wo": "row", "Q": "rep",
    },
    "ConvolutionLayer": {"W": "col", "b": "col"},
    "SeparableConvolution2DLayer": {"dW": "rep", "pW": "col", "b": "col"},
    "Deconvolution2DLayer": {"W": "col", "b": "col"},
    "BatchNormalizationLayer": {"gamma": "rep", "beta": "rep"},
}

_ATTENTION = ("TransformerEncoderLayer", "SelfAttentionLayer",
              "LearnedSelfAttentionLayer")
_CONV = ("ConvolutionLayer", "SeparableConvolution2DLayer",
         "Deconvolution2DLayer")


def default_rules(layer, name: str, ndim: int) -> tuple:
    """Megatron-style default spec for one parameter: the structure-based
    role table for layers whose block structure is known, name heuristics
    for the rest."""
    cls = type(layer).__name__
    if ndim == 0:
        return ()
    roles = _MEGATRON_ROLES.get(cls)
    if roles is not None and name in roles:
        kind = roles[name]
        if kind == "col":
            return _col(ndim)
        if kind == "row":
            return _row(ndim)
        return ()
    if "Norm" in cls:
        return ()
    if name in ("Wo", "out_W", "proj_W"):  # attention output projection
        return _row(ndim)
    if name.startswith(("W", "kernel")) or name in ("gamma_w",):
        return _col(ndim)
    if name in ("b", "bias", "gb"):
        return _col(ndim)  # bias lives with column split
    if name.startswith("R"):  # recurrent kernels [H, 4H]: gate split
        return _col(ndim)
    return ()


def _model_dim(spec):
    return spec.index("model") if "model" in spec else None


def _map_named(fn, tree, name=None):
    """``fn(name, leaf)`` over a param dict (nested dicts keep the
    innermost key as the name)."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, k) for k, v in tree.items()}
    return fn(name, tree)


class TensorAxis(DataAxis):
    """The replicas context of a tensor-parallel step: the data axis's
    hooks, and the global-norm clips over every shard of the gradients."""

    def __init__(self, data_group, model_group, dims, clips):
        super().__init__(data_group)
        self.model_group = model_group
        self.dims = dims      # the params' "model" dims, None replicated
        self.clips = clips

    def reduce_step(self, loss, grads):
        """Average over the data axis, then apply the network's global-norm
        clips with the norm of the whole sharded tree; the step's own clips
        then see a tree already inside their limit and leave it."""
        loss, grads = super().reduce_step(loss, grads)
        leaves = tree_leaves(grads)
        dims = tree_leaves(self.dims)
        for max_norm in self.clips:
            sq = [(g.float() ** 2).sum() for g in leaves]
            rep = sum(s for s, d in zip(sq, dims) if d is None)
            shd = sum(s for s, d in zip(sq, dims) if d is not None)
            if torch.is_tensor(shd):
                dist.all_reduce(shd, group=self.model_group)
            norm = torch.sqrt(rep + shd)
            scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
            leaves = [g * scale for g in leaves]
        return loss, tree_unflatten(grads, leaves)


class _ShardedLayer:
    """A layer computing from its parameters' "model" shards: Megatron-style
    for the role-table layers (``megatron``), from all-gathered parameters
    otherwise. Every other attribute is the layer's."""

    def __init__(self, layer, dims, group, megatron):
        self._layer, self._dims, self._group = layer, dims, group
        self._n = dist.get_world_size(group)
        self._megatron = megatron

    def __getattr__(self, name):
        if name == "_layer":  # not set yet (copy, pickle)
            raise AttributeError(name)
        return getattr(self._layer, name)

    def _full(self, params, dims=None):
        dims = self._dims if dims is None else dims
        return {k: (self._full(v, dims[k]) if isinstance(v, dict)
                    else v if dims[k] is None
                    else all_gather(v, self._group, dims[k]))
                for k, v in params.items()}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        layer, g = self._layer, self._group
        if not self._megatron:
            return layer.apply(self._full(params), state, x, train=train,
                               rng=rng, mask=mask)
        cls = type(layer).__name__
        if cls in _CONV:
            y, st = layer.apply(params, state, replicate_grad(x, g),
                                train=train, rng=rng, mask=mask)
            return all_gather(y, g, y.dim() - 1), st
        heads = layer.n_heads // self._n
        p = params
        if cls == "TransformerEncoderLayer":
            return _encoder(layer, p, x, heads, g, train, rng, mask), state
        xq = x
        if cls == "LearnedSelfAttentionLayer":
            xq = p["Q"].expand((x.shape[0],) + tuple(p["Q"].shape))
        a = op("multi_head_attention")(
            replicate_grad(xq, g), replicate_grad(x, g), p["Wq"], p["Wk"],
            p["Wv"], p["Wo"], n_heads=heads,
            mask=_attn_mask(mask, xq.shape[1], x.shape[1]))
        return psum_replicated(a, g), state

    def regularization(self, params):
        if self._layer.l1 == 0.0 and self._layer.l2 == 0.0:
            return 0.0
        return self._layer.regularization(self._full(params))


class _ShardedOutputLayer(_ShardedLayer):
    """A sharded output layer: its pre-output from gathered params."""

    def preout(self, params, x):
        return self._layer.preout(self._full(params), x)


def _encoder(layer, p, x, heads, g, train, rng, mask):
    """``TransformerEncoderLayer.apply`` on the local heads and hidden
    units: each half's column products on the shards, one all-reduce after
    its row product, the replicated row bias after it."""
    am = _attn_mask(mask, x.shape[1], x.shape[1])
    h = replicate_grad(layer._ln(x, p, 1) if layer.pre_norm else x, g)
    a = op("multi_head_attention")(
        h, h, p["Wq"], p["Wk"], p["Wv"], p["Wo"], n_heads=heads, mask=am,
        causal=layer.causal, bq=p["bq"], bk=p["bk"], bv=p["bv"])
    x = x + layer._drop(psum_replicated(a, g) + p["bo"], train, rng)
    if not layer.pre_norm:
        x = layer._ln(x, p, 1)
    h = replicate_grad(layer._ln(x, p, 2) if layer.pre_norm else x, g)
    m = resolve_activation(layer.activation)(h @ p["W1"] + p["b1"]) @ p["W2"]
    x = x + layer._drop(psum_replicated(m, g) + p["b2"], train, rng)
    if not layer.pre_norm:
        x = layer._ln(x, p, 2)
    return x


def _megatron_ok(layer, specs, n) -> bool:
    """The layer's actual specs are its role table's, and the shards split
    the way its Megatron forward needs (whole heads; one conv group; an
    elementwise activation)."""
    cls = type(layer).__name__
    roles = _MEGATRON_ROLES.get(cls)
    if roles is None or cls == "BatchNormalizationLayer":
        return False
    for k, spec in specs.items():
        want = roles.get(k)
        kind = ("rep" if not spec else "col" if spec[-1] == "model"
                else "row")
        if want is None or kind != want:
            return False
    if cls in _ATTENTION:
        return layer.n_heads % n == 0
    return (getattr(layer, "groups", 1) == 1
            and str(layer.activation).lower() not in ("softmax",
                                                      "logsoftmax"))


class TensorParallel:
    """Shards a model's parameters over a mesh's "model" axis and trains it
    Megatron-style.

    Usage, in every rank::

        mesh = DeviceMesh(data=2, model=4)
        tp = TensorParallel(model, mesh)
        tp.fit_batch((x, y))

    ``rules(layer, param_name, ndim) -> spec tuple`` can override the
    defaults. Params whose dims do not divide the mesh axis are replicated.
    A per-layer updater's own clipnorm sees only its layer's shards.
    """

    def __init__(self, model, mesh: Optional[DeviceMesh] = None,
                 rules: Optional[Callable] = None):
        self.model = model
        self.mesh = mesh or DeviceMesh(
            model=dist.get_world_size(), device=model.device.type)
        self.rules = rules or default_rules
        self._placed = False

    # ------------------------------------------------------------- placement
    def _named_params(self):
        """(layer, param tree) pairs mirroring model.params, and the
        function rebuilding model.params' container from a list."""
        m = self.model
        if hasattr(m, "layers"):                    # MultiLayerNetwork
            return list(zip(m.layers, m.params)), list
        from deeplearning4j_tpu_torch.nn.conf.graph import LayerVertex

        names = list(m.params)                      # ComputationGraph
        pairs = []
        for n in names:
            v = m.conf.vertices[n]
            pairs.append((v.layer if isinstance(v, LayerVertex) else v,
                          m.params[n]))
        return pairs, lambda specs: dict(zip(names, specs))

    def param_specs(self):
        """Spec tuples mirroring model.params (a list for a
        MultiLayerNetwork, a dict by vertex name for a ComputationGraph)."""
        if self._placed:
            return self._specs
        pairs, rebuild = self._named_params()
        n = self.mesh.shape["model"]

        def spec_for(layer, name, leaf):
            s = tuple(self.rules(layer, name, leaf.dim()))
            d = _model_dim(s)
            return () if d is not None and leaf.shape[d] % n else s

        return rebuild([_map_named(
            lambda name, leaf, _l=layer: spec_for(_l, name, leaf), p)
            for layer, p in pairs])

    def place(self):
        """Keep this rank's shard of every parameter and of its updater
        state; wrap the layers for the sharded forward."""
        if self._placed:
            return self
        m = self.model
        if m.device.type != self.mesh.device_type:
            raise ValueError(f"the model is on {m.device}; the mesh runs on "
                             f"{self.mesh.device_type}")
        n, r = self.mesh.shape["model"], self.mesh.index("model")
        specs = self._specs = self.param_specs()
        keys = list(specs) if isinstance(specs, dict) else range(len(specs))
        dims = {k: _map_named(lambda _, s: _model_dim(s), specs[k])
                for k in keys}

        def take(a, d):
            return a if d is None else a.chunk(n, d)[r].contiguous()

        full = m.params
        new_params = {k: _zip_map(take, full[k], dims[k]) for k in keys}
        opt = {}
        for k in keys:
            # the updater state of the shards, cut from the full state
            # leaf by leaf where the shapes differ
            fresh = m._updaters[k].init_state(new_params[k])
            opt[k] = tree_unflatten(fresh, [
                a if tuple(a.shape) == tuple(b.shape)
                else _cut_like(a, b, r, n)
                for a, b in zip(tree_leaves(m.opt_state[k]),
                                tree_leaves(fresh))])
        as_list = isinstance(specs, list)
        m.params = [new_params[k] for k in keys] if as_list else new_params
        m.opt_state = [opt[k] for k in keys] if as_list else opt
        self._dims = [dims[k] for k in keys] if as_list else dims
        self._wrapped = self._wrap_layers(dims)
        conf = m.conf
        clips = [c for c in (conf.max_grad_norm, float(getattr(
            conf.updater, "clipnorm", 0.0) or 0.0)) if c > 0]
        self.axis = TensorAxis(self.mesh.group("data"),
                               self.mesh.group("model"), self._dims, clips)
        self._placed = True
        return self

    def _wrap_layers(self, dims):
        """The network's layers (or vertices) as sharded layers, where a
        layer has a sharded parameter."""
        m, g = self.model, self.mesh.group("model")
        n = self.mesh.shape["model"]

        def wrap(layer, d, specs):
            if not any(x is not None for x in tree_leaves(d)):
                return layer
            cls = (_ShardedOutputLayer if hasattr(layer, "preout")
                   else _ShardedLayer)
            return cls(layer, d, g, _megatron_ok(layer, specs, n))

        if hasattr(m, "layers"):
            return [wrap(l, dims[i], self._specs[i]) if i in dims else l
                    for i, l in enumerate(m.layers)]
        from deeplearning4j_tpu_torch.nn.conf.graph import LayerVertex

        out = dict(m.conf.vertices)
        for k in dims:
            v = out[k]
            if isinstance(v, LayerVertex):
                out[k] = copy.copy(v)
                object.__setattr__(out[k], "layer",
                                   wrap(v.layer, dims[k], self._specs[k]))
        return out

    @contextlib.contextmanager
    def _sharded(self):
        """The network walks its wrapped layers and steps under the tensor
        axis inside the block."""
        m = self.model
        if hasattr(m, "layers"):
            saved, m.layers = m.layers, self._wrapped
        else:
            saved = m.conf
            m.conf = copy.copy(saved)
            m.conf.vertices = self._wrapped
        try:
            with replicas.use(self.axis):
                yield
        finally:
            if hasattr(m, "layers"):
                m.layers = saved
            else:
                m.conf = saved

    # ---------------------------------------------------------------- train
    def fit_batch(self, ds):
        """One step on the global batch (the same on every rank); returns
        what the model's ``fit_batch`` returns."""
        self.place()
        from deeplearning4j_tpu_torch.nn.multilayer import _unpack

        x, y, mask, label_mask = _unpack(ds)
        batch = self.mesh.shard_batch((x, y, mask, label_mask))
        with self._sharded():
            return self.model.fit_batch(batch)

    def fit(self, data, epochs: int = 1):
        for _ in range(epochs):
            for ds in data:
                self.fit_batch(ds)
            if hasattr(data, "reset"):
                data.reset()
            self.model.epoch_count += 1
        return self.model

    def output(self, x):
        """The model's output on the global batch ``x``: each "data" rank's
        slice, gathered."""
        self.place()
        xl = self.mesh.shard_batch(x)
        with self._sharded():
            out = self.model.output(xl)
        return all_gather(out, self.mesh.group("data"), 0)


def _zip_map(fn, tree, dims):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, dims[k]) for k, v in tree.items()}
    return fn(tree, dims)


def _cut_like(full, shard, r, n):
    """This rank's piece of a full updater-state leaf, along the dim where
    its shard's shape differs."""
    d = next(i for i, (a, b) in enumerate(zip(full.shape, shard.shape))
             if a != b)
    return full.chunk(n, d)[r].contiguous()


__all__ = ["TensorParallel", "default_rules"]
