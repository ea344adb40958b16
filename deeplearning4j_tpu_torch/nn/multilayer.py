"""MultiLayerNetwork — the sequential model class, inference half.

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py``: ``init``,
``output``, ``_forward_carry``, ``_init_carries``, ``rnn_time_step``,
``rnn_clear_previous_state`` and the per-row carry surgery
(``extract_carry_rows``/``merge_carry_rows``, ``multilayer.py:58-76``).
Training (``fit``) comes with the training slice.

Parameters are a list (one entry per layer) of dicts of tensors with the
JAX package's keys, on one device. ``init`` defaults to ``device="cuda"``
and raises without a card. Weights cross from the JAX package through
:func:`load_jax_params` (or the model zip, ``util/serialization.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.common.device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.common.dtypes import BF16, FLOAT32, cast_floating
from deeplearning4j_tpu_torch.nn.conf.builders import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers.base import resolve_activation


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def _layer_seed(seed: int, index: int) -> int:
    """Per-layer generator seed: distinct layers draw distinct streams."""
    return (int(seed) * 1_000_003 + index) & 0x7FFF_FFFF_FFFF_FFFF


def extract_carry_rows(carries, rows):
    """Per-row view of an rnn carry dict: {layer_idx: carry_tuple} with
    leaves [B, ...] -> the same structure with leaves [len(rows), ...].
    ``rows`` is an int or a sequence of row indices."""
    def take(a):
        idx = torch.as_tensor(np.atleast_1d(rows), dtype=torch.long,
                              device=a.device)
        return a.index_select(0, idx)

    return _map_tree(take, carries)


def merge_carry_rows(carries, sub, rows):
    """Inverse of :func:`extract_carry_rows`: ``sub``'s rows written into a
    copy of ``carries`` at ``rows`` (the inputs are not mutated)."""
    out = {}
    for layer, carry in carries.items():
        merged = []
        for a, r in zip(carry, sub[layer]):
            idx = torch.as_tensor(np.atleast_1d(rows), dtype=torch.long,
                                  device=a.device)
            merged.append(a.index_copy(0, idx, r.to(a.dtype)))
        out[layer] = tuple(merged)
    return out


def _check_carry_batch(carries, batch: int):
    for c in carries.values():
        stored = c[0].shape[0]
        if stored != batch:
            raise ValueError(
                f"batch size changed between rnn_time_step calls "
                f"({batch} vs stored {stored}); call "
                f"rnn_clear_previous_state() first")


class MultiLayerNetwork:
    """Sequential network over a MultiLayerConfiguration (inference)."""

    def __init__(self, conf: MultiLayerConfiguration):
        if not conf.layer_input_types:
            conf.resolve()
        self.conf = conf
        self.layers = conf.layers
        self.params: list[dict] = []
        self.state: list[dict] = []
        self.device: Optional[torch.device] = None
        self._policy = BF16 if conf.dtype in ("bf16", "bfloat16") else FLOAT32
        self._rnn_carries = None

    # ------------------------------------------------------------------ init
    def init(self, seed: Optional[int] = None,
             device: DeviceLike = "cuda") -> "MultiLayerNetwork":
        dev = resolve_device(device)
        seed = self.conf.seed if seed is None else seed
        self.params, self.state = [], []
        for i, layer in enumerate(self.layers):
            g = torch.Generator().manual_seed(_layer_seed(seed, i))
            p, s = layer.init(g, self.conf.layer_input_types[i], dev)
            self.params.append(p)
            self.state.append(s)
        self.device = dev
        self._rnn_carries = None
        return self

    def to(self, device: DeviceLike) -> "MultiLayerNetwork":
        """Move parameters, state and stored carries to ``device``."""
        dev = resolve_device(device)
        move = lambda a: a.to(dev) if isinstance(a, torch.Tensor) else a
        self.params = _map_tree(move, self.params)
        self.state = _map_tree(move, self.state)
        if self._rnn_carries is not None:
            self._rnn_carries = _map_tree(move, self._rnn_carries)
        self.device = dev
        return self

    def _input(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, device=self.device)
        if x.is_floating_point():
            x = x.to(self._policy.compute_dtype)
        return x

    def _compute_params(self):
        return cast_floating(self.params, self._policy.compute_dtype)

    def _activate(self, preout):
        out_layer = self.layers[-1]
        if hasattr(out_layer, "preout"):
            preout = resolve_activation(out_layer.activation)(preout)
        return preout.to(self._policy.output_dtype)

    # --------------------------------------------------------------- forward
    def _forward(self, params, state, x, mask):
        """Walk layers; returns the final layer's pre-output."""
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            if i in self.conf.preprocessors:
                x = self.conf.preprocessors[i](x)
            if i == n - 1 and hasattr(layer, "preout"):
                return layer.preout(params[i], x)
            x, _ = layer.apply(params[i], state[i], x, mask=mask)
            mask = layer.feed_forward_mask(mask, self.conf.layer_input_types[i])
        return x

    @torch.no_grad()
    def output(self, x, mask=None):
        """Inference forward pass. ``mask``: optional [B, T] padding mask."""
        x = self._input(x)
        m = None if mask is None else torch.as_tensor(mask, device=self.device)
        return self._activate(
            self._forward(self._compute_params(), self.state, x, m))

    # --------------------------------------------------- carried recurrence
    def _forward_carry(self, params, state, x, carries, mask=None):
        """_forward threading explicit RNN carries. carries:
        {layer_idx: carry_tuple}; returns (preout, new_carries)."""
        new_carries = {}
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            if i in self.conf.preprocessors:
                x = self.conf.preprocessors[i](x)
            if i == n - 1 and hasattr(layer, "preout"):
                return layer.preout(params[i], x), new_carries
            if i in carries and hasattr(layer, "apply_with_carry"):
                x, new_carries[i] = layer.apply_with_carry(
                    params[i], x, carries[i], mask=mask)
            else:
                x, _ = layer.apply(params[i], state[i], x, mask=mask)
            mask = layer.feed_forward_mask(mask, self.conf.layer_input_types[i])
        return x, new_carries

    def _rnn_layer_indices(self):
        return [i for i, l in enumerate(self.layers)
                if hasattr(l, "apply_with_carry")]

    def _init_carries(self, batch: int):
        dt = self._policy.compute_dtype
        return {i: self.layers[i].initial_carry(batch, dt, self.device)
                for i in self._rnn_layer_indices()}

    @torch.no_grad()
    def rnn_time_step(self, x):
        """Streaming inference with persisted RNN state. x [B, T, F] or
        [B, F] (single step). Returns the output activations for the new
        timesteps; the state persists until rnn_clear_previous_state()."""
        x = self._input(x)
        single = x.dim() == 2
        if single:
            x = x[:, None, :]
        carries = self._rnn_carries
        if carries is not None:
            _check_carry_batch(carries, x.shape[0])
        else:
            carries = self._init_carries(x.shape[0])
        preout, new_carries = self._forward_carry(
            self._compute_params(), self.state, x, carries)
        merged = dict(carries)
        merged.update(new_carries)
        self._rnn_carries = merged
        out = self._activate(preout)
        return out[:, 0] if single and out.dim() == 3 else out

    def rnn_clear_previous_state(self):
        self._rnn_carries = None


def load_jax_params(net: MultiLayerNetwork, params) -> MultiLayerNetwork:
    """Set ``net``'s parameters from the JAX package's: ``params`` is a list
    (one per layer) of dicts of arrays, e.g. ``[{k: np.asarray(v) ...} for
    p in jax_net.params]``. Keys and shapes must match the port's own."""
    if len(params) != len(net.params):
        raise ValueError(f"{len(params)} layers of params for a "
                         f"{len(net.params)}-layer network")

    new = []
    for i, (mine, theirs) in enumerate(zip(net.params, params)):
        if set(mine) != set(theirs):
            raise ValueError(f"layer {i}: keys {sorted(theirs)} != "
                             f"{sorted(mine)}")
        layer = {}
        for k, m in mine.items():
            arr = np.asarray(theirs[k])
            if tuple(arr.shape) != tuple(m.shape):
                raise ValueError(f"param {i}/{k}: shape {arr.shape} != "
                                 f"{tuple(m.shape)}")
            layer[k] = torch.tensor(arr, dtype=m.dtype, device=m.device)
        new.append(layer)
    net.params = new
    return net
