"""MultiLayerNetwork — the sequential model class.

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py``: ``init``,
``output``, ``_forward_carry``, ``_init_carries``, ``rnn_time_step``,
``rnn_clear_previous_state``, the per-row carry surgery
(``extract_carry_rows``/``merge_carry_rows``, ``multilayer.py:58-76``), and
training: ``fit_batch``, ``fit``, ``score``, ``evaluate``,
``save``/``load``.

One train step is what the JAX package's jitted ``train_step`` does, run
eagerly: forward, loss, ``torch.autograd.grad``, global-norm clipping and
each layer's updater. On the card every LSTM layer's forward and backward
run the fused-LSTM kernels (``ops/cuda/fused_lstm.py``), every GRU
layer's the fused-GRU kernels (``ops/cuda/fused_gru.py``), every
attention layer's the flash-attention kernels
(``ops/cuda/flash_attention.py``), and every LRN layer's the LRN kernels
(``ops/cuda/lrn.py``). Integer token ids (an embedding's input) pass
through as they are; a [B, T] padding mask reaches every layer, and the
attention layers take it as a key mask. Convolutional activations walk
the network as NHWC tensors, as in the JAX package.

Parameters are a list (one entry per layer) of dicts of tensors with the
JAX package's keys, on one device; ``opt_state`` mirrors them per updater.
``init`` defaults to ``device="cuda"`` and raises without a card. Weights
and optimizer state cross from the JAX package through
:func:`load_jax_params` and :func:`load_jax_opt_state`, or the model zip
(``util/serialization.py``), which both packages read and write.

A ``CenterLossOutputLayer`` head adds its center term to the loss and
moves its centers (layer state) every step, as the JAX train step does
(``nn/multilayer.py:232-245`` there): a per-example loss mask covers the
term and the update.

The training runtime around the step is the JAX package's:

- truncated BPTT (``tbptt_fwd_length``): the sequence in chunks, each a
  step from the carries the previous chunk left (detached), every chunk of
  one ``fit_batch`` at the same ``step_count``, the loss their mean;
- ``remat``: each layer's internals recomputed in the backward pass
  (``torch.utils.checkpoint``), the recompute replaying the dropout
  generator's draws of the forward (:func:`remat_apply`);
- fault plans (``faults``): the batch poisoned on the host before the step;
- the async fit loop (``optimize/async_dispatch.py``): ``fit_batch`` keeps
  the loss on the device and returns a lazy score, listeners see each
  (iteration, epoch, score) at drain time, ``fit`` drains before the
  epoch-end listeners; partial tail batches pad up to a pow2 bucket;
- ``evaluate``, ``feed_forward``, ``params_table``, the carry-row API.

Guardrails are not ported yet, and refused with ``NotImplementedError``
rather than trained around. Where the JAX fit loop reads the monitoring
layer, the port takes its monitoring-off branch until the monitoring
slice ports it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import faults
from deeplearning4j_tpu_torch.common.device import (
    DeviceLike, resolve_device, to_device,
)
from deeplearning4j_tpu_torch.common.dtypes import BF16, FLOAT32, cast_floating
from deeplearning4j_tpu_torch.common.env import env
from deeplearning4j_tpu_torch.common.trees import (
    tree_leaves, tree_map, tree_unflatten,
)
from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
from deeplearning4j_tpu_torch.nn.conf.builders import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers.base import resolve_activation
from deeplearning4j_tpu_torch.nn.layers.output import CenterLossOutputLayer
from deeplearning4j_tpu_torch.optimize.async_dispatch import (
    deliver_score, drain_scores, get_window, leading_dim, pad_tail_batch,
    supports_tail_padding,
)
from deeplearning4j_tpu_torch.optimize.updaters import NoOp, get_updater


def global_norm_clip(grads, max_norm):
    """Scale a gradient tree to at most ``max_norm`` global L2 norm (DL4J
    GradientNormalization.ClipL2PerParamType, global form)."""
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads)


def _layer_seed(seed: int, index: int) -> int:
    """Per-layer generator seed: distinct layers draw distinct streams."""
    return (int(seed) * 1_000_003 + index) & 0x7FFF_FFFF_FFFF_FFFF


def remat_apply(fn, rng, *args):
    """``fn(rng, *args)`` under ``torch.utils.checkpoint``: only the inputs
    are saved, and the backward pass recomputes the rest. The checkpoint
    restores the global RNG states, not an explicit generator, so a naive
    recompute would draw new dropout masks. Here the recompute draws from
    a generator set to ``rng``'s state before the forward ran, so it sees
    the forward's masks and leaves ``rng`` where the forward left it (the
    JAX package folds one key per layer for the same effect)."""
    from torch.utils.checkpoint import checkpoint

    snap = None if rng is None else rng.get_state()
    calls = [0]

    def run(*a):
        g = rng
        if calls[0] and rng is not None:
            g = torch.Generator(device=rng.device)
            g.set_state(snap)
        calls[0] += 1
        return fn(g, *a)

    return checkpoint(run, *args, use_reentrant=False)


def extract_carry_rows(carries, rows):
    """Per-row view of an rnn carry dict: {layer_idx: carry_tuple} with
    leaves [B, ...] -> the same structure with leaves [len(rows), ...].
    ``rows`` is an int or a sequence of row indices."""
    def take(a):
        idx = torch.as_tensor(np.atleast_1d(rows), dtype=torch.long,
                              device=a.device)
        return a.index_select(0, idx)

    return tree_map(take, carries)


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
    """Sequential network over a MultiLayerConfiguration."""

    def __init__(self, conf: MultiLayerConfiguration):
        if not conf.layer_input_types:
            conf.resolve()
        self.conf = conf
        self.layers = conf.layers
        self.params: list[dict] = []
        self.state: list[dict] = []
        self.opt_state: list[dict] = []
        self.step_count = 0
        self.epoch_count = 0
        self.score_value = float("nan")
        self.listeners: list = []
        self.device: Optional[torch.device] = None
        # frozen wins over any per-layer updater override
        self._updaters = [NoOp() if not l.trainable
                          else (get_updater(l.updater) if l.updater is not None
                                else conf.updater)
                          for l in self.layers]
        self._policy = BF16 if conf.dtype in ("bf16", "bfloat16") else FLOAT32
        self._rnn_carries = None
        self._rng: Optional[torch.Generator] = None  # dropout masks

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
        self.opt_state = [u.init_state(p)
                          for u, p in zip(self._updaters, self.params)]
        self.device = dev
        self._rnn_carries = None
        self._rng = None
        return self

    def to(self, device: DeviceLike) -> "MultiLayerNetwork":
        """Move parameters, state and stored carries to ``device``."""
        dev = resolve_device(device)
        drain_scores(self)
        move = lambda a: a.to(dev) if isinstance(a, torch.Tensor) else a
        self.params = tree_map(move, self.params)
        self.state = tree_map(move, self.state)
        self.opt_state = tree_map(move, self.opt_state)
        if self._rnn_carries is not None:
            self._rnn_carries = tree_map(move, self._rnn_carries)
        self.device = dev
        self._rng = None
        return self

    def num_params(self) -> int:
        return sum(int(a.numel()) for a in tree_leaves(self.params))

    def params_table(self) -> dict:
        """Flat {"0_W": tensor, ...} naming (MultiLayerNetwork.paramTable);
        a Bidirectional layer's entries are "<i>_fwd_W" and so on."""
        out = {}
        for i, p in enumerate(self.params):
            for k, v in p.items():
                if isinstance(v, dict):
                    for k2, v2 in v.items():
                        out[f"{i}_{k}_{k2}"] = v2
                else:
                    out[f"{i}_{k}"] = v
        return out

    def _generator(self) -> torch.Generator:
        """The dropout generator on the network's device, seeded from the
        configuration (a torch stream: not the JAX package's bits)."""
        if self._rng is None:
            self._rng = torch.Generator(device=self.device).manual_seed(
                _layer_seed(self.conf.seed, 0xD14))
        return self._rng

    def _input(self, x, cast: bool = True) -> torch.Tensor:
        """``x`` on the device, floating input in the compute type; with
        ``cast`` False it keeps its own type (f64 becomes f32, as
        ``jnp.asarray`` makes it), as ``score`` and ``rnn_time_step`` take it
        in the JAX package."""
        x = to_device(x, self.device)
        if x.is_floating_point():
            x = x.to(self._policy.compute_dtype if cast
                     else _canonical(x.dtype))
        return x

    def _compute_params(self):
        return cast_floating(self.params, self._policy.compute_dtype)

    def _activate(self, preout):
        out_layer = self.layers[-1]
        if hasattr(out_layer, "preout"):
            preout = resolve_activation(out_layer.activation)(preout)
        return preout.to(self._policy.output_dtype)

    def _mask(self, m):
        return None if m is None else to_device(m, self.device).float()

    def _labels(self, y) -> torch.Tensor:
        y = to_device(y, self.device)
        return y.float() if y.is_floating_point() else y

    # --------------------------------------------------------------- forward
    def _forward(self, params, state, x, mask, train=False, rng=None):
        """Walk layers; returns (the final layer's pre-output, the state
        each layer returns, the final mask, the final layer's input). In
        training a layer with running statistics returns them moved
        (BatchNormalization); the others return their state as it was.
        With ``remat`` each training layer runs under :func:`remat_apply`
        (the JAX package's ``jax.checkpoint`` of every layer)."""
        new_states = []
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            if i in self.conf.preprocessors:
                x = self.conf.preprocessors[i](x)
            if i == n - 1 and hasattr(layer, "preout"):
                x = layer._maybe_dropout(x, train, rng)
                new_states.append(state[i])
                return layer.preout(params[i], x), new_states, mask, x
            if self.conf.remat and train:
                x, st = remat_apply(
                    lambda g, p, s, xx, _l=layer, _m=mask: _l.apply(
                        p, s, xx, train=True, rng=g, mask=_m),
                    rng, params[i], state[i], x)
            else:
                x, st = layer.apply(params[i], state[i], x, train=train,
                                    rng=rng, mask=mask)
            new_states.append(st)
            mask = layer.feed_forward_mask(mask, self.conf.layer_input_types[i])
        return x, new_states, mask, x

    @torch.no_grad()
    def feed_forward(self, x, train: bool = False):
        """Every layer's activation, the input first
        (MultiLayerNetwork.feedForward): uncast params and input, and no
        mask, as in the JAX package; ``train`` runs training-mode layers
        (dropout from the network's generator)."""
        x = self._input(x, cast=False)
        rng = self._generator() if train else None
        acts = [x]
        for i, layer in enumerate(self.layers):
            if i in self.conf.preprocessors:
                x = self.conf.preprocessors[i](x)
            x, _ = layer.apply(self.params[i], self.state[i], x, train=train,
                               rng=rng, mask=None)
            acts.append(x)
        return acts

    @torch.no_grad()
    def output(self, x, mask=None):
        """Inference forward pass. ``mask``: optional [B, T] padding mask."""
        preout, _, _, _ = self._forward(self._compute_params(), self.state,
                                        self._input(x), self._mask(mask))
        return self._activate(preout)

    # --------------------------------------------------- carried recurrence
    def _walk_carry(self, params, state, x, carries, mask=None, train=False,
                    rng=None):
        """_forward threading explicit RNN carries (tBPTT, rnn_time_step).
        carries: {layer_idx: carry_tuple}; returns (preout, new_states,
        the final mask, the final layer's input, new_carries). A carried
        layer takes its dropout on its input, then its carry."""
        new_states, new_carries = [], {}
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            if i in self.conf.preprocessors:
                x = self.conf.preprocessors[i](x)
            if i == n - 1 and hasattr(layer, "preout"):
                x = layer._maybe_dropout(x, train, rng)
                new_states.append(state[i])
                return (layer.preout(params[i], x), new_states, mask, x,
                        new_carries)
            if i in carries and hasattr(layer, "apply_with_carry"):
                x = layer._maybe_dropout(x, train, rng)
                x, new_carries[i] = layer.apply_with_carry(
                    params[i], x, carries[i], mask=mask)
                new_states.append(state[i])
            else:
                x, st = layer.apply(params[i], state[i], x, train=train,
                                    rng=rng, mask=mask)
                new_states.append(st)
            mask = layer.feed_forward_mask(mask, self.conf.layer_input_types[i])
        return x, new_states, mask, x, new_carries

    def _forward_carry(self, params, state, x, carries, mask=None):
        """Inference walk with carries: (preout, new_states, new_carries)."""
        preout, new_states, _, _, new_carries = self._walk_carry(
            params, state, x, carries, mask)
        return preout, new_states, new_carries

    def _rnn_layer_indices(self):
        return [i for i, l in enumerate(self.layers)
                if hasattr(l, "apply_with_carry")]

    def _init_carries(self, batch: int):
        """Zero carries in f32, whatever the compute type, as the JAX
        package's ``initial_carry`` makes them: a bf16 net's recurrence then
        computes in f32 (the recurrent ops' mixed-type contract)."""
        return {i: self.layers[i].initial_carry(batch, torch.float32,
                                                self.device)
                for i in self._rnn_layer_indices()}

    @torch.no_grad()
    def rnn_time_step(self, x):
        """Streaming inference with persisted RNN state. x [B, T, F] or
        [B, F] (single step). Returns the output activations for the new
        timesteps; the state persists until rnn_clear_previous_state().
        As in the JAX package, the params are cast to the compute type and
        x is not, and the carries start in f32, so in a bf16 net the
        recurrence and the layers after it compute in f32 over the bf16
        weights."""
        x = self._input(x, cast=False)
        single = x.dim() == 2
        if single:
            x = x[:, None, :]
        carries = self._rnn_carries
        if carries is not None:
            _check_carry_batch(carries, x.shape[0])
        else:
            carries = self._init_carries(x.shape[0])
        preout, _, new_carries = self._forward_carry(
            self._compute_params(), self.state, x, carries)
        merged = dict(carries)
        merged.update(new_carries)
        self._rnn_carries = merged
        out = self._activate(preout)
        return out[:, 0] if single and out.dim() == 3 else out

    def rnn_clear_previous_state(self):
        self._rnn_carries = None

    def rnn_get_carry_rows(self, rows):
        """The stored rnn_time_step state of batch rows ``rows`` (an int or
        a sequence) as a carry dict with leaves [len(rows), ...]. Raises if
        no state is stored yet."""
        if self._rnn_carries is None:
            raise ValueError("no stored rnn state; call rnn_time_step first")
        return extract_carry_rows(self._rnn_carries, rows)

    def rnn_set_carry_rows(self, rows, sub, batch: Optional[int] = None):
        """Merge per-row carries into the stored rnn_time_step state: a
        retiring sequence's rows are overwritten by a newcomer's without
        clearing the rest of the batch. With no stored state, ``batch``
        sizes a fresh zero carry to merge into."""
        carries = self._rnn_carries
        if carries is None:
            if batch is None:
                raise ValueError(
                    "no stored rnn state; pass batch= to size a fresh carry")
            carries = self._init_carries(batch)
        self._rnn_carries = merge_carry_rows(carries, sub, rows)
        return self._rnn_carries

    # ------------------------------------------------------------------- fit
    def _loss_terms(self, params, x, y, mask, label_mask=None, train=True,
                    rng=None, carries=None):
        """(mean loss of one forward plus the l1/l2 terms, the layers' new
        states), and with ``carries`` (tBPTT) the RNN layers start from
        them and their new carries come third. ``label_mask``, a loss mask
        distinct from the forward's (padding) mask, replaces it for the
        loss; a masked per-example loss is normalized by the mask's sum. A
        center-loss head adds its center term and returns its moved
        centers as its new state."""
        if carries is None:
            preout, new_states, out_mask, features = self._forward(
                params, self.state, x, mask, train=train, rng=rng)
        else:
            preout, new_states, out_mask, features, new_carries = (
                self._walk_carry(params, self.state, x, carries, mask,
                                 train=train, rng=rng))
        if label_mask is not None:
            out_mask = label_mask
        out_layer = self.layers[-1]
        per = out_layer.score_from_preout(y, preout, out_mask)
        if isinstance(out_layer, CenterLossOutputLayer):
            per, new_states[-1] = _center_term(
                out_layer, params[-1], self.state[-1], features, y, per,
                out_mask, preout.shape[0])
        if out_mask is not None and per.dim() == 1:
            loss = per.sum() / torch.clamp(out_mask.sum(), min=1.0)
        else:
            loss = per.mean()
        reg = sum(l.regularization(p) for l, p in zip(self.layers, params))
        if carries is None:
            return loss + reg, new_states
        return loss + reg, new_states, new_carries

    def _apply_updaters(self, grads, params, opt_state, step):
        """Clip (the configuration's global norm and updater clipnorm), then
        each updater's step. ``grads``, ``params``, ``opt_state`` and
        ``self._updaters`` are indexed alike: lists by layer here, dicts by
        vertex name in a ComputationGraph, which shares this method."""
        if self.conf.max_grad_norm > 0:
            grads = global_norm_clip(grads, self.conf.max_grad_norm)
        cn = float(getattr(self.conf.updater, "clipnorm", 0.0) or 0.0)
        if cn > 0:
            grads = global_norm_clip(grads, cn)
        keys = list(params) if isinstance(params, dict) else range(len(params))
        new_params, new_opt = {}, {}
        for i in keys:
            u = self._updaters[i]
            g = grads[i]
            # per-layer updater override: clip only that layer's subtree
            ucn = float(getattr(u, "clipnorm", 0.0) or 0.0)
            if ucn > 0 and u is not self.conf.updater:
                g = global_norm_clip(g, ucn)
            upd, ost = u.update(g, opt_state[i], params[i], step)
            new_params[i] = tree_map(lambda p, d: p - d, params[i], upd)
            new_opt[i] = ost
        if isinstance(params, dict):
            return new_params, new_opt
        return list(new_params.values()), list(new_opt.values())

    def _differentiable(self, params):
        """``params`` detached, each requiring a gradient unless autograd
        may skip it: a frozen layer's (its updater is NoOp, which drops its
        gradient, as XLA drops it from the JAX package's step), where no
        global-norm clip reads the whole tree (the JAX clip counts frozen
        gradients too, so they are formed then). A frozen trunk under a
        trainable head then runs no backward at all. Shared with
        ComputationGraph (dicts by vertex name)."""
        clip = (self.conf.max_grad_norm > 0 or float(
            getattr(self.conf.updater, "clipnorm", 0.0) or 0.0) > 0)
        keys = list(params) if isinstance(params, dict) else range(len(params))
        out = {}
        for k in keys:
            need = clip or not isinstance(self._updaters[k], NoOp)
            out[k] = tree_map(lambda p: p.detach().requires_grad_(need),
                              params[k])
        return out if isinstance(params, dict) else list(out.values())

    def _train_step(self, x, y, mask, label_mask, carries=None):
        """One step (forward, loss, backward, clip, update) on tensors
        already on the device; stores the layers' new states (the JAX
        step's ``new_states``) and returns the loss as a 0-d f32 tensor,
        and with ``carries`` (a tBPTT chunk) the new carries, detached: no
        gradient crosses a chunk boundary."""
        params = self._differentiable(self.params)
        out = self._loss_terms(
            cast_floating(params, self._policy.compute_dtype), x, y, mask,
            label_mask, train=True, rng=self._generator(), carries=carries)
        loss = out[0].float()
        grads = _grads(loss, tree_leaves(params))
        with torch.no_grad():
            self.params, self.opt_state = self._apply_updaters(
                tree_unflatten(self.params, grads), self.params,
                self.opt_state, self.step_count)
        self.state = tree_map(lambda a: a.detach(), out[1])
        if carries is None:
            return loss.detach()
        return loss.detach(), tree_map(lambda a: a.detach(), out[2])

    def _check_trainable(self):
        """Refuse the part of the JAX train step the port has not taken
        over, instead of training without it (shared with
        ComputationGraph)."""
        if env.guardrails:
            raise NotImplementedError("training guardrails are not ported yet")

    def _fit_tbptt(self, x, y, mask, label_mask):
        """Truncated BPTT over one batch: full chunks of
        ``tbptt_fwd_length``, then the trailing partial chunk, each one
        train step from the carries the chunk before left. Every chunk
        steps at the same ``step_count`` (the JAX package increments it
        once, after the loop), and the score is the chunks' mean loss,
        summed on the device: one host fetch a call."""
        L = self.conf.tbptt_fwd_length
        x, y = self._input(x), self._labels(y)
        mask, label_mask = self._mask(mask), self._mask(label_mask)
        T = x.shape[1]
        carries = self._init_carries(x.shape[0])
        starts = list(range(0, (T // L) * L, L))
        if T % L:
            starts.append((T // L) * L)
        total = None
        for s in starts:
            sl = slice(s, s + L)
            loss, carries = self._train_step(
                x[:, sl], y[:, sl], None if mask is None else mask[:, sl],
                None if label_mask is None else label_mask[:, sl], carries)
            total = loss if total is None else total + loss
        result = deliver_score(self, total / len(starts), get_window(self))
        self.step_count += 1
        return result

    def fit_batch(self, ds):
        """One optimization step on a DataSet-like object or a (features,
        labels[, mask[, labels_mask]]) tuple.

        Sync mode (``DL4J_TORCH_ASYNC_STEPS=0``, or a listener that needs
        eager scores) returns the step's loss as a float: the host waits
        for the device. Async mode (the default) returns a lazy
        ScoreHandle and keeps up to ``DL4J_TORCH_ASYNC_STEPS`` steps in
        flight; any numeric use of the handle (or reading ``score()``)
        drains to a float."""
        x, y, mask, label_mask = _unpack(ds)
        label_mask = _single_mask(label_mask)
        self._check_trainable()
        plan = faults.active()
        if plan is not None:
            # the numeric fault classes poison the host batch before the
            # step, so a retry replays the same poisoned bytes
            x, y = faults.poison_batch(plan, x, y, step=self.step_count)
        L = self.conf.tbptt_fwd_length
        if L > 0 and np.ndim(x) == 3 and np.shape(x)[1] > L:
            return self._fit_tbptt(x, y, mask, label_mask)
        if env.pad_tail:
            # partial epoch tails pad up to a pow2 bucket (loss-exact by a
            # zeroed labels mask), so the kernels' plan caches see few shapes
            b = leading_dim(x)
            max_b = getattr(self, "_fit_max_batch", 0)
            if b > max_b:
                self._fit_max_batch = b
            elif b < max_b and self._tail_padding_ok():
                x, y, mask, label_mask = pad_tail_batch(
                    x, y, mask, label_mask, max_b)
        window = get_window(self)
        # monitoring's phases wait for the monitoring slice: this is the
        # JAX package's monitoring-off branch
        loss = self._train_step(self._input(x), self._labels(y),
                                self._mask(mask), self._mask(label_mask))
        result = deliver_score(self, loss, window)
        self.step_count += 1
        return result

    def fit(self, data, labels=None, epochs: int = 1):
        """fit(iterator) or fit(features, labels) (MultiLayerNetwork.fit
        overloads). In-flight scores drain before the epoch-end listeners
        run, and before ``fit`` returns."""
        if labels is not None:
            try:
                for _ in range(epochs):
                    self.fit_batch((data, labels))
            except BaseException:
                drain_scores(self, suppress=True)
                raise
            drain_scores(self)
            for lst in self.listeners:
                lst.on_fit_end(self)
            return self
        for _ in range(epochs):
            for lst in self.listeners:
                lst.on_epoch_start(self, self.epoch_count)
            # monitoring's data-wait spans wait for the monitoring slice
            try:
                for ds in data:
                    self.fit_batch(ds)
            except BaseException:
                # best-effort drain; the batch loop's exception wins
                drain_scores(self, suppress=True)
                raise
            drain_scores(self)
            if hasattr(data, "reset"):
                data.reset()
            for lst in self.listeners:
                lst.on_epoch_end(self, self.epoch_count)
            self.epoch_count += 1
        for lst in self.listeners:
            lst.on_fit_end(self)
        return self

    def set_listeners(self, *listeners):
        self.listeners = list(listeners)
        return self

    # ----------------------------------------------------------------- score
    @property
    def score_value(self) -> float:
        """Latest training score. Under async dispatch reading it drains
        the in-flight window first: the value is that of the newest
        dispatched step, as in sync mode."""
        drain_scores(self)
        return self._score_value

    @score_value.setter
    def score_value(self, value: float) -> None:
        self._score_value = value

    def _tail_padding_ok(self) -> bool:
        ok = getattr(self, "_pad_ok", None)
        if ok is None:
            ok = self._pad_ok = supports_tail_padding(self.layers,
                                                     self.layers[-1:])
        return ok

    def score(self, ds=None) -> float:
        """Loss on a dataset without updating; with no dataset, the last
        training step's loss. As in the JAX package, the params and the
        input go in uncast, so a bf16 net scores in f32."""
        if ds is None:
            return self.score_value
        x, y, mask, label_mask = _unpack(ds)
        label_mask = _single_mask(label_mask)
        with torch.no_grad():
            loss, _ = self._loss_terms(self.params,
                                       self._input(x, cast=False),
                                       self._labels(y), self._mask(mask),
                                       self._mask(label_mask), train=False)
        return float(loss)

    # ------------------------------------------------------------------ eval
    def evaluate(self, iterator, evaluation=None) -> Evaluation:
        """Classification statistics of ``output()`` over the batches
        (MultiLayerNetwork.evaluate); the forward sees the padding mask,
        the statistics the labels mask (or the padding mask)."""
        ev = evaluation or Evaluation()
        for ds in iterator:
            x, y, mask, label_mask = _unpack(ds)
            label_mask = _single_mask(label_mask)
            out = self.output(x, mask=mask)
            ev.eval(host_array(y), host_array(out),
                    mask=host_array(label_mask if label_mask is not None
                                    else mask))
        if hasattr(iterator, "reset"):
            iterator.reset()
        return ev

    # ----------------------------------------------------------------- serde
    def save(self, path: str, save_updater: bool = True):
        from deeplearning4j_tpu_torch.util.serialization import write_model

        write_model(self, path, save_updater=save_updater)

    @staticmethod
    def load(path: str, load_updater: bool = True,
             device: DeviceLike = "cuda") -> "MultiLayerNetwork":
        from deeplearning4j_tpu_torch.util.serialization import (
            restore_multi_layer_network,
        )

        return restore_multi_layer_network(path, device=device,
                                           load_updater=load_updater)


def _grads(loss, leaves):
    """d loss / d leaf for every leaf that requires a gradient, zeros for
    the rest (frozen leaves, and leaves the loss does not reach)."""
    want = [p for p in leaves if p.requires_grad]
    got = iter(torch.autograd.grad(loss, want, allow_unused=True)
               if want else ())
    out = []
    for p in leaves:
        g = next(got) if p.requires_grad else None
        out.append(torch.zeros_like(p) if g is None else g)
    return out


def host_array(a):
    """``a`` as a host numpy array (a tensor on any device and of any
    floating type: bf16 widens to f32); None and arrays pass through."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.cpu().numpy()
    return a


def _center_term(layer, params, state, features, labels, per, out_mask, B):
    """A CenterLossOutputLayer's per-example loss ``per`` plus its center
    term, and its moved centers: a per-example loss mask (B entries)
    covers both, as in the JAX package."""
    cmask = None
    if out_mask is not None and out_mask.numel() == B:
        cmask = out_mask.reshape(B)
    cscore, cstate = layer.center_score_and_state(params, state, features,
                                                  labels, mask=cmask)
    return per + cscore, cstate


def _canonical(dtype: torch.dtype) -> torch.dtype:
    """A floating type as ``jnp.asarray`` leaves it with x64 off: f64
    becomes f32, the others stay."""
    return torch.float32 if dtype == torch.float64 else dtype


def _single_mask(lm):
    """A MultiLayerNetwork has one output: a per-output list/dict labels
    mask (a ComputationGraph shape) is refused."""
    if isinstance(lm, (list, tuple, dict)):
        raise ValueError(
            "per-output labels masks (list/dict) are a ComputationGraph/"
            "MultiDataSet shape; MultiLayerNetwork takes a single labels "
            "mask array")
    return lm


def _unpack(ds):
    """Accept DataSet-like (has .features/.labels), tuple, or dict. Returns
    (features, labels, mask, label_mask): ``mask`` is the forward's
    (padding) mask; ``label_mask`` is set only when a labels mask distinct
    from the features mask is given. A single mask plays both roles."""
    if hasattr(ds, "features"):
        fm = getattr(ds, "features_mask", None)
        lm = getattr(ds, "labels_mask", None)
        if fm is None:
            if isinstance(lm, (list, tuple, dict)):
                return ds.features, ds.labels, None, lm
            return ds.features, ds.labels, lm, None
        return ds.features, ds.labels, fm, lm
    if isinstance(ds, dict):
        return (ds["features"], ds["labels"], ds.get("mask"),
                ds.get("labels_mask"))
    if len(ds) == 4:
        return ds
    if len(ds) == 3:
        x, y, m = ds
        return x, y, m, None
    x, y = ds
    return x, y, None, None


def _tensors_like(mine, theirs, where: str):
    """``theirs`` (nested dicts/lists of arrays) as tensors of ``mine``'s
    structure, dtypes and device; keys and shapes must match."""
    if isinstance(mine, dict):
        if not isinstance(theirs, dict) or set(mine) != set(theirs):
            got = sorted(theirs) if isinstance(theirs, dict) else type(theirs)
            raise ValueError(f"{where}: keys {got} != {sorted(mine)}")
        return {k: _tensors_like(m, theirs[k], f"{where}/{k}")
                for k, m in mine.items()}
    if isinstance(mine, (list, tuple)):
        if len(theirs) != len(mine):
            raise ValueError(f"{where}: {len(theirs)} entries for "
                             f"{len(mine)}")
        return type(mine)(_tensors_like(m, t, f"{where}/{i}")
                          for i, (m, t) in enumerate(zip(mine, theirs)))
    arr = np.asarray(theirs)
    if tuple(arr.shape) != tuple(mine.shape):
        raise ValueError(f"{where}: shape {arr.shape} != {tuple(mine.shape)}")
    return torch.tensor(arr, dtype=mine.dtype, device=mine.device)


def load_jax_params(net, params, state=None):
    """Set ``net``'s parameters, and with ``state`` its layer state (the
    running statistics of BatchNormalization), from the JAX package's,
    e.g. ``jax.tree_util.tree_map(np.asarray, jax_net.params)``. For a
    MultiLayerNetwork each is a list (one per layer) of dicts of arrays,
    nested for a Bidirectional layer ({"fwd": {...}, "bwd": {...}}); for a
    ComputationGraph a dict keyed by vertex name. Keys and shapes must
    match the port's own."""
    for what, tree, mine in (("params", params, net.params),
                             ("state", state, net.state)):
        if (tree is not None and isinstance(mine, list)
                and len(tree) != len(mine)):
            raise ValueError(f"{len(tree)} layers of {what} for a "
                             f"{len(mine)}-layer network")
    net.params = _tensors_like(net.params, params, "params")
    if state is not None:
        net.state = _tensors_like(net.state, state, "state")
    return net


def load_jax_opt_state(net, opt_state, step_count: int = 0,
                       epoch_count: int = 0):
    """Set ``net``'s updater state and counters from the JAX package's
    (``jax_net.opt_state`` as numpy arrays, ``jax_net.step_count``), so a
    half-trained model goes on training where it stopped. The structure
    must match the port's own for the same configuration (a list by layer,
    or a dict by vertex name for a ComputationGraph)."""
    net.opt_state = _tensors_like(net.opt_state, opt_state, "opt_state")
    net.step_count = int(step_count)
    net.epoch_count = int(epoch_count)
    return net
