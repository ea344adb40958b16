"""ComputationGraph — the DAG model class.

Counterpart of ``deeplearning4j_tpu/nn/graph.py``: ``init``, the walk of
the topological order (``_forward``, ``graph.py:103``), ``output``, the
loss over every output vertex with per-output label masks (``_loss``,
``:283``; ``_labels_masks_for``, ``:451``) and training: ``fit_batch``,
``fit``, ``score``, ``evaluate``, ``save``/``load``.

One train step is what the JAX package's jitted ``train_step`` (``:391``)
does, run eagerly: the forward, the loss, ``torch.autograd.grad``, the
global-norm clip and each vertex's updater (with its clipnorm override),
threading each layer's new state (BatchNormalization's running
statistics). The clip and updater step, the guarded variant of the step
and the dispatch to the guardrails and the monitoring phases are
MultiLayerNetwork's own (``nn/multilayer.py``).
Convolutional activations walk the graph as NHWC tensors (channels_last
views on the card), as in the JAX package.

Parameters, state and updater state are dicts keyed by vertex name, with
the JAX package's keys inside; only vertices with parameters (or state)
have an entry. ``init`` defaults to ``device="cuda"`` and raises without a
card. Weights and optimizer state cross from the JAX package through
:func:`load_jax_params` and :func:`load_jax_opt_state`, or the graph zip
(``util/serialization.py``), which both packages read and write.

The training runtime around the step is MultiLayerNetwork's: ``remat``
(each vertex under ``remat_apply``, the JAX package's ``jax.checkpoint``
of every vertex), fault plans, the async fit loop with listeners and tail
padding, ``evaluate`` (of the first output), ``score_value`` and
``rnn_time_step``, and the guardrails and monitoring of ``fit_batch``.
``quantize()`` returns the int8 inference view (``quantize/passes.py``),
which ``fit_batch`` refuses to train. ``as_loss_fn`` is the functional
surface of the parallel trainers. A ``CenterLossOutputLayer`` output adds
its center term and moves its centers every step
(``nn/graph.py:294,345-352`` there).
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
from deeplearning4j_tpu_torch.common.trees import tree_map
from deeplearning4j_tpu_torch.nn.conf.builders import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
from deeplearning4j_tpu_torch.nn.conf.graph import LayerVertex
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: F401 (re-exported)
    MultiLayerNetwork, _canonical, _center_term, _check_carry_batch, _grads,
    _layer_seed, _normalizer, _refuse_view, _unpack, host_array,
    load_jax_opt_state, load_jax_params, remat_apply,
)
from deeplearning4j_tpu_torch.nn.layers.output import CenterLossOutputLayer
from deeplearning4j_tpu_torch.optimize.async_dispatch import (
    leading_dim, pad_tail_batch, supports_tail_padding,
)
from deeplearning4j_tpu_torch.optimize.updaters import NoOp, get_updater


class ComputationGraph:
    """DAG network over a ComputationGraphConfiguration."""

    def __init__(self, conf: ComputationGraphConfiguration):
        if not conf.topological_order:
            conf.resolve()
        self.conf = conf
        self.params: dict = {}
        self.state: dict = {}
        self.opt_state: dict = {}
        self.step_count = 0
        self.epoch_count = 0
        self.score_value = float("nan")
        self.listeners: list = []
        self.device: Optional[torch.device] = None
        self._policy = BF16 if conf.dtype in ("bf16", "bfloat16") else FLOAT32
        self._updaters = {}
        for name, v in conf.vertices.items():
            if isinstance(v, LayerVertex):
                l = v.layer
                # frozen wins over any per-layer updater override
                self._updaters[name] = (NoOp() if not l.trainable
                                        else (get_updater(l.updater)
                                              if l.updater is not None
                                              else conf.updater))
            else:
                self._updaters[name] = conf.updater
        self._rng: Optional[torch.Generator] = None  # dropout masks
        self._rnn_carries = None

    # MultiLayerNetwork's clip and updater step (over dicts by vertex name
    # here) with its guarded variant, its dispatch of a step to the guard
    # or through the monitoring phases, its dropout generator, parameter
    # count, epoch loop with listeners, score and listener surface
    _apply_updaters = MultiLayerNetwork._apply_updaters
    _step_update = MultiLayerNetwork._step_update
    _step_and_deliver = MultiLayerNetwork._step_and_deliver
    _differentiable = MultiLayerNetwork._differentiable
    _generator = MultiLayerNetwork._generator
    num_params = MultiLayerNetwork.num_params
    fit = MultiLayerNetwork.fit
    set_listeners = MultiLayerNetwork.set_listeners
    score_value = MultiLayerNetwork.score_value

    # ------------------------------------------------------------------ init
    def init(self, seed: Optional[int] = None,
             device: DeviceLike = "cuda") -> "ComputationGraph":
        dev = resolve_device(device)
        seed = self.conf.seed if seed is None else seed
        self.params, self.state = {}, {}
        for i, name in enumerate(self.conf.topological_order):
            g = torch.Generator().manual_seed(_layer_seed(seed, i))
            p, s = self.conf.vertices[name].init(
                g, self._vertex_input_types(name), dev)
            if p:
                self.params[name] = p
            if s:
                self.state[name] = s
        self.opt_state = {n: self._updaters[n].init_state(p)
                          for n, p in self.params.items()}
        self.device = dev
        self._rng = None
        self._rnn_carries = None
        return self

    def _vertex_input_types(self, name):
        types = self.conf.vertex_output_types
        ins = []
        for dep in self.conf.vertex_inputs.get(name, []):
            t = types[dep]
            if name in self.conf.preprocessors:
                t = self.conf.preprocessors[name].output_type(t)
            ins.append(t)
        return ins

    def to(self, device: DeviceLike) -> "ComputationGraph":
        """Move parameters, state and updater state to ``device``."""
        dev = resolve_device(device)
        move = lambda a: a.to(dev) if isinstance(a, torch.Tensor) else a  # noqa: E731
        self.params = tree_map(move, self.params)
        self.state = tree_map(move, self.state)
        self.opt_state = tree_map(move, self.opt_state)
        self.device = dev
        self._rng = None
        return self

    # --------------------------------------------------------------- forward
    def _forward(self, params, state, inputs: dict, train, rng, masks=None,
                 want_preout=False):
        """Walk the topological order. Returns (dict name -> activation,
        the new state of each vertex that returned one, the output vertices'
        pre-outputs if ``want_preout``, and the input of each of those
        output vertices)."""
        acts = dict(inputs)
        new_state, preouts, out_feats = {}, {}, {}
        for name in self.conf.topological_order:
            v = self.conf.vertices[name]
            ins = [acts[d] for d in self.conf.vertex_inputs.get(name, [])]
            if name in self.conf.preprocessors:
                ins = [self.conf.preprocessors[name](ins[0])]
            p = params.get(name, {})
            s = state.get(name, {})
            if (want_preout and name in self.conf.network_outputs
                    and isinstance(v, LayerVertex)
                    and hasattr(v.layer, "preout")):
                out_feats[name] = ins[0]
                preouts[name] = acts[name] = v.layer.preout(p, ins[0])
                if s:
                    new_state[name] = s
                continue
            if self.conf.remat and train:
                out, s2 = remat_apply(
                    lambda g, pp, ss, ii, _v=v: _v.apply(
                        pp, ss, ii, train=True, rng=g, masks=masks),
                    rng, p, s, ins)
            else:
                out, s2 = v.apply(p, s, ins, train=train, rng=rng,
                                  masks=masks)
            acts[name] = out
            if s2:
                new_state[name] = s2
        return acts, new_state, preouts, out_feats

    def _as_input_dict(self, xs, cast: bool) -> dict:
        """The network inputs by name, on the device; floating inputs in the
        compute type when ``cast``, else in their own (f64 becomes f32)."""
        if not isinstance(xs, dict):
            if not isinstance(xs, (list, tuple)):
                xs = [xs]
            xs = dict(zip(self.conf.network_inputs, xs))
        out = {}
        for k, x in xs.items():
            x = to_device(x, self.device)
            if x.is_floating_point():
                x = x.to(self._policy.compute_dtype if cast
                         else _canonical(x.dtype))
            out[k] = x
        return out

    def _as_label_dict(self, y) -> dict:
        if not isinstance(y, dict):
            ys = y if isinstance(y, (list, tuple)) else [y]
            y = dict(zip(self.conf.network_outputs, ys))
        out = {}
        for k, v in y.items():
            v = to_device(v, self.device)
            out[k] = v.float() if v.is_floating_point() else v
        return out

    def _mask_list(self, mask):
        """The shared forward mask as the list the vertices take."""
        return (None if mask is None
                else [to_device(mask, self.device).float()])

    # ---------------------------------------------------------------- output
    @torch.no_grad()
    def output(self, *xs, mask=None):
        """Inference forward. As in the JAX package the params are cast to
        the compute type and the inputs are not. ``mask``: optional [B, T]
        padding mask threaded to every vertex."""
        inputs = self._as_input_dict(xs[0] if len(xs) == 1 else list(xs),
                                     cast=False)
        acts, _, _, _ = self._forward(
            cast_floating(self.params, self._policy.compute_dtype),
            self.state, inputs, False, None, masks=self._mask_list(mask))
        outs = [acts[n].to(self._policy.output_dtype)
                for n in self.conf.network_outputs]
        return outs[0] if len(outs) == 1 else outs

    def as_loss_fn(self, train: bool = False):
        """(loss_fn(params, state, rng, x, y, mask=None, label_mask=None,
        denom=None) -> (loss, new_state), (params, state)): the functional
        surface the parallel trainers take, over :meth:`_loss` (the
        MultiLayerNetwork counterpart's contract). ``x`` is one array for a
        single-input graph or a {input name: array} dict, ``y`` likewise
        for the outputs; ``label_mask`` covers every output. Vertices
        without a new state keep their entry, so the returned state has the
        input's structure."""
        conf = self.conf

        def loss_fn(params, state, rng, x, y, mask=None, label_mask=None,
                    denom=None):
            lms = (None if label_mask is None else
                   {n: to_device(label_mask, self.device).float()
                    for n in conf.network_outputs})
            loss, new_state = self._loss(
                params, state, self._as_input_dict(x, cast=False),
                self._as_label_dict(y), rng, self._mask_list(mask),
                labels_masks=lms, train=train, denom=denom)
            return loss, {k: new_state.get(k, s) for k, s in state.items()}

        return loss_fn, (self.params, self.state)

    # ------------------------------------------------------------------- fit
    def _loss(self, params, state, inputs, labels: dict, rng, masks,
              labels_masks=None, train=True, denom=None):
        """(the summed loss of every output plus the l1/l2 terms, the new
        state). ``masks``: the forward (features/padding) mask list the
        vertices take, whose first entry is also each output's default
        loss mask; ``labels_masks``: {output name: mask} overriding it per
        output ([B, T] for a sequence head, per-example [B] or [B, 1] for
        any other). A masked loss is normalized by its valid count, or by
        ``denom`` when given (``_normalizer``)."""
        acts, new_state, preouts, out_feats = self._forward(
            params, state, inputs, train, rng, masks=masks, want_preout=True)
        shared_mask = masks[0] if masks else None
        loss = 0.0
        for name in self.conf.network_outputs:
            v = self.conf.vertices[name]
            explicit = (labels_masks is not None
                        and labels_masks.get(name) is not None)
            out_mask = labels_masks[name] if explicit else shared_mask
            ref = preouts[name] if name in preouts else acts[name]
            if explicit:
                B = ref.shape[0]
                if ref.dim() == 3:
                    if tuple(out_mask.shape) != (B, ref.shape[1]):
                        raise ValueError(
                            f"labels mask for output '{name}' has shape "
                            f"{tuple(out_mask.shape)}; expected "
                            f"({B}, {ref.shape[1]}) for output shape "
                            f"{tuple(ref.shape)}")
                else:
                    if out_mask.numel() != B:
                        raise ValueError(
                            f"labels mask for output '{name}' has shape "
                            f"{tuple(out_mask.shape)}, not per-example for "
                            f"output shape {tuple(ref.shape)}")
                    out_mask = out_mask.reshape(B)
            elif (out_mask is not None and ref.dim() == 2
                    and out_mask.dim() == 2 and out_mask.shape[1] != 1):
                # the time axis collapsed upstream: the shared [B, T] mask
                # no longer applies to the per-example head
                out_mask = None
            per_example = explicit and ref.dim() != 3
            if name in preouts and hasattr(v.layer, "score_from_preout"):
                per = v.layer.score_from_preout(
                    labels[name], ref, None if per_example else out_mask)
                if per_example:
                    per = per * out_mask
                if isinstance(v.layer, CenterLossOutputLayer):
                    per, new_state[name] = _center_term(
                        v.layer, params.get(name, {}), state.get(name, {}),
                        out_feats[name], labels[name], per, out_mask,
                        ref.shape[0])
                if out_mask is not None and per.dim() == 1:
                    # masked per-sample sums normalized by the valid count
                    loss = loss + per.sum() / _normalizer(out_mask.sum(),
                                                          denom)
                else:
                    loss = loss + per.mean()
            else:
                d = acts[name] - labels[name]
                if out_mask is not None and d.dim() == 3:
                    w = out_mask[..., None]
                    loss = loss + ((d * d) * w).sum() / _normalizer(
                        w.sum(), denom, float(d.shape[-1]))
                elif explicit:
                    w = out_mask.reshape(d.shape[0], *([1] * (d.dim() - 1)))
                    loss = loss + ((d * d) * w).sum() / _normalizer(
                        w.sum(), denom, float(np.prod(d.shape[1:])))
                else:
                    loss = loss + (d * d).mean()
        for name, v in self.conf.vertices.items():
            if isinstance(v, LayerVertex) and name in params:
                loss = loss + v.layer.regularization(params[name])
        return loss, new_state

    def _labels_masks_for(self, mask, label_mask):
        """A DataSet/MultiDataSet labels mask as the per-output dict
        ``_loss`` takes, or None where it adds nothing to the shared
        forward mask: a single array (every output), or a per-output list
        or dict."""
        if label_mask is None:
            return None
        outs = self.conf.network_outputs
        on = lambda m: to_device(m, self.device).float()  # noqa: E731
        if isinstance(label_mask, dict):
            unknown = set(label_mask) - set(outs)
            if unknown:
                raise ValueError(
                    f"labels_mask keys {sorted(unknown)} are not network "
                    f"outputs {list(outs)}")
            d = {k: on(v) for k, v in label_mask.items() if v is not None}
        elif isinstance(label_mask, (list, tuple)):
            if len(label_mask) != len(outs):
                raise ValueError(
                    f"labels_mask list has {len(label_mask)} entries for "
                    f"{len(outs)} network outputs {list(outs)}")
            d = {n: on(v) for n, v in zip(outs, label_mask) if v is not None}
        else:
            if label_mask is mask or (
                    mask is not None
                    and np.shape(mask) == np.shape(label_mask)
                    and _equal(mask, label_mask)):
                return None  # the shared path already covers it
            d = {n: on(label_mask) for n in outs}
        return d or None

    def _train_step(self, inputs, labels, masks, labels_masks, ctrl=None,
                    clip_active=False, step=None):
        """One step (forward, loss, backward, clip, update) on tensors
        already on the device; stores the vertices' new states and returns
        the loss as a 0-d f32 tensor. With ``ctrl`` it is the guarded step
        and returns (loss, health word), as MultiLayerNetwork's."""
        params = self._differentiable(self.params)
        loss, new_state = self._loss(
            cast_floating(params, self._policy.compute_dtype), self.state,
            inputs, labels, self._generator(), masks, labels_masks)
        for k, v in self.state.items():  # unchanged entries carry forward
            new_state.setdefault(k, v)
        loss, word = self._step_update(loss.float(), params, new_state, ctrl,
                                       clip_active, step)
        return loss if word is None else (loss, word)

    def _tail_padding_ok(self) -> bool:
        """Tail padding is loss-exact for a DAG iff no vertex computes
        cross-example batch statistics and every network output is a
        per-example-loss head (supports_tail_padding over the vertices)."""
        ok = getattr(self, "_pad_ok", None)
        if ok is None:
            vs = self.conf.vertices
            ok = self._pad_ok = supports_tail_padding(
                [v.layer for v in vs.values() if isinstance(v, LayerVertex)],
                [vs[n].layer if isinstance(vs[n], LayerVertex) else None
                 for n in self.conf.network_outputs])
        return ok

    def fit_batch(self, ds):
        """One optimization step on a DataSet/MultiDataSet-like object or a
        (features, labels[, mask[, labels_mask]]) tuple; features and labels
        are one array, a list in input/output order, or a dict by name.
        Sync mode returns the loss as a float, async mode (the default) a
        lazy ScoreHandle: see MultiLayerNetwork.fit_batch."""
        _refuse_view(self)
        x, y, mask, label_mask = _unpack(ds)
        plan = faults.active()
        if plan is not None:
            # the numeric fault classes poison the host batch before the step
            x, y = faults.poison_batch(plan, x, y, step=self.step_count)
        if env.pad_tail and not isinstance(y, (list, tuple, dict)):
            # pad partial epoch tails up to a pow2 bucket (loss-exact by a
            # zeroed labels mask); multi-input x pads per entry, but a
            # per-output labels list or dict keeps its raw shape
            b = leading_dim(x)
            max_b = getattr(self, "_fit_max_batch", 0)
            if b > max_b:
                self._fit_max_batch = b
            elif b < max_b and self._tail_padding_ok():
                x, y, mask, label_mask = pad_tail_batch(
                    x, y, mask, label_mask, max_b)
        return self._step_and_deliver(
            (self._as_input_dict(x, cast=True), self._as_label_dict(y)),
            (self._mask_list(mask), self._labels_masks_for(mask, label_mask)))

    def score(self, ds=None) -> float:
        """Loss on a batch without updating; with no batch, the last
        training step's loss. Masks route as in ``fit_batch``; the params
        and the inputs are cast to the compute type, as in the JAX
        package."""
        if ds is None:
            return self.score_value
        x, y, mask, label_mask = _unpack(ds)
        with torch.no_grad():
            loss, _ = self._loss(
                cast_floating(self.params, self._policy.compute_dtype),
                self.state, self._as_input_dict(x, cast=True),
                self._as_label_dict(y), None, self._mask_list(mask),
                self._labels_masks_for(mask, label_mask), train=False)
        return float(loss)

    # ------------------------------------------------------------------ eval
    def evaluate(self, iterator, evaluation=None) -> Evaluation:
        """Classification statistics of the first output over the batches
        (ComputationGraph.evaluate): the forward sees the padding mask, the
        statistics that output's labels mask (validated as ``fit_batch``
        validates it) or the padding mask."""
        ev = evaluation or Evaluation()
        for ds in iterator:
            x, y, mask, label_mask = _unpack(ds)
            out = self.output(x, mask=mask)
            if isinstance(out, list):
                out = out[0]
                y = y[0] if isinstance(y, (list, tuple)) else y
            lms = self._labels_masks_for(mask, label_mask)
            lm = None if lms is None else lms.get(self.conf.network_outputs[0])
            ev.eval(host_array(y), host_array(out),
                    mask=host_array(lm if lm is not None else mask))
        if hasattr(iterator, "reset"):
            iterator.reset()
        return ev

    # --------------------------------------------------------- rnnTimeStep
    def _rnn_vertices(self):
        return [name for name, v in self.conf.vertices.items()
                if isinstance(v, LayerVertex)
                and hasattr(v.layer, "apply_with_carry")]

    def _init_carries(self, batch: int):
        """Zero carries in f32, as the JAX package's ``initial_carry``."""
        return {name: self.conf.vertices[name].layer.initial_carry(
                    batch, torch.float32, self.device)
                for name in self._rnn_vertices()}

    def _forward_carries(self, params, state, inputs, carries):
        """The topological walk threading explicit RNN carries (the
        ComputationGraph.rnnTimeStep walk): (outputs, new carries)."""
        acts = dict(inputs)
        new_carries = {}
        for name in self.conf.topological_order:
            v = self.conf.vertices[name]
            ins = [acts[d] for d in self.conf.vertex_inputs.get(name, [])]
            if name in self.conf.preprocessors:
                ins = [self.conf.preprocessors[name](ins[0])]
            p = params.get(name, {})
            if name in carries:
                acts[name], new_carries[name] = v.layer.apply_with_carry(
                    p, ins[0], carries[name])
            else:
                acts[name], _ = v.apply(p, state.get(name, {}), ins,
                                        train=False)
        return [acts[n] for n in self.conf.network_outputs], new_carries

    @torch.no_grad()
    def rnn_time_step(self, *xs):
        """Streaming inference with persisted RNN state
        (ComputationGraph.rnnTimeStep). Inputs [B, T, F] or [B, F] (single
        step); the state persists until rnn_clear_previous_state(). The
        params are cast to the compute type and the inputs are not, and
        the carries start in f32, as in the JAX package."""
        inputs = self._as_input_dict(xs[0] if len(xs) == 1 else list(xs),
                                     cast=False)
        single = all(v.dim() == 2 for v in inputs.values())
        if single:
            inputs = {k: v[:, None, :] for k, v in inputs.items()}
        batch = next(iter(inputs.values())).shape[0]
        carries = self._rnn_carries
        if carries is not None:
            _check_carry_batch(carries, batch)
        else:
            carries = self._init_carries(batch)
        outs, new_carries = self._forward_carries(
            cast_floating(self.params, self._policy.compute_dtype),
            self.state, inputs, carries)
        # the walk visits every rnn vertex, so new_carries is complete
        self._rnn_carries = new_carries
        outs = [o.to(self._policy.output_dtype) for o in outs]
        if single:
            outs = [o[:, 0] if o.dim() == 3 else o for o in outs]
        return outs[0] if len(outs) == 1 else outs

    def rnn_clear_previous_state(self):
        self._rnn_carries = None

    # ------------------------------------------------------------- quantize
    def quantize(self, dtype: str = "int8") -> "ComputationGraph":
        """Weight-only int8 inference view of this graph (the original
        stays trainable); see ``deeplearning4j_tpu_torch.quantize``."""
        from deeplearning4j_tpu_torch.quantize import quantize_network

        return quantize_network(self, dtype)

    # ----------------------------------------------------------------- serde
    def save(self, path: str, save_updater: bool = True):
        from deeplearning4j_tpu_torch.util.serialization import write_model

        write_model(self, path, save_updater=save_updater)

    @staticmethod
    def load(path: str, load_updater: bool = True,
             device: DeviceLike = "cuda") -> "ComputationGraph":
        from deeplearning4j_tpu_torch.util.serialization import (
            restore_computation_graph,
        )

        return restore_computation_graph(path, device=device,
                                         load_updater=load_updater)


def _equal(a, b) -> bool:
    """Elementwise equality of two masks: on the host for host arrays, as
    the JAX package compares them; tensors compare where they lie."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        return bool(torch.equal(a.to(b.device, b.dtype), b))
    return bool(np.array_equal(np.asarray(a), np.asarray(b)))
