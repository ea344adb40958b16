"""Graph vertices + GraphBuilder.

Counterpart of ``deeplearning4j_tpu/nn/conf/graph.py``: the eleven vertex
kinds of a ComputationGraph (``LayerVertex``, ``MergeVertex``,
``ElementWiseVertex``, ``SubsetVertex``, ``ScaleVertex``, ``ShiftVertex``,
``StackVertex``, ``UnstackVertex``, ``L2NormalizeVertex``,
``ReshapeVertex``, ``PreprocessorVertex``), their JSON records
(``vertex_to_dict``/``vertex_from_dict``) and ``GraphBuilder``. Same class
names, fields and defaults as the JAX package, so a graph configuration
written by either package loads in the other. A vertex's ``apply`` takes
and returns tensors; features and channels are on the last axis (NHWC),
as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer

VERTEX_REGISTRY: dict[str, type] = {}


def _register(cls):
    VERTEX_REGISTRY[cls.__name__] = cls
    return cls


@dataclasses.dataclass(frozen=True)
class GraphVertex:
    """A node of the ComputationGraph DAG. Vertices without a layer are
    functions of their inputs."""

    def init(self, generator, input_types: list, device):
        return {}, {}

    def apply(self, params, state, inputs: list, *, train=False, rng=None,
              masks=None):
        raise NotImplementedError

    def output_type(self, input_types: list) -> InputType:
        return input_types[0]


@_register
@dataclasses.dataclass(frozen=True)
class LayerVertex(GraphVertex):
    layer: Layer = None

    def init(self, generator, input_types, device):
        return self.layer.init(generator, input_types[0], device)

    def apply(self, params, state, inputs, *, train=False, rng=None,
              masks=None):
        m = masks[0] if masks else None
        return self.layer.apply(params, state, inputs[0], train=train,
                                rng=rng, mask=m)

    def output_type(self, input_types):
        return self.layer.output_type(input_types[0])


@_register
@dataclasses.dataclass(frozen=True)
class MergeVertex(GraphVertex):
    """Concatenate along features/channels (org...graph.MergeVertex)."""

    def apply(self, params, state, inputs, *, train=False, rng=None,
              masks=None):
        return torch.cat(inputs, dim=-1), state

    def output_type(self, input_types):
        t0 = input_types[0]
        total = sum(t.shape[-1] for t in input_types)
        return InputType(t0.kind, t0.shape[:-1] + (total,))


@_register
@dataclasses.dataclass(frozen=True)
class ElementWiseVertex(GraphVertex):
    """Add/Product/Subtract/Average/Max of inputs
    (org...graph.ElementWiseVertex): the residual connection of ResNet."""

    op: str = "add"

    def apply(self, params, state, inputs, *, train=False, rng=None,
              masks=None):
        o = self.op.lower()
        if o == "add":
            out = sum(inputs)
        elif o in ("product", "mul"):
            out = inputs[0]
            for x in inputs[1:]:
                out = out * x
        elif o == "subtract":
            out = inputs[0] - inputs[1]
        elif o in ("average", "avg"):
            out = sum(inputs) / len(inputs)
        elif o == "max":
            out = inputs[0]
            for x in inputs[1:]:
                out = torch.maximum(out, x)
        else:
            raise ValueError(f"unknown ElementWiseVertex op {self.op}")
        return out, state


@_register
@dataclasses.dataclass(frozen=True)
class SubsetVertex(GraphVertex):
    """Feature range [from, to], inclusive (org...graph.SubsetVertex)."""

    from_idx: int = 0
    to_idx: int = 0

    def apply(self, params, state, inputs, *, train=False, rng=None,
              masks=None):
        return inputs[0][..., self.from_idx:self.to_idx + 1], state

    def output_type(self, input_types):
        t = input_types[0]
        return InputType(t.kind,
                         t.shape[:-1] + (self.to_idx - self.from_idx + 1,))


@_register
@dataclasses.dataclass(frozen=True)
class ScaleVertex(GraphVertex):
    scale: float = 1.0

    def apply(self, params, state, inputs, *, train=False, rng=None,
              masks=None):
        return inputs[0] * self.scale, state


@_register
@dataclasses.dataclass(frozen=True)
class ShiftVertex(GraphVertex):
    shift: float = 0.0

    def apply(self, params, state, inputs, *, train=False, rng=None,
              masks=None):
        return inputs[0] + self.shift, state


@_register
@dataclasses.dataclass(frozen=True)
class StackVertex(GraphVertex):
    """Stack along the batch axis (org...graph.StackVertex)."""

    def apply(self, params, state, inputs, *, train=False, rng=None,
              masks=None):
        return torch.cat(inputs, dim=0), state


@_register
@dataclasses.dataclass(frozen=True)
class UnstackVertex(GraphVertex):
    """The ``from_idx``-th of ``stack_size`` equal batch slices."""

    from_idx: int = 0
    stack_size: int = 1

    def apply(self, params, state, inputs, *, train=False, rng=None,
              masks=None):
        x = inputs[0]
        n = x.shape[0] // self.stack_size
        return x[self.from_idx * n:(self.from_idx + 1) * n], state


@_register
@dataclasses.dataclass(frozen=True)
class L2NormalizeVertex(GraphVertex):
    eps: float = 1e-8

    def apply(self, params, state, inputs, *, train=False, rng=None,
              masks=None):
        x = inputs[0]
        return x / torch.sqrt((x * x).sum(-1, keepdim=True) + self.eps), state


@_register
@dataclasses.dataclass(frozen=True)
class ReshapeVertex(GraphVertex):
    shape: tuple = ()  # without batch

    def apply(self, params, state, inputs, *, train=False, rng=None,
              masks=None):
        x = inputs[0]
        return x.reshape((x.shape[0],) + tuple(self.shape)), state

    def output_type(self, input_types):
        if len(self.shape) == 1:
            return InputType.feed_forward(self.shape[0])
        if len(self.shape) == 3:
            return InputType.convolutional(*self.shape)
        if len(self.shape) == 2:
            return InputType.recurrent(self.shape[1], self.shape[0])
        return input_types[0]


@_register
@dataclasses.dataclass(frozen=True)
class PreprocessorVertex(GraphVertex):
    preprocessor: object = None

    def apply(self, params, state, inputs, *, train=False, rng=None,
              masks=None):
        return self.preprocessor(inputs[0]), state

    def output_type(self, input_types):
        return self.preprocessor.output_type(input_types[0])


def vertex_to_dict(v: GraphVertex) -> dict:
    d: dict = {"@vertex": type(v).__name__}
    if isinstance(v, LayerVertex):
        d["layer"] = v.layer.to_dict()
    elif isinstance(v, PreprocessorVertex):
        d["preprocessor"] = v.preprocessor.to_dict()
    else:
        for f in dataclasses.fields(v):
            val = getattr(v, f.name)
            d[f.name] = list(val) if isinstance(val, tuple) else val
    return d


def vertex_from_dict(d: dict) -> GraphVertex:
    from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
        InputPreProcessor,
    )

    d = dict(d)
    kind = d.pop("@vertex")
    if kind not in VERTEX_REGISTRY:
        raise ValueError(f"vertex '{kind}' is not ported yet; ported: "
                         f"{sorted(VERTEX_REGISTRY)}")
    cls = VERTEX_REGISTRY[kind]
    if cls is LayerVertex:
        return LayerVertex(layer=Layer.from_dict(d["layer"]))
    if cls is PreprocessorVertex:
        return PreprocessorVertex(
            preprocessor=InputPreProcessor.from_dict(d["preprocessor"]))
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in d.items()})


class GraphBuilder:
    """org.deeplearning4j.nn.conf.ComputationGraphConfiguration.GraphBuilder."""

    def __init__(self, base):
        self._base = base
        self._vertices: dict[str, GraphVertex] = {}
        self._inputs: dict[str, list[str]] = {}
        self._net_inputs: list[str] = []
        self._net_outputs: list[str] = []
        self._input_types: dict[str, InputType] = {}
        self._preprocessors: dict[str, object] = {}

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._net_inputs.extend(names)
        return self

    def set_input_types(self, **types) -> "GraphBuilder":
        self._input_types.update(types)
        return self

    def add_layer(self, name: str, layer: Layer, *inputs: str) -> "GraphBuilder":
        self._vertices[name] = LayerVertex(layer=layer)
        self._inputs[name] = list(inputs)
        return self

    def add_vertex(self, name: str, vertex: GraphVertex,
                   *inputs: str) -> "GraphBuilder":
        self._vertices[name] = vertex
        self._inputs[name] = list(inputs)
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._net_outputs = list(names)
        return self

    def add_preprocessor(self, name: str, preproc) -> "GraphBuilder":
        """Attach an InputPreProcessor to a vertex, applied to its single
        input before the vertex."""
        self._preprocessors[name] = preproc
        return self

    def build(self):
        from deeplearning4j_tpu_torch.nn.conf.builders import (
            ComputationGraphConfiguration,
        )

        conf = ComputationGraphConfiguration(
            vertices=self._vertices,
            vertex_inputs=self._inputs,
            network_inputs=self._net_inputs,
            network_outputs=self._net_outputs,
            input_types=self._input_types,
            seed=self._base._seed,
            updater=self._base._updater,
            dtype=self._base._dtype,
            max_grad_norm=self._base._max_grad_norm,
            remat=self._base._remat,
            preprocessors=dict(self._preprocessors),
        )
        return conf.resolve() if self._input_types else conf
