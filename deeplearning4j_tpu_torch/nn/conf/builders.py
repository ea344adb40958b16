"""Network configuration builders with JSON round-trip.

Counterpart of ``deeplearning4j_tpu/nn/conf/builders.py``:
``NeuralNetConfiguration`` -> ``ListBuilder`` -> ``MultiLayerConfiguration``
for a sequential network, and ``NeuralNetConfiguration.graph_builder`` ->
``GraphBuilder`` (``nn/conf/graph.py``) -> ``ComputationGraphConfiguration``
for a DAG, writing and reading the same JSON as the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    InputPreProcessor, auto_preprocessor,
)
from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.optimize.updaters import (
    Sgd, Updater, get_updater, updater_from_dict,
)


@dataclasses.dataclass
class MultiLayerConfiguration:
    """Sequential network config (same fields and JSON as the JAX package)."""

    layers: list = dataclasses.field(default_factory=list)
    input_type: Optional[InputType] = None
    preprocessors: dict = dataclasses.field(default_factory=dict)  # {layer_idx: preproc}
    seed: int = 0
    updater: Updater = dataclasses.field(default_factory=lambda: Sgd())
    dtype: str = "float32"  # "float32" | "bf16" compute policy
    tbptt_fwd_length: int = 0
    tbptt_bwd_length: int = 0
    max_grad_norm: float = 0.0
    remat: bool = False

    # resolved by build(): per-layer input types
    layer_input_types: list = dataclasses.field(default_factory=list)

    def resolve(self):
        """Infer per-layer input types + auto-insert preprocessors."""
        if self.input_type is None:
            raise ValueError("MultiLayerConfiguration requires input_type")
        self.layer_input_types = []
        itype = self.input_type
        for i, layer in enumerate(self.layers):
            if i not in self.preprocessors:
                pre = auto_preprocessor(itype, layer)
                if pre is not None:
                    self.preprocessors[i] = pre
            if i in self.preprocessors:
                itype = self.preprocessors[i].output_type(itype)
            self.layer_input_types.append(itype)
            itype = layer.output_type(itype)
        self.output_type = itype
        return self

    def to_json(self) -> str:
        return json.dumps(
            {
                "layers": [l.to_dict() for l in self.layers],
                "input_type": self.input_type.to_dict() if self.input_type else None,
                "preprocessors": {str(k): v.to_dict() for k, v in self.preprocessors.items()},
                "seed": self.seed,
                "updater": self.updater.to_dict(),
                "dtype": self.dtype,
                "tbptt_fwd_length": self.tbptt_fwd_length,
                "tbptt_bwd_length": self.tbptt_bwd_length,
                "max_grad_norm": self.max_grad_norm,
                "remat": self.remat,
            },
            indent=2,
        )

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        d = json.loads(s)
        conf = MultiLayerConfiguration(
            layers=[Layer.from_dict(ld) for ld in d["layers"]],
            input_type=InputType.from_dict(d["input_type"]) if d.get("input_type") else None,
            preprocessors={int(k): InputPreProcessor.from_dict(v)
                           for k, v in d.get("preprocessors", {}).items()},
            seed=d.get("seed", 0),
            updater=updater_from_dict(d["updater"]),
            dtype=d.get("dtype", "float32"),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 0),
            tbptt_bwd_length=d.get("tbptt_bwd_length", 0),
            max_grad_norm=d.get("max_grad_norm", 0.0),
            remat=d.get("remat", False),
        )
        return conf.resolve() if conf.input_type else conf


class ListBuilder:
    """The .list() stage of the builder."""

    def __init__(self, base: "NeuralNetConfiguration"):
        self._base = base
        self._layers: list[Layer] = []
        self._preprocessors: dict[int, InputPreProcessor] = {}
        self._input_type: Optional[InputType] = None
        self._tbptt = (0, 0)

    def layer(self, layer: Layer, index: int | None = None) -> "ListBuilder":
        if index is not None and index != len(self._layers):
            raise ValueError("layers must be added in order")
        self._layers.append(layer)
        return self

    def input_preprocessor(self, index: int, pre: InputPreProcessor) -> "ListBuilder":
        self._preprocessors[index] = pre
        return self

    def set_input_type(self, itype: InputType) -> "ListBuilder":
        self._input_type = itype
        return self

    def backprop_type_tbptt(self, fwd: int, bwd: int | None = None) -> "ListBuilder":
        self._tbptt = (fwd, bwd or fwd)
        return self

    def build(self) -> MultiLayerConfiguration:
        conf = MultiLayerConfiguration(
            layers=self._layers,
            input_type=self._input_type,
            preprocessors=dict(self._preprocessors),
            seed=self._base._seed,
            updater=self._base._updater,
            dtype=self._base._dtype,
            tbptt_fwd_length=self._tbptt[0],
            tbptt_bwd_length=self._tbptt[1],
            max_grad_norm=self._base._max_grad_norm,
            remat=self._base._remat,
        )
        return conf.resolve() if self._input_type else conf


class NeuralNetConfiguration:
    """Fluent builder root."""

    def __init__(self):
        self._seed = 0
        self._updater: Updater = Sgd()
        self._dtype = "float32"
        self._max_grad_norm = 0.0
        self._remat = False

    @staticmethod
    def builder() -> "NeuralNetConfiguration":
        return NeuralNetConfiguration()

    def seed(self, s: int) -> "NeuralNetConfiguration":
        self._seed = int(s)
        return self

    def updater(self, u) -> "NeuralNetConfiguration":
        self._updater = get_updater(u)
        return self

    def gradient_checkpointing(self, on: bool = True) -> "NeuralNetConfiguration":
        self._remat = bool(on)
        return self

    def data_type(self, dtype: str) -> "NeuralNetConfiguration":
        self._dtype = dtype
        return self

    def gradient_clipping(self, max_norm: float) -> "NeuralNetConfiguration":
        self._max_grad_norm = float(max_norm)
        return self

    def list(self) -> ListBuilder:
        return ListBuilder(self)

    def graph_builder(self) -> "GraphBuilder":
        from deeplearning4j_tpu_torch.nn.conf.graph import GraphBuilder

        return GraphBuilder(self)


@dataclasses.dataclass
class ComputationGraphConfiguration:
    """DAG network config (same fields and JSON as the JAX package).

    vertices: {name: GraphVertex}; edges via vertex_inputs {name: [input
    names]}; network_inputs/network_outputs are name lists;
    preprocessors: {vertex name: preprocessor of its single input}."""

    vertices: dict = dataclasses.field(default_factory=dict)
    vertex_inputs: dict = dataclasses.field(default_factory=dict)
    network_inputs: list = dataclasses.field(default_factory=list)
    network_outputs: list = dataclasses.field(default_factory=list)
    input_types: dict = dataclasses.field(default_factory=dict)
    preprocessors: dict = dataclasses.field(default_factory=dict)
    seed: int = 0
    updater: Updater = dataclasses.field(default_factory=lambda: Sgd())
    dtype: str = "float32"
    max_grad_norm: float = 0.0
    remat: bool = False

    topological_order: list = dataclasses.field(default_factory=list)
    vertex_output_types: dict = dataclasses.field(default_factory=dict)

    def resolve(self):
        """Topological order (outputs first, then every other vertex, each
        after its inputs; a cycle raises), each vertex's output type, and a
        preprocessor wherever a layer vertex's single input needs one."""
        from deeplearning4j_tpu_torch.nn.conf.graph import LayerVertex

        order, seen = [], set()

        def visit(name, stack=()):
            if name in seen:
                return
            if name in stack:
                raise ValueError(f"cycle at vertex {name}")
            for dep in self.vertex_inputs.get(name, []):
                if dep not in self.network_inputs:
                    visit(dep, stack + (name,))
            seen.add(name)
            order.append(name)

        for out in self.network_outputs:
            visit(out)
        for name in self.vertices:
            visit(name)
        self.topological_order = order

        types = dict(self.input_types)
        for name in order:
            ins = [types[i] for i in self.vertex_inputs.get(name, [])]
            v = self.vertices[name]
            if name in self.preprocessors and len(ins) == 1:
                ins = [self.preprocessors[name].output_type(ins[0])]
            elif isinstance(v, LayerVertex) and len(ins) == 1:
                pre = auto_preprocessor(ins[0], v.layer)
                if pre is not None:
                    self.preprocessors[name] = pre
                    ins = [pre.output_type(ins[0])]
            types[name] = v.output_type(ins)
        self.vertex_output_types = types
        return self

    def to_json(self) -> str:
        from deeplearning4j_tpu_torch.nn.conf.graph import vertex_to_dict

        return json.dumps(
            {
                "vertices": {k: vertex_to_dict(v) for k, v in self.vertices.items()},
                "vertex_inputs": self.vertex_inputs,
                "network_inputs": self.network_inputs,
                "network_outputs": self.network_outputs,
                "input_types": {k: v.to_dict() for k, v in self.input_types.items()},
                "preprocessors": {k: v.to_dict() for k, v in self.preprocessors.items()},
                "seed": self.seed,
                "updater": self.updater.to_dict(),
                "dtype": self.dtype,
                "max_grad_norm": self.max_grad_norm,
                "remat": self.remat,
            },
            indent=2,
        )

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        from deeplearning4j_tpu_torch.nn.conf.graph import vertex_from_dict

        d = json.loads(s)
        conf = ComputationGraphConfiguration(
            vertices={k: vertex_from_dict(v) for k, v in d["vertices"].items()},
            vertex_inputs=d["vertex_inputs"],
            network_inputs=d["network_inputs"],
            network_outputs=d["network_outputs"],
            input_types={k: InputType.from_dict(v)
                         for k, v in d.get("input_types", {}).items()},
            preprocessors={k: InputPreProcessor.from_dict(v)
                           for k, v in d.get("preprocessors", {}).items()},
            seed=d.get("seed", 0),
            updater=updater_from_dict(d["updater"]),
            dtype=d.get("dtype", "float32"),
            max_grad_norm=d.get("max_grad_norm", 0.0),
            remat=d.get("remat", False),
        )
        return conf.resolve() if conf.input_types else conf
