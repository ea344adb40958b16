"""Transfer learning: freeze, surgery, fine-tune.

Counterpart of ``deeplearning4j_tpu/nn/transferlearning.py``:
``TransferLearning.Builder`` (MultiLayerNetwork) and ``.GraphBuilder``
(ComputationGraph) with ``FineTuneConfiguration``. The builders rebuild
the configuration with replaced or frozen layers and copy every
parameter tree whose structure and shapes still match. A frozen layer is
the same layer with ``trainable=False``: the network gives it the NoOp
updater, so its parameters never move; a frozen BatchNormalization still
moves its running statistics in training, as in the JAX package. The new
network is built on the source network's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_tpu_torch.common.trees import tree_leaves, tree_map
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork


@dataclasses.dataclass
class FineTuneConfiguration:
    """Global overrides applied to the transferred model
    (org.deeplearning4j.nn.transferlearning.FineTuneConfiguration)."""

    updater: Optional[object] = None
    seed: Optional[int] = None
    dtype: Optional[str] = None
    max_grad_norm: Optional[float] = None

    def apply(self, conf):
        if self.updater is not None:
            conf.updater = self.updater
        if self.seed is not None:
            conf.seed = self.seed
        if self.dtype is not None:
            conf.dtype = self.dtype
        if self.max_grad_norm is not None:
            conf.max_grad_norm = self.max_grad_norm
        return conf


def _copy_tree(tree):
    """Copies of the tensors: the new model must not alias the source's."""
    return tree_map(lambda t: t.detach().clone(), tree)


def _structure(tree):
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(v)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_structure(v) for v in tree))
    return None


def _shapes_match(a, b) -> bool:
    return _structure(a) == _structure(b) and all(
        tuple(x.shape) == tuple(y.shape)
        for x, y in zip(tree_leaves(a), tree_leaves(b)))


class TransferLearningBuilder:
    """TransferLearning.Builder for MultiLayerNetwork::

        new = (TransferLearningBuilder(pretrained)
               .fine_tune_configuration(FineTuneConfiguration(updater=Adam(1e-4)))
               .set_feature_extractor(3)          # freeze layers 0..3
               .n_out_replace(5, 10)              # new head width, reinit
               .build())
    """

    def __init__(self, model: MultiLayerNetwork):
        self._model = model
        self._layers = list(model.conf.layers)
        self._old_params = list(model.params)
        self._old_state = list(model.state)
        self._keep = list(range(len(self._layers)))  # old index per slot, -1 new
        self._freeze_upto = -1
        self._ftc: Optional[FineTuneConfiguration] = None

    def fine_tune_configuration(self, ftc: FineTuneConfiguration):
        self._ftc = ftc
        return self

    def set_feature_extractor(self, layer_index: int):
        """Freeze layers [0, layer_index] (they keep their params and get
        NoOp updates)."""
        self._freeze_upto = layer_index
        return self

    def remove_output_layer(self):
        return self.remove_layers_from_output(1)

    def remove_layers_from_output(self, n: int):
        del self._layers[-n:]
        del self._keep[-n:]
        return self

    def add_layer(self, layer):
        self._layers.append(layer)
        self._keep.append(-1)
        return self

    def n_out_replace(self, layer_index: int, n_out: int,
                      weight_init: Optional[str] = None):
        """Change a layer's output width; it and the dependents whose shapes
        change are re-initialized."""
        repl = {"n_out": n_out}
        if weight_init is not None:
            repl["weight_init"] = weight_init
        self._layers[layer_index] = dataclasses.replace(
            self._layers[layer_index], **repl)
        self._keep[layer_index] = -1
        return self

    def build(self) -> MultiLayerNetwork:
        layers = [dataclasses.replace(l, trainable=False)
                  if i <= self._freeze_upto else l
                  for i, l in enumerate(self._layers)]
        old_conf = self._model.conf
        conf = dataclasses.replace(
            old_conf, layers=layers, layer_input_types=[],
            preprocessors={i: p for i, p in old_conf.preprocessors.items()
                           if i < len(layers)})
        if self._ftc is not None:
            conf = self._ftc.apply(conf)
        conf.resolve()
        net = MultiLayerNetwork(conf).init(device=_device(self._model))
        for new_i, old_i in enumerate(self._keep):
            if old_i < 0 or old_i >= len(self._old_params):
                continue
            if _shapes_match(net.params[new_i], self._old_params[old_i]):
                net.params[new_i] = _copy_tree(self._old_params[old_i])
                net.state[new_i] = _copy_tree(self._old_state[old_i])
        return net


class TransferLearningGraphBuilder:
    """TransferLearning.GraphBuilder for ComputationGraph."""

    def __init__(self, graph: ComputationGraph):
        self._graph = graph
        c = graph.conf
        self._vertices = dict(c.vertices)
        self._inputs = {k: list(v) for k, v in c.vertex_inputs.items()}
        self._outputs = list(c.network_outputs)
        self._frozen: set[str] = set()
        self._reinit: set[str] = set()
        self._ftc: Optional[FineTuneConfiguration] = None

    def fine_tune_configuration(self, ftc: FineTuneConfiguration):
        self._ftc = ftc
        return self

    def set_feature_extractor(self, *vertex_names: str):
        """Freeze the named vertices and everything upstream of them."""
        todo = list(vertex_names)
        while todo:
            v = todo.pop()
            if v in self._frozen or v in self._graph.conf.network_inputs:
                continue
            self._frozen.add(v)
            todo.extend(self._inputs.get(v, []))
        return self

    def remove_vertex_and_connections(self, name: str):
        """Remove the vertex and its edges. Consumers keep their reference
        to ``name``: re-add a vertex under the same name (the reference's
        removeVertexAndConnections + addLayer("name", ...) idiom) or rewire
        them before build()."""
        self._vertices.pop(name, None)
        self._inputs.pop(name, None)
        self._outputs = [o for o in self._outputs if o != name]
        return self

    def add_layer(self, name: str, layer, *inputs: str):
        from deeplearning4j_tpu_torch.nn.conf.graph import LayerVertex

        self._vertices[name] = LayerVertex(layer=layer)
        self._inputs[name] = list(inputs)
        self._reinit.add(name)
        return self

    def add_vertex(self, name: str, vertex, *inputs: str):
        self._vertices[name] = vertex
        self._inputs[name] = list(inputs)
        self._reinit.add(name)
        return self

    def set_outputs(self, *names: str):
        self._outputs = list(names)
        return self

    def build(self) -> ComputationGraph:
        from deeplearning4j_tpu_torch.nn.conf.graph import LayerVertex

        vertices = {}
        for name, v in self._vertices.items():
            if name in self._frozen and isinstance(v, LayerVertex):
                vertices[name] = LayerVertex(
                    layer=dataclasses.replace(v.layer, trainable=False))
            else:
                vertices[name] = v
        old = self._graph.conf
        conf = dataclasses.replace(
            old, vertices=vertices, vertex_inputs=self._inputs,
            network_outputs=self._outputs, topological_order=[],
            preprocessors=dict(old.preprocessors), vertex_output_types={})
        if self._ftc is not None:
            conf = self._ftc.apply(conf)
        conf.resolve()
        net = ComputationGraph(conf).init(device=_device(self._graph))
        for name in net.params:
            if name in self._reinit or name not in self._graph.params:
                continue
            if _shapes_match(net.params[name], self._graph.params[name]):
                net.params[name] = _copy_tree(self._graph.params[name])
                if name in self._graph.state:
                    net.state[name] = _copy_tree(self._graph.state[name])
        return net


def _device(model) -> torch.device:
    if model.device is None:
        raise ValueError("the source network is not initialized: call "
                         "init() (or load it) first")
    return model.device


class TransferLearning:
    """Namespace mirroring the reference's TransferLearning.Builder /
    TransferLearning.GraphBuilder entry points."""

    Builder = TransferLearningBuilder
    GraphBuilder = TransferLearningGraphBuilder
