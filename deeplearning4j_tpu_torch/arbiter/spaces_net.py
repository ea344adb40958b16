"""Network-config search spaces.

Counterpart of ``deeplearning4j_tpu/arbiter/spaces_net.py`` over the
port's ``nn.conf`` builders and layer dataclasses (the same field names):
the same numpy seed draws the same candidates, in the JAX package's order
(the configuration seed, then the updater, then each layer's spaces in
field order), and their configuration JSON is the JAX package's.

One difference: a layer field that ``__post_init__`` derives from a
sampled one (``GravesBidirectionalLSTMLayer.fwd``, built from ``n_out``)
is derived again from the draw. The JAX package keeps the template's, so
its ``fwd.n_out`` stays the space object and ``build`` raises on such a
space.

Reference analog: org.deeplearning4j.arbiter.MultiLayerSpace /
layers.DenseLayerSpace etc. — parameter spaces that *generate
MultiLayerConfiguration candidates*. Here a LayerSpace is any layer
dataclass whose fields may be ParameterSpace objects; MultiLayerSpace
samples every space field and builds a concrete MultiLayerConfiguration.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType


def _is_space(v) -> bool:
    return hasattr(v, "sample") and callable(v.sample)


def _derived(v, own) -> bool:
    """Whether ``v`` is a nested dataclass whose ParameterSpace fields are
    all among ``own`` (the outer layer's spaces): one that the outer
    layer's ``__post_init__`` built from them."""
    if not dataclasses.is_dataclass(v) or isinstance(v, type):
        return False
    spaces = [getattr(v, f.name) for f in dataclasses.fields(v)
              if _is_space(getattr(v, f.name))]
    return bool(spaces) and all(any(s is o for o in own) for s in spaces)


def _sample_layer(layer, rng):
    """Replace every ParameterSpace field of a layer dataclass with a draw;
    a nested layer derived from those spaces is set to None, so that
    ``__post_init__`` derives it again from the draws."""
    repl = {}
    for f in dataclasses.fields(layer):
        v = getattr(layer, f.name)
        if _is_space(v):
            repl[f.name] = v.sample(rng)
    own = [getattr(layer, k) for k in repl]
    for f in dataclasses.fields(layer):
        if own and _derived(getattr(layer, f.name), own):
            repl[f.name] = None
    return dataclasses.replace(layer, **repl) if repl else layer


def _seeded_builder(rng, updater_fn):
    """Shared sample() preamble: seeded base config + drawn updater."""
    b = NeuralNetConfiguration.builder().seed(int(rng.integers(1 << 30)))
    if updater_fn is not None:
        b = b.updater(updater_fn(rng))
    return b


def _candidate_generator(space, seed):
    """Infinite {'conf': sampled config} generator (RandomSearch over the
    space), pluggable into OptimizationRunner."""
    rng = np.random.default_rng(seed)
    while True:
        yield {"conf": space.sample(rng)}


class MultiLayerSpace:
    """Builder over layer templates with ParameterSpace-valued fields.

        space = (MultiLayerSpace.builder()
                 .updater_space(lambda rng: Adam(lr=lr_space.sample(rng)))
                 .add_layer(DenseLayer(n_out=IntegerParameterSpace(8, 64),
                                       activation="relu"))
                 .add_layer(OutputLayer(n_out=3, activation="softmax",
                                        loss="mcxent"))
                 .set_input_type(InputType.feed_forward(10))
                 .build())
        conf = space.sample(rng)   # -> concrete MultiLayerConfiguration
    """

    def __init__(self, layers, input_type, updater_fn=None, seed: int = 0):
        self._layers = layers
        self._input_type = input_type
        self._updater_fn = updater_fn
        self._seed = seed
        self._rng = np.random.default_rng(seed)

    def sample(self, rng=None):
        # default to the instance rng so repeated sample() calls draw NEW
        # candidates (a fresh rng per call would resample the same point)
        rng = rng if rng is not None else self._rng
        lb = _seeded_builder(rng, self._updater_fn).list()
        for layer in self._layers:
            lb = lb.layer(_sample_layer(layer, rng))
        return lb.set_input_type(self._input_type).build()

    def candidate_generator(self, seed: int = 0):
        return _candidate_generator(self, seed)

    # --------------------------------------------------------------- builder
    class Builder:
        def __init__(self):
            self._layers: List = []
            self._input_type: Optional[InputType] = None
            self._updater_fn = None
            self._seed = 0

        def add_layer(self, layer) -> "MultiLayerSpace.Builder":
            self._layers.append(layer)
            return self

        def updater_space(self, fn) -> "MultiLayerSpace.Builder":
            """fn(rng) -> Updater instance (sample learning rates etc.)."""
            self._updater_fn = fn
            return self

        def set_input_type(self, itype: InputType) -> "MultiLayerSpace.Builder":
            self._input_type = itype
            return self

        def seed(self, s: int) -> "MultiLayerSpace.Builder":
            self._seed = s
            return self

        def build(self) -> "MultiLayerSpace":
            if self._input_type is None:
                raise ValueError("MultiLayerSpace requires an input type")
            return MultiLayerSpace(self._layers, self._input_type,
                                   self._updater_fn, seed=self._seed)

    @staticmethod
    def builder() -> "MultiLayerSpace.Builder":
        return MultiLayerSpace.Builder()


class ComputationGraphSpace:
    """Graph-topology search space (org.deeplearning4j.arbiter
    .ComputationGraphSpace analog): the graph builder idiom with
    ParameterSpace-valued layer fields; ``sample`` draws every space and
    builds a concrete ComputationGraphConfiguration. Vertices are fixed
    topology (as in the reference); only layer hyperparameters vary.

        space = (ComputationGraphSpace.builder()
                 .add_inputs("in")
                 .set_input_types(**{"in": InputType.feed_forward(10)})
                 .add_layer("fc", DenseLayer(n_out=IntegerParameterSpace(8, 64),
                                             activation="relu"), "in")
                 .add_layer("out", OutputLayer(...), "fc")
                 .set_outputs("out")
                 .build())
    """

    def __init__(self, inputs, input_types, nodes, outputs, updater_fn=None,
                 seed: int = 0):
        self._inputs = inputs
        self._input_types = input_types
        self._nodes = nodes          # [(kind, name, layer_or_vertex, parents)]
        self._outputs = outputs
        self._updater_fn = updater_fn
        self._rng = np.random.default_rng(seed)

    def sample(self, rng=None):
        # instance rng default, same contract as MultiLayerSpace.sample
        rng = rng if rng is not None else self._rng
        gb = (_seeded_builder(rng, self._updater_fn).graph_builder()
              .add_inputs(*self._inputs)
              .set_input_types(**self._input_types))
        for kind, name, obj, parents in self._nodes:
            if kind == "layer":
                gb = gb.add_layer(name, _sample_layer(obj, rng), *parents)
            else:
                gb = gb.add_vertex(name, obj, *parents)
        return gb.set_outputs(*self._outputs).build()

    def candidate_generator(self, seed: int = 0):
        return _candidate_generator(self, seed)

    # --------------------------------------------------------------- builder
    class Builder:
        def __init__(self):
            self._inputs: List[str] = []
            self._input_types: Dict[str, InputType] = {}
            self._nodes: List = []
            self._outputs: List[str] = []
            self._updater_fn = None
            self._seed = 0

        def add_inputs(self, *names: str) -> "ComputationGraphSpace.Builder":
            self._inputs = list(names)
            return self

        def set_input_types(self, **types) -> "ComputationGraphSpace.Builder":
            self._input_types.update(types)
            return self

        def add_layer(self, name: str, layer, *parents: str
                      ) -> "ComputationGraphSpace.Builder":
            self._nodes.append(("layer", name, layer, list(parents)))
            return self

        def add_vertex(self, name: str, vertex, *parents: str
                       ) -> "ComputationGraphSpace.Builder":
            self._nodes.append(("vertex", name, vertex, list(parents)))
            return self

        def set_outputs(self, *names: str) -> "ComputationGraphSpace.Builder":
            self._outputs = list(names)
            return self

        def updater_space(self, fn) -> "ComputationGraphSpace.Builder":
            self._updater_fn = fn
            return self

        def seed(self, s: int) -> "ComputationGraphSpace.Builder":
            self._seed = s
            return self

        def build(self) -> "ComputationGraphSpace":
            if not (self._inputs and self._outputs):
                raise ValueError("ComputationGraphSpace requires inputs and "
                                 "outputs")
            return ComputationGraphSpace(self._inputs, self._input_types,
                                         self._nodes, self._outputs,
                                         self._updater_fn, seed=self._seed)

    @staticmethod
    def builder() -> "ComputationGraphSpace.Builder":
        return ComputationGraphSpace.Builder()
