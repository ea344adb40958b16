"""Import-graph optimizer: rewrite the parsed TF/ONNX graph IR before it
runs.

Counterpart of ``deeplearning4j_tpu/modelimport/optimizer.py``; the graph
logic is numpy and the same, rule for rule, so both packages rewrite a
graph identically (``graph_signature`` and the per-rule counts agree). The
exporter materializes layout ops (Identity chains, Reshape/Transpose pairs,
ExpandDims+Squeeze, duplicate Casts, broadcast Expands) and composes
attention out of primitive ops; this pass removes the first and rewrites
the second onto the registry's ``dot_product_attention``.

Rule catalog (each counted per rule on the imported graph's
``import_opt_stats``, and with monitoring on in
``dl4j_import_opt_rewrites_total{frontend,rule}``):

- ``fold_constants``     evaluate nodes fed only by non-parameter constants
                         (incl. Shape/Size/Rank of statically-known shapes
                         via the lightweight shape-inference env below);
- ``identity``           Identity / StopGradient / no-op Dropout chains:
                         consumers rewired to the producer, removed name
                         preserved as an alias for output/probing;
- ``noop_cast``          Cast to the dtype the value already has
                         (duplicate-cast chains the exporter emits);
- ``transpose_pairs``    Transpose(Transpose(x)) composed into one (or
                         cancelled when the composition is the identity);
- ``reshape_chains``     Reshape(Reshape(x)) collapsed to the outer
                         Reshape; Reshape to the input's own static shape
                         cancelled;
- ``expand_squeeze``     Squeeze(Unsqueeze(x)) / Squeeze(ExpandDims(x))
                         with matching axes cancelled; no-op broadcast
                         Expand (target == input shape) cancelled;
- ``fuse_attention``     the composed attention subgraph
                         (matmul -> scale -> mask-add -> softmax -> matmul)
                         rewritten onto ``op("dot_product_attention")``
                         with the exporter's additive mask as ``bias``
                         (which the flash kernels refuse: such a call
                         takes the plain lowering, on the card too);
- ``dce``                dead-node elimination backward from the known
                         graph outputs (skipped when outputs are unknown,
                         e.g. a bare frozen GraphDef with caller-chosen
                         probes).

Trainability contract: constants that could become fine-tuning parameters
(float, rank >= 1 — exactly ``as_trainable``'s default trainable set) are
NEVER folded through; rewrites only rewire references to them, so
import-then-train keeps the identical parameter set with the pass on or
off.

Escape hatch: ``DL4J_TORCH_IMPORT_OPT=0`` (or ``optimize=False`` on the
import entry points) restores the exact raw parsed graph —
``graph_signature`` (node count + topology hash) is the CI guard's witness
that the hatch cannot silently rot.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.common.env import env

FUSED_ATTENTION_OP = "_DL4JFusedAttention"
SYNTH_TRANSPOSE_OP = "_DL4JTranspose"

_FOLD_SIZE_CAP = 1 << 20   # never materialize folded constants above 1M elems
_MAX_PASSES = 8

# never folded even when inputs are constant: value depends on RNG state
_NONDETERMINISTIC = frozenset({
    "RandomNormal", "RandomUniform", "RandomNormalLike", "RandomUniformLike",
    "RandomStandardNormal", "Multinomial", "RandomShuffle", "Bernoulli",
})


def import_opt_enabled() -> bool:
    """The default-on env gate (DL4J_TORCH_IMPORT_OPT=0 disables)."""
    return env.import_opt


def resolve_alias(aliases: Dict[str, str], name: str) -> str:
    """Follow an alias chain (removed value name -> surviving ref)."""
    seen = set()
    while name in aliases and name not in seen:
        seen.add(name)
        name = aliases[name]
    return name


def graph_signature(imp) -> Tuple[int, str]:
    """(node count, topology hash) of an imported graph — the escape-hatch
    guard's witness. Duck-types both frontends: ONNX graphs expose
    ``graph_outputs``/``nodes`` (list), TF graphs expose ``order``/``nodes``
    (dict)."""
    if isinstance(getattr(imp, "nodes", None), dict):   # TF
        nodes = [imp.nodes[n] for n in imp.order]
        rows = [f"{n.op}|{n.name}|{','.join(n.inputs)}" for n in nodes]
    else:                                               # ONNX
        nodes = list(imp.nodes)
        rows = [f"{n.op}|{n.name}|{','.join(n.inputs)}|"
                f"{','.join(n.outputs)}" for n in nodes]
    h = hashlib.sha256("\n".join(rows).encode()).hexdigest()
    return len(nodes), h


# ---------------------------------------------------------- synthetic nodes


class _SynthAttrs(dict):
    pass


class SynthNode:
    """A node synthesized by a rewrite rule, executable by both frontends'
    node loops (their registries gain evaluators that read only these
    attributes — see register_synthetic_ops)."""

    __slots__ = ("op", "name", "inputs", "outputs", "perm", "scale", "attrs")

    def __init__(self, op: str, name: str, inputs: Sequence[str],
                 outputs: Sequence[str], perm=None, scale=None):
        self.op = op
        self.name = name
        self.inputs = list(inputs)
        self.outputs = list(outputs)
        self.perm = None if perm is None else [int(p) for p in perm]
        self.scale = scale
        self.attrs = _SynthAttrs()

    # frontend node API shims (attrs live on the slots above)
    def attr(self, key, default=None):
        return default

    def ints(self, name, default=()):
        return list(default)


def _eval_synth_transpose(node, xs):
    from deeplearning4j_tpu_torch.modelimport.tensorflow import _t

    return _t(xs[0]).permute(node.perm)


def _eval_fused_attention(node, xs):
    from deeplearning4j_tpu_torch.modelimport.tensorflow import _t, promote
    from deeplearning4j_tpu_torch.ops.registry import op as _rop

    q, k, v = promote(*xs[:3])
    bias = xs[3] if len(xs) > 3 and xs[3] is not None else None
    return _rop("dot_product_attention")(
        q, k, v, bias=None if bias is None else _t(bias),
        scale=float(node.scale))


def register_synthetic_ops(registry: Dict[str, Callable]) -> None:
    registry.setdefault(SYNTH_TRANSPOSE_OP, _eval_synth_transpose)
    registry.setdefault(FUSED_ATTENTION_OP, _eval_fused_attention)


# ----------------------------------------------------------- shape helpers


def _broadcast(a, b):
    """Static broadcast of two shape tuples (entries may be None)."""
    if a is None or b is None:
        return None
    out = []
    la, lb = len(a), len(b)
    for i in range(max(la, lb)):
        da = a[la - 1 - i] if i < la else 1
        db = b[lb - 1 - i] if i < lb else 1
        if da == 1:
            out.append(db)
        elif db == 1:
            out.append(da)
        elif da is None or db is None:
            out.append(None)
        elif da == db:
            out.append(da)
        else:
            return None  # incompatible per static info: give up
    return tuple(reversed(out))


def _full(shape):
    return shape is not None and all(d is not None for d in shape)


def _infer_node_shape(kind, aux, in_shapes, in_dtypes):
    """One node's (shapes, dtypes) for its outputs, or (None, None).
    ``kind`` comes from the view's shape_kind(); handlers are shared by
    both frontends."""
    s0 = in_shapes[0] if in_shapes else None
    d0 = in_dtypes[0] if in_dtypes else None
    if kind == "identity":
        return s0, d0
    if kind == "unary":
        return s0, (aux or d0)            # aux = forced dtype (bool ops)
    if kind == "binary":
        shp = in_shapes[0]
        for s in in_shapes[1:]:
            shp = _broadcast(shp, s)
        dts = [d for d in in_dtypes if d is not None]
        if aux == "bool":
            dt = np.dtype(bool)
        elif aux == "select":
            dt = in_dtypes[1]
        else:
            dt = dts[0] if dts and all(d == dts[0] for d in dts) else None
        return shp, dt
    if kind == "matmul":
        a, b = in_shapes[0], in_shapes[1]
        if a is None or b is None or len(a) < 2 or len(b) < 2:
            return None, None
        adj_a, adj_b = aux
        am, ak = (a[-1], a[-2]) if adj_a else (a[-2], a[-1])
        bk, bn = (b[-1], b[-2]) if adj_b else (b[-2], b[-1])
        batch = _broadcast(a[:-2], b[:-2])
        if batch is None and (len(a) > 2 or len(b) > 2):
            return None, None
        d = d0 if d0 == in_dtypes[1] else None
        return tuple(batch or ()) + (am, bn), d
    if kind == "transpose":
        if s0 is None or aux is None or len(aux) != len(s0):
            return None, None
        return tuple(s0[p] for p in aux), d0
    if kind == "reshape":
        if aux is None:
            return None, None
        dims = list(aux)
        # resolve 0 (= copy input dim, ONNX) and a single -1
        out = []
        for i, d in enumerate(dims):
            if d == 0 and s0 is not None and i < len(s0):
                out.append(s0[i])
            else:
                out.append(int(d))
        if any(d == 0 for d in out):
            return None, None
        if -1 in out:
            if not _full(s0) or out.count(-1) > 1:
                return tuple(None if d == -1 else d for d in out), d0
            total = int(np.prod(s0)) if s0 else 1
            rest = int(np.prod([d for d in out if d != -1])) or 1
            out = [total // rest if d == -1 else d for d in out]
        return tuple(out), d0
    if kind == "unsqueeze":
        if s0 is None or aux is None:
            return None, d0
        rank = len(s0) + len(aux)
        axes = sorted(a % rank for a in aux)
        out = list(s0)
        for a in axes:
            out.insert(a, 1)
        return tuple(out), d0
    if kind == "squeeze":
        if s0 is None:
            return None, d0
        if aux is None:  # squeeze all size-1 dims: needs full shape
            if not _full(s0):
                return None, d0
            return tuple(d for d in s0 if d != 1), d0
        axes = sorted(a % len(s0) for a in aux)
        return tuple(d for i, d in enumerate(s0) if i not in axes), d0
    if kind == "cast":
        return s0, aux
    if kind == "gather":
        data, idx = in_shapes[0], in_shapes[1]
        if data is None or idx is None:
            return None, d0
        ax = aux % len(data)
        return data[:ax] + idx + data[ax + 1:], d0
    if kind == "expand":
        if aux is None:
            return None, d0
        return _broadcast(s0, tuple(int(d) for d in aux)), d0
    if kind == "reduce":
        axes, keepdims = aux
        if s0 is None:
            return None, d0
        if axes is None:
            axes = list(range(len(s0)))
        axes = [a % len(s0) for a in axes]
        if keepdims:
            return tuple(1 if i in axes else d
                         for i, d in enumerate(s0)), d0
        return tuple(d for i, d in enumerate(s0) if i not in axes), d0
    if kind == "shape_of":
        if s0 is None:
            return None, np.dtype(np.int64)
        return (len(s0),), np.dtype(np.int64)
    if kind == "size_of":
        return (), np.dtype(np.int64)
    if kind == "concat":
        if any(s is None for s in in_shapes) or not in_shapes:
            return None, d0
        rank = len(in_shapes[0])
        ax = aux % rank
        dims = list(in_shapes[0])
        total = 0
        for s in in_shapes:
            if len(s) != rank or s[ax] is None:
                return None, d0
            total += s[ax]
        dims[ax] = total
        return tuple(dims), d0
    if kind == "constant_of_shape":
        if aux is None:
            return None, None
        return tuple(int(d) for d in aux), d0
    return None, None


# ------------------------------------------------------------- view base


class _View:
    """Frontend adapter: uniform node/value accessors the rules run over.

    Values are referenced by string names; the TF subclass canonicalizes
    "name:0" refs to "name" and tracks control ("^name") edges separately.
    """

    frontend = ""
    identity_ops: frozenset = frozenset()
    matmul_ops: frozenset = frozenset()
    softmax_ops: frozenset = frozenset()
    transpose_ops: frozenset = frozenset()
    reshape_ops: frozenset = frozenset()
    cast_ops: frozenset = frozenset()
    mul_ops: frozenset = frozenset()
    div_ops: frozenset = frozenset()
    add_ops: frozenset = frozenset()

    def __init__(self):
        self.aliases: Dict[str, str] = {}
        self.removed: set = set()
        self._synth_n = 0

    # ---- to implement per frontend
    def node_op(self, n) -> str:
        raise NotImplementedError

    def node_name(self, n) -> str:
        raise NotImplementedError

    def data_inputs(self, n) -> List[str]:
        raise NotImplementedError

    def ctrl_inputs(self, n) -> List[str]:
        return []

    def node_outputs(self, n) -> List[str]:
        raise NotImplementedError

    def set_data_input(self, n, old: str, new: str) -> None:
        raise NotImplementedError

    def is_barrier(self, n) -> bool:
        raise NotImplementedError

    def known_value(self, ref: str):
        """Concrete value for a ref (constant/folded), or None."""
        raise NotImplementedError

    def is_param(self, ref: str) -> bool:
        """True when the ref names a potential fine-tuning parameter
        (float, rank >= 1) — never folded through."""
        raise NotImplementedError

    def add_folded(self, name: str, value: np.ndarray) -> None:
        raise NotImplementedError

    def eval_node(self, n, xs):
        raise NotImplementedError

    def dce_roots(self) -> Optional[List[str]]:
        return None

    def input_info(self) -> Dict[str, Tuple[Optional[np.dtype],
                                            Optional[tuple]]]:
        return {}

    def shape_kind(self, n):
        """(kind, aux) for _infer_node_shape, or None when unknown."""
        return None

    def transpose_perm(self, n) -> Optional[List[int]]:
        return None

    def softmax_axis(self, n) -> int:
        return -1

    def matmul_adj(self, n) -> Tuple[bool, bool]:
        return (False, False)

    # ---- shared helpers
    def canon(self, ref: str) -> str:
        return ref

    def new_name(self, base: str) -> str:
        self._synth_n += 1
        return f"_dl4j_opt/{base}_{self._synth_n}"

    def rebuild(self):
        self.producers: Dict[str, object] = {}
        self.consumers: Dict[str, List[object]] = {}
        self.ctrl_targets: set = set()
        for n in self.nodes:
            for o in self.node_outputs(n):
                self.producers[o] = n
            for r in self.data_inputs(n):
                self.consumers.setdefault(self.canon(r), []).append(n)
            for r in self.ctrl_inputs(n):
                self.ctrl_targets.add(self.canon(r))

    def producer(self, ref):
        return self.producers.get(self.canon(ref))

    def value_consumers(self, value: str) -> List[object]:
        return self.consumers.get(self.canon(value), [])

    def externally_visible(self, value: str) -> bool:
        """True when removing the producer could be observable (graph
        output, or control-dep target)."""
        roots = self.dce_roots()
        v = self.canon(value)
        if roots is not None and v in {self.canon(r) for r in roots}:
            return True
        return v in self.ctrl_targets

    def alias_value(self, old: str, new_ref: str) -> None:
        self.aliases[self.canon(old)] = new_ref

    def rewire(self, value: str, new_ref: str) -> None:
        for c in list(self.value_consumers(value)):
            self.set_data_input(c, value, new_ref)

    def drop_nodes(self, dead: set) -> None:
        for n in self.nodes:
            if id(n) in dead:
                self.removed.update(self.node_outputs(n))
        self.nodes[:] = [n for n in self.nodes if id(n) not in dead]

    def scalar_const(self, ref: str) -> Optional[float]:
        """Concrete size-1 non-parameter constant value, else None."""
        if self.is_param(ref):
            return None
        v = self.known_value(ref)
        if v is None or np.size(v) != 1:
            return None
        if not np.issubdtype(np.asarray(v).dtype, np.floating):
            return None
        return float(np.asarray(v).ravel()[0])


# -------------------------------------------------------------- shape env


def _shape_env(view: _View):
    shapes: Dict[str, Optional[tuple]] = {}
    dtypes: Dict[str, Optional[np.dtype]] = {}
    for name, (dt, shp) in view.input_info().items():
        shapes[name] = shp
        dtypes[name] = dt
    for n in view.nodes:
        outs = view.node_outputs(n)
        ins = [view.canon(r) for r in view.data_inputs(n)]

        def seed(ref):
            if ref in shapes:
                return
            v = view.known_value(ref)
            if v is not None:
                a = np.asarray(v)
                shapes[ref] = tuple(int(d) for d in a.shape)
                dtypes[ref] = a.dtype

        for r in ins:
            seed(r)
        kind = view.shape_kind(n)
        if kind is None:
            for o in outs:
                shapes.setdefault(o, None)
                dtypes.setdefault(o, None)
            continue
        in_shapes = [shapes.get(r) for r in ins]
        in_dtypes = [dtypes.get(r) for r in ins]
        s, d = _infer_node_shape(kind[0], kind[1], in_shapes, in_dtypes)
        for o in outs:   # multi-output inference not modeled: first only
            shapes[o] = s if o == outs[0] else None
            dtypes[o] = d if o == outs[0] else None
    return shapes, dtypes


# ------------------------------------------------------------------ rules


def rule_fold_constants(view: _View) -> int:
    view.rebuild()
    shapes, _ = _shape_env(view)
    count = 0
    dead = set()
    for n in list(view.nodes):
        if view.is_barrier(n) or id(n) in dead:
            continue
        op = view.node_op(n)
        if op in _NONDETERMINISTIC or op in (FUSED_ATTENTION_OP,):
            continue
        outs = view.node_outputs(n)
        if any(view.known_value(o) is not None for o in outs):
            continue
        ins = view.data_inputs(n)
        canon_ins = [view.canon(r) for r in ins if r]
        # Shape/Size/Rank of a statically-known (non-constant) input fold
        # straight from the inference env — the exporter's shape-arith
        # chains (Shape -> Slice -> Cast -> Sqrt -> Div) then fold as
        # ordinary constant arithmetic.
        kind = view.shape_kind(n)
        if kind is not None and kind[0] in ("shape_of", "size_of") \
                and canon_ins and len(outs) == 1 \
                and not any(view.known_value(r) is not None
                            for r in canon_ins):
            s = shapes.get(canon_ins[0])
            if _full(s):
                val = (np.asarray(s, np.int64) if kind[0] == "shape_of"
                       else np.asarray(int(np.prod(s or (1,))), np.int64))
                view.add_folded(outs[0], val)
                dead.add(id(n))
                count += 1
            continue
        if not canon_ins and op != "Constant":
            continue  # only ONNX Constant is a foldable source op
        vals = []
        ok = True
        for r in ins:
            if not r:
                vals.append(None)
                continue
            c = view.canon(r)
            if view.is_param(c):
                ok = False
                break
            v = view.known_value(c)
            if v is None:
                ok = False
                break
            vals.append(v)
        if not ok:
            continue
        try:
            y = view.eval_node(n, vals)
        except Exception:
            continue
        if isinstance(y, (tuple, list)):
            continue  # multi-output folding not modeled
        arr = np.asarray(y)
        if arr.dtype == object or arr.size > _FOLD_SIZE_CAP:
            continue
        view.add_folded(outs[0], arr)
        dead.add(id(n))
        count += 1
    view.drop_nodes(dead)
    return count


def _eliminable_passthrough(view, n):
    """The single data input a pass-through node forwards, or None."""
    if view.is_barrier(n):
        return None
    ins = [r for r in view.data_inputs(n) if r]
    if len(ins) != 1 or view.ctrl_inputs(n):
        return None
    outs = view.node_outputs(n)
    if len(outs) < 1:
        return None
    # secondary outputs (e.g. ONNX Dropout's mask) must be unused
    for o in outs[1:]:
        if view.value_consumers(o) or view.externally_visible(o):
            return None
    return ins[0]


def _bypass(view, n, target_ref) -> bool:
    """Rewire n's consumers to target_ref, alias its output, mark dead."""
    out = view.node_outputs(n)[0]
    if view.canon(out) in view.ctrl_targets:
        return False
    view.rewire(out, target_ref)
    view.alias_value(out, target_ref)
    return True


def rule_identity(view: _View) -> int:
    view.rebuild()
    count = 0
    dead = set()
    roots = view.dce_roots()
    root_set = {view.canon(r) for r in roots} if roots is not None else None
    for n in list(view.nodes):
        if view.node_op(n) not in view.identity_ops:
            continue
        src = _eliminable_passthrough(view, n)
        if src is None:
            continue
        out = view.node_outputs(n)[0]
        if root_set is not None and view.canon(out) in root_set:
            continue  # graph outputs keep their producing node
        if _bypass(view, n, src):
            dead.add(id(n))
            count += 1
            view.rebuild()
    view.drop_nodes(dead)
    return count


def rule_noop_cast(view: _View) -> int:
    view.rebuild()
    _, dtypes = _shape_env(view)
    count = 0
    dead = set()
    for n in list(view.nodes):
        if view.node_op(n) not in view.cast_ops or id(n) in dead:
            continue
        kind = view.shape_kind(n)
        if kind is None or kind[0] != "cast" or kind[1] is None:
            continue
        src = _eliminable_passthrough(view, n)
        if src is None:
            continue
        # float-destination casts are kept even when no-op: the ONNX
        # frontend's compute_dtype override (as_trainable mixed precision)
        # redirects Cast-to-FLOAT at trace time, so an "f32 -> f32" cast
        # is only a no-op until someone fine-tunes in bf16
        if np.issubdtype(np.dtype(kind[1]), np.floating):
            continue
        src_dt = dtypes.get(view.canon(src))
        if src_dt is None or np.dtype(src_dt) != np.dtype(kind[1]):
            continue
        out = view.node_outputs(n)[0]
        roots = view.dce_roots()
        if roots is not None and view.canon(out) in {view.canon(r)
                                                     for r in roots}:
            continue
        if _bypass(view, n, src):
            dead.add(id(n))
            count += 1
            view.rebuild()
    view.drop_nodes(dead)
    return count


def rule_transpose_pairs(view: _View) -> int:
    view.rebuild()
    count = 0
    dead = set()
    for n in list(view.nodes):
        if view.node_op(n) not in view.transpose_ops or id(n) in dead:
            continue
        p2 = view.transpose_perm(n)
        ins = [r for r in view.data_inputs(n) if r]
        if p2 is None or not ins:
            continue
        out = view.node_outputs(n)[0]
        roots = view.dce_roots()
        is_root = roots is not None and view.canon(out) in {
            view.canon(r) for r in roots}
        inner = view.producer(ins[0])
        if inner is not None and view.node_op(inner) in view.transpose_ops \
                and id(inner) not in dead:
            p1 = view.transpose_perm(inner)
            inner_in = [r for r in view.data_inputs(inner) if r]
            if p1 is not None and inner_in and len(p1) == len(p2):
                composed = [p1[p] for p in p2]
                if composed == list(range(len(composed))):
                    if not is_root and _bypass(view, n, inner_in[0]):
                        dead.add(id(n))
                        count += 1
                        view.rebuild()
                    continue
                # replace n with a single synthetic transpose (same output
                # name, same topo position); inner stays for its other
                # consumers and dies in DCE otherwise. Synth nodes are
                # NAMED by their output value (the TF convention: a node's
                # name IS the value name its executor stores).
                idx = view.nodes.index(n)
                synth = SynthNode(SYNTH_TRANSPOSE_OP, out,
                                  [inner_in[0]], [out], perm=composed)
                view.nodes[idx] = synth
                count += 1
                view.rebuild()
                continue
        if p2 == list(range(len(p2))) and not is_root:
            if _bypass(view, n, ins[0]):   # identity permutation
                dead.add(id(n))
                count += 1
                view.rebuild()
    view.drop_nodes(dead)
    return count


def rule_reshape_chains(view: _View) -> int:
    view.rebuild()
    shapes, _ = _shape_env(view)
    count = 0
    dead = set()
    for n in list(view.nodes):
        if view.node_op(n) not in view.reshape_ops or id(n) in dead:
            continue
        kind = view.shape_kind(n)
        if kind is None or kind[0] != "reshape" or kind[1] is None:
            continue
        target = [int(d) for d in kind[1]]
        ins = [r for r in view.data_inputs(n) if r]
        if not ins:
            continue
        out = view.node_outputs(n)[0]
        roots = view.dce_roots()
        is_root = roots is not None and view.canon(out) in {
            view.canon(r) for r in roots}
        src_shape = shapes.get(view.canon(ins[0]))
        # no-op: reshape to the input's own fully-static shape
        if not is_root and _full(src_shape) \
                and all(d > 0 for d in target) \
                and tuple(target) == tuple(src_shape):
            if _bypass(view, n, ins[0]):
                dead.add(id(n))
                count += 1
                view.rebuild()
            continue
        # chain: Reshape(Reshape(x, s1), s2) == Reshape(x, s2), valid as
        # long as s2 has no copy-from-input dims (ONNX 0 semantics)
        inner = view.producer(ins[0])
        if inner is None or view.node_op(inner) not in view.reshape_ops:
            continue
        if view.frontend == "onnx" and any(d == 0 for d in target):
            continue
        inner_in = [r for r in view.data_inputs(inner) if r]
        if not inner_in:
            continue
        view.set_data_input(n, ins[0], inner_in[0])
        count += 1
        view.rebuild()
    view.drop_nodes(dead)
    return count


def rule_expand_squeeze(view: _View) -> int:
    view.rebuild()
    shapes, _ = _shape_env(view)
    count = 0
    dead = set()
    roots = view.dce_roots()
    root_set = {view.canon(r) for r in roots} if roots is not None else set()
    for n in list(view.nodes):
        if id(n) in dead:
            continue
        kind = view.shape_kind(n)
        if kind is None:
            continue
        out = view.node_outputs(n)[0]
        if view.canon(out) in root_set:
            continue
        ins = [r for r in view.data_inputs(n) if r]
        if not ins:
            continue
        if kind[0] == "squeeze" and kind[1] is not None:
            inner = view.producer(ins[0])
            if inner is None or id(inner) in dead:
                continue
            ikind = view.shape_kind(inner)
            if ikind is None or ikind[0] != "unsqueeze" or ikind[1] is None:
                continue
            sq, unsq = list(kind[1]), list(ikind[1])
            rank_out = shapes.get(view.canon(ins[0]))
            if rank_out is not None:
                r = len(rank_out)
                sq = sorted(a % r for a in sq)
                unsq = sorted(a % r for a in unsq)
            else:
                if any(a < 0 for a in sq + unsq):
                    continue
                sq, unsq = sorted(sq), sorted(unsq)
            if sq != unsq:
                continue
            inner_in = [r for r in view.data_inputs(inner) if r]
            if not inner_in:
                continue
            if _bypass(view, n, inner_in[0]):
                dead.add(id(n))
                count += 1
                view.rebuild()
        elif kind[0] == "expand":
            # no-op broadcast materialization: target == input static shape
            src = shapes.get(view.canon(ins[0]))
            tgt = kind[1]
            if not _full(src) or tgt is None:
                continue
            if _broadcast(src, tuple(int(d) for d in tgt)) != tuple(src):
                continue
            if _bypass(view, n, ins[0]):
                dead.add(id(n))
                count += 1
                view.rebuild()
    view.drop_nodes(dead)
    return count


# --------------------------------------------------------- attention fusion


def _peel_scale(view, ref, shapes):
    """Peel scalar Mul/Div wrappers off ``ref``; returns (base_ref, factor).
    Only non-parameter size-1 float constants are peeled (a trainable scale
    const must stay a live graph value)."""
    factor = 1.0
    for _ in range(4):
        prod = view.producer(ref)
        if prod is None:
            break
        op = view.node_op(prod)
        ins = [r for r in view.data_inputs(prod) if r]
        if op in view.mul_ops and len(ins) == 2:
            for i, j in ((0, 1), (1, 0)):
                s = view.scalar_const(view.canon(ins[j]))
                if s is not None:
                    factor *= s
                    ref = ins[i]
                    break
            else:
                break
        elif op in view.div_ops and len(ins) == 2:
            s = view.scalar_const(view.canon(ins[1]))
            if s is None or s == 0.0:
                break
            factor /= s
            ref = ins[0]
        else:
            break
    return ref, factor


def _sole_consumer(view, value, expect_node) -> bool:
    cs = view.value_consumers(value)
    return (len(cs) == 1 and cs[0] is expect_node
            and not view.externally_visible(value))


def rule_fuse_attention(view: _View) -> int:
    count = 0
    while True:
        view.rebuild()
        shapes, _ = _shape_env(view)
        match = _find_attention(view, shapes)
        if match is None:
            return count
        _apply_attention(view, match)
        count += 1


def _find_attention(view, shapes):
    for sm in view.nodes:
        if view.node_op(sm) not in view.softmax_ops:
            continue
        m = _match_attention_at(view, shapes, sm)
        if m is not None:
            return m
    return None


def _match_attention_at(view, shapes, sm):
    sm_out = view.node_outputs(sm)[0]
    sm_in = [r for r in view.data_inputs(sm) if r]
    if len(sm_in) != 1:
        return None
    # softmax must be over the last axis
    ax = view.softmax_axis(sm)
    s_shape = shapes.get(view.canon(sm_in[0]))
    if ax != -1 and (s_shape is None or ax != len(s_shape) - 1):
        return None
    # softmax output feeds exactly one matmul (probs @ v), probs on the left
    cs = view.value_consumers(sm_out)
    if len(cs) != 1 or view.externally_visible(sm_out):
        return None
    out_mm = cs[0]
    if view.node_op(out_mm) not in view.matmul_ops:
        return None
    if view.matmul_adj(out_mm) != (False, False):
        return None
    mm_ins = [r for r in view.data_inputs(out_mm) if r]
    if len(mm_ins) != 2 or view.canon(mm_ins[0]) != view.canon(sm_out):
        return None
    v_ref = mm_ins[1]

    # softmax input: optional mask-add over the (scaled) scores matmul
    def scores_of(ref):
        base, factor = _peel_scale(view, ref, shapes)
        prod = view.producer(base)
        if prod is not None and view.node_op(prod) in view.matmul_ops:
            return prod, base, factor
        return None

    bias_ref = None
    scores_entry = scores_of(sm_in[0])
    add = view.producer(sm_in[0])
    if scores_entry is None and add is not None \
            and view.node_op(add) in view.add_ops:
        add_ins = [r for r in view.data_inputs(add) if r]
        if len(add_ins) != 2:
            return None
        for i, j in ((0, 1), (1, 0)):
            scores_entry = scores_of(add_ins[i])
            if scores_entry is not None:
                bias_ref = add_ins[j]
                if not _sole_consumer(view, add_ins[i], add):
                    return None  # the scaled scores feed something else too
                break
        if scores_entry is None:
            return None
        if not _sole_consumer(view, view.node_outputs(add)[0], sm):
            return None
    elif scores_entry is not None:
        add = None
        if not _sole_consumer(view, sm_in[0], sm):
            return None
    else:
        return None

    scores_mm, _, post_factor = scores_entry
    if view.matmul_adj(scores_mm)[0]:
        return None
    qk = [r for r in view.data_inputs(scores_mm) if r]
    if len(qk) != 2:
        return None
    q_ref, q_factor = _peel_scale(view, qk[0], shapes)
    kt_ref, k_factor = _peel_scale(view, qk[1], shapes)
    scale = post_factor * q_factor * k_factor

    # q must be [B, N, T, D]
    q_shape = shapes.get(view.canon(q_ref))
    if q_shape is None or len(q_shape) != 4:
        return None

    # resolve k in [B, N, Tk, D] layout
    adj_y = view.matmul_adj(scores_mm)[1]
    if adj_y:
        k_plan = ("direct", kt_ref, None)
    else:
        kt_prod = view.producer(kt_ref)
        if kt_prod is not None and view.node_op(kt_prod) \
                in view.transpose_ops.union({SYNTH_TRANSPOSE_OP}):
            perm = (kt_prod.perm if isinstance(kt_prod, SynthNode)
                    else view.transpose_perm(kt_prod))
            kt_in = [r for r in view.data_inputs(kt_prod) if r]
            if perm is None or len(perm) != 4 or not kt_in:
                return None
            swapped = perm[:-2] + [perm[-1], perm[-2]]
            k_plan = ("transpose", kt_in[0], swapped)
        else:
            kt_shape = shapes.get(view.canon(kt_ref))
            if kt_shape is None or len(kt_shape) != 4:
                return None
            k_plan = ("transpose", kt_ref, [0, 1, 3, 2])

    # the raw scores matmul output must feed only this chain
    scores_out = view.node_outputs(scores_mm)[0]
    if len(view.value_consumers(scores_out)) != 1 \
            or view.externally_visible(scores_out):
        return None
    return {"sm": sm, "add": add, "out_mm": out_mm, "scores_mm": scores_mm,
            "q": q_ref, "k_plan": k_plan, "v": v_ref, "bias": bias_ref,
            "scale": scale}


def _apply_attention(view, m):
    out_mm = m["out_mm"]
    out_name = view.node_outputs(out_mm)[0]
    idx = view.nodes.index(out_mm)
    new_nodes = []
    mode, k_src, perm = m["k_plan"]
    if mode == "transpose":
        k_ref = view.new_name("k")
        new_nodes.append(SynthNode(SYNTH_TRANSPOSE_OP, k_ref,
                                   [k_src], [k_ref], perm=perm))
    else:
        k_ref = k_src
    inputs = [m["q"], k_ref, m["v"]]
    if m["bias"] is not None:
        inputs.append(m["bias"])
    # named by its output value: the TF executor stores acts[node.name]
    fused = SynthNode(FUSED_ATTENTION_OP, out_name,
                      inputs, [out_name], scale=m["scale"])
    new_nodes.append(fused)
    view.nodes[idx:idx + 1] = new_nodes
    # the replaced chain (softmax/add/scale muls/scores matmul/old
    # transposes) stays in place for any outside consumers; DCE sweeps
    # whatever is now unreachable.


def _bcast_absorbable(view, shapes, start_val, new_shape) -> bool:
    """Would shrinking ``start_val`` to ``new_shape`` leave every downstream
    value identical? True when the affected cone is purely elementwise-
    broadcast ops whose output shapes either re-converge with the current
    ones or get absorbed by a fused-attention bias add. (Broadcasting
    commutes with elementwise ops, so the values are unchanged wherever the
    shapes are.)"""
    hyp = {view.canon(start_val): tuple(new_shape)}
    work = [view.canon(start_val)]
    seen_nodes = set()
    guard = 0
    while work:
        guard += 1
        if guard > 200:
            return False
        v = work.pop()
        if view.externally_visible(v):
            return False
        roots = view.dce_roots()
        if roots is not None and v in {view.canon(r) for r in roots}:
            return False
        for c in view.value_consumers(v):
            if id(c) in seen_nodes:
                continue
            seen_nodes.add(id(c))
            op = view.node_op(c)
            ins = [view.canon(r) for r in view.data_inputs(c) if r]
            outs = view.node_outputs(c)
            old = shapes.get(view.canon(outs[0]))
            if op == FUSED_ATTENTION_OP:
                # only the bias operand may shrink; it is broadcast into
                # the [B, N, Tq, Tk] logits, so any shape that still
                # broadcasts to the old bias shape is absorbed here
                if len(c.inputs) < 4:
                    return False
                if any(view.canon(r) in hyp for r in c.inputs[:3]):
                    return False
                ob = shapes.get(view.canon(c.inputs[3]))
                nb = hyp.get(view.canon(c.inputs[3]))
                if ob is None or nb is None \
                        or _broadcast(nb, ob) != tuple(ob):
                    return False
                continue
            kind = view.shape_kind(c)
            if kind is None or kind[0] not in ("unary", "binary", "cast",
                                               "identity"):
                return False
            if not _full(old):
                return False
            in_shapes = [hyp.get(r, shapes.get(r)) for r in ins]
            if kind[0] == "binary":
                new = in_shapes[0]
                for s in in_shapes[1:]:
                    new = _broadcast(new, s)
            else:
                new = in_shapes[0]
            if new is None:
                return False
            if tuple(new) == tuple(old):
                continue      # shapes re-converge: downstream unaffected
            if _broadcast(new, old) != tuple(old):
                return False
            o = view.canon(outs[0])
            hyp[o] = tuple(new)
            work.append(o)
    return True


def rule_drop_broadcast(view: _View) -> int:
    """Drop Expand nodes whose materialized broadcast is absorbed further
    down (e.g. the exporter's [B,1,T,T] attention-mask expansion feeding
    the fused attention's bias add) — the shrunken tensor re-broadcasts at
    the consumer for free instead of occupying HBM."""
    view.rebuild()
    shapes, _ = _shape_env(view)
    count = 0
    dead = set()
    for n in list(view.nodes):
        if id(n) in dead:
            continue
        kind = view.shape_kind(n)
        if kind is None or kind[0] != "expand":
            continue
        ins = [r for r in view.data_inputs(n) if r]
        if not ins:
            continue
        out = view.node_outputs(n)[0]
        src_shape = shapes.get(view.canon(ins[0]))
        old_out = shapes.get(view.canon(out))
        if not _full(src_shape) or not _full(old_out) \
                or tuple(src_shape) == tuple(old_out):
            continue  # unknown shapes, or a pure no-op (expand_squeeze rule)
        if not _bcast_absorbable(view, shapes, out, src_shape):
            continue
        if _bypass(view, n, ins[0]):
            dead.add(id(n))
            count += 1
            view.rebuild()
    view.drop_nodes(dead)
    return count


def rule_dce(view: _View) -> int:
    roots = view.dce_roots()
    if roots is None:
        return 0
    view.rebuild()
    live_vals = set()
    stack = [view.canon(resolve_alias(view.aliases, r)) for r in roots]
    live_nodes = set()
    while stack:
        v = stack.pop()
        if v in live_vals:
            continue
        live_vals.add(v)
        n = view.producer(v)
        if n is None or id(n) in live_nodes:
            continue
        live_nodes.add(id(n))
        for r in view.data_inputs(n):
            if r:
                stack.append(view.canon(r))
        for r in view.ctrl_inputs(n):
            stack.append(view.canon(r))
    dead = {id(n) for n in view.nodes
            if id(n) not in live_nodes and not view.is_barrier(n)}
    if not dead:
        return 0
    removed = len(dead)
    view.drop_nodes(dead)
    return removed


RULES: List[Tuple[str, Callable[[_View], int]]] = [
    ("fold_constants", rule_fold_constants),
    ("identity", rule_identity),
    ("noop_cast", rule_noop_cast),
    ("transpose_pairs", rule_transpose_pairs),
    ("reshape_chains", rule_reshape_chains),
    ("expand_squeeze", rule_expand_squeeze),
    ("fuse_attention", rule_fuse_attention),
    ("drop_broadcast", rule_drop_broadcast),
    ("dce", rule_dce),
]


def record_stats(frontend: str, stats: Dict[str, int]) -> None:
    """Emit per-rule rewrite counters through the monitoring registry."""
    try:
        from deeplearning4j_tpu_torch import monitoring

        mon = monitoring.import_monitor()
        if mon is None:
            return
        for rule, c in stats.items():
            if c:
                mon.rewrites.labels(frontend=frontend, rule=rule).inc(c)
    except Exception:
        pass  # metrics are observability, never an import failure


def run_rules(view: _View) -> Dict[str, int]:
    stats: Dict[str, int] = {name: 0 for name, _ in RULES}
    for _ in range(_MAX_PASSES):
        changed = 0
        for name, rule in RULES:
            c = rule(view)
            stats[name] += c
            changed += c
        if not changed:
            break
    record_stats(view.frontend, stats)
    return stats


# --------------------------------------------------------------- ONNX view


class _OnnxView(_View):
    frontend = "onnx"
    identity_ops = frozenset({"Identity", "Dropout"})
    matmul_ops = frozenset({"MatMul"})
    softmax_ops = frozenset({"Softmax"})
    transpose_ops = frozenset({"Transpose"})
    reshape_ops = frozenset({"Reshape"})
    cast_ops = frozenset({"Cast"})
    mul_ops = frozenset({"Mul"})
    div_ops = frozenset({"Div"})
    add_ops = frozenset({"Add"})

    _UNARY = {
        "Relu": None, "Sigmoid": None, "Tanh": None, "Softmax": None,
        "LogSoftmax": None, "Erf": None, "Sqrt": None, "Neg": None,
        "Exp": None, "Log": None, "Abs": None, "Floor": None, "Ceil": None,
        "Round": None, "Reciprocal": None, "Sign": None, "Elu": None,
        "Selu": None, "Celu": None, "HardSigmoid": None, "HardSwish": None,
        "Softplus": None, "Softsign": None, "Mish": None, "Gelu": None,
        "LeakyRelu": None, "LayerNormalization": None,
        "Not": np.dtype(bool), "IsNaN": np.dtype(bool),
    }
    _BINARY = {"Add": None, "Sub": None, "Mul": None, "Div": None,
               "Pow": None, "Mod": None, "Min": None, "Max": None,
               "Sum": None, "Mean": None, "PRelu": None,
               "And": "bool", "Or": "bool", "Xor": "bool",
               "Equal": "bool", "Greater": "bool", "Less": "bool",
               "GreaterOrEqual": "bool", "LessOrEqual": "bool",
               "Where": "select"}
    _REDUCE = frozenset({"ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin",
                         "ReduceProd", "ReduceL1", "ReduceL2",
                         "ReduceLogSumExp", "ReduceSumSquare"})

    def __init__(self, imp):
        super().__init__()
        self.imp = imp
        self.nodes = imp.nodes
        from deeplearning4j_tpu_torch.modelimport.onnx import (
            _ONNX_DTYPES, ONNX_OP_REGISTRY)

        register_synthetic_ops(ONNX_OP_REGISTRY)
        self._registry = ONNX_OP_REGISTRY
        self._dtypes = _ONNX_DTYPES
        self._params = {k for k, v in imp.initializers.items()
                        if np.issubdtype(np.asarray(v).dtype, np.floating)
                        and np.ndim(v) >= 1}

    def node_op(self, n):
        return n.op

    def node_name(self, n):
        return n.name

    def data_inputs(self, n):
        return list(n.inputs)

    def node_outputs(self, n):
        return list(n.outputs) or [n.name]

    def set_data_input(self, n, old, new):
        n.inputs[:] = [new if i == old else i for i in n.inputs]

    def is_barrier(self, n):
        return False

    def known_value(self, ref):
        v = self.imp.initializers.get(ref)
        if v is None:
            v = self.imp._folded.get(ref)
        return v

    def is_param(self, ref):
        return ref in self._params

    def add_folded(self, name, value):
        self.imp._folded[name] = value

    def eval_node(self, n, xs):
        from deeplearning4j_tpu_torch.modelimport.tensorflow import \
            apply_mapper

        fn = self._registry.get(n.op)
        if fn is None:
            raise NotImplementedError(n.op)
        return apply_mapper(fn, n, xs)

    def dce_roots(self):
        return list(self.imp.graph_outputs)

    def input_info(self):
        return dict(getattr(self.imp, "input_info", {}) or {})

    # ---- op-specific accessors
    def _const_ints(self, n, attr_name, input_idx):
        a = n.attr(attr_name) if hasattr(n, "attr") else None
        if a is not None and getattr(a, "ints", None):
            return list(a.ints)
        ins = n.inputs
        if len(ins) > input_idx and ins[input_idx]:
            v = self.known_value(self.canon(ins[input_idx]))
            if v is not None:
                return [int(x) for x in np.asarray(v).ravel()]
        return None

    def transpose_perm(self, n):
        if isinstance(n, SynthNode):
            return n.perm
        p = n.ints("perm")
        if p:
            return list(p)
        return None  # default reversed perm needs rank; treat unknown

    def softmax_axis(self, n):
        a = n.attr("axis")
        return a.i if a is not None and a.i is not None else -1

    def shape_kind(self, n):
        op = n.op
        if isinstance(n, SynthNode):
            if op == SYNTH_TRANSPOSE_OP:
                return ("transpose", n.perm)
            if op == FUSED_ATTENTION_OP:
                return ("identity", None)   # output shape == q shape
            return None
        if op in ("Identity", "Dropout"):
            return ("identity", None)
        if op in self._UNARY:
            return ("unary", self._UNARY[op])
        if op in self._BINARY:
            return ("binary", self._BINARY[op])
        if op == "MatMul":
            return ("matmul", (False, False))
        if op == "Transpose":
            return ("transpose", self.transpose_perm(n))
        if op == "Reshape":
            if len(n.inputs) > 1:
                v = self.known_value(self.canon(n.inputs[1]))
                if v is not None:
                    return ("reshape", [int(d) for d in
                                        np.asarray(v).ravel()])
            return ("reshape", None)
        if op == "Unsqueeze":
            return ("unsqueeze", self._const_ints(n, "axes", 1))
        if op == "Squeeze":
            return ("squeeze", self._const_ints(n, "axes", 1))
        if op == "Cast":
            a = n.attr("to")
            dt = self._dtypes.get(a.i if a is not None else 1)
            return ("cast", None if dt is None else np.dtype(dt))
        if op == "Gather":
            a = n.attr("axis")
            return ("gather", a.i if a is not None and a.i is not None
                    else 0)
        if op == "Expand":
            if len(n.inputs) > 1:
                v = self.known_value(self.canon(n.inputs[1]))
                if v is not None:
                    return ("expand", [int(d) for d in
                                       np.asarray(v).ravel()])
            return ("expand", None)
        if op in self._REDUCE:
            kd = n.attr("keepdims")
            return ("reduce", (self._const_ints(n, "axes", 1),
                               bool(kd.i) if kd is not None else True))
        if op == "Shape":
            return ("shape_of", None)
        if op == "Size":
            return ("size_of", None)
        if op == "Concat":
            a = n.attr("axis")
            return ("concat", a.i if a is not None and a.i is not None
                    else 1)
        if op == "ConstantOfShape":
            if n.inputs and n.inputs[0]:
                v = self.known_value(self.canon(n.inputs[0]))
                if v is not None:
                    return ("constant_of_shape",
                            [int(d) for d in np.asarray(v).ravel()])
            return ("constant_of_shape", None)
        return None


def optimize_onnx(imp) -> Dict[str, int]:
    """Run the pass over an OnnxImportedGraph in place; returns the
    per-rule rewrite counts (also stored as ``imp.import_opt_stats``)."""
    view = _OnnxView(imp)
    stats = run_rules(view)
    imp._aliases.update(view.aliases)
    imp._removed = set(getattr(imp, "_removed", set())) | view.removed
    imp.import_opt_stats = stats
    return stats


# ----------------------------------------------------------------- TF view


class _TFView(_View):
    frontend = "tensorflow"
    identity_ops = frozenset({"Identity", "StopGradient", "PreventGradient",
                              "Snapshot"})
    matmul_ops = frozenset({"BatchMatMul", "BatchMatMulV2", "MatMul"})
    softmax_ops = frozenset({"Softmax"})
    transpose_ops = frozenset({"Transpose"})
    reshape_ops = frozenset({"Reshape"})
    cast_ops = frozenset({"Cast"})
    mul_ops = frozenset({"Mul"})
    div_ops = frozenset({"RealDiv", "Div"})
    add_ops = frozenset({"Add", "AddV2", "BiasAdd"})

    _BARRIERS = frozenset({
        "Const", "Placeholder", "Arg", "_Arg", "_Retval", "NoOp",
        "VarHandleOp", "VariableV2", "Variable", "ReadVariableOp",
        "VarIsInitializedOp", "Switch", "Merge", "If", "StatelessIf",
        "While", "StatelessWhile", "PartitionedCall",
        "StatefulPartitionedCall",
    })
    _UNARY = {
        "Relu": None, "Relu6": None, "Sigmoid": None, "Tanh": None,
        "Softmax": None, "Erf": None, "Rsqrt": None, "Sqrt": None,
        "Square": None, "Neg": None, "Exp": None, "Log": None, "Abs": None,
        "LeakyRelu": None, "Softplus": None, "Elu": None, "Selu": None,
        "Swish": None, "Floor": None, "Ceil": None, "Round": None,
        "Sign": None, "ZerosLike": None, "OnesLike": None,
        "LogicalNot": np.dtype(bool), "IsNan": np.dtype(bool),
        "IsInf": np.dtype(bool), "IsFinite": np.dtype(bool),
    }
    _BINARY = {"Add": None, "AddV2": None, "BiasAdd": None, "Sub": None,
               "Mul": None, "RealDiv": None, "Div": None, "Pow": None,
               "Maximum": None, "Minimum": None, "SquaredDifference": None,
               "FloorDiv": None, "FloorMod": None, "Mod": None,
               "Greater": "bool", "GreaterEqual": "bool", "Less": "bool",
               "LessEqual": "bool", "Equal": "bool", "NotEqual": "bool",
               "LogicalAnd": "bool", "LogicalOr": "bool",
               "Select": "select", "SelectV2": "select"}
    _REDUCE = frozenset({"Mean", "Sum", "Max", "Min", "Prod", "All", "Any"})

    def __init__(self, imp):
        super().__init__()
        self.imp = imp
        self.nodes = [imp.nodes[n] for n in imp.order]
        from deeplearning4j_tpu_torch.modelimport.tensorflow import (
            TF_NP_DTYPES, TF_OP_REGISTRY)

        register_synthetic_ops(TF_OP_REGISTRY)
        self._registry = TF_OP_REGISTRY
        self._cast_dtypes = TF_NP_DTYPES
        self._params = {k for k, v in imp.constants.items()
                        if np.issubdtype(np.asarray(v).dtype, np.floating)
                        and np.ndim(v) >= 1 and np.size(v) > 1}
        self._params |= set(imp.variables)
        # multi-output consumption ("name:N", N > 0) bars structural rules
        self._multi_out = set()
        for n in self.nodes:
            for r in n.inputs:
                r = r.lstrip("^")
                parts = r.split(":")
                if len(parts) > 1 and parts[-1].isdigit() \
                        and int(parts[-1]) > 0:
                    self._multi_out.add(parts[0])

    def canon(self, ref):
        ref = ref.lstrip("^")
        parts = ref.split(":")
        if len(parts) == 2 and parts[1] == "0":
            return parts[0]
        return ref

    def producer(self, ref):
        # "name:N" refs (N > 0) resolve to the producing node by base name
        # (the node itself is barred from rewrites via _multi_out, but DCE
        # liveness must still reach it)
        c = self.canon(ref)
        n = self.producers.get(c)
        if n is None and ":" in c:
            n = self.producers.get(c.split(":")[0])
        return n

    def node_op(self, n):
        return n.op

    def node_name(self, n):
        return n.name

    def data_inputs(self, n):
        return [i for i in n.inputs if not i.startswith("^")]

    def ctrl_inputs(self, n):
        return [i[1:] for i in n.inputs if i.startswith("^")]

    def node_outputs(self, n):
        return [n.name]

    def set_data_input(self, n, old, new):
        co = self.canon(old)
        n.inputs[:] = [new if (not i.startswith("^")
                               and self.canon(i) == co) else i
                       for i in n.inputs]

    def is_barrier(self, n):
        if isinstance(n, SynthNode):
            return False
        return (n.op in self._BARRIERS or n.name in self._multi_out
                or any(i.startswith("^") for i in n.inputs))

    def known_value(self, ref):
        ref = self.canon(ref)
        if ":" in ref:
            return None
        v = self.imp.constants.get(ref)
        if v is None:
            v = self.imp.folded.get(ref)
        return v

    def is_param(self, ref):
        return self.canon(ref) in self._params

    def add_folded(self, name, value):
        self.imp.folded[name] = value

    def eval_node(self, n, xs):
        from deeplearning4j_tpu_torch.modelimport.tensorflow import \
            apply_mapper

        fn = self._registry.get(n.op)
        if fn is None:
            raise NotImplementedError(n.op)
        return apply_mapper(fn, n, xs)

    def dce_roots(self):
        return self._roots

    _roots: Optional[List[str]] = None

    def input_info(self):
        out = {}
        for name in self.imp.placeholders:
            node = self.imp.nodes.get(name)
            if node is None:
                continue
            sh = node.attr("shape")
            dt = node.attr("dtype")
            shape = None
            if sh is not None and sh.shape is not None:
                shape = tuple(None if d < 0 else int(d) for d in sh.shape)
            np_dt = None
            if dt is not None and dt.type in self._cast_dtypes:
                np_dt = np.dtype(self._cast_dtypes[dt.type])
            out[name] = (np_dt, shape)
        for name, v in self.imp.variables.items():
            a = np.asarray(v)
            out[name] = (a.dtype, tuple(int(d) for d in a.shape))
        return out

    # ---- op-specific accessors
    def _const_input(self, n, idx):
        ins = self.data_inputs(n)
        if len(ins) <= idx:
            return None
        v = self.known_value(ins[idx])
        if v is None:
            return None
        return [int(x) for x in np.asarray(v).ravel()]

    def transpose_perm(self, n):
        if isinstance(n, SynthNode):
            return n.perm
        return self._const_input(n, 1)

    def matmul_adj(self, n):
        if isinstance(n, SynthNode):
            return (False, False)
        if n.op in ("BatchMatMul", "BatchMatMulV2"):
            ax, ay = n.attr("adj_x"), n.attr("adj_y")
            return (bool(ax.b) if ax is not None else False,
                    bool(ay.b) if ay is not None else False)
        ta, tb = n.attr("transpose_a"), n.attr("transpose_b")
        return (bool(ta.b) if ta is not None else False,
                bool(tb.b) if tb is not None else False)

    def shape_kind(self, n):
        op = n.op
        if isinstance(n, SynthNode):
            if op == SYNTH_TRANSPOSE_OP:
                return ("transpose", n.perm)
            if op == FUSED_ATTENTION_OP:
                return ("identity", None)
            return None
        if op in self.identity_ops or op == "ReadVariableOp":
            return ("identity", None)
        if op in self._UNARY:
            return ("unary", self._UNARY[op])
        if op in self._BINARY:
            return ("binary", self._BINARY[op])
        if op in self.matmul_ops:
            return ("matmul", self.matmul_adj(n))
        if op == "Transpose":
            return ("transpose", self.transpose_perm(n))
        if op == "Reshape":
            return ("reshape", self._const_input(n, 1))
        if op == "ExpandDims":
            ax = self._const_input(n, 1)
            return ("unsqueeze", ax if ax else None)
        if op == "Squeeze":
            dims = n.attr("squeeze_dims") or n.attr("axis")
            return ("squeeze",
                    list(dims.list_i) if dims is not None and dims.list_i
                    else None)
        if op == "Cast":
            dst = n.attr("DstT")
            dt = self._cast_dtypes.get(dst.type if dst is not None else 1)
            return ("cast", None if dt is None else np.dtype(dt))
        if op == "GatherV2" or op == "Gather":
            ax = self._const_input(n, 2)
            return ("gather", ax[0] if ax else 0)
        if op in self._REDUCE:
            axes = self._const_input(n, 1)
            kd = n.attr("keep_dims")
            return ("reduce", (axes, bool(kd.b) if kd is not None
                               else False))
        if op == "Shape":
            return ("shape_of", None)
        if op == "Size":
            return ("size_of", None)
        if op == "ConcatV2":
            ins = self.data_inputs(n)
            ax = None
            if ins:
                v = self.known_value(ins[-1])
                if v is not None:
                    ax = int(np.asarray(v).ravel()[0])
            return None if ax is None else ("concat", ax)
        if op == "Fill":
            dims = self._const_input(n, 0)
            return ("constant_of_shape", dims)
        return None

    def softmax_axis(self, n):
        return -1   # tf.nn.softmax default; the importer maps axis=-1


def optimize_tf(imp, roots: Optional[List[str]] = None) -> Dict[str, int]:
    """Run the pass over a TFImportedGraph in place. ``roots`` (e.g. the
    SavedModel signature outputs) enables dead-node elimination; without
    them every node is kept live (frozen GraphDefs are probed at arbitrary
    node names)."""
    view = _TFView(imp)
    view._roots = list(roots) if roots else None
    stats = run_rules(view)
    imp.aliases.update(view.aliases)
    imp.removed = set(getattr(imp, "removed", set())) | view.removed
    # write the (possibly rewritten) node list back into the graph fields
    imp.nodes = {view.node_name(n): n for n in view.nodes}
    imp.order = [view.node_name(n) for n in view.nodes]
    imp.import_opt_stats = stats
    return stats


# -------------------------------------------------------------- keras pass


def prune_keras_layers(layers_cfg: List[dict], *, graph: bool,
                       outputs: Sequence[str] = ()) -> Tuple[List[dict],
                                                             Dict[str, int]]:
    """Layer-level application of the pass for the Keras frontend: drop
    exporter no-ops — rate-0 Dropout/SpatialDropout and linear Activation
    layers. In graph (Functional) configs, consumers are rewired to the
    dropped layer's sole parent; output layers are never dropped."""
    stats = {"noop_dropout": 0, "identity_layer": 0}

    def rule_of(lc):
        cls = lc["class_name"]
        cfg = lc.get("config", {})
        if cls in ("Dropout", "SpatialDropout1D", "SpatialDropout2D") \
                and float(cfg.get("rate", 0.0) or 0.0) == 0.0:
            return "noop_dropout"
        if cls == "Activation" and cfg.get("activation",
                                           "linear") == "linear":
            return "identity_layer"
        return None

    out_set = set(outputs)
    kept: List[dict] = []
    rename: Dict[str, str] = {}

    def parent_of(lc):
        nodes = lc.get("inbound_nodes") or [[]]
        refs = nodes[0] if nodes else []
        if len(refs) != 1:
            return None
        return refs[0][0]

    for lc in layers_cfg:
        name = lc.get("config", {}).get("name") or lc.get("name")
        rule = rule_of(lc)
        if rule is None or name in out_set:
            kept.append(lc)
            continue
        if graph:
            parent = parent_of(lc)
            if parent is None:
                kept.append(lc)
                continue
            rename[name] = parent
        else:
            # sequential configs with the input shape attached to the
            # first layer must not lose it
            cfg = lc.get("config", {})
            if "batch_input_shape" in cfg or "batch_shape" in cfg:
                kept.append(lc)
                continue
        stats[rule] += 1

    if graph and rename:
        def resolve(n):
            seen = set()
            while n in rename and n not in seen:
                seen.add(n)
                n = rename[n]
            return n

        for lc in kept:
            for node_group in (lc.get("inbound_nodes") or []):
                for ref in node_group:
                    if ref and isinstance(ref, list):
                        ref[0] = resolve(ref[0])
    return kept, stats
