"""Continuous-batching generation engine: one decode step, replayed.

Counterpart of ``deeplearning4j_tpu/generation/engine.py``: a fixed slot
pool of per-sequence decode state, one decode step for the whole pool per
call (every slot at ``[n_slots, 1]``), a seeded sampler, and continuous
admission/retirement (``continuous=False`` is the static
run-to-completion baseline). Requests submitted with ``klass="batch"`` wait
in a low-priority lane that gets a freed slot only when no other request is
waiting.

Two model families share the engine through adapters with one interface:
``init_state(n)``, ``decode(state, tokens, pos)``, ``prefill_prompt(ids,
buckets)`` (a prompt's state, padded as the adapter needs) and
``position_addressed`` (whether prompt + new tokens must fit ``max_len``):

- ``RecurrentDecodeAdapter``: LSTM, GravesLSTM, GRU and SimpleRnn stacks;
  the slot state is the per-layer carry dict. It ignores ``pos`` and
  prefills a prompt at its true length.
- ``AttentionDecodeAdapter``: causal transformer stacks; the slot state is
  one KV ring per encoder layer (f32/bf16, or int8 with per-(row, head)
  scales), stepped through ``TransformerEncoderLayer.apply_step``. A
  prompt prefills padded to its pow2 bucket.

The JAX package compiles the decode step once (``jax.jit``) and replays
that one program for the engine's life. The analog here is a CUDA graph: on
a CUDA engine the first decode step captures ``adapter.decode`` over the
whole pool, on fixed input buffers (tokens, positions) and the pool's state
tensors, and every later step replays it. The recurrent adapter's new
carries are copied back into the pool's tensors inside the graph; the
attention adapter writes its rings in place. Admission copies a slot's
prefilled rows into those same tensors, so the graph's addresses hold.
The parameters are cast to the compute type once, outside the graph (the
JAX step casts each step, ``_tree_cast``); the engine captures again when
``net.params`` is replaced (``fit_batch`` and ``load_jax_params`` replace
it). A capture that fails raises, naming the operation that broke it:
there is no eager fallback on the card. On the CPU the step runs eagerly.
Sampling stays on the host, reading the step's logits.

``decode_programs`` counts the decode signatures (one graph each on the
card) and stays 1; ``replays`` counts graph replays. The kernels' wrappers
count launches on the host, so a replay counts none: a step launches
``capture_launches`` (what the capture recorded, by kernel name) each
replay. ``prefill_programs`` counts the distinct prefill shapes.

Attention prompts prefill padded to pow2 buckets
(``serving/warmup.py``), as in the JAX package: under the causal mask the
pad rows change no real position, and every pad row written into the ring
is overwritten by the decode step that reaches its position before the
validity mask admits it. Recurrent prompts prefill at their true length
(T = prompt length - 1), one call of each layer's op: the kernels cannot
gate a padded carry, and the JAX package's gated scan gives the same carry
(the tests hold the two against each other).

A ``journal`` (``generation/sessions.py``) makes requests submitted with a
``request_id`` durable. Not ported: request tracing, monitoring and the
engine's fault hooks (its ``faults.active()`` preempt points; ``faults``
itself is ported), which come with the monitoring layer.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
import traceback
from typing import List, Optional, Sequence, Tuple, Union

import torch

from deeplearning4j_tpu_torch.common.device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.common.trees import tree_leaves
from deeplearning4j_tpu_torch.generation.sampler import sample_logits
from deeplearning4j_tpu_torch.generation.slots import SlotPool
from deeplearning4j_tpu_torch.nn.layers.attention import (
    PositionalEmbeddingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.core import (
    EmbeddingLayer, EmbeddingSequenceLayer,
)
from deeplearning4j_tpu_torch.quantize.kvcache import quantize_cache
from deeplearning4j_tpu_torch.serving.warmup import bucket_for, pow2_buckets


@dataclasses.dataclass(frozen=True)
class GenerationRequest:
    """One decode job: prompt token ids + sampling knobs + stop conditions."""

    prompt: Tuple[int, ...]
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    eos_id: Optional[int] = None


_DONE = object()


class GenerationStream:
    """Token stream for one request: iterate to receive tokens as the engine
    emits them. ``finish_reason`` is eos / length / cancelled / preempted
    afterwards. A journaled stream carries its ``request_id`` and ``seq0``,
    the tokens its session emitted before this stream (non-zero on a
    resume)."""

    def __init__(self, request: GenerationRequest,
                 request_id: Optional[str] = None):
        self.request = request
        self.request_id = request_id
        self.seq0 = 0
        self.tokens: List[int] = []
        self.finish_reason: Optional[str] = None
        self.submitted_at = time.monotonic()
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._cancelled = False
        self._cancel_reason = "cancelled"
        self._done_evt = threading.Event()

    # engine side -----------------------------------------------------
    def _emit(self, token: int) -> None:
        if self.first_token_at is None:
            self.first_token_at = time.monotonic()
        self.tokens.append(token)
        self._q.put(token)

    def _finish(self, reason: str) -> None:
        self.finish_reason = reason
        self.finished_at = time.monotonic()
        self._q.put(_DONE)
        self._done_evt.set()

    # consumer side ---------------------------------------------------
    def cancel(self, reason: str = "cancelled") -> None:
        """Ask the engine to retire this request at its next step;
        ``reason="preempted"`` keeps its journal record open for resume."""
        self._cancel_reason = reason
        self._cancelled = True

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    @property
    def done(self) -> bool:
        return self.finish_reason is not None

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is _DONE:
                return
            yield item

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the request finishes; False if ``timeout`` expired."""
        return self._done_evt.wait(timeout)

    def result(self) -> List[int]:
        """Block until the request finishes; returns all emitted tokens."""
        for _ in self:
            pass
        return self.tokens


class _Adapter:
    """What both adapters share: the net, and its parameters in the
    compute type, cast once for each ``net.params`` tree."""

    def __init__(self, net):
        self.net = net
        self._cast_src = None
        self._cast = None

    def params(self):
        if self._cast_src is not self.net.params:
            self._cast = self.net._compute_params()
            self._cast_src = self.net.params
        return self._cast


class RecurrentDecodeAdapter(_Adapter):
    """Slot state = the net's own carry dict ({layer_idx: carry tuple}:
    (h, c) for an LSTM layer, (h,) for a GRU or SimpleRnn layer).

    Tokens enter as one-hot vectors over the output layer's vocabulary: the
    char-RNN convention where input and output alphabets coincide."""

    def __init__(self, net):
        if not any(hasattr(l, "apply_with_carry") for l in net.layers):
            raise ValueError("network has no recurrent apply_with_carry "
                             "layers")
        super().__init__(net)
        self.vocab = net.layers[-1].n_out

    #: the carry is not addressed by position: only the prompt has to fit
    #: the engine's max_len
    position_addressed = False

    def init_state(self, n: int):
        return self.net._init_carries(n)

    def _encode(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token ids [B, T] -> one-hot model input [B, T, vocab], by
        comparison (no host check of the ids, so a graph can hold it)."""
        classes = torch.arange(self.vocab, device=tokens.device)
        return (tokens[..., None] == classes).to(
            self.net._policy.compute_dtype)

    @torch.no_grad()
    def decode(self, carries, tokens: torch.Tensor, pos=None):
        """One step for every slot: logits [B, vocab] + advanced carries."""
        net = self.net
        preout, _, new_c = net._forward_carry(
            self.params(), net.state, self._encode(tokens[:, None]), carries)
        merged = dict(carries)
        merged.update(new_c)
        return preout[:, 0].to(torch.float32), merged

    @torch.no_grad()
    def prefill(self, prompt: Sequence[int]):
        """The carry for one slot after consuming ``prompt`` (the ids before
        the last prompt token), in one call of its op per recurrent
        layer."""
        net = self.net
        carries = self.init_state(1)
        if not prompt:
            return carries
        ids = torch.as_tensor([list(prompt)], dtype=torch.long,
                              device=net.device)
        _, _, new_c = net._forward_carry(self.params(), net.state,
                                         self._encode(ids), carries)
        carries.update(new_c)
        return carries

    def prefill_prompt(self, ids: Sequence[int], buckets):
        """The engine's prefill of ``ids`` (a prompt before its last token)
        at its true length, as the kernels cannot gate a padded carry;
        ``buckets`` is unused. Returns (the carry, the prefill's shape)."""
        return self.prefill(ids), len(ids)


class AttentionDecodeAdapter(_Adapter):
    """Slot state = one KV ring per encoder layer ({layer_idx: (k, v)},
    each [n_slots, n_heads, max_len, head_dim] of the compute type, or the
    int8 4-tuple (k, v, k_scale, v_scale) with ``kv_dtype="int8"``).

    Walks the net's layer list as the JAX adapter does: an embedding looks
    up ``W[tokens]``, a positional embedding adds ``P[pos]`` per row, an
    encoder layer runs ``apply_step`` against its ring, the output layer
    gives the logits, and any other layer runs its ``apply`` on a
    singleton time axis. The stack must be causal: decode then computes
    what the full forward computes.

    The JAX package keeps the pool's f32/bf16 rings in f32 and casts each
    read to the compute type; here the rings are of the compute type. The
    values are the same (each K/V is computed in the compute type), at
    half the bytes in bf16."""

    def __init__(self, net, max_len: int, kv_dtype: Optional[str] = None):
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"unsupported kv_dtype {kv_dtype!r}")
        super().__init__(net)
        self.max_len = max_len
        self.kv_dtype = kv_dtype
        self._tf_layers = [i for i, l in enumerate(net.layers)
                           if hasattr(l, "apply_step")]
        if not self._tf_layers:
            raise ValueError("no transformer layers with a cached-decode "
                             "path in this network")
        for i in self._tf_layers:
            if not net.layers[i].causal:
                raise ValueError(
                    f"layer {i} is not causal=True; KV-cached decode only "
                    "matches a causal forward")
        for l in net.layers:
            if isinstance(l, PositionalEmbeddingLayer) and l.max_len < max_len:
                raise ValueError(
                    f"engine max_len {max_len} exceeds positional table "
                    f"({l.max_len})")

    #: the positional table and the ring are addressed by position: the
    #: whole stream (prompt + new tokens) has to fit the engine's max_len
    position_addressed = True

    def init_state(self, n: int):
        dt = self.net._policy.compute_dtype
        return {i: self.net.layers[i].init_cache(
                    n, self.max_len, dtype=dt, kv_dtype=self.kv_dtype,
                    device=self.net.device)
                for i in self._tf_layers}

    @torch.no_grad()
    def decode(self, caches, tokens: torch.Tensor, pos: torch.Tensor):
        """One step for every slot: logits [B, vocab] f32 and the caches,
        written in place."""
        net = self.net
        cp = self.params()
        x = None
        last = len(net.layers) - 1
        for i, layer in enumerate(net.layers):
            p = cp[i]
            if i == last and hasattr(layer, "preout"):
                return (layer.preout(p, x[:, None, :])[:, 0].to(
                    torch.float32), caches)
            if isinstance(layer, (EmbeddingLayer, EmbeddingSequenceLayer)):
                x = p["W"][tokens]
                if layer.has_bias:
                    x = x + p["b"]
            elif isinstance(layer, PositionalEmbeddingLayer):
                x = x + p["P"][pos]
            elif hasattr(layer, "apply_step"):
                x, caches[i] = layer.apply_step(p, x, caches[i], pos)
            else:
                y, _ = layer.apply(p, net.state[i], x[:, None, :])
                x = y[:, 0]
        raise ValueError("network has no preout output layer")

    @torch.no_grad()
    def prefill(self, prompt: torch.Tensor, length: Optional[int] = None):
        """Causal forward over the padded prompt [B, Tb], each encoder
        layer's K/V harvested into a fresh ring.

        Where the prompt fits the ring (Tb <= L, the engine's case) ring
        slot c holds position c and ``length`` is unused. Where it is
        longer (a resume past a ring wrap, on an adapter whose ring is
        shorter than the engine's ``max_len``), slot r takes the one
        position p = r (mod L) of the live window [length - L, length):
        the ring a sequential decode would have left. An int8 ring is
        quantized once over the whole seeded ring."""
        net = self.net
        cp = self.params()
        x = None
        caches = {}
        L = self.max_len
        B, Tb = prompt.shape
        for i, layer in enumerate(net.layers):
            p = cp[i]
            if i == len(net.layers) - 1 and hasattr(layer, "preout"):
                break
            if hasattr(layer, "apply_step"):
                x, (k, v) = layer.apply_prefill(p, x)
                if Tb <= L:
                    ck, cv = layer.init_cache(B, L, dtype=k.dtype,
                                              device=k.device)
                    ck[:, :, :Tb] = k
                    cv[:, :, :Tb] = v
                else:
                    r = torch.arange(L, device=k.device)
                    start = int(length) - L
                    p_abs = start + (r - start) % L
                    idx = p_abs.clamp(0, Tb - 1)
                    keep = (p_abs >= 0)[None, None, :, None]
                    ck = torch.where(keep, k[:, :, idx], 0)
                    cv = torch.where(keep, v[:, :, idx], 0)
                if self.kv_dtype == "int8":
                    qk, sk = quantize_cache(ck)
                    qv, sv = quantize_cache(cv)
                    caches[i] = (qk, qv, sk, sv)
                else:
                    caches[i] = (ck, cv)
            else:
                x, _ = layer.apply(p, net.state[i],
                                   prompt if x is None else x)
        return caches

    def prefill_prompt(self, ids: Sequence[int], buckets):
        """The engine's prefill of ``ids`` (a prompt before its last token),
        zero-padded to its bucket of ``buckets`` so that prompt lengths
        share a few shapes. Returns (the ring, the bucket)."""
        n = len(ids)
        Tb = bucket_for(n, buckets)
        padded = torch.zeros((1, Tb), dtype=torch.long)
        padded[0, :n] = torch.as_tensor(ids)
        return self.prefill(padded.to(self.net.device), n), Tb


def _auto_adapter(net, max_len: int, kv_dtype: Optional[str] = None):
    if any(hasattr(l, "apply_step") for l in net.layers):
        return AttentionDecodeAdapter(net, max_len, kv_dtype=kv_dtype)
    if kv_dtype is not None:
        raise ValueError("kv_dtype requires attention layers with a "
                         "KV-cached decode path")
    if any(hasattr(l, "apply_with_carry") for l in net.layers):
        return RecurrentDecodeAdapter(net)
    raise ValueError("network has neither transformer apply_step nor "
                     "recurrent apply_with_carry layers")


def _signature(tree) -> tuple:
    return tuple((tuple(t.shape), t.dtype, t.device.type)
                 for t in tree_leaves(tree))


def _copy_into(dst, src) -> None:
    """Copy every leaf of ``src`` into the same leaf of ``dst`` (a leaf
    that is already that tensor is skipped)."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        if d is not s:
            d.copy_(s)


class GenerationEngine:
    """Continuous-batching decode over a fixed slot pool.

    ``slots`` is the pool's capacity; ``max_len`` bounds prompt length (and
    prompt + new tokens for a transformer, whose ring it sizes).
    ``device`` defaults to the card and must be where ``net`` lives.
    ``adapter`` overrides the one the engine picks; ``kv_dtype="int8"``
    asks the attention adapter for int8 rings. Drive it synchronously
    (``step()``/``drain()``/``generate()``) or start the background loop
    (``start()``) and consume ``submit()`` streams from other threads.
    Only one thread may call ``step()``; ``submit()``/``cancel()`` are
    thread-safe."""

    def __init__(self, net, *, slots: int = 8, max_len: int = 128,
                 eos_id: Optional[int] = None, continuous: bool = True,
                 adapter=None, codec=None, kv_dtype: Optional[str] = None,
                 journal=None, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        if net.device != self.device:
            raise ValueError(f"net lives on {net.device}, the engine was "
                             f"asked for {self.device}; call net.to(...)")
        self.net = net
        self.max_len = int(max_len)
        self.eos_id = eos_id
        self.continuous = continuous
        self.codec = codec
        #: SessionJournal or None; with None the engine makes no journal
        #: call
        self.journal = journal
        if adapter is not None and kv_dtype is not None:
            raise ValueError("pass kv_dtype to the adapter OR let the "
                             "engine build one, not both")
        self.adapter = adapter if adapter is not None else _auto_adapter(
            net, self.max_len, kv_dtype=kv_dtype)
        self.pool = SlotPool(int(slots), self.adapter.init_state)
        self.buckets = pow2_buckets(max(1, self.max_len - 1))
        # the step's inputs: row 0 the tokens, row 1 the positions, copied
        # from a pinned host staging buffer on the card
        n = self.pool.n_slots
        self._inputs = torch.zeros((2, n), dtype=torch.long,
                                   device=self.device)
        self._staging = torch.zeros((2, n), dtype=torch.long,
                                    pin_memory=self.device.type == "cuda")
        self._decode_sigs: set = set()
        self._prefill_shapes: set = set()
        self._graph = None
        self._graph_params = None
        self._graph_logits = None
        #: CUDA-graph replays, captures, and the kernel launches one
        #: captured step makes ({kernel name: launches})
        self.replays = 0
        self.captures = 0
        self.capture_launches: dict = {}
        self._pending: "collections.deque[GenerationStream]" = collections.deque()
        self._pending_lo: "collections.deque[GenerationStream]" = collections.deque()
        self._cond = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._accepting = True
        self._admitting: Optional[GenerationStream] = None
        self.steps_run = 0

    def attach_journal(self, journal) -> None:
        """Arm session journaling before traffic: requests submitted with a
        ``request_id`` after this point are durable."""
        self.journal = journal

    # ---------------------------------------------------- decode programs
    @property
    def decode_programs(self) -> int:
        """Decode signatures seen (one captured graph each on the card);
        stays 1 for the engine's life (fixed shapes)."""
        return len(self._decode_sigs)

    @property
    def prefill_programs(self) -> int:
        """Distinct prefill shapes: bounded by the buckets for the
        attention adapter; the true prompt lengths for the recurrent one."""
        return len(self._prefill_shapes)

    def _decode_into_pool(self) -> torch.Tensor:
        """``adapter.decode`` over the whole pool on the fixed inputs, the
        new state copied into the pool's own tensors; the logits."""
        logits, new_state = self.adapter.decode(
            self.pool.state, self._inputs[0], self._inputs[1])
        _copy_into(self.pool.state, new_state)
        return logits

    def _capture(self) -> None:
        """Capture one decode step into a CUDA graph. A side-stream warm-up
        first builds the kernels, fills the registry's choices and casts the
        parameters; the pool's state is restored after it."""
        from deeplearning4j_tpu_torch.ops.cuda import KERNELS

        self._graph = self._graph_logits = None
        saved = [t.clone() for t in tree_leaves(self.pool.state)]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                self._decode_into_pool()
        torch.cuda.current_stream(self.device).wait_stream(side)
        before = {k.name: k.launches for k in KERNELS}
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                logits = self._decode_into_pool()
        except Exception as e:
            frame = traceback.extract_tb(e.__traceback__)[-1]
            raise RuntimeError(
                f"capturing the decode step into a CUDA graph failed at "
                f"{frame.filename}:{frame.lineno} ({frame.line}): {e}") from e
        for t, s in zip(tree_leaves(self.pool.state), saved):
            t.copy_(s)
        self.capture_launches = {k.name: k.launches - before[k.name]
                                 for k in KERNELS
                                 if k.launches != before[k.name]}
        self.captures += 1
        self._graph, self._graph_logits = graph, logits
        self._graph_params = self.net.params

    def decode_pool(self) -> torch.Tensor:
        """One decode step for the whole pool on the current inputs: a
        replay of the captured graph on the card (captured first where
        there is none, or ``net.params`` was replaced), eager on the CPU.
        Returns the logits [n_slots, vocab] f32."""
        self._decode_sigs.add((_signature(self.pool.state),
                               _signature(self._inputs)))
        if self.device.type != "cuda":
            return self._decode_into_pool()
        if self._graph is None or self._graph_params is not self.net.params:
            self._capture()
        self._graph.replay()
        self.replays += 1
        return self._graph_logits

    # ------------------------------------------------------------- submit
    def submit(self, prompt: Union[str, Sequence[int]], *,
               max_new_tokens: int = 32, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0, seed: int = 0,
               eos_id: Optional[int] = None,
               klass: Optional[str] = None,
               request_id: Optional[str] = None) -> GenerationStream:
        """Queue a request; returns its token stream immediately.
        ``klass="batch"`` rides the low-priority pending lane. On a
        journal-armed engine a ``request_id`` makes the session durable; a
        known id is a resume, whose sequence numbers continue the
        journal's."""
        if isinstance(prompt, str):
            if self.codec is None:
                raise ValueError("string prompt needs a codec")
            ids = tuple(self.codec.encode(prompt))
        else:
            ids = tuple(int(t) for t in prompt)
        if not ids:
            raise ValueError("empty prompt")
        if len(ids) > self.max_len:
            raise ValueError(
                f"prompt length {len(ids)} exceeds max_len {self.max_len}")
        if (self.adapter.position_addressed
                and len(ids) + max_new_tokens > self.max_len):
            raise ValueError(
                f"prompt + max_new_tokens = {len(ids) + max_new_tokens} "
                f"exceeds max_len {self.max_len}")
        req = GenerationRequest(
            prompt=ids, max_new_tokens=int(max_new_tokens),
            temperature=float(temperature), top_k=int(top_k),
            top_p=float(top_p), seed=int(seed),
            eos_id=self.eos_id if eos_id is None else eos_id)
        stream = GenerationStream(req, request_id=request_id)
        with self._cond:
            if not self._accepting:
                raise RuntimeError("engine is shut down")
            if self.journal is not None and request_id is not None:
                # journal the admission before the engine loop can reach
                # the stream: no token precedes its open line
                self.journal.attach(stream, klass=klass)
            (self._pending_lo if klass == "batch" else self._pending).append(stream)
            self._cond.notify_all()
        return stream

    def has_work(self) -> bool:
        return (bool(self._pending) or bool(self._pending_lo)
                or self.pool.occupancy() > 0)

    def pending_count(self) -> int:
        return len(self._pending) + len(self._pending_lo)

    # ---------------------------------------------------------- scheduler
    def _prefill_state(self, ids: Tuple[int, ...]):
        if len(ids) == 1:
            return self.adapter.init_state(1)
        state, shape = self.adapter.prefill_prompt(ids[:-1], self.buckets)
        self._prefill_shapes.add(shape)
        return state

    def _admit(self) -> None:
        if not self.continuous and self.pool.occupancy() > 0:
            return  # static batching: wait for the whole batch to finish
        free = self.pool.free_slots()
        while free:
            with self._cond:
                if self._pending:
                    stream = self._pending.popleft()
                elif self._pending_lo:
                    stream = self._pending_lo.popleft()
                else:
                    return
            if stream.cancelled:
                self._finish_stream(stream, stream._cancel_reason)
                continue
            ids = stream.request.prompt
            self._admitting = stream
            try:
                sub = self._prefill_state(ids)
            finally:
                self._admitting = None
            if stream.cancelled:
                self._finish_stream(stream, stream._cancel_reason)
                continue
            req = stream.request
            self.pool.admit(
                free.pop(0), sub, token=ids[-1], pos=len(ids) - 1,
                seed=req.seed, temperature=req.temperature, top_k=req.top_k,
                top_p=req.top_p, meta=stream)

    def _finish_stream(self, stream: GenerationStream, reason: str) -> None:
        if self.journal is not None and stream.request_id is not None:
            self.journal.finished(stream, reason)
        stream._finish(reason)

    def _retire(self, slot: int, reason: str) -> None:
        self._finish_stream(self.pool.retire(slot), reason)

    def step(self) -> bool:
        """Admit + one decode step for the whole pool. Returns False when
        there was nothing to do. One calling thread only."""
        self._admit()
        for s in self.pool.active_slots():
            if self.pool.meta[s].cancelled:
                self._retire(s, self.pool.meta[s]._cancel_reason)
        act = self.pool.active_slots()
        if not act:
            return False
        pool = self.pool
        staged = self._staging.numpy()
        staged[0] = pool.tokens
        staged[1] = pool.pos
        self._inputs.copy_(self._staging, non_blocking=True)
        logits = self.decode_pool()
        nxt = sample_logits(logits, seeds=pool.seeds, pos=pool.pos,
                            temperature=pool.temps, top_k=pool.top_k,
                            top_p=pool.top_p, rows=act)
        self.steps_run += 1
        for s in act:
            stream: GenerationStream = pool.meta[s]
            if stream.cancelled:
                self._retire(s, stream._cancel_reason)
                continue
            tok = int(nxt[s])
            pool.pos[s] += 1
            pool.tokens[s] = tok
            req = stream.request
            if req.eos_id is not None and tok == req.eos_id:
                self._retire(s, "eos")
                continue
            stream._emit(tok)
            if self.journal is not None and stream.request_id is not None:
                self.journal.emitted(stream, tok)
            if len(stream.tokens) >= req.max_new_tokens:
                self._retire(s, "length")
        return True

    def drain(self, max_steps: Optional[int] = None) -> int:
        """Step synchronously until idle (or ``max_steps``)."""
        steps = 0
        while self.has_work():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return steps

    def generate(self, prompt, **kw) -> List[int]:
        """Convenience one-shot: submit + run to completion + tokens."""
        stream = self.submit(prompt, **kw)
        if self._thread is None:
            self.drain()
        return stream.result()

    # ----------------------------------------------------- background loop
    def start(self) -> "GenerationEngine":
        """Run the step loop in a daemon thread (the serving mode)."""
        if self._thread is not None:
            return self
        self._running = True
        self._thread = threading.Thread(
            target=self._loop, name="dl4j-torch-generate", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while True:
            with self._cond:
                while self._running and not self.has_work():
                    self._cond.wait(timeout=0.05)
                if not self._running and not self.has_work():
                    return
            self.step()

    def shutdown(self, timeout: float = 10.0,
                 reason: str = "cancelled") -> None:
        """Stop accepting, let in-flight streams finish up to ``timeout``
        seconds, then cancel whatever remains and stop the loop.
        ``reason="preempted"`` leaves the stragglers' journal records open,
        so a restarted engine resumes them."""
        deadline = time.monotonic() + timeout
        with self._cond:
            self._accepting = False
            self._cond.notify_all()
        if self._thread is not None:
            while time.monotonic() < deadline and self.has_work():
                time.sleep(0.01)
        else:
            while time.monotonic() < deadline and self.has_work():
                self.step()
        with self._cond:
            pending = list(self._pending) + list(self._pending_lo)
            self._pending = collections.deque()
            self._pending_lo = collections.deque()
        admitting = self._admitting
        if admitting is not None:
            admitting.cancel(reason)
        for stream in pending:
            self._finish_stream(stream, reason)
        for s in self.pool.active_slots():
            self.pool.meta[s].cancel(reason)
        if self._thread is not None:
            with self._cond:
                self._running = False
                self._cond.notify_all()
            self._thread.join(timeout=5.0)
            self._thread = None
        for s in self.pool.active_slots():
            self._retire(s, reason)
