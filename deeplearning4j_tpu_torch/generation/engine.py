"""Continuous-batching generation engine for recurrent nets.

Counterpart of ``deeplearning4j_tpu/generation/engine.py``: a fixed slot
pool of per-sequence carries, one decode step for the whole pool per call
(every slot at ``[n_slots, 1]``, so each LSTM or GRU layer launches its
fused forward kernel once per step at the same shape), a seeded sampler,
and continuous admission/retirement (``continuous=False`` is the static
run-to-completion baseline). Requests submitted with ``klass="batch"`` wait
in a low-priority lane that gets a freed slot only when no other request is
waiting. The net may stack any recurrent layers with a carry (LSTM,
GravesLSTM, GRU, SimpleRnn).

Prefill runs each recurrent layer's op (``lstm_layer``, ``gru_layer``)
once over the true ``prompt[:-1]`` at batch 1, so the kernel sees T =
prompt length - 1. The JAX package pads prompts to
pow2 buckets and gates a scan so padding cannot advance the carry; running
the true length gives the same carry with no padding at all (the tests
hold the two against each other).

Not ported in this slice: the session journal, request tracing, monitoring
and fault hooks, ``AttentionDecodeAdapter`` and the ``decode_programs``
witness (its torch analog, a CUDA-graph replay count, comes with graph
capture).
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import List, Optional, Sequence, Tuple, Union

import torch

from deeplearning4j_tpu_torch.common.device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.generation.sampler import sample_logits
from deeplearning4j_tpu_torch.generation.slots import SlotPool


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
    emits them. ``finish_reason`` is eos / length / cancelled afterwards."""

    def __init__(self, request: GenerationRequest):
        self.request = request
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
        """Ask the engine to retire this request at its next step."""
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


class RecurrentDecodeAdapter:
    """Slot state = the net's own carry dict ({layer_idx: carry tuple}:
    (h, c) for an LSTM layer, (h,) for a GRU or SimpleRnn layer).

    Tokens enter as one-hot vectors over the output layer's vocabulary: the
    char-RNN convention where input and output alphabets coincide."""

    def __init__(self, net):
        if not any(hasattr(l, "apply_with_carry") for l in net.layers):
            raise ValueError("network has no recurrent apply_with_carry "
                             "layers (the attention adapter is not ported)")
        self.net = net
        self.vocab = net.layers[-1].n_out

    def init_state(self, n: int):
        return self.net._init_carries(n)

    def _encode(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token ids [B, T] -> one-hot model input [B, T, vocab]."""
        oh = torch.nn.functional.one_hot(tokens, self.vocab)
        return oh.to(self.net._policy.compute_dtype)

    @torch.no_grad()
    def decode(self, carries, tokens: torch.Tensor):
        """One step for every slot: logits [B, vocab] + advanced carries."""
        net = self.net
        preout, _, new_c = net._forward_carry(
            net._compute_params(), net.state, self._encode(tokens[:, None]),
            carries)
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
        _, _, new_c = net._forward_carry(net._compute_params(), net.state,
                                         self._encode(ids), carries)
        carries.update(new_c)
        return carries


class GenerationEngine:
    """Continuous-batching decode over a fixed slot pool.

    ``slots`` is the pool's capacity; ``max_len`` bounds prompt length.
    ``device`` defaults to the card and must be where ``net`` lives. Drive
    it synchronously (``step()``/``drain()``/``generate()``) or start the
    background loop (``start()``) and consume ``submit()`` streams from
    other threads. Only one thread may call ``step()``;
    ``submit()``/``cancel()`` are thread-safe."""

    def __init__(self, net, *, slots: int = 8, max_len: int = 128,
                 eos_id: Optional[int] = None, continuous: bool = True,
                 codec=None, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        if net.device != self.device:
            raise ValueError(f"net lives on {net.device}, the engine was "
                             f"asked for {self.device}; call net.to(...)")
        self.net = net
        self.max_len = int(max_len)
        self.eos_id = eos_id
        self.continuous = continuous
        self.codec = codec
        self.adapter = RecurrentDecodeAdapter(net)
        self.pool = SlotPool(int(slots), self.adapter.init_state)
        self._pending: "collections.deque[GenerationStream]" = collections.deque()
        self._pending_lo: "collections.deque[GenerationStream]" = collections.deque()
        self._cond = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._accepting = True
        self._admitting: Optional[GenerationStream] = None
        self.steps_run = 0

    # ------------------------------------------------------------- submit
    def submit(self, prompt: Union[str, Sequence[int]], *,
               max_new_tokens: int = 32, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0, seed: int = 0,
               eos_id: Optional[int] = None,
               klass: Optional[str] = None) -> GenerationStream:
        """Queue a request; returns its token stream immediately.
        ``klass="batch"`` rides the low-priority pending lane."""
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
        req = GenerationRequest(
            prompt=ids, max_new_tokens=int(max_new_tokens),
            temperature=float(temperature), top_k=int(top_k),
            top_p=float(top_p), seed=int(seed),
            eos_id=self.eos_id if eos_id is None else eos_id)
        stream = GenerationStream(req)
        with self._cond:
            if not self._accepting:
                raise RuntimeError("engine is shut down")
            (self._pending_lo if klass == "batch" else self._pending).append(stream)
            self._cond.notify_all()
        return stream

    def has_work(self) -> bool:
        return (bool(self._pending) or bool(self._pending_lo)
                or self.pool.occupancy() > 0)

    def pending_count(self) -> int:
        return len(self._pending) + len(self._pending_lo)

    # ---------------------------------------------------------- scheduler
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
                stream._finish(stream._cancel_reason)
                continue
            ids = stream.request.prompt
            self._admitting = stream
            try:
                sub = self.adapter.prefill(ids[:-1])
            finally:
                self._admitting = None
            if stream.cancelled:
                stream._finish(stream._cancel_reason)
                continue
            req = stream.request
            self.pool.admit(
                free.pop(0), sub, token=ids[-1], pos=len(ids) - 1,
                seed=req.seed, temperature=req.temperature, top_k=req.top_k,
                top_p=req.top_p, meta=stream)

    def _retire(self, slot: int, reason: str) -> None:
        self.pool.retire(slot)._finish(reason)

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
        tokens = torch.as_tensor(pool.tokens, dtype=torch.long,
                                 device=self.device)
        logits, pool.state = self.adapter.decode(pool.state, tokens)
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
        seconds, then cancel whatever remains and stop the loop."""
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
            stream._finish(reason)
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
