"""Training guardrails: numeric sentinel, policy ladder, rollback, blame.

Counterpart of ``deeplearning4j_tpu/guardrails/__init__.py``. The
fault-tolerance stack (``faults``, ``util/checkpoints.py``) recovers from
crashes and torn checkpoints; this package defends the *numerics* of
training: a NaN/Inf gradient or a poisoned batch must not silently corrupt
params and then be checkpointed, journaled and served.

Three pieces:

- **Sentinel** (``guardrails/sentinel.py``): a health word computed on the
  device inside the train step: finite(loss) and finite(global gradient
  norm), the norm itself and a loss-EWMA z-score. A tripped step's update
  is discarded on the device (``tree_select``, ``torch.where`` leaf by
  leaf), so nothing non-finite reaches params or a checkpoint. The word
  rides the async window next to the loss and is screened at drain with no
  extra host sync.
- **Policy ladder** (:class:`Guardrail`): on a trip, skip-step (the device
  already discarded the update), then a clip-by-global-norm retry of the
  same batch, then a rollback to the last-known-good checkpoint (the
  port's ``TrainingCheckpointer``, saved synchronously, validated by its
  manifest) with the offending window replayed.
- **Blame** (``guardrails/bisect.py``): deterministic bisection over the
  replayed window names the culprit batch, quarantines it to an ndjson
  sidecar, and records a flight-recorder ``numeric_trip`` incident (a
  dump trigger) carrying the sentinel trace.

Zero-overhead contract: unarmed, :func:`get_guard` returns None and
``fit_batch`` does no guardrail work. Arm with :func:`arm`, or process-wide
with ``DL4J_TORCH_GUARDRAILS=1`` (plus ``DL4J_TORCH_GUARDRAILS_DIR`` for a
rollback checkpoint directory; without one the ladder ends at clip-retry
and an unrecoverable trip raises :class:`GuardrailTripped`).

The guarded step is ``_train_step`` with a control tensor: the raw
gradients are screened, then the configuration's clips and the updaters
run, then params, updater state and layer state are selected on the
device. The control lanes are built on the host and cross to the card from
pinned memory without blocking (``common/device.to_device``). Unguarded, as
in the JAX package: truncated BPTT and the parallel trainers.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import time
import zlib
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import monitoring
from deeplearning4j_tpu_torch.common.device import to_device
from deeplearning4j_tpu_torch.common.env import env
from deeplearning4j_tpu_torch.common.trees import tree_map
from deeplearning4j_tpu_torch.guardrails.bisect import bisect_culprit
from deeplearning4j_tpu_torch.guardrails.sentinel import (
    SentinelState, WORD_GNORM, WORD_LOSS, WORD_OK, WORD_Z,
)


def _fetch_word(word) -> np.ndarray:
    """The host<-device sync of a guarded step's delivery. The word
    carries the loss, so a guarded drain costs exactly the one fetch the
    unguarded drain already paid (spy point, the guardrails analog of
    async_dispatch._fetch_scalar). An in-flight copy (the async window's)
    waits for its own step only."""
    from deeplearning4j_tpu_torch.optimize.async_dispatch import (
        _InFlightScalar,
    )

    if isinstance(word, _InFlightScalar):
        word.event.synchronize()
        word = word.host
    if isinstance(word, torch.Tensor):
        return word.detach().cpu().numpy()
    return np.asarray(word)


@dataclasses.dataclass(frozen=True)
class GuardrailPolicy:
    """Knobs for the sentinel screens and the trip ladder."""

    clipnorm: float = 1.0        # clip-retry / rollback-replay global norm
    gnorm_limit: float = 0.0     # trip when post-clip gnorm exceeds; 0 = off
    z_limit: float = 6.0         # loss EWMA z-score trip; 0 = off
    ewma_alpha: float = 0.9
    warmup_steps: int = 8        # clean losses before the z screen arms
    skip_budget: int = 2         # consecutive trips absorbed by skip-step
    clip_retry: bool = True      # ladder rung 2
    checkpoint_every: int = 25   # guarded-step cadence for last-known-good
    keep_last: int = 3
    replay_window: int = 64      # batches retained for rollback replay


class GuardrailTripped(RuntimeError):
    """A sentinel trip exhausted the policy ladder (no checkpointer, no
    restorable checkpoint, or the replay window outlived the ring).
    Carries the tripping step and its sentinel ``word``."""

    def __init__(self, step: int, word, reason: str):
        word = [float(v) for v in word]
        super().__init__(f"guardrail trip at step {step} could not be "
                         f"recovered: {reason} (sentinel word {word})")
        self.step = int(step)
        self.word = word


class _Resolved:
    """Marker wrapped around an already-resolved score for a handle whose
    device-side step was erased by a rollback: the window delivers it in
    FIFO order without touching the device."""

    __slots__ = ("value",)

    def __init__(self, value: float):
        self.value = value


def _leaf_arrays(part):
    if isinstance(part, dict):
        return [(f"[{k}]", v) for k, v in part.items()]
    if isinstance(part, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(part)]
    return [("", part)]


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _describe_batch(data):
    """Shape/digest summary of a quarantined (features, labels) pair —
    enough to locate the batch in the input pipeline without writing
    tensor payloads next to checkpoints."""
    out = []
    for name, part in zip(("features", "labels"), data):
        for key, leaf in _leaf_arrays(part):
            a = _host(leaf)
            desc = {"tensor": name + key, "shape": list(a.shape),
                    "dtype": str(a.dtype),
                    "crc32": zlib.crc32(np.ascontiguousarray(a).tobytes())}
            if np.issubdtype(a.dtype, np.floating) and a.size:
                desc["finite_fraction"] = float(np.isfinite(a).mean())
                amax = float(np.abs(a).max())
                desc["abs_max"] = amax if math.isfinite(amax) else None
            out.append(desc)
    return out


class Guardrail:
    """Per-model guardrail: owns the sentinel baseline, the replay ring,
    the trip ladder, and (optionally) a rollback checkpointer.

    ``fit_batch`` delegates the whole dispatch/deliver path here when
    armed; the model's ``_train_step`` with a control tensor is the
    guarded step and returns ``(loss, word)``.
    """

    def __init__(self, model, policy: Optional[GuardrailPolicy] = None,
                 checkpoint_dir: Optional[str] = None,
                 quarantine_path: Optional[str] = None):
        self.model = model
        self.policy = policy or GuardrailPolicy()
        self.checkpointer = None
        if checkpoint_dir:
            from deeplearning4j_tpu_torch.util.checkpoints import (
                TrainingCheckpointer,
            )

            # sync saves: a checkpoint the ladder may restore NEXT step
            # must be durable before training continues
            self.checkpointer = TrainingCheckpointer(
                checkpoint_dir, keep_last=self.policy.keep_last,
                async_save=False)
            if quarantine_path is None:
                quarantine_path = os.path.join(checkpoint_dir,
                                               "quarantine.ndjson")
        self.quarantine_path = quarantine_path
        ring = max(int(self.policy.replay_window),
                   int(self.policy.checkpoint_every) + 8)
        self._ring: collections.deque = collections.deque(maxlen=ring)
        self._sent = SentinelState(self.policy.ewma_alpha,
                                   self.policy.warmup_steps)
        self._consecutive = 0
        self._trace: collections.deque = collections.deque(maxlen=128)
        self._initial_saved = False
        self.trips = 0
        self.rollbacks = 0
        self.steps_lost = 0
        self.quarantined: "list[int]" = []
        self.last_bisect_probes = 0

    # -------------------------------------------------------------- dispatch
    def _ctrl(self, model, clip: float) -> torch.Tensor:
        p = self.policy
        mean, var = self._sent.baseline()
        # built on the host, staged in pinned memory and copied to the card
        # without blocking: no per-step sync
        return to_device(np.asarray(
            [clip, p.gnorm_limit, p.z_limit, mean, var], np.float32),
            model.device)

    def _dispatch(self, model, step_i: int, data, masks, clip: float):
        # two variants: the hot one (clip 0) has no scaling pass over the
        # gradients; the retry/replay one scales them
        return model._train_step(data[0], data[1], masks[0], masks[1],
                                 ctrl=self._ctrl(model, clip),
                                 clip_active=clip > 0, step=step_i)

    def _replay_one(self, model, entry, clip: float):
        step_i, _epoch_i, data, masks = entry
        _loss, word = self._dispatch(model, step_i, data, masks, clip)
        w = _fetch_word(word)
        return float(w[WORD_LOSS]), w

    # ------------------------------------------------------------------ step
    def step(self, model, data, masks, window, mon):
        """One guarded train step. Called by ``fit_batch`` with the
        PRE-increment counters; ``data``/``masks`` are the model's
        device-ready (features, labels) / (mask, labels_mask) pairs.
        Returns the step's score (float, or ScoreHandle under async)."""
        if self.checkpointer is not None and not self._initial_saved:
            # the floor of the ladder: before the first guarded update
            # there must be something to roll back TO
            self.checkpointer.save(int(model.step_count), model)
            self.checkpointer.wait()
            self._initial_saved = True
        step_i, epoch_i = int(model.step_count), int(model.epoch_count)
        self._ring.append((step_i, epoch_i, data, masks))
        if mon is None:
            loss, word = self._dispatch(model, step_i, data, masks, 0.0)
            if window is not None:
                result = self._submit(model, window, step_i, loss, word)
            else:
                value = self._deliver_sync(model, step_i, epoch_i,
                                           _fetch_word(word))
                model._score_value = value
                for lst in model.listeners:
                    lst.iteration_done(model, step_i, epoch_i, value)
                result = value
        elif window is not None:
            with mon.phase("dispatch"):
                loss, word = self._dispatch(model, step_i, data, masks, 0.0)
            result = self._submit(model, window, step_i, loss, word)
        else:
            with mon.phase("device_step"):
                loss, word = self._dispatch(model, step_i, data, masks, 0.0)
                # the host fetch is the device sync: step time includes it
                w = _fetch_word(word)
            value = self._deliver_sync(model, step_i, epoch_i, w)
            model._score_value = value
            with mon.phase("listeners"):
                for lst in model.listeners:
                    lst.iteration_done(model, step_i, epoch_i, value)
            mon.iteration_done(value)
            result = value
        self._maybe_checkpoint(model, window)
        return result

    def _submit(self, model, window, step_i, loss, word):
        """Queue the step on the async window. The handle is appended
        before the window drains, so any error surfacing here belongs to
        an OLDER step — the current one is dispatched and queued, and the
        host counter must advance past it even on the error path, or the
        next ``fit_batch`` would reuse its step id (duplicate dispatch)."""
        try:
            return window.submit(loss, word=word, guard=self)
        except BaseException:
            model.step_count = step_i + 1
            raise

    def _deliver_sync(self, model, step_i, epoch_i, w):
        """Sync-path delivery: the step consumed its batch even when the
        ladder ends in a raise, so the counter advances either way."""
        try:
            return self.deliver(model, step_i, epoch_i, w, None)
        except BaseException:
            model.step_count = step_i + 1
            raise

    # -------------------------------------------------------------- delivery
    def deliver(self, model, step_i: int, epoch_i: int, w, window):
        """Judge one fetched sentinel word (sync path, or the async drain
        via the window); returns the score to deliver for the step."""
        ok = float(w[WORD_OK]) > 0
        gnorm = float(w[WORD_GNORM])
        loss = float(w[WORD_LOSS])
        self._trace.append({"step": step_i, "ok": int(ok), "gnorm": gnorm,
                            "loss": loss, "z": float(w[WORD_Z])})
        if ok:
            self._consecutive = 0
            self._sent.update(loss)
            gm = monitoring.guardrail_monitor()
            if gm is not None:
                gm.grad_norm.set(gnorm)
            return loss
        return self._trip(model, step_i, epoch_i, w, window)

    def _trip(self, model, step_i, epoch_i, w, window):
        p = self.policy
        self.trips += 1
        self._consecutive += 1
        gnorm = float(w[WORD_GNORM])
        loss = float(w[WORD_LOSS])
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            kind = "nonfinite"
        elif p.gnorm_limit > 0 and gnorm > p.gnorm_limit:
            kind = "gnorm"
        else:
            kind = "zscore"
        gm = monitoring.guardrail_monitor()
        if gm is not None:
            gm.trips.labels(kind=kind).inc()
        entry = self._entry(step_i)
        # rung 1: skip — the device already discarded the update, so the
        # observed (possibly NaN) loss is truthful and params are intact
        if self._consecutive <= p.skip_budget:
            if kind != "zscore" and entry is not None:
                # hard trips are exactly attributable to their own batch;
                # a z-trip may be collateral from an earlier sneaky batch,
                # so blame there waits for the bisection
                self._quarantine(entry, w, method="direct")
            self.steps_lost += 1
            if gm is not None:
                gm.steps_lost.inc()
            self._resolve(step_i, "skip", kind, w)
            return loss
        # rung 2: clip-by-global-norm retry of the same batch
        if p.clip_retry and p.clipnorm > 0 and entry is not None:
            rloss, rw = self._replay_one(model, entry, clip=p.clipnorm)
            if float(rw[WORD_OK]) > 0:
                self._consecutive = 0
                self._sent.update(rloss)
                self._resolve(step_i, "clip_retry", kind, w)
                return rloss
        # rung 3: rollback to last-known-good + bisect blame
        return self._rollback(model, step_i, w, window, kind)

    def _entry(self, step_i: int):
        for e in reversed(self._ring):
            if e[0] == step_i:
                return e
        return None

    # -------------------------------------------------------------- rollback
    def _rollback(self, model, trip_step, w, window, kind):
        p = self.policy
        if self.checkpointer is None:
            self._resolve(trip_step, "halt", kind, w)
            raise GuardrailTripped(
                trip_step, w, "no guardrail checkpoint directory to roll "
                "back to (arm with checkpoint_dir= or "
                "DL4J_TORCH_GUARDRAILS_DIR)")
        self.rollbacks += 1
        pending = window.take_pending() if window is not None else []
        resume = int(model.step_count)   # host counter survives the restore
        end_step = trip_step
        for h, _loss, _lst, _w, _g in pending:
            end_step = max(end_step, h.step)
        restored = self.checkpointer.restore_latest(model)
        if restored is None:
            self._resolve(trip_step, "halt", kind, w)
            raise GuardrailTripped(trip_step, w, "no restorable checkpoint")
        start = int(restored)
        entries = [e for e in self._ring if start <= e[0] <= end_step]
        if len(entries) != end_step - start + 1 or entries[0][0] != start:
            self._resolve(trip_step, "halt", kind, w)
            raise GuardrailTripped(
                trip_step, w,
                f"replay window [{start}, {end_step}] fell out of the "
                f"{self._ring.maxlen}-batch replay ring")
        # bisection domain: entries up to the trip — in-flight steps past
        # it ran on untouched params (the device discarded the bad update)
        # and only need replaying afterwards
        span = [e for e in entries if e[0] <= trip_step]
        ref = span[-1]
        frozen = self._sent.baseline()
        probe_count = {"n": 0}

        def snapshot():
            return tuple(tree_map(torch.clone, t) for t in
                         (model.params, model.state, model.opt_state))

        def restore_state(s):
            model.params, model.state, model.opt_state = s

        def ref_probe():
            """Does the tripping step's batch trip against the CURRENT
            model state? Snapshot/restore around it — a clean probe must
            not leave the trip batch's update applied mid-bisection."""
            probe_count["n"] += 1
            snap = snapshot()
            rloss, rw = self._replay_one(model, ref, clip=0.0)
            restore_state(snap)
            if float(rw[WORD_OK]) <= 0 or not math.isfinite(rloss):
                return True
            mean, var = frozen
            if var < 0 or self.policy.z_limit <= 0:
                return False
            return (rloss - mean) / math.sqrt(var + 1e-12) > self.policy.z_limit

        base = snapshot()
        # an intrinsically bad batch (NaN features, gnorm blow-up) trips
        # against ANY state — the last-known-good probe settles blame in
        # one replay, and bisecting on it would be meaningless (constant-
        # True predicate collapses to the window's first entry)
        if ref_probe() or len(span) == 1:
            culprit = ref
        else:
            # the trip batch is clean on last-known-good: an earlier batch
            # passed its own screens but corrupted state (sneaky culprit).
            # Predicate for prefix ranges: an in-range trip, or the trip
            # batch tripping once the range is applied.
            def run_range(i, j):
                for e in span[i:j]:
                    probe_count["n"] += 1
                    _, rw = self._replay_one(model, e, clip=0.0)
                    if float(rw[WORD_OK]) <= 0:
                        return True
                return ref_probe()

            idx, _rounds = bisect_culprit(len(span) - 1, run_range,
                                          snapshot, restore_state)
            culprit = span[idx]
        restore_state(base)
        self.last_bisect_probes = probe_count["n"]
        gm = monitoring.guardrail_monitor()
        if gm is not None:
            gm.bisect_probes.inc(probe_count["n"])
        self._quarantine(culprit, w, method="bisect")
        # replay the window minus the culprit, clip armed; scores resolve
        # exactly once — only steps not yet delivered (the in-flight ones
        # plus the tripping step itself) feed listeners and the EWMA
        deliver_from = min([h.step for h, *_ in pending] + [trip_step])
        values = {}
        for e in entries:
            s = e[0]
            if s == culprit[0]:
                self.steps_lost += 1
                if gm is not None:
                    gm.steps_lost.inc()
                values[s] = float("nan")
                continue
            rloss, rw = self._replay_one(model, e, clip=p.clipnorm)
            if float(rw[WORD_OK]) <= 0:
                # still unhealthy even clipped: drop it too
                self.steps_lost += 1
                if gm is not None:
                    gm.steps_lost.inc()
                values[s] = float("nan")
                continue
            values[s] = rloss
            if s >= deliver_from:
                self._sent.update(rloss)
        model.step_count = resume
        self._consecutive = 0
        self._resolve(trip_step, "rollback", kind, w,
                      culprit_step=int(culprit[0]), restored_step=start,
                      replayed=len(entries) - 1,
                      probes=probe_count["n"])
        # the post-replay state is clean and screened: it is the new
        # last-known-good (key = completed-step count)
        self.checkpointer.save(end_step + 1, model)
        self.checkpointer.wait()
        for h, _loss, listeners, _w, _g in pending:
            window.requeue(h, listeners,
                           _Resolved(values.get(h.step, float("nan"))), self)
        return values.get(trip_step, float("nan"))

    # ------------------------------------------------------------ checkpoint
    def _maybe_checkpoint(self, model, window):
        if self.checkpointer is None:
            return
        done = int(model.step_count) + 1   # this step completes the count
        if done % max(1, int(self.policy.checkpoint_every)):
            return
        if window is not None:
            # every step entering the checkpoint must pass its screen first
            window.drain()
        if self.checkpointer.latest_step() == done:
            return   # a rollback in that drain already saved this key
        self.checkpointer.save(done, model)
        self.checkpointer.wait()

    # ------------------------------------------------------------ quarantine
    def _quarantine(self, entry, w, method: str):
        step_i, epoch_i, data, _masks = entry
        if step_i in self.quarantined:
            return
        self.quarantined.append(step_i)
        gm = monitoring.guardrail_monitor()
        if gm is not None:
            gm.actions.labels(action="quarantine").inc()
        if not self.quarantine_path:
            return
        rec = {
            "t": time.time(),
            "step": int(step_i),
            "epoch": int(epoch_i),
            "method": method,
            "word": {"ok": float(w[WORD_OK]), "gnorm": float(w[WORD_GNORM]),
                     "loss": float(w[WORD_LOSS]), "z": float(w[WORD_Z])},
            "batch": _describe_batch(data),
        }
        parent = os.path.dirname(self.quarantine_path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(self.quarantine_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    # ----------------------------------------------------------- bookkeeping
    def _resolve(self, step_i, action, kind, w, **extra):
        gm = monitoring.guardrail_monitor()
        if gm is not None:
            gm.actions.labels(action=action).inc()
        rm = monitoring.recovery_monitor()
        if rm is not None:
            rm.recovery_total.labels(component="guardrails",
                                     outcome=action).inc()
        rec = monitoring.flight.recorder()
        if rec is not None:
            rec.record(
                "numeric_trip",
                severity="error" if action in ("rollback", "halt")
                else "warning",
                step=int(step_i), action=action, trip=kind,
                word=[round(float(v), 6) for v in w],
                sentinel_trace=list(self._trace)[-32:], **extra)

    def sentinel_trace(self):
        """The last ~128 delivered sentinel words (newest last)."""
        return list(self._trace)

    def close(self):
        if self.checkpointer is not None:
            self.checkpointer.close()


# ------------------------------------------------------------------ arming
def arm(model, policy: Optional[GuardrailPolicy] = None,
        checkpoint_dir: Optional[str] = None,
        quarantine_path: Optional[str] = None) -> Guardrail:
    """Attach a guardrail to ``model``; from the next ``fit_batch`` on,
    every train step runs the guarded program and its delivery passes
    through the policy ladder."""
    guard = Guardrail(model, policy=policy, checkpoint_dir=checkpoint_dir,
                      quarantine_path=quarantine_path)
    model._guardrail = guard
    return guard


def disarm(model) -> None:
    guard = getattr(model, "_guardrail", None)
    if guard is not None:
        guard.close()
    model._guardrail = None


def get_guard(model) -> Optional[Guardrail]:
    """The model's guardrail, or None when unarmed — callers skip ALL
    guardrail work on None (the zero-overhead contract). The first call
    per model resolves the ``DL4J_TORCH_GUARDRAILS`` env arming;
    :func:`arm`/:func:`disarm` override it."""
    try:
        return model._guardrail
    except AttributeError:
        pass
    guard = None
    if env.guardrails:
        guard = Guardrail(model, checkpoint_dir=env.guardrails_dir)
    model._guardrail = guard
    return guard


__all__ = [
    "Guardrail", "GuardrailPolicy", "GuardrailTripped", "SentinelState",
    "arm", "bisect_culprit", "disarm", "get_guard",
]
