"""Durable generation sessions: the crash-recovery journal.

Counterpart of ``deeplearning4j_tpu/generation/sessions.py``. A
journal-armed :class:`GenerationEngine` appends one line per session event
to an append-only ndjson file; after a restart,
:meth:`SessionJournal.resume_into` re-submits every interrupted session
with ``prompt + already-emitted tokens`` as its prompt. The sampler draws
each row's number from (request seed, absolute position)
(generation/sampler.py) and admission sets ``pos = len(prompt) - 1``, so
the resumed stream draws exactly what the uninterrupted run would have,
and the concatenated tokens are identical (tests/test_torch_sessions.py,
through a KV ring wrap too).

Journal format (one JSON object per line), the JAX package's field for
field, so a journal written by either package replays in the other::

    {"e":"open","id":R,"prompt":[...],"max_new":N,"temp":T,
     "top_k":K,"top_p":P,"seed":S,"eos":E,"klass":C,"t":...}
    {"e":"tok","id":R,"seq":n,"tok":t}      # n is 1-based and contiguous
    {"e":"fin","id":R,"reason":"eos"|"length"|"cancelled"}
    {"e":"res","id":R,"at":n}               # audit: session resumed at n

A session with no ``fin`` line is interrupted (a shutdown with
``reason="preempted"`` deliberately writes none). A torn tail or a
sequence gap marks the affected sessions corrupt: they are never resumed.
An engine without a journal makes no journal call at all. Each resumed or
lost session counts in ``dl4j_recovery_total{component="generation"}``
(monitoring on), and a resume pass that found any is one
``session_resume`` flight-recorder event (recorder armed).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional



class SessionRecord:
    """One journaled generation session: the durable request plus every
    token emitted so far. ``stream`` points at the live engine stream while
    one exists (reconnects follow it); ``corrupt``/``lost`` sessions answer
    503 on reconnect and are never resumed."""

    __slots__ = ("request_id", "prompt", "max_new_tokens", "temperature",
                 "top_k", "top_p", "seed", "eos_id", "klass", "tokens",
                 "finish_reason", "corrupt", "lost", "resumes", "stream",
                 "opened_at")

    def __init__(self, request_id: str, prompt, max_new_tokens: int,
                 temperature: float, top_k: int, top_p: float, seed: int,
                 eos_id: Optional[int], klass: Optional[str] = None):
        self.request_id = request_id
        self.prompt = tuple(int(t) for t in prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed)
        self.eos_id = eos_id
        self.klass = klass
        self.tokens: List[int] = []
        self.finish_reason: Optional[str] = None
        self.corrupt = False
        self.lost = False
        self.resumes = 0
        self.stream = None
        self.opened_at = time.time()

    @property
    def emitted(self) -> int:
        return len(self.tokens)

    @property
    def open(self) -> bool:
        """Interrupted-or-running: no terminal ``fin`` line yet."""
        return self.finish_reason is None and not self.corrupt

    def describe(self) -> dict:
        return {"request_id": self.request_id,
                "prompt_len": len(self.prompt),
                "emitted": self.emitted,
                "max_new_tokens": self.max_new_tokens,
                "finish_reason": self.finish_reason,
                "corrupt": self.corrupt, "lost": self.lost,
                "resumes": self.resumes,
                "live": self.stream is not None and not self.stream.done}


class SessionJournal:
    """Append-only session journal over one ndjson file.

        journal = SessionJournal(path)          # replays any existing file
        engine = GenerationEngine(net, journal=journal)
        ...crash/preempt...
        journal2 = SessionJournal(path)         # fresh process
        engine2 = GenerationEngine(net, journal=journal2).start()
        journal2.resume_into(engine2)           # before accepting traffic

    ``fsync=True`` fsyncs every line (preemption-grade durability);
    the default flushes to the OS per line, and :meth:`sync` (called by the
    lifecycle drain) forces the fsync at preemption time.
    """

    def __init__(self, path: str, fsync: bool = False):
        self.path = str(path)
        self.fsync = bool(fsync)
        self._lock = threading.RLock()
        self._records: Dict[str, SessionRecord] = {}
        self.corrupt_lines = 0
        self._replay()
        self._f = open(self.path, "a", encoding="utf-8")

    # ------------------------------------------------------------- replay
    def _tombstone(self, rid: str) -> SessionRecord:
        rec = SessionRecord(rid, (), 0, 0.0, 0, 1.0, 0, None)
        rec.corrupt = True
        return rec

    def _replay(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path, "r", encoding="utf-8") as f:
            for raw in f:
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    ev = json.loads(raw)
                    kind, rid = ev["e"], ev["id"]
                except Exception:
                    self.corrupt_lines += 1
                    continue
                if kind == "open":
                    try:
                        self._records[rid] = SessionRecord(
                            rid, ev["prompt"], ev["max_new"], ev["temp"],
                            ev["top_k"], ev["top_p"], ev["seed"],
                            ev.get("eos"), ev.get("klass"))
                    except Exception:
                        self.corrupt_lines += 1
                        self._records[rid] = self._tombstone(rid)
                elif kind == "tok":
                    rec = self._records.get(rid)
                    if rec is None:
                        self._records[rid] = self._tombstone(rid)
                        continue
                    if rec.corrupt:
                        continue
                    if ev.get("seq") != rec.emitted + 1:
                        rec.corrupt = True  # gap: token tally unprovable
                        continue
                    rec.tokens.append(int(ev["tok"]))
                elif kind == "fin":
                    rec = self._records.get(rid)
                    if rec is None:
                        self._records[rid] = self._tombstone(rid)
                    else:
                        rec.finish_reason = ev.get("reason") or "length"
                elif kind == "res":
                    rec = self._records.get(rid)
                    if rec is not None:
                        rec.resumes += 1
                else:
                    self.corrupt_lines += 1
        if self.corrupt_lines:
            # a torn tail could have swallowed token lines of ANY session
            # still open at crash time — their tallies are unprovable, and
            # resuming from a wrong position would produce silently wrong
            # tokens. Finished sessions keep replaying: their fin line
            # proves the tally was complete when written.
            for rec in self._records.values():
                if rec.finish_reason is None:
                    rec.corrupt = True

    # -------------------------------------------------------------- write
    def _write(self, ev: dict) -> None:
        line = json.dumps(ev, separators=(",", ":"))
        self._f.write(line + "\n")
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())

    def sync(self) -> None:
        """Force everything journaled so far onto disk (the lifecycle
        manager calls this inside the preemption grace budget)."""
        with self._lock:
            self._f.flush()
            os.fsync(self._f.fileno())

    def close(self) -> None:
        with self._lock:
            self._f.close()

    # ---------------------------------------------------- engine-side API
    def attach(self, stream, klass: Optional[str] = None) -> SessionRecord:
        """Bind a just-submitted stream to its session record; called by
        ``GenerationEngine.submit`` on journal-armed engines. A known
        request id is a RESUME: the stream's sequence numbers continue
        where the journal left off (``stream.seq0``)."""
        rid = stream.request_id
        with self._lock:
            rec = self._records.get(rid)
            if rec is None:
                req = stream.request
                rec = SessionRecord(
                    rid, req.prompt, req.max_new_tokens, req.temperature,
                    req.top_k, req.top_p, req.seed, req.eos_id, klass)
                self._records[rid] = rec
                self._write({"e": "open", "id": rid,
                             "prompt": list(req.prompt),
                             "max_new": req.max_new_tokens,
                             "temp": req.temperature, "top_k": req.top_k,
                             "top_p": req.top_p, "seed": req.seed,
                             "eos": req.eos_id, "klass": klass,
                             "t": time.time()})
            else:
                rec.resumes += 1
                self._write({"e": "res", "id": rid, "at": rec.emitted})
            stream.seq0 = rec.emitted
            rec.stream = stream
            return rec

    def emitted(self, stream, token: int) -> None:
        with self._lock:
            rec = self._records.get(stream.request_id)
            if rec is None or rec.finish_reason is not None:
                return
            rec.tokens.append(int(token))
            self._write({"e": "tok", "id": stream.request_id,
                         "seq": rec.emitted, "tok": int(token)})

    def finished(self, stream, reason: str) -> None:
        if reason == "preempted":
            # the whole point: a preempted session stays OPEN on disk so
            # the restarted engine resumes it
            return
        with self._lock:
            rec = self._records.get(stream.request_id)
            if rec is None or rec.finish_reason is not None:
                return
            rec.finish_reason = reason
            self._write({"e": "fin", "id": stream.request_id,
                         "reason": reason})

    # -------------------------------------------------------------- query
    def get(self, request_id: str) -> Optional[SessionRecord]:
        with self._lock:
            return self._records.get(request_id)

    def interrupted(self) -> List[SessionRecord]:
        """Sessions with no terminal line and a provable token tally —
        the resumable set."""
        with self._lock:
            return [r for r in self._records.values()
                    if r.finish_reason is None and not r.corrupt
                    and not r.lost]

    def describe(self) -> dict:
        with self._lock:
            recs = list(self._records.values())
        return {"path": self.path,
                "sessions": len(recs),
                "open": sum(1 for r in recs if r.open),
                "finished": sum(1 for r in recs
                                if r.finish_reason is not None),
                "corrupt": sum(1 for r in recs if r.corrupt),
                "lost": sum(1 for r in recs if r.lost),
                "corrupt_lines": self.corrupt_lines}

    # ------------------------------------------------------------- resume
    def resume_into(self, engine) -> dict:
        """Re-submit every interrupted session into ``engine`` (call after
        ``start()`` and BEFORE accepting new traffic). The resumed prompt
        is ``original prompt + emitted tokens``, the token budget is the
        unspent remainder, and the sampler seed is unchanged — admission
        sets ``pos = len(prompt) - 1``, so the next sampler key is
        drawn from ``(seed, pos)`` exactly as in the uninterrupted run.

        Returns ``{"resumed", "lost", "completed"}``; outcomes land in
        ``dl4j_recovery_total{component="generation"}`` and one
        ``session_resume`` flight event summarizes the pass.
        """
        from deeplearning4j_tpu_torch import monitoring

        mon = monitoring.recovery_monitor()
        resumed = lost = completed = 0
        for rec in self.interrupted():
            remaining = rec.max_new_tokens - rec.emitted
            if remaining <= 0:
                # crashed between the final token and its fin line: the
                # session is actually complete — close it for replay
                with self._lock:
                    if rec.finish_reason is None:
                        rec.finish_reason = "length"
                        self._write({"e": "fin", "id": rec.request_id,
                                     "reason": "length"})
                completed += 1
                continue
            try:
                engine.submit(
                    rec.prompt + tuple(rec.tokens),
                    max_new_tokens=remaining, temperature=rec.temperature,
                    top_k=rec.top_k, top_p=rec.top_p, seed=rec.seed,
                    eos_id=rec.eos_id, klass=rec.klass,
                    request_id=rec.request_id)
                resumed += 1
                outcome = "session_resumed"
            except (ValueError, RuntimeError):
                rec.lost = True
                lost += 1
                outcome = "session_lost"
            if mon is not None:
                mon.recovery_total.labels(component="generation",
                                          outcome=outcome).inc()
        rec_flight = monitoring.flight.recorder()
        if rec_flight is not None and (resumed or lost or completed):
            rec_flight.record("session_resume", resumed=resumed, lost=lost,
                              completed=completed, path=self.path)
        return {"resumed": resumed, "lost": lost, "completed": completed}


__all__ = ["SessionJournal", "SessionRecord"]
