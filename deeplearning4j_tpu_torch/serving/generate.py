"""The gateway's streaming text-generation tier.

Counterpart of ``deeplearning4j_tpu/serving/generate.py``, copied; it drives
the port's ``GenerationEngine``, ``GenerationStream.follow`` and
``SessionJournal``.

    POST /v1/<name>/generate   {"prompt": "..." | "prompt_ids": [...],
                                "max_new_tokens": 64, "temperature": 0.8,
                                "top_k": 40, "top_p": 0.95, "seed": 7,
                                "eos_id": 3, "stream": true,
                                "timeout_ms": 30000}

Streaming mode (default) answers ndjson — one ``{"token": id, "text":
"..."}`` line per emitted token as it is produced, then a terminal
``{"done": true, "finish_reason": ..., "n_tokens": N}`` line (see
serving/http.py's StreamingResponse for the wire contract). ``"stream":
false`` collects the whole completion and answers one JSON body, bounded by
the admission deadline (504 on expiry, partial work cancelled).

Admission mirrors the predict tier: 503 while draining or after engine
shutdown, 429 + Retry-After when the engine's backlog exceeds the queue
bound (counted in ``dl4j_serving_shed_total{reason="queue_full"}`` and
``dl4j_generate_requests_total{outcome="shed"}``), 404 for an unknown
generator, 400 for a bad prompt. A client that disconnects mid-stream
cancels its generation at the engine's next step — slots are never held by
dead connections.

Durable sessions (generators registered with ``sessions=``): a request
carrying ``X-Request-Id`` (header) or ``request_id`` (body) is journaled,
its ndjson lines gain 1-based ``"seq"`` numbers, and a disconnect does NOT
cancel it — the engine keeps generating into the journal. The client
reconnects by POSTing the same ``X-Request-Id`` with ``last_seq`` (body,
or ``X-Last-Seq`` header) and receives exactly the not-yet-seen tokens:
the journaled prefix replays, then the live stream is followed. After a
preemption + restart the journal resumes the session bit-identically
(generation/sessions.py), so the reconnect contract spans process deaths.
Corrupt/lost sessions answer a clean 503; unknown ids start a NEW durable
session under that id. See docs/fault_tolerance.md for curl examples.
"""

from __future__ import annotations

from typing import Optional, Tuple

from deeplearning4j_tpu_torch import monitoring
from deeplearning4j_tpu_torch.monitoring import flight
from deeplearning4j_tpu_torch.serving.http import HttpError, StreamingResponse


def match_generate(path: str) -> Optional[dict]:
    """/v1/<name>/generate -> {"name": name} (None = no match)."""
    parts = path.strip("/").split("/")
    if len(parts) == 3 and parts[0] == "v1" and parts[2] == "generate":
        return {"name": parts[1]}
    return None


def _prompt_from(body: dict, engine):
    if "prompt_ids" in body:
        ids = body["prompt_ids"]
        if not isinstance(ids, (list, tuple)):
            raise HttpError(400, "prompt_ids must be a list of token ids")
        return [int(t) for t in ids]
    prompt = body.get("prompt")
    if isinstance(prompt, str):
        if engine.codec is None:
            raise HttpError(400, "this generator has no codec; send "
                                 "prompt_ids")
        return prompt
    raise HttpError(400, "need prompt (string) or prompt_ids (list)")


def _session_identity(body: dict, headers) -> Tuple[Optional[str], int]:
    """(request_id, last_seq) from the request, headers winning over body
    fields (a reconnecting proxy sets headers without reparsing the body).
    """
    rid = None
    if headers is not None:
        rid = headers.get("X-Request-Id")
    if not rid:
        rid = body.get("request_id")
    raw = body.get("last_seq")
    if raw is None and headers is not None:
        raw = headers.get("X-Last-Seq")
    try:
        last_seq = max(0, int(raw or 0))
    except (TypeError, ValueError):
        raise HttpError(400, "last_seq must be an integer") from None
    return (str(rid) if rid else None), last_seq


def handle_generate(gateway, engine, name: str, body: dict,
                    klass: Optional[str] = None, trace=None, headers=None):
    """The /v1/<name>/generate handler body, shared by the gateway.

    Returns either a plain dict (one-shot) or a StreamingResponse whose
    ``on_finish`` releases the gateway in-flight slot — which is what makes
    ``ServingGateway.stop()`` drain streams, not just one-shot requests.
    ``klass`` is the caller's priority class (multi-tenant gateways):
    ``batch`` requests wait in the engine's low-priority pending lane, so
    interactive submissions claim freed slots first. ``trace`` (traced
    gateways) rides into the engine stream for slot-lifetime spans; a
    streaming response closes it in ``on_finish`` — at last-token (or
    disconnect) time, not at headers-out time.
    """
    mon = monitoring.serving_monitor()
    gmon = monitoring.generate_monitor()
    journal = gateway._sessions.get(name) if gateway._sessions else None
    request_id = None
    if journal is not None:
        request_id, last_seq = _session_identity(body, headers)
        if request_id is not None:
            rec = journal.get(request_id)
            if rec is not None:  # a reconnect, not a new submission
                return _reconnect(gateway, engine, name, rec, body,
                                  last_seq, trace)
    if engine.pending_count() >= gateway.generate_max_queue:
        if mon is not None:
            mon.shed_total.labels(model=name, reason="queue_full",
                                  **{"class": klass or "default"}).inc()
        if gmon is not None:
            gmon.requests_total.labels(outcome="shed").inc()
        rec = flight.recorder()
        if rec is not None:
            rec.record("shed", severity="warn", model=name,
                       reason="queue_full", klass=klass or "default",
                       trace=trace)
        if trace is not None:
            trace.event("shed", reason="queue_full", model=name)
        raise HttpError(429, "generation queue is full",
                        headers=gateway.admission._retry_headers(
                            engine.pending_count()))
    prompt = _prompt_from(body, engine)
    try:
        stream = engine.submit(
            prompt,
            max_new_tokens=int(body.get("max_new_tokens", 64)),
            temperature=float(body.get("temperature", 0.0)),
            top_k=int(body.get("top_k", 0)),
            top_p=float(body.get("top_p", 1.0)),
            seed=int(body.get("seed", 0)),
            eos_id=body.get("eos_id"),
            klass=klass, trace=trace, request_id=request_id)
    except RuntimeError as e:  # engine shut down
        raise HttpError(503, str(e),
                        headers=gateway.admission._retry_headers()) from None
    except ValueError as e:
        raise HttpError(400, str(e)) from None
    codec = engine.codec
    durable = request_id is not None  # journaled: survives disconnects

    if not body.get("stream", True):
        timeout = gateway.admission.timeout_for(body)
        if not stream.wait(timeout):
            if not durable:  # a durable session keeps generating
                stream.cancel()
            raise HttpError(504, "deadline exceeded")
        out = {"tokens": stream.tokens, "n_tokens": len(stream.tokens),
               "finish_reason": stream.finish_reason, "model": name}
        if durable:
            out["request_id"] = request_id
        if codec is not None:
            out["text"] = codec.decode(stream.tokens)
        return out

    gateway._track(+1)

    def finish():
        # a durable session outlives its connection: the engine keeps
        # generating into the journal and the client reconnects by id
        if not stream.done and not durable:
            stream.cancel()  # client went away: free the slot
        if trace is not None:
            gateway.tracer.finish(trace, "served", code=200,
                                  reason=stream.finish_reason)
        gateway._track(-1)

    def lines():
        seq = 0
        for tok in stream:
            seq += 1
            d = {"token": tok}
            if durable:
                d["seq"] = seq
                d["request_id"] = request_id
            if codec is not None:
                d["text"] = codec.decode([tok])
            yield d
        term = {"done": True, "finish_reason": stream.finish_reason,
                "n_tokens": len(stream.tokens), "model": name}
        if durable:
            term["request_id"] = request_id
        yield term

    return StreamingResponse(lines(), on_finish=finish)


def _reconnect(gateway, engine, name: str, rec, body: dict, last_seq: int,
               trace=None):
    """A request whose id is already in the session journal: replay the
    journaled tokens past ``last_seq`` (exactly-once by sequence number),
    then follow the live stream if the session is still generating.

    Reconnects never submit work — they observe the existing session — so
    they skip the queue-full shed and never fail with 429. The failure
    modes are all clean errors: a corrupt/lost journal record answers 503
    immediately (never a hang), and an interrupted session that has not
    yet been resumed into an engine answers 503 + Retry-After.
    """
    rid = rec.request_id
    if rec.corrupt or rec.lost:
        raise HttpError(
            503, f"session {rid!r} cannot be recovered: "
                 + ("journal corrupt" if rec.corrupt else "resume failed"))
    stream = rec.stream
    live = stream is not None and not stream.done
    if not live and rec.finish_reason is None:
        # interrupted (crash/preempt) and not resumed here yet: the
        # restart path resumes before traffic, so tell the client to retry
        raise HttpError(503, f"session {rid!r} is being recovered",
                        headers=gateway.admission._retry_headers())
    if trace is not None:
        trace.event("session_reconnect", request_id=rid, last_seq=last_seq,
                    live=live)
    frec = flight.recorder()
    if frec is not None:
        frec.record("session_reconnect", model=name, request_id=rid,
                    last_seq=last_seq, live=live, trace=trace)
    codec = engine.codec

    def _finish_reason():
        if rec.finish_reason is not None:
            return rec.finish_reason
        return stream.finish_reason if stream is not None else None

    if not body.get("stream", True):
        if live:
            timeout = gateway.admission.timeout_for(body)
            if not stream.wait(timeout):  # session stays alive: no cancel
                raise HttpError(504, "deadline exceeded")
        toks = list(rec.tokens[last_seq:])
        out = {"tokens": toks, "n_tokens": len(rec.tokens),
               "finish_reason": _finish_reason(), "model": name,
               "request_id": rid, "last_seq": last_seq}
        if codec is not None:
            out["text"] = codec.decode(toks)
        return out

    gateway._track(+1)

    def finish():
        if trace is not None:
            gateway.tracer.finish(trace, "served", code=200,
                                  reason=_finish_reason())
        gateway._track(-1)

    def lines():
        # 1. the journaled prefix — durable, ordered, exactly-once: every
        #    line the client already consumed (seq <= last_seq) is skipped
        i = last_seq
        stable = stream.seq0 if live else len(rec.tokens)
        while i < stable:
            d = {"seq": i + 1, "token": rec.tokens[i], "request_id": rid}
            if codec is not None:
                d["text"] = codec.decode([rec.tokens[i]])
            yield d
            i += 1
        # 2. the live tail (seq numbers continue where the prefix ended)
        if live:
            for seq, tok in stream.follow(last_seq=i):
                d = {"seq": seq, "token": tok, "request_id": rid}
                if codec is not None:
                    d["text"] = codec.decode([tok])
                yield d
        yield {"done": True, "finish_reason": _finish_reason(),
               "n_tokens": len(rec.tokens), "model": name,
               "request_id": rid, "resumes": rec.resumes}

    return StreamingResponse(lines(), on_finish=finish)


def read_ndjson_stream(resp):
    """Client-side helper: iterate the parsed ndjson lines of a streaming
    ``/generate`` response (an ``http.client``/``urllib`` response object)."""
    import json

    for raw in resp:
        raw = raw.strip()
        if raw:
            yield json.loads(raw)
