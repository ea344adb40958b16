"""Are the serving phases' token streams the same from run to run, on the
card?

Runs ``chip_smoke.main()`` whole, with two changes: a failed check is
printed and the run goes on, and each engine phase that compares a timed
run's streams with a counted run's (``chip_smoke._engine_launches``:
phases 4, 5, 17, 29 and 30) first serves its requests ``REPEATS`` more
times, every other run under torch.profiler as the counted run is. Each
run records, beside its streams, every prefill's state, every decode
step's inputs (the pool's tokens, positions and live slots) and every
decode step's logits; every third run shares the card with matrix
products on another stream, so that a race would meet other timings.
Each later run is held against the first, and one ``DIAG`` line a
phase says where the first difference lies: in a prefill's state, in a
step's inputs (host logic), in a step's logits from equal inputs (a
device computation that is not repeatable), or only in the streams.

Run from the root of a checkout, on the card (about 11 minutes):

    python3 experiments/serving_determinism/repeat.py

It prints the smoke's own lines, the ``DIAG`` lines and, last, the failed
checks as one JSON list.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

REPEATS = {"small": 96, "large": 16}
FAILS = []
ORIGINAL = cs._engine_launches


def soft_fail(msg):
    print(f"chip_smoke: FAIL (continuing): {msg}", file=sys.stderr,
          flush=True)
    FAILS.append(msg)


def _load(torch):
    """Matrix products queued on a side stream, to share the card's SMs
    with the run that follows (a race shows under other timings)."""
    side = torch.cuda.Stream()
    a = torch.randn(4096, 4096, device="cuda")
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(64):
            a = (a @ a).clamp_(-1, 1)
    return side, a


def _record_run(torch, eng, fn, counted, profiled, loaded=False):
    """One run of ``fn`` with every prefill state, decode input and decode
    logits kept (the logits and states on the card); with ``loaded``, under
    the load of _load."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.common.trees import tree_leaves

    rec = {"prefill": [], "inputs": [], "logits": []}
    adapter = eng.adapter
    inner_prefill = type(adapter).prefill_prompt.__get__(adapter)

    def prefill_prompt(ids, buckets):
        state, shape = inner_prefill(ids, buckets)
        rec["prefill"].append((tuple(ids), [t.clone() for t in
                                            tree_leaves(state)]))
        return state, shape

    inner_decode = type(eng).decode_pool.__get__(eng)

    def decode_pool():
        pool = eng.pool
        rec["inputs"].append((list(map(int, pool.tokens)),
                              list(map(int, pool.pos)),
                              list(pool.active_slots())))
        logits = inner_decode()
        rec["logits"].append(logits.clone())
        return logits

    adapter.prefill_prompt = prefill_prompt
    eng.decode_pool = decode_pool
    try:
        torch.cuda.synchronize()
        if loaded:
            load = _load(torch)
        if profiled:
            with profile(activities=[ProfilerActivity.CUDA]):
                out = fn(counted=counted)
                torch.cuda.synchronize()
        else:
            out = fn(counted=counted)
            torch.cuda.synchronize()
    finally:
        adapter.__dict__.pop("prefill_prompt", None)
        eng.__dict__.pop("decode_pool", None)
    if loaded:
        torch.cuda.synchronize()
        del load
    rec["tokens"] = [list(s.tokens) for s in out]
    return rec


def _first_difference(base, rec):
    """Where ``rec`` first departs from ``base``."""
    for i, ((ids0, s0), (ids1, s1)) in enumerate(zip(base["prefill"],
                                                     rec["prefill"])):
        if ids0 != ids1:
            return {"where": "prefill ids", "prefill": i}
        for j, (a, b) in enumerate(zip(s0, s1)):
            if not (a.shape == b.shape and bool((a == b).all())):
                d = (a.float() - b.float()).abs()
                return {"where": "prefill state", "prefill": i, "leaf": j,
                        "prompt_len": len(ids0),
                        "max_abs_diff": float(d.max()),
                        "elements_differing": int((d > 0).sum())}
    for t, (x0, x1) in enumerate(zip(base["inputs"], rec["inputs"])):
        if x0 != x1:
            return {"where": "decode inputs", "step": t, "base": x0,
                    "run": x1}
        a, b = base["logits"][t], rec["logits"][t]
        if not bool((a == b).all()):
            d = (a - b).abs()
            live = x0[2]
            return {"where": "decode logits", "step": t,
                    "max_abs_diff": float(d.max()),
                    "live_rows_differing": [
                        s for s in live if bool((d[s] > 0).any())],
                    "dead_rows_differing": [
                        s for s in range(d.shape[0])
                        if s not in live and bool((d[s] > 0).any())]}
    if len(base["inputs"]) != len(rec["inputs"]):
        return {"where": "step count", "base": len(base["inputs"]),
                "run": len(rec["inputs"])}
    if base["tokens"] != rec["tokens"]:
        return {"where": "streams only"}
    return None


def diag_engine_launches(torch, eng, kernels, fn, tries: int = 3,
                         what: str = "serving"):
    """Serve ``fn`` REPEATS more times against its first run, print the
    DIAG line, then run chip_smoke's own _engine_launches."""
    large = eng.adapter.__class__.__name__ == "AttentionDecodeAdapter" \
        and eng.net.num_params() > 50_000_000
    n = REPEATS["large" if large else "small"]
    t0 = time.perf_counter()
    base = _record_run(torch, eng, fn, counted=False, profiled=False)
    runs = []
    for i in range(1, n):
        profiled, loaded = i % 2 == 1, i % 3 == 2
        rec = _record_run(torch, eng, fn, counted=profiled,
                          profiled=profiled, loaded=loaded)
        diff = _first_difference(base, rec)
        runs.append({"run": i, "profiled": profiled, "loaded": loaded,
                     "diff": diff})
        del rec
    del base
    torch.cuda.empty_cache()
    differing = [r for r in runs if r["diff"] is not None]
    print("DIAG " + json.dumps({
        "adapter": eng.adapter.__class__.__name__,
        "kv_dtype": getattr(eng.adapter, "kv_dtype", None),
        "params": eng.net.num_params(), "runs": n,
        "runs_differing": len(differing), "differences": differing[:6],
        "seconds": time.perf_counter() - t0}), flush=True)
    return ORIGINAL(torch, eng, kernels, fn, tries, what=what)


def main():
    cs.fail = soft_fail
    cs._engine_launches = diag_engine_launches
    t0 = time.perf_counter()
    try:
        cs.main()
    except Exception as e:
        import traceback
        traceback.print_exc()
        FAILS.append(f"exception: {e!r}")
    print(f"main done in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(FAILS), flush=True)


if __name__ == "__main__":
    main()
