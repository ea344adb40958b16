"""Ranks as processes: the launcher of the port's parallel modules.

The JAX package runs one program over every device of a host and, across
hosts, the same program under ``jax.distributed``. The port runs one
process per rank, joined by ``torch.distributed``: NCCL between cards, gloo
when the caller asks for the CPU. This module is the counterpart of what
``jax.distributed`` gives the JAX package:

- :func:`run` spawns ``world_size`` ranks, each calling ``fn(rank, *args)``
  with the default process group initialized, and returns every rank's
  result in rank order. The rendezvous is a ``FileStore`` in a fresh
  temporary directory (so parallel test workers cannot clash on ports); the
  call joins with a time limit, kills every rank when one fails or the
  limit passes, and raises the failing rank's exception in the caller (the
  rank's traceback attached as a note).
- :func:`init_rank` is what each spawned rank runs before ``fn``: the rank's
  card (local rank = rank modulo the cards of the host), then the group.
- :func:`local_group` is a group of one rank in the calling process (the
  chip smoke run's NCCL group on its one card).

There is no fallback: ``device="cuda"`` is NCCL on as many cards as ranks
or it raises, and gloo runs only when the caller asks for the CPU.
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
import pickle
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# seconds the caller waits, after a rank's failure report, for the
# reports of the ranks that fail because it left
FAILURE_GRACE_S = 1.0


def _backend(device: str) -> str:
    if device not in BACKENDS:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return BACKENDS[device]


def _require_cards(world_size: int) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA world needs the card, but torch.cuda.is_available() is "
            "False; pass device='cpu' for a gloo world on the CPU")
    if torch.cuda.device_count() < world_size:
        raise RuntimeError(
            f"a CUDA world of {world_size} ranks needs {world_size} cards "
            f"(one a rank; NCCL refuses two ranks on one card), found "
            f"{torch.cuda.device_count()}")


def init_rank(rank: int, world_size: int, device: str, store) -> None:
    """Join the default process group as ``rank``: on the card, the rank's
    own card first (``cuda:<rank modulo the host's cards>``) and NCCL; on
    the CPU, gloo."""
    backend = _backend(device)
    kw = {}
    if device == "cuda":
        _require_cards(1)
        local = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(local)
        kw["device_id"] = local
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, **kw)


@contextlib.contextmanager
def local_group(device: str = "cuda"):
    """A default process group of one rank in this process, destroyed on
    exit: NCCL on the card (the collectives still run, on one rank), gloo
    on the CPU."""
    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialized")
    init_rank(0, 1, device, dist.HashStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def _failure(e):
    """("error", exception, traceback, when): the exception as pickled
    for the caller, with the time it was caught."""
    when, tb = time.time(), traceback.format_exc()
    try:
        pickle.dumps(e)
    except Exception:
        e = RuntimeError(f"{type(e).__name__}: {e}")
    return ("error", e, tb, when)


def _rank_main(fn, rank, world_size, device, store_path, out_path, args,
               threads):
    """A spawned rank: join the group, run ``fn``, pickle ("ok", result) or
    :func:`_failure` to ``out_path``. A failure is timed before the group
    is torn down, so the first rank to fail is known from the others that
    fail because it left."""
    if threads:
        torch.set_num_threads(threads)
    try:
        init_rank(rank, world_size, device,
                  dist.FileStore(store_path, world_size))
        try:
            outcome = ("ok", fn(rank, *args))
        except BaseException as e:  # reported to the caller, raised there
            outcome = _failure(e)
        finally:
            dist.destroy_process_group()
    except BaseException as e:  # reported to the caller, raised there
        if "outcome" not in locals() or outcome[0] == "ok":
            outcome = _failure(e)
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(outcome, f)
    os.replace(tmp, out_path)


def _first_failure(outs, world_size):
    """The earliest-timed failure among the ranks' result files, raised
    with the rank's traceback as a note."""
    failed = []
    for r, path in enumerate(outs):
        if os.path.exists(path):
            with open(path, "rb") as f:
                outcome = pickle.load(f)
            if outcome[0] == "error":
                failed.append((outcome[3], r, outcome[1], outcome[2]))
    _, r, exc, tb = min(failed, key=lambda f: f[:2])
    exc.add_note(f"raised in rank {r} of {world_size}:\n{tb}")
    raise exc


def _stop(procs) -> None:
    procs = [p for p in procs if p.pid is not None]  # started
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)


def run(fn, world_size: int, *, device: str = "cuda", args=(),
        timeout: float = 300.0, threads: int | None = None) -> list:
    """``fn(rank, *args)`` in ``world_size`` spawned processes, each in the
    default process group; returns the ranks' results in rank order.

    ``fn`` and ``args`` are pickled (``fn`` by import path) and so is each
    result. ``threads`` sets ``torch.set_num_threads`` in every rank. The
    first rank to raise, or to exit without a result, ends the call: every
    rank is killed and the exception is raised here. A call still running
    after ``timeout`` seconds is killed and raises ``TimeoutError``."""
    _backend(device)
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    if device == "cuda":
        _require_cards(world_size)
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="dl4j_torch_world_")
    outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world_size)]
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, r, world_size, device, os.path.join(tmp, "store"), outs[r],
        tuple(args), threads)) for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        results = [None] * world_size
        pending = set(range(world_size))
        while pending:
            for r in sorted(pending):
                if os.path.exists(outs[r]):
                    with open(outs[r], "rb") as f:
                        outcome = pickle.load(f)
                    if outcome[0] == "error":
                        # the others fail soon after the first; let their
                        # reports land before choosing the earliest
                        time.sleep(FAILURE_GRACE_S)
                        _first_failure(outs, world_size)
                    results[r] = outcome[1]
                    pending.discard(r)
                elif (not procs[r].is_alive()
                      and not os.path.exists(outs[r])):
                    raise RuntimeError(
                        f"rank {r} of {world_size} exited with code "
                        f"{procs[r].exitcode} and no result")
            if pending and time.monotonic() > deadline:
                raise TimeoutError(
                    f"ranks {sorted(pending)} of {world_size} still running "
                    f"after {timeout} s; killed")
            if pending:
                time.sleep(0.02)
        for p in procs:
            p.join(timeout)
        return results
    finally:
        _stop(procs)
        shutil.rmtree(tmp, ignore_errors=True)
