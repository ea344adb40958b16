"""Training checkpoints with durability hardening.

Counterpart of ``deeplearning4j_tpu/util/checkpoints.py``. The model zip
(``util/serialization.py``) covers interchange; this module covers the
training checkpoint: step-indexed saves of {params, state, opt_state} with
keep-last-N retention, written on a background thread.

The JAX package writes through orbax. The port writes its own format, one
directory a step: ``<directory>/<step>/payload.pt``, the three trees as
CPU tensors in ``torch.save``'s zip, committed by an atomic rename of the
step's temporary directory. Its durability contract is the JAX package's:

- every save writes an **integrity manifest** (``manifest-<step>.json``:
  the sorted leaf paths, in ``jax.tree_util.keystr`` form, and the crc32
  of every leaf's host bytes, so the same weights give the same
  checksums in both packages);
- :meth:`TrainingCheckpointer.restore` validates the payload against the
  manifest and raises :class:`CheckpointCorrupt` on a mismatch;
- :meth:`TrainingCheckpointer.restore_latest` walks the steps newest first
  and falls back to the newest valid step instead of raising;
- retention (keep-last-N) never deletes the last step that restored;
- save and restore I/O run under a :class:`faults.RetryPolicy`.

A save copies the trees to pinned host memory on the current stream
without blocking the host, then a writer thread waits for that copy,
checksums and writes; :meth:`wait` joins every pending write and raises
the first error. Fault points (``faults``): ``ckpt_io`` fails a save
submit or a restore read with an OSError; ``ckpt_corrupt`` truncates a
committed step's payload after the save. With monitoring on, a save is
a ``checkpoint.save`` span and counts in ``dl4j_checkpoint_save_seconds``
(the submit time under async saves), ``dl4j_checkpoint_bytes_total`` and
``dl4j_checkpoint_saves_total``; a restore that falls back past an invalid
step counts ``dl4j_recovery_total{component="checkpoint",
outcome="fallback"}``, and finding none ``outcome="no_valid_checkpoint"``.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import warnings
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional

import torch

from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener

PAYLOAD = "payload.pt"


class CheckpointCorrupt(Exception):
    """A restored payload failed manifest validation (structure or checksum
    mismatch): the step is not a valid recovery point."""


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{leaf path: tensor} in order, the paths spelled as
    ``jax.tree_util.keystr`` spells them (``['params'][0]['W']``)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}[{k!r}]"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}[{i}]"))
        return out
    if tree is None:
        return {}
    return {prefix: tree}


def checksum(t) -> int:
    """crc32 of a leaf's host bytes (little-endian, row-major)."""
    t = torch.as_tensor(t).detach().cpu().contiguous()
    return zlib.crc32(t.reshape(-1).view(torch.uint8).numpy().tobytes())


def _snapshot(tree):
    """``tree`` copied to host memory as of the current stream position:
    CUDA leaves into pinned buffers without blocking, CPU leaves cloned."""
    def copy(t):
        if not isinstance(t, torch.Tensor):
            return t
        t = t.detach()
        if t.is_cuda:
            out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return out.copy_(t, non_blocking=True)
        return t.clone()

    from deeplearning4j_tpu_torch.common.trees import tree_map

    return tree_map(copy, tree)


class TrainingCheckpointer:
    """Step-indexed {params, state, opt_state} checkpoints.

        ckpt = TrainingCheckpointer(dir, keep_last=3)
        ckpt.save(step, model)             # written on a thread by default
        step = ckpt.restore_latest(model)  # newest valid step, or None
    """

    def __init__(self, directory: str, keep_last: int = 3,
                 async_save: bool = True, retry=None):
        from deeplearning4j_tpu_torch.faults import RetryPolicy

        self.directory = str(directory)
        self.keep_last = max(1, int(keep_last))
        self.async_save = bool(async_save)
        self._retry = retry or RetryPolicy(
            max_attempts=4, base_delay_s=0.05, max_delay_s=1.0,
            deadline_s=60.0)
        self._last_good: Optional[int] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending: List[Future] = []
        self._closed = False
        os.makedirs(self.directory, exist_ok=True)

    # ------------------------------------------------------------- layout
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self.directory, f"manifest-{int(step)}.json")

    def all_steps(self) -> List[int]:
        """Committed steps, ascending."""
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.exists(
                    os.path.join(self.directory, name, PAYLOAD)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------- saving
    def save(self, step: int, model) -> None:
        from deeplearning4j_tpu_torch import faults, monitoring

        step = int(step)
        plan = faults.active()

        def submit():
            if plan is not None and plan.fires("ckpt_io", step=step):
                raise faults.CheckpointIOFault(
                    f"injected checkpoint I/O failure at step {step}")
            payload = _snapshot({"params": model.params,
                                 "state": model.state,
                                 "opt_state": model.opt_state})
            ready = None
            if torch.cuda.is_available() and any(
                    t.is_pinned() for t in flatten(payload).values()):
                ready = torch.cuda.Event()
                ready.record()
            return payload, ready

        mon = monitoring.checkpoint_monitor()
        if mon is None:
            payload, ready = self._retry.call(submit, component="checkpoint")
        else:
            from deeplearning4j_tpu_torch.common.trees import tree_leaves

            trees = (model.params, model.state, model.opt_state)
            nbytes = sum(t.numel() * t.element_size()
                         for t in tree_leaves(trees)
                         if isinstance(t, torch.Tensor))
            with monitoring.span("checkpoint.save", step=step, bytes=nbytes):
                t0 = time.perf_counter()
                # async saves: this is the submit cost the fit loop pays;
                # the background write finishes under wait()
                payload, ready = self._retry.call(submit,
                                                  component="checkpoint")
                mon.save_seconds.observe(time.perf_counter() - t0)
            mon.saved_bytes.inc(nbytes)
            mon.saves.inc()
        if self.async_save:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    1, thread_name_prefix="dl4j-checkpoint")
            self._pending.append(self._pool.submit(
                self._write, step, payload, ready))
        else:
            self._write(step, payload, ready)
        if plan is not None and plan.fires("ckpt_corrupt", step=step):
            # torn-write simulation: commit, then truncate the payload
            self.wait()
            self._corrupt_step(step)

    def _write(self, step: int, payload, ready) -> None:
        """Checksum, write and commit one step, then apply retention."""
        if ready is not None:
            ready.synchronize()
        flat = flatten(payload)
        final = self._step_dir(step)
        tmp = os.path.join(self.directory, f".{step}.tmp")

        def write():
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(payload, os.path.join(tmp, PAYLOAD))
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)  # atomic commit of the step

        self._retry.call(write, component="checkpoint")
        manifest = {
            "step": step,
            "created": time.time(),
            "structure": sorted(flat),
            "checksums": {k: checksum(v) for k, v in flat.items()},
        }
        path = self._manifest_path(step)
        with open(path + ".tmp", "w") as f:
            json.dump(manifest, f)
        os.replace(path + ".tmp", path)  # atomic: no torn manifests
        self._prune()

    def _corrupt_step(self, step: int) -> None:
        """Truncate every non-trivial file under the committed step's
        directory (the injected ``ckpt_corrupt`` action)."""
        for dirpath, _dirs, files in os.walk(self._step_dir(step)):
            for name in files:
                path = os.path.join(dirpath, name)
                try:
                    if os.path.getsize(path) > 16:
                        with open(path, "r+b") as f:
                            f.truncate(os.path.getsize(path) // 2)
                except OSError:
                    continue

    def _prune(self) -> None:
        """Keep the newest ``keep_last`` steps plus the last known-good one
        (never delete the only step that provably restores)."""
        steps = self.all_steps()
        if len(steps) <= self.keep_last:
            return
        keep = set(steps[-self.keep_last:])
        if self._last_good is not None and self._last_good in steps:
            keep.add(self._last_good)
        for s in steps:
            if s in keep:
                continue
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
            try:
                os.remove(self._manifest_path(s))
            except OSError:
                pass

    def wait(self) -> None:
        """Join every pending write; raise the first one's error."""
        pending, self._pending = self._pending, []
        errors = [f.exception() for f in pending]
        for e in errors:
            if e is not None:
                raise e

    # ----------------------------------------------------------- restoring
    def _validate(self, step: int, flat) -> None:
        """Raise CheckpointCorrupt when the payload disagrees with the
        step's manifest; a missing manifest is accepted with a warning."""
        path = self._manifest_path(step)
        if not os.path.exists(path):
            warnings.warn(f"checkpoint step {step} has no integrity "
                          f"manifest; restoring unvalidated")
            return
        try:
            with open(path) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointCorrupt(
                f"step {step}: unreadable manifest ({e})") from e
        if sorted(flat) != manifest["structure"]:
            raise CheckpointCorrupt(
                f"step {step}: restored tree structure does not match the "
                f"manifest ({len(flat)} leaves vs "
                f"{len(manifest['structure'])})")
        for key, want in manifest["checksums"].items():
            if want is None:
                continue
            got = checksum(flat[key])
            if got != want:
                raise CheckpointCorrupt(
                    f"step {step}: payload checksum mismatch at {key} "
                    f"(stored {want}, restored {got})")

    def restore_latest(self, model) -> Optional[int]:
        """Restore the newest valid checkpoint: a step that fails to read
        or to validate is skipped (with a warning, counted as a
        ``fallback`` recovery), not raised."""
        from deeplearning4j_tpu_torch import monitoring

        self.wait()
        steps = sorted(self.all_steps(), reverse=True)
        for i, step in enumerate(steps):
            try:
                restored = self.restore(step, model)
            except KeyboardInterrupt:
                raise
            except Exception as e:  # noqa: BLE001 — an unreadable or
                # corrupt step must not kill the relaunch; the next older
                # step is the recovery point
                warnings.warn(f"checkpoint step {step} is not restorable "
                              f"({type(e).__name__}: {e}); falling back to "
                              f"the previous step")
                continue
            if i > 0:
                mon = monitoring.recovery_monitor()
                if mon is not None:
                    mon.recovery_total.labels(
                        component="checkpoint", outcome="fallback").inc()
            return restored
        if steps:
            mon = monitoring.recovery_monitor()
            if mon is not None:
                mon.recovery_total.labels(
                    component="checkpoint",
                    outcome="no_valid_checkpoint").inc()
            warnings.warn(f"no restorable checkpoint among steps {steps}; "
                          f"starting from scratch")
        return None

    def restore(self, step: int, model) -> int:
        """Load step ``step`` into ``model`` (on its device) and set its
        ``step_count``; raises CheckpointCorrupt on a manifest mismatch."""
        from deeplearning4j_tpu_torch import faults
        from deeplearning4j_tpu_torch.common.trees import tree_map

        step = int(step)
        plan = faults.active()

        def read():
            if plan is not None and plan.fires("ckpt_io", step=step):
                raise faults.CheckpointIOFault(
                    f"injected checkpoint read failure at step {step}")
            return torch.load(os.path.join(self._step_dir(step), PAYLOAD),
                              map_location="cpu", weights_only=True)

        restored = self._retry.call(read, component="checkpoint")
        self._validate(step, flatten(restored))
        template = {"params": model.params, "state": model.state,
                    "opt_state": model.opt_state}
        if sorted(flatten(restored)) != sorted(flatten(template)):
            raise ValueError(f"step {step}: the checkpoint's trees do not "
                             f"match this model's")
        dev = model.device
        on = lambda t: t.to(dev) if isinstance(t, torch.Tensor) else t  # noqa: E731
        model.params = tree_map(on, restored["params"])
        model.state = tree_map(on, restored["state"])
        model.opt_state = tree_map(on, restored["opt_state"])
        model.step_count = step
        self._last_good = step
        return step

    def close(self) -> None:
        """Idempotent: joins pending writes and stops the writer thread."""
        if self._closed:
            return
        self._closed = True
        try:
            self.wait()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)


class AsyncCheckpointListener(TrainingListener):
    """Listener wiring the checkpointer into fit() (CheckpointListener's
    role, with background writes instead of zip writes). The final step is
    always saved when fit() completes."""

    needs_eager_score = True  # saves the model at each checkpoint iteration

    def __init__(self, directory: str, save_every_n_iterations: int = 1000,
                 keep_last: int = 3):
        self.checkpointer = TrainingCheckpointer(directory, keep_last)
        self.every = max(1, save_every_n_iterations)
        self._last_saved: Optional[int] = None

    def iteration_done(self, model, iteration: int, epoch: int, score: float):
        if iteration > 0 and iteration % self.every == 0:
            self.checkpointer.save(iteration, model)
            self._last_saved = iteration

    def on_epoch_end(self, model, epoch: int):
        self.checkpointer.wait()

    def on_fit_end(self, model):
        step = int(getattr(model, "step_count", 0))
        if step and step != self._last_saved:
            self.checkpointer.save(step, model)
            self._last_saved = step
        self.checkpointer.wait()
