"""Shared retry policy: exponential backoff + jitter + deadline.

Counterpart of ``deeplearning4j_tpu/faults/retry.py``, copied: the policy
is explicit and shared by every transient-failure site of the port
(checkpoint I/O, dataset reads). The JAX package also counts every retry
and recovery outcome in its monitoring registry; those counters wait for
the port's monitoring slice.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type


class RetryDeadlineExceeded(Exception):
    """Raised when the policy's wall-clock deadline expires before an
    attempt succeeds; ``__cause__`` carries the last attempt's error."""


class RetryPolicy:
    """Exponential backoff with jitter, bounded by attempts AND deadline.

        policy = RetryPolicy(max_attempts=4, base_delay_s=0.05)
        out = policy.call(flaky_fn, arg, component="checkpoint")

    ``retry_on``: exception types treated as transient; anything else
    propagates immediately. ``component`` names the site in the deadline
    error (the JAX package also labels its recovery counters with it).
    """

    def __init__(self, max_attempts: int = 4, base_delay_s: float = 0.05,
                 max_delay_s: float = 2.0, deadline_s: float = 30.0,
                 jitter: float = 0.5,
                 retry_on: Tuple[Type[BaseException], ...] = (
                     OSError, ConnectionError, TimeoutError),
                 seed: Optional[int] = None,
                 sleep: Callable[[float], None] = time.sleep):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        self.max_attempts = int(max_attempts)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.deadline_s = float(deadline_s)
        self.jitter = float(jitter)
        self.retry_on = tuple(retry_on)
        self._rng = random.Random(seed)
        self._sleep = sleep

    def delay_for(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based): exponential, capped,
        with multiplicative jitter in [1, 1+jitter)."""
        d = min(self.max_delay_s, self.base_delay_s * (2.0 ** (attempt - 1)))
        return d * (1.0 + self.jitter * self._rng.random())

    def call(self, fn: Callable, *args, component: str = "",
             on_retry: Optional[Callable[[int, BaseException], None]] = None,
             **kw):
        """Run ``fn(*args, **kw)`` under the policy. ``on_retry(attempt,
        error)`` fires before each backoff sleep."""
        start = time.monotonic()
        attempt = 0
        while True:
            try:
                out = fn(*args, **kw)
            except self.retry_on as e:
                attempt += 1
                delay = self.delay_for(attempt)
                exhausted = attempt >= self.max_attempts
                past_deadline = (time.monotonic() - start + delay
                                 > self.deadline_s)
                if exhausted or past_deadline:
                    if past_deadline and not exhausted:
                        raise RetryDeadlineExceeded(
                            f"{component or 'operation'} still failing after "
                            f"{attempt} attempt(s) and "
                            f"{time.monotonic() - start:.2f}s") from e
                    raise
                if on_retry is not None:
                    on_retry(attempt, e)
                self._sleep(delay)
                continue
            # the recovery counters (retried_ok, gave_up) wait for the
            # monitoring slice
            return out
