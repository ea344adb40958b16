"""Multi-tenant admission: API keys, priority classes, sliding-window quotas.

Counterpart of ``deeplearning4j_tpu/serving/tenancy.py``, copied: the
module has no framework in it.

The scenario this kills: one abusive (or merely enthusiastic) tenant fills
the queues and every other tenant's latency degrades equally. Here each
tenant authenticates with an API key (``X-Api-Key`` header or ``api_key``
body field), carries a priority class (``interactive`` > ``batch``) that the
queues and slot pools honor, and is metered against sliding-window request
and token quotas — a request over quota is rejected NOW with 429 and a
``Retry-After`` computed from when the window actually frees up, instead of
degrading everyone.

Zero-overhead contract: a gateway constructed without ``tenants=`` never
builds a :class:`TenantTable` and the request path performs none of this —
no key lookup, no window pruning, no per-tenant metrics (spy-guarded in
tests/test_torch_serving_gateway.py).
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque
from typing import Dict, Iterable, Optional, Union

from deeplearning4j_tpu_torch import monitoring
from deeplearning4j_tpu_torch.serving.http import HttpError

#: priority classes, highest first — shed order is the reverse
PRIORITY_CLASSES = ("interactive", "default", "batch")


def class_rank(klass: Optional[str]) -> int:
    """Smaller = higher priority; unknown classes rank with ``default``."""
    try:
        return PRIORITY_CLASSES.index(klass or "default")
    except ValueError:
        return PRIORITY_CLASSES.index("default")


@dataclasses.dataclass(frozen=True)
class Tenant:
    """One API-key principal: identity, priority class, and quota bounds.

    ``requests_per_window`` / ``tokens_per_window`` of None means unmetered
    for that resource; ``window_s`` is the sliding accounting window. A
    predict request costs its batch-row count in tokens; a generate request
    costs its requested ``max_new_tokens``.
    """

    key: str
    name: str
    klass: str = "interactive"
    requests_per_window: Optional[int] = None
    tokens_per_window: Optional[int] = None
    window_s: float = 60.0

    def __post_init__(self):
        if self.klass not in PRIORITY_CLASSES:
            raise ValueError(
                f"tenant {self.name!r}: unknown priority class "
                f"{self.klass!r} (known: {', '.join(PRIORITY_CLASSES)})")


class QuotaExceeded(HttpError):
    """429 with a drain-aware Retry-After; ``resource`` says which quota
    (requests/tokens) bit."""

    def __init__(self, tenant: str, resource: str, retry_after_s: float):
        retry = min(max(int(math.ceil(retry_after_s)), 1), 30)
        super().__init__(
            429, f"tenant {tenant!r} {resource} quota exceeded; retry later",
            headers={"Retry-After": str(retry)})
        self.resource = resource


class TenantTable:
    """API-key -> Tenant resolution plus sliding-window usage accounting.

    Thread-safe: the gateway's handler threads authorize/admit concurrently.
    Usage is a per-tenant deque of ``(t, tokens)`` events pruned lazily at
    admit time — O(evicted) per call, no background thread.
    """

    def __init__(self, tenants: Iterable[Union[Tenant, dict]]):
        self._tenants: Dict[str, Tenant] = {}
        for t in tenants:
            if isinstance(t, dict):
                t = Tenant(**t)
            if t.key in self._tenants:
                raise ValueError(f"duplicate tenant API key for {t.name!r}")
            self._tenants[t.key] = t
        self._usage: Dict[str, deque] = {t.name: deque()
                                         for t in self._tenants.values()}
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._tenants)

    def tenants(self):
        return list(self._tenants.values())

    # -------------------------------------------------------------- authn
    def authorize(self, body: dict, headers=None) -> Tenant:
        """Resolve the request's tenant from ``X-Api-Key`` (header) or
        ``api_key`` (body). 401 on missing/unknown key — multi-tenant
        gateways serve no anonymous traffic."""
        key = None
        if headers is not None:
            key = headers.get("X-Api-Key")
        if key is None:
            key = body.get("api_key")
        if key is None:
            self._count_anon("missing_key")
            raise HttpError(401, "missing API key (X-Api-Key header or "
                                 "api_key body field)")
        tenant = self._tenants.get(key)
        if tenant is None:
            self._count_anon("unknown_key")
            raise HttpError(401, "unknown API key")
        return tenant

    def _count_anon(self, outcome: str):
        mon = monitoring.tenant_monitor()
        if mon is not None:
            mon.requests_total.labels(tenant="<unauthorized>",
                                      outcome=outcome).inc()

    # -------------------------------------------------------------- quota
    def _prune(self, events: deque, now: float, window: float):
        cutoff = now - window
        while events and events[0][0] <= cutoff:
            events.popleft()

    def admit(self, tenant: Tenant, tokens: int = 1) -> None:
        """Charge one request of ``tokens`` cost against the tenant's
        sliding window, or raise :class:`QuotaExceeded` (429) with a
        Retry-After saying when the window will have drained enough."""
        now = time.monotonic()
        with self._lock:
            events = self._usage[tenant.name]
            self._prune(events, now, tenant.window_s)
            n_req = len(events)
            n_tok = sum(e[1] for e in events)
            resource = None
            if (tenant.requests_per_window is not None
                    and n_req + 1 > tenant.requests_per_window):
                resource = "requests"
            elif (tenant.tokens_per_window is not None
                    and n_tok + tokens > tenant.tokens_per_window):
                resource = "tokens"
            if resource is not None:
                # the window frees up when its oldest event ages out
                retry = (events[0][0] + tenant.window_s - now) if events \
                    else tenant.window_s
                self._record(tenant, f"quota_{resource}", 0, n_req, n_tok)
                raise QuotaExceeded(tenant.name, resource, retry)
            events.append((now, tokens))
            n_req, n_tok = n_req + 1, n_tok + tokens
        self._record(tenant, "admitted", tokens, n_req, n_tok)

    def usage(self, tenant: Tenant) -> Dict[str, int]:
        """Current in-window usage (requests, tokens) for status surfaces."""
        now = time.monotonic()
        with self._lock:
            events = self._usage[tenant.name]
            self._prune(events, now, tenant.window_s)
            return {"requests": len(events),
                    "tokens": sum(e[1] for e in events)}

    def _record(self, tenant: Tenant, outcome: str, tokens: int,
                n_req: int, n_tok: int):
        mon = monitoring.tenant_monitor()
        if mon is None:
            return
        mon.requests_total.labels(tenant=tenant.name, outcome=outcome).inc()
        if tokens:
            mon.tokens_total.labels(tenant=tenant.name).inc(tokens)
        if tenant.requests_per_window is not None:
            mon.quota_remaining.labels(tenant=tenant.name,
                                       resource="requests").set(
                max(0, tenant.requests_per_window - n_req))
        if tenant.tokens_per_window is not None:
            mon.quota_remaining.labels(tenant=tenant.name,
                                       resource="tokens").set(
                max(0, tenant.tokens_per_window - n_tok))
