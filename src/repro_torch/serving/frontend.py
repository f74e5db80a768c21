"""Async serving front door: admission, deadline-aware dynamic batching,
per-tenant quotas, and a stdlib HTTP/JSON endpoint.

Counterpart of ``repro.serving.frontend`` over the port's
:class:`~repro_torch.serving.serve.QueryServer`: the same admission,
batching, resilience, metric names and labels, reject reasons,
``retry_after_ms`` arithmetic, HTTP routes, status codes and JSON fields.

This is the layer that models *concurrent clients* over the fused batched
query path — the GPUExecutor shape: a bounded admission queue decouples
request intake from device execution, and one dispatcher thread drains it
into single fused ``query_many`` dispatches.

Pipeline (see docs/serving.md for the full diagram and SLO guidance)::

    client threads / HTTP handlers
        │  submit(q, tenant, deadline)
        ▼
    [admission]  per-tenant token bucket ──✗──► Rejected(throttled,
        │                                        retry_after)
        ▼
    [queue]  bounded depth ──✗──► Rejected(queue_full, retry_after)
        │                         (explicit backpressure, never silent
        ▼                          blocking)
    [dispatcher thread]  coalesce: wait ≤ batch_window_ms OR until
        │                max_batch queued, whichever first
        │   drop + count queries whose deadline elapsed while queued
        ▼
    QueryServer.query_many  — ONE fused dispatch for the whole batch
        │
        ▼
    per-request ``QueryResult`` futures (bit-identical to per-query
    ``query()`` answers — batching is a scheduling optimization, never a
    semantic one; asserted in tests/test_torch_frontend.py)

Shape discipline: every dispatch is padded to exactly
``(max_batch, query_pad·j)``, the reference's shapes (there a jit cache
holds one program per width bucket; on the card no compile cache needs
it).  Padding coordinates (idx = -1) contribute exact zeros, which is why
coalesced answers stay bit-identical; the all-padding dummy rows beyond
the live queries go through the kernels as queries of no coordinates and
their answers are discarded.

Resilience (docs/robustness.md):

* the dispatcher is **supervised** — a crash restarts it (bounded times)
  instead of silently wedging every future;
* a **poisoned batch** is retried one query at a time, so only the
  malformed query's future fails and healthy riders still get answers;
* a **circuit breaker** over device dispatch fast-fails submits (429
  "unavailable") while the device is persistently broken; the half-open
  probe token is consumed by the dispatcher at dispatch time (never at
  admission), so a throttled/queue-full/expired request cannot strand it;
* a **stuck-device watchdog** fails in-flight futures with
  :class:`DeviceStuck` (HTTP 504) instead of hanging clients forever.  It
  cannot cancel a running CUDA kernel: like the reference, it fails the
  futures and leaves the dispatcher blocked in ``query_many`` (in its
  device-to-host copy of the answer) until the device returns;
* a **degradation ladder** driven by SLO fast-burn and queue depth
  brownouts instead of blacking out: L1 shrinks the rerank budget, L2
  serves sketch-only answers stamped ``degraded``, L3 sheds
  lowest-priority tenants with 429 — with hysteresis auto-recovery.

All queue/batch/latency/drop behaviour reports into the ``repro_torch.obs``
registry under the reference's names (metric catalog: docs/observability.md,
"Serving front door").
"""

from __future__ import annotations

import inspect
import json
import math
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from repro_torch.fault.degrade import DegradationController, DegradeConfig
from repro_torch.fault.retry import CircuitBreaker
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import recorder as obs_recorder
from repro_torch.obs import server as obs_server
from repro_torch.obs.recorder import new_batch_id
from repro_torch.obs.trace import TraceContext
from repro_torch.serving.results import QueryResult

__all__ = [
    "DeadlineExceeded",
    "DeviceStuck",
    "FrontendServer",
    "Rejected",
    "ServingFrontend",
    "TenantQuota",
]


class Rejected(RuntimeError):
    """Admission failure — the request never entered the queue.

    ``reason`` is ``"queue_full"`` (backpressure: the bounded admission
    queue is at depth) or ``"throttled"`` (the tenant's token bucket is
    empty).  ``retry_after_ms`` is the server's estimate of when capacity
    will exist; the HTTP front door surfaces it as a ``Retry-After`` header
    on a 429.
    """

    def __init__(self, reason: str, retry_after_ms: float, tenant: str,
                 trace_id: Optional[str] = None):
        super().__init__(f"rejected ({reason}, tenant={tenant!r}): "
                         f"retry after {retry_after_ms:.1f} ms")
        self.reason = reason
        self.retry_after_ms = float(retry_after_ms)
        self.tenant = tenant
        self.trace_id = trace_id     # resolves at /debug/trace/<id>


class DeadlineExceeded(RuntimeError):
    """The request's deadline elapsed while it sat in the queue.

    The query was admitted but never dispatched: spending device time on an
    answer nobody is still waiting for only steals capacity from requests
    that can still meet their deadline, so the dispatcher drops and counts
    it instead.
    """

    def __init__(self, queued_ms: float, deadline_ms: float,
                 trace_id: Optional[str] = None):
        super().__init__(f"deadline of {deadline_ms:.1f} ms elapsed after "
                         f"{queued_ms:.1f} ms in queue")
        self.queued_ms = queued_ms
        self.deadline_ms = deadline_ms
        self.trace_id = trace_id     # resolves at /debug/trace/<id>


class DeviceStuck(DeadlineExceeded):
    """The stuck-device watchdog failed this in-flight request.

    The dispatch it rode did not return within ``watchdog_timeout_s`` —
    a stalled device, not a busy queue.  Subclasses
    :class:`DeadlineExceeded` so every 504 path handles it unchanged;
    ``queued_ms``/``deadline_ms`` carry (time stuck, watchdog timeout).
    """


@dataclass(frozen=True)
class TenantQuota:
    """Token-bucket quota: sustained ``rate_qps`` with ``burst`` headroom.

    ``priority`` orders tenants for L3 load shedding: when the degradation
    ladder reaches its top level, tenants in the strictly-lowest priority
    class are shed with 429 (higher number = more important; sheds only
    when more than one distinct class exists)."""

    rate_qps: float
    burst: float = 0.0      # 0 -> defaults to max(rate_qps, 1)
    priority: int = 0

    def resolved_burst(self) -> float:
        return self.burst if self.burst > 0 else max(self.rate_qps, 1.0)


class _TokenBucket:
    def __init__(self, quota: TenantQuota, now: float):
        self.rate = float(quota.rate_qps)
        self.burst = float(quota.resolved_burst())
        self.tokens = self.burst
        self.t = now
        self.lock = threading.Lock()

    def try_take(self, now: float) -> float:
        """0.0 when a token was taken, else seconds until one exists."""
        with self.lock:
            self.tokens = min(self.burst,
                              self.tokens + (now - self.t) * self.rate)
            self.t = now
            if self.tokens >= 1.0:
                self.tokens -= 1.0
                return 0.0
            return (1.0 - self.tokens) / self.rate if self.rate > 0 \
                else math.inf


@dataclass
class _Pending:
    q_idx: np.ndarray
    q_val: np.ndarray
    k: Optional[int]
    tenant: str
    deadline_ms: float
    deadline: float              # clock timestamp
    enqueued: float              # clock timestamp
    ctx: TraceContext            # propagated request trace
    future: Future = field(default_factory=Future)


def _pad_batch(items, width: int, rows: int):
    """Pad sparse queries to one ``[rows, width]`` rectangle.

    Shorter queries pad with (idx=-1, val=0) — scoring treats idx<0 as
    absent and the contribution is an exact 0.0, so padding never changes a
    real row's answer.  Rows beyond ``len(items)`` are all-padding dummy
    queries whose results are discarded.
    """
    qi = np.full((rows, width), -1, np.int32)
    qv = np.zeros((rows, width), np.float32)
    for b, p in enumerate(items):
        L = p.q_idx.shape[0]
        qi[b, :L] = p.q_idx
        qv[b, :L] = p.q_val
    return qi, qv


class ServingFrontend:
    """Deadline-aware dynamically batching front end over a `QueryServer`.

    The only thing this class asks of ``server`` is ``query_many`` returning
    a batched :class:`QueryResult` and a ``k`` attribute, so tests can stub
    the device side, and any index layout the ``QueryServer`` handles
    (single, sharded, durable) serves through it unchanged.

    Admission (caller thread, never blocks on the device):

    1. per-tenant token bucket (``quotas`` / ``default_quota``; None =
       unthrottled) — failure raises :class:`Rejected` ("throttled");
    2. bounded queue (``queue_depth``) — failure raises :class:`Rejected`
       ("queue_full") with a retry-after derived from the queue's current
       drain rate.

    Dispatch (single daemon thread): collect for ``batch_window_ms`` after
    the first waiting request OR until ``max_batch`` requests are queued,
    whichever comes first; drop queued requests whose deadline has already
    elapsed (their futures fail with :class:`DeadlineExceeded`); pad to the
    fixed ``(max_batch, width_bucket)`` rectangle; one fused
    ``query_many``; split the batched result into per-request futures.

    ``submit`` returns a ``concurrent.futures.Future[QueryResult]``;
    :meth:`query` is the blocking convenience wrapper.
    """

    def __init__(self, server, *, max_batch: int = 16,
                 batch_window_ms: float = 2.0, queue_depth: int = 128,
                 default_deadline_ms: float = 1000.0,
                 quotas: Optional[Dict[str, TenantQuota]] = None,
                 default_quota: Optional[TenantQuota] = None,
                 query_pad: int = 32, registry=None,
                 clock=time.monotonic, recorder=None,
                 slo=None, degrade: Optional[DegradeConfig] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 watchdog_timeout_s: Optional[float] = None,
                 max_dispatcher_restarts: int = 3,
                 degrade_tick_s: float = 0.25):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        self.server = server
        self.max_batch = int(max_batch)
        self.batch_window_s = float(batch_window_ms) / 1e3
        self.queue_depth = int(queue_depth)
        self.default_deadline_ms = float(default_deadline_ms)
        self.query_pad = int(query_pad)
        self.quotas = dict(quotas or {})
        self.default_quota = default_quota
        self.registry = (obs_metrics.get_registry() if registry is None
                         else registry)
        self.recorder = recorder     # None -> process-global at record time
        self._clock = clock
        self._queue: deque[_Pending] = deque()
        self._cv = threading.Condition()
        self._buckets: Dict[str, _TokenBucket] = {}
        self._buckets_lock = threading.Lock()
        self._closed = False
        self._ewma_service_s = 0.0           # drain-rate estimate for 429s
        # -- resilience state -------------------------------------------------
        self.slo = slo               # SLOMonitor: the ladder's burn signal
        # No config -> ladder off: overload answers stay pure backpressure
        # unless the operator opts into brownouts.
        self.degrade = DegradationController(
            degrade if degrade is not None else DegradeConfig(enabled=False),
            registry=self.registry)
        self.breaker = breaker if breaker is not None else CircuitBreaker(
            failure_threshold=5, reset_timeout_s=5.0, name="frontend",
            clock=clock, registry=self.registry)
        self.watchdog_timeout_s = watchdog_timeout_s
        self.max_dispatcher_restarts = int(max_dispatcher_restarts)
        self.dispatcher_restarts = 0
        self._dispatcher_dead = False
        self._degrade_tick_s = float(degrade_tick_s)
        self._inflight = None        # (t0, live) while a dispatch is on-device
        self._inflight_lock = threading.Lock()   # dispatcher/watchdog CAS
        self._live_batch = None      # batch the dispatch loop is holding
        self._supports_degrade = self._probe_degrade(server)
        self._metrics_init()
        self._dispatcher = threading.Thread(target=self._dispatch_supervised,
                                            name="frontend-dispatch",
                                            daemon=True)
        self._dispatcher.start()
        self._hk_stop = threading.Event()
        self._housekeeper = threading.Thread(target=self._housekeeping,
                                             name="frontend-housekeeping",
                                             daemon=True)
        self._housekeeper.start()

    @staticmethod
    def _probe_degrade(server) -> bool:
        """Does ``server.query_many`` accept the ``degrade`` kwarg?  Probed
        once so stub servers in tests (and older QueryServers) keep working
        without it."""
        try:
            return "degrade" in inspect.signature(
                server.query_many).parameters
        except (TypeError, ValueError):
            return False

    # -- metrics -------------------------------------------------------------
    def _metrics_init(self):
        reg = self.registry
        self._m_depth = reg.gauge(
            "repro_frontend_queue_depth",
            "Requests currently waiting in the admission queue.")
        self._m_batch = reg.histogram(
            "repro_frontend_batch_size",
            "Live queries per coalesced dispatch.",
            buckets=obs_metrics.DEFAULT_COUNT_BUCKETS)
        self._m_wait = reg.histogram(
            "repro_frontend_coalesce_wait_ms",
            "Oldest-request wait from enqueue to dispatch.")
        self._m_dispatch = reg.counter(
            "repro_frontend_dispatches_total",
            "Coalesced device dispatches issued.")
        self._m_expired = reg.counter(
            "repro_frontend_expired_total",
            "Queries dropped because their deadline elapsed while queued.")

    def _m_outcome(self, tenant: str, outcome: str):
        return self.registry.counter(
            "repro_frontend_requests_total",
            "Front-door requests by tenant and outcome.",
            labels={"tenant": tenant, "outcome": outcome})

    def _m_reject(self, reason: str):
        return self.registry.counter(
            "repro_frontend_rejected_total",
            "Admission rejections (explicit backpressure) by reason.",
            labels={"reason": reason})

    def _m_throttle(self, tenant: str):
        return self.registry.counter(
            "repro_frontend_throttled_total",
            "Token-bucket quota rejections per tenant.",
            labels={"tenant": tenant})

    def _m_latency(self, tenant: str):
        return self.registry.histogram(
            "repro_frontend_latency_ms",
            "End-to-end front-door latency (admission to response).",
            labels={"tenant": tenant})

    def _m_shed(self, tenant: str):
        return self.registry.counter(
            "repro_frontend_shed_total",
            "Requests shed at ladder L3 (lowest-priority tenants, 429).",
            labels={"tenant": tenant})

    def _m_degraded_queries(self, level: int):
        return self.registry.counter(
            "repro_frontend_degraded_queries_total",
            "Requests answered while the degradation ladder was engaged.",
            labels={"level": str(level)})

    # -- tracing -------------------------------------------------------------
    def _recorder(self):
        return self.recorder if self.recorder is not None \
            else obs_recorder.get_recorder()

    def _seal(self, ctx: TraceContext, outcome: str, total_ms: float,
              error: Optional[str] = None):
        """Finish a request context and hand it to the flight recorder.
        Returns the retention reason (truthy when the id resolves)."""
        ctx.finish(outcome, total_ms=total_ms, error=error)
        rec = self._recorder()
        return rec.record(ctx) if rec is not None else None

    # -- admission -----------------------------------------------------------
    def submit(self, q_idx, q_val, *, tenant: str = "default",
               deadline_ms: Optional[float] = None,
               k: Optional[int] = None) -> Future:
        """Admit one query; returns a ``Future[QueryResult]``.

        Raises :class:`Rejected` synchronously when admission fails (quota
        or queue depth); the future fails with :class:`DeadlineExceeded`
        when the deadline elapses in-queue, or with the device error if the
        dispatch itself fails.
        """
        if self._closed:
            raise RuntimeError("frontend is closed")
        now = self._clock()
        ctx = TraceContext(tenant=tenant)
        deadline_ms = (self.default_deadline_ms if deadline_ms is None
                       else float(deadline_ms))
        if self._dispatcher_dead or self.breaker.state == "open":
            # Fast-fail while the device side is known-broken (breaker
            # open, or the supervised dispatcher exhausted its restarts):
            # a 429 with a honest retry hint beats queueing into a void.
            # Deliberately a state CHECK, not allow(): the half-open probe
            # token is consumed by the dispatcher at dispatch time, so a
            # request that is throttled, queue-full, or expires in queue
            # can never strand the probe and wedge the breaker.
            retry_ms = (self.breaker.remaining_s() * 1e3
                        if not self._dispatcher_dead
                        else self.default_deadline_ms)
            self._m_reject("unavailable").inc()
            self._m_outcome(tenant, "rejected_unavailable").inc()
            ctx.annotate(retry_after_ms=round(retry_ms, 3),
                         breaker=self.breaker.state,
                         dispatcher_dead=self._dispatcher_dead)
            self._seal(ctx, "rejected_unavailable",
                       (self._clock() - now) * 1e3)
            raise Rejected("unavailable", retry_ms, tenant,
                           trace_id=ctx.trace_id)
        if self.degrade.level >= 3 and self._sheddable(tenant):
            self._m_shed(tenant).inc()
            self._m_reject("shed").inc()
            self._m_outcome(tenant, "rejected_shed").inc()
            ctx.annotate(retry_after_ms=1000.0,
                         degrade_level=self.degrade.level)
            self._seal(ctx, "rejected_shed", (self._clock() - now) * 1e3)
            raise Rejected("shed", 1000.0, tenant, trace_id=ctx.trace_id)
        quota = self.quotas.get(tenant, self.default_quota)
        if quota is not None:
            with self._buckets_lock:
                bucket = self._buckets.get(tenant)
                if bucket is None:
                    bucket = self._buckets[tenant] = _TokenBucket(quota, now)
            wait_s = bucket.try_take(now)
            ctx.add_stage("quota", (self._clock() - now) * 1e3, start_ms=0.0)
            if wait_s > 0:
                self._m_throttle(tenant).inc()
                self._m_reject("throttled").inc()
                self._m_outcome(tenant, "rejected_throttled").inc()
                ctx.annotate(retry_after_ms=round(wait_s * 1e3, 3))
                self._seal(ctx, "rejected_throttled",
                           (self._clock() - now) * 1e3)
                raise Rejected("throttled", wait_s * 1e3, tenant,
                               trace_id=ctx.trace_id)
        else:
            ctx.add_stage("quota", (self._clock() - now) * 1e3, start_ms=0.0)
        p = _Pending(
            q_idx=np.asarray(q_idx, np.int32).reshape(-1),
            q_val=np.asarray(q_val, np.float32).reshape(-1),
            k=k, tenant=tenant, deadline_ms=deadline_ms,
            deadline=now + deadline_ms / 1e3, enqueued=now,
            ctx=ctx)
        if p.q_idx.shape != p.q_val.shape:
            raise ValueError(f"query idx/val length mismatch: "
                             f"{p.q_idx.shape[0]} vs {p.q_val.shape[0]}")
        with self._cv:
            if len(self._queue) >= self.queue_depth:
                # Explicit backpressure: hand the client a retry hint
                # instead of silently blocking its thread on our queue.
                per = self._ewma_service_s or self.batch_window_s or 1e-3
                retry_ms = per * (1 + len(self._queue) / self.max_batch) * 1e3
                self._m_reject("queue_full").inc()
                self._m_outcome(tenant, "rejected_queue_full").inc()
                ctx.annotate(retry_after_ms=round(retry_ms, 3),
                             queue_depth=len(self._queue))
                self._seal(ctx, "rejected_queue_full",
                           (self._clock() - now) * 1e3)
                raise Rejected("queue_full", retry_ms, tenant,
                               trace_id=ctx.trace_id)
            self._queue.append(p)
            self._m_depth.set(len(self._queue))
            self._cv.notify_all()
        return p.future

    def query(self, q_idx, q_val, *, tenant: str = "default",
              deadline_ms: Optional[float] = None,
              k: Optional[int] = None) -> QueryResult:
        """Blocking convenience wrapper over :meth:`submit`."""
        return self.submit(q_idx, q_val, tenant=tenant,
                           deadline_ms=deadline_ms, k=k).result()

    # -- dispatch ------------------------------------------------------------
    def _take_batch(self):
        """Wait for work, coalesce, and pop up to ``max_batch`` requests."""
        with self._cv:
            while not self._queue and not self._closed:
                self._cv.wait()
            if not self._queue:
                return []
            first = self._queue[0].enqueued
            while (len(self._queue) < self.max_batch and not self._closed):
                remaining = first + self.batch_window_s - self._clock()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
                if not self._queue:          # everything got drained/closed
                    return []
                first = self._queue[0].enqueued
            n = min(len(self._queue), self.max_batch)
            batch = [self._queue.popleft() for _ in range(n)]
            self._m_depth.set(len(self._queue))
            return batch

    def _sheddable(self, tenant: str) -> bool:
        """L3 sheds only the strictly-lowest priority class, and only when
        more than one class exists — uniform deployments never shed."""
        prios = {q.priority for q in self.quotas.values()}
        prios.add(self.default_quota.priority
                  if self.default_quota is not None else 0)
        if len(prios) <= 1:
            return False
        quota = self.quotas.get(tenant, self.default_quota)
        return (quota.priority if quota is not None else 0) == min(prios)

    @staticmethod
    def _try_fail(future: Future, exc: BaseException) -> bool:
        """Fail a future unless someone (watchdog vs dispatcher race) beat
        us to it.  True when this call actually set the exception."""
        try:
            future.set_exception(exc)
            return True
        except InvalidStateError:
            return False

    def _server_query(self, qi, qv, ctx, level: int):
        if self._supports_degrade and level > 0:
            return self.server.query_many(qi, qv, ctx=ctx, degrade=level)
        return self.server.query_many(qi, qv, ctx=ctx)

    def _dispatch_supervised(self):
        """Dispatcher crash supervisor: ``_dispatch_loop`` exiting cleanly
        (close) ends the thread; anything escaping it — only a bug in the
        loop itself can, batch failures are handled inside — restarts the
        loop up to ``max_dispatcher_restarts`` times before declaring the
        front door dead and failing everything still queued."""
        while True:
            try:
                self._dispatch_loop()
                return
            except BaseException as e:                   # noqa: BLE001
                # Whatever crashed the loop, the batch it was holding must
                # not leak: query() blocks on these futures with no timeout,
                # so an unfailed future is a client hung forever — exactly
                # the wedge this supervisor exists to prevent.
                batch, self._live_batch = self._live_batch, None
                for p in (batch or ()):
                    if p.future.done():
                        continue
                    self._m_outcome(p.tenant, "error").inc()
                    self._seal(p.ctx, "error",
                               (self._clock() - p.enqueued) * 1e3,
                               error=repr(e))
                    self._try_fail(p.future, e)
                if self._closed:
                    return
                self.dispatcher_restarts += 1
                self.registry.counter(
                    "repro_frontend_dispatcher_restarts_total",
                    "Supervised dispatcher crash-restarts.").inc()
                if self.dispatcher_restarts > self.max_dispatcher_restarts:
                    self._dispatcher_dead = True
                    with self._cv:
                        pending = list(self._queue)
                        self._queue.clear()
                        self._m_depth.set(0)
                    for p in pending:
                        self._m_outcome(p.tenant, "error").inc()
                        self._seal(p.ctx, "error",
                                   (self._clock() - p.enqueued) * 1e3,
                                   error=repr(e))
                        self._try_fail(p.future, e)
                    return

    def _dispatch_loop(self):
        while True:
            batch = self._take_batch()
            if not batch:
                if self._closed:
                    return
                continue
            self._live_batch = batch    # supervisor fails these on a crash
            now = self._clock()
            live = []
            for p in batch:
                queued_ms = (now - p.enqueued) * 1e3
                p.ctx.add_stage("queue", queued_ms)
                if p.deadline < now:
                    self._m_expired.inc()
                    self._m_outcome(p.tenant, "expired").inc()
                    self._seal(p.ctx, "expired", queued_ms,
                               error=f"deadline {p.deadline_ms:.1f} ms "
                                     f"elapsed in queue")
                    p.future.set_exception(DeadlineExceeded(
                        queued_ms, p.deadline_ms, trace_id=p.ctx.trace_id))
                else:
                    live.append(p)
            if not live:
                self._live_batch = None
                continue
            if not self.breaker.allow():
                # The breaker opened after these requests were admitted
                # (or the half-open probe dispatch is already in flight):
                # fast-fail instead of burning a known-broken device.  The
                # probe token is consumed HERE, by an actual dispatch whose
                # outcome is always recorded below — never by a request
                # that might be rejected or expire before reaching us.
                self._fail_unavailable(live)
                self._live_batch = None
                continue
            self._m_wait.observe(
                (now - min(p.enqueued for p in live)) * 1e3)
            self._m_batch.observe(len(live))
            self._m_dispatch.inc()
            bctx = TraceContext(tenant="batch", trace_id=new_batch_id())
            width = max(p.q_idx.shape[0] for p in live)
            width = max(self.query_pad,
                        -(-width // self.query_pad) * self.query_pad)
            level = self.degrade.level
            t0 = self._clock()
            try:
                qi, qv = _pad_batch(live, width, self.max_batch)
                bctx.add_stage("assembly", (self._clock() - t0) * 1e3,
                               start_ms=0.0)
                inflight = (self._clock(), live)
                with self._inflight_lock:
                    self._inflight = inflight
                try:
                    res = self._server_query(qi, qv, bctx, level)
                finally:
                    with self._inflight_lock:
                        # Identity compare: the watchdog clears exactly the
                        # tuple it tripped on, so a trip can never be
                        # mistaken for (or clobber) a different dispatch.
                        tripped = self._inflight is not inflight
                        self._inflight = None
            except Exception as e:                       # noqa: BLE001
                self._fail_batch(bctx, live, width, e, level)
                self._live_batch = None
                continue
            if not tripped:
                self.breaker.record_success()
            dt = self._clock() - t0
            a = 0.2        # smooth the drain-rate estimate for 429 hints
            self._ewma_service_s = (dt if self._ewma_service_s == 0
                                    else a * dt + (1 - a) * self._ewma_service_s)
            done = self._clock()
            pad_frac = 1.0 - (sum(p.q_idx.shape[0] for p in live)
                              / float(self.max_batch * width))
            if level > 0:
                self._m_degraded_queries(level).inc(len(live))
                bctx.annotate(degrade_level=level)
            for i, p in enumerate(live):
                if p.future.done():
                    continue        # watchdog already 504'd this rider
                out = res.row(i, k=p.k, trace_id=p.ctx.trace_id)
                self._m_outcome(p.tenant, "ok").inc()
                lat_ms = (done - p.enqueued) * 1e3
                # batch-level stages (assembly + synced device dispatch +
                # sampled device/* sub-spans) are wall time every rider
                # waited through, so each request inherits them whole.
                for name, _start, dur in bctx.stages:
                    p.ctx.add_stage(name, dur)
                p.ctx.add_stage("respond", (self._clock() - done) * 1e3)
                p.ctx.annotate(batch_id=bctx.trace_id, batch_size=len(live),
                               width_bucket=width,
                               padding_fraction=round(pad_frac, 4))
                if level > 0:
                    p.ctx.annotate(degraded=True, degrade_level=level)
                retained = self._seal(p.ctx, "ok", lat_ms)
                self._m_latency(p.tenant).observe(
                    lat_ms, exemplar=p.ctx.trace_id if retained else None)
                try:
                    p.future.set_result(out)
                except InvalidStateError:
                    pass            # lost the race to the watchdog
            bctx.finish("ok", total_ms=(self._clock() - t0) * 1e3)
            self._record_batch(bctx, live, width)
            self._live_batch = None

    def _fail_unavailable(self, live) -> None:
        """Fast-fail already-admitted requests while the breaker is open:
        the same 429 "unavailable" answer :meth:`submit` gives new traffic,
        minus the admission work."""
        retry_ms = (self.breaker.remaining_s() * 1e3
                    or self.default_deadline_ms)
        for p in live:
            if p.future.done():
                continue
            self._m_reject("unavailable").inc()
            self._m_outcome(p.tenant, "rejected_unavailable").inc()
            p.ctx.annotate(retry_after_ms=round(retry_ms, 3),
                           breaker=self.breaker.state)
            self._seal(p.ctx, "rejected_unavailable",
                       (self._clock() - p.enqueued) * 1e3)
            self._try_fail(p.future, Rejected(
                "unavailable", retry_ms, p.tenant, trace_id=p.ctx.trace_id))

    def _fail_batch(self, bctx: TraceContext, live, width: int,
                    e: BaseException, level: int) -> None:
        """A coalesced dispatch raised.  One malformed query must not fail
        its healthy riders: with >1 live query each one is retried as its
        own single-row dispatch (same padded shape), and only the
        queries that still fail get the exception.
        The breaker records a device failure only when nothing could be
        served singly (a poisoned query is not a broken device)."""
        err = repr(e)
        bctx.finish("error", error=err)
        recovered = 0
        for i, p in enumerate(live):
            if p.future.done():
                continue
            out = exc = None
            if len(live) > 1:
                sctx = TraceContext(tenant="batch", trace_id=new_batch_id())
                try:
                    qi, qv = _pad_batch([p], width, self.max_batch)
                    res = self._server_query(qi, qv, sctx, level)
                    sctx.finish("ok")
                    out = res.row(0, k=p.k, trace_id=p.ctx.trace_id)
                except Exception as se:                  # noqa: BLE001
                    sctx.finish("error", error=repr(se))
                    exc = se
            else:
                exc = e
            for name, _start, dur in bctx.stages:
                p.ctx.add_stage(name, dur)
            lat_ms = (self._clock() - p.enqueued) * 1e3
            if out is not None:
                recovered += 1
                self._m_outcome(p.tenant, "ok").inc()
                p.ctx.annotate(batch_id=bctx.trace_id, retried_single=True)
                retained = self._seal(p.ctx, "ok", lat_ms)
                self._m_latency(p.tenant).observe(
                    lat_ms, exemplar=p.ctx.trace_id if retained else None)
                try:
                    p.future.set_result(out)
                except InvalidStateError:
                    pass
            else:
                self._m_outcome(p.tenant, "error").inc()
                self._seal(p.ctx, "error", lat_ms, error=repr(exc))
                self._try_fail(p.future, exc)
        if recovered:
            self.breaker.record_success()
        else:
            self.breaker.record_failure()
        self._record_batch(bctx, live, width)

    # -- housekeeping: watchdog + degradation ladder -------------------------
    def _housekeeping(self):
        """Sidecar thread: the dispatcher blocks inside ``query_many``
        during a device stall, so the watchdog and the ladder tick must
        live on their own thread.  The body is exception-guarded: a bug in
        the SLO signal or a metrics call must not silently kill the
        watchdog and the ladder, so failures are counted and the loop
        keeps running."""
        last_tick = self._clock()
        while not self._hk_stop.wait(0.05):
            try:
                now = self._clock()
                if self.watchdog_timeout_s is not None:
                    inflight = self._inflight
                    if inflight is not None:
                        t0, _live = inflight
                        if now - t0 > self.watchdog_timeout_s:
                            self._trip_watchdog(inflight, (now - t0) * 1e3)
                if self.degrade.config.enabled \
                        and now - last_tick >= self._degrade_tick_s:
                    last_tick = now
                    burn = (self.slo.fast_burn() if self.slo is not None
                            else 0.0)
                    self.degrade.tick(
                        burn=burn,
                        queue_frac=len(self._queue) / self.queue_depth)
            except Exception:                            # noqa: BLE001
                self.registry.counter(
                    "repro_frontend_housekeeping_errors_total",
                    "Exceptions swallowed by the housekeeping loop "
                    "(watchdog + degradation ladder kept alive).").inc()

    def _trip_watchdog(self, inflight, stalled_ms: float) -> None:
        """Fail a stuck dispatch's futures with 504 instead of hanging the
        clients; the dispatcher thread is still blocked on the device and
        will skip every already-done future when (if) it returns.
        Compare-and-clear on the exact snapshot: if the stalled dispatch
        returned (and the dispatcher possibly started the next one)
        between the housekeeping check and this call, the trip is a no-op
        instead of 504'ing a healthy dispatch and mis-recording a breaker
        failure for one that completed."""
        _t0, live = inflight
        with self._inflight_lock:
            if self._inflight is not inflight:
                return              # the stalled dispatch already returned
            self._inflight = None   # fire at most once per dispatch
        self.registry.counter(
            "repro_frontend_watchdog_trips_total",
            "Stuck-device watchdog activations (in-flight futures 504'd)."
        ).inc()
        self.breaker.record_failure()
        timeout_ms = self.watchdog_timeout_s * 1e3
        for p in live:
            if p.future.done():
                continue
            exc = DeviceStuck(stalled_ms, timeout_ms,
                              trace_id=p.ctx.trace_id)
            if self._try_fail(p.future, exc):
                self._m_outcome(p.tenant, "stuck").inc()
                self._seal(p.ctx, "stuck",
                           (self._clock() - p.enqueued) * 1e3,
                           error=f"device stuck > {timeout_ms:.0f} ms")

    def _record_batch(self, bctx: TraceContext, live, width: int) -> None:
        """Retain one coalesced-dispatch record in the recorder's batch
        ring (`/debug/batches`, `/debug/trace/<batch_id>`)."""
        rec = self._recorder()
        if rec is None:
            return
        pad_frac = 1.0 - (sum(p.q_idx.shape[0] for p in live)
                          / float(self.max_batch * width))
        bctx.annotate(batch_id=bctx.trace_id, size=len(live),
                      width_bucket=width,
                      padding_fraction=round(pad_frac, 4),
                      trace_ids=[p.ctx.trace_id for p in live])
        rec.record_batch(bctx.to_dict())

    # -- lifecycle -----------------------------------------------------------
    def close(self, drain: bool = True) -> None:
        """Stop the dispatcher.  With ``drain`` (default) queued requests
        are served first; otherwise their futures fail with `Rejected`."""
        with self._cv:
            self._closed = True
            if not drain:
                now = self._clock()
                while self._queue:
                    p = self._queue.popleft()
                    self._m_outcome(p.tenant, "rejected_shutdown").inc()
                    p.ctx.add_stage("queue", (now - p.enqueued) * 1e3)
                    self._seal(p.ctx, "rejected_shutdown",
                               (now - p.enqueued) * 1e3)
                    p.future.set_exception(
                        Rejected("shutdown", 0.0, p.tenant,
                                 trace_id=p.ctx.trace_id))
                self._m_depth.set(0)
            self._cv.notify_all()
        self._hk_stop.set()
        self._dispatcher.join(timeout=30)
        self._housekeeper.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False


# ---------------------------------------------------------------------------
# HTTP/JSON front door
# ---------------------------------------------------------------------------

class FrontendServer:
    """Stdlib HTTP/JSON front door over a :class:`ServingFrontend`.

    Endpoints:

    * ``POST /v1/query`` — body ``{"indices": [...], "values": [...]}`` plus
      optional ``"k"``, ``"tenant"``, ``"deadline_ms"``; responds 200 with
      ``{"ids", "scores", "k", "backend", "trace_id", "degraded"}``
      (``degraded`` true when the answer was served under the degradation
      ladder), 429 + ``Retry-After`` on admission rejection (reasons:
      throttled, queue_full, unavailable — breaker open, shed — ladder
      L3), 504 on in-queue deadline expiry or a watchdog-detected stuck
      device, 400 on malformed input.
    * the standard observability endpoints (``/metrics``,
      ``/metrics.json``, ``/healthz``, ``/readyz``) plus any ``/debug/*``
      surfaces, mounted from ``repro_torch.obs.server`` — one port serves both
      queries and scrapes.  ``/readyz`` defaults to two live checks:
      the dispatcher thread is alive, and the admission queue is below 90%
      of its depth (saturated = not ready, so load balancers stop sending
      before clients start seeing 429s); pass ``ready=`` to extend or
      replace them.

    Handlers block in ``frontend.query`` (each connection gets a thread via
    ``ThreadingHTTPServer``), so concurrent clients coalesce into fused
    batches exactly like in-process callers.  Rejection (429) and deadline
    (504) bodies carry the request's ``trace_id``, which resolves at
    ``/debug/trace/<id>`` whenever a flight recorder is mounted.
    """

    def __init__(self, frontend: ServingFrontend, host: str = "127.0.0.1",
                 port: int = 0, registry=None, *, ready=None, recorder=None,
                 slo=None, profile_dir=None):
        self.frontend = frontend
        self.host = host
        self.port = int(port)
        self.registry = (frontend.registry if registry is None else registry)
        if ready is None:
            ready = obs_server.ReadyState()
            ready.add_check("dispatcher", self._check_dispatcher)
            ready.add_check("admission_queue", self._check_queue)
        self.ready = ready
        self.recorder = recorder
        self.slo = slo
        self.profile_dir = profile_dir
        self._httpd = None
        self._thread = None

    def _check_dispatcher(self):
        alive = self.frontend._dispatcher.is_alive()
        return alive, "" if alive else "dispatcher thread is not running"

    def _check_queue(self):
        depth = len(self.frontend._queue)
        limit = 0.9 * self.frontend.queue_depth
        ok = depth < limit
        return ok, "" if ok else (f"admission queue saturated: "
                                  f"{depth}/{self.frontend.queue_depth}")

    def start(self) -> "FrontendServer":
        frontend = self.frontend
        recorder = self.recorder if self.recorder is not None \
            else frontend._recorder()
        get_endpoints = obs_server.build_endpoints(
            self.registry, ready=self.ready, recorder=recorder,
            slo=self.slo, profile_dir=self.profile_dir)

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, code: int, body: bytes, ctype: str,
                       headers=()):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _reply_json(self, code: int, doc: dict, headers=()):
                self._reply(code, json.dumps(doc).encode("utf-8"),
                            "application/json", headers)

            def do_GET(self):  # noqa: N802 - http.server API
                routed = obs_server.dispatch(get_endpoints, self.path)
                if routed is None:
                    self.send_error(404)
                    return
                status, body, ctype = routed
                self._reply(status, body, ctype)

            def do_POST(self):  # noqa: N802 - http.server API
                if self.path != "/v1/query":
                    self.send_error(404)
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    doc = json.loads(self.rfile.read(length))
                    q_idx = np.asarray(doc["indices"], np.int32)
                    q_val = np.asarray(doc["values"], np.float32)
                    if q_idx.ndim != 1 or q_idx.shape != q_val.shape:
                        raise ValueError("indices/values must be equal-"
                                         "length 1-d arrays")
                    tenant = str(doc.get("tenant", "default"))
                    deadline_ms = doc.get("deadline_ms")
                    k = doc.get("k")
                except (KeyError, TypeError, ValueError,
                        json.JSONDecodeError) as e:
                    self._reply_json(400, {"error": "bad_request",
                                           "detail": str(e)})
                    return
                try:
                    res = frontend.query(q_idx, q_val, tenant=tenant,
                                         deadline_ms=deadline_ms, k=k)
                except Rejected as e:
                    self._reply_json(
                        429, {"error": "rejected", "reason": e.reason,
                              "retry_after_ms": e.retry_after_ms,
                              "trace_id": e.trace_id},
                        headers=[("Retry-After",
                                  str(max(1, math.ceil(e.retry_after_ms
                                                       / 1e3))))])
                    return
                except DeadlineExceeded as e:
                    self._reply_json(504, {"error": "deadline_exceeded",
                                           "queued_ms": round(e.queued_ms, 3),
                                           "deadline_ms": e.deadline_ms,
                                           "trace_id": e.trace_id})
                    return
                self._reply_json(200, {
                    "ids": [int(i) for i in res.ids],
                    "scores": [float(s) for s in res.scores],
                    "k": res.k, "backend": res.backend,
                    "trace_id": res.trace_id,
                    "degraded": bool(getattr(res, "degraded", False))})

            def log_message(self, fmt, *args):
                pass    # request logging belongs to metrics, not stderr

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="frontend-http", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def __enter__(self):
        if self._httpd is None:
            self.start()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        return False
