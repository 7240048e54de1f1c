"""Online inference gateway: continuous batching over warm bucket shapes.

The port's copy of :mod:`tensorflowonspark_tpu.gateway`; the copy is the
port's own.  It batches for the port's :class:`serving.ModelServer`, whose
warmup loads or compiles every rung's AOTInductor package under a warm
cache (eagerly dispatched rungs without one), and its beats carry the
compile plane's counters.
The batcher thread is the one thread that runs the model: the kernel
wrappers take the current stream of ``torch.cuda.device(tensor.device)``,
``predict_feed`` enters ``torch.inference_mode`` on that thread, and a
parked weight swap is copied in between two dispatches.

The serving tier, built from parts the training side already proved:

* **continuous/dynamic batcher** — concurrent requests coalesce into one
  padded-bucket batch under a latency budget (``max_batch`` rows or
  ``max_wait_ms`` since the oldest queued request, whichever first).  The
  batch pads up to the :func:`serving.bucket_ladder` rung, and
  :meth:`ModelServer.warmup` dispatches every rung at load time, so no
  request is the first on its rung (``serving_compiles`` stays flat under
  load — the ``train_compile_us`` convention).
* **admission control** — a *bounded* queue.  At ``max_queue`` pending
  requests new arrivals are shed immediately with a typed
  :class:`OverloadError` (code ``overload``); a request whose deadline
  expires while queued is shed before dispatch (code ``deadline``).
  Backpressure is an error the client can act on, never an unbounded
  queue.
* **shared transport** — request/response batches ride the same
  length-prefixed colv1 frames as training chunks
  (:mod:`tensorflowonspark_torch.transport`), codec negotiation included.
* **replica failover for free** — each gateway registers in the
  reservation roster (``job_name="serving"``) and beats its serving
  counters over the heartbeat channel.  A killed replica is fenced by the
  liveness monitor exactly like a dead trainer; the HA
  :class:`ServingClient` retries in-flight requests on a surviving
  replica.

Wire protocol (after the transport hello/hello_ok codec handshake, which
also advertises ``max_batch`` and the bucket ladder)::

    -> {"type": "predict", "id": n, "count": C, "tensors": [names...],
        "deadline_ms": optional budget}
    -> one colv1/pickle frame: the input columns in ``tensors`` order
    <- {"type": "result", "id": n, "count": C, "outputs": [names...]}
    <- one colv1/pickle frame: the output columns in ``outputs`` order
  or
    <- {"type": "error", "id": n, "code": "overload"|"deadline"|...,
        "message": str}

Metrics exported per beat (observatory renders ``_hwm``/``_max`` keys as
gauges, everything else as ``_total`` counters): ``serving_requests``,
``serving_rows``, ``serving_batches``, ``serving_shed`` (plus the
``serving_shed_<reason>`` split), ``serving_compiles``,
``serving_p50_us_max``, ``serving_p99_us_max``, ``serving_queue_depth_hwm``,
``serving_batch_fill_pct_max``.

Request-plane observability: every request carries a client-minted
request id + telemetry flow id (``serving/request_flow``, riding the
transport's ``K_TRACED`` header) so one slow request renders as a single
cross-pid Perfetto arrow, and the gateway stamps each stage on a monotonic
clock — ``queue_us`` (admission -> batch collection), ``coalesce_us``
(collection -> dispatch start), ``dispatch_us`` (``predict_feed``),
``serialize_us`` (slice + response write).  The four stage histograms plus
the end-to-end ``serving_latency_us`` family ride heartbeats in the
``STEP_MS_BUCKETS`` flat-counter convention, the worst requests are kept as
exemplars (``slow_requests()``, the observatory's ``GET /slow``), and every
completed-or-shed request is classified against ``slo_latency_us`` into the
``serving_slo_good``/``serving_slo_total`` counters that feed watchtower's
``slo_budget_burn`` multi-window budget math.
"""

import collections
import heapq
import logging
import socket
import threading
import time

import numpy as np

from tensorflowonspark_torch import fault
from tensorflowonspark_torch import metrics as metrics_mod
from tensorflowonspark_torch import telemetry
from tensorflowonspark_torch import transport
from tensorflowonspark_torch.transport import Transport, TransportError

logger = logging.getLogger(__name__)

#: Latency samples kept for the p50/p99 window (enough for several beat
#: intervals at saturation without unbounded growth).
_LAT_WINDOW = 4096

#: Worst-request exemplars kept in the bounded ring…
_SLOW_RING = 32
#: …and how many of those ride each heartbeat (the driver latch and /slow
#: see the union across beats, so a small per-beat top-K is enough).
_SLOW_BEAT = 8

#: Typed shed reasons, also the ``reason=`` label set of
#: ``tfos_serving_shed_total`` (emitted as zeros so scrapers see the full
#: label space before the first shed).
#: ``unknown_model`` / ``no_capacity`` are shed by the fleet router
#: (``fleet.FleetRouter``), not the gateway itself; they live in this
#: vocabulary so the label space is one set fleet-wide.
SHED_REASONS = ("overload", "deadline", "shutdown", "internal",
                "unknown_model", "no_capacity")


class _Hist(object):
    """Flat-counter latency histogram over microsecond bucket edges.

    Same convention as the Trainer's ``step_ms_le_<bound>`` counters:
    :meth:`flat` emits *cumulative* ``<prefix>_le_<bound>`` keys plus
    ``_count``/``_sum_us``, which heartbeat latching, ``merge_counters``,
    and the observatory's ``_render_histogram`` already know how to carry.
    Callers hold the gateway's metrics lock around ``observe``.
    """

    __slots__ = ("buckets", "counts", "count", "sum_us")

    def __init__(self, buckets=metrics_mod.SERVING_US_BUCKETS):
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.count = 0
        self.sum_us = 0

    def observe(self, us):
        self.count += 1
        self.sum_us += int(round(us))
        for i, bound in enumerate(self.buckets):
            if us <= bound:
                self.counts[i] += 1
                return
        # above the last edge: counted only in _count (the +Inf bucket)

    def flat(self, prefix, out):
        """Emit the flat-counter keys into ``out`` (skipped while empty so
        idle replicas don't widen every heartbeat)."""
        if not self.count:
            return
        running = 0
        for bound, n in zip(self.buckets, self.counts):
            running += n
            out["{}_le_{}".format(prefix, bound)] = running
        out[prefix + "_count"] = self.count
        out[prefix + "_sum_us"] = self.sum_us


class OverloadError(RuntimeError):
    """A request was shed by admission control.

    ``code`` says why: ``"overload"`` (bounded queue full on arrival),
    ``"deadline"`` (the request's budget expired before dispatch), or
    ``"shutdown"`` (the gateway is draining).  Typed so clients can back
    off / retry elsewhere instead of pattern-matching strings.
    """

    def __init__(self, code, message):
        super(OverloadError, self).__init__(message)
        self.code = code


class _Request(object):
    """One queued prediction: feed columns plus completion callbacks."""

    __slots__ = ("feed", "count", "deadline", "arrival", "t_collect",
                 "req_id", "flow", "on_result", "on_error")

    def __init__(self, feed, count, deadline, on_result, on_error,
                 req_id=None, flow=0):
        self.feed = feed
        self.count = count
        self.deadline = deadline          # monotonic seconds, or None
        self.arrival = time.monotonic()
        self.t_collect = None             # stamped when batched (queue end)
        self.req_id = req_id              # client-minted request id string
        self.flow = flow                  # serving/request_flow id, 0 = none
        self.on_result = on_result        # fn(outputs: {name: rows-slice})
        self.on_error = on_error          # fn(code, message)


class GatewayServer(object):
    """One serving replica: TCP front, continuous batcher, roster member.

    ``server`` is a loaded :class:`serving.ModelServer`; the gateway
    dispatches coalesced batches through ``server.predict_feed`` so padding
    and bucket reuse live in exactly one place.  Pass ``roster_addr`` (the
    reservation server) to join a replica fleet — registration metadata
    carries this gateway's ``host:port`` so clients can discover it, and
    heartbeats carry the serving counters into the observatory.
    """

    def __init__(self, server, host="127.0.0.1", port=0, max_batch=None,
                 max_wait_ms=5.0, max_queue=None, roster_addr=None,
                 replica_id=None, task_index=0, heartbeat_interval=1.0,
                 warmup=True, slo_latency_us=0.0, model_version=None):
        self.server = server
        self.host = host
        self.port = port
        self.max_batch = min(max_batch or server.batch_size,
                             server.batch_size)
        self.max_wait = max_wait_ms / 1000.0
        # 4 batches of headroom by default: deep enough to ride a dispatch,
        # shallow enough that shed latency stays bounded by ~4 batch times.
        self.max_queue = max_queue or 4 * self.max_batch
        self.roster_addr = roster_addr
        self.replica_id = replica_id or "serving-{}".format(task_index)
        self.task_index = task_index
        self.heartbeat_interval = heartbeat_interval
        self._warmup = warmup
        # SLO classification threshold: a completed request is "good" when
        # its end-to-end latency is <= this many microseconds (0 disarms
        # the latency leg: every completed request is good, only sheds
        # burn budget).  Shed requests always count against the budget.
        self.slo_latency_us = float(slo_latency_us or 0.0)
        # model/version dimension: rides heartbeats as string keys
        # (merge_counters drops them from aggregates; the latch keeps them
        # per-node) and the roster registration meta, which is how the
        # fleet router (fleet.FleetRouter) maps replicas to versions.
        desc = getattr(server, "descriptor", None) or {}
        self.model = str(desc.get("model_name") or "default")
        self.model_version = str(model_version
                                 or desc.get("model_version") or "0")
        # live version swap (fleet canary plane): the serving_load_version
        # knob parks the swap here; the batcher applies it BETWEEN
        # dispatches so in-flight batches drain on the old weights.
        self._pending_swap = None
        self._swap_token = None

        self._queue = collections.deque()
        self._cond = threading.Condition()
        self._stopped = False
        self._listener = None
        self._threads = []
        self._conns = set()
        self._hb = None
        self._fault = fault.from_env()

        # counters (cumulative; heartbeat latch is latest-value-per-key)
        self.requests_total = 0
        self.rows_total = 0
        self.batches_total = 0
        self.shed_total = 0
        self.shed_by_reason = {reason: 0 for reason in SHED_REASONS}
        self.slo_good_total = 0
        self.slo_total = 0
        self.swaps_total = 0        # completed live version swaps
        self.swap_failed_total = 0  # refused/failed swap attempts
        # rows whose outputs carried NaN/Inf — the version-labeled signal
        # the canary controller rolls back on
        self.nonfinite_total = 0
        self._lat_us = collections.deque(maxlen=_LAT_WINDOW)
        self._stage_hists = {
            "serving_queue_us": _Hist(),
            "serving_coalesce_us": _Hist(),
            "serving_dispatch_us": _Hist(),
            "serving_serialize_us": _Hist(),
            "serving_latency_us": _Hist(),
        }
        self._slow = []       # min-heap of (latency_us, seq, exemplar dict)
        self._slow_seq = 0
        self._req_seq = 0     # fallback ids for untagged/in-process entries
        self._queue_depth_hwm = 0
        self._batch_fill_pct = 0.0
        self._metrics_lock = threading.Lock()

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        """Warm the bucket ladder, bind, start batcher/acceptor threads,
        and (with ``roster_addr``) register + beat.  Returns
        ``(host, port)``."""
        if self._warmup:
            warmed = self.server.warmup()
            report = getattr(self.server, "warmup_report", None) or {}
            logger.info("gateway %s: %d bucket(s) warm (ladder %s, "
                        "%d loaded / %d compiled)",
                        self.replica_id, warmed, self.server.buckets,
                        report.get("loaded", 0), report.get("compiled", 0))
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self.host, self.port))
        self._listener.listen(128)
        self.port = self._listener.getsockname()[1]

        batcher = threading.Thread(target=self._batch_loop,
                                   name="gateway-batcher", daemon=True)
        acceptor = threading.Thread(target=self._accept_loop,
                                    name="gateway-accept", daemon=True)
        self._threads = [batcher, acceptor]
        batcher.start()
        acceptor.start()

        if self.roster_addr:
            from tensorflowonspark_torch import reservation

            addr = transport.addr_tuple(self.roster_addr)
            client = reservation.Client(addr)
            reg = {
                "executor_id": self.replica_id,
                "host": self.host,
                "port": self.port,
                "addr": "{}:{}".format(self.host, self.port),
                "job_name": "serving",
                "task_index": self.task_index,
                # fleet routing meta: the router maps (model, version) ->
                # replica set off these fields (fleet.FleetRouter.sync_roster)
                "model": self.model,
                "model_version": self.model_version,
            }
            # Per-rung load-vs-compile verdicts travel on the roster
            # registration, so the driver can place them in tf_status
            # without a second channel.
            if getattr(self.server, "warmup_report", None):
                reg["warmup"] = self.server.warmup_report
            try:
                client.register(reg)
            finally:
                client.close()
            self._hb = reservation.HeartbeatSender(
                addr, self.replica_id, self.heartbeat_interval,
                metrics_provider=self.heartbeat_metrics,
                on_reply=self._on_beat_reply).start()
        logger.info("gateway %s serving on %s:%d (max_batch=%d, "
                    "max_wait=%.1fms, max_queue=%d)", self.replica_id,
                    self.host, self.port, self.max_batch,
                    self.max_wait * 1e3, self.max_queue)
        return (self.host, self.port)

    def stop(self, goodbye=True):
        """Drain: stop accepting, shed the queue with code ``shutdown``,
        deregister from the roster."""
        with self._cond:
            self._stopped = True
            pending = list(self._queue)
            self._queue.clear()
            self._cond.notify_all()
        if pending:
            self._count_shed("shutdown", len(pending))
        for req in pending:
            self._safe_error(req, "shutdown", "gateway stopping")
        if self._hb is not None:
            self._hb.stop(goodbye=goodbye, reason="done")
            self._hb = None
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        for conn in list(self._conns):
            try:
                conn.close()
            except OSError:
                pass

    # -- admission + batching ----------------------------------------------

    def submit(self, feed, count, deadline_ms=None):
        """In-process entry: enqueue one request and block for its result.
        Raises :class:`OverloadError` when shed.  ``feed`` is
        ``{tensor: array}`` with ``count`` leading rows."""
        done = threading.Event()
        box = {}

        def on_result(outputs):
            box["out"] = outputs
            done.set()

        def on_error(code, message):
            box["err"] = OverloadError(code, message)
            done.set()

        self._enqueue(feed, count, deadline_ms, on_result, on_error)
        done.wait()
        if "err" in box:
            raise box["err"]
        return box["out"]

    def _count_shed(self, reason, n=1):
        """One shed accounting point for every admission-control exit:
        the total, the by-reason split, and the SLO budget (a shed request
        is never a good request)."""
        with self._metrics_lock:
            self.shed_total += n
            self.shed_by_reason[reason] = \
                self.shed_by_reason.get(reason, 0) + n
            self.slo_total += n

    def _enqueue(self, feed, count, deadline_ms, on_result, on_error,
                 req_id=None, flow=0):
        deadline = None
        if deadline_ms is not None:
            deadline = time.monotonic() + deadline_ms / 1000.0
        req = _Request(feed, count, deadline, on_result, on_error,
                       req_id=req_id, flow=flow)
        with self._cond:
            if self._stopped:
                shed = ("shutdown", "gateway stopping")
            elif len(self._queue) >= self.max_queue:
                shed = ("overload",
                        "queue full ({} pending, max_queue={})".format(
                            len(self._queue), self.max_queue))
            else:
                shed = None
                if req.req_id is None:
                    self._req_seq += 1
                    req.req_id = "{}-local-{}".format(self.replica_id,
                                                      self._req_seq)
                self._queue.append(req)
                depth = len(self._queue)
                if depth > self._queue_depth_hwm:
                    self._queue_depth_hwm = depth
                self._cond.notify()
        if shed is not None:
            self._count_shed(shed[0])
            if req.flow:
                telemetry.get_tracer().flow_step(
                    telemetry.SERVING_REQUEST_FLOW, req.flow,
                    stage="shed", reason=shed[0], req=req.req_id)
            self._safe_error(req, *shed)
        elif req.flow:
            telemetry.get_tracer().flow_step(
                telemetry.SERVING_REQUEST_FLOW, req.flow,
                stage="admit", req=req.req_id, rows=int(req.count))

    def _batch_loop(self):
        """Continuous batcher: wait for the first request, then coalesce
        arrivals until the batch is full or the oldest request has waited
        ``max_wait``; expired requests are shed *before* dispatch."""
        while True:
            batch = self._collect_batch()
            if batch is None:
                return  # stopped
            if self._pending_swap is not None:
                # apply the parked version swap between dispatches: the
                # batch just collected (and everything before it) drained
                # on the old weights; this batch runs on the new ones
                self._apply_swap()
            if batch:
                try:
                    self._dispatch(batch)
                except Exception as e:  # defensive: batcher must survive
                    logger.exception("gateway batch dispatch failed")
                    self._count_shed("internal", len(batch))
                    for req in batch:
                        self._safe_error(req, "internal", repr(e))

    def _collect_batch(self):
        expired = []
        try:
            with self._cond:
                while not self._queue and not self._stopped:
                    if self._pending_swap is not None:
                        return []  # idle replica: let the batcher swap now
                    self._cond.wait(timeout=0.1)
                if self._stopped:
                    return None
                flush_at = self._queue[0].arrival + self.max_wait
                batch, rows = [], 0
                while True:
                    while self._queue:
                        req = self._queue[0]
                        if rows and rows + req.count > self.max_batch:
                            return batch  # carry overflow to the next batch
                        self._queue.popleft()
                        if (req.deadline is not None
                                and time.monotonic() > req.deadline):
                            expired.append(req)
                            continue
                        req.t_collect = time.monotonic()  # queue stage ends
                        batch.append(req)
                        rows += req.count
                        if rows >= self.max_batch:
                            return batch
                    remaining = flush_at - time.monotonic()
                    if remaining <= 0 or self._stopped:
                        return batch
                    self._cond.wait(timeout=remaining)
        finally:
            # shed callbacks write to client sockets: never under the lock
            if expired:
                self._count_shed("deadline", len(expired))
                for req in expired:
                    self._safe_error(
                        req, "deadline",
                        "deadline expired after {:.1f}ms in queue".format(
                            (time.monotonic() - req.arrival) * 1e3))

    def _apply_swap(self):
        """Apply the parked ``serving_load_version`` swap (batcher thread
        only — the single-dispatcher contract ``ModelServer.swap_export``
        documents).  Failures are counted and logged, never fatal: a bad
        export must not take a serving replica down."""
        swap, self._pending_swap = self._pending_swap, None
        if not swap:
            return
        try:
            version = self.server.swap_export(
                swap["export_dir"], expected_version=swap.get("version"))
        except Exception as e:
            with self._metrics_lock:
                self.swap_failed_total += 1
            logger.warning("gateway %s: version swap to %s refused: %s",
                           self.replica_id, swap.get("version"), e)
            return
        with self._metrics_lock:
            self.model_version = str(version)
            self.swaps_total += 1
        telemetry.get_tracer().instant(
            "serving/version_swap", model=self.model, version=version,
            token=swap.get("token"))
        logger.info("gateway %s: now serving %s@%s (swap token %s)",
                    self.replica_id, self.model, version, swap.get("token"))

    def _dispatch(self, batch):
        tracer = telemetry.get_tracer()
        total = sum(r.count for r in batch)
        if len(batch) == 1:
            feed = batch[0].feed
        else:
            keys = batch[0].feed.keys()
            feed = {k: np.concatenate([r.feed[k] for r in batch])
                    for k in keys}
        # stage boundaries on one monotonic clock: [arrival, t_collect) is
        # queue wait, [t_collect, t_d0) coalescing (incl. the concat above),
        # [t_d0, t_d1) model dispatch, [t_d1, done_i) serialize — the four
        # always sum exactly to the request's end-to-end latency.
        t_d0 = time.monotonic()
        # injected model slowness lands inside [t_d0, t_d1): it must show
        # up as DISPATCH latency in the decomposition, like a real slow
        # predict would
        self._fault.on_predict(rows=total, batch=self.batches_total)
        for req in batch:
            if req.flow:
                tracer.flow_step(telemetry.SERVING_REQUEST_FLOW, req.flow,
                                 stage="dispatch", req=req.req_id,
                                 batch_rows=int(total))
        with tracer.span("serving/dispatch", rows=int(total),
                         requests=len(batch)):
            outputs = self.server.predict_feed(feed, total)
        t_d1 = time.monotonic()
        # nonfinite output scan: one vectorized pass per batch.  NaN/Inf
        # rows are the version-labeled poison signal the watchtower's
        # nonfinite rule and the fleet's canary rollback key on (bad
        # weights pass param validation when finite but overflow in the
        # matmul — only the outputs betray them).
        bad_rows = 0
        for v in outputs.values():
            arr = np.asarray(v)
            if arr.dtype.kind != "f":
                continue
            finite = np.isfinite(arr)
            if not finite.all():
                flat = finite.reshape(arr.shape[0], -1).all(axis=1)
                bad_rows = max(bad_rows, int((~flat).sum()))
        if bad_rows:
            with self._metrics_lock:
                self.nonfinite_total += bad_rows
            tracer.instant("serving/nonfinite_output", rows=int(bad_rows),
                           model=self.model, version=self.model_version)
        from tensorflowonspark_torch.serving import bucket_for

        fill = 100.0 * total / bucket_for(total, self.server.buckets)
        with self._metrics_lock:
            self.batches_total += 1
            self.requests_total += len(batch)
            self.rows_total += total
            self._batch_fill_pct = fill
        lo = 0
        for req in batch:
            hi = lo + req.count
            sliced = {k: v[lo:hi] for k, v in outputs.items()}
            lo = hi
            try:
                req.on_result(sliced)
            except Exception:
                logger.debug("result callback failed (client gone?)",
                             exc_info=True)
            done = time.monotonic()
            self._account_request(req, total, t_d0, t_d1, done)
            if req.flow:
                tracer.flow_step(
                    telemetry.SERVING_REQUEST_FLOW, req.flow,
                    stage="serialize", req=req.req_id,
                    e2e_us=int((done - req.arrival) * 1e6))

    def _account_request(self, req, batch_rows, t_d0, t_d1, done):
        """Per-request latency decomposition at completion: stage + e2e
        histograms, the SLO classification, and the slow-exemplar ring."""
        queue_us = (req.t_collect - req.arrival) * 1e6
        coalesce_us = (t_d0 - req.t_collect) * 1e6
        dispatch_us = (t_d1 - t_d0) * 1e6
        serialize_us = (done - t_d1) * 1e6
        e2e_us = (done - req.arrival) * 1e6
        with self._metrics_lock:
            self._lat_us.append(e2e_us)
            hists = self._stage_hists
            hists["serving_queue_us"].observe(queue_us)
            hists["serving_coalesce_us"].observe(coalesce_us)
            hists["serving_dispatch_us"].observe(dispatch_us)
            hists["serving_serialize_us"].observe(serialize_us)
            hists["serving_latency_us"].observe(e2e_us)
            self.slo_total += 1
            if self.slo_latency_us <= 0 or e2e_us <= self.slo_latency_us:
                self.slo_good_total += 1
            if (len(self._slow) < _SLOW_RING
                    or e2e_us > self._slow[0][0]):
                exemplar = {
                    "req": req.req_id,
                    "flow": int(req.flow or 0),
                    "time": round(time.time(), 3),
                    "latency_us": int(round(e2e_us)),
                    "queue_us": int(round(queue_us)),
                    "coalesce_us": int(round(coalesce_us)),
                    "dispatch_us": int(round(dispatch_us)),
                    "serialize_us": int(round(serialize_us)),
                    "rows": int(req.count),
                    "batch_rows": int(batch_rows),
                    "model": self.model,
                    "version": self.model_version,
                }
                item = (e2e_us, self._slow_seq, exemplar)
                self._slow_seq += 1
                if len(self._slow) < _SLOW_RING:
                    heapq.heappush(self._slow, item)
                else:
                    heapq.heapreplace(self._slow, item)

    def slow_requests(self, limit=None):
        """The worst-latency exemplars seen so far (bounded ring of
        :data:`_SLOW_RING`), slowest first — each a dict with the request
        id, flow id, and the full stage breakdown."""
        with self._metrics_lock:
            worst = sorted(self._slow, reverse=True)
        recs = [dict(rec) for _, _, rec in worst]
        return recs[:limit] if limit else recs

    @staticmethod
    def _safe_error(req, code, message):
        try:
            req.on_error(code, message)
        except Exception:
            logger.debug("error callback failed (client gone?)",
                         exc_info=True)

    # -- live knobs ---------------------------------------------------------

    def _on_beat_reply(self, reply):
        """Roster-beat reply hook: apply any live serving knob the driver
        piggybacked (autopilot pushes via the reservation server's
        KnobCoordinator — gateways beat there like any other node).  Both
        targets are re-read fresh every ``_collect_batch`` iteration, so a
        plain attribute store takes effect on the very next batch."""
        knobs = reply.get("knobs") if isinstance(reply, dict) else None
        if not knobs:
            return
        wait_ms = knobs.get("serving_max_wait_ms")
        if wait_ms is not None:
            try:
                self.max_wait = max(float(wait_ms), 0.0) / 1000.0
                logger.info("gateway %s: max_wait retuned to %.2fms",
                            self.replica_id, self.max_wait * 1e3)
            except (TypeError, ValueError):
                logger.warning("gateway %s: bad serving_max_wait_ms %r",
                               self.replica_id, wait_ms)
        batch = knobs.get("serving_max_batch")
        if batch is not None:
            try:
                # the compiled bucket ladder tops out at batch_size: a
                # bigger batch would recompile on the hot path
                self.max_batch = min(max(int(batch), 1),
                                     self.server.batch_size)
                logger.info("gateway %s: max_batch retuned to %d",
                            self.replica_id, self.max_batch)
            except (TypeError, ValueError):
                logger.warning("gateway %s: bad serving_max_batch %r",
                               self.replica_id, batch)
        swap = knobs.get("serving_load_version")
        if isinstance(swap, dict) and swap.get("export_dir"):
            # fleet live swap: park it for the batcher (it applies between
            # dispatches), dedup'd by token — knob replies repeat until the
            # coordinator's knob map changes
            token = swap.get("token") or "{}@{}".format(
                swap.get("model"), swap.get("version"))
            if token != self._swap_token:
                self._swap_token = token
                if str(swap.get("model") or self.model) != self.model:
                    with self._metrics_lock:
                        self.swap_failed_total += 1
                    logger.warning(
                        "gateway %s: serving_load_version for model %r "
                        "ignored (this replica serves %r)",
                        self.replica_id, swap.get("model"), self.model)
                else:
                    self._pending_swap = dict(swap)
                    logger.info("gateway %s: version swap to %s@%s parked",
                                self.replica_id, self.model,
                                swap.get("version"))
        with self._cond:
            self._cond.notify_all()  # a waiting batcher re-reads both

    # -- metrics ------------------------------------------------------------

    def heartbeat_metrics(self):
        """Flat counter/gauge dict piggybacked on each roster beat (and
        polled directly by the bench leg).  Key suffixes follow the
        observatory contract: ``_hwm``/``_max`` render as gauges, the rest
        as monotonic counters."""
        with self._metrics_lock:
            lat = sorted(self._lat_us)
            depth_hwm = self._queue_depth_hwm
            out = {
                "serving_requests": self.requests_total,
                "serving_rows": self.rows_total,
                "serving_batches": self.batches_total,
                "serving_shed": self.shed_total,
                "serving_compiles": self.server.compile_count,
                "serving_queue_depth_hwm": depth_hwm,
                "serving_batch_fill_pct_max": round(self._batch_fill_pct, 2),
                # gauges: the CURRENT batching knobs, so the driver can
                # confirm a live autopilot retune landed
                "serving_max_wait_ms_max": round(self.max_wait * 1e3, 3),
                "serving_max_batch_max": self.max_batch,
                # SLO error-budget feed for watchtower's slo_budget_burn
                "serving_slo_good": self.slo_good_total,
                "serving_slo_total": self.slo_total,
                # fleet plane: live-swap tallies + the nonfinite-output
                # poison signal the canary rollback keys on
                "serving_swaps": self.swaps_total,
                "serving_swap_failed": self.swap_failed_total,
                "serving_nonfinite": self.nonfinite_total,
                # model/version dimension (strings: latched per-node,
                # dropped from merge_counters aggregates by design)
                "serving_model": self.model,
                "serving_model_version": self.model_version,
            }
            for reason in SHED_REASONS:
                out["serving_shed_" + reason] = \
                    self.shed_by_reason.get(reason, 0)
            for prefix, hist in self._stage_hists.items():
                hist.flat(prefix, out)
            if self._slow:
                worst = sorted(self._slow, reverse=True)[:_SLOW_BEAT]
                out["serving_slow"] = [dict(rec) for _, _, rec in worst]
        if lat:
            out["serving_p50_us_max"] = round(lat[len(lat) // 2], 1)
            out["serving_p99_us_max"] = round(
                lat[min(len(lat) - 1, int(len(lat) * 0.99))], 1)
        report = getattr(self.server, "warmup_report", None)
        if report:
            out["serving_warm_loaded"] = report["loaded"]
            out["serving_warm_compiled"] = report["compiled"]
        # Compile-plane tallies (kernel cache hits, AOT loads): gateway
        # replicas run outside a node process, so they merge the snapshot
        # here instead of via node._register_feed — the same counters, one
        # channel per process, never both.
        from tensorflowonspark_torch import compilecache

        out.update(compilecache.stats.counters_snapshot())
        return out

    # -- network front ------------------------------------------------------

    def _accept_loop(self):
        while not self._stopped:
            try:
                conn, peer = self._listener.accept()
            except OSError:
                return  # listener closed by stop()
            self._conns.add(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn, peer),
                                 name="gateway-conn", daemon=True)
            t.start()

    def _serve_conn(self, conn, peer):
        """One client connection: hello handshake, then a predict loop.
        The reader enqueues; responses are written by the batcher thread
        through the request callbacks (Transport serializes sends), so one
        connection can keep many requests in flight."""
        t = Transport(conn)
        try:
            hello = t.recv_control()
            if hello.get("type") != "hello":
                t.send_abort("protocol", "expected hello")
                return
            t.server_hello(hello, extra={
                "max_batch": self.max_batch,
                "buckets": list(self.server.buckets),
                "replica_id": self.replica_id,
            })
            while True:
                kind, msg = t.recv_message()
                if kind != transport.K_JSON:
                    t.send_abort("protocol", "expected control frame")
                    return
                mtype = msg.get("type")
                if mtype == "ping":
                    t.send_control({"type": "pong",
                                    "replica_id": self.replica_id})
                    continue
                if mtype == "bye":
                    return
                if mtype != "predict":
                    t.send_abort("protocol",
                                 "unknown message {!r}".format(mtype))
                    return
                self._handle_predict(t, msg)
        except (EOFError, OSError, TransportError):
            pass  # client went away; nothing to clean but the socket
        finally:
            self._conns.discard(conn)
            t.close()

    def _handle_predict(self, t, msg):
        rid = msg.get("id")
        req_id = msg.get("req")
        kind, payload = t.recv_message()
        flow = 0
        if kind == transport.K_TRACED:
            flow, kind, payload = Transport.split_traced(payload)
        columns, count, _ = Transport.decode_columns(kind, payload,
                                                     copy=False)
        names = msg.get("tensors") or [None] * len(columns)
        # signature-driven dtype/shape coercion: clients may send float64
        # JSON-born columns; the bucketizer must land them on the compiled
        # dtype or every batch would trace a fresh program
        feed = {}
        for name, col in zip(names, columns):
            coerced = self.server._coerce(
                name if name in self.server.signature else None, col)
            feed[name or "_x"] = coerced

        def on_result(outputs):
            out_names = sorted(outputs)
            cols = [np.ascontiguousarray(outputs[n]) for n in out_names]
            t.send_control({"type": "result", "id": rid, "req": req_id,
                            "count": int(msg.get("count", count)),
                            "outputs": out_names})
            t.send_columns(cols, len(cols[0]) if cols else 0)

        def on_error(code, message):
            t.send_control({"type": "error", "id": rid, "req": req_id,
                            "code": code, "message": message})

        self._enqueue(feed, count, msg.get("deadline_ms"),
                      on_result, on_error, req_id=req_id, flow=flow)


class GatewayChannel(object):
    """A client connection to ONE gateway replica (request/response over
    the shared transport; one in-flight request at a time per channel)."""

    def __init__(self, addr, timeout=30.0, client_id=None):
        self.addr = transport.addr_tuple(addr)
        sock = socket.create_connection(self.addr, timeout=timeout)
        sock.settimeout(timeout)
        self.client_id = client_id or "gateway-client"
        self.transport = Transport(sock)
        reply = self.transport.client_hello(
            extra={"client": self.client_id})
        self.max_batch = reply.get("max_batch")
        self.buckets = reply.get("buckets")
        self.replica_id = reply.get("replica_id")
        self._next_id = 0
        self._lock = threading.Lock()

    def predict(self, feed, count, deadline_ms=None, request_id=None,
                flow_id=None):
        """One round trip: ``feed`` is ``{tensor: array-like}`` with
        ``count`` leading rows; returns ``{name: np.ndarray}``.  Raises
        :class:`OverloadError` on a typed shed, EOFError/OSError when the
        replica died (HA clients retry elsewhere).

        ``request_id``/``flow_id`` tag the request for cross-pid tracing;
        when unset a request id is minted here and a flow id is minted from
        the live tracer (0 — no trace header on the wire — when telemetry
        is off).  The flow id rides the request frame's ``K_TRACED``
        transport header so the gateway's admit/dispatch/serialize steps
        join this client's flow arrow.
        """
        tracer = telemetry.get_tracer()
        names = sorted(feed)
        columns = [np.ascontiguousarray(np.asarray(feed[n]))
                   for n in names]
        with self._lock:
            self._next_id += 1
            rid = self._next_id
            if request_id is None:
                request_id = "{}-{}".format(self.client_id, rid)
            if flow_id is None:
                flow_id = tracer.new_flow_id()
            msg = {"type": "predict", "id": rid, "req": request_id,
                   "count": int(count), "tensors": names}
            if deadline_ms is not None:
                msg["deadline_ms"] = float(deadline_ms)
            with tracer.span("serving/request", req=request_id,
                             rows=int(count),
                             replica=str(self.replica_id or "")):
                if flow_id:
                    tracer.flow_start(
                        telemetry.SERVING_REQUEST_FLOW, flow_id,
                        req=request_id,
                        replica=str(self.replica_id or ""))
                self.transport.send_control(msg)
                self.transport.send_columns(columns, int(count),
                                            flow_id=flow_id)
                reply = self.transport.recv_control()
                if reply.get("type") == "error":
                    raise OverloadError(reply.get("code", "error"),
                                        reply.get("message", ""))
                if reply.get("type") != "result":
                    raise TransportError(
                        "unexpected reply {!r}".format(reply))
                kind, payload = self.transport.recv_message()
                cols, _, _ = Transport.decode_columns(kind, payload,
                                                      copy=True)
                if flow_id:
                    tracer.flow_end(telemetry.SERVING_REQUEST_FLOW,
                                    flow_id, req=request_id, stage="reply")
        return dict(zip(reply.get("outputs", []), cols))

    def ping(self):
        with self._lock:
            self.transport.send_control({"type": "ping"})
            return self.transport.recv_control()

    def close(self):
        try:
            with self._lock:
                self.transport.send_control({"type": "bye"})
        except (OSError, EOFError):
            pass
        self.transport.close()


class ServingClient(object):
    """HA client over N gateway replicas: discovers the fleet from the
    reservation roster (or a static address list), spreads requests
    round-robin over the healthy replica set (picks counted per replica,
    so a 3-replica fleet actually takes 1/3 of the load each), and
    retries a failed request on a surviving replica.  Prediction is
    idempotent, so a request that was in flight on a killed replica is
    simply re-sent — this is how an *accepted* request survives a
    replica SIGKILL.

    A replica that fails at the transport level is marked unhealthy and
    skipped by the rotation; once every replica is marked, the set is
    reset and all are retried (a dead socket fails fast, so full-fleet
    resets stay cheap).

    :class:`OverloadError` is NOT retried here: a typed shed is the
    gateway telling this client to back off, and hammering a sibling
    replica would defeat admission control.  Callers own that policy.
    """

    def __init__(self, replicas=None, roster_addr=None, timeout=30.0,
                 roster_timeout=60.0, client_id=None):
        self.timeout = timeout
        self.client_id = client_id
        if replicas is None:
            if roster_addr is None:
                raise ValueError("need replicas=[addr...] or roster_addr")
            replicas = self._discover(roster_addr, roster_timeout)
        self.replicas = [transport.addr_tuple(a) for a in replicas]
        if not self.replicas:
            raise ValueError("no serving replicas found")
        self._rr = 0
        self._chans = {}     # addr -> connected GatewayChannel
        self._bad = set()    # addrs skipped by the rotation
        self.failovers = 0
        self._req_seq = 0
        #: requests routed per replica ("host:port" -> count) — the
        #: balance surface
        self.picks = {}
        # client-side view of the wire: redials (transport failures that
        # rotated replicas) and typed sheds the gateway handed back.  Flat
        # counter names so callers can drop them onto any heartbeat.
        self.counters = {"serving_client_redials": 0,
                         "serving_client_shed": 0}

    @staticmethod
    def _discover(roster_addr, timeout):
        """Roster bootstrap: wait for the full roster (get_reservations is
        None until every slot registers), keep the ``serving`` rows."""
        from tensorflowonspark_torch import reservation

        client = reservation.Client(transport.addr_tuple(roster_addr))
        try:
            info = client.await_reservations(timeout=timeout)
        finally:
            client.close()
        return ["{}:{}".format(m["host"], m["port"]) for m in info
                if isinstance(m, dict) and m.get("job_name") == "serving"]

    def _pick(self):
        """Next replica in the round-robin rotation, skipping addresses
        marked unhealthy; when everything is marked, the set resets so a
        recovered fleet is rediscovered instead of erroring forever."""
        if len(self._bad) >= len(self.replicas):
            self._bad.clear()
        for _ in range(len(self.replicas)):
            addr = self.replicas[self._rr % len(self.replicas)]
            self._rr += 1
            if addr not in self._bad:
                return addr
        return self.replicas[self._rr % len(self.replicas)]

    def _channel(self, addr):
        chan = self._chans.get(addr)
        if chan is not None:
            return chan
        last = None
        for _ in range(len(self.replicas)):
            try:
                chan = GatewayChannel(addr, timeout=self.timeout,
                                      client_id=self.client_id)
                self._chans[addr] = chan
                return chan
            except OSError as e:
                last = e
                self._mark_bad(addr)
                addr = self._pick()
                chan = self._chans.get(addr)
                if chan is not None:
                    return chan
        raise ConnectionError(
            "no serving replica reachable (tried {}): {}".format(
                self.replicas, last))

    def _mark_bad(self, addr):
        self._bad.add(addr)
        self.failovers += 1
        self.counters["serving_client_redials"] += 1
        telemetry.get_tracer().counter_add("serving_client_redials")

    def _drop_channel(self, addr):
        chan = self._chans.pop(addr, None)
        if chan is not None:
            try:
                chan.transport.close()
            except OSError:
                pass
        self._mark_bad(addr)

    def predict(self, feed, count, deadline_ms=None):
        """Predict with failover: transport-level failures rotate to the
        next replica, trying each one once before giving up.

        The request id and ``serving/request_flow`` flow id are minted
        ONCE here and re-sent verbatim on every failover attempt, so a
        request that survived a replica kill still renders as one flow
        arrow (with a visible hop to the second replica)."""
        tracer = telemetry.get_tracer()
        self._req_seq += 1
        request_id = "{}-{}".format(self.client_id or "serving-client",
                                    self._req_seq)
        flow_id = tracer.new_flow_id()
        last = None
        for _ in range(len(self.replicas) + 1):
            addr = self._pick()
            try:
                chan = self._channel(addr)
            except (OSError, ConnectionError) as e:
                last = e
                continue
            addr = chan.addr  # _channel may have failed over while dialing
            key = "{}:{}".format(*addr)
            self.picks[key] = self.picks.get(key, 0) + 1
            try:
                return chan.predict(feed, count,
                                    deadline_ms=deadline_ms,
                                    request_id=request_id,
                                    flow_id=flow_id)
            except OverloadError as e:
                self.counters["serving_client_shed"] += 1
                tracer.counter_add("serving_client_shed")
                if flow_id:
                    tracer.flow_end(telemetry.SERVING_REQUEST_FLOW,
                                    flow_id, req=request_id, stage="shed",
                                    reason=e.code)
                raise
            except (EOFError, OSError, ConnectionError,
                    TransportError) as e:
                last = e
                self._drop_channel(addr)
        if flow_id:
            tracer.flow_end(telemetry.SERVING_REQUEST_FLOW, flow_id,
                            req=request_id, stage="failed")
        raise ConnectionError(
            "predict failed on every replica: {!r}".format(last))

    def close(self):
        for addr in list(self._chans):
            chan = self._chans.pop(addr)
            try:
                chan.close()
            except (OSError, EOFError):
                pass
