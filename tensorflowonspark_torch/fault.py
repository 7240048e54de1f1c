"""Fault-tolerance primitives: retry policy and fault injection.

The reference framework's whole recovery story was "Spark retries the job and
TF restores from the last checkpoint" (SURVEY §5.3).  This module makes both
halves first-class for the TPU framework:

- :class:`RetryPolicy` — exponential backoff + jitter + retryable-error
  classification, shared by the driver's supervised feed-job retry
  (:meth:`~tensorflowonspark_torch.cluster.TPUCluster.train`) and the trainer's
  supervised restart (:func:`~tensorflowonspark_torch.train.fit_supervised`,
  which restores-latest from a
  :class:`~tensorflowonspark_torch.checkpoint.CheckpointManager`).
- :class:`FaultInjector` — env/ctx-driven chaos harness that can kill a node
  at item/step N, drop heartbeats, delay or close control-plane sockets, and
  corrupt a queue chunk.  Wired into the hot paths
  (:class:`~tensorflowonspark_torch.datafeed.DataFeed` consumption, the
  heartbeat sender, the built-in backend's executor loop, the feed chunk
  putter) behind a null-object default, so production runs pay one env lookup
  per process and chaos tests exercise the REAL failure paths instead of
  ad-hoc ``raise RuntimeError("injected ...")`` in user fns.

Classification contract: infrastructure failures (an executor or node process
that died, a drain timeout, a cancelled sibling task, connection loss) are
retryable — re-running the work elsewhere can succeed.  User-code exceptions
(surfaced as ``"Exception in user code"`` tracebacks) are NOT: the same code
fed the same data fails the same way, and retrying silently re-trains on
duplicate rows.
"""

import json
import logging
import os
import random
import re
import signal
import time

logger = logging.getLogger(__name__)

#: Environment variable carrying a JSON :class:`FaultInjector` spec.  The
#: built-in backend's per-executor env overrides are the targeting mechanism:
#: set the spec on exactly the executor whose node should fail.
FAULT_SPEC_ENV = "TFOS_FAULT_SPEC"


class InjectedFailure(RuntimeError):
    """An error raised deliberately by the fault-injection harness.

    Simulates a *user-code* failure, so the default :class:`RetryPolicy`
    classifies it non-retryable (chaos tests that want a retryable injected
    failure pass ``extra_retryable=["injected"]``).
    """


class PoisonRollback(Exception):
    """Raised inside the training loop when the remediator pushes the
    ``train_rollback`` command knob (a watchtower ``nonfinite`` crit
    alert): the dispatch loop halts, ``fit_supervised`` quarantines the
    poisoned checkpoint step(s) via ``restore_latest_valid`` (the
    ``<step>.corrupt`` convention) and resumes from the last valid one.
    Deliberately NOT an :class:`InjectedFailure` — this is a control-plane
    signal, not a simulated fault, and it must never be classified
    retryable (the rollback path handles it explicitly without consuming
    a retry attempt)."""

    def __init__(self, step=None, token=None):
        super(PoisonRollback, self).__init__(
            "poison rollback requested at host step {}".format(step))
        self.step = step
        self.token = token


def fail(message="injected failure"):
    """Raise an :class:`InjectedFailure` unconditionally.

    The one-line replacement for the ad-hoc ``raise RuntimeError("injected
    ...")`` scattered through older tests — failures stay greppable under a
    single type and classification rule.
    """
    raise InjectedFailure(message)


# ---------------------------------------------------------------------------
# RetryPolicy
# ---------------------------------------------------------------------------

#: Error-string patterns that mark a failure as infrastructure (retryable).
#: Matched case-insensitively against ``str(exc)`` / the formatted traceback.
RETRYABLE_PATTERNS = (
    r"executor \d+ died",                # LocalBackend: executor process gone
    r"node process .* died",             # feeder's dead-consumer fast-fail
    r"task skipped: job cancelled",      # sibling cancelled before dispatch
    r"backend stopped",
    r"timeout \(\d+(\.\d+)?s\) waiting for the consumer",  # feed drain timeout
    r"job did not complete within",
    r"marked dead by the liveness monitor",
    r"connection(error| refused| reset)",
    r"broken pipe",
    r"\beoferror\b",
    # transiently true while an elastic replacement is being admitted: the
    # retry waits for the admission and re-dispatches onto the new roster
    r"unschedulable: no live executors",
)

#: Exception types that are retryable regardless of message.
RETRYABLE_TYPES = (ConnectionError, EOFError, BrokenPipeError, TimeoutError)

#: Patterns that force NON-retryable even if a retryable pattern also matches
#: (a user traceback may embed e.g. a ConnectionError string).
FATAL_PATTERNS = (
    r"exception in user code",
)


class RetryPolicy(object):
    """Exponential backoff + jitter + retryable-error classification.

    Args:
      max_attempts: total tries including the first (≥ 1).
      initial_backoff: seconds before the first retry.
      max_backoff: backoff ceiling in seconds.
      multiplier: backoff growth factor per attempt.
      jitter: fraction of the delay randomized away (0.5 → delay sampled
        uniformly from [0.5·d, d]); decorrelates retry storms across feeders.
      extra_retryable: additional regex patterns treated as retryable (e.g.
        ``["injected"]`` in chaos tests).
      retryable_fn: full override — ``fn(error) -> bool`` where ``error`` is
        an exception or a formatted-traceback string; when given, the
        pattern/type classification is skipped entirely.
      rng: random source for jitter (tests inject a seeded one).
    """

    def __init__(self, max_attempts=3, initial_backoff=1.0, max_backoff=30.0,
                 multiplier=2.0, jitter=0.5, extra_retryable=(),
                 retryable_fn=None, rng=None):
        assert max_attempts >= 1, max_attempts
        self.max_attempts = max_attempts
        self.initial_backoff = initial_backoff
        self.max_backoff = max_backoff
        self.multiplier = multiplier
        self.jitter = jitter
        self._retryable_fn = retryable_fn
        self._patterns = [re.compile(p, re.IGNORECASE)
                          for p in tuple(RETRYABLE_PATTERNS) + tuple(extra_retryable)]
        self._fatal = [re.compile(p, re.IGNORECASE) for p in FATAL_PATTERNS]
        self._rng = rng or random.Random()

    def backoff(self, attempt):
        """Delay in seconds before retry number ``attempt`` (0-based)."""
        delay = min(self.initial_backoff * (self.multiplier ** attempt),
                    self.max_backoff)
        if self.jitter:
            low = delay * (1.0 - self.jitter)
            delay = self._rng.uniform(low, delay)
        return delay

    def is_retryable(self, error):
        """Classify an exception (or formatted-traceback string)."""
        if self._retryable_fn is not None:
            return bool(self._retryable_fn(error))
        if isinstance(error, BaseException):
            if isinstance(error, InjectedFailure):
                text = str(error)  # classify by message patterns only
            elif isinstance(error, RETRYABLE_TYPES):
                return True
            else:
                text = "{}: {}".format(type(error).__name__, error)
        else:
            text = str(error)
        if any(p.search(text) for p in self._fatal):
            return False
        return any(p.search(text) for p in self._patterns)

    def call(self, fn, description="operation", on_retry=None):
        """Run ``fn()`` under this policy; retries retryable failures with
        backoff, re-raising the last error when attempts are exhausted.

        ``on_retry``: optional ``fn(attempt, exc)`` hook run before each
        retry's backoff sleep (e.g. restore-latest from a checkpoint).
        """
        for attempt in range(self.max_attempts):
            try:
                return fn()
            except Exception as e:
                if (not self.is_retryable(e)
                        or attempt + 1 >= self.max_attempts):
                    raise
                delay = self.backoff(attempt)
                logger.warning(
                    "%s failed (%s: %s); retry %d/%d in %.1fs",
                    description, type(e).__name__, e, attempt + 1,
                    self.max_attempts - 1, delay)
                if on_retry is not None:
                    on_retry(attempt, e)
                time.sleep(delay)
        raise AssertionError("unreachable")  # pragma: no cover


# ---------------------------------------------------------------------------
# FaultInjector
# ---------------------------------------------------------------------------

class _NullInjector(object):
    """No-op injector: the production fast path (one env lookup, no branches
    per item beyond a single attribute call)."""

    enabled = False

    def on_items(self, n=1):
        pass

    def on_task(self):
        pass

    def on_split(self, n=1):
        pass

    def on_step(self, step=None):
        pass

    def on_predict(self, rows=None, batch=None):
        pass

    def corrupt_batch(self, batch, step=None):
        return batch

    def on_consume(self):
        pass

    def traffic_multiplier(self):
        return 1.0

    def should_drop_heartbeat(self, beats_sent):
        return False

    def delay_socket(self):
        pass

    def corrupt(self, data):
        return data

    def maybe_fail(self, where):
        pass

    def arm_preempt_notice(self):
        pass

    def arm_coordinator_kill(self, role=None):
        pass

    def corrupt_checkpoint(self, directory):
        pass


NULL = _NullInjector()


class FaultInjector(object):
    """Env/ctx-driven fault injection for chaos testing.

    Spec keys (all optional; counters are per-process):

    - ``kill_after_items``: SIGKILL this process once the data feed has
      handed out N items (the "node dies at step N" fault — an unannounced
      death the liveness monitor must catch).
    - ``sigterm_at_item``: SIGTERM this process once the data feed has
      handed out N items — an ANNOUNCED preemption: the node's SIGTERM
      drain (stop feeding, emergency checkpoint, ``BYE reason=preempted``)
      must run instead of a heartbeat-timeout death.
    - ``preempt_notice``: seconds of advance warning a preemption notice
      gives; :meth:`arm_preempt_notice` (called when the node's user fn
      starts) arms a timer that SIGTERMs the process after that delay —
      the cloud-provider "instance going away in N seconds" shape.
    - ``kill_coordinator_after_secs``: SIGKILL a *coordinator* process
      (reservation server or data-service dispatcher) that long after
      :meth:`arm_coordinator_kill` is called at its startup — scripts
      coordinator death like node death, so chaos runs exercise the
      warm-standby takeover path.  Optional ``coordinator_role``
      (``"reservation"`` / ``"dispatcher"``) restricts which coordinator
      the spec fires in, the way ``executor_id`` targets node faults.
    - ``fail_after_items``: raise :class:`InjectedFailure` (``message``)
      once N items were consumed (a user-code failure at step N).
    - ``corrupt_checkpoint``: garble the newest checkpoint step directory
      the next time :meth:`corrupt_checkpoint` fires (wired into
      ``CheckpointManager.maybe_save``) — recovery must then fall back to
      the previous retained step (``restore_latest_valid``).
    - ``kill_after_tasks``: SIGKILL the built-in backend's executor process
      after serving N tasks (whole-executor loss).
    - ``kill_after_splits``: SIGKILL a data-service feed worker once it has
      finished streaming N splits — the mid-job worker death whose splits
      the dispatcher must re-pool (exactly-once visitation under failure).
    - ``sleep_per_step_secs``: sleep this long in the training loop before
      EVERY dispatch (:meth:`on_step`) — turns this node into a straggler
      the watchtower's cross-node rules must name without killing anything.
    - ``sleep_per_predict_secs``: the serving-plane analogue — the gateway
      batcher sleeps this long before EVERY model dispatch
      (:meth:`on_predict`), inflating the ``dispatch_us`` stage so
      request-trace/latency-decomposition assertions and the
      ``slo_budget_burn`` rule have a deterministic slow replica.
    - ``nan_batch_at_step``: once the host step counter reaches N, replace
      every floating leaf of ONE batch with NaN (:meth:`corrupt_batch`,
      fires once) — the NaN'd loss then arises through real training math,
      exercising the window-boundary nonfinite tallies end to end.
    - ``saturate_consumer_secs``: for this many seconds after the FIRST
      consumer pop (:meth:`on_consume`, wired into the ServiceFeed's
      chunk-drain loop), every pop sleeps ``saturate_consumer_sleep``
      (default 0.05 s) — a timed slow-drain that pins the prefetch queue
      at capacity and forces the watchtower's ``dataservice_saturation``
      rule, then releases so the run still completes.  The remediator's
      worker scale-out chaos gate rides this.
    - ``traffic_surge``: ``{"mult": M, "secs": S}`` — a timed QPS
      multiplier for serving chaos: :meth:`traffic_multiplier` returns
      ``M`` for ``S`` seconds after its first call, then 1.0.  Load
      generators poll it per request batch, so one env spec turns a
      steady drive into a surge that burns the latency SLO
      (``slo_budget_burn`` -> remediator serving scale-out).
    - ``drop_heartbeats_after``: heartbeat sender emits N beats, then goes
      silent while the process lives (tests missed-beat detection without a
      real death).
    - ``delay_connect_secs``: sleep before control-plane socket connects
      (slow-network rendezvous).
    - ``corrupt_chunk_index``: corrupt the Nth feed chunk's serialized bytes
      (consumer-side desync / unpickle failure).
    - ``message``: message for ``fail_after_items``.
    - ``executor_id``: restrict the spec to one executor id; when absent the
      spec applies to whichever process carries it in its environment (the
      built-in backend's ``env_per_executor`` is the usual targeting knob).

    Construct directly for in-process tests, or plant a JSON spec in
    ``TFOS_FAULT_SPEC`` (see :meth:`from_env`) to reach executor and node
    child processes.
    """

    enabled = True

    def __init__(self, spec):
        self.spec = dict(spec or {})
        self._items = 0
        self._tasks = 0
        self._chunks = 0
        self._splits = 0
        self._slow_fired = False
        self._slow_predict_fired = False
        self._consume_t0 = None   # first on_consume() (slow-drain anchor)
        self._consume_fired = False
        self._surge_t0 = None     # first traffic_multiplier() (surge anchor)
        self._surge_fired = False

    @staticmethod
    def _fired(kind, flush=False, **attrs):
        """Mark an injection firing on the telemetry timeline, so a chaos
        trace shows WHERE the kill/corruption landed relative to the
        fence→reclaim→replace spans.  ``flush=True`` for faults that end
        this process abruptly (SIGKILL never reaches the BYE flush)."""
        from tensorflowonspark_torch import telemetry

        tracer = telemetry.get_tracer()
        tracer.instant("fault/" + kind, **attrs)
        if flush:
            tracer.flush()

    @classmethod
    def from_env(cls, environ=None):
        """Build from ``TFOS_FAULT_SPEC`` (JSON); :data:`NULL` when unset,
        malformed, or targeted at a different executor."""
        environ = environ if environ is not None else os.environ
        raw = environ.get(FAULT_SPEC_ENV)
        if not raw:
            return NULL
        try:
            spec = json.loads(raw)
        except ValueError:
            logger.warning("ignoring malformed %s=%r", FAULT_SPEC_ENV, raw)
            return NULL
        target = spec.get("executor_id")
        if target is not None:
            from tensorflowonspark_torch import util

            try:
                if util.read_executor_id() != target:
                    return NULL
            except Exception:
                return NULL  # no executor identity here: not the target
        return cls(spec)

    # -- injection points -------------------------------------------------

    def on_items(self, n=1):
        """Data-feed consumption hook: count ``n`` consumed items and fire
        ``kill_after_items`` / ``sigterm_at_item`` / ``fail_after_items``
        when crossed."""
        self._items += n
        kill_at = self.spec.get("kill_after_items")
        if kill_at is not None and self._items >= kill_at:
            logger.warning("FaultInjector: killing pid %d after %d items",
                           os.getpid(), self._items)
            self._fired("kill_after_items", flush=True, items=self._items)
            self._kill_self()
        term_at = self.spec.get("sigterm_at_item")
        if term_at is not None and self._items >= term_at:
            self.spec.pop("sigterm_at_item")  # fire once
            logger.warning("FaultInjector: SIGTERM (preemption) to pid %d "
                           "after %d items", os.getpid(), self._items)
            self._fired("sigterm_at_item", items=self._items)
            os.kill(os.getpid(), signal.SIGTERM)
        fail_at = self.spec.get("fail_after_items")
        if fail_at is not None and self._items >= fail_at:
            self.spec.pop("fail_after_items")  # fire once
            self._fired("fail_after_items", items=self._items)
            fail(self.spec.get("message", "injected failure after {} items"
                               .format(self._items)))

    def on_task(self):
        """Built-in backend executor hook: count a served task and fire
        ``kill_after_tasks`` when crossed."""
        self._tasks += 1
        kill_at = self.spec.get("kill_after_tasks")
        if kill_at is not None and self._tasks >= kill_at:
            logger.warning("FaultInjector: killing executor pid %d after %d "
                           "tasks", os.getpid(), self._tasks)
            self._fired("kill_after_tasks", flush=True, tasks=self._tasks)
            self._kill_self()

    def on_split(self, n=1):
        """Data-service worker hook: count ``n`` finished splits and fire
        ``kill_after_splits`` when crossed."""
        self._splits += n
        kill_at = self.spec.get("kill_after_splits")
        if kill_at is not None and self._splits >= kill_at:
            logger.warning("FaultInjector: killing feed worker pid %d after "
                           "%d splits", os.getpid(), self._splits)
            self._fired("kill_after_splits", flush=True, splits=self._splits)
            self._kill_self()

    def on_step(self, step=None):
        """Training-loop hook (``fit_feed``, once per dispatch): sleep
        ``sleep_per_step_secs`` before the dispatch, making this node a
        persistent straggler rather than a dead one."""
        delay = self.spec.get("sleep_per_step_secs")
        if not delay:
            return
        if not self._slow_fired:
            self._slow_fired = True
            logger.warning("FaultInjector: slowing pid %d by %.3fs/step",
                           os.getpid(), delay)
            self._fired("sleep_per_step", delay_secs=delay, step=step)
        time.sleep(delay)

    def on_predict(self, rows=None, batch=None):
        """Serving-plane hook (gateway ``_dispatch``, once per coalesced
        batch): sleep ``sleep_per_predict_secs`` before the model dispatch,
        making this replica a persistent straggler whose inflated
        ``dispatch_us`` stage the request-plane observability must name."""
        delay = self.spec.get("sleep_per_predict_secs")
        if not delay:
            return
        if not self._slow_predict_fired:
            self._slow_predict_fired = True
            logger.warning("FaultInjector: slowing pid %d by %.3fs/predict",
                           os.getpid(), delay)
            self._fired("sleep_per_predict", delay_secs=delay, rows=rows,
                        batch=batch)
        time.sleep(delay)

    def corrupt_batch(self, batch, step=None):
        """Training-loop hook: once the host step counter reaches
        ``nan_batch_at_step``, replace every floating leaf of one batch (a
        tree of dicts, lists and tuples over torch tensors and numpy
        arrays) with a NaN-filled copy, on the same device (fires once).
        The nonfinite loss/grads then arise through the real step, not a
        mocked value."""
        at = self.spec.get("nan_batch_at_step")
        if at is None or (step is not None and step < at):
            return batch
        self.spec.pop("nan_batch_at_step")  # fire once
        logger.warning("FaultInjector: NaN-corrupting batch at step %s", step)
        self._fired("nan_batch", step=step)
        import numpy as np
        import torch

        def nanify(x):
            if isinstance(x, torch.Tensor) and x.is_floating_point():
                return torch.full_like(x, float("nan"))
            if (isinstance(x, np.ndarray)
                    and np.issubdtype(x.dtype, np.floating)):
                return np.full_like(x, np.nan)
            return x

        def tree_map(tree):
            if isinstance(tree, dict):
                return {k: tree_map(v) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(tree_map(v) for v in tree)
            return nanify(tree)

        return tree_map(batch)

    def on_consume(self):
        """ServiceFeed chunk-drain hook: for ``saturate_consumer_secs``
        seconds after the first pop, sleep ``saturate_consumer_sleep``
        per pop — the producer pins the prefetch queue at capacity
        (``dataservice_saturation`` fires) and then the drain recovers,
        so the run still finishes."""
        secs = self.spec.get("saturate_consumer_secs")
        if not secs:
            return
        now = time.monotonic()
        if self._consume_t0 is None:
            self._consume_t0 = now
        if now - self._consume_t0 > secs:
            return
        if not self._consume_fired:
            self._consume_fired = True
            logger.warning("FaultInjector: slow-draining consumer pid %d "
                           "for %.1fs", os.getpid(), secs)
            self._fired("saturate_consumer", secs=secs)
        time.sleep(self.spec.get("saturate_consumer_sleep", 0.05))

    def traffic_multiplier(self):
        """Serving-chaos hook: the current offered-load multiplier.  With
        ``traffic_surge`` ``{"mult": M, "secs": S}`` armed, returns ``M``
        for ``S`` seconds after the first poll, else 1.0 — load
        generators scale their request rate by it per batch."""
        surge = self.spec.get("traffic_surge")
        if not surge:
            return 1.0
        now = time.monotonic()
        if self._surge_t0 is None:
            self._surge_t0 = now
        if now - self._surge_t0 > surge.get("secs", 0):
            return 1.0
        if not self._surge_fired:
            self._surge_fired = True
            logger.warning("FaultInjector: traffic surge x%s for %ss",
                           surge.get("mult", 1.0), surge.get("secs", 0))
            self._fired("traffic_surge", mult=surge.get("mult", 1.0),
                        secs=surge.get("secs", 0))
        return float(surge.get("mult", 1.0))

    def should_drop_heartbeat(self, beats_sent):
        """Heartbeat-sender hook: True once ``drop_heartbeats_after`` beats
        went out (the node then looks dead to the monitor while alive)."""
        drop_at = self.spec.get("drop_heartbeats_after")
        return drop_at is not None and beats_sent >= drop_at

    def delay_socket(self):
        """Control-plane socket hook: sleep ``delay_connect_secs``."""
        delay = self.spec.get("delay_connect_secs")
        if delay:
            time.sleep(delay)

    def corrupt(self, data):
        """Feed-chunk hook: flip bytes of the chunk whose 0-based index
        matches ``corrupt_chunk_index``; other chunks pass through."""
        idx = self.spec.get("corrupt_chunk_index")
        here = self._chunks
        self._chunks += 1
        if idx is None or here != idx:
            return data
        logger.warning("FaultInjector: corrupting feed chunk %d", here)
        self._fired("corrupt_chunk", chunk_index=here)
        corrupted = bytearray(data)
        for i in range(min(16, len(corrupted))):
            corrupted[i] ^= 0xFF
        return bytes(corrupted)

    def maybe_fail(self, where):
        """Generic named failpoint: raise when spec ``fail_at == where``."""
        if self.spec.get("fail_at") == where:
            self._fired("fail_at", where=where)
            fail(self.spec.get("message",
                               "injected failure at {}".format(where)))

    def arm_preempt_notice(self):
        """Arm the ``preempt_notice`` timer: a daemon timer SIGTERMs this
        process after the configured delay, simulating a cloud preemption
        notice arriving mid-run.  Call once when the node's user fn starts
        (wired into the node wrappers); unarmed specs are a no-op."""
        delay = self.spec.get("preempt_notice")
        if not delay:
            return
        self.spec.pop("preempt_notice")  # arm once
        import threading

        def _notify():
            logger.warning("FaultInjector: preemption notice expired; "
                           "SIGTERM to pid %d", os.getpid())
            self._fired("preempt_notice", delay_secs=delay)
            os.kill(os.getpid(), signal.SIGTERM)

        t = threading.Timer(delay, _notify)
        t.daemon = True
        t.start()

    def arm_coordinator_kill(self, role=None):
        """Arm the ``kill_coordinator_after_secs`` timer: a daemon timer
        SIGKILLs this process after the configured delay — an unannounced
        coordinator death the warm standby must turn into a takeover.
        Call once at coordinator startup (the reservation-server and
        dispatcher CLIs do), passing this process's ``role``; a spec with
        ``coordinator_role`` set fires only in the matching coordinator."""
        delay = self.spec.get("kill_coordinator_after_secs")
        if not delay:
            return
        target = self.spec.get("coordinator_role")
        if target is not None and role is not None and target != role:
            return
        self.spec.pop("kill_coordinator_after_secs")  # arm once
        import threading

        def _kill():
            logger.warning("FaultInjector: killing %s coordinator pid %d "
                           "after %.1fs", role or "?", os.getpid(), delay)
            self._fired("kill_coordinator", flush=True, role=role,
                        delay_secs=delay)
            self._kill_self()

        t = threading.Timer(delay, _kill)
        t.daemon = True
        t.start()

    def corrupt_checkpoint(self, directory):
        """Garble the newest checkpoint step under ``directory`` (fires
        once): every regular file in the step dir is truncated and
        overwritten with garbage, so a restore of that step fails and
        recovery must fall back to the previous retained step."""
        if not self.spec.get("corrupt_checkpoint"):
            return
        steps = []
        try:
            for name in os.listdir(directory):
                if name.isdigit() and os.path.isdir(
                        os.path.join(directory, name)):
                    steps.append(int(name))
        except OSError:
            return
        if not steps:
            return  # nothing saved yet: stay armed for the next save
        self.spec.pop("corrupt_checkpoint")  # fire once
        step_dir = os.path.join(directory, str(max(steps)))
        logger.warning("FaultInjector: corrupting checkpoint step dir %s",
                       step_dir)
        self._fired("corrupt_checkpoint", step=max(steps))
        for root, _, files in os.walk(step_dir):
            for fname in files:
                path = os.path.join(root, fname)
                try:
                    with open(path, "wb") as f:
                        f.write(b"\xde\xad\xbe\xef")
                except OSError:
                    pass

    @staticmethod
    def _kill_self():
        os.kill(os.getpid(), signal.SIGKILL)


def from_env(environ=None):
    """Module-level alias for :meth:`FaultInjector.from_env` (the hot-path
    call sites read better as ``fault.from_env()``)."""
    return FaultInjector.from_env(environ)
