"""Driver-side cluster lifecycle API (reference ``TFCluster.py``; the port's
copy of the JAX package's ``cluster`` module).

``run()`` turns a backend's executors into a training cluster: it computes the
role template, starts the rendezvous server, launches one long-running node
task per executor, waits for all nodes to register, and returns a
:class:`TPUCluster` whose ``train/inference/shutdown`` drive the data plane
(reference call stacks SURVEY §3.1-§3.5).

Input modes (reference ``TFCluster.py:41-44``):

- ``InputMode.FILES``  (reference name ``TENSORFLOW``): nodes read their data
  directly from shared storage; the cluster only orchestrates lifecycle.
- ``InputMode.SPARK``: the backend pushes dataset partitions through
  per-executor queues into the nodes (feed jobs with backpressure).

The driver never initializes CUDA for the cluster: the executors are
spawned processes, and each node's first CUDA call is in its user fn.  The
observatory (``observatory=True``: ``/metrics``, ``/status``, ``/profile``,
``/slow``, ``/alerts``, ``/autopilot``, ``/remediations``), the per-node
profiler capture endpoints (``profiler=True``) and the alerting and control
planes (``watchtower``, ``autopilot``, ``remediator``), the warm-start
compile plane (``compile_cache_dir``) and the disaggregated data service
(``data_service``) are ported.
"""

import logging
import os
import random
import signal
import sys
import threading
import time
import uuid

from tensorflowonspark_torch import backend as backend_mod
from tensorflowonspark_torch import node, reservation
from tensorflowonspark_torch import telemetry as telemetry_mod

logger = logging.getLogger(__name__)

#: env fallback of the compile cache dir (``compilecache.CACHE_DIR_ENV``)
COMPILE_CACHE_DIR_ENV = "TFOS_COMPILE_CACHE_DIR"

class InputMode(object):
    """How data reaches the nodes (reference ``TFCluster.py:41-44``)."""

    TENSORFLOW = 0  # reference-compat alias for FILES
    FILES = 0       # nodes read files from shared storage themselves
    SPARK = 1       # backend pushes dataset partitions via queues


class TPUCluster(object):
    """Handle for a running cluster (reference ``TFCluster`` object,
    ``TFCluster.py:29-207``)."""

    def __init__(self, backend, cluster_meta, cluster_info, input_mode,
                 server, start_job, tf_status, queues, observatory=None,
                 profiling=None, watchtower=None, autopilot=None,
                 remediator=None):
        self.backend = backend
        self.cluster_meta = cluster_meta
        self.cluster_info = cluster_info
        self.input_mode = input_mode
        self.server = server
        self.start_job = start_job
        self.tf_status = tf_status
        self.queues = queues
        # optional observatory.ObservatoryServer (cluster.run(observatory=
        # True)): live /metrics + /status HTTP endpoint; stopped with the
        # cluster on every shutdown path (see _latch_telemetry)
        self.observatory = observatory
        # optional profiling.CaptureCoordinator (rides the observatory
        # flag): .trigger() captures traces from the driver without going
        # through HTTP; artifacts land under <log_dir>/profiles
        self.profiling = profiling
        # optional watchtower.Watchtower (rides the observatory flag):
        # streaming straggler/anomaly detection over the sample ring;
        # stopped before the observatory so the final journal flush and
        # alert-count latch land in tf_status (see _latch_telemetry)
        self.watchtower = watchtower
        # optional autopilot.Autopilot (cluster.run(autopilot=True)): the
        # closed-loop performance controller; stopped before the
        # watchtower so its final journal snapshot and action tallies
        # precede the watchtower/observatory teardown
        self.autopilot = autopilot
        # optional remediator.Remediator (cluster.run(remediator=True)):
        # the topology action plane over admitted watchtower alerts;
        # stopped before everything else on shutdown — its subprocess
        # pools (scale-out workers/replicas) must die before the roster
        # they talk to (see _latch_telemetry)
        self.remediator = remediator

    # -- data plane -------------------------------------------------------

    def train(self, data, num_epochs=1, feed_timeout=600, qname="input",
              chunk_size=1024, retry_policy=None):
        """Feed partitioned data for training (InputMode.SPARK only;
        reference ``TFCluster.py:61-92``).

        ``data`` may be:
        - a list of partitions (built-in backend) or an RDD (Spark backend);
          epochs repeat **executor-side** — each feed task replays its
          partition's packed chunks ``num_epochs`` times from an
          executor-local cache, so the driver ships every row exactly once
          (the reference re-shipped each epoch via
          ``sc.union([rdd]*num_epochs)``, ``TFCluster.py:88-91``);
        - a Spark Streaming DStream: every micro-batch RDD is fed as its own
          feed job until STOP (reference DStream branch, ``TFCluster.py:81-83``;
          pair with ``shutdown(ssc=...)``);
        - an *iterator/generator of partitions* for streaming without Spark:
          fed until exhausted or a STOP is requested.

        ``chunk_size`` governs feed amortization: rows travel in columnar
        chunks of this many rows (see ``node.train``).

        ``retry_policy``: optional
        :class:`~tensorflowonspark_torch.fault.RetryPolicy` supervising the
        feed job (list-of-partitions data only): after ALL tasks settle,
        partitions whose tasks failed retryably (dead node/executor, drain
        timeout, cancelled sibling — see ``fault.RETRYABLE_PATTERNS``) are
        re-dispatched with backoff onto the live executors; the surviving
        nodes re-consume them from their own queues.  User-code failures
        stay fatal.  RDD/DStream/iterator data ignores the policy (Spark
        applies its own task-level retries there).
        """
        logger.info("Feeding training data")
        assert self.input_mode == InputMode.SPARK, \
            "train() feeding requires InputMode.SPARK"
        assert num_epochs >= 0
        fn = node.train(self.cluster_info, self.cluster_meta, qname,
                        feed_timeout, chunk_size, max(num_epochs, 1))
        if hasattr(data, "foreachRDD"):  # Spark Streaming DStream
            # Streaming has no epochs: feed each micro-batch once.
            fn = node.train(self.cluster_info, self.cluster_meta, qname,
                            feed_timeout, chunk_size)
            cluster = self

            def _feed_batch(rdd):
                # Runs on the streaming scheduler thread, once per interval.
                # After STOP, micro-batches keep arriving until the user's
                # awaitTermination loop (shutdown(ssc=...)) stops the
                # context; don't feed them into terminating nodes.
                if not cluster.server.done:
                    try:
                        rdd.foreachPartition(fn)
                    except Exception as e:
                        # scheduler-thread failure never reaches the driver
                        # thread: latch it so shutdown(ssc=...) exits 1
                        cluster._latch_error(e)
                        raise

            data.foreachRDD(_feed_batch)
        elif hasattr(data, "__next__"):  # streaming source: unbounded partitions
            # Streaming has no epochs: feed each partition once.
            fn = node.train(self.cluster_info, self.cluster_meta, qname,
                            feed_timeout, chunk_size)
            try:
                for part in data:
                    if self.server.done:
                        logger.info("STOP requested; ending streaming feed")
                        break
                    self.backend.foreach_partition([part], fn)
            except Exception as e:
                self._latch_error(e)
                raise
        elif hasattr(data, "foreachPartition"):  # Spark RDD
            if retry_policy is not None:
                logger.info("retry_policy ignored for RDD data: Spark "
                            "retries failed tasks itself")
            self._feed_or_latch(data, fn)
        else:
            # Retries rebuild the closure from the CURRENT roster: after a
            # replacement admission the dead node's cluster_info entry is
            # gone and the replacement's (new executor id, new manager
            # address) is in — a stale closure could not route a partition
            # that lands on the replacement executor.
            def _fn_factory():
                return node.train(self.cluster_info, self.cluster_meta,
                                  qname, feed_timeout, chunk_size,
                                  max(num_epochs, 1))

            self._feed_or_latch(list(data), fn, retry_policy, _fn_factory)

    def _feed_or_latch(self, partitions, fn, retry_policy=None,
                       fn_factory=None):
        """Dispatch a feed job; a failure (user-code error OR a consumer
        that died without one — e.g. OOM-killed, surfaced as the feeder's
        feed_timeout) is latched into ``tf_status`` so a later
        ``shutdown()`` still exits non-zero (reference ``tf_status``
        error propagation, ``TFCluster.py:177-181``)."""
        try:
            if retry_policy is not None:
                self._dispatch_with_retry(partitions, fn, retry_policy,
                                          fn_factory)
            else:
                self.backend.foreach_partition(partitions, fn)
        except Exception as e:
            self._latch_error(e)
            raise

    def _await_replacement(self, timeout=30):
        """After a node death, give the elastic replacement a bounded window
        to claim the freed slot and re-complete the roster, then refresh
        ``cluster_info`` in place.  Returns True if the roster changed (a
        retry must rebuild its feed closure); an unfilled roster just means
        the retry shrinks onto the survivors — PR-1 semantics."""
        with telemetry_mod.get_tracer().span(
                "cluster/replacement_wait", timeout_secs=timeout):
            refilled = self.server.reservations.wait(timeout=timeout)
        if not refilled:
            logger.warning(
                "no replacement admitted within %.0fs (released slots: %s); "
                "retrying on the surviving nodes only", timeout,
                self.server.reservations.released_slots())
        info = self.server.reservations.get()
        info.sort(key=node._sort_key)
        changed = info != self.cluster_info
        if changed:
            self.cluster_info[:] = info
            logger.info(
                "roster refreshed at generation %d: %s",
                self.server.reservations.generation,
                [(n["job_name"], n["task_index"], n["executor_id"])
                 for n in info])
        return changed

    def _dispatch_with_retry(self, partitions, fn, policy, fn_factory=None):
        """Supervised feed dispatch: wait for the job to SETTLE (every task
        terminal — retrying while a sibling is still feeding would
        double-ship its partition), then re-dispatch only the failed
        partitions, with the policy's backoff, while every failure stays
        retryable and attempts remain.  When the liveness monitor admitted a
        replacement node in the meantime, the retry waits for its admission
        and re-dispatches onto the refreshed roster — failed partitions land
        on the replacement (or the survivors) instead of only shrinking."""
        if not getattr(self.backend, "supports_task_retry", False):
            # Job-level backends (Spark) can't observe per-partition task
            # outcomes, and re-running the whole job would double-feed the
            # partitions that succeeded; Spark's own task retries cover
            # these deployments.
            logger.info("backend %s has no per-task outcome visibility; "
                        "dispatching unsupervised",
                        type(self.backend).__name__)
            self.backend.foreach_partition(partitions, fn)
            return
        tracer = telemetry_mod.get_tracer()
        parts = list(partitions)
        pending = list(range(len(parts)))  # indices into parts
        for attempt in range(policy.max_attempts):
            with tracer.span("cluster/dispatch", attempt=attempt + 1,
                             partitions=len(pending)):
                handle = self.backend.foreach_partition_async(
                    [parts[i] for i in pending], fn)
                handle.wait_settled()
                failed = handle.failed_tasks()
            if not failed:
                return
            errors = [e for _, e in failed]
            fatal = [e for e in errors if not policy.is_retryable(e)]
            if fatal or attempt + 1 >= policy.max_attempts:
                raise RuntimeError("feed job failed{}:\n{}".format(
                    "" if fatal else
                    " after {} attempts".format(policy.max_attempts),
                    (fatal or errors)[0]))
            delay = policy.backoff(attempt)
            logger.warning(
                "feed job: %d of %d partition task(s) failed retryably; "
                "retrying in %.1fs (attempt %d/%d). First error:\n%s",
                len(failed), len(pending), delay, attempt + 2,
                policy.max_attempts, errors[0])
            tracer.instant("cluster/retry", attempt=attempt + 1,
                           failed=len(failed), delay_secs=delay)
            time.sleep(delay)
            if (self.tf_status.get("dead_nodes")
                    and self._await_replacement()
                    and fn_factory is not None):
                fn = fn_factory()
            pending = [pending[i] for i, _ in failed]
        raise AssertionError("unreachable")  # pragma: no cover

    def _latch_error(self, exc):
        if "error" not in self.tf_status:
            self.tf_status["error"] = "{}: {}".format(
                type(exc).__name__, exc)

    def metrics_snapshot(self):
        """Per-node feed-plane counters carried by heartbeats, plus the
        cluster-wide aggregate (``_hwm``/``_max`` keys merge by max, the
        rest sum).  Live while the cluster runs; ``shutdown()`` latches the
        final snapshot into ``tf_status["telemetry"]``."""
        return self.server.metrics_snapshot()

    def _latch_telemetry(self):
        """Latch the final metrics aggregate into ``tf_status`` and flush
        the driver's trace buffer.  Runs on every shutdown path, including
        the error exits — a failed run's timeline is the one you want."""
        try:
            snap = self.server.metrics_snapshot()
            if snap.get("nodes"):
                self.tf_status.setdefault("telemetry", snap)
                # slow-request exemplars ride serving heartbeats; latch the
                # cluster-wide worst offenders so a finished run still names
                # the requests that blew its tail latency
                from tensorflowonspark_torch import observatory as obs_mod

                slow = obs_mod.collect_slow(snap)
                if slow:
                    self.tf_status.setdefault("serving_slow", slow)
        except Exception:
            logger.debug("telemetry latch failed", exc_info=True)
        if self.remediator is not None:
            # stop the action plane before every other controller: its
            # spawned subprocesses must drain while the roster they talk
            # to still exists, and the action tallies belong in tf_status
            # next to the telemetry latch
            try:
                self.remediator.stop()
                counts = self.remediator.action_counts()
                if counts:
                    self.tf_status.setdefault("remediations", counts)
            except Exception:
                logger.debug("remediator stop failed", exc_info=True)
            telemetry_mod.unregister_flight_source("remediations")
        if self.autopilot is not None:
            # stop the controller before the rule engine that feeds it
            # hints: the final journal snapshot and the action tallies
            # belong in tf_status next to the telemetry latch
            try:
                self.autopilot.stop()
                counts = self.autopilot.action_counts()
                if counts:
                    self.tf_status.setdefault("autopilot", counts)
            except Exception:
                logger.debug("autopilot stop failed", exc_info=True)
        if self.watchtower is not None:
            # stop the rule engine first: its final tick + journal flush
            # must see the closing metrics, and the alert tallies belong in
            # tf_status next to the telemetry latch
            try:
                self.watchtower.stop()
                counts = self.watchtower.alert_counts()
                if counts:
                    self.tf_status.setdefault("alerts", counts)
            except Exception:
                logger.debug("watchtower stop failed", exc_info=True)
            telemetry_mod.unregister_flight_source("sample_ring_tail")
            telemetry_mod.unregister_flight_source("alerts")
        if self.observatory is not None:
            # exporter outlives the nodes (scrapes tolerate node death) but
            # not the cluster handle; stop is idempotent across the several
            # shutdown paths that reach this latch
            try:
                self.observatory.stop()
            except Exception:
                logger.debug("observatory stop failed", exc_info=True)
        telemetry_mod.get_tracer().flush()

    def inference(self, data, qname="input", chunk_size=1024):
        """Feed data for inference, returning per-item results (reference
        ``TFCluster.py:94-113``).  Results preserve partition order; the
        1:1 item/result contract is enforced by the node feeder."""
        logger.info("Feeding inference data")
        assert self.input_mode == InputMode.SPARK, \
            "inference() feeding requires InputMode.SPARK"
        fn = node.inference(self.cluster_info, self.cluster_meta, qname,
                            chunk_size=chunk_size)
        try:
            results = self.backend.map_partitions(data, fn)
            if hasattr(results, "collect"):  # Spark path returns an RDD-like
                return results
            return [item for part in results if part for item in part]
        except Exception as e:
            self._latch_error(e)
            raise

    # -- lifecycle --------------------------------------------------------

    def shutdown(self, ssc=None, grace_secs=0, timeout=259200):
        """Stop the cluster and surface any node errors (reference
        ``TFCluster.py:115-200``).

        For Spark Streaming apps pass ``ssc``: blocks in an
        ``awaitTerminationOrTimeout`` loop until an external STOP reaches
        the reservation server, then stops the StreamingContext gracefully
        (reference ``TFCluster.py:145-151``).
        For FILES mode, waits for worker node tasks to finish their user fn
        first (reference statusTracker polling, ``TFCluster.py:152-167``).
        Exits the driver with status 1 if any node raised (reference
        ``TFCluster.py:177-181``) — fail-fast, so schedulers notice.
        """
        logger.info("Stopping cluster")
        # Shutdown must target the LIVE roster: an elastic replacement (or a
        # remediator eviction) may have swapped an executor since launch, and
        # poisoning through the stale entry would schedule the shutdown task
        # on an executor whose cluster_info row no longer matches its manager.
        try:
            info = self.server.reservations.get()
            info.sort(key=node._sort_key)
            if info != self.cluster_info:
                self.cluster_info[:] = info
                logger.info(
                    "shutdown targeting refreshed roster (generation %d)",
                    self.server.reservations.generation)
        except Exception:
            pass  # reservation server already gone; fall back to the snapshot
        timer = None
        if timeout > 0 and threading.current_thread() is threading.main_thread():
            # Watchdog so a hung node cannot wedge the driver forever
            # (reference SIGALRM watchdog, TFCluster.py:134-142).
            def _watchdog(signum, frame):
                logger.error("shutdown timeout after %ds; exiting", timeout)
                self.backend.stop()
                sys.exit(1)

            signal.signal(signal.SIGALRM, _watchdog)
            signal.alarm(timeout)
            timer = True

        ps_like = [n for n in self.cluster_info
                   if n["job_name"] in ("ps", "evaluator")]
        workers = [n for n in self.cluster_info
                   if n["job_name"] in ("chief", "master", "worker")]

        if ssc is not None:
            # Spark Streaming: keep the context alive until a STOP arrives
            # at the reservation server (external stop CLI or a node's
            # request_stop), then stop it gracefully (reference
            # TFCluster.py:145-151).
            while not ssc.awaitTerminationOrTimeout(1):
                if self.server.done:
                    logger.info("STOP received; stopping StreamingContext")
                    ssc.stop(stopSparkContext=False, stopGraceFully=True)
                    break

        if self.input_mode == InputMode.FILES:
            # Workers run the user fn inline in their start task; wait for
            # those tasks to complete before poisoning queues (reference
            # active-task polling, TFCluster.py:152-167).
            num_worker_tasks = len(workers)
            while not self.start_job.done():
                if self.start_job.error:
                    break
                if self.start_job._completed >= num_worker_tasks:
                    break  # all worker tasks returned; only ps-like still parked
                time.sleep(1)

        # Poison each worker's queues via a shutdown job; tasks land on free
        # (worker) executors since ps-like executors stay parked (reference
        # SPARK JOB #3, TFCluster.py:172-174).  Task placement is not
        # guaranteed, so each task reports the node it reached and we retry
        # until every worker node confirms (poisoning is idempotent).
        fn = node.shutdown(self.cluster_info, self.cluster_meta,
                           queues=self.queues, grace_secs=grace_secs)
        worker_ids = {n["executor_id"] for n in workers}
        covered = set()
        for attempt in range(3):
            pending = sorted(worker_ids - covered)
            if not pending:
                break
            try:
                results = self.backend.map_partitions(
                    [[i] for i in pending], fn,
                    timeout=grace_secs + 120)
                for part in results:
                    if part:
                        covered.add(part[0])
            except (RuntimeError, TimeoutError) as e:
                self._latch_error(e)  # first error wins: keep the root cause
                break
        else:
            missing = sorted(worker_ids - covered)
            if missing and "error" not in self.tf_status:
                # Distinguish "finished already" (benign: poisoning found no
                # node because the node completed and stopped) from a
                # VANISHED executor.  Probe each unconfirmed node's manager:
                # a reachable manager reporting finished/stopped is fine;
                # anything else means the executor died without reporting —
                # fail loudly like the reference (TFCluster.py:177-181),
                # not a warning + exit 0 a scheduler would read as success.
                from tensorflowonspark_torch import util as util_mod

                by_id = {n["executor_id"]: n for n in workers}
                driver_ip = util_mod.get_ip_address()
                dead, unknown = [], []
                for i in missing:
                    n = by_id[i]
                    state = None
                    try:
                        from tensorflowonspark_torch import manager as mgr_mod

                        m = mgr_mod.connect(n["addr"],
                                            bytes.fromhex(n["authkey"]))
                        state = m.get("state")
                    except Exception:
                        pass
                    if state in ("finished", "stopped"):
                        logger.info("node %d already %s; shutdown coverage "
                                    "not needed", i, state)
                        continue
                    if state is not None:
                        # The probe SUCCEEDED and the node is still live:
                        # a shutdown-coverage gap, not a dead executor —
                        # don't latch a fatal error.  'terminating' means
                        # the poison marker WAS seen (the node is draining
                        # but its result never reached the driver);
                        # 'running' means the marker never landed.
                        if state == "terminating":
                            logger.warning(
                                "node %d saw the poison marker and is still "
                                "draining (state=terminating); its shutdown "
                                "result never reached the driver", i)
                        else:
                            logger.warning(
                                "node %d alive but unresponsive to shutdown "
                                "(state=%s); its queue never saw a poison "
                                "marker — check feed partitioning", i, state)
                        continue
                    # A failed probe is only AUTHORITATIVE when the driver
                    # could have reached the manager at all: worker managers
                    # are same-host unix sockets (node.py mode='local'), so
                    # from a remote driver an unreachable socket proves
                    # nothing about the executor.
                    authoritative = (isinstance(n["addr"], (tuple, list))
                                     or n.get("host") == driver_ip)
                    (dead if authoritative else unknown).append((i, state))
                if unknown:
                    logger.warning(
                        "could not confirm shutdown of remote nodes %s and "
                        "their managers are not driver-reachable; check the "
                        "executor logs", [i for i, _ in unknown])
                if dead:
                    self._latch_error(RuntimeError(
                        "worker nodes never confirmed shutdown and are not "
                        "finished: {} (executor died or is unreachable)"
                        .format(["node {} state={}".format(i, s)
                                 for i, s in dead])))

        if "error" in self.tf_status:
            logger.error("cluster failed: %s", self.tf_status["error"])
            self._latch_telemetry()
            self.backend.stop()
            if timer:
                signal.alarm(0)
            sys.exit(1)

        # Stop ps-like nodes: the driver reaches their remote managers
        # directly and signals their control queues (reference
        # TFCluster.py:186-192).
        for n in ps_like:
            try:
                from tensorflowonspark_torch import manager as mgr_mod

                m = mgr_mod.connect(n["addr"], bytes.fromhex(n["authkey"]))
                ctrl = m.get_queue("control")
                ctrl.put(None, block=True)
                ctrl.join()
            except Exception:
                logger.warning("failed to signal %s:%d for shutdown",
                               n["job_name"], n["task_index"], exc_info=True)

        # Wait for the start job to fully drain (reference TFCluster.py:195-200).
        try:
            self.start_job.wait(timeout=max(grace_secs, 60))
        except TimeoutError:
            logger.warning("start job did not fully drain; continuing shutdown")
        except RuntimeError as e:
            logger.error("cluster failed: %s", e)
            self._latch_telemetry()
            if timer:
                signal.alarm(0)
            sys.exit(1)

        if timer:
            signal.alarm(0)
        self._latch_telemetry()
        self.server.stop()
        logger.info("cluster stopped")

    def profiler_addresses(self):
        """``host:port`` of each node's profiler capture endpoint
        (``cluster.run(..., profiler=True)``): ``GET
        http://<address>/capture?duration_ms=`` answers with a gzipped
        Chrome trace of that node's process."""
        return ["{}:{}".format(n["host"], n["profiler_port"])
                for n in self.cluster_info if n.get("profiler_port")]

    def tensorboard_url(self):
        """URL of the cluster-managed TensorBoard, if launched (reference
        ``TFCluster.py:202-207``)."""
        for n in self.cluster_info:
            if n.get("tb_port"):
                return "http://{}:{}".format(n["host"], n["tb_port"])
        return None


def run(cluster_backend, map_fun, tf_args, num_executors=None, num_ps=0,
        tensorboard=False, input_mode=InputMode.FILES, log_dir=None,
        master_node=None, reservation_timeout=600,
        queues=("input", "output", "error"), eval_node=False,
        release_port=True, profiler=False, executor_env=None,
        driver_ps_nodes=False, heartbeat_interval=5.0, heartbeat_misses=3,
        telemetry=False, telemetry_dir=None, data_service=None,
        observatory=False, observatory_port=0, watchtower=None,
        autopilot=False, remediator=False, compile_cache_dir=None):
    """Start a cluster: one long-running node task per executor (reference
    ``TFCluster.py:210-378``).

    Args:
      cluster_backend: a :mod:`~tensorflowonspark_torch.backend` backend (or a
        ``SparkContext``, which is wrapped in a :class:`SparkBackend`).
      map_fun: user function ``fn(args, ctx)`` run on every node.
      tf_args: argparse Namespace or argv list for ``map_fun``.
      num_executors: cluster size (defaults to the backend's executor count).
      num_ps: number of long-running non-worker ("ps"-like) roles — kept for
        capability parity (reference async-PS mode, SURVEY §2.4); training
        itself is synchronous.
      driver_ps_nodes: run the ps roles in daemon threads ON THE DRIVER
        instead of occupying executors (reference ``TFCluster.py:291-309``) —
        small clusters then spend every executor on workers.  Requires
        ``num_ps > 0``; the backend only needs ``num_executors - num_ps``
        task slots.
      master_node: name for the chief role (``None`` → plain ``worker`` 0 is
        chief, reference ``TFCluster.py:225,257-258``).
      eval_node: dedicate one node as ``evaluator`` (reference ``TFCluster.py:228``).
      input_mode: :class:`InputMode`.
      executor_env: env vars every node applies BEFORE any CUDA
        initialization — CUDA/NCCL knobs travel here (the analog of the
        reference's GPU-thread tuning, reference ``common.py:143-166``).
      heartbeat_interval: seconds between node liveness beats to the
        reservation server (0 disables monitoring).  A node silent for
        ``heartbeat_interval * heartbeat_misses`` seconds is declared dead:
        its identity lands in ``tf_status['dead_nodes']``, a blocked
        ``await_reservations`` aborts immediately, and the executor is
        fenced off from further feed-task scheduling (built-in backend).
      heartbeat_misses: missed beats tolerated before declaring death.
      telemetry: enable the cluster-wide telemetry plane (lifecycle span
        traces, heartbeat-carried feed counters, hang flight recorder).
        Off by default: when False no telemetry files are written and the
        instrumentation reduces to no-op calls on a null tracer.
      telemetry_dir: directory for per-process trace/flight files
        (default: ``<log_dir>/telemetry``, or ``./telemetry`` without a
        log_dir).  See docs/OBSERVABILITY.md.
      profiler: serve a trace-capture endpoint from each training node's
        user-fn process (``profiler.start_server``; ``GET
        /capture?duration_ms=&steps=`` answers with a gzipped Chrome
        trace) and publish its port in the roster
        (:meth:`TPUCluster.profiler_addresses`).
      observatory: start the driver-side HTTP observatory — ``/metrics``
        (Prometheus text exposition), ``/status`` (JSON ``tf_status`` +
        metrics snapshot, the profiler addresses and the last capture),
        ``/profile?duration_ms=&steps=`` (a cluster-wide trace capture
        fanned out on heartbeat replies, landing under
        ``<log_dir>/profiles/<capture_id>/``) and ``/slow``; per-node
        counter samples are kept in a bounded ring so the exporter also
        derives ``*_per_sec`` rates.  The address lands on
        ``cluster.observatory.addr``.  With telemetry off, nodes send bare
        beats and the exporter mostly shows ``tfos_nodes``: enable both.
      observatory_port: TCP port for the observatory (0 = ephemeral).
      watchtower: streaming straggler/anomaly detection over the
        observatory's sample ring (see
        :mod:`~tensorflowonspark_torch.watchtower`): ``None`` (default)
        enables it whenever the observatory is on, ``False`` disables it,
        a dict overrides rule thresholds key-wise (see
        ``watchtower.DEFAULT_CONFIG``).  Alerts surface on ``GET
        /alerts``, as ``tfos_alerts_total`` on ``/metrics``, as
        ``watchtower/alert`` trace instants, and in the append-only JSONL
        journal at ``<log_dir>/watchtower/journal.jsonl`` (replayable
        offline via ``scripts/metrics_replay_torch.py``).  Suspect-node
        verdicts land in ``tf_status["suspects"]``.
      autopilot: closed-loop performance controller over the observatory's
        sample ring (see :mod:`~tensorflowonspark_torch.autopilot`;
        requires ``observatory=True``): ``False`` (default) off, ``True``
        on with defaults, a dict overrides controller/knob settings
        key-wise (see ``autopilot.DEFAULT_CONFIG``; ``{"dry_run": True}``
        journals proposals without actuating).  Actuation rides the
        heartbeat-reply channel into per-node live setters (infeed
        prefetch depth, K steps a dispatch, gateway batching).  Every
        action is journaled to ``<log_dir>/autopilot/journal.jsonl`` and
        surfaces on ``GET /autopilot`` plus ``tfos_autopilot_*`` counters
        on ``/metrics``.
      remediator: topology action plane over admitted watchtower alerts
        (see :mod:`~tensorflowonspark_torch.remediator`; requires
        ``observatory=True`` and the watchtower): ``False`` (default) off,
        ``True`` on with defaults, a dict overrides key-wise (see
        ``remediator.DEFAULT_CONFIG``; ``{"dry_run": True}`` journals
        proposals without actuating).  Persistent stragglers are fenced
        and replaced (graceful node-side SIGTERM drain + elastic slot
        re-admission; SPARK mode), ``nonfinite`` crits roll training back
        to the last finite checkpoint (poisoned steps quarantined as
        ``<step>.corrupt``); the scale-out families stay unarmed unless
        their spawn argv is given.  Every action is journaled to
        ``<log_dir>/remediator/journal.jsonl`` and surfaces on ``GET
        /remediations`` plus ``tfos_remediation_actions_total`` on
        ``/metrics``; final tallies latch into
        ``tf_status["remediations"]``.
      data_service: dispatcher address of a disaggregated data service
        (``"host:port"``, ``(host, port)``, or a ``{"dispatcher": addr}``
        dict, where ``addr`` may be a list: the primary first, then warm
        standbys; an optional ``"codecs"`` list pins the wire compression
        the consumers offer) — executors then read input over the network
        via ``ctx.get_service_feed(...)`` instead of reading files locally
        (:mod:`~tensorflowonspark_torch.dataservice`).
      compile_cache_dir: warm-start compile plane
        (:mod:`~tensorflowonspark_torch.compilecache`): every node makes
        this cluster-shared directory its compile root before its user fn
        touches CUDA, so the kernel libraries build once into
        ``<dir>/kernels`` and an elastic replacement node (which re-runs
        the same start closure) loads them instead of running ``nvcc`` —
        ``tfos_compile_cache_hit`` counts the saves on ``/metrics``.  Falls
        back to the ``TFOS_COMPILE_CACHE_DIR`` env var; None with no env
        leaves the compile plane off.
    """
    if hasattr(cluster_backend, "parallelize"):  # raw SparkContext
        cluster_backend = backend_mod.SparkBackend(cluster_backend)
    num_executors = num_executors or cluster_backend.num_executors

    tdir = None
    if telemetry:
        tdir = os.path.abspath(
            telemetry_dir or os.path.join(log_dir or ".", "telemetry"))
    tracer = telemetry_mod.configure(telemetry, tdir)
    telemetry_mod.install_sigusr1()

    # Role template: {job_name: [executor_ids]} (reference TFCluster.py:250-264).
    num_workers = num_executors - num_ps - (1 if eval_node else 0)
    if num_workers <= 0:
        # ValueError, not assert: this guards USER configuration, and an
        # assert vanishes under ``python -O`` (the roster would then wedge
        # the rendezvous with zero workers ever registering).
        raise ValueError(
            "num_executors={} leaves no workers after num_ps={} eval_node={}".format(
                num_executors, num_ps, eval_node))
    executors = list(range(num_executors))
    cluster_template = {}
    if num_ps > 0:
        cluster_template["ps"] = executors[:num_ps]
        del executors[:num_ps]
    if eval_node:
        cluster_template["evaluator"] = executors[:1]
        del executors[:1]
    if master_node is None:
        cluster_template["worker"] = executors
    else:
        cluster_template[master_node] = executors[:1]
        if len(executors) > 1:
            cluster_template["worker"] = executors[1:]
    logger.info("cluster template: %s", cluster_template)

    # Shared driver-side status dict: async start-job failures land in
    # 'error' (fatal); the liveness monitor appends to 'dead_nodes'
    # (recoverable — a supervised retry may complete the run regardless);
    # replacement admissions land in 'replacements'; clean BYE reasons
    # ('done' / 'preempted') land in 'byes' keyed by executor id.
    tf_status = {}

    # The replacement path needs the start-task closure, which is built
    # AFTER the server (the closure captures cluster_meta, which carries the
    # server address) — a mutable cell bridges the ordering.
    elastic = {"start_fn": None}

    def _request_replacement(meta):
        """Elastic recovery: release the dead node's roster slot and spawn a
        fresh executor into it (built-in backend).  Returns True when a
        replacement was dispatched; False leaves the PR-1 semantics (fence
        only, roster abort on bring-up death) untouched."""
        start_fn = elastic.get("start_fn")
        if (start_fn is None
                or not getattr(cluster_backend, "supports_replacement", False)
                or meta.get("executor_id") is None
                or meta.get("job_name") is None):
            return False
        released = server.release_slot(meta["executor_id"])
        if released is None:
            return False  # died before registering: nothing to reclaim
        try:
            with tracer.span("cluster/replacement_provision",
                             dead_executor=meta["executor_id"],
                             job_name=released["job_name"],
                             task_index=released["task_index"]):
                new_index = cluster_backend.provision_replacement()
                handle = cluster_backend.run_on(
                    new_index, start_fn,
                    [{"executor_id": new_index,
                      "job_name": released["job_name"],
                      "task_index": released["task_index"]}])
        except Exception:
            logger.exception("replacement provisioning failed; the run "
                             "continues on the surviving nodes")
            return False
        desc = "executor {} replaces {} as {}:{}".format(
            new_index, meta["executor_id"], released["job_name"],
            released["task_index"])
        tf_status.setdefault("replacements", []).append(desc)
        logger.warning("elastic recovery: %s", desc)
        tracer.instant("cluster/replacement_dispatched",
                       new_executor=new_index,
                       dead_executor=meta["executor_id"],
                       job_name=released["job_name"],
                       task_index=released["task_index"])

        def _watch():
            try:
                handle.wait_settled(timeout=reservation_timeout)
            except Exception:
                pass
            failed = handle.failed_tasks()
            if failed:
                logger.error("replacement start task failed:\n%s",
                             failed[0][1])
                tf_status.setdefault("replacement_errors", []).append(
                    failed[0][1])

        threading.Thread(target=_watch, name="replacement-watch",
                         daemon=True).start()
        return True

    def _on_dead(meta, age):
        desc = ("node {}:{} (executor {}) on {} declared dead after {:.1f}s "
                "of heartbeat silence").format(
                    meta.get("job_name", "?"), meta.get("task_index", "?"),
                    meta.get("executor_id", "?"), meta.get("host", "?"), age)
        tf_status.setdefault("dead_nodes", []).append(desc)
        tracer.instant("cluster/node_dead",
                       executor_id=meta.get("executor_id"),
                       job_name=meta.get("job_name"),
                       task_index=meta.get("task_index"),
                       age_secs=round(age, 3))
        if (hasattr(cluster_backend, "exclude")
                and meta.get("executor_id") is not None):
            cluster_backend.exclude(meta["executor_id"])
        _request_replacement(meta)

    def _on_bye(executor_id, reason):
        tf_status.setdefault("byes", {})[str(executor_id)] = reason

    # Rendezvous server (reference TFCluster.py:277-279) + liveness monitor.
    server = reservation.Server(num_executors,
                                heartbeat_interval=heartbeat_interval,
                                heartbeat_misses=heartbeat_misses,
                                on_dead=_on_dead, on_bye=_on_bye)
    server_addr = server.start()

    obs = None
    profiling_coord = None
    wt = None
    pilot = None
    rem = None
    if autopilot and not observatory:
        raise ValueError("autopilot= requires observatory=True: the "
                         "controller reads the observatory's sample ring")
    if remediator and not observatory:
        raise ValueError("remediator= requires observatory=True: the action "
                         "plane consumes the watchtower's admitted alerts")
    if remediator and watchtower is False:
        raise ValueError("remediator= requires the watchtower: its admitted "
                         "alerts ARE the detect half of the detect→act loop")
    if observatory:
        from tensorflowonspark_torch import observatory as observatory_mod
        from tensorflowonspark_torch import profiling as profiling_mod

        # Sample ring first: the server records a timestamped copy of each
        # node's folded counters on every metrics-bearing beat, so the
        # exporter can derive rates; the HTTP endpoint reads only through
        # snapshot callables (copies), so scrapes are safe mid-run and
        # mid-node-death.
        ring = observatory_mod.SampleRing()
        server.sample_ring = ring
        # On-demand trace captures: GET /profile fans out through the
        # heartbeat channel and artifacts land under <log_dir>/profiles.
        profiling_coord = profiling_mod.CaptureCoordinator(
            server, os.path.abspath(
                os.path.join(log_dir or ".", "profiles")))
        server.profile_coordinator = profiling_coord

        if autopilot:
            from tensorflowonspark_torch import autopilot as autopilot_mod

            # Actuation plane: knob pushes fan out through the
            # heartbeat-reply channel — each node drains its unseen pushes
            # exactly once per beat and applies the namespaced knobs its
            # registered feeds claim (node.apply_knobs); unclaimed names
            # are ignored, so one broadcast serves trainers, feeds and
            # gateways alike.  A journal-armed server may already have
            # rebuilt the coordinator during recovery — reuse it so the
            # fleet's standing knob state survives the coordinator death.
            if server.knob_coordinator is None:
                server.knob_coordinator = reservation.KnobCoordinator()
            ap_config = dict(autopilot) if isinstance(autopilot, dict) else {}
            ap_knobs = {k: dict(v)
                        for k, v in (ap_config.get("knobs") or {}).items()}
            ap_knobs.setdefault("infeed_prefetch", {})
            if "initial" not in ap_knobs["infeed_prefetch"]:
                # seed the controller with the fleet's actual starting depth
                # so the first retune doubles from reality, not a guess
                try:
                    ap_knobs["infeed_prefetch"]["initial"] = max(
                        int(os.environ.get("TFOS_INFEED_PREFETCH", "2")), 1)
                except ValueError:
                    ap_knobs["infeed_prefetch"]["initial"] = 2
            ap_config["knobs"] = ap_knobs
            # push_knobs (not the bare KnobCoordinator.push) journals each
            # retune when the server is journal-armed; resume_values
            # re-seeds the controller from the recovered push history.
            pilot = autopilot_mod.Autopilot(
                ring, actuator=server.push_knobs,
                snapshot_fn=server.metrics_snapshot,
                config=ap_config,
                journal_path=os.path.abspath(os.path.join(
                    log_dir or ".", "autopilot", "journal.jsonl")),
                resume_values=server.knob_coordinator.current())
            pilot.start()
            logger.info("autopilot engaged (dry_run=%s), journal at %s",
                        pilot.config["dry_run"], pilot.journal_path)

        if remediator:
            from tensorflowonspark_torch import remediator as remediator_mod

            def _evict_straggler(executor, alert):
                # Fence + replace, in dependency order: the evict command
                # is queued FIRST (the node drains it from its next beat
                # reply and SIGTERMs itself — graceful feed drain, chief
                # emergency checkpoint, BYE), then the driver releases the
                # roster slot, excludes the executor backend-side, and
                # dispatches a replacement into the freed slot.  The
                # released node keeps beating until its drain completes
                # (only *dead* executors are fenced from the beat
                # channel), so the command always reaches it; its BYE
                # later pops the beat entry, so no death is declared and
                # no second replacement fires.
                try:
                    eid = int(executor)
                except (TypeError, ValueError):
                    eid = executor
                meta = server.reservations.find(eid)
                if meta is None:
                    raise RuntimeError(
                        "executor {} holds no reservation".format(executor))
                token = "evict-{}-{}".format(eid, int(time.time() * 1000))
                server.push_knobs({"remediator_evict": token},
                                  executor_id=eid)
                if hasattr(cluster_backend, "exclude"):
                    cluster_backend.exclude(eid)
                replaced = _request_replacement(meta)
                return {"executor": eid, "token": token,
                        "replaced": bool(replaced),
                        "job_name": meta.get("job_name"),
                        "task_index": meta.get("task_index")}

            def _rollback_poison(executor, alert):
                # Broadcast, not targeted: every trainer honours the
                # rollback — the chief's restore quarantines the poisoned
                # step(s); workers re-restore the same validated step.
                token = "rollback-{}".format(int(time.time() * 1000))
                server.push_knobs({"train_rollback": token})
                ev = (alert or {}).get("evidence") or {}
                return {"token": token,
                        "train_steps_total": ev.get("train_steps_total")}

            rem = remediator_mod.Remediator(
                ring,
                actions={"evict": _evict_straggler,
                         "rollback": _rollback_poison},
                snapshot_fn=server.metrics_snapshot,
                config=(dict(remediator) if isinstance(remediator, dict)
                        else None),
                journal_path=os.path.abspath(os.path.join(
                    log_dir or ".", "remediator", "journal.jsonl")))
            rem.start()
            logger.info("remediator engaged (dry_run=%s), journal at %s",
                        rem.dry_run, rem.journal_path)

        def _profiler_addresses():
            # lazy: the observatory starts before the roster exists, and the
            # roster can change on replacement admission
            return ["{}:{}".format(m.get("host"), m.get("profiler_port"))
                    for m in server.reservations.get()
                    if isinstance(m, dict) and m.get("profiler_port")]

        if watchtower is not False:
            from tensorflowonspark_torch import watchtower as watchtower_mod

            def _on_suspect(executor, alert):
                # the elastic-recovery plane's consumption point: verdicts
                # accumulate here next to dead_nodes/replacements
                tf_status.setdefault("suspects", {})[str(executor)] = (
                    alert.get("rule"))

            # Admitted alerts fan out to every consumer plane: the
            # autopilot treats them as retune hints, the remediator as
            # triggers for topology actions.
            _alert_sinks = [s for s in (
                pilot.observe_alert if pilot is not None else None,
                rem.observe_alert if rem is not None else None)
                if s is not None]

            def _fan_alert(alert):
                for sink in _alert_sinks:
                    try:
                        sink(alert)
                    except Exception:
                        logger.warning("alert sink failed", exc_info=True)

            wt = watchtower_mod.Watchtower(
                ring=ring, snapshot_fn=server.metrics_snapshot,
                heartbeat_interval=heartbeat_interval,
                config=watchtower if isinstance(watchtower, dict) else None,
                journal_path=os.path.abspath(os.path.join(
                    log_dir or ".", "watchtower", "journal.jsonl")),
                on_suspect=_on_suspect, beat_ages_fn=server.beat_ages,
                coordinator_fn=server.ha_status,
                on_alert=(_fan_alert if _alert_sinks else None))
            wt.start()
            # Flight records (SIGUSR1 / stall dumps) now carry the metric
            # trajectory and alert log leading into the stall.
            telemetry_mod.register_flight_source("sample_ring_tail",
                                                 wt.ring_tail)
            telemetry_mod.register_flight_source("alerts", wt.alerts)
            if rem is not None:
                telemetry_mod.register_flight_source("remediations",
                                                     rem.actions)

        obs = observatory_mod.ObservatoryServer(
            server.metrics_snapshot, ring=ring,
            status_fn=lambda: tf_status, port=observatory_port,
            profile_fn=profiling_coord.trigger,
            profiler_addresses_fn=_profiler_addresses,
            capture_status_fn=profiling_coord.status,
            watchtower=wt, autopilot=pilot, remediator=rem,
            coordinator_fn=server.ha_status,
            beat_ages_fn=server.beat_ages)
        addr = obs.start()
        logger.info("observatory serving /metrics, /status, /profile, "
                    "/slow and /alerts at http://%s:%d", addr[0], addr[1])

    # Normalize the data-service spec to {"dispatcher": [host, port]} for
    # the JSON hop to executors (ctx.get_service_feed consumes it).  An
    # optional "codecs" preference list survives normalization so a driver
    # can pin the wire compression its consumers offer at dial.
    if data_service is not None:
        codecs = (data_service.get("codecs")
                  if isinstance(data_service, dict) else None)
        addr = (data_service.get("dispatcher")
                if isinstance(data_service, dict) else data_service)
        # "dispatcher" may be one endpoint or a LIST (primary first, warm
        # standbys at pinned ports after): a single endpoint keeps the
        # [host, port] JSON shape, a list becomes [[host, port], ...] —
        # ServiceFeed/FeedWorker normalize either and redial across the
        # list on a dispatcher failover.
        eps = reservation.normalize_endpoints(addr)
        if len(eps) == 1:
            data_service = {"dispatcher": [eps[0][0], int(eps[0][1])]}
        else:
            data_service = {"dispatcher": [[h, int(p)] for h, p in eps]}
        if codecs is not None:
            data_service["codecs"] = list(codecs)

    # Reservation-coordinator endpoint list for the nodes: the live
    # primary first, then any warm standbys at pre-agreed pinned ports
    # (TFOS_RS_STANDBY env: "host:port[,host:port...]").  Node-side
    # Client/HeartbeatSender redial across the list, so a coordinator
    # failover needs no re-broadcast of cluster_meta.
    server_addrs = [list(server_addr)]
    for part in (os.environ.get("TFOS_RS_STANDBY") or "").split(","):
        part = part.strip()
        if part:
            shost, _, sport = part.rpartition(":")
            server_addrs.append([shost, int(sport)])

    cluster_meta = {
        "id": "{:x}".format(random.getrandbits(64)),
        "cluster_template": cluster_template,
        "num_executors": num_executors,
        "default_fs": getattr(cluster_backend, "default_fs", "file://"),
        "server_addr": list(server_addr),
        "server_addrs": server_addrs,
        "authkey": uuid.uuid4().bytes.hex(),
        "reservation_timeout": reservation_timeout,
        "input_mode": input_mode,
        "executor_env": dict(executor_env or {}),
        "heartbeat_interval": heartbeat_interval,
        "telemetry": telemetry_mod.meta_spec(telemetry, tdir),
        "data_service": data_service,
        # the nodes warm their profiler where captures can come
        "profiling": bool(observatory or profiler),
        # Resolved here, where cluster.run is called (env fallback
        # included), so every node — and every future replacement — shares
        # one cache root even when only this process's environment names
        # it.
        "compile_cache_dir": (os.path.abspath(compile_cache_dir)
                              if compile_cache_dir
                              else os.environ.get(COMPILE_CACHE_DIR_ENV)),
    }
    tracer.instant("cluster/start", num_executors=num_executors,
                   input_mode=str(input_mode),
                   cluster_id=cluster_meta["id"])

    # Launch the start job in the background (reference daemon thread +
    # foreachPartition, TFCluster.py:312-329): SPARK-mode workers run the user
    # fn in a background process so their task returns and frees the slot for
    # feed jobs; FILES-mode workers hold the slot for the whole run.
    background = (input_mode == InputMode.SPARK)
    start_fn = node.run(map_fun, tf_args, cluster_meta, tensorboard=tensorboard,
                        log_dir=log_dir, queues=tuple(queues),
                        background=background, release_port=release_port,
                        profiler=profiler)
    # Replacement admission re-runs this same start closure on the fresh
    # executor (the role travels as an explicit assignment item, see
    # node.run) — SPARK-mode nodes run the user fn in a background child,
    # so a replacement can join mid-run without holding a task slot.
    if background:
        elastic["start_fn"] = start_fn
    if driver_ps_nodes:
        # ps roles run in driver daemon threads (reference
        # TFCluster.py:291-309): the backend's start job covers only the
        # worker executors, so every backend slot hosts a worker.
        assert num_ps > 0, "driver_ps_nodes requires num_ps > 0"
        start_ids = list(range(num_ps, num_executors))
        ps_fn = node.run(map_fun, tf_args, cluster_meta, log_dir=log_dir,
                         queues=tuple(queues), background=background,
                         release_port=release_port, driver_local=True)

        def _start_driver_ps(node_index):
            try:
                ps_fn(iter([node_index]))
            except Exception:
                logger.exception("driver-local ps %d failed", node_index)

        for i in cluster_template["ps"]:
            threading.Thread(target=_start_driver_ps, args=(i,),
                             name="driver-ps-{}".format(i),
                             daemon=True).start()
    else:
        start_ids = list(range(num_executors))
    start_parts = [[i] for i in start_ids]
    start_job = cluster_backend.foreach_partition_async(start_parts, start_fn)

    # Propagate async start-job failures into the reservation wait (reference
    # tf_status error flag, TFCluster.py:38,321-323 + reservation.py:117-120).
    def _monitor():
        while not start_job.done():
            if start_job.error:
                break
            time.sleep(0.5)
        if start_job.error:
            tf_status["error"] = start_job.error

    threading.Thread(target=_monitor, name="start-job-monitor", daemon=True).start()

    cluster_info = server.await_reservations(
        status=tf_status, timeout=reservation_timeout)
    cluster_info.sort(key=node._sort_key)
    logger.info("cluster nodes: %s",
                [(n["job_name"], n["task_index"], n["host"]) for n in cluster_info])
    tracer.instant("cluster/ready", nodes=len(cluster_info),
                   generation=server.reservations.generation)

    # Duplicate-node sanity check (reference TFCluster.py:350-365).
    seen = set()
    for n in cluster_info:
        key = (n["host"], n["executor_id"])
        if key in seen:
            raise Exception(
                "Duplicate cluster node on executor {} of host {}: executors "
                "must provide exactly one task slot each (disable dynamic "
                "allocation / over-subscription).".format(n["executor_id"], n["host"]))
        seen.add(key)

    return TPUCluster(cluster_backend, cluster_meta, cluster_info, input_mode,
                      server, start_job, tf_status, tuple(queues),
                      observatory=obs, profiling=profiling_coord,
                      watchtower=wt, autopilot=pilot, remediator=rem)
