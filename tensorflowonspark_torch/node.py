"""Per-executor node runtime (reference ``TFSparkNode.py``; the port's copy
of the JAX package's ``node`` module, with its jax places replaced by
``torch.distributed`` and ``torch.cuda``).

The functions here return closures that run as backend tasks on executors:

- :func:`run`       — the "start job" task: claim a role from the cluster
  template, start the per-executor manager, rendezvous with the driver's
  reservation server, derive the ``torch.distributed`` coordinates (the
  replacement for building ``TF_CONFIG``, reference
  ``TFSparkNode.py:264-286``), then invoke the user's
  ``main_fun(args, ctx)`` in the foreground (FILES-mode workers) or a
  background process (SPARK-mode workers, ps-like/evaluator roles).
- :func:`train` / :func:`inference` — "feed job" tasks that push partition
  data into the node's queues with backpressure (reference
  ``TFSparkNode.py:371-502``).
- :func:`shutdown`  — poisons the queues and surfaces late errors
  (reference ``TFSparkNode.py:505-559``).

Roles (cluster template job names, reference ``TFCluster.py:250-264``):
``'chief'`` / ``'master'`` (worker 0 with export duties), ``'worker'``,
``'ps'`` (long-running non-worker role parked on a control queue — kept for
capability parity even though training is synchronous), ``'evaluator'``.

CUDA and fork: the executor shell forks the manager server and, in SPARK
mode, the user-fn child.  Nothing here initializes CUDA (no
``torch.cuda.is_available()``, no device count, no tensor on a card): a
process that has initialized CUDA cannot hand it to a forked child.  The
first CUDA call belongs in the user's ``main_fun``, in the child.  An
executor that initialized CUDA itself (a ``TFModel.transform`` on the card
ran there) refuses to host a node: :func:`refuse_if_cuda_initialized`.
"""

import json
import logging
import multiprocessing
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import traceback
import weakref

from tensorflowonspark_torch import (fault, manager, marker, reservation,
                                   telemetry, util)

logger = logging.getLogger(__name__)

# Job names that join the shared torch.distributed world and get a
# process_id.  ps parks on a control queue and never trains.  The evaluator
# trains nothing either but runs in its OWN single-process world: it executes
# a different program than the workers (periodic eval over checkpoints,
# reference ``examples/mnist/estimator/mnist_tf.py:109-115``), and a process
# running a different program inside the workers' world would wedge every
# collective while inflating num_processes.
_DIST_JOBS = ("chief", "master", "worker")

# Executor-process-lifetime state (reference "TFSparkNode singleton holder",
# ``TFSparkNode.py:75-89``): keeps the manager handle referenced after the
# start task returns — BaseManager shuts its server down when the handle is
# garbage collected, and the node must outlive the start task in SPARK mode.
_node_state = {}

# Live per-process metrics sources (weakrefs): anything with a flat
# ``counters_snapshot() -> dict`` — DataFeeds (TPUNodeContext.get_data_feed),
# ShardedFeeds (infeed overlap tallies), Trainers (dispatch-gap tallies).
# The heartbeat metrics provider snapshots them so HBEAT payloads carry the
# counters without the source having to know about telemetry.
_feeds = []


def _register_feed(feed):
    """Register a metrics source for this node's heartbeats (weakref; dead
    sources are pruned on the next snapshot).  Idempotent: a source that
    registers on every fit call (the Trainer does, from ``fit_feed``) must
    not appear twice — heartbeat merges SUM across registry entries, so a
    duplicate would double-count its counters, and duplicate
    ``apply_knob`` hooks would double-ack knob pushes."""
    for ref in _feeds:
        if ref() is feed:
            return
    _feeds.append(weakref.ref(feed))


# Live-knob application tallies, merged into the heartbeat counters so the
# driver can see that its KNOB pushes actually landed on this node.
_knob_counters = {"autopilot_knobs_applied": 0}

# Remediator eviction tokens already honoured by this process.  The knob
# coordinator re-broadcasts a push on every heartbeat until drained, and the
# SIGTERM drain takes a couple hundred ms — without the dedupe a second beat
# reply could double-fire the timer.
_evict_tokens = set()


def _evict_self(token):
    """Fence honoured node-side: raise SIGTERM against our own process so
    the installed preemption drain runs (feed drain, chief emergency
    checkpoint, BYE goodbye) — the exact path a real preemption takes, so
    eviction inherits its guarantees.  The in-flight Spark feed task then
    fails retryably in the executor parent and PR 3's re-dispatch moves the
    partitions to surviving executors (exact totals preserved)."""
    logger.warning("remediator eviction (token %s): draining via SIGTERM",
                   token)
    telemetry.get_tracer().instant("remediator/evict_self", token=str(token),
                                   flush=True)
    try:
        os.kill(os.getpid(), signal.SIGTERM)
    except OSError:  # pragma: no cover - process already unwinding
        logger.exception("self-eviction signal failed")


def apply_knobs(knobs):
    """Apply a ``{knob: value}`` dict from an autopilot KNOB push to every
    live source in this process that understands it.

    The registry is the same weakref list the heartbeat metrics walk: any
    registered source exposing ``apply_knob(name, value) -> bool``
    (ShardedFeed, ServiceFeed, DataFeed) gets a chance at each knob; names
    nothing claims are ignored — a training node silently skips
    ``serving_*`` knobs and vice versa.  Returns the number of (source,
    knob) applications that took effect.

    ``remediator_evict`` is intercepted BEFORE the fan-out: it is a
    command to this process (fence + drain + exit), not a tunable any
    feed owns.  The value is a one-shot token (dedupe against heartbeat
    re-broadcast); a short timer lets the beat cycle ack the knob as
    drained before the SIGTERM lands."""
    knobs = dict(knobs or {})
    evict_token = knobs.pop("remediator_evict", None)
    applied = 0
    if evict_token is not None and str(evict_token) not in _evict_tokens:
        _evict_tokens.add(str(evict_token))
        applied += 1
        threading.Timer(0.2, _evict_self, args=(evict_token,)).start()
    for name, value in (knobs or {}).items():
        for ref in list(_feeds):
            feed = ref()
            if feed is None:
                continue
            hook = getattr(feed, "apply_knob", None)
            if hook is None:
                continue
            try:
                if hook(name, value):
                    applied += 1
            except Exception:
                logger.warning("apply_knob(%s) failed on %r", name, feed,
                               exc_info=True)
    if applied:
        _knob_counters["autopilot_knobs_applied"] += applied
        telemetry.get_tracer().instant("autopilot/knobs_applied",
                                       applied=applied,
                                       knobs=",".join(sorted(knobs)))
    return applied


def _knob_reply_handler(reply):
    """``HeartbeatSender(on_reply=...)`` hook: apply any live-knob update
    the driver piggybacked on the beat reply (exactly-once per push — the
    KnobCoordinator marks pushes drained at poll time)."""
    if isinstance(reply, dict) and reply.get("knobs"):
        apply_knobs(reply["knobs"])


#: set once this process's profiler preload has finished (or was not
#: needed): the node's beats start before the preload, so a capture asked
#: for on a beat reply meanwhile waits for it on the capture thread
_preload_done = threading.Event()


def _profile_handler(job_name):
    """The ``on_profile`` capture handler for this node's HeartbeatSender:
    the training roles run the trace captures fanned out on beat replies
    (:func:`profiling.handle_capture_request`) once the profiler preload
    has finished (a first profiler start on the capture thread during the
    preload's imports can deadlock them, see ``profiler.preload``); other
    roles get None — the driver never targets them."""
    if job_name not in _DIST_JOBS:
        return None
    from tensorflowonspark_torch import profiling

    def _handle(request):
        _preload_done.wait()
        return profiling.handle_capture_request(request)

    return _handle


def _hold_captures():
    """Hold this process's captures until :func:`_preload_profiler` has
    run: called before the node starts its beats.  (The node's nested
    functions are pickled by value, so they reach the event, which cannot
    be pickled, through module functions.)"""
    _preload_done.clear()


def _preload_profiler(profiling_on, role):
    """Where the driver can ask for captures (``profiling_on``), the process
    that runs the user fn warms the profiler on its main thread (see
    ``profiler.preload``).  Its beats already run; a capture that arrives
    meanwhile waits for :data:`_preload_done`, set here in every case."""
    try:
        if profiling_on and role in _DIST_JOBS:
            from tensorflowonspark_torch import profiler as prof_mod

            prof_mod.preload()
    finally:
        _preload_done.set()


def _imported(name):
    """True when module ``name`` has finished importing: a module whose
    import another thread is still running is in ``sys.modules`` already,
    and importing it from here would wait for that import to end."""
    module = sys.modules.get(name)
    return module is not None and not getattr(
        getattr(module, "__spec__", None), "_initializing", False)


def _node_metrics_provider(mgr, qname="input"):
    """Build the heartbeat metrics provider for this node's user-fn process.

    Merges (all flat JSON dicts; see telemetry.merge_counters):
    - shm-ring consumer-side tallies (this process attaches the rings);
    - every live DataFeed's counters (rows, stall time, wire formats);
    - feeder-side counters published to the manager KV by feed tasks
      (they run in a different process — the executor shell);
    - the input queue's depth high-water mark, sampled per beat.

    Every leg is individually guarded: metrics must never cost a beat.
    """
    hwm = {"queue_depth_hwm": 0}

    def _provider():
        from tensorflowonspark_torch import shmring

        # Telemetry off: beats stay bare and the driver latches nothing —
        # tf_status["telemetry"] is part of the opt-in plane, not a default.
        # While the profiler warms, the beats only say the node is alive:
        # counters of a node that cannot train yet would read as idle
        # windows to the watchtower's rules.
        if not telemetry.get_tracer().enabled or not _preload_done.is_set():
            return None
        parts = [shmring.counters_snapshot()]
        if _knob_counters["autopilot_knobs_applied"]:
            parts.append(dict(_knob_counters))
        try:
            # tracer self-telemetry: a nonzero events_dropped means this
            # process's trace files are silently truncated — surfaced as a
            # heartbeat counter so the driver sees it live, not post-mortem
            parts.append(telemetry.get_tracer().counters_snapshot())
        except Exception:
            pass
        for ref in list(_feeds):
            feed = ref()
            if feed is None:
                _feeds.remove(ref)
                continue
            try:
                parts.append(feed.counters_snapshot())
            except Exception:
                pass
        try:
            # profiler capture endpoint liveness (its counter is {} unless
            # this process started one)
            from tensorflowonspark_torch import profiler as profiler_mod

            parts.append(profiler_mod.server_counters())
        except Exception:
            pass
        try:
            # card memory HWMs: device-plane health riding the same beat as
            # the host-side feed counters ({} until this process initialized
            # CUDA; reading them never initializes it).  Only where the user
            # fn imported torch: importing it here would stall the beat,
            # and so would waiting out an import of torch still running
            # on the main thread (the profiler preload's, for one).
            if _imported("torch"):
                from tensorflowonspark_torch import metrics as metrics_mod

                parts.append(metrics_mod.device_memory_counters())
        except Exception:
            pass
        try:
            feeder = mgr.get("feeder_metrics")
            if isinstance(feeder, dict):
                parts.append(feeder)
        except Exception:
            pass
        try:
            depth = mgr.get_queue(qname).qsize()
            if depth > hwm["queue_depth_hwm"]:
                hwm["queue_depth_hwm"] = depth
            # Instantaneous depth next to the high-water mark: the HWM can
            # never come back down, so a live backlog signal (is the queue
            # draining NOW?) needs its own gauge.
            parts.append(dict(hwm, queue_depth_max=depth))
        except Exception:
            pass
        return telemetry.merge_counters(parts)

    return _provider

# ---------------------------------------------------------------------------
# Preemption drain (SIGTERM): a preempted host must stop feed consumption,
# land an emergency checkpoint, and deregister cleanly (BYE reason=preempted)
# instead of dying by heartbeat timeout.  The node wrappers install the
# handler in the process running the user fn; interested parties register
# callbacks (the DataFeed registers its drain in get_data_feed; the trainer's
# supervision registers the emergency save in train.fit_supervised).
# ---------------------------------------------------------------------------

_preempt_event = threading.Event()
_preempt_callbacks = []  # run FIFO: feed drain first, then emergency save


def on_preemption(callback):
    """Register ``callback()`` to run when this process receives SIGTERM
    (preemption).  Callbacks run in registration order inside the signal
    handler, so keep them short and idempotent; after they return the
    handler raises ``SystemExit(0)`` to unwind the user fn cleanly.
    Returns the callback (usable as a decorator)."""
    _preempt_callbacks.append(callback)
    return callback


def remove_preemption_callback(callback):
    """Deregister a preemption callback (no-op if absent)."""
    try:
        _preempt_callbacks.remove(callback)
    except ValueError:
        pass


def preempted():
    """True once this process received a preemption SIGTERM."""
    return _preempt_event.is_set()


def _reset_preemption():
    """Fresh preemption state (a forked node child inherits the parent's
    registrations; tests reuse the module in-process)."""
    global _preempt_event
    _preempt_event = threading.Event()
    del _preempt_callbacks[:]


def _sigterm_drain(signum, frame):
    """SIGTERM handler: run the registered drain callbacks once, then exit
    cleanly.  A second SIGTERM while draining is ignored (schedulers often
    send TERM twice before escalating to KILL)."""
    if _preempt_event.is_set():
        return
    _preempt_event.set()
    logger.warning("SIGTERM received: preemption drain (stopping feed, "
                   "emergency checkpoint, clean BYE)")
    for cb in list(_preempt_callbacks):
        try:
            cb()
        except Exception:
            logger.exception("preemption callback %r failed", cb)
    raise SystemExit(0)


def _install_sigterm_drain():
    """Install the preemption handler; False when impossible (signal
    handlers can only be installed from the main thread — e.g. Spark
    executors run tasks on worker threads, where the preemption story is
    Spark's own task re-land instead)."""
    try:
        signal.signal(signal.SIGTERM, _sigterm_drain)
        return True
    except ValueError:
        logger.info("not on the main thread; SIGTERM preemption drain "
                    "not installed")
        return False


class TPUNodeContext(object):
    """Encapsulates a node's identity & helpers, passed to ``main_fun(args, ctx)``.

    Mirrors the reference's ``TFNodeContext`` (``TFSparkNode.py:32-72``) with
    the TF_CONFIG-era fields replaced by torch.distributed coordinates (the
    class keeps the JAX package's name, so user code reads the same):

    Attributes:
      executor_id: backend executor ordinal this node runs on.
      job_name: ``'chief'|'master'|'worker'|'ps'|'evaluator'``.
      task_index: index within the job.
      cluster_info: full sorted roster of node metadata dicts.
      cluster_spec: ``{job_name: [host:port, ...]}`` view of the roster.
      default_fs: default filesystem prefix for relative paths.
      working_dir: this executor's working directory.
      mgr: connected per-executor manager (queues + state).
      coordinator_address: ``host:port`` of the torch.distributed store
        (process 0's reserved port).
      num_processes / process_id: this node's world size and rank
        (``None`` for ps nodes).
      device: the ``torch.device`` :meth:`initialize_distributed` resolved
        (None before it ran).
    """

    def __init__(self, executor_id, job_name, task_index, cluster_info,
                 default_fs, working_dir, mgr, coordinator_address,
                 num_processes, process_id, data_service=None):
        self.executor_id = executor_id
        self.worker_num = executor_id  # reference-compat alias (TFSparkNode.py:34)
        self.job_name = job_name
        self.task_index = task_index
        self.cluster_info = cluster_info
        self.default_fs = default_fs
        self.working_dir = working_dir
        self.mgr = mgr
        self.coordinator_address = coordinator_address
        self.num_processes = num_processes
        self.process_id = process_id
        # disaggregated-data-service spec from cluster.run(data_service=):
        # {"dispatcher": [host, port]} or None (see get_service_feed)
        self.data_service = data_service
        self.device = None

    @property
    def cluster_spec(self):
        spec = {}
        for node in self.cluster_info:
            spec.setdefault(node["job_name"], []).append(
                "{}:{}".format(node["host"], node["port"])
            )
        return spec

    @property
    def num_workers(self):
        """Number of training nodes (reference ``TFSparkNode.py:53``)."""
        return len([n for n in self.cluster_info if n["job_name"] in _DIST_JOBS])

    def is_chief(self):
        return self.process_id == 0

    def initialize_distributed(self, device=None):
        """Resolve this node's device and join the multi-process world.

        The act that replaces consuming ``TF_CONFIG`` (SURVEY §2.5): every
        training node calls ``torch.distributed.init_process_group`` with
        the coordinates the rendezvous distributed — the coordinator
        address (process 0's reserved port) as a TCP store,
        ``world_size=num_processes`` and ``rank=process_id``.  The backend
        is NCCL when the device is a card and gloo on the CPU; a separate
        gloo group carries the host-level agreement of
        :mod:`~tensorflowonspark_torch.parallel.collectives`.

        ``device`` defaults to this node's card: ``cuda:<local rank>``,
        the rank among this host's training nodes, or ``cuda:0`` when
        :func:`~tensorflowonspark_torch.device.pin_cards` left this worker
        only its own cards (see
        :func:`~tensorflowonspark_torch.device.default_card`; ``"cpu"``
        only when asked; with no card that raises, see
        :func:`~tensorflowonspark_torch.device.resolve_device`).  This is a
        CUDA call: make it in the user fn, never before the node's forks.
        Joining the world is a no-op for single-process clusters and for
        ps nodes, as in the reference.  Returns the device."""
        from tensorflowonspark_torch import device as device_mod

        if device is None:
            import torch

            if not torch.cuda.is_available():
                device_mod.resolve_device("cuda")   # raises: no card
            device = "cuda:{}".format(device_mod.default_card(
                self.local_rank, torch.cuda.device_count(),
                device_mod.cards_pinned()))
        self.device = device_mod.resolve_device(device)
        if self.device.type == "cuda":
            import torch

            torch.cuda.set_device(self.device)
        if self.process_id is None or self.num_processes <= 1:
            return self.device
        import torch.distributed as dist

        from tensorflowonspark_torch.parallel import collectives

        dist.init_process_group(
            backend="nccl" if self.device.type == "cuda" else "gloo",
            init_method="tcp://{}".format(self.coordinator_address),
            world_size=self.num_processes, rank=self.process_id)
        collectives.init_host_group()
        return self.device

    @property
    def local_rank(self):
        """This node's index among the training nodes on its host (0 for
        ps nodes and single-node hosts)."""
        if self.process_id is None:
            return 0
        me = [n for n in self.cluster_info
              if n["job_name"] in _DIST_JOBS][self.process_id]
        return sum(1 for n in self.cluster_info[:self.cluster_info.index(me)]
                   if n["job_name"] in _DIST_JOBS and n["host"] == me["host"])

    def get_data_feed(self, train_mode=True, qname_in="input",
                      qname_out="output", input_mapping=None):
        """Return a :class:`~tensorflowonspark_torch.datafeed.DataFeed` on this
        node's queues (reference ``TFNode.py:86``)."""
        from tensorflowonspark_torch.datafeed import DataFeed

        feed = DataFeed(self.mgr, train_mode, qname_in, qname_out, input_mapping)
        # On preemption the feed must stop consuming first (before the
        # emergency checkpoint), so feeders unblock instead of pushing into a
        # dying node; drain order is registration order.
        on_preemption(feed.terminate)
        # Expose the feed's counters to the heartbeat metrics provider (the
        # real node module of this process, not the closure's copy — see
        # the _node_state comment in run()).
        import tensorflowonspark_torch.node as _node_mod

        _node_mod._register_feed(feed)
        return feed

    def get_service_feed(self, files, dispatcher=None, **kwargs):
        """Return a :class:`~tensorflowonspark_torch.dataservice.ServiceFeed`
        reading ``files`` through the disaggregated data service (the
        FILES-mode analog of :meth:`get_data_feed` when ``cluster.run`` was
        given ``data_service=``).

        ``dispatcher`` overrides the cluster-configured address; remaining
        kwargs pass through to ``ServiceFeed`` (``job_name``, ``mode``,
        ``num_epochs``, ``input_mapping``, ...).  The consumer identity
        defaults to this node's executor id."""
        from tensorflowonspark_torch import dataservice

        if dispatcher is None:
            if not self.data_service:
                raise ValueError(
                    "no data service configured: pass dispatcher= here or "
                    "data_service= to cluster.run")
            dispatcher = self.data_service["dispatcher"]
        kwargs.setdefault("consumer_id",
                          "executor-{}".format(self.executor_id))
        if self.data_service and self.data_service.get("codecs") is not None:
            # cluster-pinned wire-compression offer (cluster.run data_service
            # spec); an explicit codecs= kwarg still wins
            kwargs.setdefault("codecs", self.data_service["codecs"])
        feed = dataservice.ServiceFeed(dispatcher, files, **kwargs)
        # same lifecycle wiring as get_data_feed: preemption drain stops the
        # network streams, and the feed's dataservice_* counters ride this
        # node's heartbeats into the driver's metrics snapshot
        on_preemption(feed.terminate)
        import tensorflowonspark_torch.node as _node_mod

        _node_mod._register_feed(feed)
        return feed

    def absolute_path(self, path):
        """Normalize a user path against CWD/default_fs (reference ``TFNode.py:23-58``)."""
        from tensorflowonspark_torch.datafeed import absolute_path

        return absolute_path(self, path)


def _reserve_free_port():
    """Bind an ephemeral port and hold it (reference ``TFSparkNode.py:239-244``)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("", 0))
    return s, s.getsockname()[1]


def _start_tensorboard(log_dir):
    """Spawn TensorBoard for this cluster if available (reference
    ``TFSparkNode.py:199-225``); returns ``(pid, port)`` or ``(0, 0)``."""
    tb_exec = util.find_in_path(os.environ.get("PATH", ""), "tensorboard")
    if not tb_exec:
        logger.warning("tensorboard not found in PATH; skipping launch")
        return 0, 0
    sock, tb_port = _reserve_free_port()
    sock.close()
    proc = subprocess.Popen(
        [sys.executable, tb_exec, "--logdir=%s" % log_dir, "--port=%d" % tb_port],
        env=os.environ,
    )
    return proc.pid, tb_port


def _sort_key(node):
    """Deterministic roster ordering: chief/master first, then workers,
    evaluator, ps — so process_id 0 is always the chief (reference sorts by
    executor_id, ``TFSparkNode.py:264-276``; we sort by role for a stable
    torch.distributed rank numbering)."""
    job_rank = {"chief": 0, "master": 0, "worker": 1, "evaluator": 2, "ps": 3}
    return (job_rank.get(node["job_name"], 4), node["task_index"])


def refuse_if_cuda_initialized():
    """Raise when this process has initialized CUDA: a node forks its
    manager and (SPARK mode) its user-fn child, and a forked child of a
    CUDA process cannot use the card (it fails there, or hangs).  Reads
    only whether torch is imported and CUDA up; initializes nothing."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        raise RuntimeError(
            "executor process {} has initialized CUDA (a TFModel.transform "
            "on the card ran here), so it cannot host a cluster node: the "
            "node forks its manager and user-fn child, and a forked child "
            "cannot use CUDA.  Run TFEstimator.fit before TFModel.transform, "
            "or fit on a fresh backend.".format(os.getpid()))


def run(fn, tf_args, cluster_meta, tensorboard=False, log_dir=None,
        queues=("input", "output", "error"), background=False,
        release_port=True, profiler=False, driver_local=False):
    """Build the "start job" task closure (reference ``TFSparkNode.py:121-368``).

    Args:
      fn: user map function ``fn(args, ctx)``.
      tf_args: argparse Namespace or argv list passed through to ``fn``.
      cluster_meta: dict from :func:`tensorflowonspark_torch.cluster.run` with
        ``id``, ``cluster_template``, ``server_addr``, ``authkey``,
        ``default_fs``, ``num_executors``.
      tensorboard: launch TensorBoard on the chief.
      background: run ``fn`` in a background process (SPARK input mode), so the
        executor's task slot frees up for feed jobs (reference
        ``TFSparkNode.py:310-342``).
      release_port: close the reserved coordinator port right before invoking
        ``fn`` (reference ``TFSparkNode.py:306-308``).
      profiler: serve the profiler's capture endpoint
        (:func:`profiler.start_server`) from the process that runs ``fn``
        on the training roles, and publish its port in the roster
        (``profiler_port``).  In FILES mode that is this executor; in
        SPARK mode the port is reserved here, before registration, and
        the forked user-fn child serves on the reserved socket.
      driver_local: this node runs in a DRIVER thread, not on an executor
        (``cluster.run(driver_ps_nodes=True)``, reference
        ``TFCluster.py:291-309``): skip the executor working-dir handshakes
        (executor-id file, stale-node state file, shm rings) — they belong
        to executor cwds, and the driver's cwd never receives the shutdown
        job that would retire a state file.
    """

    def _mapfn(iterator):
        # The start job parallelizes range(num_executors) with one element per
        # partition; that element is this node's executor id
        # (reference TFCluster.py:312-316, TFSparkNode.py:148).  An elastic
        # REPLACEMENT start task instead carries an explicit assignment dict
        # {executor_id, job_name, task_index}: the fresh executor is not in
        # the original template, and the role it must claim is the dead
        # node's released slot (see cluster.run's _request_replacement).
        executor_id = None
        for item in iterator:
            executor_id = item
        assert executor_id is not None, "start task received an empty partition"
        if not driver_local:
            refuse_if_cuda_initialized()
        assignment = None
        if isinstance(executor_id, dict):
            assignment = executor_id
            executor_id = assignment["executor_id"]

        # Claim role from the assignment or the template (reference
        # TFSparkNode.py:148-158).
        if assignment is not None:
            job_name = assignment["job_name"]
            task_index = assignment["task_index"]
        else:
            job_name, task_index = None, -1
            for job, executors in cluster_meta["cluster_template"].items():
                if executor_id in executors:
                    job_name = job
                    task_index = executors.index(executor_id)
                    break
            assert job_name is not None, (
                "executor_id {} not present in cluster template {}".format(
                    executor_id, cluster_meta["cluster_template"])
            )
        logger.info("executor_id=%d assigned role %s:%d%s", executor_id,
                    job_name, task_index,
                    " (replacement)" if assignment is not None else "")
        tracer = telemetry.configure_from_meta(cluster_meta)
        tracer.instant("node/role_assigned", executor_id=executor_id,
                       job_name=job_name, task_index=task_index,
                       replacement=assignment is not None)

        # Apply cluster-level env (CUDA/NCCL knobs) FIRST: CUDA and NCCL
        # read these only when they initialize, and everything below
        # (manager fork, user fn) inherits them.
        if cluster_meta.get("executor_env"):
            os.environ.update(cluster_meta["executor_env"])

        # Stale-node detection: if this working dir already hosts a live node
        # from another cluster instance, fail loudly so the scheduler retries
        # elsewhere (reference TFSparkNode.py:166-172).  Driver-local nodes
        # skip the cwd handshakes entirely (see driver_local in run()).
        state_file = os.path.join(os.getcwd(), "cluster_state.json")
        if not driver_local:
            if os.path.exists(state_file):
                with open(state_file) as f:
                    prior = json.load(f)
                if prior.get("cluster_id") != cluster_meta["id"] and prior.get("state") == "running":
                    raise Exception(
                        "A node from cluster {} appears to still be running in {}; "
                        "this executor cannot host two clusters. Ensure previous "
                        "clusters were shut down.".format(prior.get("cluster_id"), os.getcwd())
                    )

            util.write_executor_id(executor_id)

        # Start the per-executor manager BEFORE any CUDA initialization: a
        # process that initialized CUDA cannot use it in a forked child
        # (reference TFSparkNode.py:174-185; remote mode for roles the driver
        # must reach directly at shutdown, TFCluster.py:186-192).
        authkey = bytes.fromhex(cluster_meta["authkey"])
        qnames = list(queues)
        with tracer.span("node/manager_start", executor_id=executor_id):
            if job_name in ("ps", "evaluator"):
                if "control" not in qnames:
                    qnames.append("control")
                mgr = manager.start(authkey, qnames, mode="remote")
                addr = list(mgr.address)
                if not addr[0]:
                    addr[0] = util.get_ip_address()
            else:
                mgr = manager.start(authkey, qnames, mode="local")
                addr = mgr.address  # unix socket path (same-host connections only)
            mgr.set("state", "running")
        # Pin the manager handle in the *real* node module of this executor
        # process — not this closure's globals.  The start-task closure is
        # cloudpickled by value, so its reconstructed globals (including any
        # module-level dict captured by value) are garbage collected when the
        # executor loads its next task; GC of the manager handle would
        # finalize (kill) the manager server (BaseManager registers a
        # Finalize).  Importing resolves the genuinely process-global module.
        import tensorflowonspark_torch.node as _node_mod

        # Keyed by executor id: driver_ps_nodes runs several node closures
        # in ONE process (driver threads) — a single shared key would drop
        # all but the last manager's reference.
        _node_mod._node_state["mgr-{}".format(executor_id)] = mgr
        _node_mod._node_state["cluster_id"] = cluster_meta["id"]
        if not driver_local:
            with open(state_file, "w") as f:
                json.dump({"cluster_id": cluster_meta["id"],
                           "state": "running"}, f)

        # Pre-create the shm-ring feed transports HERE, in the long-lived
        # node process, so the creator's lifetime matches the consumer's.
        # Feed tasks only attach: if a short-lived (non-reused) feed worker
        # created a ring, its exit would unlink it under the consumer and
        # the next feed task would create a second ring with the same name
        # — tokens then promise records that never arrive (the hazard
        # native/shmring.cc's shmring_free contract documents).  Driver-local
        # ps nodes never receive feed jobs, so no rings.
        from tensorflowonspark_torch import shmring

        if shmring.available() and not driver_local:
            # Only feed-direction queues get a ring: results travel back as
            # plain Chunks (DataFeed.batch_results), and error/control carry
            # single small messages.
            with tracer.span("node/rings", executor_id=executor_id):
                for qn in qnames:
                    if qn not in ("error", "control", "output"):
                        shmring.get_ring(
                            shmring.ring_name(cluster_meta["id"], executor_id,
                                              qn),
                            create=True)

        # TensorBoard on the first worker-like node (reference TFSparkNode.py:199-225).
        tb_pid, tb_port = 0, 0
        if tensorboard and job_name in ("chief", "master", "worker") and task_index == 0:
            tb_pid, tb_port = _start_tensorboard(log_dir or "tensorboard_logs")

        # The profiler's capture endpoint lives in the process that runs the
        # user fn and owns CUDA: this executor in FILES mode, the forked
        # child in SPARK mode, which serves on a socket reserved here so
        # the roster can carry its port.  Nothing here touches CUDA.
        profiler_port, prof_sock = 0, None
        if profiler and job_name in _DIST_JOBS:
            from tensorflowonspark_torch import profiler as profiler_mod

            if background:
                prof_sock, profiler_port = _reserve_free_port()
                prof_sock.listen(16)  # dials queue until the child serves
            else:
                profiler_mod.preload()
                profiler_port = profiler_mod.start_server()

        # Reserve the port this node contributes to the roster.  For process 0
        # it becomes the torch.distributed store port (reference reserved
        # the TF gRPC server port here, TFSparkNode.py:239-244).
        port_sock, port = _reserve_free_port()

        host = util.get_ip_address()
        client = reservation.Client(
            cluster_meta.get("server_addrs") or cluster_meta["server_addr"])
        node_meta = {
            "executor_id": executor_id,
            "host": host,
            "job_name": job_name,
            "task_index": task_index,
            "port": port,
            "addr": addr,
            "authkey": cluster_meta["authkey"],
            "pid": os.getpid(),
            "tb_pid": tb_pid,
            "tb_port": tb_port,
            "profiler_port": profiler_port,
            "working_dir": os.getcwd(),
        }
        # Trace flow across the rendezvous: started here, stepped by the
        # driver on REG admission, ended on this node's first heartbeat —
        # Perfetto then links registration -> admission -> liveness causally
        # across the node/driver process boundary.
        reg_flow = tracer.new_flow_id()
        if reg_flow:
            node_meta["trace_flow"] = reg_flow
            tracer.flow_start("reservation/register_flow", reg_flow,
                              leg="node_register", executor_id=executor_id,
                              job_name=job_name)
        with tracer.span("node/register", executor_id=executor_id,
                         job_name=job_name, task_index=task_index):
            client.register(node_meta)
        with tracer.span("node/await", executor_id=executor_id):
            cluster_info = client.await_reservations(
                timeout=cluster_meta.get("reservation_timeout", 600))
        client.close()
        cluster_info.sort(key=_sort_key)

        # Duplicate-registration sanity check (reference TFSparkNode.py:267-270).
        seen = set()
        for n in cluster_info:
            key = (n["job_name"], n["task_index"])
            if key in seen:
                raise Exception(
                    "Duplicate cluster node {}; executors likely ran multiple "
                    "start tasks. Roster: {}".format(key, cluster_info))
            seen.add(key)

        # Derive torch.distributed coordinates — the TF_CONFIG replacement
        # (reference TFSparkNode.py:278-286; SURVEY §2.5 mapping).
        world_nodes = [n for n in cluster_info if n["job_name"] in _DIST_JOBS]
        num_processes = len(world_nodes)
        process_id = None
        for i, n in enumerate(world_nodes):
            if n["executor_id"] == executor_id:
                process_id = i
                break
        coordinator_address = "{}:{}".format(world_nodes[0]["host"], world_nodes[0]["port"])
        tracer.instant("node/cluster_ready", executor_id=executor_id,
                       num_processes=num_processes, process_id=process_id)

        ctx = TPUNodeContext(
            executor_id, job_name, task_index, cluster_info,
            cluster_meta.get("default_fs", "file://"), os.getcwd(), mgr,
            coordinator_address, num_processes, process_id,
            data_service=cluster_meta.get("data_service"),
        )

        if release_port:
            port_sock.close()

        def wrapper_fn(args, context):
            """Invoke the user fn with argv semantics (reference TFSparkNode.py:320-324)."""
            # Warm-start compile plane: runs in the process that actually
            # compiles (the forked background child in SPARK mode, this
            # process in FILES mode), BEFORE the user fn touches CUDA —
            # replacement nodes re-enter through this same closure, which
            # is what makes warm rejoin automatic.  No-op without a
            # configured cache dir; sets paths only (no CUDA).
            from tensorflowonspark_torch import compilecache

            compilecache.configure_from_meta(cluster_meta)
            if isinstance(args, list):
                sys.argv = args
            fn(args, context)

        heartbeat_interval = cluster_meta.get("heartbeat_interval", 0)

        def wrapper_fn_background(args, context):
            """Background-process wrapper: route exceptions to the error queue
            (reference TFSparkNode.py:326-332)."""
            multiprocessing.current_process().authkey = authkey
            errq = context.mgr.get_queue("error")
            _hold_captures()
            # The heartbeat lives HERE, in the process executing the user fn:
            # a SIGKILL of training silences the beats even though the
            # executor shell and manager survive — that silence is what the
            # driver's liveness monitor detects.  Clean exits (including
            # user-code exceptions, which travel via the error queue) send
            # BYE so they are not miscounted as deaths.
            hb = reservation.HeartbeatSender(
                cluster_meta.get("server_addrs")
                or cluster_meta["server_addr"], executor_id,
                heartbeat_interval,
                metrics_provider=_node_metrics_provider(context.mgr),
                trace_flow=node_meta.get("trace_flow"),
                on_profile=_profile_handler(context.job_name),
                on_reply=_knob_reply_handler).start()
            # Forked children inherit the parent's preemption registrations;
            # start from a clean slate, then install the SIGTERM drain in the
            # process that actually runs the user fn.
            _reset_preemption()
            _install_sigterm_drain()
            # SIGUSR1 -> flight record (this forked child owns its main
            # thread, so the handler installs; no-op when telemetry is off).
            telemetry.install_sigusr1()
            fault.from_env().arm_preempt_notice()
            tracer = telemetry.get_tracer()
            reason = None
            try:
                # the beats run while the profiler warms (seconds: 7.8 s on
                # an H100 host); the capture endpoint starts after it
                _preload_profiler(cluster_meta.get("profiling"),
                                  context.job_name)
                if prof_sock is not None:
                    profiler_mod.start_server(sock=prof_sock)
                with tracer.span("node/user_fn", executor_id=executor_id,
                                 job_name=context.job_name,
                                 task_index=context.task_index):
                    wrapper_fn(args, context)
                reason = "done"
            except Exception:
                try:
                    errq.put(traceback.format_exc())
                except (EOFError, BrokenPipeError, ConnectionError, OSError):
                    # the manager (and with it the error queue) is already
                    # gone — cluster shutdown beat us; the traceback still
                    # goes to the executor log via the raise below, but a
                    # dead reporting channel must not mask it with its own
                    # BrokenPipeError
                    logger.warning("error queue unreachable during "
                                   "shutdown; traceback follows in log")
                raise
            finally:
                if preempted():
                    reason = "preempted"
                hb.stop(reason=reason)
                # Crash-safe flush point: runs on clean completion, on user
                # exceptions, AND on the SIGTERM drain's SystemExit — the
                # trace must survive everything short of SIGKILL.
                tracer.flush()

        if job_name in ("ps", "evaluator") or background:
            # Run the user fn in a child process; ps/evaluator then park this
            # task on the control queue so their executor stays reserved
            # (reference TFSparkNode.py:334-361).  SPARK-mode workers return
            # immediately, freeing the slot for feed jobs.
            p = multiprocessing.get_context("fork").Process(
                target=wrapper_fn_background, args=(tf_args, ctx), daemon=True)
            p.start()
            if prof_sock is not None:
                prof_sock.close()  # the child serves on its inherited copy
            # Publish the user-fn pid so feeders can fast-fail on a consumer
            # that died instead of burning the whole feed_timeout.
            mgr.set("node_pid", p.pid)
            # The start task returns now (SPARK mode frees the slot for feed
            # jobs): flush the bring-up spans recorded in THIS process — the
            # forked child writes its own trace file.
            tracer.flush()
            if job_name in ("ps", "evaluator"):
                ctrl = mgr.get_queue("control")
                errq = mgr.get_queue("error")
                done = False
                while not done:
                    while not ctrl.empty():
                        msg = ctrl.get(block=True)
                        ctrl.task_done()
                        if msg is None:
                            done = True
                    if not errq.empty():
                        trace = errq.get(block=True)
                        errq.task_done()
                        raise Exception(
                            "Exception in {}:{}:\n{}".format(job_name, task_index, trace))
                    time.sleep(1)
                mgr.set("state", "stopped")
                p.terminate()
        else:
            # FILES-mode worker: run inline; the task slot stays occupied for
            # the duration of training (reference TFSparkNode.py:362-366).
            errq = mgr.get_queue("error")
            mgr.set("node_pid", os.getpid())
            _hold_captures()
            hb = reservation.HeartbeatSender(
                cluster_meta.get("server_addrs")
                or cluster_meta["server_addr"], executor_id,
                heartbeat_interval,
                metrics_provider=_node_metrics_provider(mgr),
                trace_flow=node_meta.get("trace_flow"),
                on_profile=_profile_handler(job_name),
                on_reply=_knob_reply_handler).start()
            _reset_preemption()
            _install_sigterm_drain()
            telemetry.install_sigusr1()
            fault.from_env().arm_preempt_notice()
            reason = None
            try:
                _preload_profiler(cluster_meta.get("profiling"), job_name)
                with tracer.span("node/user_fn", executor_id=executor_id,
                                 job_name=job_name, task_index=task_index):
                    wrapper_fn(tf_args, ctx)
                reason = "done"
            except Exception:
                errq.put(traceback.format_exc())
                raise
            finally:
                if preempted():
                    reason = "preempted"
                hb.stop(reason=reason)
                mgr.set("state", "finished")
                tracer.flush()

    return _mapfn


def _get_manager(cluster_info, host, executor_id):
    """Reconnect to the manager of the node on (host, executor_id)
    (reference ``TFSparkNode.py:92-118``)."""
    for node in cluster_info:
        if node["host"] == host and node["executor_id"] == executor_id:
            addr = node["addr"]
            authkey = bytes.fromhex(node["authkey"])
            try:
                m = manager.connect(addr, authkey)
            except (OSError, EOFError) as e:
                raise Exception(
                    "Unable to reach the manager of node {} (role {}:{}) at "
                    "{!r} (exists={}) from pid {} cwd {!r}: {!r}. The node "
                    "process may have died; check its logs.".format(
                        executor_id, node["job_name"], node["task_index"],
                        addr, os.path.exists(str(addr)), os.getpid(),
                        os.getcwd(), e))
            state = m.get("state")
            logger.debug("connected to manager %s state=%s", addr, state)
            return m
    raise Exception(
        "No cluster node found on executor {} of host {}. A data task was "
        "scheduled on an executor that is not part of this cluster; ensure "
        "one task slot per executor and no dynamic allocation.".format(
            executor_id, host))


def train(cluster_info, cluster_meta, qname="input", feed_timeout=600,
          chunk_size=1024, num_epochs=1):
    """Feed-job closure: push partition items into this executor's input queue
    (reference ``TFSparkNode.py:371-438``).

    Items travel in **columnar** :class:`~tensorflowonspark_torch.marker.ColChunk`
    blocks of ``chunk_size`` (object :class:`~tensorflowonspark_torch.marker.Chunk`
    fallback for non-uniform rows) so the manager-proxy IPC cost amortizes and
    serialization is a few memcpys, not per-row pickling (the reference's
    per-element hops were its feed ceiling, SURVEY §3.2); backpressure is at
    chunk granularity via the JoinableQueue.

    ``num_epochs > 1`` repeats the partition **executor-side**: the feeder
    caches each packed chunk's serialized bytes on the first pass and re-puts
    them per epoch, so epochs cost zero driver->executor shipping and zero
    re-serialization (the reference re-shipped every epoch from the driver
    via ``sc.union([rdd]*num_epochs)``, reference ``TFCluster.py:88-91``).
    Epoch order is per-partition (P1 P1 P2 P2 ...) rather than the
    reference's per-epoch (P1 P2 P1 P2 ...); with per-step batching this is
    equivalent for training and the driver ships each row exactly once.
    """

    def _train(iterator):
        host = util.get_ip_address()
        executor_id = util.read_executor_id()
        tracer = telemetry.configure_from_meta(cluster_meta)
        mgr = _get_manager(cluster_info, host, executor_id)
        queue = mgr.get_queue(qname)
        state = mgr.get("state")
        if state in ("terminating", "stopped"):
            # Consumer already signalled completion: drain this partition
            # without feeding (reference TFSparkNode.py:393-399).
            logger.info("node state %s; skipping partition", state)
            count = sum(1 for _ in iterator)
            logger.info("skipped %d items", count)
        else:
            # Fast-fail before shipping anything: a consumer that died
            # WITHOUT signalling (SIGKILL leaves state 'running' forever)
            # would otherwise absorb the whole partition and then burn
            # feed_timeout on the drain wait.  The error message is
            # classified retryable, so a supervised train() can re-feed
            # this partition to a surviving node.
            _check_consumer_alive(mgr, executor_id, "before feeding")
            putter = _ChunkPutter(queue, cluster_meta, executor_id, qname,
                                  feed_timeout, cache=(num_epochs > 1))
            try:
                with tracer.span("feed/partition", executor_id=executor_id,
                                 qname=qname):
                    count = _feed_blocks(iterator, putter.put, chunk_size)
                    for _ in range(num_epochs - 1):
                        if mgr.get("state") in ("terminating", "stopped"):
                            break
                        count += putter.reput_cached()
                    _publish_feeder_metrics(mgr, putter)
                    # Wait for the consumer to drain the queue, surfacing
                    # user-code errors and enforcing feed_timeout (reference
                    # TFSparkNode.py:407-418).  The deadline scales with
                    # epochs: executor-side replay drains ALL epochs inside
                    # this one task, where the reference's per-epoch
                    # partition tasks each got their own timeout — a fixed
                    # deadline would spuriously kill healthy multi-epoch
                    # runs on the in-queue (no-shm-ring) path.
                    _join_with_error_check(mgr, queue,
                                           feed_timeout * max(num_epochs, 1),
                                           "feeding",
                                           executor_id=executor_id)
            finally:
                # The feeder's trace must survive a failed join too — the
                # chaos timeline needs the feed span that the kill cut short.
                tracer.flush()
            logger.info("fed %d items to %s queue", count, qname)
        # If the consumer began terminating while we fed, ask the driver to
        # stop scheduling feed partitions (reference TFSparkNode.py:422-434).
        if mgr.get("state") == "terminating":
            client = reservation.Client(
                cluster_meta.get("server_addrs")
                or cluster_meta["server_addr"])
            client.request_stop()
            client.close()
        return [count]

    return _train


def _publish_feeder_metrics(mgr, putter):
    """Accumulate this feed task's counters into the node's manager KV
    (``feeder_metrics``), where the consumer-side heartbeat provider picks
    them up.  Feed tasks are serialized per executor, so read-modify-write
    is race-free; any failure (dead manager mid-chaos) is swallowed —
    metrics never outrank the feed itself."""
    if not telemetry.get_tracer().enabled:
        return
    try:
        prev = mgr.get("feeder_metrics")
        mgr.set("feeder_metrics", telemetry.merge_counters(
            [prev if isinstance(prev, dict) else {},
             putter.counters_delta()]))
    except Exception as e:
        logger.debug("feeder metrics publish failed: %s", e)


def _feed_blocks(iterator, put, chunk_size):
    """Batch an item iterator into ``chunk_size`` blocks through ``put``;
    returns the item count (shared by the train and inference feeders)."""
    count = 0
    block = []
    for item in iterator:
        block.append(item)
        count += 1
        if len(block) >= chunk_size:
            put(block)
            block = []
    if block:
        put(block)
    return count


class _ChunkPutter(object):
    """Sends item blocks the fastest way available: columnar payloads as
    zero-copy framed records through the native shm ring
    (:mod:`~tensorflowonspark_torch.wire` + ``Ring.put_vectored`` — one
    memcpy per column, no intermediate pickle bytes) with an ordering token
    on the queue; pickled ring records for object chunks and non-framable
    columns; an in-queue chunk when the ring is unavailable / the record is
    oversized (see :mod:`~tensorflowonspark_torch.shmring`).

    With ``cache=True`` every block's packed chunk (or its pickled bytes,
    when the pickled ring path was taken — framed chunks ARE their own raw
    buffers, so the chunk object is the cache) is retained so
    :meth:`reput_cached` can replay the whole partition without touching
    the source rows again — the executor-side epoch repeat.
    """

    def __init__(self, queue, cluster_meta, executor_id, qname, feed_timeout,
                 cache=False):
        from tensorflowonspark_torch import fault, shmring, wire

        self._queue = queue
        self._feed_timeout = feed_timeout
        self._cache = [] if cache else None
        # Feeder-side telemetry tallies (always on; plain ints — see the
        # shmring.Ring counters for the rationale).  Published per feed task
        # to the node's manager KV so the consumer-side heartbeat can carry
        # them (the feeder runs in a different process than the user fn).
        self.items = 0
        self.bytes = 0
        # Chaos hook: corrupt_chunk_index flips bytes of the Nth serialized
        # chunk on the ring path (consumer-side unpickle/desync failure).
        self._injector = fault.from_env()
        # Framed columnar records unless TFOS_WIRE_FORMAT=pickle (the A/B
        # knob) or a corruption fault targets this feeder — byte corruption
        # is specified over one serialized stream, i.e. the pickled path.
        self._framed = (wire.enabled() and not (
            self._injector.enabled
            and self._injector.spec.get("corrupt_chunk_index") is not None))
        # Attach-only: the node process created the ring at startup (run());
        # a feed task must never create one, or a recycled Spark worker's
        # exit would unlink it under the live consumer (see run()).  No ring
        # (e.g. a custom qname the node didn't pre-create) falls back to
        # in-queue chunks.
        self._ring = None
        if shmring.available():
            self._ring = shmring.get_ring(
                shmring.ring_name(cluster_meta["id"], executor_id, qname))
        # Ring tallies are process-cumulative (executor processes host many
        # feed tasks); remember the baseline so counters_delta() reports
        # only THIS task's work and the KV accumulation never double counts.
        self._ring_base = ((self._ring.writes, self._ring.writevs)
                           if self._ring is not None else (0, 0))

    def counters_delta(self):
        """This feed task's contribution, as flat telemetry counters."""
        snap = {"feeder_items": self.items, "feeder_bytes": self.bytes}
        if self._ring is not None:
            snap["feeder_ring_writes"] = self._ring.writes - self._ring_base[0]
            snap["feeder_ring_writevs"] = (self._ring.writevs
                                           - self._ring_base[1])
            snap["ring_occupancy_hwm"] = int(self._ring.occupancy_hwm)
        return snap

    def put(self, block):
        chunk = marker.pack_columnar(block)
        n = len(block)
        if chunk is None:
            chunk = marker.Chunk(block)
        data = self._send(chunk, n, data=None)
        self.items += n
        if self._cache is not None:
            # When the pickled ring path was taken, the bytes alone suffice
            # for replay (holding the chunk too would double the partition's
            # resident footprint for the whole feed).  Framed chunks cache
            # as the chunk object — its columns are the raw buffers the
            # replay gather-writes again, so there is nothing cheaper.
            self._cache.append((None if data is not None else chunk, n, data))

    def reput_cached(self):
        """Re-send every cached chunk (one epoch); returns the item count."""
        import pickle

        total = 0
        for chunk, n, data in self._cache or ():
            if chunk is None:
                # Rare fallback: the ring accepted this chunk last epoch but
                # rejects it now (e.g. ring unlinked mid-run) — reconstruct
                # the object for the in-queue path.
                if self._send_bytes(data, n):
                    total += n
                    continue
                chunk = pickle.loads(data)
            self._send(chunk, n, data)
            total += n
        self.items += total
        return total

    def _send_bytes(self, data, n):
        """Ring-path replay of cached bytes; False if the ring refused."""
        if self._ring is not None and self._ring.put_bytes(
                data, timeout_secs=self._feed_timeout):
            self._queue.put(marker.ShmChunk(self._ring.name, n), block=True)
            self.bytes += len(data)
            return True
        return False

    def _send(self, chunk, n, data):
        """Ship one chunk; returns the pickled bytes if the pickled ring
        path was taken (for the epoch-repeat cache), else None (framed and
        in-queue sends cache the chunk object itself)."""
        import pickle

        from tensorflowonspark_torch import wire

        if self._ring is not None:
            if (self._framed and data is None
                    and isinstance(chunk, marker.ColChunk)):
                parts = wire.encode_chunk(chunk)
                if parts is not None and self._ring.put_vectored(
                        parts, timeout_secs=self._feed_timeout):
                    self._queue.put(
                        marker.ShmChunk(self._ring.name, n,
                                        fmt=wire.WIRE_COLV1), block=True)
                    self.bytes += sum(
                        getattr(p, "nbytes", None) or len(p) for p in parts)
                    return None
                # non-framable columns or an oversized record: pickled path
            if data is None:
                data = pickle.dumps(chunk, protocol=pickle.HIGHEST_PROTOCOL)
            # Ship possibly-corrupted bytes but cache the CLEAN ones: the
            # injected fault models one bad transfer, not a poisoned cache.
            payload = self._injector.corrupt(data)
            if self._ring.put_bytes(payload, timeout_secs=self._feed_timeout):
                self._queue.put(marker.ShmChunk(self._ring.name, n),
                                block=True)
                self.bytes += len(payload)
                return data
        self._queue.put(chunk, block=True)
        return None


def _check_consumer_alive(mgr, executor_id, when):
    """Raise (retryably) if the node's user-fn process is gone.

    ``node_pid`` is published by the start task; feeder and node are
    same-host by construction (the feed task reached this executor via the
    working-dir handshake), so a 0-signal probe is authoritative.  A missing
    pid (old node, driver-local) just skips the check.
    """
    pid = mgr.get("node_pid")
    if not pid:
        return
    dead = False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        dead = True
    except OSError:
        return  # EPERM etc.: process exists but isn't ours — treat as alive
    if not dead:
        # The pid exists, but a SIGKILLed node child is a ZOMBIE, not gone:
        # it's a daemon fork whose spawning start task returned long ago, so
        # nothing in the executor reaps it and the 0-signal probe keeps
        # succeeding for the rest of the executor's life.
        try:
            with open("/proc/{}/stat".format(pid)) as f:
                dead = f.read().split(")")[-1].split()[0] == "Z"
        except OSError:
            pass  # no procfs (non-Linux): existence is the best signal
    if dead:
        raise Exception(
            "node process (pid {}) on executor {} died {} — it exited "
            "without consuming its data; check executor logs.".format(
                pid, executor_id, when))


def _join_with_error_check(mgr, queue, timeout, phase, executor_id=None):
    """``queue.join()`` with error-queue polling + timeout (reference
    ``TFSparkNode.py:407-418``); also fails fast when the consumer process
    itself died (an unannounced death would otherwise cost the full
    ``timeout`` to diagnose)."""
    import threading

    joined = threading.Event()

    def _join():
        try:
            queue.join()
        except (EOFError, ConnectionError, BrokenPipeError):
            # Manager went away (executor died mid-feed); the error-queue
            # poll below surfaces the real failure — don't dump this
            # daemon thread's traceback on top of it.
            return
        joined.set()

    t = threading.Thread(target=_join, daemon=True)
    t.start()
    deadline = time.time() + timeout
    errq = mgr.get_queue("error")

    def _surface_user_error():
        if errq.empty():
            return
        # Peek-and-requeue so later lifecycle checks (shutdown's
        # late-error pass) still observe the failure (reference
        # TFSparkNode.py:547-553 applies the same trick).
        trace = errq.get(block=True)
        errq.task_done()
        errq.put(trace)
        raise Exception("Exception in user code during {}:\n{}".format(phase, trace))

    last_pid_check = 0.0
    while not joined.is_set():
        _surface_user_error()
        now = time.time()
        if now - last_pid_check >= 1.0:
            last_pid_check = now
            # Checked AFTER the error queue: a consumer that raised and
            # exited must surface its traceback, not a generic death.
            try:
                _check_consumer_alive(mgr, executor_id,
                                      "while draining the {} queue".format(phase))
            except Exception:
                # The death verdict races the dying consumer's own
                # traceback: its errq.put RPC returns once the item is in
                # the manager's feeder-thread buffer, where empty() (a pipe
                # poll) can't see it yet — so the process may look dead
                # while its traceback is still in flight.  Give the
                # traceback a beat to land; it is the better diagnosis
                # (user-code errors are fatal, a bare death is retryable).
                grace = time.time() + 2.0
                while time.time() < grace:
                    _surface_user_error()
                    time.sleep(0.1)
                raise
        if now > deadline:
            mgr.set("state", "stopped")
            raise Exception(
                "Timeout ({}s) waiting for the consumer to drain the {} queue. "
                "The training process may have exited without consuming its "
                "data; check executor logs.".format(timeout, phase))
        time.sleep(0.1)


def inference(cluster_info, cluster_meta, qname_in="input", qname_out="output",
              feed_timeout=600, chunk_size=1024):
    """Inference feed-job closure: push one partition, await exactly one result
    per input item (reference ``TFSparkNode.py:441-502``)."""

    def _inference(iterator):
        host = util.get_ip_address()
        executor_id = util.read_executor_id()
        tracer = telemetry.configure_from_meta(cluster_meta)
        mgr = _get_manager(cluster_info, host, executor_id)
        queue_in = mgr.get_queue(qname_in)

        putter = _ChunkPutter(queue_in, cluster_meta, executor_id, qname_in,
                              feed_timeout)
        try:
            with tracer.span("feed/partition", executor_id=executor_id,
                             qname=qname_in, mode="inference"):
                count = _feed_blocks(iterator, putter.put, chunk_size)
                _publish_feeder_metrics(mgr, putter)
                # Signal end-of-partition so DataFeed can align result batches
                # (reference TFSparkNode.py:469, marker.py).
                queue_in.put(marker.EndPartition(), block=True)
                if count == 0:
                    return []
                _join_with_error_check(mgr, queue_in, feed_timeout,
                                       "inference feeding",
                                       executor_id=executor_id)
        finally:
            tracer.flush()

        # Collect exactly `count` results: the 1:1 input/output contract
        # (reference TFSparkNode.py:491-500, TFNode.py:160-162).
        queue_out = mgr.get_queue(qname_out)
        results = []
        while count > 0:
            result = queue_out.get(block=True)
            queue_out.task_done()
            if isinstance(result, marker.Chunk):
                results.extend(result.items)
                count -= len(result.items)
            else:
                results.append(result)
                count -= 1
        return results

    return _inference


def shutdown(cluster_info, cluster_meta, queues=("input",), grace_secs=0):
    """Shutdown-job closure: kill TensorBoard, poison the queues, surface late
    errors (reference ``TFSparkNode.py:505-559``)."""

    def _shutdown(iterator):
        host = util.get_ip_address()
        executor_id = util.read_executor_id()
        mgr = _get_manager(cluster_info, host, executor_id)

        for node in cluster_info:  # kill TB on this node (reference 522-528)
            if node["host"] == host and node["executor_id"] == executor_id:
                if node.get("tb_pid"):
                    try:
                        os.kill(node["tb_pid"], 15)
                    except OSError:
                        pass

        # Poison only the data queues: 'error' must stay clean for the
        # late-error check below and 'control' is signalled by the driver
        # (reference TFCluster.py:172-174 passes only data queues here).
        data_queues = [q for q in queues if q not in ("error", "control")]
        logger.info("shutting down node %d: poisoning queues %s", executor_id, data_queues)
        for qname in data_queues:
            try:
                queue = mgr.get_queue(qname)
                queue.put(None, block=True)  # end-of-feed marker (reference 530-540)
            except (AttributeError, EOFError):
                pass

        if grace_secs > 0:
            # Give the chief time to finish exporting (reference 542-545).
            time.sleep(grace_secs)

        # Late-error check: peek-and-requeue so a retried shutdown task still
        # sees the failure (reference TFSparkNode.py:547-553).
        errq = mgr.get_queue("error")
        if not errq.empty():
            trace = errq.get(block=True)
            errq.task_done()
            errq.put(trace)
            raise Exception("Exception in user code:\n{}".format(trace))

        mgr.set("state", "stopped")

        # Remove this executor's shm-ring transports (payload fast path,
        # shmring.py); mappings held by live processes stay valid.
        from tensorflowonspark_torch import shmring

        if shmring.available():
            for qn in queues:
                shmring.unlink(
                    shmring.ring_name(cluster_meta["id"], executor_id, qn))

        state_file = os.path.join(os.getcwd(), "cluster_state.json")
        if os.path.exists(state_file):
            with open(state_file, "w") as f:
                json.dump({"cluster_id": cluster_meta["id"], "state": "stopped"}, f)
        # Report which node this task actually reached: scheduling does not
        # guarantee one task per executor, so the driver retries until every
        # worker node confirms (poisoning is idempotent — an extra None in a
        # drained queue is harmless).
        return [executor_id]

    return _shutdown
