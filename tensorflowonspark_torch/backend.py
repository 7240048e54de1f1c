"""Cluster execution backends: who runs the long-lived per-host tasks.

The reference framework is welded to Apache Spark: the driver runs "jobs" whose
tasks are scheduled one-per-executor, executors are long-lived OS processes
that persist across jobs, and data reaches tasks as partition iterators
(reference ``TFCluster.py:312-329``, ``TFSparkNode.py:121-135``).  This module
abstracts exactly that contract so the TPU framework can run on:

- :class:`SparkBackend`  — a thin adapter over a live ``SparkContext`` (used
  when ``pyspark`` is installed; API-compatible with the reference deployment).
- :class:`LocalBackend`  — a built-in multi-process standalone cluster: N
  long-lived executor processes on this host, a driver-side scheduler that
  dispatches one task per free executor, per-executor working directories, and
  partition-iterator task semantics.  This is the moral equivalent of the
  reference's test rig (a local Spark Standalone cluster with separate worker
  processes, ``test/run_tests.sh:15-22``, ``test/README.md:10``) promoted to a
  first-class deployment mode — one process per TPU host is the natural
  granularity for JAX/libtpu anyway (SURVEY §7.2).

The backend contract (used by :mod:`~tensorflowonspark_torch.cluster`):

- ``foreach_partition_async(partitions, fn) -> JobHandle`` — run ``fn(iter)``
  once per partition on some executor; non-blocking ("start job" / "feed job").
- ``map_partitions(partitions, fn) -> list`` — run ``fn(iter)`` per partition,
  collect per-partition result lists (inference results job).
- one task slot per executor: a task occupies its executor until it returns,
  which is what lets the framework co-locate feed tasks with the long-running
  node process via the executor-id working-dir handshake (``util.py:66-75``).
"""

import logging
import os
import pickle
import queue as _queue
import shutil
import struct
import tempfile
import threading
import time
import traceback
import weakref

import cloudpickle
from multiprocessing import get_context
from multiprocessing import util as _mp_util

logger = logging.getLogger(__name__)

#: LocalBackends that have not been stop()ped.  A leaked backend would hang
#: interpreter shutdown: multiprocessing's exit hook joins non-daemon
#: children, and an idle executor blocks on its command pipe forever (the
#: executors can't be daemonic — their tasks fork manager-server children).
#: A plain ``atexit`` handler can't help: multiprocessing registers its own
#: lazily at the first spawn, so LIFO ordering would run the join loop
#: first.  ``util.Finalize`` with an exitpriority runs INSIDE that hook,
#: before the join loop, so leaked executors are stopped in time.
_live_backends = weakref.WeakSet()


def _reap_leaked_backends():
    for backend in list(_live_backends):
        if not backend._stopped:
            logger.warning(
                "LocalBackend leaked (never stopped); stopping at exit")
            try:
                backend.stop()
            except Exception:
                pass


_mp_util.Finalize(None, _reap_leaked_backends, exitpriority=100)


def partition(data, num_partitions):
    """Split a list into ``num_partitions`` contiguous partitions.

    The local-mode stand-in for ``sc.parallelize(data, n)``; Spark's formula
    (elements spread as evenly as possible) is used so partition sizes match
    what the reference's feeders would see.
    """
    items = list(data)
    n = len(items)
    out = []
    for i in range(num_partitions):
        start = (i * n) // num_partitions
        stop = ((i + 1) * n) // num_partitions
        out.append(items[start:stop])
    return out


class JobHandle(object):
    """Handle for an asynchronously running backend job."""

    def __init__(self, num_tasks):
        self.num_tasks = num_tasks
        self._done = threading.Event()
        self._lock = threading.Lock()
        self._completed = 0
        self.error = None  # first task error (formatted traceback string)
        self.results = [None] * num_tasks
        self.task_errors = [None] * num_tasks  # per-task error strings

    def _task_done(self, index, ok, payload):
        with self._lock:
            if ok:
                self.results[index] = payload
                self.task_errors[index] = None
            else:
                self.task_errors[index] = payload
                if self.error is None:
                    self.error = payload
            self._completed += 1
            if self._completed >= self.num_tasks or not ok:
                self._done.set()

    def _set_progress(self, completed):
        """Monotonically update the completed-task count from an external
        progress source (Spark statusTracker) without firing completion —
        task results/errors still arrive via ``_task_done``."""
        with self._lock:
            if completed > self._completed:
                self._completed = min(completed, self.num_tasks)

    def _finish_ok(self):
        """Mark the whole job successfully finished (backends that only
        observe job-level completion, e.g. Spark's ``foreachPartition``)."""
        with self._lock:
            self._completed = self.num_tasks
            self._done.set()

    def done(self):
        return self._done.is_set()

    def wait(self, timeout=None):
        """Block until all tasks finished; raises on the first task error."""
        if not self._done.wait(timeout):
            raise TimeoutError("job did not complete within {}s".format(timeout))
        if self.error is not None:
            raise RuntimeError("job failed:\n{}".format(self.error))
        return self.results

    def wait_settled(self, timeout=None):
        """Block until EVERY task reached a terminal state (ok, failed, or
        skipped) — unlike :meth:`wait`, which fires on the *first* failure
        while sibling tasks may still be in flight.  The retry machinery
        needs the settled view: retrying a partition whose original task is
        still running would double-feed its rows.
        """
        deadline = None if timeout is None else time.time() + timeout
        while True:
            with self._lock:
                if self._completed >= self.num_tasks:
                    return
            if deadline is not None and time.time() > deadline:
                raise TimeoutError(
                    "job did not settle within {}s".format(timeout))
            time.sleep(0.05)

    def failed_tasks(self):
        """``[(task_index, error_string), ...]`` for tasks that failed or
        were skipped; call after :meth:`wait_settled`."""
        with self._lock:
            return [(i, e) for i, e in enumerate(self.task_errors)
                    if e is not None]


# ---------------------------------------------------------------------------
# LocalBackend: executor worker process main loop
# ---------------------------------------------------------------------------

def _read_exact(fd, n):
    data = b""
    while len(data) < n:
        chunk = os.read(fd, n - len(data))
        if not chunk:
            raise EOFError("executor pipe closed")
        data += chunk
    return data


def _recv_result(conn):
    """``conn.recv()`` for one message sent with ``Connection.send``, read
    into one buffer allocated once.

    ``Connection.recv`` reads a large message in pipe-sized chunks with
    ``os.read(fd, remaining)``, and every call allocates a buffer for all
    that is still to come: a transform of four rows of an LM's logits as
    Python floats (about 1.2 GB pickled) spent most of 487 s in that loop
    on the 8-core host of an H100 machine.  Same framing: a ``!i``
    length, or -1 and a ``!Q`` length."""
    fd = conn.fileno()
    size, = struct.unpack("!i", _read_exact(fd, 4))
    if size == -1:
        size, = struct.unpack("!Q", _read_exact(fd, 8))
    buf = bytearray(size)
    view = memoryview(buf)
    got = 0
    while got < size:
        n = os.readv(fd, [view[got:]])
        if n == 0:
            raise EOFError("executor pipe closed mid-message")
        got += n
    return pickle.loads(buf)


def _executor_main(executor_index, workdir, conn, env_overrides):
    """Long-lived executor process: apply env, chdir, serve tasks over a pipe.

    Tasks arrive as ``(task_id, pickled_fn, partition_items)``; results return
    as ``(task_id, ok, result_or_traceback)``.  Environment overrides are
    applied *before* any task runs so that e.g. ``CUDA_VISIBLE_DEVICES`` is
    set before the first CUDA call in user code.
    """
    os.environ.update(env_overrides or {})
    os.makedirs(workdir, exist_ok=True)
    os.chdir(workdir)
    import threading as _threading

    from tensorflowonspark_torch import fault

    _threading.current_thread().name = "executor-{}".format(executor_index)
    # Resolved once per executor (counters are per-process).  Note: specs
    # targeted with ``executor_id`` resolve to NULL here — the executor-id
    # file doesn't exist until a node's start task writes it — so target
    # executor-loss faults via ``env_per_executor`` instead.
    injector = fault.from_env()
    while True:
        try:
            msg = conn.recv()
        except EOFError:
            break
        if msg is None:  # backend shutdown
            break
        task_id, fn_bytes, items = msg
        try:
            fn = cloudpickle.loads(fn_bytes)
            result = fn(iter(items))
            if result is not None and not isinstance(result, (list, tuple)):
                result = list(result)  # drain generators inside the executor
            conn.send((task_id, True, result))
        except Exception:
            conn.send((task_id, False, traceback.format_exc()))
        injector.on_task()  # kill_after_tasks: die AFTER serving N tasks


class LocalBackend(object):
    """Built-in standalone cluster: N long-lived executor processes on this host.

    Args:
      num_executors: number of executor processes.
      env: base environment overrides applied in every executor before the
        first task.
      env_per_executor: optional list of per-executor override dicts (e.g.
        ``CUDA_VISIBLE_DEVICES`` to give each executor its own card).
      workdir_root: parent directory for per-executor working dirs (a fresh
        temp dir by default); each executor gets ``<root>/executor-<i>``, its
        own cwd, which is what makes the executor-id file handshake work.
    """

    #: Per-task outcomes (JobHandle.task_errors) are real here, so the
    #: driver's supervised feed retry can re-dispatch failed partitions.
    supports_task_retry = True

    #: The driver's elastic recovery can ask this backend to spawn a FRESH
    #: executor process into a dead node's freed roster slot
    #: (:meth:`provision_replacement` + :meth:`run_on`).
    supports_replacement = True

    def __init__(self, num_executors, env=None, env_per_executor=None, workdir_root=None):
        self.num_executors = num_executors
        self._owns_root = workdir_root is None
        self.workdir_root = workdir_root or tempfile.mkdtemp(prefix="tfos_tpu_local_")
        self._ctx = get_context("spawn")
        self._base_env = dict(env or {})
        self._procs = []
        self._conns = []
        self._free = _queue.Queue()
        self._stopped = False
        self._excluded = set()  # executor indices fenced off from scheduling
        self._lock = threading.Lock()  # guards _procs/_conns growth
        _live_backends.add(self)
        for i in range(num_executors):
            overrides = dict(env or {})
            if env_per_executor:
                overrides.update(env_per_executor[i] or {})
            self._spawn_executor(i, overrides)
            self._free.put(i)

    def _spawn_executor(self, i, overrides):
        parent_conn, child_conn = self._ctx.Pipe()
        proc = self._ctx.Process(
            target=_executor_main,
            args=(
                i,
                os.path.join(self.workdir_root, "executor-{}".format(i)),
                child_conn,
                overrides,
            ),
            name="local-executor-{}".format(i),
        )
        proc.start()
        child_conn.close()
        self._procs.append(proc)
        self._conns.append(parent_conn)

    # -- scheduling -------------------------------------------------------

    def _run_one(self, executor_index, task_id, fn_bytes, items, handle):
        conn = self._conns[executor_index]
        try:
            conn.send((task_id, fn_bytes, items))
            # recv with a LIVENESS poll, not a bare recv: an executor whose
            # task spawned children (every node runtime forks a manager
            # server) leaves those children holding a dup of the pipe fd,
            # so a SIGKILLed executor never EOFs the pipe — the job would
            # wedge forever instead of failing (observed: vanished-executor
            # shutdown hang).
            while not conn.poll(1.0):
                if not self._procs[executor_index].is_alive():
                    if conn.poll(0.5):
                        break  # final response raced with process exit
                    raise EOFError("executor process died")
            rid, ok, payload = _recv_result(conn)
            assert rid == task_id
            handle._task_done(task_id, ok, payload)
        except (EOFError, OSError):
            if self._stopped:
                return
            handle._task_done(
                task_id,
                False,
                "executor {} died while running task {} (exitcode={})".format(
                    executor_index, task_id, self._procs[executor_index].exitcode
                ),
            )
        finally:
            if (self._procs[executor_index].is_alive()
                    and executor_index not in self._excluded):
                self._free.put(executor_index)

    def exclude(self, executor_index):
        """Fence an executor off from future scheduling (liveness monitor:
        its node process died, so tasks landing there would feed a corpse).
        In-flight tasks finish/fail on their own; the slot is simply never
        returned to the free pool."""
        if 0 <= executor_index < self.num_executors:
            self._excluded.add(executor_index)
            logger.warning("executor %d excluded from scheduling", executor_index)
            from tensorflowonspark_torch import telemetry
            telemetry.get_tracer().instant("backend/executor_excluded",
                                           executor_id=executor_index)

    def provision_replacement(self, env=None):
        """Spawn a FRESH executor process for elastic recovery; returns its
        executor index (a brand-new identity — never a recycled index, so
        the liveness monitor's zombie fence on the dead executor keeps
        holding).  The new executor gets its own working directory and does
        NOT enter the free pool until its first task (the replacement start
        task dispatched via :meth:`run_on`) completes."""
        from tensorflowonspark_torch import telemetry
        with telemetry.get_tracer().span("backend/provision_replacement"):
            with self._lock:
                if self._stopped:
                    # A liveness monitor racing teardown must not spawn an
                    # executor nobody will ever stop.
                    raise RuntimeError("backend stopped; no replacements")
                i = len(self._procs)
                overrides = dict(self._base_env)
                overrides.update(env or {})
                self._spawn_executor(i, overrides)
                self.num_executors = len(self._procs)
        logger.warning("provisioned replacement executor %d", i)
        return i

    def run_on(self, executor_index, fn, items):
        """Dispatch one task DIRECTLY onto ``executor_index``, bypassing the
        free pool (elastic recovery must land the replacement start task on
        the replacement executor — any other executor's working dir already
        hosts a node).  Returns a single-task :class:`JobHandle`; when the
        task finishes, the executor joins the free pool for ordinary
        scheduling (``_run_one``'s finally)."""
        handle = JobHandle(1)
        fn_bytes = cloudpickle.dumps(fn)
        t = threading.Thread(
            target=self._run_one,
            args=(executor_index, 0, fn_bytes, list(items), handle),
            name="task-on-{}".format(executor_index),
            daemon=True,
        )
        t.start()
        return handle

    def _live_executors(self):
        return [i for i, p in enumerate(self._procs)
                if p.is_alive() and i not in self._excluded]

    def foreach_partition_async(self, partitions, fn):
        """Dispatch ``fn(iter(partition))`` per partition onto free executors."""
        handle = JobHandle(len(partitions))
        fn_bytes = cloudpickle.dumps(fn)

        def _dispatch():
            threads = []
            for task_id, items in enumerate(partitions):
                if handle.error is not None:
                    # Job-level cancel: a sibling task already failed, so
                    # don't keep feeding the failed job's remaining tasks to
                    # executors (wait() has raised; stop() may be imminent).
                    # In-flight tasks finish on their own.
                    handle._task_done(
                        task_id, False,
                        "task skipped: job cancelled after an earlier task "
                        "failure")
                    continue
                # Poll the free queue instead of blocking forever: a dead or
                # excluded executor's slot never returns, so a bare get()
                # would starve the dispatcher once nodes start dying.
                executor_index = None
                while executor_index is None:
                    try:
                        executor_index = self._free.get(timeout=1.0)
                    except _queue.Empty:
                        if self._stopped:
                            break
                        if not self._live_executors():
                            break  # no executor can ever serve this task
                        continue
                    if (executor_index in self._excluded
                            or not self._procs[executor_index].is_alive()):
                        executor_index = None  # drop the stale slot token
                if executor_index is None:
                    handle._task_done(
                        task_id, False,
                        "backend stopped" if self._stopped else
                        "task {} unschedulable: no live executors remain "
                        "(all died or were excluded)".format(task_id))
                    continue
                if self._stopped:
                    handle._task_done(task_id, False, "backend stopped")
                    continue
                t = threading.Thread(
                    target=self._run_one,
                    args=(executor_index, task_id, fn_bytes, list(items), handle),
                    name="task-{}".format(task_id),
                    daemon=True,
                )
                t.start()
                threads.append(t)

        threading.Thread(target=_dispatch, name="job-dispatch", daemon=True).start()
        return handle

    def foreach_partition(self, partitions, fn, timeout=None):
        self.foreach_partition_async(partitions, fn).wait(timeout)

    def map_partitions(self, partitions, fn, timeout=None):
        """Run ``fn`` per partition and return the list of per-partition results."""
        return self.foreach_partition_async(partitions, fn).wait(timeout)

    def stop(self):
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            conns = list(self._conns)
            procs = list(self._procs)
        _live_backends.discard(self)
        for conn in conns:
            try:
                conn.send(None)
            except OSError:
                pass
        for proc in procs:
            proc.join(timeout=5)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5)
                if proc.is_alive():
                    proc.kill()
                    proc.join(timeout=1)
        if self._owns_root:
            shutil.rmtree(self.workdir_root, ignore_errors=True)


# ---------------------------------------------------------------------------
# SparkBackend: adapter over a live SparkContext (requires pyspark)
# ---------------------------------------------------------------------------

class SparkBackend(object):
    """Adapter over ``pyspark.SparkContext`` matching the backend contract.

    Deployment-equivalent to the reference: the "start job" is
    ``sc.parallelize(range(n), n).foreachPartition(fn)`` on a background thread
    (reference ``TFCluster.py:312-329``) and feed jobs are ``rdd.foreachPartition``
    / ``rdd.mapPartitions`` (reference ``TFCluster.py:92,113``).  Requires one
    task slot per executor, exactly like the reference
    (``TFSparkNode.py:110-115``).

    ``partitions`` arguments may be RDDs (used as-is) or lists (parallelized).

    Elastic recovery on Spark is **Spark's own**: when an executor dies,
    Spark re-runs its failed start/feed tasks on another executor
    (``spark.task.maxFailures``), so a replacement node "re-lands" with the
    task rather than via :meth:`LocalBackend.provision_replacement` — the
    re-run start task registers from its fresh executor and claims the dead
    node's released ``(job_name, task_index)`` slot exactly like a built-in
    replacement would (the reservation server's admission path is backend
    agnostic; only *who spawns the process* differs).  The driver therefore
    does not request replacements here (``supports_replacement = False``).
    """

    #: Spark only reports job-level outcomes to the driver (task retries are
    #: Spark's own); the supervised feed retry therefore skips this backend.
    supports_task_retry = False

    #: Replacement processes come from Spark's task retry (see class doc),
    #: not from a driver-side provisioning call.
    supports_replacement = False

    def __init__(self, sc, num_executors=None):
        import pyspark  # gated: only needed when this backend is chosen

        assert isinstance(sc, pyspark.SparkContext)
        self.sc = sc
        self.num_executors = num_executors or int(
            sc.getConf().get("spark.executor.instances", "1")
        )

    def _to_rdd(self, partitions):
        if hasattr(partitions, "foreachPartition"):  # already an RDD
            return partitions
        flat = [item for part in partitions for item in part]
        return self.sc.parallelize(flat, len(partitions))

    def foreach_partition_async(self, partitions, fn):
        rdd = self._to_rdd(partitions)
        handle = JobHandle(rdd.getNumPartitions())
        # uuid, not id(): a freed handle's address can be reused, and a
        # recycled group name would let statusTracker count a PRIOR job's
        # completed tasks into this handle's progress.
        import uuid

        job_group = "tfos-{}".format(uuid.uuid4().hex)

        def _run():
            # Job group scopes the statusTracker queries below to this job
            # (setJobGroup is thread-local, so it must be set in the thread
            # that triggers the action).
            self.sc.setJobGroup(job_group, "tensorflowonspark_torch job")
            try:
                rdd.foreachPartition(fn)
                handle._finish_ok()
            except Exception:
                handle._task_done(0, False, traceback.format_exc())

        t = threading.Thread(target=_run, name="spark-job", daemon=True)
        t.start()
        threading.Thread(target=self._track_progress,
                         args=(job_group, handle),
                         name="spark-job-progress", daemon=True).start()
        return handle

    def _track_progress(self, job_group, handle):
        """Feed per-task completion counts into the JobHandle while the job
        runs (reference statusTracker active-task polling,
        ``TFCluster.py:152-167``).

        Without this, ``_completed`` would only move when the WHOLE job ends
        — and a job whose ps/evaluator tasks park forever never ends, so
        FILES-mode shutdown (which waits for ``_completed >= num_workers``)
        would spin until the SIGALRM watchdog.
        """
        while not handle.done():
            try:
                st = self.sc.statusTracker()
                completed = 0
                for job_id in st.getJobIdsForGroup(job_group):
                    info = st.getJobInfo(job_id)
                    if info is None:
                        continue
                    for stage_id in info.stageIds:
                        si = st.getStageInfo(stage_id)
                        if si is not None:
                            completed += si.numCompletedTasks
                handle._set_progress(completed)
            except Exception:
                logger.debug("statusTracker poll failed", exc_info=True)
            time.sleep(1)

    def foreach_partition(self, partitions, fn, timeout=None):
        self.foreach_partition_async(partitions, fn).wait(timeout)

    def map_partitions(self, partitions, fn, timeout=None):
        rdd = self._to_rdd(partitions)
        return rdd.mapPartitions(lambda it: [fn(it)]).collect()

    def stop(self):
        pass  # the caller owns the SparkContext's lifecycle

    @property
    def default_fs(self):
        """Filesystem defaultFS from the Hadoop conf (reference TFCluster.py:269-272)."""
        return self.sc._jsc.hadoopConfiguration().get("fs.defaultFS")
