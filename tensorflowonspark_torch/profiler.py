"""Profiling lifecycle (the port of the JAX package's ``profiler`` module,
on ``torch.profiler``).

The reference's tracing story is TensorBoard managed by the framework plus
example-level step profiling (``--profile_steps`` building a Keras profiler
callback, reference ``examples/resnet/common.py:192-197,293-300``).  Here:

- :func:`start_server` — a per-process capture endpoint.  PyTorch has no
  remote profiler server like ``jax.profiler.start_server``'s gRPC one, so
  this is a small HTTP endpoint: ``GET /capture?duration_ms=&steps=`` runs
  the cluster capture's own function
  (:func:`~tensorflowonspark_torch.profiling.capture_trace`) in this process
  and answers with the gzipped Chrome trace.  TensorBoard's profile plugin
  cannot dial it.  The node runtime starts one in the process that runs the
  user fn when ``cluster.run(..., profiler=True)``, and publishes its port
  in the cluster roster.
- :class:`StepProfiler` — trace capture over a step range, the
  ``--profile_steps start,stop`` behavior: call :meth:`on_step_end` once per
  step and the trace of [start, stop] lands in ``log_dir`` as a gzipped
  Chrome trace (``*.pt.trace.json.gz``, the file TensorBoard's PyTorch
  plugin and Perfetto read).

The profiler records CUDA activity only where this process already has a
card in use, and the CPU alone otherwise: nothing here initializes CUDA.
"""

import logging
import os
import socket
import sys
import threading
import time

from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

logger = logging.getLogger(__name__)

#: file suffix of every trace this module and :mod:`profiling` write
TRACE_SUFFIX = ".pt.trace.json.gz"


def _cuda_in_use():
    """True when this process already initialized CUDA (never initializes
    it: a forked node child and the driver must stay CUDA-free)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_initialized()


def preload():
    """Start and stop one CPU profile on the calling thread, so that what a
    profiler imports and initializes on its first start happens here.  A
    capture runs on a side thread, and a first start there imports
    ``torch._inductor`` and ``torch._dynamo`` while the training thread may
    be importing them itself (the optimizers do, on their first step): an
    import deadlock.  The node preloads before the user fn starts, and
    before the capture endpoint starts, where captures are on.  Once per
    process (its seconds: :data:`preload_secs`); initializes no CUDA."""
    global preload_secs
    if preload_secs is not None:
        return
    from torch.profiler import ProfilerActivity, profile

    t0 = time.monotonic()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    prof.stop()
    preload_secs = time.monotonic() - t0


#: seconds this process's :func:`preload` took (None before it ran)
preload_secs = None


def new_profile(all_threads=False):
    """A ``torch.profiler.profile`` over the CPU and, where this process
    already has a card in use, CUDA activity; shapes and stacks off (a
    full-width step emits thousands of events).

    ``all_threads`` records the CPU ops of every thread, not only the one
    that starts the profile: a capture started from a side thread then
    still sees the training thread's ops, where this torch has the option
    (``_ExperimentalConfig(profile_all_threads=)``).  Returns ``(profile,
    all_threads_recorded)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if _cuda_in_use():
        activities.append(ProfilerActivity.CUDA)
    if all_threads:
        try:
            from torch._C._profiler import _ExperimentalConfig

            config = _ExperimentalConfig(profile_all_threads=True)
            return profile(activities=activities,
                           experimental_config=config), True
        except (ImportError, TypeError):
            logger.info("torch %s cannot profile all threads; the trace "
                        "holds the capturing thread's ops and the card's",
                        torch.__version__)
    return profile(activities=activities), False


def synchronize():
    """Wait for the card's queued work where CUDA is in use, so a trace
    window starts and ends on kernel boundaries of the host's steps."""
    if _cuda_in_use():
        sys.modules["torch"].cuda.synchronize()


#: seconds the card idles inside each edge of a :class:`StepProfiler`
#: window (where CUDA is in use)
EDGE_SECS = 0.5
#: kernels of another name the card runs inside each edge of a
#: :class:`StepProfiler` window, before the idle time (where CUDA is in use)
EDGE_KERNELS = 256


def _settle():
    """Run :data:`EDGE_KERNELS` one-element adds, wait for the card's
    queued work, then let it idle :data:`EDGE_SECS`.  In a process that
    has run other profiles before, the CUDA profiler has dropped the
    record of one flash kernel of a window (on an H100: one flash forward
    of 24 in a window of three steps, late in a long run, with the idle
    edges alone); windows padded with kernels of another name and a pause
    at both ends have not lost one.  So a step window keeps every step's
    kernels well inside such padding."""
    if _cuda_in_use():
        torch = sys.modules["torch"]
        pad = torch.zeros(1, device="cuda")
        for _ in range(EDGE_KERNELS):
            pad.add_(1.0)
        synchronize()
        time.sleep(EDGE_SECS)


def write_trace(prof, log_dir):
    """Export a stopped profile into ``log_dir`` as
    ``<host>_<pid>.<ms><TRACE_SUFFIX>`` (gzipped); returns the path."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "{}_{}.{}{}".format(
        socket.gethostname(), os.getpid(), int(time.time() * 1000),
        TRACE_SUFFIX))
    prof.export_chrome_trace(path)
    return path


def start_server(port=None, sock=None):
    """Start this process's capture endpoint; returns its port (0 when it
    could not start).  Idempotent per process: later calls return the
    first port.

    ``sock``: an already bound, not yet listening socket to serve on (the
    node reserves the port in the executor shell before registration and
    hands the socket to the process that runs the user fn); else ``port``
    (an ephemeral one when None) is bound here.

    A FAILED start does not latch: ``_server_port`` stays ``None`` so the
    next call retries (a transient bind race at bring-up must not cost the
    node its capture capability for good), while ``_server_state`` records
    the last outcome for the heartbeat counter (:func:`server_counters`)."""
    global _server_port, _server_state, _server
    if _server_port is not None:
        return _server_port
    try:
        server = _bind(port, sock)
    except Exception:
        logger.warning("profiler capture endpoint unavailable",
                       exc_info=True)
        _server_state = "down"
        return 0
    threading.Thread(target=server.serve_forever,
                     kwargs={"poll_interval": 0.2},
                     name="tfos-profiler-server", daemon=True).start()
    _server = server
    _server_port = server.server_address[1]
    _server_state = "up"
    logger.info("profiler capture endpoint listening on port %d",
                _server_port)
    return _server_port


def _bind(port, sock):
    """The endpoint's ``ThreadingHTTPServer``, listening (see
    :func:`start_server`)."""
    if sock is None:
        server = ThreadingHTTPServer(("", int(port or 0)), _CaptureHandler)
    else:
        server = ThreadingHTTPServer(sock.getsockname()[:2],
                                     _CaptureHandler,
                                     bind_and_activate=False)
        server.socket.close()
        server.socket = sock
        server.server_address = sock.getsockname()[:2]
        server.server_activate()
    server.daemon_threads = True
    return server


def _query_int(params, name):
    vals = params.get(name)
    return int(vals[0]) if vals else None


class _CaptureHandler(BaseHTTPRequestHandler):
    """``GET /capture?duration_ms=&steps=``: one capture in this process,
    answered as the gzipped Chrome trace (``application/gzip``), the
    capture's facts in ``X-Tfos-Capture-*`` headers; 400 on a bad query,
    500 when the capture failed.  A request waits while another capture
    runs in this process."""

    def do_GET(self):
        import urllib.parse

        from tensorflowonspark_torch import profiling

        path, _, query = self.path.partition("?")
        if path not in ("/capture", "/capture/"):
            self.send_error(404)
            return
        params = urllib.parse.parse_qs(query)
        try:
            duration_ms = _query_int(params, "duration_ms")
            steps = _query_int(params, "steps")
        except ValueError:
            self._reply(400, b"duration_ms and steps must be integers\n",
                        "text/plain")
            return
        try:
            body, info = profiling.capture_bytes(duration_ms=duration_ms,
                                                 steps=steps)
        except Exception as e:
            logger.exception("capture endpoint: capture failed")
            self._reply(500, (repr(e) + "\n").encode(), "text/plain")
            return
        headers = {"X-Tfos-Capture-" + k.replace("_", "-"): str(v)
                   for k, v in info.items()}
        self._reply(200, body, "application/gzip", headers)

    def _reply(self, code, body, ctype, headers=None):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for key, value in (headers or {}).items():
            self.send_header(key, value)
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # quiet: no stderr per request
        logger.debug("profiler endpoint: " + fmt, *args)


def server_counters():
    """Heartbeat-counter view of the capture endpoint: ``{}`` when a start
    was never attempted, else ``profiler_server_up_max`` 1/0 (``_max``
    suffix -> rendered as a Prometheus gauge by the observatory)."""
    if _server_state is None:
        return {}
    return {"profiler_server_up_max": 1 if _server_state == "up" else 0}


_server = None
_server_port = None
_server_state = None  # None = never attempted, else "up"/"down" (last try)


def _forget_server():
    """A forked child inherits the module state but not the server's
    thread: it starts its own endpoint, if any."""
    global _server, _server_port, _server_state
    _server = _server_port = _server_state = None


os.register_at_fork(after_in_child=_forget_server)


def parse_profile_steps(spec):
    """``"start,stop"`` -> (start, stop) step numbers (reference flag format,
    ``common.py:293-300``)."""
    if not spec:
        return None
    parts = [p.strip() for p in str(spec).split(",")]
    if len(parts) != 2:
        raise ValueError(
            "profile_steps must be 'start,stop', got {!r}".format(spec))
    start, stop = int(parts[0]), int(parts[1])
    if start < 0 or stop < start:
        raise ValueError(
            "need 0 <= start <= stop in profile_steps, got {!r}".format(spec))
    return start, stop


class StepProfiler(object):
    """Capture a trace over a global-step range.

    Usage: ``prof = StepProfiler(log_dir, "10,20")`` then call
    ``prof.on_step_begin()`` before and ``prof.on_step_end()`` after every
    step; the trace starts before step ``start`` executes and stops after
    step ``stop``.  Callers that only hook ``on_step_end`` still get a
    trace (it starts lazily, one step late — after step ``start``
    completes) as long as the range spans more than one step.

    On a card the window is exact: the profiler starts and stops after the
    card has run every step queued before, with :data:`EDGE_KERNELS`
    kernels of another name and :data:`EDGE_SECS` of idle time inside each
    edge, so the trace holds the kernels of ``stop - start + 1`` steps.  The trace is written at :meth:`stop`; its
    path is ``trace_path``.
    """

    def __init__(self, log_dir, profile_steps):
        self.log_dir = log_dir
        self.bounds = parse_profile_steps(profile_steps)
        self.step = 0
        self.trace_path = None
        self._prof = None

    @property
    def _active(self):
        return self._prof is not None

    def _start(self):
        from tensorflowonspark_torch import profiling

        synchronize()
        prof, _ = new_profile()
        with profiling.cuda_graph_lock:
            prof.start()
        _settle()
        self._prof = prof
        logger.info("profiler trace started at step %d -> %s",
                    self.step, self.log_dir)

    def on_step_begin(self):
        if self.bounds and not self._active and self.step == self.bounds[0]:
            self._start()

    def on_step_end(self):
        self.step += 1
        if not self.bounds:
            return
        if self._active and self.step > self.bounds[1]:
            self.stop()
        elif (not self._active
              and self.bounds[0] <= self.step <= self.bounds[1]):
            # on_step_begin was never called: start late rather than never.
            self._start()

    def stop(self):
        if self._active:
            from tensorflowonspark_torch import profiling

            prof, self._prof = self._prof, None
            _settle()
            with profiling.cuda_graph_lock:
                prof.stop()
            self.trace_path = write_trace(prof, self.log_dir)
            logger.info("profiler trace stopped at step %d -> %s",
                        self.step, self.trace_path)

    # Context-manager form: an exception between start/stop would otherwise
    # leak an active profiler and poison the next capture attempt (a second
    # profiler cannot start while one is running).
    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
        return False
