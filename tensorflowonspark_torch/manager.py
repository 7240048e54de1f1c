"""Per-executor IPC broker (reference ``TFManager.py``).

A ``multiprocessing.managers.BaseManager`` serving named ``JoinableQueue``s and
a key-value state store to every process on (or connecting to) an executor:

- queues: ``input`` (feed data), ``output`` (inference results), ``error``
  (exception tracebacks from user code), ``control`` (lifecycle signals for
  parked background roles) — reference ``TFManager.py:54-55`` plus the
  per-role queue wiring in ``TFSparkNode.py:174-185``.
- state: small kv store (e.g. ``'state' -> 'running'|'terminating'|'stopped'``)
  — reference ``TFManager.py:30-37``.

Modes (reference ``TFManager.py:60-63``):

- ``'local'``  — unix-socket address; reachable only by processes on this
  executor host (workers).
- ``'remote'`` — TCP on an ephemeral port; reachable by the driver, used for
  long-running non-worker roles (ps-like/evaluator) so the driver can signal
  shutdown directly (reference ``TFCluster.py:186-192``).

The manager server runs in a forked child; :func:`start` MUST be called before
the executor initializes CUDA: a forked child cannot use a CUDA context its
parent created.

Proxy note: values returned by proxied *methods* travel by value while objects
returned by registered *callables* travel as proxies — hence the kv store is a
proxied object with ``get``/``set`` methods, and :class:`ManagerHandle` hides
the indirection behind the reference's ``mgr.get/set/get_queue`` surface.
"""

import logging
import multiprocessing
from multiprocessing.managers import BaseManager

logger = logging.getLogger(__name__)

# Module-level registries, inherited by the forked manager server process
# (reference ``TFManager.py:20-22``).
qdict = {}


class _KVStore(object):
    def __init__(self):
        self._data = {}

    def get(self, key):
        return self._data.get(key)

    def set(self, key, value):
        self._data[key] = value


_kv = _KVStore()


def _get_kv():
    return _kv


def _get_queue(qname):
    return qdict.get(qname)


class TPUManager(BaseManager):
    """Python multiprocessing.Manager for distributed, multi-process communication."""


TPUManager.register("get_kv", callable=_get_kv)
TPUManager.register("get_queue", callable=_get_queue)


class ManagerHandle(object):
    """Reference-shaped facade (``mgr.get_queue/get/set``) over the proxies.

    Safely crosses fork boundaries (background user-fn processes inherit it
    via ``ctx.mgr``, reference ``TFSparkNode.py:334-342``).
    """

    def __init__(self, mgr, address, authkey):
        self._mgr = mgr
        self.address = address
        self.authkey = authkey

    def get_queue(self, qname):
        return self._mgr.get_queue(qname)

    def get(self, key):
        return self._mgr.get_kv().get(key)

    def set(self, key, value):
        self._mgr.get_kv().set(key, value)

    def shutdown(self):
        self._mgr.shutdown()


def start(authkey, queues, mode="local"):
    """Create a new manager server process for this executor.

    Args:
      authkey: bytes auth key shared with all connecting processes.
      queues: names of JoinableQueues to serve (reference ``TFSparkNode.py:174-185``
        passes ``['input', 'output', 'error']`` for workers plus ``'control'``
        for background roles).
      mode: ``'local'`` or ``'remote'`` (see module docstring).

    Returns:
      a :class:`ManagerHandle`; ``.address`` is the connect address.
    """
    qdict.clear()
    _kv._data.clear()
    for qname in queues:
        qdict[qname] = multiprocessing.JoinableQueue()

    # Fork explicitly: the registries above must be inherited by the server
    # process, and the caller guarantees CUDA is not initialized yet.
    ctx = multiprocessing.get_context("fork")
    if mode == "remote":
        mgr = TPUManager(address=("", 0), authkey=authkey, ctx=ctx)
    else:
        mgr = TPUManager(authkey=authkey, ctx=ctx)
    mgr.start(initializer=_die_with_parent)
    logger.info("started %s manager at %s", mode, mgr.address)
    return ManagerHandle(mgr, mgr.address, authkey)


def _die_with_parent():
    """Manager-server initializer: die when the owning executor dies.

    A SIGKILLed executor cannot shut its manager down, and the orphan is
    worse than a leak: it inherits the executor's pipe/resource-tracker fds,
    so the driver's exit blocks forever in the tracker join (observed:
    vanished-executor shutdown hang).  Linux parent-death-signal closes the
    hole; elsewhere this is a no-op (orphans persist until cluster teardown
    kills them explicitly)."""
    try:
        import ctypes
        import signal as _signal

        PR_SET_PDEATHSIG = 1
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(PR_SET_PDEATHSIG, _signal.SIGKILL, 0, 0, 0)
    except Exception:  # non-Linux / restricted: best-effort only
        pass


def connect(address, authkey):
    """Connect to an existing manager server (reference ``TFManager.py:68-83``)."""
    if isinstance(address, list):  # JSON round-trip turns tuples into lists
        address = tuple(address)
    # Nested proxies (the returned queue/kv objects) authenticate against the
    # connecting process's authkey, so it must match the manager's.
    multiprocessing.current_process().authkey = authkey
    m = TPUManager(address=address, authkey=authkey)
    m.connect()
    return ManagerHandle(m, address, authkey)
