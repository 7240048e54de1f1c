"""Miscellaneous host-side utilities (reference ``util.py:19-75``).

These run in driver and executor processes alike and must not touch CUDA (the
driver and the executor shells fork; only the user-fn child initializes the
card, mirroring the reference's deferred ``import tensorflow`` at
``TFSparkNode.py:137``).
"""

import errno
import logging
import os
import socket

logger = logging.getLogger(__name__)

# Name of the CWD file that persists this executor's id so that later feed tasks
# scheduled onto the same executor can locate its manager (reference
# ``util.py:66-75`` and the executor-id handshake described in SURVEY §7.4.2).
EXECUTOR_ID_FILE = "executor_id"


def get_ip_address():
    """Best-effort IP address of the current host.

    Uses the UDP-connect trick (no packets are sent) like reference
    ``util.py:41-54``; falls back to loopback when the host is offline.
    """
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("10.255.255.255", 1))
        ip = s.getsockname()[0]
    except OSError:
        ip = "127.0.0.1"
    finally:
        s.close()
    return ip


def find_in_path(path, file_name):
    """Find a file in a ':'-separated path string (reference ``util.py:57-63``)."""
    for p in path.split(os.pathsep):
        candidate = os.path.join(p, file_name)
        if os.path.exists(candidate) and os.path.isfile(candidate):
            return candidate
    return False


def write_executor_id(num, working_dir=None):
    """Persist this executor's id to a file in its working dir.

    Reference ``util.py:66-69``.  Later jobs (feed tasks) that land on the same
    executor read this file to reconnect to the long-running node's manager.
    """
    path = os.path.join(working_dir or os.getcwd(), EXECUTOR_ID_FILE)
    with open(path, "w") as f:
        f.write(str(num))


def read_executor_id(working_dir=None):
    """Read the executor id persisted by :func:`write_executor_id`.

    Reference ``util.py:72-75``.  Raises a descriptive error when the file is
    missing (a feed task arrived on an executor that never ran a node task —
    the one-task-per-executor discipline was violated).
    """
    path = os.path.join(working_dir or os.getcwd(), EXECUTOR_ID_FILE)
    try:
        with open(path) as f:
            return int(f.read())
    except OSError as e:
        if e.errno == errno.ENOENT:
            raise RuntimeError(
                "No executor_id file found in {!r}. A data-feeding task was "
                "scheduled on an executor that is not running a cluster node; "
                "ensure one task slot per executor (see cluster.run docs).".format(
                    os.path.dirname(path) or os.getcwd()
                )
            )
        raise

