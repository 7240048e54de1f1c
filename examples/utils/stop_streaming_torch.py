"""Externally stop a running streaming cluster of the PyTorch port (the
twin of ``examples/utils/stop_streaming.py``; reference
``examples/utils/stop_streaming.py:1-18``): connect a reservation client to
the driver's rendezvous server and request STOP.  The feeding loop observes
``server.done`` and winds the stream down cleanly.

Usage:
    python examples/utils/stop_streaming_torch.py <host> <port>
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from tensorflowonspark_torch import reservation  # noqa: E402


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print(__doc__)
        sys.exit(2)
    host, port = argv[0], int(argv[1])
    client = reservation.Client((host, port))
    client.request_stop()
    client.close()
    print("STOP sent to {}:{}".format(host, port))


if __name__ == "__main__":
    main()
