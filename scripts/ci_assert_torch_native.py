"""CI gate of the port's C++ engines (the twin of
``scripts/ci_assert_native.py``, on ``tensorflowonspark_torch``; it
imports no jax): the C++ engines must be the ones under test.

Every native-backed module has a pure-python fallback for hosts without a
toolchain — correct for users, WRONG for CI, where a missing compiler or
header would silently demote the suite to fallback coverage.

Port modules driven: ``native`` (the build/load shim of ``native/``),
``shmring._lib()`` (with the symbols ``shmring_writev``, ``shmring_peek``
and ``shmring_consume``) and ``tfrecord._lib()``.

Exit 0 = all required engines built.  The JAX gate's ``--require-pjrt``
(the PJRT runner and its mock plugin) has no counterpart: the port loads
no PJRT plugin.  In its place ``--require-runner`` builds the port's
serving runner, ``csrc/aoti_runner.cpp`` (the C++ AOTInductor runner) and
``csrc/flash_ops.cpp``, through ``ops._build.build_native``; like the JAX
flag it is off by default.  On the card ``chip_smoke.py``'s ``export``
phase builds and runs that runner.

    python scripts/ci_assert_torch_native.py [--require-runner]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--require-runner", action="store_true")
    args = ap.parse_args()

    from tensorflowonspark_torch import shmring, tfrecord

    assert tfrecord._lib() is not None, "C++ tfrecord codec not built"
    # go through shmring's own loader (it carries the librt link flag for
    # pre-glibc-2.34 hosts) — a bare native.load here could cache a handle
    # built without it
    ring_lib = shmring._lib()
    assert ring_lib is not None, "C++ shm ring not built"
    # the zero-copy columnar feed path needs the vectored-write and
    # two-phase read entry points; an older cached .so without them would
    # silently demote every ColChunk to the pickled path
    for sym in ("shmring_writev", "shmring_peek", "shmring_consume"):
        assert hasattr(ring_lib, sym), \
            "libshmring.so missing symbol {} (stale build?)".format(sym)
    print("native engines OK: tfrecord, shmring (+writev/peek/consume)")
    if args.require_runner:
        from tensorflowonspark_torch.ops import _build

        built = _build.build_native()
        for name in _build.NATIVE:
            assert name in built and os.path.exists(built[name]["path"]), \
                "{} failed to build: {}".format(name, built.get(name))
        print("native engines OK: {}".format(", ".join(sorted(built))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
