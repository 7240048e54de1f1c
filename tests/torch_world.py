"""Run a function in a small ``torch.distributed`` world, one spawned
process per rank, for the port's multi-process tests: gloo on the CPU, or
NCCL with rank ``r`` on card ``r``.

``run_world(fn, world, *args)`` calls ``fn(rank, *args)`` in every rank
after ``init_process_group`` on a free localhost port and returns the
results by rank; a rank that raises fails the call with its traceback.
``fn`` must be a module-level function (it is pickled by reference into
the spawned processes).
"""

import multiprocessing
import socket
import traceback


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, results, backend, args):
    import torch
    import torch.distributed as dist

    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method="tcp://127.0.0.1:{}".format(
        port), world_size=world, rank=rank)
    try:
        results.put((rank, fn(rank, *args), None))
    except Exception:
        results.put((rank, None, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def run_world(fn, world, *args, backend="gloo", timeout=120):
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, rank, world, port, results, backend,
                               args))
             for rank in range(world)]
    for p in procs:
        p.start()
    try:
        got = [results.get(timeout=timeout) for _ in procs]
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    errors = [err for _, _, err in got if err]
    assert not errors, errors[0]
    return [value for _, value, _ in sorted(got, key=lambda r: r[0])]
