"""Standalone batch-inference CLI (reference ``Inference.scala`` +
``TFModel.scala``), the port's counterpart of
:mod:`tensorflowonspark_tpu.inference_cli`.

Loads TFRecords (with an optional ``--schema_hint``), feeds them through a
cached :class:`~tensorflowonspark_torch.serving.ModelServer` with JSON
input/output mappings, and writes predictions as JSON lines (reference
``Inference.scala:27-79``, ``TFModel.scala:245-292``).  It runs on the CUDA
card unless ``--device cpu``.

Usage:
    python -m tensorflowonspark_torch.inference_cli \
        --export_dir /path/to/export --input /path/to/tfrecords \
        --schema_hint 'struct<image:array<float>,label:bigint>' \
        --input_mapping '{"image": "image"}' \
        --output /path/to/preds.jsonl

``--serve`` switches to ONLINE mode: the process becomes one
continuous-batching gateway replica
(:class:`~tensorflowonspark_torch.gateway.GatewayServer`), prints a ready
line and runs until SIGTERM/SIGINT.  Pass ``--roster host:port`` to join a
replica fleet behind the reservation server:

    python -m tensorflowonspark_torch.inference_cli \
        --export_dir /path/to/export --serve --port 8500 \
        --max-batch 64 --max-wait-ms 5 --roster driver:41111

A model-fleet replica resolves its export through the model registry
(:class:`~tensorflowonspark_torch.fleet.ModelRegistry`) instead: ``--registry
ROOT --model NAME[@VERSION]`` serves the pinned version, or the model's live
default, and labels its metrics and roster meta with that version:

    python -m tensorflowonspark_torch.inference_cli \
        --registry /path/to/registry --model lm --serve --port 0 \
        --roster driver:41111 --replica-id lm-0

``--warm-cache-dir W`` (or a registry entry's ``warm_dir``) makes ``W`` the
replica's compile root and warm store
(:mod:`~tensorflowonspark_torch.compilecache`): the kernels build under
``W/kernels``, and each ladder rung's AOTInductor package is stored in ``W``,
so a restarted replica loads its rungs and reaches its ready line with
``compile_count == 0``.

A response is one frame with a 4-byte length: its outputs must stay under
4 GiB (33 rows of the flagship LM's fp32 logits do not fit).

``--native`` serves batch mode with no Python on the serving path: the
export's embedded AOTInductor package (``export_model(...,
embed_batch_size=N)``) runs in the C++ runner (``csrc/aoti_runner.cpp``)
on ``--device``, each batch padded to the package's fixed size.

The JAX CLI's ``--pjrt_plugin PATH`` names a PJRT device plugin, which a
CUDA host has no use for: it is refused with ``NotImplementedError``
naming ``--native``.
"""

import argparse
import json
import logging
import os
import sys

import numpy as np

from tensorflowonspark_torch import (checkpoint, dfutil, schema as schema_mod,
                                     serving)
from tensorflowonspark_torch.device import resolve_device

logger = logging.getLogger(__name__)


def _json_default(o):
    """Numpy scalars/arrays (vectorized TFRecord decode) serialize as plain
    JSON numbers/lists; anything else still fails loudly."""
    if isinstance(o, (np.ndarray, np.generic)):
        return o.tolist()
    raise TypeError(
        "Object of type {} is not JSON serializable".format(type(o).__name__))


def run_inference(export_dir, rows, input_mapping=None, output_name=None,
                  output_mapping=None, batch_size=128, device=None):
    """Yield one output row dict per input row (1:1 contract, reference
    ``TFModel.scala:265-281`` / ``pipeline.py:509-512``).

    N input tensors via ``input_mapping`` ``{column: tensor}`` and M output
    columns via ``output_mapping`` ``{tensor: column}``; ``output_name``
    renames a single-output model's ``prediction`` column.  Runs on the
    CUDA card unless ``device="cpu"``.
    """
    server = serving.ModelServer(export_dir, batch_size, device=device)
    for row in server.run_rows_dict(iter(rows), input_mapping=input_mapping,
                                    output_mapping=output_mapping):
        if output_name and output_name != "prediction" and "prediction" in row:
            row[output_name] = row.pop("prediction")
        yield row


def run_inference_native(export_dir, rows, device=None, input_mapping=None,
                         output_mapping=None):
    """Serve through the C++ runner (``csrc/aoti_runner.cpp``): batches
    are padded to the embedded package's fixed batch size, fed as raw
    buffers, and the runner's outputs zip back into one dict per input
    row.  Requires the export to carry the ``embedded_pt2`` artifact
    (``export_model(..., embed_batch_size=...)``) built for ``device``'s
    type (the CUDA card unless ``"cpu"``)."""
    device = resolve_device(device).type
    with open(os.path.join(checkpoint._fs_path(export_dir),
                           checkpoint._DESCRIPTOR)) as f:
        desc = json.load(f)
    emb = desc.get("embedded_pt2")
    if not emb:
        raise ValueError(
            "export has no embedded_pt2 artifact; re-export with "
            "embed_batch_size set to use --native serving")
    bsz = emb["batch_size"]
    col_for = {t: c for c, t in (input_mapping or {}).items()}
    out_col = dict(output_mapping or {})
    rows = list(rows)
    # every padded chunk first, then ONE runner process for all of them:
    # the package loads once instead of per chunk
    chunks = []
    feeds = []
    for lo in range(0, len(rows), bsz):
        chunk = rows[lo:lo + bsz]
        count = len(chunk)
        feed = {}
        for spec in emb["inputs"]:
            tensor = spec["name"]
            col = col_for.get(tensor, tensor)
            vals = np.asarray([r[col] for r in chunk])
            vals = vals.reshape([-1] + list(spec["shape"][1:]))
            if count < bsz:
                pad = [(0, bsz - count)] + [(0, 0)] * (vals.ndim - 1)
                vals = np.pad(vals, pad)
            feed[tensor] = vals
        chunks.append(chunk)
        feeds.append(feed)
    all_outs = serving.run_embedded_native_many(export_dir, feeds,
                                                device=device)
    for chunk, outs in zip(chunks, all_outs):
        for i in range(len(chunk)):
            row = dict(chunk[i])
            for tensor, arr in outs.items():
                cell = arr[i]
                row[out_col.get(tensor, tensor)] = (
                    cell.tolist() if cell.ndim else cell.item())
            yield row


def _refuse_unported(args):
    """Options of the JAX CLI with no meaning in the port."""
    if getattr(args, "pjrt_plugin", None):
        raise NotImplementedError(
            "--pjrt_plugin names a PJRT device plugin, which a CUDA host has "
            "no use for; the port's C++ runner (ROADMAP item L) serves the "
            "embedded package with --native on --device")


def open_replica(args):
    """A ``--serve`` replica's model: ``(ModelServer, model version)``,
    the export resolved through ``--registry/--model`` where given, and
    the warm-start root (``--warm-cache-dir``, else the registry entry's
    ``warm_dir``) configured and attached."""
    model_version = args.model_version
    if args.registry:
        # fleet mode: resolve --model NAME[@VERSION] through the model
        # registry instead of pinning an export path; the registry entry
        # also supplies the version label and (absent an explicit flag)
        # the shared warm dir
        from tensorflowonspark_torch import fleet

        registry = fleet.ModelRegistry(args.registry)
        name, _, pinned = (args.model or "").partition("@")
        if not name:
            raise SystemExit("--registry requires --model NAME[@VERSION]")
        entry = registry.resolve(name, pinned or model_version or None)
        args.export_dir = entry["export_dir"]
        model_version = entry["version"]
        if entry.get("warm_dir") and not args.warm_cache_dir:
            args.warm_cache_dir = entry["warm_dir"]
        logger.info("registry %s resolved %s@%s -> %s", args.registry,
                    name, model_version, args.export_dir)
    elif not args.export_dir:
        raise SystemExit("--serve needs --export_dir or --registry/--model")
    if args.warm_cache_dir:
        # Warm-start compile plane: the kernels' build cache and the
        # rungs' AOTInductor packages under one root, so a restarted
        # replica reaches first prediction with compile_count == 0.
        # register_feed=False: gateway beats merge the counters themselves
        # (heartbeat_metrics), there is no node heartbeat here.
        from tensorflowonspark_torch import compilecache

        compilecache.configure(args.warm_cache_dir, register_feed=False)
    server = serving.ModelServer(args.export_dir, args.max_batch,
                                 device=args.device,
                                 warm_cache_dir=args.warm_cache_dir)
    return server, model_version


def serve_forever(args):
    """``--serve``: run one gateway replica until SIGTERM/SIGINT (the
    ``dataservice_worker.py`` lifecycle — print a ready line, wait on a
    signal-set event, drain on the way out)."""
    import signal
    import threading

    from tensorflowonspark_torch import gateway, telemetry

    _refuse_unported(args)
    telemetry.configure_from_meta({})
    telemetry.install_sigusr1()
    server, model_version = open_replica(args)
    gw = gateway.GatewayServer(
        server, host=args.host, port=args.port,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        max_queue=args.max_queue, roster_addr=args.roster,
        replica_id=args.replica_id, task_index=args.task_index,
        heartbeat_interval=args.heartbeat,
        slo_latency_us=args.slo_latency_us,
        model_version=model_version)
    host, port = gw.start()
    print("serving replica {} ready on {}:{} (buckets {})".format(
        gw.replica_id, host, port, list(server.buckets)), flush=True)
    done = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: done.set())
    done.wait()
    gw.stop()
    # flush request-flow trace events before exit so a clean SIGTERM drain
    # leaves trace-<host>-<pid>.json behind for the merged timeline
    telemetry.get_tracer().flush()


def build_parser():
    """The CLI's argument parser."""
    parser = argparse.ArgumentParser(
        description="Batch inference over TFRecords with an export of the "
                    "port (reference Inference.scala); --serve runs an "
                    "online continuous-batching gateway replica instead")
    parser.add_argument("--export_dir", default=None,
                        help="export directory (required for batch mode; "
                             "--serve can resolve one via --registry/--model "
                             "instead)")
    parser.add_argument("--input", default=None,
                        help="TFRecord directory (required unless --serve)")
    parser.add_argument("--schema_hint", default=None,
                        help="struct<name:type,...> (reference --schema_hint)")
    parser.add_argument("--input_mapping", default=None,
                        help='JSON {"column": "tensor"} (reference -i)')
    parser.add_argument("--output_mapping", default=None,
                        help='JSON {"tensor": "column"}, one entry per '
                             "output tensor (reference -o)")
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--native", action="store_true",
                        help="serve through the C++ runner (no Python on the "
                             "serving path) on --device; needs an export "
                             "with the embedded_pt2 artifact")
    parser.add_argument("--pjrt_plugin", default=None,
                        help="the JAX CLI's PJRT plugin: refused (a CUDA "
                             "host serves natively with --native)")
    parser.add_argument("--output", default=None,
                        help="output JSON-lines path (stdout when omitted)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on (default: the CUDA "
                             "card; 'cpu' only when asked)")
    serve = parser.add_argument_group("online serving (--serve)")
    serve.add_argument("--serve", action="store_true",
                       help="run as a gateway replica instead of batch mode")
    serve.add_argument("--host", default="127.0.0.1")
    serve.add_argument("--port", type=int, default=0,
                       help="listen port (0 = ephemeral, printed on ready)")
    serve.add_argument("--max-batch", type=int, default=None, dest="max_batch",
                       help="batch coalescing cap (default: --batch_size)")
    serve.add_argument("--max-wait-ms", type=float, default=5.0,
                       dest="max_wait_ms",
                       help="batching latency budget per request")
    serve.add_argument("--max-queue", type=int, default=None, dest="max_queue",
                       help="admission-control queue bound "
                            "(default 4 * max_batch)")
    serve.add_argument("--roster", default=None,
                       help="reservation server host:port to register with")
    serve.add_argument("--replica-id", default=None, dest="replica_id")
    serve.add_argument("--task-index", type=int, default=0, dest="task_index")
    serve.add_argument("--heartbeat", type=float, default=1.0,
                       help="roster heartbeat interval seconds")
    serve.add_argument("--slo-latency-us", type=float, default=0.0,
                       dest="slo_latency_us",
                       help="availability+latency SLO threshold in "
                            "microseconds: completed requests at or under "
                            "it count as serving_slo_good (0 = latency "
                            "leg disarmed; sheds always burn budget)")
    serve.add_argument("--registry", default=None,
                       help="model-fleet registry root (fleet.ModelRegistry): "
                            "resolve the export through the registry instead "
                            "of --export_dir; an entry's warm_dir is the "
                            "replica's --warm-cache-dir unless one is given")
    serve.add_argument("--model", default=None,
                       help="with --registry: model NAME or NAME@VERSION "
                            "(default version = the model's live default)")
    serve.add_argument("--model-version", default=None, dest="model_version",
                       help="version label override for serving metrics / "
                            "roster meta (set automatically by --registry)")
    serve.add_argument("--warm-cache-dir", default=None,
                       dest="warm_cache_dir",
                       help="warm-start root: the kernels' build cache and "
                            "each bucket rung's stored AOTInductor package; "
                            "a replica restart then warms by loading "
                            "instead of compiling")
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)

    if args.serve:
        if args.max_batch is None:
            args.max_batch = args.batch_size
        serve_forever(args)
        return
    if not args.export_dir:
        parser.error("--export_dir is required in batch mode")
    if not args.input:
        parser.error("--input is required (or pass --serve for online mode)")
    _refuse_unported(args)

    hint = schema_mod.parse(args.schema_hint) if args.schema_hint else None
    input_mapping = json.loads(args.input_mapping) if args.input_mapping else None
    output_mapping = (json.loads(args.output_mapping)
                      if args.output_mapping else None)

    rows = dfutil.load_tfrecords(args.input, schema=hint)
    logger.info("loaded %d rows from %s (schema %s)",
                len(rows), args.input, rows.schema)

    if args.native:
        results = run_inference_native(
            args.export_dir, rows, device=args.device,
            input_mapping=input_mapping, output_mapping=output_mapping)
    else:
        results = run_inference(args.export_dir, rows,
                                input_mapping=input_mapping,
                                output_mapping=output_mapping,
                                batch_size=args.batch_size,
                                device=args.device)
    out_f = open(args.output, "w") if args.output else sys.stdout
    try:
        n = 0
        for out in results:
            out_f.write(json.dumps(out, default=_json_default) + "\n")
            n += 1
        logger.info("wrote %d predictions", n)
    finally:
        if args.output:
            out_f.close()


if __name__ == "__main__":
    main()
