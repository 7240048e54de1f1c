"""Batch inference over an export (the counterpart of
:func:`tensorflowonspark_tpu.inference_cli.run_inference`).

The TFRecord command line and the ``--serve`` gateway come with later
slices; this module holds the row-in, row-out entry point they drive.
"""

from tensorflowonspark_torch import serving


def run_inference(export_dir, rows, input_mapping=None, output_name=None,
                  output_mapping=None, batch_size=128, device=None):
    """Yield one output row dict per input row (1:1 contract).

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
