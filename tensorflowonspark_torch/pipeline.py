"""Row batching for the serving path (the counterpart of the part of
:mod:`tensorflowonspark_tpu.pipeline` that serving uses)."""


def yield_batch(iterator, batch_size):
    """Generate ``(rows, count)`` batches from a row iterator."""
    batch = []
    for row in iterator:
        batch.append(row)
        if len(batch) >= batch_size:
            yield batch, len(batch)
            batch = []
    if batch:
        yield batch, len(batch)
