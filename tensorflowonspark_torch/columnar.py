"""THE row->columns contract (single source).

Three data-plane sites assemble lists of rows into per-field arrays and
historically mirrored each other (the CONTRACT MIRRORS note that lived on
``marker.pack_columnar``):

- ``marker.pack_columnar`` — feeder-side packing into ColChunks (soft:
  non-columnar data falls back to an object Chunk);
- ``datafeed.DataFeed.next_batch_arrays`` — consumer-side degraded path
  for object chunks (hard: inconsistent arity is corrupt training data);
- ``data.FileFeed._columnar`` — FILES path (adds dict rows + dtype casts;
  the dict branch stays there, it is FileFeed-specific surface).

All three now call :func:`rows_to_fields`; the row semantics live HERE and
nowhere else.

**The contract**: a **tuple** row is a row-of-fields (each field an ndarray
or scalar with consistent shape/dtype down the block); anything else
(list, ndarray, scalar) is a single data value — a ``[1.0, 2.0]`` list row
is a length-2 vector, not two fields (``DataFeed.next_batch_arrays``'s
historical ``np.asarray(items)`` behavior).
"""

import numpy as np

__all__ = ["rows_to_fields"]


def rows_to_fields(rows, strict, dtypes=None):
    """Assemble rows into per-field columns.

    Args:
      rows: non-empty list of rows (tuples => rows-of-fields, else single
        values).
      strict: edge-case policy.  ``False`` (feeder-side packer): return
        ``None`` for anything not cleanly columnar — inconsistent tuple
        arity, ragged shapes, object dtypes — so the caller can fall back
        to object transport.  ``True`` (consumer side): inconsistent arity
        raises ``ValueError`` (truncating would silently drop fields —
        wrong training data), and object-dtype columns pass through (the
        consumer's historical contract for arbitrary python rows).
      dtypes: optional per-field cast — a sequence indexed by field for
        tuple rows, or a single dtype for single-value rows (FILES path).

    Returns:
      ``(fields, tuple_rows)`` — ``fields`` a tuple of ndarrays (length =
      arity for tuple rows, 1 for single values) — or ``None`` (only when
      ``strict=False``) for non-columnar data.
    """
    first = rows[0]
    try:
        if isinstance(first, tuple):
            arity = len(first)
            mismatched = [r for r in rows
                          if not isinstance(r, tuple) or len(r) != arity]
            if arity == 0 and not mismatched:
                # degenerate all-empty-tuple block: not packable (soft), a
                # zero-field row set (strict) — the consumer's historical
                # behavior
                return None if not strict else ((), True)
            if mismatched:
                if not strict:
                    return None
                wrong = mismatched[0]
                raise ValueError(
                    "inconsistent row arity in feed chunk: expected "
                    "{}-field tuples, got {!r}".format(
                        arity, type(wrong).__name__
                        if not isinstance(wrong, tuple) else len(wrong)))
            fields = []
            for f in range(arity):
                col = np.asarray([row[f] for row in rows],
                                 dtype=None if dtypes is None else dtypes[f])
                if col.dtype == object and not strict:
                    return None
                fields.append(col)
            return tuple(fields), True
        col = np.asarray(rows, dtype=dtypes)
        if col.dtype == object and not strict:
            return None
        return (col,), False
    except ValueError:
        if strict:
            raise
        return None
    except TypeError:
        if strict:
            raise
        return None  # mixed types: not columnar-packable
