"""Byte accounting of batches (the two helpers of
``presto_tpu/runtime/trace.py`` that EXPLAIN ANALYZE reads). Capacity
arithmetic only: never a device sync. Spans and trace export are not
ported."""

from __future__ import annotations


def batch_row_bytes(batch) -> int:
    """Per-row device bytes of a Batch: column payload widths plus the
    validity and live masks (1 byte each)."""
    total = 1  # live mask
    for c in batch.columns.values():
        width = 1
        for d in c.data.shape[1:]:
            width *= int(d)
        total += width * c.data.element_size() + 1  # + valid mask
    return total


def batch_device_bytes(batch) -> int:
    """Capacity-based device residency of a Batch (live rows and padding
    both occupy device memory)."""
    return batch_row_bytes(batch) * int(batch.capacity)
