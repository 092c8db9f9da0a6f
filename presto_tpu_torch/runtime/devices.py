"""Device telemetry: allocator bytes, peaks and the dispatch wall.

Counterpart of ``presto_tpu/runtime/devices.py``, read from the CUDA
caching allocator (``torch.cuda.memory_stats``):

- ``sample_devices()`` — one row per CUDA device with the allocator's
  bytes in use, its peak watermark and the device's total memory, plus
  the dispatch wall the fragment choke point (``runtime/lifecycle.
  run_fragment``) recorded, spread evenly over the devices. Without a
  card (or before the CUDA context exists) one ``cpu`` row of zeros
  appears, as the JAX package reports a CPU backend.
- ``DISPATCH_WALL`` — the process-wide ledger of time inside
  ``run_fragment``.
- ``peak_bytes()`` — the allocator's peak watermark over the devices,
  stamped per query as ``QueryInfo.device_peak_bytes``.
- ``headroom_bytes()`` — min over devices of ``total - in use``; None
  where no device reports a limit.
- ``gauges()`` — OpenMetrics gauge rows.

Reading never creates a CUDA context: a process that has not touched the
card reports the ``cpu`` row.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import torch


class _DispatchLedger:
    """Accumulated wall seconds spent in fragment dispatch, plus the
    dispatch count."""

    def __init__(self):
        self._lock = threading.Lock()
        self._total_s = 0.0
        self._dispatches = 0

    def record(self, seconds: float) -> None:
        if seconds < 0:
            return
        with self._lock:
            self._total_s += seconds
            self._dispatches += 1

    def snapshot(self) -> "tuple[float, int]":
        with self._lock:
            return self._total_s, self._dispatches

    def reset(self) -> None:
        with self._lock:
            self._total_s = 0.0
            self._dispatches = 0


DISPATCH_WALL = _DispatchLedger()


def _cuda_devices() -> list[int]:
    """Indices of the CUDA devices whose stats can be read without
    creating a context (none before the first CUDA call)."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return []
    return list(range(torch.cuda.device_count()))


def _memory_stats(index: int) -> dict:
    """The allocator's stats of one device as the JAX package's keys
    (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``); telemetry
    degrades to zeros, it never fails a query."""
    try:
        st = torch.cuda.memory_stats(index)
        return {
            "bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(index).total_memory),
        }
    except Exception:  # noqa: BLE001 -- telemetry must not fail queries
        return {}


def sample_devices() -> "list[dict]":
    """One telemetry row per CUDA device (a ``cpu`` row of zeros without
    one)."""
    devs = _cuda_devices()
    total_s, dispatches = DISPATCH_WALL.snapshot()
    per_device_s = total_s / max(len(devs), 1)
    if not devs:
        return [{"device_id": "0", "platform": "cpu", "bytes_in_use": 0,
                 "peak_bytes": 0, "bytes_limit": 0,
                 "dispatch_wall_s": per_device_s, "dispatches": dispatches}]
    rows = []
    for d in devs:
        ms = _memory_stats(d)
        rows.append({
            "device_id": str(d),
            "platform": "gpu",
            "bytes_in_use": int(ms.get("bytes_in_use", 0)),
            "peak_bytes": int(ms.get("peak_bytes_in_use", 0)),
            "bytes_limit": int(ms.get("bytes_limit", 0)),
            "dispatch_wall_s": per_device_s,
            "dispatches": dispatches,
        })
    return rows


def peak_bytes() -> int:
    """Max allocator watermark over the devices right now (0 without a
    card)."""
    peak = 0
    for d in _cuda_devices():
        peak = max(peak, int(_memory_stats(d).get("peak_bytes_in_use", 0)))
    return peak


def headroom_bytes() -> Optional[int]:
    """Min over devices of ``bytes_limit - bytes_in_use``; None where no
    device reports a limit (absent telemetry reads as unknown, not
    infinite)."""
    headroom = None
    for d in _cuda_devices():
        ms = _memory_stats(d)
        limit = int(ms.get("bytes_limit", 0))
        if limit <= 0:
            continue
        free = limit - int(ms.get("bytes_in_use", 0))
        headroom = free if headroom is None else min(headroom, free)
    return headroom


def gauges() -> dict:
    """Per-device OpenMetrics gauges."""
    out = {}
    for row in sample_devices():
        did = row["device_id"]
        out[f"device.bytes_in_use.{did}"] = row["bytes_in_use"]
        out[f"device.peak_bytes.{did}"] = row["peak_bytes"]
        out[f"device.bytes_limit.{did}"] = row["bytes_limit"]
        out[f"device.dispatch_wall_s.{did}"] = row["dispatch_wall_s"]
    return out


def timed_dispatch(fn):
    """Run ``fn()`` recording its wall into the dispatch ledger."""
    t0 = time.perf_counter()
    try:
        return fn()
    finally:
        DISPATCH_WALL.record(time.perf_counter() - t0)
