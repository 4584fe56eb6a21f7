"""Median ms of the FLUX transformer's forward: CUDA events the benchmark
records around each call in the traced unit (device time between them)."""

import statistics


def read(rec):
    spans = (rec.get("spans_ms") or {}).get("flux")
    return statistics.median(spans) if spans else None
