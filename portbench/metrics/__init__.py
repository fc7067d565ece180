"""Metric readers: one file per metric, ``read(window) -> float | None``."""
