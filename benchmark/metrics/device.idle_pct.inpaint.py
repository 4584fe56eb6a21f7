"""The device's idle share of the traced window in the inpaint cells
(``frozen/readers.device_idle_pct``)."""

from benchmark.frozen.readers import device_idle_pct as read  # noqa: F401
