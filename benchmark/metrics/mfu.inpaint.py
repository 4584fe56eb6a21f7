"""The whole unit's share of the bf16 peak in the inpaint cells
(``frozen/readers.mfu``)."""

from benchmark.frozen.readers import mfu as read  # noqa: F401
