"""The attention forward's share of its roofline in the inpaint cells
(``frozen/readers.attn_fwd_roofline_pct``)."""

from benchmark.frozen.readers import attn_fwd_roofline_pct as read  # noqa: F401
