from followmyhold_tpu_torch.eval.metrics import (
    chamfer_distance,
    delta1_depth,
    f_score,
    rel_depth,
    scale_aligned_depth_metrics,
)

__all__ = [
    "chamfer_distance",
    "delta1_depth",
    "f_score",
    "rel_depth",
    "scale_aligned_depth_metrics",
]
