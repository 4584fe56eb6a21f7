from followmyhold_tpu_torch.configs.guidance import LrGroup, OptimizationConfig
from followmyhold_tpu_torch.configs.paths import assets_root, package_root, repo_root
from followmyhold_tpu_torch.configs.pipeline import PipelineConfig, load_config

__all__ = [
    "LrGroup",
    "OptimizationConfig",
    "PipelineConfig",
    "load_config",
    "assets_root",
    "package_root",
    "repo_root",
]
