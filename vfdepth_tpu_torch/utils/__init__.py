from .metrics import METRIC_NAMES, cal_depth_error, compute_depth_metrics, pretty_ts
from .visualize import aug_depth_params, colormap
from .logger import Logger

__all__ = ["METRIC_NAMES", "cal_depth_error", "compute_depth_metrics",
           "pretty_ts", "aug_depth_params", "colormap", "Logger"]
