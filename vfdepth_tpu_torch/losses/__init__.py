"""Training losses (port of ``vfdepth_tpu/losses``)."""
from .composite import (LossConfig, cold_start_schedule,
                        depth_synthesis_loss, pose_consistency_loss, reprojection_loss,
                        smoothness_loss, spatio_loss_fn, spatio_tempo_loss_fn,
                        total_loss)
from .primitives import (auto_mask, edge_aware_smoothness, masked_mean,
                         mean_normalized_disp, photometric_loss, ssim_loss)

__all__ = ["LossConfig", "cold_start_schedule", "depth_synthesis_loss",
           "pose_consistency_loss",
           "reprojection_loss",
           "smoothness_loss", "spatio_loss_fn", "spatio_tempo_loss_fn",
           "total_loss", "auto_mask", "edge_aware_smoothness", "masked_mean",
           "mean_normalized_disp", "photometric_loss", "ssim_loss"]
