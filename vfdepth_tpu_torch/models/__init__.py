from .blocks import ConvBlock, PointwiseBlock, pack_cam_feat, unpack_cam_feat
from .decoders import FusionDepthDecoder, MonoDepthDecoder, PoseDecoder
from .nets import FusedDepthNet, FusedPoseNet, MonoDepthNet, MonoPoseNet
from .resnet import ResnetEncoder, num_ch_enc
from .vfnet import (BEVFold, VFNet, backproject_features,
                    backproject_features_grouped, grouped_backprojection_ok)

__all__ = ["ConvBlock", "PointwiseBlock", "pack_cam_feat", "unpack_cam_feat",
           "FusionDepthDecoder", "MonoDepthDecoder", "PoseDecoder",
           "FusedDepthNet", "FusedPoseNet", "MonoDepthNet", "MonoPoseNet",
           "ResnetEncoder", "num_ch_enc", "BEVFold", "VFNet",
           "backproject_features", "backproject_features_grouped",
           "grouped_backprojection_ok"]
