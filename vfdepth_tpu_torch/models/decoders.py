"""Depth / pose decoders (port of ``vfdepth_tpu/models/decoders.py``), NCHW.

``FusionDepthDecoder`` is ported with ``phase_final=False`` only (the JAX
package's default; its sub-pixel variant, ``ops/subpixel.py``, is an
ablation left for later). ``dtype`` is the compute dtype
(``models/blocks.py``); the disparity sigmoid and the pose head's mean run
in f32 whatever it is, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import Conv2d, ConvBlock
from ..ops.resize import upsample2x_nearest


class FusionDepthDecoder(nn.Module):
    """Decode fusion-level features down to full-scale sigmoid disparity.

    ``level_in`` is the starting pyramid level; with ``use_skips=False``
    (the default) only the last input feature is consumed.
    """

    def __init__(self, level_in: int, num_ch_enc: Sequence[int],
                 num_ch_dec: Sequence[int] = (16, 32, 64, 128, 256),
                 scales: Sequence[int] = (0,), use_skips: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.level_in = level_in
        self.scales = tuple(scales)
        self.use_skips = use_skips
        ch = num_ch_enc[-1]
        for i in range(level_in, -1, -1):
            self.add_module(f"upconv_{i}_0",
                            ConvBlock(ch, num_ch_dec[i], 3, nonlin="ELU",
                                      dtype=dtype))
            cin = num_ch_dec[i]
            if use_skips and i > 0:
                cin += num_ch_enc[i - 1]
            self.add_module(f"upconv_{i}_1",
                            ConvBlock(cin, num_ch_dec[i], 3, nonlin="ELU",
                                      dtype=dtype))
            if i in self.scales:
                self.add_module(f"dispconv_{i}",
                                ConvBlock(num_ch_dec[i], 1, 3, nonlin=None,
                                          dtype=dtype))
            ch = num_ch_dec[i]

    def forward(self, input_features: List[torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        outputs = {}
        x = input_features[-1]
        for i in range(self.level_in, -1, -1):
            x = getattr(self, f"upconv_{i}_0")(x)
            x = upsample2x_nearest(x, channels_last=False)
            if self.use_skips and i > 0:
                x = torch.cat([x, input_features[i - 1]], dim=1)
            x = getattr(self, f"upconv_{i}_1")(x)
            if i in self.scales:
                outputs[f"disp/{i}"] = torch.sigmoid(
                    getattr(self, f"dispconv_{i}")(x).float())
        return outputs


class PoseDecoder(nn.Module):
    """Monodepth2 pose head: 1x1 squeeze (-> 256) + ReLU, two 3x3 convs
    (stride ``stride``) + ReLU, 1x1 conv to 6*n_frames, mean over H, W in
    f32, x0.01. Returns (axisangle, translation), each [b, n_frames, 1, 3].
    """

    def __init__(self, in_ch: int, num_frames_to_predict_for: int = 1,
                 stride: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n = num_frames_to_predict_for
        self.squeeze = Conv2d(in_ch, 256, 1, dtype=dtype)
        self.pose_0 = Conv2d(256, 256, 3, stride=stride, padding=1,
                             dtype=dtype)
        self.pose_1 = Conv2d(256, 256, 3, stride=stride, padding=1,
                             dtype=dtype)
        self.pose_2 = Conv2d(256, 6 * self.n, 1, dtype=dtype)

    def forward(self, feature: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = F.relu(self.squeeze(feature))
        x = F.relu(self.pose_0(x))
        x = F.relu(self.pose_1(x))
        x = self.pose_2(x).float().mean(dim=(-2, -1))     # [b, 6*n]
        x = 0.01 * x.reshape(x.shape[0], self.n, 1, 6)
        return x[..., :3], x[..., 3:]
