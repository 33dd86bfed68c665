from .contract import color_key, build_intrinsics_pyramid, required_keys
from .ddad import DDADDataset
from .fake import FakeDataset, make_rig_extrinsics
from .loader import BatchLoader, device_prefetch
from .nuscenes import NuScenesDataset
from .synthetic_scene import SyntheticSceneDataset

__all__ = ["color_key", "build_intrinsics_pyramid", "required_keys",
           "FakeDataset", "make_rig_extrinsics", "BatchLoader",
           "device_prefetch", "SyntheticSceneDataset", "DDADDataset",
           "NuScenesDataset"]
