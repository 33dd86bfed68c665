from .contract import color_key, build_intrinsics_pyramid, required_keys
from .fake import FakeDataset, make_rig_extrinsics

__all__ = ["color_key", "build_intrinsics_pyramid", "required_keys",
           "FakeDataset", "make_rig_extrinsics"]
