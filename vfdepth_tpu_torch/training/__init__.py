from .model import VFDepthModel

__all__ = ["VFDepthModel"]
