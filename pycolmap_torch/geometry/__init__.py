from pycolmap_torch.geometry.types import Rigid3d, Rotation3d, Sim3d

__all__ = ["Rotation3d", "Rigid3d", "Sim3d"]
