from pycolmap_torch.scene.camera import Camera
from pycolmap_torch.scene.correspondence_graph import Correspondence, CorrespondenceGraph
from pycolmap_torch.scene.database import (
    Database,
    DatabaseTransaction,
    image_pair_to_pair_id,
    pair_id_to_image_pair,
)
from pycolmap_torch.scene.image import Image
from pycolmap_torch.scene.point2d import INVALID_POINT3D_ID, Point2D
from pycolmap_torch.scene.point3d import Point3D
from pycolmap_torch.scene.reconstruction import Reconstruction
from pycolmap_torch.scene.track import Track, TrackElement

__all__ = [
    "Camera",
    "Correspondence",
    "CorrespondenceGraph",
    "Database",
    "DatabaseTransaction",
    "Image",
    "INVALID_POINT3D_ID",
    "Point2D",
    "Point3D",
    "Reconstruction",
    "Track",
    "TrackElement",
    "image_pair_to_pair_id",
    "pair_id_to_image_pair",
]
