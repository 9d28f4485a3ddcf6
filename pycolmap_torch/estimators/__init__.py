from pycolmap_torch.estimators.two_view_geometry import (
    TwoViewGeometry,
    TwoViewGeometryConfiguration,
)

__all__ = ["TwoViewGeometry", "TwoViewGeometryConfiguration"]
