"""Track: the list of (image_id, point2D_idx) observations of a 3D point.

API parity: pycolmap/scene/track.h:19-69.
"""

from __future__ import annotations


class TrackElement:
    __slots__ = ("image_id", "point2D_idx")

    def __init__(self, image_id: int = 0, point2D_idx: int = 0):
        self.image_id = int(image_id)
        self.point2D_idx = int(point2D_idx)

    def __eq__(self, other):
        return (
            isinstance(other, TrackElement)
            and self.image_id == other.image_id
            and self.point2D_idx == other.point2D_idx
        )

    def __hash__(self):
        return hash((self.image_id, self.point2D_idx))

    def __repr__(self):
        return f"TrackElement(image_id={self.image_id}, point2D_idx={self.point2D_idx})"


class Track:
    __slots__ = ("elements",)

    def __init__(self, elements=None):
        self.elements = list(elements) if elements else []

    def length(self) -> int:
        return len(self.elements)

    def add_element(self, image_id: int, point2D_idx: int):
        self.elements.append(TrackElement(image_id, point2D_idx))

    def append(self, element: TrackElement):
        self.elements.append(element)

    def add_elements(self, elements):
        self.elements.extend(elements)

    def delete_element(self, image_id: int, point2D_idx: int):
        self.elements = [
            e
            for e in self.elements
            if not (e.image_id == image_id and e.point2D_idx == point2D_idx)
        ]

    def remove(self, index: int):
        del self.elements[index]

    def __len__(self):
        return len(self.elements)

    def __eq__(self, other):
        return isinstance(other, Track) and self.elements == other.elements

    def __repr__(self):
        return f"Track(length={len(self.elements)})"
