from .base import Manifold
from .euclidean import Euclidean
from .oblique import Oblique
from .sphere import Sphere

__all__ = ["Manifold", "Oblique", "Sphere", "Euclidean"]
