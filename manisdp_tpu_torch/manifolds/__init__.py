from .euclidean import Euclidean
from .oblique import Oblique
from .sphere import Sphere

__all__ = ["Euclidean", "Oblique", "Sphere"]
