from .gset import load_gset_laplacian
from .sedumi import Cone, SedumiData

__all__ = ["load_gset_laplacian", "SedumiData", "Cone"]
