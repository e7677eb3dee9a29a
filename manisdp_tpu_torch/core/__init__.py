from .problem import Problem, TROptions, TRResult
from .trustregions import make_batched_trustregions, make_trustregions

__all__ = ["Problem", "TROptions", "TRResult", "make_trustregions",
           "make_batched_trustregions"]
