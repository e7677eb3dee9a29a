from .common import SDPResult

__all__ = ["SDPResult"]
