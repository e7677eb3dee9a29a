from .eigs import CertResult, dual_certificate
from .sparse import ConstraintOp, SymCOO, gather_cols, pair_dots, scatter_cols

__all__ = [
    "SymCOO", "ConstraintOp", "pair_dots", "gather_cols", "scatter_cols",
    "dual_certificate", "CertResult",
]
