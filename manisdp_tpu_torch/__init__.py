"""ManiSDP on PyTorch: the MaxCut path, the primal augmented-Lagrangian
drivers and the dual Riemannian-ADMM drivers of the low-rank SDP solver,
with hand-written Hopper kernels.

A port of the JAX package ``manisdp_tpu`` (the reference it is tested
against) to PyTorch and CUDA on an NVIDIA H100.  Burer-Monteiro factor Y
(p_pad, n) on the oblique manifold, Riemannian trust-region inner solves
with truncated CG, a device LOBPCG dual certificate, Gram-SVD rank
truncation and escape along negative eigenvectors.  Float64 end to end
by default; every tensor is created with an explicit device and dtype.

The sparse product with the cost matrix (and its MaxCut and AL Hessian
epilogues) is kernel K1, the oblique column ops are kernel K2, the
constraint operator's pattern pair dots kernel K3 and its CSR gathers
(A and its adjoint) kernel K4 (``kernels/``); each has a plain PyTorch
twin that CPU tensors use.  ``solve_sdp`` / ``solve_unitdiag`` /
``solve_unittrace`` take SeDuMi data (At, b, c, n) and pick the constraint
operator as the JAX package does: the entrywise carrier (kernel K5), the
dense carrier (K4 gathers and scatters) or the factored operator;
``solve_sedumi`` takes a SeDuMi container with one PSD block.  The
``dense_eigh`` certificate's refinement pass is kernel K6.
``solve_dual_unitdiag`` / ``solve_dual_sdp`` take SeDuMi dual data (the
sparse operator on kernel K4); ``solvers.dual_unitdiag.solve_bqp_sos_dual``
solves the BQP SOS dual on the expanded-basis tensor operator (kernels K7
and K8), and ``solvers.primal_mom.solve_bqp_mom`` its primal moment
relaxation on the expanded-basis moment operator (kernels K9 and K10).
``solvers.multiblock.solve_multiblock`` and
``solvers.dual_multiblock.solve_dual_multiblock`` take block-diagonal
SeDuMi data on the masked product manifold (K2 with a column mask);
``solve_sedumi`` sends an LP cone or several PSD blocks to the first.
``solve_maxcut_batch`` solves B MaxCut instances together (K1 and K2 in
instance mode); every RTR's truncated-CG step is kernel K11.
Importing this package imports neither jax nor ``manisdp_tpu`` and
builds nothing.
"""

from . import recipes
from .config import SolverOptions
from .frontends.gset import load_gset_laplacian
from .solvers.dispatch import solve_sedumi
from .solvers.dual_general import solve_dual_sdp
from .solvers.dual_unitdiag import solve_dual_unitdiag
from .solvers.batch import solve_maxcut_batch
from .solvers.general import solve_sdp
from .solvers.maxcut import solve_maxcut_unitdiag
from .solvers.unitdiag import solve_unitdiag
from .solvers.unittrace import solve_unittrace

__all__ = ["SolverOptions", "recipes", "solve_maxcut_unitdiag",
           "solve_maxcut_batch", "solve_sdp",
           "solve_sedumi", "solve_unitdiag", "solve_unittrace",
           "solve_dual_unitdiag", "solve_dual_sdp", "load_gset_laplacian"]

__version__ = "0.1.0"
