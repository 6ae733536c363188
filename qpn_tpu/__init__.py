"""qpn_tpu — a batched Quadratic Program Network equilibrium framework.

From-scratch JAX/XLA/Pallas re-design of the capabilities of
``QuadraticProgramNetworks.jl`` (reference surveyed in /root/repo/SURVEY.md):
DAGs of quadratic-program "players" (bilevel / trilevel / Nash structures),
equilibrium computation, and explicit piecewise-polyhedral solution graphs of
lower levels — with the reference's serial C solvers (PATH, OSQP, cdd)
replaced by batched accelerator kernels (the GPU in production, the CPU in
tests).
"""

from . import config  # noqa: F401  -- must be first (enables x64)

from .geometry.poly import Poly, PolyUnion, intersect, from_box  # noqa: E402
from .options import QPNetOptions  # noqa: E402
from .network import QP, Constraint, Quadratic, Linear, QPNet  # noqa: E402
from .frontend import variables, variable  # noqa: E402
from .algorithm import solve, solve_many  # noqa: E402
from .models import setup  # noqa: E402
from .printing import install_reprs as _install_reprs  # noqa: E402

_install_reprs()

__all__ = [
    "Poly", "PolyUnion", "intersect", "from_box",
    "QPNetOptions", "QP", "Constraint", "Quadratic", "Linear", "QPNet",
    "variables", "variable", "solve", "solve_many", "setup",
]

__version__ = "0.1.0"
