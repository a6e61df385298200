"""The strategy search: the cost model, the simulator and its delta
session, MCMC, the exact DP over decomposable regions and the hybrid
search (``optimize_strategies`` is what ``compile`` calls)."""
from .mcmc import optimize_strategies
from .session import SimSession

__all__ = ["optimize_strategies", "SimSession"]
