from .batched_solve import batched_solve, batched_solve_lanes, nr_solve
from .dispatch import auto_layout, solve_route

__all__ = ["batched_solve", "batched_solve_lanes", "nr_solve",
           "auto_layout", "solve_route"]
