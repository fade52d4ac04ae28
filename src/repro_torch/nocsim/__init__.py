"""Route operators of the NoC model (`routes`): the sparse link × (s, t)
matrices the stacked simulator contracts with, and the minimal-adaptive
two-choice assignment.  The windowed contention replay itself is not in this
package yet."""
from repro_torch.nocsim.routes import (
    ROUTING_POLICIES,
    RouteOperators,
    assign_adaptive2,
    route_operators,
)

__all__ = ["ROUTING_POLICIES", "RouteOperators", "route_operators", "assign_adaptive2"]
