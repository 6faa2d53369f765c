"""Fleet tier: deadline-aware routing over N replica sessions.

The serving stack scaled out: a :class:`FleetRouter` places
deadline-stamped requests across replica sessions with pluggable
placement policies (registered like schedulers), sheds at the router via
the shared EDF admission, and grows/shrinks the fleet with an
:class:`ElasticAutoscaler` through the sessions' ``add_device`` /
``remove_device`` membership hooks.  ``simulate_fleet`` is the
policy-validation twin (epoch co-simulation over
``simulate_serving`` resume states); ``FleetServer``/``ReplicaWorker``
run the same router against real threaded sessions.
"""
from repro_torch.fleet.autoscale import (AutoscaleConfig,
                                         ElasticAutoscaler, ScaleEvent)
from repro_torch.fleet.placement import (
    PLACEMENTS, DeadlinePlacement, LeastResidualPlacement, PlacementPolicy,
    PlacementSpec, PowerPropPlacement, ReplicaState, RoundRobinPlacement,
    StaticPlacement, available_placements, make_placement,
    placement_accepts, placement_spec, register_placement,
    unregister_placement)
from repro_torch.fleet.router import FleetRouter, Placed, RouterConfig
from repro_torch.fleet.sim import (FleetSimResult, SimReplica,
                                   crosscheck_fleet, simulate_fleet)
from repro_torch.fleet.worker import FleetServer, ReplicaWorker

__all__ = [
    "AutoscaleConfig", "DeadlinePlacement", "ElasticAutoscaler",
    "FleetRouter", "FleetServer", "FleetSimResult", "LeastResidualPlacement",
    "PLACEMENTS", "Placed", "PlacementPolicy", "PlacementSpec",
    "PowerPropPlacement", "ReplicaState", "ReplicaWorker",
    "RoundRobinPlacement", "RouterConfig", "ScaleEvent", "SimReplica",
    "StaticPlacement", "available_placements", "crosscheck_fleet",
    "make_placement", "placement_accepts", "placement_spec",
    "register_placement", "simulate_fleet", "unregister_placement",
]
