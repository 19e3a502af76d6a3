"""Fault tolerance, elastic scaling and the collectives of the explicit
SPMD code (port of ``repro.distributed``)."""
from repro_torch.distributed.elastic import rebalance_shards, reshard_state
from repro_torch.distributed.fault_tolerance import (HeartbeatMonitor,
                                                     StragglerPlan,
                                                     Supervisor,
                                                     SupervisorReport)

__all__ = ["HeartbeatMonitor", "StragglerPlan", "Supervisor",
           "SupervisorReport", "rebalance_shards", "reshard_state"]
