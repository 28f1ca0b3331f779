"""Elastic pretraining soak: wall-clock fault schedules composed across
every plane, with per-fault-class MTTR accounting.

`SoakDriver` runs a budgeted pretraining loop (Data ingest →
`TrainStepRunner` fold-steps on the CPU → gang-durable checkpoints)
under a timed `FaultPlan` schedule (the port runs the local mode; the
cluster mode waits for the autoscaler);
`RecoveryLedger` measures MTTR per fault class from the flight
recorder's StepStats stream and audits that every observed failure was
injected and every restore resumed from the last gang-committed
checkpoint.
"""

from ray_tpu_torch.soak.driver import SoakConfig, SoakDriver, run_soak
from ray_tpu_torch.soak.ledger import FaultEvent, RecoveryLedger

__all__ = [
    "FaultEvent",
    "RecoveryLedger",
    "SoakConfig",
    "SoakDriver",
    "run_soak",
]
