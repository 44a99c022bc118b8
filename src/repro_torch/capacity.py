"""Top-level re-exports of the capacity subsystem.

``repro_torch.capacity`` is the public face of
:mod:`repro_torch.serve.capacity` — online bottleneck detection
(:class:`BottleneckMonitor`), the adaptive host/device balance control
loop (:class:`CapacityController`), and cost-efficiency reporting
(:class:`CostReport`, $/1k-queries through the paper's deployment
prices). See that module's docstring for the full story; enable in a
serving stack with ``ServeConfig(capacity=CapacityConfig(...))``.

Port of ``repro.capacity``.
"""
from repro_torch.serve.capacity import (PAPER_BOXES, Bottleneck,
                                  BottleneckMonitor, BoxPrice,
                                  CapacityConfig, CapacityController,
                                  CapacitySignals, ControllerAction,
                                  CostReport, CostRow)
from repro_torch.serve.metrics import SignalSnapshot

__all__ = [
    "PAPER_BOXES", "Bottleneck", "BottleneckMonitor", "BoxPrice",
    "CapacityConfig", "CapacityController", "CapacitySignals",
    "ControllerAction", "CostReport", "CostRow", "SignalSnapshot",
]
