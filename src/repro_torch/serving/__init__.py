"""Serving runtime of the port: the event-heap simulator Elastico runs in
(:mod:`repro_torch.serving.simulator`, with its scheduler, workloads and
fault schedules, copied from ``repro.serving``) and the batched sweep
engine behind :meth:`repro_torch.core.planner.Planner.validate`
(:mod:`repro_torch.serving.fastsim`)."""
