"""Serving runtime of the port: the event-heap simulator Elastico runs in
(:mod:`repro_torch.serving.simulator`, with its scheduler, workloads and
fault schedules, copied from ``repro.serving``), the batched sweep engine
behind :meth:`repro_torch.core.planner.Planner.validate`
(:mod:`repro_torch.serving.fastsim`), and the workflow DAGs
(:mod:`repro_torch.serving.dag`): the pipeline ladder, the event-heap
:class:`~repro_torch.serving.dag.DagSimulator` the pipeline-level Elastico
runs in, and the pipeline sweep behind
:meth:`repro_torch.core.planner.Planner.validate_pipeline`, whose chained
recursion runs in :func:`repro_torch.serving.fastsim._pipeline_grid`."""
