"""planlint — compile-time static analysis over TCAP plans.

Three passes (schema/dtype dataflow, partitioning-property propagation,
capability & fusion checking) producing structured
:class:`~repro_torch.analysis.diagnostics.Diagnostic` findings with stable
codes. Surfaces: ``Dataset.check()``, ``Dataset.explain(
diagnostics=True)``, and ``python -m repro_torch.analysis`` over the bundled
apps. Every plan the Session executes must analyze clean at error
severity.
"""
from repro_torch.analysis.analyzer import analyze
from repro_torch.analysis.capability import (BuildConfig, capability_diagnostics,
                                       check_session_config,
                                       check_worker_config)
from repro_torch.analysis.diagnostics import AnalysisReport, Diagnostic
from repro_torch.analysis.footprint import (PlanFootprint,
                                      estimate_plan_footprint)
from repro_torch.analysis.partitioning import propagate_partitioning
from repro_torch.analysis.schema_pass import schema_pass

__all__ = ["AnalysisReport", "BuildConfig", "Diagnostic", "PlanFootprint",
           "analyze", "capability_diagnostics", "check_session_config",
           "check_worker_config", "estimate_plan_footprint",
           "propagate_partitioning", "schema_pass"]
