"""PlinyCompute's primary contribution, ported to PyTorch (port of
``repro.core``):

* the lambda calculus + Computation toolkit (paper §4),
* the TCAP IR + rule-based optimizer (paper §5, §7),
* the vectorized executor with PC's distributed join/aggregation plans
  (paper Appendix C/D), its ``torch`` expression backend on the
  hand-written relational kernels;
* the sharding planner (``planner.make_plan``), "declarative in the
  large" for the model side; ``make_plan`` and ``ShardingPlan`` load it
  on first use, so that the relational engine never imports it.
"""
from repro_torch.core.naming import NameScope, default_scope
from repro_torch.core.lambdas import (LambdaArg, LambdaTerm, TypedLambdaArg,
                                UnknownColumnError, constant, make_lambda,
                                make_lambda_from_member,
                                make_lambda_from_method,
                                make_lambda_from_self, register_method,
                                METHOD_REGISTRY)
from repro_torch.core.exprc import (EXPR_BACKENDS, FusedStage, build_steps,
                              kernel_cache_info, reset_kernel_cache)
from repro_torch.core.computations import (AggregateComp, Computation, JoinComp,
                                     MultiSelectionComp, ScanSet,
                                     SelectionComp, TopKComp, WriteSet)
from repro_torch.core.tcap import TCAPOp, TCAPProgram, structural_signature
from repro_torch.core.compiler import compile_graph
from repro_torch.core.optimizer import (OptimizerReport, dead_column_elimination,
                                  eliminate_redundant_applies, optimize,
                                  push_filters_past_joins)
from repro_torch.core.physical import PhysicalPlan, estimate_bytes, plan_physical
from repro_torch.core.executor import ExecStats, Executor, NaiveExecutor
from repro_torch.core.aggregates import AGG_KINDS, AggTerm, agg
from repro_torch.core.dataset import Dataset, GroupedDataset
from repro_torch.core.session import Session

__all__ = [
    "Dataset", "GroupedDataset", "Session", "NameScope", "default_scope",
    "AGG_KINDS", "AggTerm", "agg",
    "structural_signature",
    "EXPR_BACKENDS", "FusedStage", "build_steps", "kernel_cache_info",
    "reset_kernel_cache", "TypedLambdaArg", "UnknownColumnError",
    "LambdaArg", "LambdaTerm", "constant", "make_lambda",
    "make_lambda_from_member", "make_lambda_from_method",
    "make_lambda_from_self", "register_method", "METHOD_REGISTRY",
    "AggregateComp", "Computation", "JoinComp", "MultiSelectionComp",
    "ScanSet", "SelectionComp", "TopKComp", "WriteSet", "TCAPOp",
    "TCAPProgram", "compile_graph", "OptimizerReport",
    "dead_column_elimination", "eliminate_redundant_applies", "optimize",
    "push_filters_past_joins", "PhysicalPlan", "estimate_bytes",
    "plan_physical", "ExecStats", "Executor", "NaiveExecutor",
    "ShardingPlan", "make_plan",
]


def __getattr__(name):
    if name in ("ShardingPlan", "make_plan"):
        from repro_torch.core import planner
        return getattr(planner, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
