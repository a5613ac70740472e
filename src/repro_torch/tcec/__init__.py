"""The policy-aware einsum frontend of the port (counterpart of
``repro.tcec``): every model contraction funnels through ``einsum``."""
from .epilogue import ACTIVATIONS, Epilogue
from .frontend import (PlanRecord, einsum, matmul, mma_dtype, trace_plans,
                       wide_weight_policy)
from .operands import (FragmentOperand, banded, givens_operand,
                       householder_operand, identity, triangular)
from .planner import Plan, matmul_pattern, parse_equation, plan_einsum

__all__ = [
    "ACTIVATIONS", "Epilogue", "PlanRecord", "einsum", "matmul", "mma_dtype",
    "trace_plans", "wide_weight_policy", "Plan", "matmul_pattern",
    "parse_equation", "plan_einsum", "FragmentOperand", "triangular",
    "identity", "banded", "householder_operand", "givens_operand",
]
