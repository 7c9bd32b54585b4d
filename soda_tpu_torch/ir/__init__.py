"""Expression IR (rebuild of the external haoda.ir substrate, SURVEY.md §2.9)."""

from soda_tpu_torch.ir.nodes import (  # noqa: F401
    AddSub, BinaryAnd, BinaryOr, Call, Cast, CHAIN_CLASSES, EqCmp, Expr,
    FUNCS, Let, LogicAnd, LtCmp, MulDiv, Node, Num, Ref, Unary, Var, Xor,
    from_reduction, make_chain, make_num, make_var, to_reduction,
)
from soda_tpu_torch.ir.types import Type, common_type, common_type_of  # noqa: F401
