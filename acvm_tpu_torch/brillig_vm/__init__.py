from .vm import (
    VM,
    VMStatus,
    Registers,
    Memory,
    Failure,
    ForeignCallWait,
    evaluate_binary_field_op,
    evaluate_binary_int_op,
)

__all__ = [
    "VM",
    "VMStatus",
    "Registers",
    "Memory",
    "Failure",
    "ForeignCallWait",
    "evaluate_binary_field_op",
    "evaluate_binary_int_op",
]
