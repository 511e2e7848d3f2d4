"""Find the distributed lookup table in a program
(reference python/paddle/fluid/distribute_lookup_table.py).

The DistributeTranspiler calls these to locate the single is_distributed
embedding table and its per-op input/output vars; user code also uses
find_distributed_lookup_table to introspect a program before transpile.
"""

from __future__ import annotations

from typing import List, Optional

__all__ = ["find_distributed_lookup_table",
           "find_distributed_lookup_table_inputs",
           "find_distributed_lookup_table_outputs"]

LOOKUP_TABLE_TYPES = ("lookup_table", "lookup_table_v2")


def find_distributed_lookup_table(program) -> Optional[str]:
    """The unique table name used by is_distributed lookup ops, or None.
    Mixing several distributed tables is rejected like the reference
    (:56)."""
    table_name = None
    for op in program.global_block().ops:
        if op.type in LOOKUP_TABLE_TYPES and \
                op.attrs.get("is_distributed", False):
            name = op.input("W")[0]
            if table_name is None:
                table_name = name
            elif table_name != name:
                raise RuntimeError(
                    "all distributed lookup_table ops must share one "
                    "table; found %r and %r" % (table_name, name))
    return table_name


def find_distributed_lookup_table_inputs(program, table_name: str) -> List:
    """Ids vars of every lookup op reading table_name (:18)."""
    block = program.global_block()
    inputs = []
    for op in block.ops:
        if op.type in LOOKUP_TABLE_TYPES and \
                op.input("W")[0] == table_name:
            inputs.extend(block.var(n) for n in op.input("Ids"))
    return inputs


def find_distributed_lookup_table_outputs(program, table_name: str) -> List:
    """Out vars of every lookup op reading table_name (:37)."""
    block = program.global_block()
    outputs = []
    for op in block.ops:
        if op.type in LOOKUP_TABLE_TYPES and \
                op.input("W")[0] == table_name:
            outputs.extend(block.var(n) for n in op.output("Out"))
    return outputs
