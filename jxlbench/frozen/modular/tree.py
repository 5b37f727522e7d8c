"""MA (meta-adaptive) tree decode (reference j40.h:3437-3522, spec §
10.1)."""

from __future__ import annotations

from dataclasses import dataclass

from ..errors import check
from ..io.bits import BitReader
from ..limits import MAIN_LV5, Limits
from ..mathutil import unpack_signed
from ..entropy.code import CodeSpec, CodeState, read_code_spec

NUM_PRED = 14


@dataclass
class TreeNode:
    # branch if prop >= 0 (property index), else leaf
    prop: int = -1
    value: int = 0
    left: int = 0  # absolute child indices
    right: int = 0
    # leaf fields
    ctx: int = 0
    predictor: int = 0
    offset: int = 0
    multiplier: int = 1

    @property
    def is_leaf(self) -> bool:
        return self.prop < 0


def read_tree(
    r: BitReader, max_tree_size: int, limits: Limits = MAIN_LV5
) -> tuple[list[TreeNode], CodeSpec]:
    """Decode the tree (breadth-first wire order) and its leaf code spec.

    Node contexts: 1=property selector, 0=branch value, 2=predictor,
    3=offset, 4=multiplier shift, 5=multiplier value.
    """
    spec = read_code_spec(r, 6)
    code = CodeState(spec)
    nodes: list[TreeNode] = []
    ctx_id = 0
    nodes_left = 1
    depth = 0
    nodes_upto_this_depth = 1
    while nodes_left > 0:
        nodes_left -= 1
        if len(nodes) == nodes_upto_this_depth:
            depth += 1
            check(depth <= limits.tree_depth, "tlim")
            nodes_upto_this_depth += nodes_left + 1
        prop = code.code(r, 1)
        n = TreeNode()
        if prop > 0:
            n.prop = prop - 1
            n.value = unpack_signed(code.code(r, 0))
            nodes_left += 1
            n.left = len(nodes) + nodes_left
            nodes_left += 1
            n.right = len(nodes) + nodes_left
        else:
            n.prop = -1
            n.ctx = ctx_id
            ctx_id += 1
            n.predictor = code.code(r, 2)
            n.offset = unpack_signed(code.code(r, 3))
            shift = code.code(r, 4)
            check(shift < 31, "tree")
            val = code.code(r, 5)
            check(((val + 1) >> (31 - shift)) == 0, "tree")
            n.multiplier = (val + 1) << shift
        nodes.append(n)
        check(len(nodes) + nodes_left <= max_tree_size, "tlim")
    code.finish(r)
    leaf_spec = read_code_spec(r, ctx_id)
    return nodes, leaf_spec
