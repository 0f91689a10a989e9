"""Operator Graph (paper §IV-B).

A graph is: a *converting chain* applied to the whole matrix (COMPRESS first,
then reordering / dividing operators — dividing operators branch the graph),
followed by a mapping+implementing chain. When the converting stage produced
branches (BIN / ROW_DIV / COL_DIV), the mapping+implementing chain may be
*shared* across branches or *per-branch* (the paper's "branches appear in
Operator Graphs ... different formats for different parts", §VII-G).

Graphs are hashable value objects: the search engine memoises on them.

Operator names are resolved through the ``repro_torch.design`` registry, and
validation runs off the traits operators declare there (``divides``,
``builds_layout``, ``accepts_layouts``, ``requires``, ``before_layout``) —
an out-of-tree operator registered with
``@repro_torch.design.register_operator`` validates and runs like a built-in.
"""
from __future__ import annotations

import dataclasses

from repro_torch.design.registry import (GraphError, OpSpec, STAGE_CONVERTING,
                                   STAGE_IMPLEMENTING, get_operator)
from .metadata import MetadataSet, from_matrix
from .matrices import SparseMatrix
from .operators import apply_op

__all__ = ["OperatorGraph", "GraphError", "run_graph"]


@dataclasses.dataclass(frozen=True, order=True)
class OperatorGraph:
    converting: tuple[OpSpec, ...]
    # either one shared chain, or one chain per branch (len == n branches)
    branch_chains: tuple[tuple[OpSpec, ...], ...]
    shared: bool = True

    @staticmethod
    def chain(*specs: OpSpec) -> "OperatorGraph":
        """Convenience: linear graph, converting ops auto-split from the rest."""
        conv = tuple(s for s in specs
                     if get_operator(s.name).stage == STAGE_CONVERTING)
        rest = tuple(s for s in specs
                     if get_operator(s.name).stage != STAGE_CONVERTING)
        return OperatorGraph(converting=conv, branch_chains=(rest,), shared=True)

    def all_ops(self) -> tuple[OpSpec, ...]:
        out = list(self.converting)
        for c in self.branch_chains:
            out.extend(c)
        return tuple(out)

    def op_names(self) -> tuple[str, ...]:
        return tuple(s.name for s in self.all_ops())

    def has_branches(self) -> bool:
        return (not self.shared) or any(
            get_operator(s.name).divides for s in self.converting)

    def label(self) -> str:
        conv = " -> ".join(s.label() for s in self.converting)
        if self.shared:
            body = " -> ".join(s.label() for s in self.branch_chains[0])
            return f"[{conv}] => [{body}]"
        bodies = " | ".join(" -> ".join(s.label() for s in c)
                            for c in self.branch_chains)
        return f"[{conv}] => branches({bodies})"

    def validate(self) -> None:
        if not self.converting or self.converting[0].name != "COMPRESS":
            raise GraphError("graph must start with COMPRESS (paper §IV-A: "
                             "the mapping stage always begins after COMPRESS)")
        for s in self.converting:
            if get_operator(s.name).stage != STAGE_CONVERTING:
                raise GraphError(f"{s.name} is not a converting operator")
        dividers = [s.name for s in self.converting
                    if get_operator(s.name).divides]
        if len(dividers) > 1:
            raise GraphError("at most one dividing operator per graph "
                             "(prototype scope, matches paper examples)")
        if not self.shared and not dividers:
            raise GraphError("per-branch chains require a dividing operator")
        for chain in self.branch_chains:
            ops = [get_operator(s.name) for s in chain]
            if any(op.stage == STAGE_CONVERTING for op in ops):
                raise GraphError("converting op inside a branch chain")
            # mapping ops must precede implementing ops
            seen_impl = False
            for op in ops:
                if op.stage == STAGE_IMPLEMENTING:
                    seen_impl = True
                elif seen_impl:
                    raise GraphError("mapping op after implementing op")
            layout_builders = [op for op in ops
                               if op.builds_layout is not None]
            if len(layout_builders) != 1:
                raise GraphError("each branch chain needs exactly one layout "
                                 "builder (LANE_ROW_BLOCK | LANE_NNZ_BLOCK)")
            reducers = [op for op in ops if op.is_reducer]
            if len(reducers) != 1:
                raise GraphError("each branch chain needs exactly one reducer")
            lb, red = layout_builders[0], reducers[0]
            if lb.builds_layout not in red.accepts_layouts:
                raise GraphError(f"{red.name} cannot follow {lb.name} "
                                 "(operator dependency, paper §IV-B)")
            names = [s.name for s in chain]
            for op in ops:
                for need in op.requires:
                    if need not in names:
                        raise GraphError(f"{op.name} requires {need}")
            # mapping order: tiling/padding decisions before the layout build
            lb_idx = next(i for i, op in enumerate(ops)
                          if op.builds_layout is not None)
            for i, op in enumerate(ops):
                if op.before_layout and i > lb_idx:
                    raise GraphError(f"{op.name} after layout builder")


def run_graph(matrix: SparseMatrix, graph: OperatorGraph) -> MetadataSet:
    """The Designer (paper §IV): execute operators in order on the metadata."""
    graph.validate()
    meta = from_matrix(matrix)
    for spec in graph.converting:
        if not get_operator(spec.name).applicable(meta):
            raise GraphError(f"{spec.name} not applicable at this point")
        meta = apply_op(meta, spec)

    if graph.shared:
        for spec in graph.branch_chains[0]:
            meta = apply_op(meta, spec)
        return meta

    if len(graph.branch_chains) != len(meta.blocks):
        raise GraphError(
            f"{len(graph.branch_chains)} branch chains for {len(meta.blocks)}"
            " branches")
    # run each branch chain on a single-block view, then re-join
    out_blocks = []
    sub_metas = []
    for block, chain in zip(meta.blocks, graph.branch_chains):
        sub = dataclasses.replace(meta, blocks=(block,))
        for spec in chain:
            sub = apply_op(sub, spec)
        out_blocks.append(sub.blocks[0])
        sub_metas.append(sub)
    joined = meta.with_blocks(out_blocks, "JOIN")
    # resource knobs (SET_RESOURCES: tiles_per_step / storage_dtype) set
    # inside a branch chain must survive the join. Both knobs are global
    # to the generated program, so branches are merged: the widest
    # megatile wins, and any branch requesting bf16 storage makes the
    # whole plan bf16 (the DesignSpace always heads every branch with the
    # same knob spec, so merged == per-branch there; the merge only
    # matters for user-authored graphs that set a knob in one branch).
    if sub_metas:
        joined = dataclasses.replace(
            joined,
            tiles_per_step=max(s.tiles_per_step for s in sub_metas),
            storage_dtype=("bfloat16"
                           if any(s.storage_dtype == "bfloat16"
                                  for s in sub_metas) else "float32"))
    return joined
