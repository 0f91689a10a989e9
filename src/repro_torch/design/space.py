"""DesignSpace: the enumerable half of the search (paper §VI levels 1-2).

The single source of truth for *what can be searched*: structure templates
(operator chains without parameters), the statistics-keyed pruning rules
(paper §VI-B), seed structures (one per source-format family), and
parameter binding (coarse/fine grids -> concrete ``OperatorGraph``\\ s).
``repro_torch.core.search`` used to hard-code all of this; strategies now
receive a ``DesignSpace`` and decide *how* to walk it.

The space is registry-open: operators registered out of tree via
``repro_torch.design.register_operator`` are woven into the enumerated
structures from their declared traits — a new converting operator becomes
an extra converting choice, a new layout builder is paired with every
reducer that accepts its layout kind, a new reducer with every builder it
accepts. With nothing registered beyond the built-ins the space is
byte-identical to the pre-registry tables (strategy parity depends on
this).
"""
from __future__ import annotations

import dataclasses
import itertools

from .registry import (OPERATOR_REGISTRY, STAGE_CONVERTING, STAGE_MAPPING,
                       STAGE_IMPLEMENTING, _ensure_builtins, get_operator)

__all__ = ["Structure", "DesignSpace", "structure_space",
           "CONVERTING_CHOICES", "MAPPING_IMPL_CHOICES", "SEED_STRUCTURES"]


# ------------------------- structure templates ----------------------------

CONVERTING_CHOICES: tuple[tuple[str, ...], ...] = (
    (),
    ("SORT",),
    ("BIN",),
    ("BIN", "SORT_SUB"),
    ("ROW_DIV",),
    ("ROW_DIV", "SORT_SUB"),
    ("COL_DIV",),
    ("HYB_SPLIT",),   # beyond-paper: the paper's §VII-H missing operator
)

MAPPING_IMPL_CHOICES: tuple[tuple[str, ...], ...] = (
    ("LANE_ROW_BLOCK", "LANE_TOTAL_RED"),
    ("TILE_ROW_BLOCK", "LANE_ROW_BLOCK", "LANE_TOTAL_RED"),
    ("TILE_ROW_BLOCK", "LANE_PAD", "LANE_ROW_BLOCK", "LANE_TOTAL_RED"),
    ("TILE_ROW_BLOCK", "SORT_TILE", "LANE_ROW_BLOCK", "LANE_TOTAL_RED"),
    ("TILE_ROW_BLOCK", "SORT_TILE", "LANE_PAD", "LANE_ROW_BLOCK",
     "LANE_TOTAL_RED"),
    ("LANE_NNZ_BLOCK", "SEG_SCAN_RED"),
    ("LANE_NNZ_BLOCK", "ONEHOT_MXU_RED"),
    ("LANE_NNZ_BLOCK", "GMEM_ATOM_RED"),
)

# Evaluated FIRST, before any strategy's walk: one structure per
# source-format family (paper Table II "Source" column). Guarantees the
# search never loses to its own seeds modulo timing noise.
SEED_STRUCTURES: tuple[tuple[tuple[str, ...], tuple[str, ...]], ...] = (
    ((), ("TILE_ROW_BLOCK", "LANE_ROW_BLOCK", "LANE_TOTAL_RED")),  # ELL-tiled
    (("SORT",), ("TILE_ROW_BLOCK", "LANE_ROW_BLOCK",
                 "LANE_TOTAL_RED")),                               # SELL
    ((), ("LANE_NNZ_BLOCK", "GMEM_ATOM_RED")),                     # merge/COO
    ((), ("LANE_NNZ_BLOCK", "SEG_SCAN_RED")),                      # CSR5
)

_BASE_CONVERTING_OPS = frozenset(
    n for c in CONVERTING_CHOICES for n in c) | {"COMPRESS"}
_BASE_CHAIN_OPS = frozenset(n for c in MAPPING_IMPL_CHOICES for n in c) | {
    "SET_RESOURCES"}


@dataclasses.dataclass(frozen=True)
class Structure:
    """A graph structure: op-name chains, parameters not yet bound."""

    converting: tuple[str, ...]
    chains: tuple[tuple[str, ...], ...]  # len 1 = shared; len >1 = per-branch
    shared: bool = True

    def label(self) -> str:
        conv = "+".join(self.converting) or "-"
        body = " | ".join("+".join(c) for c in self.chains)
        return f"{conv} => {body}"


def _registry_extra_choices():
    """Weave registered out-of-tree operators into the enumerated space.

    Returns (extra converting choices, extra mapping+impl chains), both
    deterministically ordered (sorted by name). Empty when only built-ins
    are registered — the parity guarantee.
    """
    _ensure_builtins()
    extra_convs: list[tuple[str, ...]] = []
    extra_chains: list[tuple[str, ...]] = []
    builders = {name: op for name, op in OPERATOR_REGISTRY.items()
                if op.builds_layout is not None}
    reducers = {name: op for name, op in OPERATOR_REGISTRY.items()
                if op.is_reducer}
    for name in sorted(OPERATOR_REGISTRY):
        op = OPERATOR_REGISTRY[name]
        if op.stage == STAGE_CONVERTING and name not in _BASE_CONVERTING_OPS:
            extra_convs.append((name,))
        elif op.stage == STAGE_MAPPING and op.builds_layout is not None \
                and name not in _BASE_CHAIN_OPS:
            for red in sorted(reducers):
                if op.builds_layout in reducers[red].accepts_layouts:
                    extra_chains.append((name, red))
        elif op.stage == STAGE_IMPLEMENTING and op.is_reducer \
                and name not in _BASE_CHAIN_OPS:
            for b in sorted(builders):
                if builders[b].builds_layout in op.accepts_layouts:
                    extra_chains.append((b, name))
    return tuple(extra_convs), tuple(extra_chains)


def structure_space(pruned_convs, pruned_chains,
                    allow_branch_mix: bool) -> list[Structure]:
    """Enumerate structures from converting choices x chain choices."""
    out = []
    for conv in pruned_convs:
        for chain in pruned_chains:
            out.append(Structure(("COMPRESS",) + conv, (chain,), shared=True))
    if allow_branch_mix:
        # the paper's branched graphs (§VII-G): different designs per branch.
        ell = ("TILE_ROW_BLOCK", "LANE_ROW_BLOCK", "LANE_TOTAL_RED")
        seg = ("LANE_NNZ_BLOCK", "SEG_SCAN_RED")
        oneh = ("LANE_NNZ_BLOCK", "ONEHOT_MXU_RED")
        for combo in ((ell, seg), (ell, oneh), (seg, ell)):
            out.append(Structure(("COMPRESS", "BIN"), combo, shared=False))
        # HYB proper: dense-regular part -> ELL, overflow -> flat segment
        atom = ("LANE_NNZ_BLOCK", "GMEM_ATOM_RED")
        out.append(Structure(("COMPRESS", "HYB_SPLIT"), (ell, atom),
                             shared=False))
    return out


class DesignSpace:
    """Candidate designs for one (matrix, SearchConfig) pair.

    Derived from the operator registry, the matrix's sparsity statistics
    (pruning, paper §VI-B) and the search config. Strategies consume it
    through:

    * ``seed_structures()`` — the source-format fidelity floor, evaluated
      first by every shipped strategy;
    * ``structures()`` — the full pruned structure space (seeds included);
    * ``bind(structure, "coarse"|"fine")`` — cartesian parameter binding
      to concrete ``OperatorGraph`` candidates;
    * ``features(graph)`` — the cost-model feature vector of a candidate
      *without timing it* (None if the graph is invalid for the matrix);
    * ``pruned_ops`` — the §VI-B ban-list report.
    """

    def __init__(self, matrix, config):
        self.m = matrix
        self.cfg = config
        self.pruned_ops: tuple[str, ...] = ()
        self._convs, self._chains = self._prune()
        self._structures = structure_space(
            tuple(self._convs), tuple(self._chains),
            self.cfg.allow_branch_mix)
        # robustness quarantine: structure labels whose candidates keep
        # failing hard (crash/hang/OOM/wrong result) are banned from
        # further proposals — repeat offenders are data, not retries
        self._failure_counts: dict[str, int] = {}
        self.quarantined: set[str] = set()

    # -- quarantine (fault-tolerant search) --
    def note_failure(self, label: str, bucket: str = "crash",
                     threshold: int = 2) -> bool:
        """Record one hard candidate failure against ``label`` (a structure
        label); quarantine the structure once ``threshold`` failures have
        accumulated. Returns True when the structure is now quarantined."""
        if not label:
            return False
        n = self._failure_counts.get(label, 0) + 1
        self._failure_counts[label] = n
        if n >= max(threshold, 1):
            self.quarantined.add(label)
        return label in self.quarantined

    def is_quarantined(self, label: str) -> bool:
        return label in self.quarantined

    # -- pruning (paper §VI-B) --
    def _prune(self):
        extra_convs, extra_chains = _registry_extra_choices()
        convs = list(CONVERTING_CHOICES) + list(extra_convs)
        chains = list(MAPPING_IMPL_CHOICES) + list(extra_chains)
        pruned = []
        if self.cfg.use_pruning:
            row_var = self.m.row_variance()
            avg_len = self.m.avg_row_length()
            if row_var <= 100.0:          # regular: row branching cannot help
                # (COL_DIV divides columns, not rows — it stays; custom
                # dividers are conservatively kept in the space)
                convs = [c for c in convs
                         if not any(o in ("BIN", "ROW_DIV", "HYB_SPLIT")
                                    for o in c)]
                pruned += ["BIN", "ROW_DIV", "SORT_SUB", "HYB_SPLIT"]
            if row_var <= 4.0:            # near-uniform rows: sorting useless
                convs = [c for c in convs if "SORT" not in c]
                pruned += ["SORT"]
            if row_var > 100.0:
                # irregular: global-width ELL explodes in padding
                chains = [c for c in chains
                          if c != ("LANE_ROW_BLOCK", "LANE_TOTAL_RED")]
                pruned += ["LANE_ROW_BLOCK(untiled)"]
            if self.m.n_cols < 512:
                convs = [c for c in convs if "COL_DIV" not in c]
                pruned += ["COL_DIV"]
            if avg_len <= 2.0:            # rows too short for scan reductions
                chains = [c for c in chains if "SEG_SCAN_RED" not in c]
                pruned += ["SEG_SCAN_RED"]
        self.pruned_ops = tuple(dict.fromkeys(pruned))
        return convs, chains

    # -- enumeration --
    def seed_structures(self) -> list[Structure]:
        return [Structure(("COMPRESS",) + c, (b,), shared=True)
                for c, b in SEED_STRUCTURES]

    def structures(self) -> list[Structure]:
        return list(self._structures)

    # -- resource knobs (SET_RESOURCES) woven into every candidate --
    def _knob_specs(self):
        """SET_RESOURCES variants from the config's knob choices.

        Empty with the default choices — candidate graphs are then
        byte-identical to the pre-knob space (strategy golden-trace
        parity). Non-default choices (``repro_torch.compile`` widens them from
        the Target) multiply every bound structure by the knob grid, so
        megatile width and storage dtype are searched per matrix like any
        other design decision."""
        from .registry import OpSpec
        ks = tuple(getattr(self.cfg, "tiles_per_step_choices", (1,)) or (1,))
        ds = tuple(getattr(self.cfg, "dtype_choices",
                           ("float32",)) or ("float32",))
        if ks == (1,) and ds == ("float32",):
            return ()
        return tuple(OpSpec.make("SET_RESOURCES", tiles_per_step=int(k),
                                 dtype=str(d))
                     for k in ks for d in ds)

    # -- parameter binding --
    def bind(self, structure: Structure, grid: str) -> list:
        """Cartesian product of per-op parameter grids -> concrete graphs."""
        from repro_torch.core.graph import OperatorGraph
        from .registry import OpSpec

        def combos(chain):
            per_op = []
            for name in chain:
                op = get_operator(name)
                g = (op.coarse_grid(None) if grid == "coarse"
                     else op.fine_grid(None))
                per_op.append([OpSpec.make(name, **p) for p in g])
            return [tuple(c) for c in itertools.product(*per_op)]

        conv_combos = combos(structure.converting)
        chain_combos = [combos(c) for c in structure.chains]
        graphs = []
        for conv in conv_combos:
            for body in itertools.product(*chain_combos):
                graphs.append(OperatorGraph(conv, tuple(body),
                                            shared=structure.shared))
        knobs = self._knob_specs()
        if knobs:
            # the same knob spec heads every branch chain of a variant
            # (run_graph propagates it across the branched join)
            graphs = [OperatorGraph(g.converting,
                                    tuple((ks,) + c for c in g.branch_chains),
                                    shared=g.shared)
                      for g in graphs for ks in knobs]
        return graphs

    # -- model features without timing --
    def features(self, graph):
        """Cost-model feature vector for a candidate, or None if the graph
        is invalid / inapplicable for this matrix. Runs the Designer and
        packs the format (cheap, no jit, no timing)."""
        from repro_torch.core.graph import GraphError, run_graph
        from repro_torch.core.kernel_builder import build_program
        from repro_torch.core.cost_model import program_features
        try:
            graph.validate()
            meta = run_graph(self.m, graph)
            prog = build_program(meta, backend=self.cfg.backend)
            return program_features(meta, prog, self.cfg.batch_size)
        except (GraphError, ValueError):
            return None
