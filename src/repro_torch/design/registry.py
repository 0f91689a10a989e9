"""Operator registry: the open half of the paper's design space.

AlphaSparse's central claim is that the Operator Graph is an *open*
design space — machine designs "go beyond the scope of human-designed
format(s)" by composing operators. This module makes the operator set
itself open: operators are looked up by name in a process-wide registry,
so an out-of-tree operator registered with
``@repro_torch.design.register_operator("MY_OP")`` flows through the whole
stack (Designer -> graph JSON -> kernel spec -> saved ``SpmvPlan``)
without touching ``repro_torch.core``.

An operator declares, as class attributes, everything the graph
validator and the search engine need to reason about it:

* ``stage`` — ``converting`` | ``mapping`` | ``implementing``;
* ``divides`` — converting op that splits the matrix into branches;
* ``builds_layout`` — mapping op that packs a tile layout (``"ell"`` |
  ``"seg"``, or a custom kind with a matching reducer);
* ``is_reducer`` / ``accepts_layouts`` — implementing op and the layout
  kinds it can follow (the paper's operator dependencies, §IV-B);
* ``requires`` — op names that must appear earlier in the same chain
  (e.g. SORT_TILE requires TILE_ROW_BLOCK);
* ``before_layout`` — mapping op that must precede the layout builder;
* ``coarse_grid`` / ``fine_grid`` — parameter grids for the search
  levels 2/3 (paper §VI-A);
* ``applicable(meta)`` / ``apply(meta, spec)`` — the Designer contract.

This module is import-light on purpose (stdlib only): ``repro_torch.core``
imports it, never the other way around.
"""
from __future__ import annotations

__all__ = ["GraphError", "Operator", "OpSpec", "OPERATOR_REGISTRY",
           "register_operator", "unregister_operator", "get_operator",
           "operator_names", "STAGE_CONVERTING", "STAGE_MAPPING",
           "STAGE_IMPLEMENTING"]

STAGE_CONVERTING = "converting"
STAGE_MAPPING = "mapping"
STAGE_IMPLEMENTING = "implementing"

_STAGES = (STAGE_CONVERTING, STAGE_MAPPING, STAGE_IMPLEMENTING)


class GraphError(ValueError):
    """Raised when an Operator Graph violates operator dependencies."""


import dataclasses


@dataclasses.dataclass(frozen=True, order=True)
class OpSpec:
    """Hashable (operator, params) node of an Operator Graph."""

    name: str
    params: tuple[tuple[str, object], ...] = ()

    def param(self, key, default=None):
        for k, v in self.params:
            if k == key:
                return v
        return default

    @staticmethod
    def make(name: str, **params) -> "OpSpec":
        return OpSpec(name, tuple(sorted(params.items())))

    def label(self) -> str:
        ps = ",".join(f"{k}={v}" for k, v in self.params)
        return f"{self.name}({ps})"


class Operator:
    """Base class / declared-trait contract for design-space operators."""

    name: str
    stage: str

    # structural traits consumed by graph validation and the DesignSpace
    divides: bool = False                 # converting op that branches
    builds_layout: str | None = None      # mapping op packing a layout kind
    is_reducer: bool = False              # implementing op choosing a reduce
    accepts_layouts: tuple[str, ...] = ()  # layout kinds a reducer follows
    requires: tuple[str, ...] = ()        # ops that must appear in the chain
    before_layout: bool = False           # mapping op preceding the builder

    # parameter grids for the search engine (paper §VI-A levels 2/3)
    @staticmethod
    def coarse_grid(meta=None) -> list[dict]:
        return [{}]

    @staticmethod
    def fine_grid(meta=None) -> list[dict]:
        return [{}]

    @staticmethod
    def applicable(meta) -> bool:
        return True

    @staticmethod
    def apply(meta, spec):
        raise NotImplementedError


# The one process-wide registry. ``repro_torch.core.operators`` re-exports this
# dict as ``OPERATORS`` (same object), so registration is visible through
# both surfaces.
OPERATOR_REGISTRY: dict[str, type[Operator]] = {}


def register_operator(name: str | None = None, *, replace: bool = False):
    """Class decorator registering an :class:`Operator` by name.

    ``@register_operator("MY_OP")`` sets ``cls.name = "MY_OP"`` and adds
    the class to the registry; with no argument the class's own ``name``
    attribute is used. Re-registering an existing name raises unless
    ``replace=True`` (tests use replace + :func:`unregister_operator`).
    """
    def deco(cls: type) -> type:
        op_name = name if name is not None else getattr(cls, "name", None)
        if not op_name or not isinstance(op_name, str):
            raise ValueError("operator needs a name: pass it to "
                             "register_operator(...) or set cls.name")
        stage = getattr(cls, "stage", None)
        if stage not in _STAGES:
            raise ValueError(f"operator {op_name!r} must declare stage in "
                             f"{_STAGES}, got {stage!r}")
        if not callable(getattr(cls, "apply", None)):
            raise ValueError(f"operator {op_name!r} must define "
                             "apply(meta, spec)")
        if op_name in OPERATOR_REGISTRY and not replace:
            raise ValueError(f"operator {op_name!r} already registered; "
                             "pass replace=True to override")
        cls.name = op_name
        OPERATOR_REGISTRY[op_name] = cls
        return cls

    # support bare @register_operator on a class that sets .name itself
    if isinstance(name, type):
        cls, name = name, None
        return deco(cls)
    return deco


def unregister_operator(name: str) -> None:
    """Remove an operator (no-op if absent). Intended for tests/examples."""
    OPERATOR_REGISTRY.pop(name, None)


_BUILTINS_LOADED = False


def _ensure_builtins() -> None:
    """Built-in operators register as a side effect of importing
    ``repro_torch.core.operators``; trigger that import on first lookup so the
    registry works whatever gets imported first (runtime-only dependency —
    no import cycle: core imports this module at load, not vice versa)."""
    global _BUILTINS_LOADED
    if not _BUILTINS_LOADED:
        _BUILTINS_LOADED = True
        import repro_torch.core.operators  # noqa: F401


def get_operator(name: str) -> type[Operator]:
    """Resolve an operator name, with a clear error for unknown names."""
    _ensure_builtins()
    try:
        return OPERATOR_REGISTRY[name]
    except KeyError:
        known = ", ".join(sorted(OPERATOR_REGISTRY)) or "(none)"
        raise GraphError(
            f"unknown operator {name!r}: not in the operator registry. "
            f"Registered operators: {known}. Out-of-tree operators must be "
            "registered with @repro_torch.design.register_operator before graphs "
            "naming them are validated or run.") from None


def operator_names() -> tuple[str, ...]:
    _ensure_builtins()
    return tuple(sorted(OPERATOR_REGISTRY))
