"""``repro_torch.design``: the public, extensible design-space API.

The paper's Operator Graph is an *open* design space; this package is
where it opens up:

* **operator registry** — ``@register_operator("MY_OP")`` adds an
  out-of-tree :class:`Operator` that flows Designer -> graph JSON ->
  kernel spec -> saved ``SpmvPlan`` without touching ``repro_torch.core``;
* **DesignSpace** — enumerates/binds candidate graphs for a (matrix,
  SearchConfig) pair: structure templates, §VI-B pruning, parameter
  grids, cost-model features;
* **SearchStrategy protocol** — ``propose(space, history)`` /
  ``observe(result)``; shipped strategies: ``AnnealStrategy`` (the
  original SA walk, default), ``GridStrategy`` (coarse->fine grids),
  ``CostModelGuidedStrategy`` (GBT-ranked proposals). Register custom
  policies with ``@register_strategy("name")`` and select them via
  ``repro_torch.compile(..., strategy="name")``.

Attribute access is lazy (PEP 562, same as ``repro_torch`` itself): importing
``repro_torch.design`` pulls in neither torch nor numpy, so operators can be
registered cheaply.
"""

_EXPORTS = {
    # registry (stdlib-only module: safe to import eagerly via attribute)
    "Operator": "repro_torch.design.registry",
    "OpSpec": "repro_torch.design.registry",
    "GraphError": "repro_torch.design.registry",
    "register_operator": "repro_torch.design.registry",
    "unregister_operator": "repro_torch.design.registry",
    "get_operator": "repro_torch.design.registry",
    "operator_names": "repro_torch.design.registry",
    "OPERATOR_REGISTRY": "repro_torch.design.registry",
    "STAGE_CONVERTING": "repro_torch.design.registry",
    "STAGE_MAPPING": "repro_torch.design.registry",
    "STAGE_IMPLEMENTING": "repro_torch.design.registry",
    # design space
    "DesignSpace": "repro_torch.design.space",
    "Structure": "repro_torch.design.space",
    # strategies
    "SearchStrategy": "repro_torch.design.strategies",
    "Proposal": "repro_torch.design.strategies",
    "CandidateResult": "repro_torch.design.strategies",
    "AnnealStrategy": "repro_torch.design.strategies",
    "GridStrategy": "repro_torch.design.strategies",
    "CostModelGuidedStrategy": "repro_torch.design.strategies",
    "LearnedStrategy": "repro_torch.design.strategies",
    "register_strategy": "repro_torch.design.strategies",
    "make_strategy": "repro_torch.design.strategies",
    "strategy_names": "repro_torch.design.strategies",
    "STRATEGY_REGISTRY": "repro_torch.design.strategies",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module 'repro_torch.design' has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(module), name)


def __dir__():
    return __all__
