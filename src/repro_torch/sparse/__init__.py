"""Artificial sparse formats (the paper's baselines) + the Perfect Format
Selector (paper §VII-B); port of ``repro.sparse``."""
from .baselines import BASELINES, BaselineFormat, build_baseline  # noqa: F401
from .pfs import PerfectFormatSelector  # noqa: F401
