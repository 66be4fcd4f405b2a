"""What the program counts of itself, read in the run's process after the
window: the totals of its host ranges (``span.totals`` of
tdrn_tpu_torch/utils/logging.py, ``{name: [calls, seconds]}``, summed over
every range the process closed, profiled or not) and its set-up counters
(function attributes). A program without them, or a run that never loaded
the module, reads None. One run a process: the totals are the process's."""

from __future__ import annotations

import sys
from typing import Optional, Sequence


def attribute(module: str, path: str):
    """``module``'s attribute at the dotted ``path``, or None where the
    module was not loaded or has none."""
    obj = sys.modules.get(module)
    for part in path.split("."):
        obj = getattr(obj, part, None)
    return obj


def span_totals() -> Optional[dict]:
    return attribute("tdrn_tpu_torch.utils.logging", "span.totals")


def ms_a_detect(names: Sequence[str]) -> Optional[float]:
    """The host seconds of the ranges ``names`` over the ``tdrn::detect``
    calls, in ms a call; None without a ``detect`` call or without any of
    the ranges."""
    totals = span_totals()
    calls = (totals or {}).get("tdrn::detect", [0])[0]
    have = [totals[n][1] for n in names if n in (totals or {})]
    if not calls or not have:
        return None
    return 1e3 * sum(have) / calls
