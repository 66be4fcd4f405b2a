"""The card's idle a step under the program's own host ranges: the idle
gaps of the traced stretch put to a ``tdrn::*`` range (``tdrn__*`` in the
breakdown), in ms, over the stretch's steps. 0 where the program's ranges
were recorded and no gap fell in them; None where it records none."""

from perfbench import program


def read(name, record):
    prof = record.get("profile")
    if not prof or not prof["steps"]:
        return None
    gaps = [s for n, s in prof["breakdown"]["idle_gaps"] if n.startswith("tdrn__")]
    if not gaps and "tdrn::detect" not in (program.span_totals() or {}):
        return None
    return 1e3 * sum(gaps) / prof["steps"]
