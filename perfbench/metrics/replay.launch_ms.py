"""The host's time launching one step's graph and copying its outputs, a
``detect`` call: the program's ``tdrn::replay`` and ``tdrn::clone`` ranges
over its ``tdrn::detect`` calls: every call of the run, as for
``replay.host_ms``, the set-up's warm-up calls and the traced stretch's
among them."""

from perfbench import program


def read(name, record):
    return program.ms_a_detect(["tdrn::replay", "tdrn::clone"])
