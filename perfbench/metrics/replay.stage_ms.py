"""The host's time staging one step's inputs, a ``detect`` call: the
program's ``tdrn::stage`` range (the masks, the wait on the pinned buffer's
event, the frames' copy into pinned memory, the copies to the card), over
its ``tdrn::detect`` calls: every call of the run, as for
``replay.host_ms``, the set-up's warm-up calls and the traced stretch's
among them."""

from perfbench import program


def read(name, record):
    return program.ms_a_detect(["tdrn::stage"])
