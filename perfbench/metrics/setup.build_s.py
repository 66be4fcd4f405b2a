"""Set-up spent loading the port's kernel libraries: ``library.seconds`` of
tdrn_tpu_torch/_build.py summed, each library's first load (the nvcc
version check, any nvcc build, the ctypes load). None where none was
loaded."""

from perfbench import program


def read(name, record):
    seconds = program.attribute("tdrn_tpu_torch._build", "library.seconds")
    if not seconds:
        return None
    return sum(seconds.values())
