"""Set-up spent in the step's graph captures: ``capture.seconds`` of
tdrn_tpu_torch/inference.py, the eager warm-up on a side stream and the
capture of each frame shape, up to a synchronize of the card (on a
checkout's first run it holds the kernels' nvcc builds too, which
``setup.build_s`` also counts). None where nothing was captured."""

from perfbench import program


def read(name, record):
    return program.attribute("tdrn_tpu_torch.inference", "capture.seconds") or None
