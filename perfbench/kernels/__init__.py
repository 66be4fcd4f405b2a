"""The program's hand-written kernels, one file each, named by the kernel
(``K1.py`` for K1), which perfbench/roofline.py finds by the directory.

A kernel file keeps:

``NAMES``
    the substrings of the kernel's names in the device trace; no trace name
    may hold a substring of two files' NAMES.
``bound_s(cfg, batch)``
    the least time of one launch in a step of ``batch`` frames of the
    configuration, in seconds, from roofline.py's peaks and formulas; or
    None, where the kernel is named in the trace but its bound is not
    counted.
"""
