"""The program's own kernels against their bounds: the sum over the traced
launches of each launch's bound time (the kernel's file under
perfbench/kernels/, at the cell's shapes) over the sum of their measured
device time, in percent. A kernel whose file counts no bound is left out of
both sums. Nothing when no counted kernel ran."""

from perfbench import roofline


def read(name, record):
    prof = record.get("profile")
    if not prof:
        return None
    bounds = roofline.bounds_s(record["config"], record["batch"])
    bound = spent = 0.0
    for kernel, seconds in prof["kernel_s"].items():
        k = roofline.kernel_of(kernel)
        if k in bounds:
            bound += bounds[k] * prof["kernel_n"][kernel]
            spent += seconds
    return 100.0 * bound / spent if spent > 0 else None
