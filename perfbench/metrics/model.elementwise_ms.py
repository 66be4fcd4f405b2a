"""Device time a step of the model's kernels that are neither the program's
own nor cuDNN's or cuBLAS's convolutions: norms, activations, residual adds,
casts, pools and the preprocess (trace.kind), before the detect tail starts;
memory copies and sets left out (trace.parts), from the traced stretch."""


def read(name, record):
    prof = record.get("profile")
    if not prof or not prof["steps"]:
        return None
    ms = prof["part_s"]["model"].get("other", 0.0) * 1e3
    return ms / prof["steps"] if ms > 0 else None
