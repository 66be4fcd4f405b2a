"""Device time a step of the detect tail: every kernel from the cascade (K1)
to the step's end (decode, prefilter, per-class top-k, the suppression K2,
the overall top-k), memory copies and sets left out (trace.parts), from the
traced stretch. Nothing where K1 never ran."""


def read(name, record):
    prof = record.get("profile")
    if not prof or not prof["steps"]:
        return None
    ms = sum(prof["part_s"]["tail"].values()) * 1e3
    return ms / prof["steps"] if ms > 0 else None
