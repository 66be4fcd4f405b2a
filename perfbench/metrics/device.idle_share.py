"""The share of the traced stretch in which no kernel or copy ran on the
card, in percent."""


def read(name, record):
    prof = record.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
