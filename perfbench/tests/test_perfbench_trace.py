"""The traced stretch's device events split into the step's parts: copies,
the detect tail from the cascade (K1) to the next step's staging, and the
model before it."""

from perfbench import trace

K1 = "void cascade_kernel<31>(Params)"


def test_parts_follow_the_step_order():
    events = [  # (start, end, name) in microseconds, two steps
        (0, 1, "Memcpy HtoD (Pinned -> Device)"), (1, 5, "cudnn_conv_fprop"),
        (5, 7, "elementwise_kernel_relu"), (7, 8, K1), (8, 10, "radixSort"),
        (10, 11, "Memcpy DtoD (Device -> Device)"), (11, 12, "gather_kernel"),
        (12, 13, "Memcpy DtoH (Device -> Pinned)"),
        (13, 14, "Memcpy HtoD (Pinned -> Device)"), (14, 17, "elementwise_kernel_add"),
    ]
    got = trace.parts(events)
    us = lambda d: {k: round(v * 1e6, 6) for k, v in d.items()}
    assert us(got["copy"]) == {"copy": 4.0}
    assert us(got["model"]) == {"conv": 4.0, "other": 5.0}
    assert us(got["tail"]) == {"port": 1.0, "other": 3.0}
