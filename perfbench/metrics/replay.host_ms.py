"""The host's time inside one ``StreamingDetector.detect`` call (staging the
frames, the graph replay's launch), the mean over the window's calls."""


def read(name, record):
    return record.get("detect_host_ms")
