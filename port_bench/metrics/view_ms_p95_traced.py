"""The 95th percentile of every frame's latency in the traced window, ms:
the call to the host array in hand, by the host's clock, under the
profiler. The view cell's device idles over half its window, so the tail
is the host's and is read here rather than held to a bound."""


def read(layer):
    return layer.get("frame_ms_p95")
