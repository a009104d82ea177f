"""Host ms a step spent waiting for the next batch from the session's
`BatchPipeline` (its prefetch thread), mean over the measured window."""


def read(layer: dict):
    return layer.get("input_wait_ms")
