"""Host ms a step inside the benchmark's span around the step call, mean
over the measured window (the host's launch and bookkeeping time; with
no synchronisation in the window it is also where the host waits when
the launch queue is full)."""


def read(layer: dict):
    return layer.get("step_host_ms")
