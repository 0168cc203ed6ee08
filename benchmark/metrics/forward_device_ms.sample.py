"""forward_device_ms.sample: device ms of the kernels one denoiser call
launches, from the profiled part's trace: every kernel whose launch lies in
a "dispatch" span, summed, over the number of those spans."""

LAYER = "model"
MOVES = "scenes_per_s"


def read(reading: dict):
    trace = reading["trace"]
    calls = trace.span_count("dispatch")
    kernels = trace.kernels(span="dispatch")
    if not calls or not kernels:
        return None
    return sum(k.dur for k in kernels) / 1e3 / calls
