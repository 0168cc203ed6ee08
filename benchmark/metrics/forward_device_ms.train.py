"""forward_device_ms.train: device ms a train step spends in the kernels
its forward launches (add_noise, the model's training arm, the MSE), from
the profiled part's trace: every kernel whose innermost host span is the
program's "train.forward", summed, over the steps. Silent unless each
profiled step opened one such span."""

LAYER = "trainer"
MOVES = "train_samples_per_s"


def span_device_ms(reading: dict, span: str):
    """Kernel ms a step launched innermost in `span`, or None unless the
    trace holds one `span` a profiled step."""
    trace, steps = reading["trace"], reading["profiled"].get("steps")
    kernels = trace.kernels(span=span)
    if not steps or trace.span_count(span) != steps or not kernels:
        return None
    return sum(k.dur for k in kernels) / 1e3 / steps


def read(reading: dict):
    return span_device_ms(reading, "train.forward")
