"""quantize_idle_ms.sample: device idle ms a batch while the program
delivers its scenes, from the profiled part's trace: the idle gaps whose
middle lies innermost in the program's "quantize.copy" (the wait for the
batch and the device-to-host copy) or "quantize.host" (numpy's passes)
span, summed, over the batches. Silent unless each profiled batch opened
one of each."""

from benchmark.trace_summary import innermost

LAYER = "sampler"
MOVES = "scenes_per_s"
SPANS = ("quantize.copy", "quantize.host")


def read(reading: dict):
    trace = reading["trace"]
    batches = reading["cell"]["params"]["profiled_batches"]
    if not batches or any(trace.span_count(s) != batches for s in SPANS):
        return None
    idle = sum(b - a for a, b in trace.gaps if innermost(trace.spans, (a + b) / 2) in SPANS)
    return idle / 1e3 / batches
