"""step_host_ms.sample: host ms one sampler step takes, the mean duration
of the program's "sampler.step" spans in the profiled part's trace (the
denoiser call, the step's noise draw and the update, as the host runs them
while the profiler records each launch). Silent unless the trace holds one
such span a forward."""

LAYER = "sampler"
MOVES = "scenes_per_s"
SPAN = "sampler.step"


def read(reading: dict):
    steps = [b - a for name, a, b in reading["trace"].spans if name == SPAN]
    if not steps or len(steps) != reading["profiled"].get("forwards"):
        return None
    return sum(steps) / 1e3 / len(steps)
