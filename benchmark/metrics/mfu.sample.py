"""mfu.sample: the sampler's share of the card's bf16 peak. The copied FLOP
count of one forward (benchmark/counts.py, at the forward's rows: the
batch, twice it under guidance) times the forwards run, over the wall time
of the traced run's untraced part, over 989 TFLOP/s, in %."""

from benchmark import counts

LAYER = "model"
MOVES = "scenes_per_s"


def read(reading: dict):
    host = reading["host"]
    if not host.get("forwards") or not host.get("wall_s"):
        return None
    flops = host["forward_flops"] * host["forwards"]
    return 100.0 * flops / host["wall_s"] / counts.PEAK_FLOPS
