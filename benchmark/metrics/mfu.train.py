"""mfu.train: the train step's share of the card's bf16 peak. Three times
the copied forward FLOP count at the step's batch (forward and backward)
times the steps run, over the wall time of the traced run's untraced part,
over 989 TFLOP/s, in %."""

from benchmark import counts

LAYER = "trainer"
MOVES = "train_samples_per_s"


def read(reading: dict):
    host = reading["host"]
    if not host.get("steps") or not host.get("wall_s"):
        return None
    flops = 3 * host["forward_flops"] * host["steps"]
    return 100.0 * flops / host["wall_s"] / counts.PEAK_FLOPS
