"""idle_share.train: the share of the profiled part's window in which no
kernel, copy or memset ran on the device, in %: 1 - the union of device
intervals over the window span."""

LAYER = "device"
MOVES = "train_samples_per_s"


def read(reading: dict):
    trace = reading["trace"]
    if trace.window_s <= 0 or not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
