"""dispatch_ms.sample: host ms a denoiser call takes to return, the mean
over every call of the traced run's untraced part. The harness's own
host-clock span around each call it hands the sampler: what the eager
sampler pays to enqueue one forward (and, where the device is the slower
side, the wait for room in the launch queue)."""

LAYER = "sampler"
MOVES = "scenes_per_s"


def read(reading: dict):
    calls = reading["host"].get("dispatch_s") or []
    if not calls:
        return None
    return 1e3 * sum(calls) / len(calls)
