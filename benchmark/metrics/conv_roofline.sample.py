"""conv_roofline.sample: the fused GroupNorm+SiLU+conv3x3 kernel's share of
its roofline in the sampler's forwards. The summed bound of every
silu_conv3x3_kernel launch of the profiled part (from the shapes one
forward makes, benchmark/counts.py) over their summed traced time, in %.
Silent unless the trace holds exactly the launches those forwards make."""

from benchmark import counts

LAYER = "kernels"
MOVES = "scenes_per_s"
KERNEL = r"silu_conv3x3_kernel"


def read(reading: dict):
    prof = reading["profiled"]
    kernels = reading["trace"].kernels(KERNEL)
    bound, per_forward = counts.conv3x3_forward_bound_s(reading["config"]["model"],
                                                        prof["rows_per_forward"])
    if not kernels or len(kernels) != per_forward * prof["forwards"]:
        return None
    return 100.0 * bound * prof["forwards"] / (sum(k.dur for k in kernels) / 1e6)
