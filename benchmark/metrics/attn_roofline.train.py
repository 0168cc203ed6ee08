"""attn_roofline.train: the head-dim-8 attention kernels' share of their
roofline in the train step: the forward with its lse output
(flash_attention_d8_kernel) and the one-launch backward
(flash_attention_bwd_d8_kernel), once each a step. Their summed bounds
(benchmark/counts.py) over their summed traced time, in %. Silent unless
the trace holds one of each a step."""

from benchmark import counts

LAYER = "kernels"
MOVES = "train_samples_per_s"
FORWARD, BACKWARD = r"flash_attention_d8_kernel", r"flash_attention_bwd_d8_kernel"


def read(reading: dict):
    steps, B = reading["profiled"]["steps"], reading["profiled"]["batch"]
    fwd, bwd = reading["trace"].kernels(FORWARD), reading["trace"].kernels(BACKWARD)
    if len(fwd) != steps or len(bwd) != steps:
        return None
    heads, S, D = counts.mid_attention_shape(reading["config"]["model"])
    bound = (counts.attention_fwd_bound_s(B, heads, S, D, with_lse=True)
             + counts.attention_bwd_bound_s(B, heads, S, D))
    return 100.0 * bound * steps / (sum(k.dur for k in fwd + bwd) / 1e6)
