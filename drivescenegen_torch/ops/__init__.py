"""Kernel wrappers. Each runs its plain PyTorch version on a CPU tensor and
its hand-written Hopper kernel on a CUDA tensor, counting launches in
`<wrapper>.launches`."""

from drivescenegen_torch.ops.attention import (  # noqa: F401
    AttentionFunction,
    attention,
    attention_bwd,
    attention_bwd_d8,
    attention_bwd_dq,
    attention_bwd_main,
    attention_bwd_prep,
    attention_with_lse,
    dq_from_fragment_order,
    dq_to_fragment_order,
    reference_attention,
    reference_attention_bwd,
    reference_attention_bwd_dq,
    reference_attention_bwd_main,
    reference_attention_di,
    reference_attention_lse,
)
from drivescenegen_torch.ops.gn_silu_conv import (  # noqa: F401
    gn_silu_conv3x3,
    reference_gn_silu_conv3x3,
    reference_silu_conv3x3,
    silu_conv3x3,
)
from drivescenegen_torch.ops.group_norm import (  # noqa: F401
    GroupNormSiLUFunction,
    composition_group_norm_silu,
    gn_mul_add,
    group_norm_silu,
    group_norm_silu_bwd,
    reference_gn_mul_add,
    reference_gn_stats,
    reference_group_norm_silu_bwd,
    reference_group_norm_silu,
    reference_group_norm_silu_multi,
    reference_silu_affine,
    silu_affine,
)

# Every kernel wrapper, for counting launches: the sampling path's four,
# then the training path's: the attention backward's (three at head dim
# 64, one at head dim 8) and the GroupNorm+SiLU backward (the training arm
# launches gn_mul_add and silu_affine at each of its GN sites too).
KERNEL_WRAPPERS = (silu_conv3x3, gn_mul_add, silu_affine, attention, attention_bwd_prep,
                   attention_bwd_main, attention_bwd_dq, attention_bwd_d8, group_norm_silu_bwd)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    attention.launches_by_source = dict.fromkeys(attention.launches_by_source, 0)


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
