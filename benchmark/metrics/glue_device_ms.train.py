"""glue_device_ms.train: device ms a train step spends in PyTorch's own
elementwise, reduction, normalization, copy and concatenation kernels (the
training arm's f32 GroupNorm, SiLU, casts and layout changes, forward and
backward), from the profiled part's trace. Kernel names matching GLUE and
not OPTIMIZER count; the optimizer's and the clip's multi-tensor kernels
do not."""

LAYER = "trainer"
MOVES = "train_samples_per_s"
GLUE = r"at::native::|at_cuda_detail::"
OPTIMIZER = "multi_tensor_apply"


def read(reading: dict):
    steps = reading["profiled"].get("steps")
    kernels = [k for k in reading["trace"].kernels(GLUE) if OPTIMIZER not in k.name]
    if not steps or not kernels:
        return None
    return sum(k.dur for k in kernels) / 1e3 / steps
