"""The port's analytic FLOP count (utils/flops.py) against the JAX
package's, and against torch's own count of the port's plain forward."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from drivescenegen_tpu.config import ModelConfig as JaxModelConfig
from drivescenegen_tpu.utils import flops as jax_flops
from drivescenegen_torch.config import ModelConfig
from drivescenegen_torch.models import UNet2D
from drivescenegen_torch.utils import flops

# tests/test_flops.py's two configs, and the default (flagship) model.
CONFIGS = {
    "small": dict(sample_size=32, block_out_channels=(16, 32), layers_per_block=1,
                  norm_num_groups=4, attention_head_dim=8, dtype="float32"),
    "three_blocks": dict(sample_size=64, block_out_channels=(32, 64, 96), layers_per_block=2,
                         norm_num_groups=8, attention_head_dim=16, dtype="float32"),
    "default": {},
    "conditional": dict(sample_size=128, in_channels=1, out_channels=1, cond_channels=2),
}


def _pair(name):
    return ModelConfig(**CONFIGS[name]), JaxModelConfig(**CONFIGS[name])


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("batch", [1, 8])
def test_forward_flops_equal_jax(name, batch):
    cfg, jcfg = _pair(name)
    assert flops.unet2d_forward_flops(cfg, batch) == jax_flops.unet2d_forward_flops(jcfg, batch)


def test_flagship_count():
    """351 GFLOP a sample at 256x256 (PERF.md section 3)."""
    assert round(flops.unet2d_forward_flops(ModelConfig()) / 1e9) == 351


@pytest.mark.parametrize("name", ["small", "three_blocks"])
def test_forward_flops_near_torch_flop_counter(name):
    """Within 5% of FlopCounterMode over the port's plain forward on the
    CPU (convolutions, matmuls and the attention; elementwise work is in
    neither count)."""
    cfg, _ = _pair(name)
    model = UNet2D(cfg, device="cpu", generator=torch.Generator().manual_seed(0)).eval()
    x = torch.zeros(2, cfg.sample_size, cfg.sample_size, cfg.in_channels)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(x, torch.zeros(2, dtype=torch.int64))
    ours = flops.unet2d_forward_flops(cfg, batch=2)
    total = counter.get_total_flops()
    assert abs(ours - total) / total < 0.05, (ours, total)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_speed_of_light_and_roofline_equal_jax_at_its_arguments(name):
    cfg, jcfg = _pair(name)
    assert flops.unet2d_speed_of_light(cfg, mxu_lanes=128) == \
        jax_flops.unet2d_speed_of_light(jcfg)
    for batch in (1, 8):
        got = flops.unet2d_roofline_seconds(cfg, batch, peak_flops=197e12, hbm_bw=819e9,
                                            mxu_lanes=128)
        assert got == jax_flops.unet2d_roofline_seconds(jcfg, batch)


def test_h100_defaults():
    """No lane cap on Hopper: the speed of light is 1, the roofline's FLOP
    time is the count over 989 TFLOP/s (less the time-embedding denses,
    which the roofline leaves out: 9e-6 of it), and its time sits between
    the larger of the two pure times and their sum."""
    cfg = ModelConfig()
    assert flops.unet2d_speed_of_light(cfg) == 1.0
    r = flops.unet2d_roofline_seconds(cfg, batch=8)
    at_peak = flops.unet2d_forward_flops(cfg, 8) / 989e12
    assert at_peak * (1 - 1e-4) <= r["t_flops_only_s"] < at_peak
    assert max(r["t_flops_only_s"], r["t_mem_only_s"]) <= r["t_roofline_s"] <= \
        r["t_flops_only_s"] + r["t_mem_only_s"]
    assert r == flops.unet2d_roofline_seconds(cfg, 8, peak_flops=989e12, hbm_bw=3.35e12,
                                               mxu_lanes=1)
