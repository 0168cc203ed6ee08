"""The shapes chip_smoke.py holds the CUDA kernels to are the shapes the
model gives them: the GN+SiLU+conv3x3 calls and the mid-block attention
that a UNet2D forward really makes are recorded on the CPU and compared
with models/unet2d.py conv3x3_shapes / mid_attention_shape (also under
tensor parallelism at model 2, on two gloo ranks: heads / 2 heads a
rank), and every full-width shape passes the kernel wrappers' limits (the
same predicates the wrappers raise through)."""

import json
import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch

from drivescenegen_torch import ops
from drivescenegen_torch.config import ModelConfig
from drivescenegen_torch.models import UNet2D
from drivescenegen_torch.models.convert import torch_to_flax
from drivescenegen_torch.models.unet2d import (conv3x3_shapes, gn_mul_add_shapes,
                                               kernel_limit_errors, mid_attention_shape)
from drivescenegen_torch.ops import build
from drivescenegen_torch.ops import gn_silu_conv as gn_silu_conv_mod
from drivescenegen_torch.ops import group_norm as group_norm_mod
from drivescenegen_torch.ops.attention import attention_bwd_shape_error, attention_shape_error
from drivescenegen_torch.ops.gn_silu_conv import conv_shape_error
from drivescenegen_torch.ops.group_norm import stats_shape_error

TINY = dict(sample_size=16, block_out_channels=(8, 16), layers_per_block=1,
            norm_num_groups=2, attention_head_dim=8, dtype="float32")

CONFIGS = {
    "default": {},
    "split_skip_conv": dict(split_skip_conv=True),
    "three_levels": dict(block_out_channels=(8, 16, 32), layers_per_block=2),
    "sample_24": dict(sample_size=24),
    "cond": dict(cond_channels=2),
}


def _forward(cfg, plain):
    torch.manual_seed(0)
    model = UNet2D(cfg, device="cpu", plain=plain).eval()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, cfg.sample_size, cfg.sample_size,
                                          cfg.in_channels)).astype(np.float32))
    with torch.no_grad():
        model(x, torch.tensor([3, 500]))


@pytest.mark.parametrize("plain", [True, False], ids=["plain", "wrapper"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_conv3x3_shapes_are_the_forward_calls(monkeypatch, name, plain):
    """plain=True records ops.reference_gn_silu_conv3x3 (the plain model's
    call); plain=False records the kernel wrapper silu_conv3x3 that
    gn_silu_conv3x3 launches on the sampling path."""
    cfg = ModelConfig(**dict(TINY, **CONFIGS[name]))
    seen = Counter()
    if plain:
        inner = ops.reference_gn_silu_conv3x3

        def record(x, scale, bias, weight, conv_bias, *args, **kw):
            seen[(x.shape[1], x.shape[-1], weight.shape[0])] += 1
            assert x.shape[1] == x.shape[2]
            return inner(x, scale, bias, weight, conv_bias, *args, **kw)

        monkeypatch.setattr(ops, "reference_gn_silu_conv3x3", record)
    else:
        inner = gn_silu_conv_mod.silu_conv3x3

        def record(x, mul, add, weight, conv_bias):
            seen[(x.shape[1], x.shape[-1], weight.shape[0])] += 1
            assert x.shape[1] == x.shape[2]
            return inner(x, mul, add, weight, conv_bias)

        monkeypatch.setattr(gn_silu_conv_mod, "silu_conv3x3", record)
    _forward(cfg, plain)
    assert seen == conv3x3_shapes(cfg)


@pytest.mark.parametrize("plain", [True, False], ids=["plain", "wrapper"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_gn_mul_add_shapes_are_the_forward_calls(monkeypatch, name, plain):
    """plain=True records reference_gn_mul_add where the plain model's conv
    pairs and norm_out call it; plain=False records the stats wrapper
    gn_mul_add that gn_silu_conv3x3 and group_norm_silu launch."""
    cfg = ModelConfig(**dict(TINY, **CONFIGS[name]))
    seen = Counter()
    attr = "reference_gn_mul_add" if plain else "gn_mul_add"
    for mod in (gn_silu_conv_mod, group_norm_mod):
        inner = getattr(mod, attr)

        def record(x, scale, bias, *args, inner=inner, **kw):
            seen[(x.shape[1], x.shape[-1])] += 1
            assert x.dim() == 4 and x.shape[1] == x.shape[2]
            return inner(x, scale, bias, *args, **kw)

        monkeypatch.setattr(mod, attr, record)
    _forward(cfg, plain)
    assert seen == gn_mul_add_shapes(cfg)


@pytest.mark.parametrize("plain", [True, False], ids=["plain", "wrapper"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mid_attention_shape_is_the_forward_call(monkeypatch, name, plain):
    cfg = ModelConfig(**dict(TINY, **CONFIGS[name]))
    seen = []
    attr = "reference_attention" if plain else "attention"
    inner = getattr(ops, attr)

    def record(q, k, v, scale):
        seen.append(tuple(q.shape[1:]))
        assert k.shape == q.shape and v.shape == q.shape
        return inner(q, k, v, scale)

    monkeypatch.setattr(ops, attr, record)
    _forward(cfg, plain)
    assert seen == [mid_attention_shape(cfg)]


@pytest.mark.parametrize("heads", [2, 4], ids=["heads_2", "heads_4"])
def test_mid_attention_shape_under_tensor_parallelism_is_the_forward_call(tmp_path, heads):
    """One train step of the training arm at model 2 on two gloo ranks
    (tests/torch_tp_worker.py): each rank's forward calls the attention at
    mid_attention_shape(cfg, 2), heads / 2 heads of the full head dim."""
    cfg_kw = dict(TINY, attention_head_dim=16 // heads)
    cfg = ModelConfig(**cfg_kw)
    net = UNet2D(cfg, device="cpu", for_training=True, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    inputs = {"config": json.dumps({"model": cfg_kw, "train": dict(batch_size=2)}),
              "batch": rng.normal(size=(2, 16, 16, 3)).astype(np.float32),
              "noise_0": rng.normal(size=(2, 16, 16, 3)).astype(np.float32),
              "t_0": np.array([3, 500])}
    inputs.update({f"params/{k}": v for k, v in torch_to_flax(net.state_dict()).items()})
    np.savez(tmp_path / "in.npz", **inputs)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", "2", os.path.join(root, "tests", "torch_tp_worker.py"),
                          str(tmp_path / "in.npz"), "2", str(tmp_path / "out.npz")],
                         cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, (out.stdout + out.stderr)[-3000:]
    seen = [tuple(s) for s in np.load(tmp_path / "out.npz")["attention_shapes"]]
    assert seen == [mid_attention_shape(cfg, 2)] == [(heads // 2, 64, 16 // heads)]
    assert mid_attention_shape(cfg, 1) == (heads, 64, 16 // heads)


def test_full_width_shapes_under_tensor_parallelism():
    """Config-3's attention at model 2 and 4 runs 4 and 2 heads of 64 over
    1024 tokens, within the kernels' limits; at a model axis the heads do
    not divide it runs them all (the attention is replicated)."""
    cfg = ModelConfig(attention_impl="flash")
    assert [mid_attention_shape(cfg, m) for m in (1, 2, 4, 8, 3)] == [
        (8, 1024, 64), (4, 1024, 64), (2, 1024, 64), (1, 1024, 64), (8, 1024, 64)]
    for m in (2, 4):
        assert kernel_limit_errors(cfg, for_training=True, model=m) == []
    bad = ModelConfig(attention_impl="flash", attention_head_dim=32)
    assert kernel_limit_errors(bad, True, 2) == kernel_limit_errors(bad, True) != []


def test_full_width_shapes_pass_the_kernel_limits():
    cfg = ModelConfig(use_pallas_gn=True, use_pallas_gn_conv=True, attention_impl="flash")
    shapes = conv3x3_shapes(cfg)
    assert sum(shapes.values()) == 44  # two per ResnetBlock, 22 ResnetBlocks
    assert min(h for h, _, _ in shapes) == cfg.sample_size >> 3
    for H, C, Co in shapes:
        assert conv_shape_error(C, Co) is None, (H, C, Co)
    heads, S, D = mid_attention_shape(cfg)
    assert (heads, S, D) == (8, 1024, 64)
    assert attention_shape_error(S, D) is None


def test_full_width_shapes_pass_the_stats_kernel_limits():
    cfg = ModelConfig(use_pallas_gn=True, use_pallas_gn_conv=True, attention_impl="flash")
    shapes = gn_mul_add_shapes(cfg)
    assert sum(shapes.values()) == 45  # the 44 conv inputs and norm_out
    assert shapes[(cfg.sample_size, cfg.block_out_channels[0])] >= 1
    assert {C for _, C in shapes} == {64, 128, 192, 256, 384, 512, 768, 1024}
    for H, C in shapes:
        assert stats_shape_error(C, cfg.norm_num_groups) is None, (H, C)
    assert "group_norm" in build.SOURCES
    assert build.source_int("group_norm", "VEC") == 8
    assert build.source_int("group_norm", "MAX_C") >= max(C for _, C in shapes)


@pytest.mark.parametrize("name", build.SOURCES)
def test_every_source_states_the_sass_it_needs(name):
    """chip_smoke.py requires these opcodes in each library's SASS."""
    ops_needed = build.sass_must_hold(name)
    assert ops_needed and all(op.replace(".", "").isalnum() for op in ops_needed)
    if name == "group_norm":
        assert ops_needed == ("LDG.E.128.CONSTANT", "ATOMG")


@pytest.mark.parametrize("C,groups", [(100, 4), (96, 5), (4096, 32), (3080, 8), (64, 0)])
def test_stats_limits_reject_what_the_kernel_cannot_take(C, groups):
    assert stats_shape_error(C, groups) is not None


@pytest.mark.parametrize("C,Co", [(32, 64), (64, 32), (96, 128), (128, 96)])
def test_conv_limits_reject_what_the_kernel_cannot_take(C, Co):
    assert conv_shape_error(C, Co) is not None


@pytest.mark.parametrize("S,D", [(1024, 32), (1024, 128), (64, 64), (1000, 64)])
def test_attention_limits_reject_what_the_kernel_cannot_take(S, D):
    assert attention_shape_error(S, D) is not None


def test_attention_bwd_limits_take_the_mid_attention_shape():
    _, S, D = mid_attention_shape(ModelConfig())
    assert (S, D) == (1024, 64)
    assert attention_bwd_shape_error(S, D) is None


@pytest.mark.parametrize("S,D", [(1024, 32), (1024, 128), (1000, 64)])
def test_attention_bwd_limits_reject_what_the_kernel_cannot_take(S, D):
    assert attention_bwd_shape_error(S, D) is not None


def test_attention_bwd_limits_are_read_from_its_source():
    """The backward takes every shape the forward takes, and the plain
    decode of its dQ accumulator assumes 64-query tiles."""
    assert build.source_int("flash_attention_bwd", "D") == mid_attention_shape(ModelConfig())[2]
    fwd = build.source_int("flash_attention", "S_MULTIPLE")
    bwd = build.source_int("flash_attention_bwd", "S_MULTIPLE")
    assert fwd % bwd == 0
    assert build.source_int("flash_attention_bwd", "BQ") == 64
    assert attention_bwd_shape_error(bwd, 64) is None
    assert attention_bwd_shape_error(bwd // 2, 64) is not None


def test_limits_are_read_from_the_kernel_sources():
    assert build.source_int("flash_attention", "D") == mid_attention_shape(ModelConfig())[2]
    assert build.source_int("gn_silu_conv", "CK") == 64
    with pytest.raises(RuntimeError, match="0 lines"):
        build.source_int("gn_silu_conv", "NO_SUCH_LIMIT")
