"""The attention's gradient at head dim 8 (csrc/flash_attention_bwd_d8.cu
and the lse output of csrc/flash_attention_d8.cu) on the CPU, held against
the JAX package: the head-dim-8 launch's plain version, chained after the
forward's with lse, against jax.vjp of the library's plain attention; the
lse against logsumexp; the autograd Function through gradcheck on strided
qkv views; the port's AttentionBlock at head dim 8 against jax.grad of the
JAX block; the backward's limits, read from both backward sources; the
training arm of DriveSceneGen's own model within the kernels' limits at
every tp; and the train CLI on the import CLI's config.yaml. The CUDA
kernels themselves are checked against their plain versions on the card
by chip_smoke.py (phase 17)."""

import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference_no_custom_vjp
from PIL import Image

from drivescenegen_tpu.models.unet2d import AttentionBlock as JaxAttentionBlock
from drivescenegen_torch import ops
from drivescenegen_torch.config import load_config
from drivescenegen_torch.models import import_diffusers
from drivescenegen_torch.models.unet2d import (AttentionBlock, kernel_limit_errors,
                                               mid_attention_shape)
from drivescenegen_torch.ops import build
from drivescenegen_torch.ops.attention import attention_bwd_shape_error, backward_kernels
from drivescenegen_torch.scripts import generation, import_reference, train

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_import_diffusers import TorchUNet2D, _write_checkpoint  # noqa: E402

# f32 on both sides: the same math in another summation order, relative to
# each output's largest value.
F32_REL = 1e-5
# The reference's architecture (its scripts/train.py:39-57), as the import
# CLI reads a config.json that names no attention_head_dim.
REFERENCE = {"sample_size": 256, "in_channels": 3, "out_channels": 3, "layers_per_block": 2,
             "block_out_channels": [64, 128, 256, 512], "norm_num_groups": 32,
             "down_block_types": ["DownBlock2D"] * 4, "up_block_types": ["UpBlock2D"] * 4}
BWD_COUNTS = ("attention_bwd_prep", "attention_bwd_main", "attention_bwd_dq", "attention_bwd_d8")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel=F32_REL):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(np.asarray(g) - w).max() <= rel * np.abs(w).max()


@pytest.mark.parametrize("seed,shape,scale", [
    (0, (1, 2, 128, 8), 1.0 / np.sqrt(8.0)),
    (1, (2, 3, 256, 8), 1.0 / np.sqrt(8.0)),
    (2, (1, 16, 128, 8), 0.6),
    (3, (3, 1, 384, 8), 0.2),
])
def test_d8_backward_chained_matches_vjp_of_library_reference(seed, shape, scale):
    """The training path's launches at head dim 8 through their plain
    versions, as the CPU runs them: attention_with_lse (o and lse), then
    attention_bwd, whose head-dim-8 launch attention_bwd_d8 has the plain
    version reference_attention_bwd, against jax.vjp of the library's
    plain attention (flash_attention.py:1482), in f32. No launch is counted
    on the CPU, and attention_bwd_d8 itself takes CUDA tensors only."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=shape).astype(np.float32) for _ in range(4))
    tq, tk, tv, tdo = (_t(a) for a in (q, k, v, do))
    ops.reset_launch_counts()
    o, lse = ops.attention_with_lse(tq, tk, tv, scale)
    got = ops.attention_bwd(tq, tk, tv, o, lse, tdo, scale)
    assert all(ops.launch_counts()[name] == 0 for name in BWD_COUNTS)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.attention_bwd_d8(tq, tk, tv, o, lse, tdo, scale)
    want_o, vjp = jax.vjp(
        lambda a, b, c: mha_reference_no_custom_vjp(a, b, c, None, sm_scale=scale),
        *map(jnp.asarray, (q, k, v)))
    _close([o.numpy()], [want_o])
    _close([g.numpy() for g in got], vjp(jnp.asarray(do)))


@pytest.mark.parametrize("shape", [(1, 4, 128, 8), (2, 64, 128, 8)])
def test_d8_lse_is_the_logsumexp_of_the_scaled_logits(shape):
    """attention_with_lse at head dim 8 on the CPU: the lse the head-dim-8
    forward kernel writes on the card (natural log, scale included)."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    _, lse = ops.attention_with_lse(_t(q), _t(k), _t(v), 0.3)
    logits = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k.astype(np.float64)) * 0.3
    top = logits.max(-1, keepdims=True)
    want = (top + np.log(np.exp(logits - top).sum(-1, keepdims=True)))[..., 0]
    assert lse.shape == shape[:3] and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)


def test_d8_function_passes_gradcheck_f64_on_qkv_views():
    """The autograd Function at head dim 8 on the CPU in float64, on q, k
    and v views of a fused qkv projection as the model hands them over."""
    gen = torch.Generator().manual_seed(6)
    B, H, S, D = 1, 2, 8, 8
    qkv = torch.randn(B, S, 3 * H * D, generator=gen, dtype=torch.float64, requires_grad=True)

    def fn(t):
        q, k, v = (x.view(B, S, H, D).transpose(1, 2) for x in t.split(H * D, dim=-1))
        assert q.stride() == (S * 3 * H * D, D, 3 * H * D, 1)
        return ops.attention(q, k, v, 1.0 / np.sqrt(D))

    assert torch.autograd.gradcheck(fn, (qkv,))


@pytest.mark.parametrize("hw", [(16, 16), (8, 16)], ids=["S256", "S128"])
def test_attention_block_at_head_dim_8_grads_match_jax(rng, hw):
    """C = 64 in 8 heads of 8: the port's AttentionBlock (the Function on
    the CPU) against jax.grad of the JAX block with impl="flash" (its xla
    branch off the TPU), the input and every parameter."""
    C, head_dim, groups = 64, 8, 8
    x = rng.normal(size=(2, *hw, C)).astype(np.float32)
    w = rng.normal(size=(2, *hw, C)).astype(np.float32)
    jblock = JaxAttentionBlock(head_dim=head_dim, groups=groups, dtype=jnp.float32, impl="flash")
    params = jblock.init(jax.random.key(8), jnp.asarray(x))["params"]
    loss_j = lambda p, xx: jnp.sum(jblock.apply({"params": p}, xx) * w)  # noqa: E731
    gp, gx = jax.grad(loss_j, argnums=(0, 1))(params, jnp.asarray(x))

    block = AttentionBlock(C, head_dim, groups, plain=False, device="cpu")
    assert block.num_heads == 8
    block.load_state_dict({
        "norm.weight": _t(params["norm"]["scale"]), "norm.bias": _t(params["norm"]["bias"]),
        "qkv.weight": _t(np.asarray(params["qkv"]["kernel"]).T),
        "qkv.bias": _t(params["qkv"]["bias"]),
        "proj_out.weight": _t(np.asarray(params["proj_out"]["kernel"]).T),
        "proj_out.bias": _t(params["proj_out"]["bias"]),
    })
    tx = _t(x).requires_grad_()
    (block(tx) * _t(w)).sum().backward()
    pairs = [(tx.grad, gx), (block.qkv.weight.grad.T, gp["qkv"]["kernel"]),
             (block.qkv.bias.grad, gp["qkv"]["bias"]),
             (block.proj_out.weight.grad.T, gp["proj_out"]["kernel"]),
             (block.proj_out.bias.grad, gp["proj_out"]["bias"]),
             (block.norm.weight.grad, gp["norm"]["scale"]),
             (block.norm.bias.grad, gp["norm"]["bias"])]
    for got, want in pairs:
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * max(np.abs(want).max(), 1.0)


def test_backward_limits_are_read_from_both_sources():
    """One backward source a head dim: 64 (flash_attention_bwd.cu, any S
    multiple) and 8 (flash_attention_bwd_d8.cu, whose whole head lives in
    shared memory: S up to its S_MAX line)."""
    names = ("flash_attention_bwd", "flash_attention_bwd_d8")
    assert all(name in build.SOURCES for name in names)
    assert backward_kernels() == {
        build.source_int(n, "D"): (n, build.source_int(n, "S_MULTIPLE"),
                                   build.source_int(n, "S_MAX", required=False)) for n in names}
    assert {d: n for d, (n, _, _) in backward_kernels().items()} == {64: names[0], 8: names[1]}
    assert backward_kernels()[64][2] is None and backward_kernels()[8][2] >= 1024
    assert "attention_bwd_d8" in ops.launch_counts()
    src = (build.CSRC_DIR / "flash_attention_bwd_d8.cu").read_text()
    assert 'extern "C" int dsg_flash_attention_bwd_d8(' in src
    with pytest.raises(RuntimeError, match="S_MAX"):
        build.source_int("flash_attention_bwd", "S_MAX")


@pytest.mark.parametrize("S,D", [(1024, 8), (128, 8), (2048, 8), (1024, 64), (4096, 64)])
def test_backward_limits_take_head_dims_8_and_64(S, D):
    assert attention_bwd_shape_error(S, D) is None


@pytest.mark.parametrize("S,D", [(1024, 4), (1024, 16), (1024, 32), (1000, 8), (64, 8),
                                 (4096, 8), (1000, 64)])
def test_backward_limits_refuse_other_shapes_naming_both_kernels(S, D):
    why = attention_bwd_shape_error(S, D)
    assert why is not None and why.endswith(f"got D={D}, S={S}")
    for d, (_, m, _) in backward_kernels().items():
        assert f"head_dim {d} with S % {m} == 0" in why
    assert f"and S <= {backward_kernels()[8][2]}" in why


def test_the_bwd_d8_source_states_its_sass():
    """chip_smoke.py requires these in the library's SASS: the two
    mma.sync shapes (S^T and dP^T at k8, dV, dK and dQ at k16), ldmatrix
    .trans for the k16 B operands, movmatrix for dS, and the exponential
    unit."""
    assert build.sass_must_hold("flash_attention_bwd_d8") == (
        "HMMA.1688.F32.BF16", "HMMA.16816.F32.BF16", "LDSM.16.MT88.4", "MOVM", "MUFU.EX2")


@pytest.fixture(scope="module")
def reference_cfg(tmp_path_factory):
    """The port's ModelConfig of the reference architecture, read by the
    importer from a config.json (an empty weights file beside it)."""
    d = tmp_path_factory.mktemp("reference") / "unet"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(REFERENCE))
    (d / "diffusion_pytorch_model.bin").write_bytes(b"")
    return import_diffusers.load_model_config(str(d))[0]


@pytest.mark.parametrize("model", [1, 2, 4])
def test_reference_training_arm_is_within_the_kernels_limits(reference_cfg, model):
    """DriveSceneGen's own model trains on the kernels at every tp the TP
    rules give it: 64, 32 or 16 heads of 8 over 1024 tokens a rank."""
    assert mid_attention_shape(reference_cfg, model) == (64 // model, 1024, 8)
    assert kernel_limit_errors(reference_cfg, for_training=True, model=model) == []


def test_head_dim_64_fragment_order_refuses_head_dim_8():
    """The head-dim-64 main pass's dQ fragment order (dq_to_fragment_order,
    the plain version's layout of its accumulator) is 64 columns wide: at
    head dim 8 it raises instead of reshaping wrongly. The head-dim-8
    launch has no such accumulator."""
    with pytest.raises(ValueError, match="head_dim 8"):
        ops.dq_to_fragment_order(torch.zeros(1, 2, 128, 8))


def test_train_cli_on_the_import_clis_config(tmp_path):
    """A tiny diffusers checkpoint at head dim 8 through the import CLI,
    then the train CLI on its config.yaml as it is (--cfg_file, default
    TrainConfig: batch 14), two steps on the CPU, and the generation CLI
    sampling the export."""
    torch.manual_seed(9)
    replica = TorchUNet2D(chans=(16, 32), layers=1, groups=4, head_dim=8).eval()
    src = _write_checkpoint(tmp_path, replica, chans=(16, 32), layers=1, groups=4, head_dim=8)
    model_dir = tmp_path / "imported"
    import_reference.main(["--src", src, "--dst", str(model_dir)])
    cfg = load_config(str(model_dir / "config.yaml"))
    assert cfg.model.attention_head_dim == 8 and cfg.model.torch_pad_downsample
    assert cfg.train.batch_size == 14
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    rng = np.random.default_rng(10)
    for i in range(16):
        Image.fromarray(rng.integers(0, 256, size=(16, 16, 3), dtype=np.uint8)).save(
            corpus / f"{i:03d}.png")
    out = tmp_path / "run"
    ops.reset_launch_counts()
    state = train.main(["--cfg_file", str(model_dir / "config.yaml"), "--dataset_glob",
                        str(corpus / "*.png"), "--output_dir", str(out), "--max_steps", "2",
                        "--device", "cpu"])
    assert state.step == 2 and set(ops.launch_counts().values()) == {0}
    assert (out / "params.npz").exists()
    records = [json.loads(line) for line in open(out / "logs" / "metrics.jsonl")]
    assert records and all(np.isfinite(r["loss"]) for r in records)
    gen_out = tmp_path / "gen"
    rate = generation.main(["--model_dir", str(out), "--output_dir", str(gen_out), "--device",
                            "cpu", "--sampler", "ddim", "--steps", "2", "--batch_size", "1",
                            "--num_batches", "1"])
    assert rate > 0 and os.listdir(gen_out) == ["loop_000_batch_000.png"]
