"""The port's diffusers import (models/import_diffusers.py and
scripts/import_reference.py) against the JAX package's, with no download:
tests/test_import_diffusers.py's pure-torch replica of the reference
UNet2DModel writes a random checkpoint under diffusers' names, as .bin or
as .safetensors."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from drivescenegen_tpu.config import ModelConfig as JaxModelConfig
from drivescenegen_tpu.models import import_diffusers as jax_import
from drivescenegen_torch.config import ModelConfig, load_config
from drivescenegen_torch.models import UNet2D, import_diffusers
from drivescenegen_torch.models.convert import flax_to_torch, load_npz
from drivescenegen_torch.scripts import import_reference

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_import_diffusers import TorchUNet2D, _write_checkpoint  # noqa: E402


@pytest.fixture(scope="module")
def replica():
    torch.manual_seed(0)
    return TorchUNet2D().eval()


@pytest.fixture(scope="module", params=["bin", "safetensors"])
def checkpoint(request, replica, tmp_path_factory):
    """The replica's checkpoint as .bin, or the same tensors as
    .safetensors beside the same config.json."""
    src = _write_checkpoint(tmp_path_factory.mktemp("ckpt"), replica)
    if request.param == "safetensors":
        from safetensors.numpy import save_file

        d = Path(src)
        save_file({k: v.numpy() for k, v in replica.state_dict().items()},
                  str(d / "diffusion_pytorch_model.safetensors"))
        (d / "diffusion_pytorch_model.bin").unlink()
    return src


def test_flat_tree_equals_jax(checkpoint):
    cfg, flat = import_diffusers.import_unet2d(checkpoint)
    jcfg, jparams = jax_import.import_unet2d(checkpoint)
    want = {k: np.asarray(v) for k, v in flatten_dict(jparams, sep="/").items()}
    assert sorted(flat) == sorted(want)
    for k in want:
        assert flat[k].dtype == want[k].dtype and np.array_equal(flat[k], want[k]), k
    assert "params/mid_attn/qkv/kernel" in flat  # to_q/k/v fused
    assert {f: getattr(cfg, f) for f in cfg.__dataclass_fields__} == \
        {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}
    assert cfg.torch_pad_downsample and cfg.attention_head_dim == 4


def test_forward_matches_the_torch_replica(replica, checkpoint):
    cfg, flat = import_diffusers.import_unet2d(checkpoint)
    cfg.dtype = "float32"  # fp32 activations for a tight parity bound
    model = UNet2D(cfg, device="cpu")
    model.load_state_dict(flax_to_torch(flat, cfg))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    t = np.array([7, 383])
    with torch.no_grad():
        ref = replica(torch.from_numpy(x).permute(0, 3, 1, 2),
                      torch.from_numpy(t)).permute(0, 2, 3, 1).numpy()
        got = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert np.abs(got - ref).max() < 2e-3


@pytest.mark.parametrize("patch,match", [
    ({"down_block_types": ["AttnDownBlock2D", "DownBlock2D"]}, "unsupported block types"),
    ({"freq_shift": 1}, "time-embedding convention"),
    ({"num_class_embeds": 4}, "class conditioning"),
])
def test_config_rejections_match_jax(tmp_path, patch, match):
    d = tmp_path / "unet"
    d.mkdir()
    cfgj = {"block_out_channels": [8, 16], "down_block_types": ["DownBlock2D"] * 2,
            "up_block_types": ["UpBlock2D"] * 2, **patch}
    (d / "config.json").write_text(json.dumps(cfgj))
    (d / "diffusion_pytorch_model.bin").write_bytes(b"")
    for mod in (import_diffusers, jax_import):
        with pytest.raises(ValueError, match=match):
            mod.load_model_config(str(d))


def test_default_head_dim_is_eight(tmp_path):
    d = tmp_path / "unet"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({"block_out_channels": [8, 16]}))
    (d / "diffusion_pytorch_model.bin").write_bytes(b"")
    cfg, _ = import_diffusers.load_model_config(str(tmp_path))  # a pipeline dir holding unet/
    jcfg, _ = jax_import.load_model_config(str(tmp_path))
    assert cfg.attention_head_dim == jcfg.attention_head_dim == 8
    assert cfg.norm_num_groups == 32 and cfg.torch_pad_downsample


def test_unconsumed_keys_raise(replica):
    sd = {k: v.numpy() for k, v in replica.state_dict().items()}
    sd["mystery.weight"] = np.zeros((3, 3), np.float32)
    kw = dict(sample_size=16, block_out_channels=(8, 16), layers_per_block=2,
              norm_num_groups=4, attention_head_dim=4)
    with pytest.raises(ValueError, match="not consumed"):
        import_diffusers.diffusers_to_flax(sd, ModelConfig(**kw))
    with pytest.raises(ValueError, match="not consumed"):
        jax_import.diffusers_to_flax(sd, JaxModelConfig(**kw))


def test_missing_safetensors_names_the_bin_route(tmp_path, monkeypatch):
    d = tmp_path / "unet"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({"block_out_channels": [8, 16]}))
    (d / "diffusion_pytorch_model.safetensors").write_bytes(b"")
    monkeypatch.setitem(sys.modules, "safetensors.numpy", None)  # import fails
    with pytest.raises(ImportError, match="diffusion_pytorch_model.bin"):
        import_diffusers.load_state_dict(str(d))


@pytest.mark.parametrize("case", ["head_dim_4", "no_head_dim", "within_limits",
                                  "reference_widths"])
def test_cli_writes_a_model_dir_and_names_plain(replica, tmp_path, capsys, monkeypatch, case):
    """The CLI writes config.yaml and params.npz equal to the import and
    prints the parameter count; its closing line adds --plain exactly when
    kernel_limit_errors names a breach: at head dim 4, outside both
    attention kernels (D = 64 and 8), and at the default of 8 (no
    attention_head_dim in config.json), where these narrow widths break
    the conv's limits and the 16x16 sample leaves the attention 64 tokens,
    not a multiple of 128; not when the limits hold, stubbed at these
    widths and real at the reference's own widths (64/128/256/512, 256x256)
    and head dim 8."""
    if case == "reference_widths":
        torch.manual_seed(1)
        replica = TorchUNet2D(chans=(64, 128, 256, 512), layers=2, groups=32, head_dim=8).eval()
        src = _write_checkpoint(tmp_path, replica, chans=(64, 128, 256, 512), layers=2,
                                groups=32, head_dim=8, sample=256)
    else:
        src = _write_checkpoint(tmp_path, replica, head_dim=4)
    if case in ("no_head_dim", "reference_widths"):
        cfgj = json.loads(Path(src, "config.json").read_text())
        del cfgj["attention_head_dim"]
        Path(src, "config.json").write_text(json.dumps(cfgj))
    if case == "within_limits":
        monkeypatch.setattr("drivescenegen_torch.models.unet2d.kernel_limit_errors",
                            lambda cfg: [])
    dst = tmp_path / "imported"
    import_reference.main(["--src", src, "--dst", str(dst)])
    out = capsys.readouterr().out
    cfg = load_config(str(dst / "config.yaml"))
    want_cfg, want = import_diffusers.import_unet2d(src)
    assert cfg.model == want_cfg
    assert want_cfg.attention_head_dim == (4 if case in ("head_dim_4", "within_limits") else 8)
    got = load_npz(str(dst / "params.npz"))
    assert sorted(got) == sorted(want) and all(np.array_equal(got[k], want[k]) for k in want)
    n = sum(v.size for v in want.values())
    assert f"imported {n:,} parameters" in out
    last = out.strip().splitlines()[-1]
    assert last.startswith("sample with: python -m drivescenegen_torch.scripts.generation "
                           f"--model_dir {dst}")
    if case in ("within_limits", "reference_widths"):
        assert not last.endswith("--plain") and "outside the CUDA kernels' limits" not in out
    else:
        assert last.endswith(" --plain")
        assert "outside the CUDA kernels' limits: silu_conv3x3: " in out
        assert "attention: the kernels take head_dim 64 with S % 128 == 0 or head_dim 8" in out
        assert f"got D={want_cfg.attention_head_dim}, S=64" in out
