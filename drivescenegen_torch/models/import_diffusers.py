"""Import a reference (diffusers UNet2DModel) checkpoint into the flat flax
tree the port loads (port of drivescenegen_tpu/models/import_diffusers.py).

The reference trains a diffusers UNet2DModel and saves it with
save_pretrained (reference: scripts/train.py:39-57,
pipeline/training_pipeline.py:106-107): a directory holding config.json +
diffusion_pytorch_model.safetensors (or .bin). This module maps that state
dict onto the flat "/"-joined flax tree of models/convert.py, which
flax_to_torch loads into UNet2D and `<model_dir>/params.npz` stores, so the
published weights can be sampled on the card.

Conventions, as in the JAX package:
  - torch conv weight [O, I, kh, kw]  -> flax HWIO [kh, kw, I, O]
  - torch linear weight [O, I]        -> flax kernel [I, O]
  - GroupNorm weight/bias             -> {scale, bias}
  - separate to_q/to_k/to_v           -> the fused qkv Dense (concat on the
                                         output dim; supports the legacy
                                         query/key/value/proj_attn naming)
  - downsample padding: diffusers pads (1,1) per side where XLA SAME pads
    (0,1) at stride 2, so the imported ModelConfig sets
    torch_pad_downsample=True (params identical, geometry exact)
  - attention head partitioning: head count comes from the imported
    config.json's attention_head_dim (diffusers default 8), not this
    repo's default 64. The attention kernels, forward and backward, take
    head dim 64 and 8 (csrc/flash_attention_d8.cu,
    csrc/flash_attention_bwd_d8.cu), so the reference's own model, at its
    widths and bf16, samples and trains on CUDA with every kernel; a model outside
    the kernels' limits runs there only with plain=True
    (models/unet2d.py kernel_limit_errors).
  - GroupNorm eps stays the model's 1e-6 (models/unet2d.py).

No diffusers import is needed: the state dict is read with
safetensors.numpy (.safetensors) or torch.load (.bin).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np

from drivescenegen_torch.config import ModelConfig

WEIGHT_FILES = (
    "diffusion_pytorch_model.safetensors",
    "diffusion_pytorch_model.bin",
)


def _find_model_dir(src: str) -> str:
    """Accept either the unet dir itself or a pipeline dir holding unet/."""
    for d in (src, os.path.join(src, "unet")):
        if os.path.isfile(os.path.join(d, "config.json")) and any(
            os.path.isfile(os.path.join(d, w)) for w in WEIGHT_FILES
        ):
            return d
    raise FileNotFoundError(
        f"no diffusers UNet2DModel checkpoint under {src!r} "
        f"(need config.json + one of {WEIGHT_FILES})"
    )


def load_state_dict(src: str) -> Dict[str, np.ndarray]:
    d = _find_model_dir(src)
    st = os.path.join(d, WEIGHT_FILES[0])
    if os.path.isfile(st):
        try:
            from safetensors.numpy import load_file
        except ImportError as e:
            raise ImportError(
                f"{st} needs the safetensors package, which is not installed; save the "
                f"state dict as {WEIGHT_FILES[1]} (torch.save(model.state_dict(), ...)) "
                f"beside config.json instead") from e
        return {k: np.asarray(v) for k, v in load_file(st).items()}
    import torch

    raw = torch.load(os.path.join(d, WEIGHT_FILES[1]), map_location="cpu",
                     weights_only=True)
    return {k: v.detach().to(torch.float32).numpy() for k, v in raw.items()}


def load_model_config(src: str) -> Tuple[ModelConfig, dict]:
    """Build a ModelConfig from the diffusers config.json, rejecting
    architectures this UNet does not implement (only the reference's plain
    DownBlock2D/UpBlock2D + default attn mid block)."""
    d = _find_model_dir(src)
    with open(os.path.join(d, "config.json")) as f:
        dc = json.load(f)

    down = tuple(dc.get("down_block_types",
                        ("DownBlock2D",) * len(dc["block_out_channels"])))
    up = tuple(dc.get("up_block_types",
                      ("UpBlock2D",) * len(dc["block_out_channels"])))
    if set(down) != {"DownBlock2D"} or set(up) != {"UpBlock2D"}:
        raise ValueError(
            f"unsupported block types {down} / {up}: the importer covers the "
            "reference architecture (plain resnet blocks, attention only in "
            "the mid block — scripts/train.py:44-57)"
        )
    if not dc.get("flip_sin_to_cos", True) or dc.get("freq_shift", 0) != 0:
        raise ValueError(
            "time-embedding convention mismatch: this UNet implements "
            "flip_sin_to_cos=True, freq_shift=0 (the UNet2DModel defaults "
            "the reference uses)"
        )
    if dc.get("class_embed_type") or dc.get("num_class_embeds"):
        raise ValueError("class conditioning is not part of the reference model")

    ss = dc.get("sample_size", 256)
    if isinstance(ss, (list, tuple)):
        ss = ss[0]
    head_dim = dc.get("attention_head_dim", 8) or 8

    cfg = ModelConfig(
        sample_size=int(ss),
        in_channels=int(dc.get("in_channels", 3)),
        out_channels=int(dc.get("out_channels", 3)),
        layers_per_block=int(dc.get("layers_per_block", 2)),
        block_out_channels=tuple(int(c) for c in dc["block_out_channels"]),
        norm_num_groups=int(dc.get("norm_num_groups", 32)),
        attention_head_dim=int(head_dim),
        torch_pad_downsample=True,
    )
    return cfg, dc


def _t_conv(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0)).astype(np.float32)


def _t_lin(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (1, 0)).astype(np.float32)


def _f32(b: np.ndarray) -> np.ndarray:
    return np.asarray(b, dtype=np.float32)


def diffusers_to_flax(sd: Dict[str, np.ndarray], cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """Map the torch state dict onto the flat flax tree ("params/<module
    path>/<leaf>"). Every source key must be consumed — an unconsumed key
    means an architecture mismatch and raises rather than silently
    importing a half-mapped model."""
    sd = dict(sd)  # consumed destructively
    out: Dict[str, np.ndarray] = {}

    def take(key: str) -> np.ndarray:
        try:
            return sd.pop(key)
        except KeyError:
            raise KeyError(f"diffusers checkpoint is missing {key!r}") from None

    def conv(dst: str, src: str) -> None:
        out[f"params/{dst}/kernel"] = _t_conv(take(f"{src}.weight"))
        out[f"params/{dst}/bias"] = _f32(take(f"{src}.bias"))

    def dense(dst: str, src: str) -> None:
        out[f"params/{dst}/kernel"] = _t_lin(take(f"{src}.weight"))
        out[f"params/{dst}/bias"] = _f32(take(f"{src}.bias"))

    def norm(dst: str, src: str) -> None:
        out[f"params/{dst}/scale"] = _f32(take(f"{src}.weight"))
        out[f"params/{dst}/bias"] = _f32(take(f"{src}.bias"))

    def resnet(dst: str, src: str) -> None:
        norm(f"{dst}/norm1", f"{src}.norm1")
        conv(f"{dst}/conv1", f"{src}.conv1")
        dense(f"{dst}/time_proj", f"{src}.time_emb_proj")
        norm(f"{dst}/norm2", f"{src}.norm2")
        conv(f"{dst}/conv2", f"{src}.conv2")
        if f"{src}.conv_shortcut.weight" in sd:
            conv(f"{dst}/shortcut", f"{src}.conv_shortcut")

    def attention(dst: str, src: str) -> None:
        # Modern naming (diffusers >= 0.15 Attention) with a legacy
        # (AttentionBlock query/key/value/proj_attn) fallback.
        modern = f"{src}.to_q.weight" in sd
        qn, kn, vn, on = (("to_q", "to_k", "to_v", "to_out.0") if modern
                          else ("query", "key", "value", "proj_attn"))
        norm(f"{dst}/norm", f"{src}.group_norm")
        qw, kw, vw = (take(f"{src}.{n}.weight") for n in (qn, kn, vn))
        qb, kb, vb = (take(f"{src}.{n}.bias") for n in (qn, kn, vn))
        out[f"params/{dst}/qkv/kernel"] = np.concatenate(
            [_t_lin(qw), _t_lin(kw), _t_lin(vw)], axis=1)
        out[f"params/{dst}/qkv/bias"] = np.concatenate([_f32(qb), _f32(kb), _f32(vb)])
        dense(f"{dst}/proj_out", f"{src}.{on}")

    conv("conv_in", "conv_in")
    dense("time_mlp/dense1", "time_embedding.linear_1")
    dense("time_mlp/dense2", "time_embedding.linear_2")

    n_blocks = len(cfg.block_out_channels)
    for i in range(n_blocks):
        for j in range(cfg.layers_per_block):
            resnet(f"down_{i}_res_{j}", f"down_blocks.{i}.resnets.{j}")
        if i != n_blocks - 1:
            conv(f"down_{i}_downsample/conv", f"down_blocks.{i}.downsamplers.0.conv")

    resnet("mid_res_0", "mid_block.resnets.0")
    attention("mid_attn", "mid_block.attentions.0")
    resnet("mid_res_1", "mid_block.resnets.1")

    for i in range(n_blocks):
        for j in range(cfg.layers_per_block + 1):
            resnet(f"up_{i}_res_{j}", f"up_blocks.{i}.resnets.{j}")
        if i != n_blocks - 1:
            conv(f"up_{i}_upsample/conv", f"up_blocks.{i}.upsamplers.0.conv")

    norm("norm_out", "conv_norm_out")
    conv("conv_out", "conv_out")

    if sd:
        raise ValueError(
            f"{len(sd)} diffusers keys were not consumed by the mapping "
            f"(architecture drift?): {sorted(sd)[:8]} ..."
        )
    return out


def import_unet2d(src: str) -> Tuple[ModelConfig, Dict[str, np.ndarray]]:
    """One-call import: (ModelConfig, flat flax tree) from a diffusers dir.
    The tree is checked against UNet2D(cfg)'s parameters, names and shapes
    (models/convert.py flax_to_torch raises on any mismatch)."""
    from drivescenegen_torch.models.convert import flax_to_torch

    cfg, _ = load_model_config(src)
    flat = diffusers_to_flax(load_state_dict(src), cfg)
    flax_to_torch(flat, cfg)
    return cfg, flat
