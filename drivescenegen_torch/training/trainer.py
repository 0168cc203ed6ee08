"""Training step for the DDPM UNet (port of
drivescenegen_tpu/training/trainer.py:36-156).

Per step, as the JAX step: noise ~ N(0, I), t ~ U[0, T), x_t =
add_noise(x0, noise, t); loss = MSE(model(x_t, t, cond), noise) in f32;
gradients clipped to a global norm; AdamW with a linear-warmup cosine
learning rate; optionally an EMA of the parameters with a decay warmup.
A conditional model (cond_channels > 0) splits each batch by channel, the
conditioning first (map R/G) and the diffusion target after (agent B), and
zeroes the conditioning of a sample with probability cond_dropout, which
trains the null branch of classifier-free guidance (diffusion/cfg.py).

optax is matched operation for operation, not just nearly:
- `clip_by_global_norm` scales by max/norm only when norm >= max, with no
  epsilon (torch's clip_grad_norm_ adds 1e-6), as (g / norm) * max;
- `adamw` is scale_by_adam, add_decayed_weights, scale_by_learning_rate:
  the same update as torch.optim.AdamW's decoupled weight decay;
- `warmup_cosine_decay_schedule(0, peak, warmup, decay_steps, 0)` in f32,
  evaluated at the step count before the update, so the first step's lr
  is 0; decay_steps includes the warmup;
- the EMA decay is min(d, (1 + s) / (10 + s)) with s = step + 1.

The model is a UNet2D(for_training=True): bf16 activations over f32
parameters, the attention's forward and backward kernels on the card.
With cfg.dropout > 0 its ResnetBlocks drop activations between norm2 and
conv2 (models/unet2d.py DropoutMasks).

Data parallel (parallel/mesh.py): each rank steps on its rows of the
global batch. Every rank draws the global noise, t, keep mask and dropout
masks from the step's generator and takes its rows, so a W-rank step
computes what the one-process step computes, up to the order of
reduction. The gradients are averaged over the data axis by one coalesced
all_reduce (all_reduce_mean_, not DDP: the model stays unwrapped, so its
state-dict names are the flax tree's) before the global-norm clip; the
optimizer and EMA then make the same update on every rank.

Tensor parallel (a model axis over 1: the model was built on the mesh,
models/unet2d.py): a sharded parameter's gradient is this rank's shard,
and a replicated one's is whole and the same on every rank of the model
group (copy_to_model summed what its column-parallel consumers sent
back). Both are averaged over the data group only; the global norm sums
the squares of the shards over the model group and counts the replicated
gradients once, so the clip scales by the whole model's norm, as optax's
does under GSPMD. AdamW and the EMA stay local and elementwise, on shards.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from drivescenegen_torch.config import TrainConfig
from drivescenegen_torch.diffusion.cfg import apply_cond_dropout
from drivescenegen_torch.diffusion.schedule import DiffusionSchedule
from drivescenegen_torch.models.unet2d import DropoutMasks, UNet2D
from drivescenegen_torch.parallel.mesh import Mesh, all_reduce_mean_
from drivescenegen_torch.utils import prng, profiling


@dataclass
class TrainState:
    model: UNet2D
    optimizer: torch.optim.Optimizer
    step: int = 0
    # EMA of the parameters by state-dict name (None when disabled).
    ema_params: Optional[Dict[str, torch.Tensor]] = None


def lr_schedule_fn(cfg: TrainConfig, total_steps: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(init_value=0, peak_value=lr,
    warmup_steps, decay_steps=max(total_steps, warmup + 1), end_value=0),
    in f32 as optax computes it."""
    f32 = np.float32
    peak, warmup = f32(cfg.learning_rate), cfg.lr_warmup_steps
    decay = max(total_steps, warmup + 1) - warmup

    def lr(count: int) -> float:
        if count < warmup:
            frac = f32(1) - f32(min(max(count, 0), warmup)) / f32(warmup)
            return float((f32(0) - peak) * frac + peak)
        c = f32(min(count - warmup, decay))
        return float(peak * (f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay)))))

    return lr


def create_optimizer(cfg: TrainConfig, total_steps: int, params
                     ) -> Tuple[torch.optim.Optimizer, Callable[[int], float]]:
    """AdamW over `params` and its learning-rate schedule; the train step
    sets the lr of the step before each update."""
    opt = torch.optim.AdamW(params, lr=0.0, betas=(cfg.adam_b1, cfg.adam_b2), eps=cfg.adam_eps,
                            weight_decay=cfg.weight_decay)
    return opt, lr_schedule_fn(cfg, total_steps)


def init_train_state(model: UNet2D, optimizer: torch.optim.Optimizer, ema: bool = False
                     ) -> TrainState:
    ema_params = None
    if ema:
        ema_params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return TrainState(model=model, optimizer=optimizer, step=0, ema_params=ema_params)


def global_norm(tensors: List[torch.Tensor], sharded: Optional[List[bool]] = None,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm).
    Under tensor parallelism the tensors flagged in `sharded` are this
    rank's shards: their squares are summed over the mesh's model group,
    the others' counted once."""
    norms = torch.stack(torch._foreach_norm(tensors))
    if sharded is None or not any(sharded):
        return torch.linalg.vector_norm(norms)
    mask = torch.tensor(sharded, device=norms.device)
    sq = norms.square()
    shard_sq = sq[mask].sum()
    torch.distributed.all_reduce(shard_sq, group=mesh.model_group)
    return torch.sqrt(shard_sq + sq[~mask].sum())


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float, norm: torch.Tensor) -> None:
    """optax.clip_by_global_norm in place: g unchanged when norm < max,
    else (g / norm) * max. No host sync: both factors are 1 when the norm
    is under the max."""
    keep = norm < max_norm
    one = torch.ones((), device=norm.device, dtype=norm.dtype)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))


def normalize_batch(batch: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> f32 [-1, 1] as x / 127.5 - 1 (exact for 8-bit
    sources); other batches are taken as already normalized."""
    if batch.dtype == torch.uint8:
        return batch.float() / 127.5 - 1.0
    return batch.float()


def diffusion_loss(model: UNet2D, schedule: DiffusionSchedule, target: torch.Tensor,
                   noise: torch.Tensor, t: torch.Tensor,
                   cond: Optional[torch.Tensor] = None,
                   dropout: Optional[DropoutMasks] = None) -> torch.Tensor:
    """MSE between the model's eps at x_t = add_noise(target, noise, t)
    (conditioned on `cond`, if given; its ResnetBlocks masked by `dropout`,
    if given) and the noise, in f32."""
    eps_hat = model(schedule.add_noise(target, noise, t), t, cond, dropout=dropout)
    return torch.mean((eps_hat.float() - noise) ** 2)


def make_train_step(schedule: DiffusionSchedule, lr_schedule: Callable[[int], float],
                    cfg: TrainConfig, mesh: Optional[Mesh] = None) -> Callable:
    """Returns step(state, batch, noise=None, t=None, keep=None,
    dropout_masks=None) -> (state, metrics).

    `batch` is this rank's rows of the global batch (all of it without a
    mesh): [B, H, W, C] uint8 (normalized on the device) or float in
    [-1, 1]; for a conditional model C = cond_channels + in_channels, the
    conditioning first. The step's generator (utils/prng.py: the run's
    "train" seed folded with the step) draws, at the global batch, the
    noise, t, the cond-dropout mask `keep` ([B] bool) and then, during the
    forward, the dropout masks, in that order, and the rank takes its rows
    of each. What the caller hands in (this rank's rows, e.g. the JAX
    step's own draws in the tests; `dropout_masks` a list, one per
    ResnetBlock) is used instead; when anything is missing, noise and t
    are both drawn and a given one is kept, so that every later draw keeps
    its place in the stream. The state is updated in place; metrics are
    loss (averaged over the data axis), grad_norm (before clipping; both
    device tensors, read without a host sync) and lr. While a profiler
    records, the step opens the spans train.step and, inside it,
    train.forward, train.backward and train.update (utils/profiling.py)."""
    train_seed = prng.purpose_seed(cfg.seed, "train")
    ema_decay = np.float32(cfg.ema_decay)

    def train_step(state: TrainState, batch: torch.Tensor, noise=None, t=None, keep=None,
                   dropout_masks=None):
        with profiling.annotate("train.step"):
            return step(state, batch, noise, t, keep, dropout_masks)

    def step(state: TrainState, batch: torch.Tensor, noise, t, keep, dropout_masks):
        model, opt = state.model, state.optimizer
        mcfg = model.cfg
        device = schedule.device
        batch = normalize_batch(batch.to(device))
        cond_ch = mcfg.cond_channels
        if batch.shape[-1] != cond_ch + mcfg.in_channels:
            raise ValueError(f"batch has {batch.shape[-1]} channels; the model takes "
                             f"cond_channels + in_channels = {cond_ch + mcfg.in_channels}")
        cond, target = (batch[..., :cond_ch], batch[..., cond_ch:]) if cond_ch else (None, batch)
        B = target.shape[0]
        world = mesh.shape["data"] if mesh is not None else 1
        rows = mesh.rows(B * world) if mesh is not None else slice(None)
        drop = cond is not None and cfg.cond_dropout > 0.0
        use_dropout = mcfg.dropout > 0.0
        gen = None
        if noise is None or t is None or (drop and keep is None) or (
                use_dropout and dropout_masks is None):
            gen = prng.for_step(train_seed, state.step, device)
            # noise and t are drawn even when given, so that each draw keeps
            # its place in the stream whatever the caller hands in.
            noise_d = torch.randn((B * world,) + tuple(target.shape[1:]), generator=gen,
                                  device=device)[rows]
            t_d = torch.randint(0, schedule.num_train_timesteps, (B * world,), generator=gen,
                                device=device)[rows]
            noise = noise_d if noise is None else noise
            t = t_d if t is None else t
            if drop and keep is None:
                keep = (torch.rand(B * world, generator=gen, device=device)
                        < 1.0 - cfg.cond_dropout)[rows]
        noise = noise.to(device=device, dtype=torch.float32)
        t = t.to(device=device, dtype=torch.int64)
        if cond is not None:
            cond = apply_cond_dropout(cond, cfg.cond_dropout, None, keep)
        dropout = None
        if use_dropout:
            dropout = (DropoutMasks(mcfg.dropout, masks=dropout_masks) if dropout_masks is not None
                       else DropoutMasks(mcfg.dropout, gen, batch=B * world, rows=rows))

        opt.zero_grad(set_to_none=True)
        with profiling.annotate("train.forward"):
            loss = diffusion_loss(model, schedule, target, noise, t, cond, dropout)
        with profiling.annotate("train.backward"):
            loss.backward()
        with profiling.annotate("train.update"):
            params = [p for group in opt.param_groups for p in group["params"]]
            grads = [p.grad for p in params]
            loss = loss.detach()
            all_reduce_mean_(grads + [loss.reshape(1)], mesh)
            sharded_ids = {id(p) for n, p in model.named_parameters() if n in model.tp_plan}
            norm = global_norm(grads, [id(p) in sharded_ids for p in params], mesh)
            clip_by_global_norm_(grads, cfg.grad_clip_norm, norm)
            lr = lr_schedule(state.step)
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
            if ema_decay > 0 and state.ema_params is not None:
                s = np.float32(state.step) + np.float32(1)
                decay = min(ema_decay, (np.float32(1) + s) / (np.float32(10) + s))
                ema = list(state.ema_params.values())
                named = dict(model.named_parameters())
                torch._foreach_mul_(ema, float(decay))
                torch._foreach_add_(ema, [named[n].detach() for n in state.ema_params],
                                    alpha=float(np.float32(1) - decay))
        state.step += 1
        return state, {"loss": loss, "grad_norm": norm, "lr": lr}

    return train_step
