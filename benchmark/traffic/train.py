"""Traffic kind "train": the train CLI's resident loop. A seeded uint8
corpus is made on the host and uploaded once by the port's
data.dataset.array_to_device; each step gathers its batch there by the
indices of data.dataset.index_batches and runs training.trainer's step
(UNet2D's training arm, AdamW, the global-norm clip), handed the
benchmark's noise and t. The window runs steps for --seconds and ends in a
synchronize: samples/s is over all of it. Every step is timed on the
device by CUDA events recorded between steps and read after the window.

Workload parameters: batch, corpus (rasters), checked_steps (3),
warmup_steps (steps after them, before the window), profiled_steps,
ref_block (rows the reference differentiates at once), limits.

The check follows the training object set-up built and drove: its first
checked_steps steps are the window's own call and feed, on rows that all
differ. The reference (benchmark/reference, float32) runs those steps
again from the same weights, rows, noise and t, and works out its own
rows from the order's seed. Compared, each against its limit:
- loss_rel_gap: the largest |loss - reference| / reference over the steps;
- grad_leaf_gap: over leaves, the largest gap between the norm of the first
  step's clipped gradient as AdamW holds it (exp_avg / (1 - b1) after one
  step) and the reference's, over the larger of the reference leaf's norm
  and the median leaf's;
- update_leaf_gap: the same for the norm of each leaf's change over the
  checked steps, over the elements whose first reference gradient is at
  least a thousandth of the median leaf's root-mean-square gradient: the
  others (a key's bias under softmax, a third of the fused qkv bias) have
  a gradient of round-off alone, which AdamW scales up to full steps.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import counts, inputs
from benchmark.harness import Spans
from benchmark.reference import diffusion as ref_diffusion
from benchmark.reference.unet import ReferenceUNet, plain_float32
from drivescenegen_torch.config import DiffusionConfig, ModelConfig, TrainConfig
from drivescenegen_torch.data.dataset import array_to_device, index_batches
from drivescenegen_torch.diffusion import make_schedule
from drivescenegen_torch.models import UNet2D
from drivescenegen_torch.models.convert import flax_path
from drivescenegen_torch.training import create_optimizer, init_train_state, make_train_step

NEGLIGIBLE_GRAD = 1e-3  # of the median leaf's root-mean-square reference gradient


class StepClock:
    """Marks between steps: CUDA events on the card (read after the
    window, so no step waits for them), the host clock elsewhere."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List = []

    def mark(self) -> None:
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self) -> List[float]:
        pairs = zip(self.marks, self.marks[1:])
        if self.cuda:
            return [a.elapsed_time(b) for a, b in pairs]
        return [(b - a) * 1e3 for a, b in pairs]


def as_flat_tree(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Port state-dict tensors as the flat tree's leaves (keys, layouts)."""
    out = {}
    for name, t in tensors.items():
        path, perm = flax_path(name, t.dim())
        out[path] = t.float().permute(perm)
    return out


def worst_leaf_gap(mine: Dict[str, float], ref: Dict[str, float]) -> float:
    """max over leaves of |mine - ref| / max(ref, median ref)."""
    med = float(np.median(list(ref.values())))
    return max(abs(mine[k] - r) / max(r, med, 1e-30) for k, r in ref.items())


class Cell:
    def __init__(self, cell: dict, config: dict, seed: int, device: str):
        self.p, self.limits = cell["params"], cell["limits"]
        self.mcfg, self.tcfg = config["model"], config["train"]
        self.seed, self.device = seed, torch.device(device)
        S = self.mcfg["sample_size"]
        self.B = self.p["batch"]
        self.sample_shape = (S, S, self.mcfg["in_channels"])
        self.spans = Spans()
        self.attempted = self.failed = 0
        self.step_i = 0

    # -- the program -------------------------------------------------------

    def make_inputs(self) -> None:
        """What set-up draws before the program is built: the corpus and
        the weights."""
        S, C = self.sample_shape[0], self.sample_shape[-1]
        self.corpus = inputs.corpus(self.seed, self.p["corpus"], S, C)
        self.weights = inputs.make_weights(self.mcfg, self.seed, self.device)

    def setup(self) -> None:
        self.make_inputs()
        self.data = array_to_device(self.corpus, self.device)
        tcfg = TrainConfig(**self.tcfg)
        model = UNet2D(ModelConfig(**self.mcfg), device=self.device, for_training=True)
        self.handed = inputs.port_state_dict(model, self.weights)
        model.load_state_dict(self.handed)
        total = (self.p["corpus"] // self.B) * tcfg.num_epochs
        optimizer, lr = create_optimizer(tcfg, total, model.parameters())
        self.state = init_train_state(model, optimizer, ema=tcfg.ema_decay > 0.0)
        self.step_fn = make_train_step(make_schedule(DiffusionConfig(), device=self.device), lr,
                                       tcfg)
        self.order = index_batches(self.p["corpus"], self.B, seed=inputs.order_seed(self.seed))
        self.b1 = tcfg.adam_b1
        self._checked_steps()
        for _ in range(self.p["warmup_steps"]):
            self._step()

    def _step(self):
        """One step, as the train CLI's resident loop runs it: the batch's
        noise, t and rows ("inputs"), then the step ("train_step")."""
        with self.spans("inputs"):
            noise, t = inputs.step_noise(self.seed, self.step_i, self.B, self.sample_shape,
                                         self.device)
            batch = self.data[torch.from_numpy(next(self.order)).to(self.device)]
        with self.spans("train_step"):
            self.state, metrics = self.step_fn(self.state, batch, noise=noise, t=t)
        self.step_i += 1
        return metrics

    def _checked_steps(self) -> None:
        """The first steps, through the window's own call and feed, and what
        the check reads of them: each loss, the first clipped gradient's
        norms by leaf from AdamW's state, each leaf's change."""
        model, opt = self.state.model, self.state.optimizer
        losses = []
        for i in range(self.p["checked_steps"]):
            losses.append(self._step()["loss"])
            if i == 0:
                # A step that left AdamW no state handed it no gradient.
                grads = {n: opt.state[p].get("exp_avg", torch.zeros_like(p)) / (1 - self.b1)
                         for n, p in model.named_parameters()}
                self.grad_norms = {k: float(g.norm()) for k, g in as_flat_tree(grads).items()}
                del grads
        self.losses = [float(x) for x in losses]
        self.change = as_flat_tree({n: p.detach() - self.handed[n]
                                  for n, p in model.named_parameters()})
        del self.handed

    def window(self, seconds: float, host_spans: bool) -> dict:
        clock = StepClock(self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        clock.mark()
        steps = 0
        while True:
            self._step()
            clock.mark()
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        self.attempted = steps
        step_ms = clock.step_ms()
        return {"train_samples_per_s": steps * self.B / wall,
                "train_step_ms_p95": float(np.percentile(step_ms, 95)), "wall_s": wall,
                "steps": steps, "forward_flops": counts.unet2d_forward_flops(self.mcfg, self.B)}

    def profiled(self) -> dict:
        """The traced part: profiled_steps more steps."""
        n = self.p["profiled_steps"]
        for _ in range(n):
            self._step()
        self.attempted += n
        return {"steps": n, "batch": self.B}

    def release(self) -> None:
        del self.state, self.step_fn, self.data
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------

    def reference_steps(self, precision: str = "f32") -> dict:
        """The reference's losses, first clipped gradients (and their norms)
        and changes by leaf over the checked steps, from the benchmark's
        inputs alone."""
        with plain_float32():
            return self._reference_steps(precision)

    def _reference_steps(self, precision: str) -> dict:
        tcfg = self.tcfg
        params = {k: v.detach().clone().requires_grad_(True) for k, v in self.weights.items()}
        model = ReferenceUNet(self.mcfg, params, precision)
        adam = ref_diffusion.AdamW(params, tcfg["adam_b1"], tcfg["adam_b2"], tcfg["adam_eps"],
                                   tcfg["weight_decay"])
        order = np.random.default_rng(inputs.order_seed(self.seed)).permutation(self.p["corpus"])
        losses, first = [], None
        for step in range(self.p["checked_steps"]):
            rows = order[step * self.B:(step + 1) * self.B]
            x0 = torch.from_numpy(self.corpus[rows]).to(self.device).float() / 127.5 - 1.0
            noise, t = inputs.step_noise(self.seed, step, self.B, self.sample_shape, self.device)
            loss = 0.0
            for i in range(0, self.B, self.p["ref_block"]):
                blk = slice(i, i + self.p["ref_block"])
                part = ref_diffusion.diffusion_loss(model, x0[blk], noise[blk], t[blk], self.B)
                part.backward()
                loss += float(part.detach())
            grads = {k: p.grad for k, p in params.items()}
            ref_diffusion.clip_by_global_norm(grads, tcfg["grad_clip_norm"])
            if step == 0:
                first = {k: g.detach().clone() for k, g in grads.items()}
            adam.step(grads, ref_diffusion.warmup_lr(step, tcfg["learning_rate"],
                                                     tcfg["lr_warmup_steps"]))
            for p in params.values():
                p.grad = None
            losses.append(loss)
        return {"losses": losses, "grads": first,
                "grad_norms": {k: float(g.norm()) for k, g in first.items()},
                "change": {k: p.detach() - self.weights[k] for k, p in params.items()}}

    def compare(self, mine: dict, ref: dict) -> dict:
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(mine["losses"], ref["losses"]))
        rms = float(np.median([float(g.norm()) / g.numel() ** 0.5
                               for g in ref["grads"].values()]))
        mine_moved, ref_moved = {}, {}
        for k, g in ref["grads"].items():
            keep = g.abs() >= NEGLIGIBLE_GRAD * rms
            if keep.any():
                mine_moved[k] = float(mine["change"][k][keep].norm())
                ref_moved[k] = float(ref["change"][k][keep].norm())
        return {
            "loss_rel_gap": {"value": loss_gap, "limit": self.limits["loss_rel_gap"]},
            "grad_leaf_gap": {"value": worst_leaf_gap(mine["grad_norms"], ref["grad_norms"]),
                              "limit": self.limits["grad_leaf_gap"]},
            "update_leaf_gap": {"value": worst_leaf_gap(mine_moved, ref_moved),
                                "limit": self.limits["update_leaf_gap"]},
        }

    def check(self) -> dict:
        mine = {"losses": self.losses, "grad_norms": self.grad_norms, "change": self.change}
        return self.compare(mine, self.reference_steps())

    def control_check(self) -> dict:
        """The control in the program's place: the reference with its
        products in fp8, over the same checked steps."""
        self.make_inputs()
        return self.compare(self.reference_steps("fp8"), self.reference_steps())
