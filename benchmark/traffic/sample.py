"""Traffic kind "sample": a closed loop of sampling batches, as the
generation CLI runs them. Each batch draws its x_T (and, for a conditional
configuration, its cond rasters), runs the port's DDIM sampler over
UNet2D's sampling arm (under classifier-free guidance when the workload
gives a guidance scale), and delivers the scenes as uint8 host arrays
through the CLI's quantize. The window closes at the end of the first
batch that finishes after --seconds; scenes/s is over all of that time.

Workload parameters: sampler ("ddim"), steps, eta (0), spacing
("leading"), batch, guidance (null: unconditional), check_scenes (scenes
the reference samples again), profiled_batches (batches in the traced
part), metric (the end-to-end metric the rate is reported as, by default
scenes_per_s); and limits (each compared number's limit).

The check: once the program is freed, the reference runs the whole DDIM
chain again in float32 (benchmark/reference) from the same x_T and cond for
`check_scenes` scenes drawn from the seed among all the window delivered,
one row position after another, and quantizes them. Compared:
scene_mean_abs_levels, the mean |program - reference| in uint8 levels over
those scenes' sampled channels; for a conditional cell cond_levels_changed,
the cond channels' pixels that differ (exactly 0). With seeded random
weights the mid-block attention adds little to a scene, so a wrong
attention kernel would pass that; the window therefore taps the attention
branch (the output of the model's mid_attn.proj_out, before the residual
add) of the first forward of batch 0 and of one more of its first
TAP_FIRST batches drawn from the seed, which runs on x_T, a raw input. The
reference computes that forward on the same x_T (and cond) at the first
timestep, and attention_rel_gap is the worst tapped batch's
||program - reference|| / ||reference|| over all of the forward's rows. A
forward that no hook sees (a captured CUDA graph's replay) taps nothing,
and the number is then left out.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import counts, inputs
from benchmark.harness import Spans
from benchmark.reference import diffusion as ref_diffusion
from benchmark.reference.unet import ReferenceUNet, plain_float32
from drivescenegen_torch.config import DiffusionConfig, ModelConfig
from drivescenegen_torch.diffusion import ddim_sample, make_guided_denoise, make_schedule
from drivescenegen_torch.models import UNet2D
from drivescenegen_torch.scripts.generation import quantize

REF_BLOCK = 4  # rows the reference runs at once
TAP_FIRST = 8  # the second tapped batch is drawn from the window's first batches


class Cell:
    def __init__(self, cell: dict, config: dict, seed: int, device: str):
        self.p = cell["params"]
        if self.p["sampler"] != "ddim":
            raise ValueError(f"traffic kind sample runs DDIM, not {self.p['sampler']!r}")
        self.limits = cell["limits"]
        self.mcfg = config["model"]
        self.seed, self.device = seed, torch.device(device)
        B, S = self.p["batch"], self.mcfg["sample_size"]
        self.shape = (B, S, S, self.mcfg["out_channels"])
        self.cond_shape = (B, S, S, self.mcfg.get("cond_channels", 0))
        self.guidance = self.p.get("guidance")
        self.rows = B * (1 if self.guidance is None else 2)  # of each forward
        self.outs: List[np.ndarray] = []  # outs[b]: batch b's scenes
        self.taps: Dict[int, torch.Tensor] = {}  # batch -> its first forward's attention branch
        self._tap_next: Optional[int] = None
        self._tapping = False
        self.spans = Spans()
        self.attempted = self.failed = 0

    # -- the program -------------------------------------------------------

    def make_inputs(self) -> None:
        """What set-up draws before the program is built: the weights."""
        self.weights = inputs.make_weights(self.mcfg, self.seed, self.device)

    def setup(self) -> None:
        self.make_inputs()
        self.model = UNet2D(ModelConfig(**self.mcfg), device=self.device).eval()
        self.model.load_state_dict(inputs.port_state_dict(self.model, self.weights))
        self.schedule = make_schedule(DiffusionConfig(), device=self.device)
        self._batch(-1)  # every shape the window uses, once
        self.outs.clear()
        self.model.mid_attn.proj_out.register_forward_hook(self._tap)

    def tap_batches(self) -> List[int]:
        rng = np.random.default_rng(inputs.sub_seed(self.seed, "attention"))
        return [0, int(rng.integers(1, TAP_FIRST))]

    def _tap(self, module, args, out) -> None:
        """proj_out's forward hook: keeps the output of a tapped batch's first
        forward (none taken while a CUDA graph is being captured)."""
        if self._tap_next is None:
            return
        if not (out.is_cuda and torch.cuda.is_current_stream_capturing()):
            self.taps[self._tap_next] = out.detach().clone()
        self._tap_next = None

    def _batch(self, batch: int, wrap=None) -> None:
        """One batch, as the generation CLI runs it: its draws ("inputs"),
        the sampler over the model ("sampler"), the scenes to the host
        ("quantize")."""
        spans = self.spans
        with torch.no_grad():
            with spans("inputs"):
                g = inputs.generator(self.seed, "x_T", batch, self.device)
                x_T = torch.randn(self.shape, generator=g, device=self.device)
                denoise, cond = self.model, None
                if self.guidance is not None:
                    cond = inputs.cond_rasters(self.seed, batch, self.cond_shape, self.device)
                    denoise = make_guided_denoise(self.model, cond, self.guidance)
            if self._tapping and batch in self._tap_set:
                self._tap_next = batch
            with spans("sampler"):
                x = ddim_sample(denoise if wrap is None else wrap(denoise), self.schedule,
                                self.shape, g, self.p["steps"], eta=self.p["eta"],
                                spacing=self.p["spacing"], x_T=x_T)
            with spans("quantize"):
                if cond is not None:
                    x = torch.cat([cond, x], dim=-1)
                imgs = quantize(x)  # to the host: the batch is finished here
        want = self.shape[:-1] + (self.shape[-1] + self.cond_shape[-1],)
        if imgs.shape != want or imgs.dtype != np.uint8:
            self.failed += self.shape[0]
        self.outs.append(imgs)

    def window(self, seconds: float, host_spans: bool) -> dict:
        """The measured window. With host_spans, each denoiser call's host
        time (what the sampler pays to enqueue a forward) is kept."""
        dispatch: List[float] = []

        def timed(denoise):
            def call(x, t):
                t0 = time.perf_counter()
                out = denoise(x, t)
                dispatch.append(time.perf_counter() - t0)
                return out

            return call

        self._tap_set, self._tapping = set(self.tap_batches()), True
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        batch = 0
        while True:
            self._batch(batch, timed if host_spans else None)
            batch += 1
            wall = time.perf_counter() - t0
            if wall >= seconds:
                break
        self._tapping = False
        self.attempted = batch * self.shape[0]
        return {self.p.get("metric", "scenes_per_s"): batch * self.shape[0] / wall, "wall_s": wall,
                "dispatch_s": dispatch, "forwards": batch * self.p["steps"],
                "forward_flops": counts.unet2d_forward_flops(self.mcfg, self.rows)}

    def profiled(self) -> dict:
        """The traced part: profiled_batches more batches, each denoiser
        call in a "dispatch" span."""

        def wrap(denoise):
            def call(x, t):
                with self.spans("dispatch"):
                    return denoise(x, t)

            return call

        n = self.p["profiled_batches"]
        first = len(self.outs)
        for b in range(first, first + n):
            self._batch(b, wrap)
        self.attempted += n * self.shape[0]
        return {"forwards": n * self.p["steps"], "rows_per_forward": self.rows}

    def release(self) -> None:
        del self.model, self.schedule
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------

    def sample_scenes(self, batches: int) -> List[tuple]:
        """(batch, row) of the scenes to check: row positions in a seeded
        order, each from a seeded one of the `batches` delivered."""
        rng = np.random.default_rng(inputs.sub_seed(self.seed, "check"))
        B, n = self.shape[0], self.p["check_scenes"]
        rows = np.concatenate([rng.permutation(B) for _ in range(-(-n // B))])[:n]
        return [(int(rng.integers(batches)), int(r)) for r in rows]

    def reference_scenes(self, picks: List[tuple], precision: str = "f32"
                         ) -> Dict[tuple, np.ndarray]:
        """The reference's uint8 scenes for (batch, row) picks, drawn again
        from the seed: batch b's x_T (and cond) as the run drew them."""
        model = ReferenceUNet(self.mcfg, self.weights, precision)
        by_batch = defaultdict(list)
        for b, r in picks:
            by_batch[b].append(r)
        out = {}
        with torch.no_grad(), plain_float32():
            for b, rows in sorted(by_batch.items()):
                rows = sorted(set(rows))
                x_T = inputs.x_T(self.seed, b, self.shape, self.device)
                cond = (inputs.cond_rasters(self.seed, b, self.cond_shape, self.device)
                        if self.guidance is not None else None)
                for i in range(0, len(rows), REF_BLOCK):
                    blk = rows[i:i + REF_BLOCK]
                    if cond is None:
                        denoise = model
                    else:
                        denoise = ref_diffusion.guided(model, cond[blk], self.guidance)
                    x = ref_diffusion.ddim_chain(denoise, x_T[blk], self.p["steps"])
                    if cond is not None:
                        x = torch.cat([cond[blk], x], dim=-1)
                    for r, img in zip(blk, ref_diffusion.quantize(x)):
                        out[(b, r)] = img
        return out

    def reference_taps(self, batches: List[int], precision: str = "f32"
                       ) -> Dict[int, torch.Tensor]:
        """The reference's attention branch in the first forward of each of
        `batches`, on its x_T (and cond) drawn again from the seed, rows in
        the program's order (under guidance the cond rows, then the
        unconditional ones)."""
        model = ReferenceUNet(self.mcfg, self.weights, precision)
        t0 = ref_diffusion.ddim_timesteps(self.p["steps"])[0]
        out = {}
        with torch.no_grad(), plain_float32():
            for b in batches:
                x_T = inputs.x_T(self.seed, b, self.shape, self.device)
                conds = [None]
                if self.guidance is not None:
                    cond = inputs.cond_rasters(self.seed, b, self.cond_shape, self.device)
                    conds = [cond, torch.zeros_like(cond)]
                model.taps = []
                for c in conds:
                    for i in range(0, self.shape[0], REF_BLOCK):
                        x = x_T[i:i + REF_BLOCK]
                        t = torch.full((x.shape[0],), t0, device=self.device, dtype=torch.int64)
                        model(x, t, None if c is None else c[i:i + REF_BLOCK])
                out[b] = torch.cat(model.taps)
                model.taps = None
        return out

    @staticmethod
    def tap_gap(got: Dict[int, torch.Tensor], ref: Dict[int, torch.Tensor]) -> float:
        """The worst batch's ||got - ref|| / ||ref|| over all its rows."""
        gaps = []
        for b, want in ref.items():
            if got[b].numel() != want.numel():
                return float("inf")
            have = got[b].double().reshape(want.shape)
            want = want.double()
            gaps.append(float((have - want).norm() / want.norm()))
        return max(gaps)

    def compare(self, got: Dict[tuple, np.ndarray], ref: Dict[tuple, np.ndarray]) -> dict:
        c = self.cond_shape[-1]
        diffs, cond_changed = [], 0
        for key, want in ref.items():
            have = got[key]
            if have.shape != want.shape:
                return {"scene_mean_abs_levels": {"value": float("inf"),
                                                  "limit": self.limits["scene_mean_abs_levels"]}}
            diffs.append(np.abs(have[..., c:].astype(np.int16) - want[..., c:]).ravel())
            cond_changed += int(np.count_nonzero(have[..., :c] != want[..., :c]))
        checks = {"scene_mean_abs_levels": {"value": float(np.concatenate(diffs).mean()),
                                            "limit": self.limits["scene_mean_abs_levels"]}}
        if c:
            checks["cond_levels_changed"] = {"value": cond_changed,
                                             "limit": self.limits["cond_levels_changed"]}
        return checks

    def check(self) -> dict:
        picks = self.sample_scenes(len(self.outs))
        got = {(b, r): self.outs[b][r] for b, r in picks}
        checks = self.compare(got, self.reference_scenes(picks))
        if self.taps:
            gap = self.tap_gap(self.taps, self.reference_taps(sorted(self.taps)))
            checks["attention_rel_gap"] = {"value": gap,
                                           "limit": self.limits["attention_rel_gap"]}
        else:
            print("check: no eager forward was tapped; attention_rel_gap is not compared",
                  file=sys.stderr)
        return checks

    def control_check(self) -> dict:
        """The control in the program's place: the reference with its
        products in fp8, on the scenes a one-batch window would check."""
        self.make_inputs()
        picks = self.sample_scenes(1)
        checks = self.compare(self.reference_scenes(picks, "fp8"), self.reference_scenes(picks))
        batches = self.tap_batches()
        gap = self.tap_gap(self.reference_taps(batches, "fp8"), self.reference_taps(batches))
        checks["attention_rel_gap"] = {"value": gap, "limit": self.limits["attention_rel_gap"]}
        return checks
