"""Config-5 evaluation: agent-extraction precision/recall for the
map-conditioned agent-inpainting model under classifier-free guidance
(port of drivescenegen_tpu/scripts/eval_cond_agents.py).

Protocol: for each held-out GT raster, the model diffuses the agent (B)
channel conditioned on the map (R/G) channels; the agent extractor
(vectorize/agents.py, reference extract_vehicles.py:130) is run on BOTH
the GT raster and the [R, G, B_generated] composite, and the two agent
sets are greedily matched by center distance. Reported per guidance
scale: precision / recall / F1 and mean center error on matches.

Judging against the raster's own extracted agents (not the scenario's
track table) isolates conditioning fidelity from the rasterizer's
visibility gates — both sides pass through the identical extractor.

  python -m drivescenegen_torch.scripts.eval_cond_agents \
      --cfg_file <config-5 yaml> --model_dir <dir> \
      --raster_dir <held-out GT rasters> --guidance 1,2,3,5 --num 128

DDIM (eta 0) runs on --device (default cuda); --plain runs PyTorch's
library ops there instead of the kernels. Batch i (its first raster's
index) draws x_T from a torch.Generator seeded from --seed and i
(scripts/generation.py batch_generator); the last, short batch samples
only its real rows, where the JAX package pads it to one compiled shape.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np


def match_agents(gt: list, pred: list, dist_thresh_m: float = 3.0):
    """Greedy nearest-center matching; returns (n_matched, sum_err_m)."""
    if not gt or not pred:
        return 0, 0.0
    gt_xy = np.array([[a[0], a[1]] for a in gt])
    pr_xy = np.array([[a[0], a[1]] for a in pred])
    d = np.linalg.norm(gt_xy[:, None, :] - pr_xy[None, :, :], axis=-1)
    n_matched, err = 0, 0.0
    used_g, used_p = set(), set()
    order = np.dstack(np.unravel_index(np.argsort(d, axis=None), d.shape))[0]
    for gi, pi in order:
        if d[gi, pi] > dist_thresh_m:
            break
        if gi in used_g or pi in used_p:
            continue
        used_g.add(int(gi))
        used_p.add(int(pi))
        n_matched += 1
        err += float(d[gi, pi])
    return n_matched, err


def score_samples(rasters: np.ndarray, gt_agents: list, samples: np.ndarray) -> dict:
    """The scores of one guidance scale: the agents extracted from each
    [R, G, B_sampled] composite (B from `samples`, [N, res, res, 1] in
    [-1, 1]) matched against `gt_agents`, those of the GT `rasters`
    ([N, res, res, 3] in [0, 1])."""
    from drivescenegen_torch.vectorize.agents import extract_agents

    gen_b = np.clip(np.asarray(samples)[..., 0] / 2 + 0.5, 0, 1)
    tp = fp = fn = 0
    err_sum = 0.0
    for i, r in enumerate(rasters):
        comp = r.copy()
        comp[..., 2] = gen_b[i]
        pred = extract_agents(comp, None)
        m, e = match_agents(gt_agents[i], pred)
        tp += m
        fp += len(pred) - m
        fn += len(gt_agents[i]) - m
        err_sum += e
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    return {
        "precision": round(precision, 4),
        "recall": round(recall, 4),
        "f1": round(2 * precision * recall / max(precision + recall, 1e-9), 4),
        "mean_center_err_m": round(err_sum / max(tp, 1), 3),
        "n_pred": tp + fp,
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description="Conditional agent eval (PyTorch)")
    parser.add_argument("--cfg_file", required=True, type=str)
    parser.add_argument("--model_dir", default=None, type=str)
    parser.add_argument("--raster_dir", required=True, type=str,
                        help="held-out GT rasters (RGB PNGs; R/G=map cond)")
    parser.add_argument("--guidance", default="1,2,3,5", type=str)
    parser.add_argument("--num", default=128, type=int)
    parser.add_argument("--batch_size", default=32, type=int)
    parser.add_argument("--steps", default=50, type=int)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--json_out", default=None, type=str)
    parser.add_argument("--device", default="cuda", type=str)
    parser.add_argument("--plain", action="store_true",
                        help="run PyTorch's library ops instead of the CUDA kernels")
    args = parser.parse_args(argv)

    import torch
    from PIL import Image

    from drivescenegen_torch.config import load_config
    from drivescenegen_torch.diffusion import ddim_sample, make_guided_denoise
    from drivescenegen_torch.scripts.generation import batch_generator, load_model_for_sampling
    from drivescenegen_torch.utils.device import resolve_device
    from drivescenegen_torch.vectorize.agents import extract_agents

    cfg = load_config(args.cfg_file)
    if cfg.model.cond_channels <= 0:
        raise SystemExit("eval_cond_agents needs a conditional model")
    device = resolve_device(args.device)
    model, schedule = load_model_for_sampling(
        cfg, args.model_dir or cfg.generation.model_dir, device, plain=args.plain
    )
    res = cfg.model.sample_size

    files = sorted(glob.glob(os.path.join(args.raster_dir, "*.png")))[: args.num]
    if not files:
        raise SystemExit(f"no rasters under {args.raster_dir}")

    # Load GT rasters, resized to the model resolution.
    rasters = []
    for f in files:
        img = Image.open(f).convert("RGB")
        if img.size != (res, res):
            img = img.resize((res, res), Image.BILINEAR)
        rasters.append(np.asarray(img).astype(np.float32) / 255.0)
    rasters = np.stack(rasters)  # [N, res, res, 3] in [0, 1]
    cond = rasters[..., :2] * 2.0 - 1.0  # map channels in model range

    bsz = args.batch_size

    def sample_all(guidance: float) -> np.ndarray:
        outs = []
        with torch.no_grad():
            for i in range(0, len(cond), bsz):
                c = torch.from_numpy(cond[i : i + bsz]).to(device)
                denoise = make_guided_denoise(model, c, guidance)
                out = ddim_sample(denoise, schedule,
                                  (c.shape[0], res, res, cfg.model.out_channels),
                                  batch_generator(args.seed, i, device), args.steps)
                outs.append(out.float().cpu().numpy())
        return np.concatenate(outs)  # [-1, 1]

    results = {}
    gt_agents = [extract_agents(r, None) for r in rasters]
    n_gt_total = sum(len(a) for a in gt_agents)
    for g in [float(x) for x in args.guidance.split(",")]:
        results[f"guidance_{g:g}"] = score_samples(rasters, gt_agents, sample_all(g))
        print(g, results[f"guidance_{g:g}"], flush=True)

    out = {"n_images": len(files), "n_gt_agents": n_gt_total, "results": results}
    print(json.dumps(out))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
