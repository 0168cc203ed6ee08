"""End-to-end pipeline demo on synthetic data (the port of
drivescenegen_tpu/scripts/run_demo.py): all five stages + metrics in one
command, no Waymo data required.

  python -m drivescenegen_torch.scripts.run_demo --work_dir <dir> --plain \
      [--n_scenarios 16 --train_steps 50 --device cpu]

Runs the port's CLIs in turn: preprocess(synthetic) -> rasterize -> train ->
generate -> vectorize -> compute_map_metrics, and prints a stage-time
summary. The demo's model (widths 32/64, head dim 8, 8 groups) is outside
the CUDA kernels' limits, so on the card it needs --plain, which the train
and generation CLIs pass to UNet2D; without it they refuse at construction.
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle
import tempfile
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description="Pipeline demo")
    parser.add_argument("--work_dir", default=os.path.join(tempfile.gettempdir(), "dsg_demo"),
                        type=str)
    parser.add_argument("--n_scenarios", default=16, type=int)
    parser.add_argument("--train_steps", default=50, type=int)
    parser.add_argument("--img_res", default=64, type=int)
    parser.add_argument("--gen_batches", default=2, type=int)
    parser.add_argument("--sampler", default="ddim", type=str)
    parser.add_argument("--steps", default=50, type=int)
    parser.add_argument("--device", default="cuda", type=str)
    parser.add_argument("--plain", action="store_true",
                        help="train and sample on PyTorch's library ops instead of the CUDA "
                             "kernels (the demo's model is outside their limits)")
    args = parser.parse_args(argv)

    from drivescenegen_torch.scripts import (
        compute_map_metrics,
        data_preprocess,
        data_rasterization,
        generation,
        train,
        vectorization,
    )
    from drivescenegen_torch.utils.device import resolve_device

    resolve_device(args.device)
    wd = args.work_dir
    os.makedirs(wd, exist_ok=True)
    times = {}
    dev = ["--device", args.device]
    plain = ["--plain"] if args.plain else []

    def stage(name, fn):
        t0 = time.perf_counter()
        fn()
        times[name] = time.perf_counter() - t0
        print(f"[demo] {name}: {times[name]:.1f}s")

    cfg_path = os.path.join(wd, "cfg.yaml")
    with open(cfg_path, "w") as f:
        f.write(f"""
model:
  sample_size: {args.img_res}
  block_out_channels: [32, 64]
  layers_per_block: 1
  norm_num_groups: 8
  attention_head_dim: 8
train:
  batch_size: 8
  learning_rate: 0.002
  lr_warmup_steps: 10
  log_every: 25
  eval_inference_steps: 50
  save_image_epochs: 100000
  save_model_epochs: 100000
  output_dir: {wd}/model
  dataset_glob: "{wd}/rasterized/GT_70k_s80_dxdy_agents_img/*"
generation:
  model_dir: {wd}/model
  output_dir: {wd}/generated
raster:
  img_res: {args.img_res}
""")

    stage("preprocess", lambda: data_preprocess.main(
        ["--synthetic", str(args.n_scenarios), "--save_path", f"{wd}/preprocessed"]
    ))
    stage("rasterize", lambda: data_rasterization.main(
        ["--load_path", f"{wd}/preprocessed", "--save_path", f"{wd}/rasterized",
         "--n_workers", "4", "--cfg_file", cfg_path, *dev]
    ))
    stage("train", lambda: train.main(
        ["--cfg_file", cfg_path, "--max_steps", str(args.train_steps), *dev, *plain]
    ))
    stage("generate", lambda: generation.main(
        ["--cfg_file", cfg_path, "--sampler", args.sampler,
         "--steps", str(args.steps), "--batch_size", "8",
         "--num_batches", str(args.gen_batches), *dev, *plain]
    ))
    # Best-effort on the generated samples (a briefly-trained demo model
    # mostly produces noise, which the vectorizer rejects quickly)...
    stage("vectorize_generated", lambda: vectorization.main(
        ["--load_path", f"{wd}/generated", "--save_path", f"{wd}/vec_gen",
         "--n_workers", "4", *dev]
    ))
    # ...and the real vectorization demo on the clean GT rasters.
    stage("vectorize", lambda: vectorization.main(
        ["--load_path", f"{wd}/rasterized/GT_70k_s80_dxdy_agents_img",
         "--save_path", f"{wd}/vec", "--n_workers", "4", *dev]
    ))

    # GT side for metrics.
    def gt_export():
        from drivescenegen_torch.data.graph_export import export_scenario

        for i, path in enumerate(sorted(glob.glob(f"{wd}/preprocessed/sample_*.pkl"))):
            with open(path, "rb") as f:
                info = pickle.load(f)
            export_scenario(info, f"{wd}/gt", i)

    stage("gt_export", gt_export)

    # Model-quality metrics (GT vs generated samples) — only when some
    # generated samples survived vectorization (a smoke-trained model may
    # produce none).
    if glob.glob(f"{wd}/vec_gen/graph/*"):
        print("[demo] metrics vs GENERATED samples (model quality):")
        stage("metrics_generated", lambda: compute_map_metrics.main(
            ["--gt_dir", f"{wd}/gt", "--gen_dir", f"{wd}/vec_gen",
             "--map_range", "80", "--map_res", str(args.img_res)]
        ))
    else:
        print("[demo] no generated samples passed vectorization "
              "(expected for a briefly-trained smoke model) — skipping "
              "model-quality metrics")

    # Round-trip metrics (GT vs vectorized GT rasters) — measures the
    # rasterize->vectorize fidelity, NOT the model.
    print("[demo] metrics vs vectorized GT rasters (round-trip fidelity):")
    stage("metrics_roundtrip", lambda: compute_map_metrics.main(
        ["--gt_dir", f"{wd}/gt", "--gen_dir", f"{wd}/vec",
         "--map_range", "80", "--map_res", str(args.img_res)]
    ))

    total = sum(times.values())
    print(f"[demo] TOTAL {total:.1f}s — artifacts under {wd}")
    return times


if __name__ == "__main__":
    main()
