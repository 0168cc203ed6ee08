"""Stage 0b: scenario pickles -> BEV raster PNGs (the port of
drivescenegen_tpu/scripts/data_rasterization.py).

CLI parity with the reference (scripts/data_rasterization.py:55-90); the
rasterizer is the analytic splatter of ops/raster.py, rendering directly at
the training resolution, on --device (the card unless `--device cpu`). Each
spawned worker runs its own scenes' splats on that device.

--save_sidecar also writes the decoded-corpus sidecar the trainer reads
(data/dataset.py sidecar_path), so training never decodes the PNGs: the
output names are known before rasterizing, so every image's row in the
sorted corpus is too, and the workers write their rows of one memmap. The
file is promoted to its key only if the PNG set is the expected one and 8
random rows equal their PNGs' decode (_finalize_sidecar). RGB modes only.

  python -m drivescenegen_torch.scripts.data_rasterization \
      --load_path ./data/preprocessed --save_path ./data/rasterized
"""

from __future__ import annotations

import argparse
import glob
import multiprocessing
import os
import pickle
import time

import numpy as np

from drivescenegen_torch.config import load_config
from drivescenegen_torch.utils.io import split_round_robin


def _worker(files, cfg_raster, out_dir, proc_id, vec_dir=None, augment="", device="cuda",
            threads=0, sidecar=None):
    import torch
    from PIL import Image

    from drivescenegen_torch.ops.raster import rasterize_scenario

    if threads:
        # Workers share the host's cores: each takes its share, or their
        # spinning thread pools stall one another (~8x slower on the CPU).
        torch.set_num_threads(threads)
    # (memmap path, {suffix: [global row of file i]}): this worker's rows of
    # the sidecar, written while the uint8 image is in memory.
    smm = None

    def _render(scenario_info):
        img = rasterize_scenario(
            scenario_info,
            img_res=cfg_raster.img_res,
            map_range=cfg_raster.map_range,
            max_polylines=cfg_raster.max_polylines,
            max_agents=cfg_raster.max_agents,
            with_agent=cfg_raster.with_agent,
            background=cfg_raster.background,
            color_max=cfg_raster.color_max,
            agent_time_index=cfg_raster.agent_time_index,
            interp_k=cfg_raster.interp_k,
            num_points_each_polyline=cfg_raster.num_points_each_polyline,
            mode=cfg_raster.mode,
            device=device,
        )
        return np.clip(img * 255.0, 0, 255).astype(np.uint8)

    for i, path in enumerate(files):
        try:
            with open(path, "rb") as f:
                scenario_info = pickle.load(f)
            if not isinstance(scenario_info, dict):
                continue
            variants = [("", scenario_info)]
            if augment == "rot180":
                # Direction-balancing augmentation (data/augment.py): the
                # 180°-rotated scene presents every lane's opposite travel
                # direction.
                from drivescenegen_torch.data.augment import rotate_scenario_180

                variants.append(("_rot", rotate_scenario_180(scenario_info)))
            for sfx, info in variants:
                arr = _render(info)
                if sidecar is not None and arr.ndim == 3 and arr.shape[-1] == 3:
                    if smm is None:
                        smm = np.load(sidecar[0], mmap_mode="r+")
                    # Byte-equal to the PNG's decode (lossless 8-bit RGB;
                    # _finalize_sidecar checks rows).
                    smm[sidecar[1][sfx][i]] = arr
                if arr.shape[-1] == 1:
                    arr = arr[..., 0]  # occupancy mode saves grayscale
                Image.fromarray(arr).save(
                    os.path.join(out_dir, f"{proc_id}_{i}{sfx}.png")
                )
            if vec_dir is not None:
                # Reference save_png_polys branch (rasterization.py:129-151):
                # padded (rows, cols, 8) vector tensor beside the raster.
                from drivescenegen_torch.data.vector_map import vector_to_same_size_tensor

                tensor, too_less = vector_to_same_size_tensor(
                    scenario_info,
                    des_column_size=cfg_raster.vector_tensor_cols,
                    des_row_size=cfg_raster.vector_tensor_rows,
                    map_range=cfg_raster.map_range,
                )
                if not too_less:
                    np.save(
                        os.path.join(vec_dir, f"{proc_id}_{i}_vector.npy"), tensor
                    )
        except Exception as e:  # skip-and-log, like the reference's workers
            print(f"[worker {proc_id}] {path}: {type(e).__name__}: {e}")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Data Processing 2")
    parser.add_argument("--load_path", default="./data/preprocessed", type=str)
    parser.add_argument("--save_path", default="./data/rasterized/", type=str)
    parser.add_argument("--cfg_file", default=None, type=str)
    parser.add_argument("--n_workers", default=8, type=int)
    parser.add_argument("--save_vector_tensor", action="store_true",
                        help="also save the padded vector-map tensor per "
                             "scenario (reference save_png_polys branch)")
    parser.add_argument("--save_sidecar", action="store_true",
                        help="also write the decoded-corpus sidecar (data/dataset.py "
                             "sidecar_path) at rasterization time, so training never decodes "
                             "the PNGs (RGB modes only)")
    parser.add_argument("--augment", default="", choices=["", "rot180"],
                        help="rot180: additionally rasterize each scenario "
                             "rotated 180 degrees (doubles the corpus; "
                             "direction-balancing for two-way lanes, see "
                             "data/augment.py)")
    parser.add_argument("--device", default="cuda", type=str)
    args = parser.parse_args(argv)

    from drivescenegen_torch.utils.device import resolve_device

    device = str(resolve_device(args.device))
    cfg = load_config(args.cfg_file)
    raster = cfg.raster
    out_dir = os.path.join(
        args.save_path, f"GT_70k_s{int(raster.map_range)}_dxdy_agents_img"
    )
    os.makedirs(out_dir, exist_ok=True)
    vec_dir = None
    if args.save_vector_tensor or raster.save_vector_tensor:
        vec_dir = os.path.join(args.save_path, "vector_tensor")
        os.makedirs(vec_dir, exist_ok=True)

    all_files = sorted(glob.glob(os.path.join(args.load_path, "sample_*.pkl")))
    if not all_files:
        raise SystemExit(f"no scenario pickles under {args.load_path}")

    if args.save_sidecar and raster.mode == "occupancy":
        # The sidecar is a 3-channel corpus cache; a 1-channel mode would
        # allocate a multi-GB memmap the workers never write.
        raise SystemExit("--save_sidecar requires an RGB raster mode; "
                         f"raster.mode={raster.mode!r} renders 1 channel")

    t0 = time.perf_counter()
    n_workers = max(1, min(args.n_workers, len(all_files)))
    shards = [all_files] if n_workers == 1 else split_round_robin(all_files, n_workers)
    sidecars = [None] * len(shards)
    if args.save_sidecar:
        from drivescenegen_torch.data.dataset import sidecar_path

        suffixes = [""] + (["_rot"] if args.augment == "rot180" else [])
        named = sorted((os.path.join(out_dir, f"{pid}_{i}{sfx}.png"), pid, i, sfx)
                       for pid, shard in enumerate(shards) for i in range(len(shard))
                       for sfx in suffixes)
        expected = [t[0] for t in named]
        row_of = {(pid, i, sfx): row for row, (_, pid, i, sfx) in enumerate(named)}
        cache_path = sidecar_path(expected, raster.img_res, 3, np.uint8)
        sidecar_tmp = cache_path + ".tmp"
        m = np.lib.format.open_memmap(sidecar_tmp, mode="w+", dtype=np.uint8,
                                      shape=(len(expected), raster.img_res, raster.img_res, 3))
        del m  # the workers reopen it r+ and fill disjoint rows
        sidecars = [(sidecar_tmp, {sfx: [row_of[(pid, i, sfx)] for i in range(len(shard))]
                                   for sfx in suffixes})
                    for pid, shard in enumerate(shards)]
    if n_workers == 1:
        _worker(all_files, raster, out_dir, 0, vec_dir, args.augment, device,
                sidecar=sidecars[0])
    else:
        # spawn, not fork: the parent may hold a CUDA context.
        ctx = multiprocessing.get_context("spawn")
        threads = max(1, (os.cpu_count() or 1) // n_workers)
        procs = []
        for pid, shard in enumerate(shards):
            p = ctx.Process(target=_worker, args=(shard, raster, out_dir, pid, vec_dir,
                                                  args.augment, device, threads, sidecars[pid]))
            p.start()
            procs.append(p)
        for p in procs:
            p.join()
    dt = time.perf_counter() - t0
    n = len(glob.glob(os.path.join(out_dir, "*.png")))
    print(f"Rasterized {n} scenarios in {dt:.1f}s -> {out_dir}")
    result = {"out_dir": out_dir, "n_png": n, "seconds": dt}
    if args.save_sidecar:
        result["sidecar"] = _finalize_sidecar(out_dir, raster.img_res, expected, sidecar_tmp,
                                              cache_path)
    return result


def _finalize_sidecar(out_dir, img_res, expected, sidecar_tmp, cache_path):
    """Promote the rasterization-time sidecar to its key only if it is what
    decoded_corpus would build: the PNG set on disk must be the expected
    list (a failed worker leaves a hole and shifts the sorted rows), and 8
    random rows must equal their PNGs' decode. Returns the sidecar's path,
    or None when it was discarded."""
    from drivescenegen_torch.data.dataset import RasterDataset

    actual = sorted(glob.glob(os.path.join(out_dir, "*.png")))
    ok = [os.path.normpath(a) for a in actual] == [os.path.normpath(e) for e in expected]
    if ok:
        ds = RasterDataset(os.path.join(out_dir, "*.png"), img_res=img_res, n_channels=3,
                           raw=True)
        m = np.load(sidecar_tmp, mmap_mode="r")
        idxs = np.random.default_rng(0).choice(len(actual), size=min(8, len(actual)),
                                               replace=False)
        ok = all(np.array_equal(m[int(i)], ds[int(i)]) for i in idxs)
        del m
    if ok:
        os.replace(sidecar_tmp, cache_path)
        print(f"sidecar written: {cache_path}")
        return cache_path
    os.remove(sidecar_tmp)
    print("sidecar discarded (PNG set / row mismatch); decoded_corpus will rebuild it by decode")
    return None


if __name__ == "__main__":
    main()
