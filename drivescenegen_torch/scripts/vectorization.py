"""Stage 2: generated rasters -> vectorized scenarios (port of
drivescenegen_tpu/scripts/vectorization.py; reference:
scripts/vectorization.py).

Per image: GRAPH_FIT lane extraction + agent decoding; saves
  vectorized/<id>.pkl   (scenario dict, torch.save for reference parity)
  graph/<id>_graph.pickle
  agent/<id>_agents.npy
  vectorized_pics/<id>.png  (3-panel figure, with vectorize.plot)
  stats/worker_<n>.json and vectorization_stats.json (the survivorship
  counts and the rejection gates)

The lane masks of the images, taken on the host, are skeletonized on
--device (default cuda) in chunks of 64, one batched call each
(ops/morphology.py skeletonize_batch; --no_device_skeleton skips it and
each worker skeletonizes on the CPU). The irregular graph passes then run
in spawned CPU worker processes, which never touch the card; the native
graph library (vectorize/native_graph.py) is built at its first use.

  python -m drivescenegen_torch.scripts.vectorization --load_path <dir> \
      --save_path <dir> --n_workers 8 [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import multiprocessing
import os
import pickle
import time

import numpy as np

from drivescenegen_torch.config import load_config
from drivescenegen_torch.utils.io import split_round_robin
from drivescenegen_torch.utils.logging import get_logger

logger = get_logger("vectorization")

# Worker-process state of scripts/end_to_end.py's pool, set once by the
# pool initializer (spawn context: module globals, not closures, so they
# pickle). The worker functions live here, in a module that imports no
# torch at its top: a worker imports torch only to save an accepted
# scenario (torch.save), so a spawned worker starts in a fraction of the
# time.
_POOL_STATE: dict = {}


def _pool_init(vcfg, dirs):
    _POOL_STATE["vcfg"] = vcfg
    _POOL_STATE["dirs"] = dirs


def _pool_entry(job):
    img_id, path, skel, pixels = job
    if pixels is not None:
        # PNG encode happens here, off the sampler loop's critical path.
        from PIL import Image

        Image.fromarray(pixels).save(path)
    return process_one(img_id, path, skel, _POOL_STATE["vcfg"], _POOL_STATE["dirs"])


def vectorize(img01, method: str = "GRAPH_FIT", map_range: float = 80.0,
              plot: bool = False, pic_save_path: str = None, skel=None,
              vcfg=None):
    """One raster -> (lanes, graph, agents, fig) (reference vectorize(),
    scripts/vectorization.py:24-84)."""
    from drivescenegen_torch.vectorize import graph_fit
    from drivescenegen_torch.vectorize.agents import extract_agents
    from drivescenegen_torch.vectorize.image_utils import to_float01

    img01 = to_float01(img01)
    kwargs = {}
    if vcfg is not None:
        kwargs = dict(
            min_distance=vcfg.min_distance,
            intersection_offset=vcfg.intersection_offset,
            length_thresh=vcfg.length_thresh,
            noise_mask_frac=vcfg.noise_mask_frac,
            max_graph_nodes=vcfg.max_graph_nodes,
            despeckle_px=vcfg.despeckle_px,
            max_scene_nodes=vcfg.max_scene_nodes,
        )
    try:
        if method == "GRAPH_FIT":
            lanes, graph = graph_fit.extract_polylines_from_img(
                img01, map_range=map_range, skel=skel, **kwargs
            )
        elif method == "GRAPH":
            from drivescenegen_torch.vectorize import graph_legacy

            lanes, graph = graph_legacy.extract_polylines_from_img(
                img01, map_range=map_range, skel=skel
            )
        else:
            logger.warning(f"Unknown method {method}, vectorization failed")
            return None, None, None, None
    except ValueError:
        logger.warning("Could not extract polylines from img")
        return None, None, None, None

    if lanes is None:
        return None, graph, None, None

    agent_kwargs = {}
    if vcfg is not None:
        agent_kwargs = dict(
            dist_thresh=vcfg.agent_dist_thresh,
            min_speed=vcfg.agent_min_speed,
            max_speed=vcfg.agent_max_speed,
        )
    agents = extract_agents(img01, lanes, map_range=map_range, **agent_kwargs)

    fig = None
    if plot or pic_save_path:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from drivescenegen_torch.render import render_vectorized_scenario_on_axes

        fig, axes = plt.subplots(1, 3)
        dpi = 100
        size = 800 / dpi
        fig.set_size_inches([3 * size, size])
        fig.set_dpi(dpi)
        fig.set_facecolor("azure")
        axes = axes.ravel()
        axes[0].imshow(img01)
        axes[0].set_aspect("equal")
        axes[0].margins(0)
        axes[0].grid(False)
        axes[0].axis("off")
        render_vectorized_scenario_on_axes(axes[1], lanes, [], map_range=map_range)
        render_vectorized_scenario_on_axes(axes[2], [], agents, map_range=map_range)

    return lanes, graph, agents, fig


def _batch_skeletonize(files, device, chunk: int = 64):
    """Skeletonize the host's lane masks of `files` on `device`, `chunk` at
    a time, the last chunk padded to a full one so every call has one
    shape; each call stops at the first 8th iteration that changed nothing
    (the result is read back right after, so the checks stall nothing).
    Returns {path: skel array ([x][y] indexed)}."""
    import torch
    from PIL import Image

    from drivescenegen_torch.ops.morphology import skeletonize_batch
    from drivescenegen_torch.vectorize.image_utils import get_lane_mask, to_float01

    out = {}
    t0 = time.perf_counter()
    for i in range(0, len(files), chunk):
        batch_files = files[i : i + chunk]
        masks = []
        for f in batch_files:
            img = to_float01(Image.open(f).convert("RGB"))
            masks.append(get_lane_mask(img).T)  # [x][y] convention
        masks_np = np.stack(masks)
        n_real = masks_np.shape[0]
        if n_real < chunk:
            pad = np.zeros((chunk - n_real,) + masks_np.shape[1:], masks_np.dtype)
            masks_np = np.concatenate([masks_np, pad])
        skels = skeletonize_batch(torch.from_numpy(masks_np).to(device),
                                  check_every=8).cpu().numpy()[:n_real]
        for f, s in zip(batch_files, skels):
            out[f] = s
    logger.info(
        f"skeletonized {len(files)} masks on {device} in {time.perf_counter() - t0:.1f}s"
    )
    return out


def process_one(img_id, path, skel, cfg_v, dirs) -> str:
    """Vectorize one raster PNG and save its artifacts.

    Returns "ok" | "rejected" | "failed" (the survivorship accounting
    categories). Shared by the batch workers below and the fused
    generation+vectorization pipeline (scripts/end_to_end.py)."""
    from PIL import Image

    vectorized_dir, picture_dir, graph_dir, agent_dir = dirs
    try:
        img = Image.open(path).convert("RGB")
        pic_save_path = (
            os.path.join(picture_dir, f"{img_id}_process.png") if cfg_v.plot else None
        )
        lanes, graph, agents, fig = vectorize(
            img, method=cfg_v.method, map_range=cfg_v.map_range,
            plot=cfg_v.plot, pic_save_path=pic_save_path, skel=skel, vcfg=cfg_v,
        )
        if fig is not None:
            fig.savefig(
                os.path.join(picture_dir, f"{img_id}.png"),
                transparent=True, format="png",
            )
            import matplotlib.pyplot as plt

            plt.close(fig)
        if graph is not None:
            with open(os.path.join(graph_dir, f"{img_id}_graph.pickle"), "wb") as f:
                pickle.dump(graph, f)
        if agents is not None and lanes is not None:
            np.save(os.path.join(agent_dir, f"{img_id}_agents.npy"), np.array(agents))
            output_dict = {
                "scenario_id": img_id,
                "sdc_track_index": 0,
                "object_type": np.ones((len(agents))),
                "all_agent": agents,
                "lane": lanes,
            }
            import torch

            torch.save(output_dict, os.path.join(vectorized_dir, f"{img_id}.pkl"))
        return "ok" if lanes is not None else "rejected"
    except Exception as e:
        logger.warning(f"File no. {img_id} failed to be vectorized due to {e}")
        return "failed"


def _worker(jobs, cfg_v, dirs, proc_id):
    # Rejection accounting: metrics downstream must be able to report how
    # many samples never entered the pool.
    counts = {"n_ok": 0, "n_rejected": 0, "n_failed": 0}
    for img_id, path, skel in jobs:
        counts[f"n_{process_one(img_id, path, skel, cfg_v, dirs)}"] += 1
    stats_dir = os.path.join(os.path.dirname(dirs[0].rstrip("/")), "stats")
    os.makedirs(stats_dir, exist_ok=True)
    with open(os.path.join(stats_dir, f"worker_{proc_id}.json"), "w") as f:
        json.dump(counts, f)


@contextlib.contextmanager
def cuda_hidden():
    """Processes started within the block see no CUDA device
    (CUDA_VISIBLE_DEVICES is empty there): the host workers never touch
    the card. The variable is restored after."""
    saved = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = saved


def main(argv=None):
    parser = argparse.ArgumentParser(description="Vectorization (PyTorch)")
    parser.add_argument("--load_path", default=None, type=str,
                        help="directory of generated raster PNGs")
    parser.add_argument("--save_path", default=None, type=str)
    parser.add_argument("--cfg_file", default=None, type=str)
    parser.add_argument("--n_workers", default=8, type=int)
    parser.add_argument("--no_device_skeleton", action="store_true",
                        help="skip the batched skeletonization pass on --device")
    parser.add_argument("--limit", default=0, type=int)
    parser.add_argument("--device", default="cuda", type=str)
    args = parser.parse_args(argv)

    from drivescenegen_torch.utils.device import resolve_device

    cfg = load_config(args.cfg_file)
    vcfg = cfg.vectorize
    map_range = vcfg.map_range
    device = resolve_device(args.device)

    input_dir = args.load_path or f"./data/generated_{int(map_range)}m_5k/diffusion"
    outputs_dir = args.save_path or os.path.dirname(input_dir.rstrip("/")) or "."

    vectorized_dir = os.path.join(outputs_dir, "vectorized")
    picture_dir = os.path.join(outputs_dir, "vectorized_pics")
    graph_dir = os.path.join(outputs_dir, "graph")
    agent_dir = os.path.join(outputs_dir, "agent")
    for d in (vectorized_dir, picture_dir, graph_dir, agent_dir):
        os.makedirs(d, exist_ok=True)
    # Clear stale per-worker accounting from a previous run of this dir.
    for sf in glob.glob(os.path.join(outputs_dir, "stats", "worker_*.json")):
        os.remove(sf)

    all_files = sorted(glob.glob(os.path.join(input_dir, "*.png")))
    if args.limit:
        all_files = all_files[: args.limit]
    if not all_files:
        raise SystemExit(f"no PNGs under {input_dir}")

    t0 = time.perf_counter()
    skels = {} if args.no_device_skeleton else _batch_skeletonize(all_files, device)

    jobs = [(i, f, skels.get(f)) for i, f in enumerate(all_files)]
    n_workers = max(1, min(args.n_workers, len(jobs)))
    dirs = (vectorized_dir, picture_dir, graph_dir, agent_dir)
    if n_workers == 1:
        _worker(jobs, vcfg, dirs, 0)
    else:
        # spawn, not fork: the parent may hold a CUDA context.
        ctx = multiprocessing.get_context("spawn")
        shards = split_round_robin(jobs, n_workers)
        procs = []
        with cuda_hidden():
            for pid, shard in enumerate(shards):
                p = ctx.Process(target=_worker, args=(shard, vcfg, dirs, pid))
                p.start()
                procs.append(p)
        for p in procs:
            p.join()
        # Re-run any crashed worker's shard in-process (covers both a single
        # OOM-killed worker and the spawn-cannot-reimport-__main__ case
        # under REPL/heredoc parents).
        failed = [pid for pid, p in enumerate(procs) if p.exitcode != 0]
        for pid in failed:
            logger.warning(f"worker {pid} exited abnormally; rerunning its shard")
            _worker(shards[pid], vcfg, dirs, pid)

    dt = time.perf_counter() - t0
    n = len(glob.glob(os.path.join(graph_dir, "*")))

    # Aggregate the per-worker rejection accounting into one JSON so metrics
    # consumers can see survivorship.
    totals = {"n_images": len(all_files), "n_ok": 0, "n_rejected": 0, "n_failed": 0}
    for sf in glob.glob(os.path.join(outputs_dir, "stats", "worker_*.json")):
        with open(sf) as f:
            c = json.load(f)
        for k in ("n_ok", "n_rejected", "n_failed"):
            totals[k] += c.get(k, 0)
    totals["wall_time_s"] = round(dt, 1)
    # Rejection-gate settings travel with the record: every stats artifact
    # is self-describing about the gates it ran under.
    totals["gates"] = {
        "noise_mask_frac": vcfg.noise_mask_frac,
        "max_graph_nodes": vcfg.max_graph_nodes,
        "max_scene_nodes": vcfg.max_scene_nodes,
        "despeckle_px": vcfg.despeckle_px,
    }
    with open(os.path.join(outputs_dir, "vectorization_stats.json"), "w") as f:
        json.dump(totals, f, indent=2)

    print(
        f"Vectorized {n}/{len(all_files)} scenarios in {dt:.1f}s "
        f"({len(all_files)/dt:.2f} scenes/s) -> {outputs_dir} "
        f"[ok {totals['n_ok']}, rejected {totals['n_rejected']}, "
        f"failed {totals['n_failed']}]"
    )
    return totals


if __name__ == "__main__":
    main()
