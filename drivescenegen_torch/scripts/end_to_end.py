"""Fused stages 1b+2 (port of drivescenegen_tpu/scripts/end_to_end.py):
sample scene rasters on the card while host workers vectorize finished
batches concurrently.

Per batch the device work is one function, run_batch: sample (the port's
samplers, through the UNet's kernels), then ops/stage2.py: quantize to
uint8, lane-mask (integer-exact against the host path), transpose to
[x][y], skeletonize (a fixed count of iterations) and pack the skeletons
8 pixels per byte, most significant bit first. The
quantized pixels and packed skeletons are copied into pinned host memory
behind an event, so nothing in the pass waits for the host. Batch N+1 is
enqueued before batch N is drained: the drain waits only for batch N's
event, then hands the PNG encode and the graph passes to spawned CPU
workers (which never touch the card) through a blocking queue.

Artifacts match the two-stage path: the PNGs equal the generation CLI's
for the same seed (batch `num` draws from generation.batch_generator(seed,
num)), and the skeletons equal what scripts/vectorization.py derives from
the saved files. --resume reloads a batch whose PNGs are all on disk and
runs only the mask/skeleton/pack pass for it.

Batch-parallel under torchrun (parallel/mesh.py), as the generation CLI:
the batch rounded to the data axis, every rank sampling its rows of batch
`num`'s global draws and running the device pass on them. Rank 0 gathers
the quantized pixels and packed skeletons of every rank (all_gather) and
alone runs the host side (PNG encode, graph passes, stats), exactly as
one process does; a batch it resumes from disk it runs alone, and it
tells the other ranks so (a broadcast flag per batch). With mesh.model >
1 the parameters are replicated and the data axis is the world over it:
the ranks of a model group sample the same rows, and rank 0 gathers over
its data group.

  python -m drivescenegen_torch.scripts.end_to_end --model_dir <dir> \
      --output_dir <dir> --num_scenes 5000 --n_workers 2 [--device cpu] [--plain]
"""

from __future__ import annotations

import argparse
import functools
import json
import multiprocessing
import os
import queue
import time

import numpy as np

from drivescenegen_torch.config import load_config
from drivescenegen_torch.scripts.vectorization import _pool_entry, _pool_init, cuda_hidden
from drivescenegen_torch.utils.logging import get_logger

# torch and the sampling stack are imported inside the functions: a spawned
# worker imports this module again as its __main__ when the CLI runs with
# python -m, and needs none of them (scripts/vectorization.py _pool_entry).

logger = get_logger("end_to_end")


def to_host(*tensors):
    """Copies of `tensors` in host memory and a function that waits for
    them and returns them as numpy arrays. On the card the copies go into
    pinned memory behind an event: nothing here waits for the device."""
    import torch

    if tensors[0].device.type != "cuda":
        arrays = tuple(t.numpy() for t in tensors)
        return lambda: arrays
    host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors)
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait():
        done.synchronize()
        return tuple(h.numpy() for h in host)

    return wait


def refuse_unsupported(mcfg) -> None:
    """The fused drain path (PNG encode + lane-mask channel indexing) only
    handles unconditional 3-channel models."""
    if mcfg.out_channels != 3 or mcfg.cond_channels != 0:
        raise SystemExit(
            "end_to_end supports unconditional 3-channel models only "
            f"(got out_channels={mcfg.out_channels}, "
            f"cond_channels={mcfg.cond_channels}); use "
            "scripts.generation + scripts.vectorization for this model."
        )


def main(argv=None):
    """Returns (the vectorization_stats.json record, unrounded timings)."""
    parser = argparse.ArgumentParser(description="Fused generation+vectorization (PyTorch)")
    parser.add_argument("--cfg_file", default=None, type=str)
    parser.add_argument("--model_dir", default=None, type=str)
    parser.add_argument("--output_dir", required=True, type=str)
    parser.add_argument("--num_scenes", default=5000, type=int)
    parser.add_argument("--batch_size", default=8, type=int)
    parser.add_argument("--sampler", default="ddim",
                        choices=["ddpm", "ddim", "dpm", "sde"])
    parser.add_argument("--steps", default=0, type=int)
    parser.add_argument("--eta", default=None, type=float,
                        help="DDIM stochasticity (see generation --eta)")
    parser.add_argument("--spacing", default=None,
                        choices=["leading", "trailing"],
                        help="timestep spacing (see generation --spacing)")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--n_workers", default=2, type=int)
    parser.add_argument("--resume", action="store_true",
                        help="skip sampling for batches whose PNGs are all "
                             "on disk (crash recovery for long runs); their "
                             "images are still vectorized, so the stats "
                             "stay complete")
    parser.add_argument("--device", default="cuda", type=str)
    parser.add_argument("--plain", action="store_true",
                        help="run PyTorch's library ops instead of the CUDA kernels, for a "
                             "model outside their limits")
    args = parser.parse_args(argv)

    import torch

    from drivescenegen_torch.diffusion import (
        ddim_sample,
        ddpm_sample,
        dpmpp_2m_sample,
        dpmpp_2m_sde_sample,
    )
    from drivescenegen_torch.ops.stage2 import quantize, skeleton_pass
    from drivescenegen_torch.parallel import make_mesh
    from drivescenegen_torch.scripts.generation import (
        batch_generator,
        load_model_for_sampling,
        rounded_batch,
        row_draws,
    )

    cfg = load_config(args.cfg_file)
    vcfg = cfg.vectorize
    refuse_unsupported(cfg.model)
    mesh = make_mesh(cfg.mesh, args.device)
    device = mesh.device
    model, schedule = load_model_for_sampling(
        cfg, args.model_dir or cfg.generation.model_dir, device, plain=args.plain
    )
    refuse_unsupported(cfg.model)  # the model section spliced from the model dir
    res = cfg.model.sample_size
    batch = rounded_batch(args.batch_size, mesh.shape["data"])
    if batch != args.batch_size:
        logger.info(f"rounded batch to {batch} (data axis {mesh.shape['data']})")
    rows = mesh.rows(batch)
    steps = args.steps or (
        cfg.generation.ddim_steps if args.sampler == "ddim"
        else 20 if args.sampler == "dpm"
        else 25 if args.sampler == "sde"
        else cfg.generation.num_inference_steps
    )

    out_dir = args.output_dir
    png_dir = os.path.join(out_dir, "diffusion")
    dirs = tuple(
        os.path.join(out_dir, d)
        for d in ("vectorized", "vectorized_pics", "graph", "agent")
    )
    for d in (png_dir, *dirs):
        os.makedirs(d, exist_ok=True)

    eta = args.eta if args.eta is not None else cfg.generation.ddim_eta
    if args.sampler == "ddim":
        fn = functools.partial(ddim_sample, eta=eta, spacing=args.spacing or "leading")
    elif args.sampler in ("dpm", "sde"):
        fn = functools.partial(
            dpmpp_2m_sample if args.sampler == "dpm" else dpmpp_2m_sde_sample,
            spacing=args.spacing or "trailing",
        )
    else:
        fn = ddpm_sample
    shape = (batch, res, res, cfg.model.out_channels)
    local_shape = (rows.stop - rows.start,) + shape[1:]

    def gathered(t):
        """The batch's rows of every data coordinate, in order, over the data
        group (rank 0's use; under mesh.model > 1 the other data groups
        hold the same rows and gather them unused)."""
        if not mesh.distributed:
            return t
        parts = [torch.empty_like(t) for _ in range(mesh.shape["data"])]
        torch.distributed.all_gather(parts, t.contiguous(), group=mesh.data_group)
        return torch.cat(parts)

    def run_batch(num: int):
        """Batch `num`'s device pass, enqueued; its host copies' waiter
        (None on ranks but 0)."""
        with torch.no_grad():
            x_T, noise = row_draws(batch_generator(args.seed, num, device), shape, rows)
            kw = {} if args.sampler == "dpm" else {"noise": noise}
            x = fn(model, schedule, local_shape, None, steps, x_T=x_T, **kw)
            q = quantize(x)
            q, packed = gathered(q), gathered(skeleton_pass(q))
            return to_host(q, packed) if mesh.is_main else None

    def resumed_on_main(num: int):
        """try_resume on rank 0; every rank learns whether it resumed."""
        r = try_resume(num) if mesh.is_main else None
        return r, mesh.agree(r is not None)

    def try_resume(num: int):
        """Batch `num` from its PNGs on disk, or None to sample it."""
        if not args.resume:
            return None
        keep = min(batch, args.num_scenes - num * batch)
        from PIL import Image

        pixels = []
        try:
            for i in range(keep):
                p = os.path.join(png_dir, f"loop_{num:03d}_batch_{i:03d}.png")
                pixels.append(np.asarray(Image.open(p).convert("RGB")))
        except (OSError, ValueError):
            return None  # missing/truncated/wrong-size: resample this batch
        q = np.stack(pixels)
        if q.shape[1:] != (res, res, 3):
            return None  # stale files from a different-resolution run
        if q.shape[0] < batch:  # pad: every pass has one shape
            q = np.concatenate(
                [q, np.zeros((batch - q.shape[0], *q.shape[1:]), np.uint8)]
            )
        return to_host(skeleton_pass(torch.from_numpy(q).to(device)))

    if not mesh.is_main:
        # Ranks but 0 sample their rows of each batch that rank 0 does not
        # resume, and leave the host side to it.
        n_batches = (args.num_scenes + batch - 1) // batch
        for num in range(n_batches):
            if not resumed_on_main(num)[1]:
                run_batch(num)
        mesh.barrier()
        mesh.close()
        return None, None

    with cuda_hidden():  # the host workers never touch the card
        pool = multiprocessing.get_context("spawn").Pool(
            max(1, args.n_workers), initializer=_pool_init, initargs=(vcfg, dirs)
        )

    # Jobs flow through a blocking queue; Pool.imap's task-handler thread
    # consumes the generator, so the main thread never blocks on dispatch.
    job_q: queue.Queue = queue.Queue()

    def jobs():
        while True:
            item = job_q.get()
            if item is None:
                return
            yield item

    results = pool.imap_unordered(_pool_entry, jobs(), chunksize=1)

    n_enqueued = 0

    def drain(num: int, wait, resumed: bool = False) -> None:
        """Wait for batch `num`'s host copies and hand the PNG encode and
        graph passes to the workers. Resumed batches already have their
        PNGs on disk, so workers get pixels=None and read the files."""
        nonlocal n_enqueued
        if resumed:
            quant, (packed,) = None, wait()
        else:
            quant, packed = wait()
        skels = np.unpackbits(packed, axis=-1).astype(bool)
        keep = min(batch, args.num_scenes - num * batch)
        for i in range(keep):
            p = os.path.join(png_dir, f"loop_{num:03d}_batch_{i:03d}.png")
            job_q.put((num * batch + i, p, skels[i], None if resumed else quant[i]))
            n_enqueued += 1

    t0 = time.perf_counter()
    first_batch_s = None
    n_batches = (args.num_scenes + batch - 1) // batch
    pending = None
    n_resumed = 0
    try:
        for num in range(n_batches):
            r, _ = resumed_on_main(num)
            if r is not None:
                n_resumed += 1
            current = (num, r if r is not None else run_batch(num), r is not None)
            if pending is not None:
                drain(*pending)
            pending = current
            if num == 0:
                current[1]()
                first_batch_s = time.perf_counter() - t0
                logger.info(f"first batch ({batch}) in {first_batch_s:.1f}s")
        drain(*pending)
        if n_resumed:
            logger.info(f"resumed {n_resumed}/{n_batches} batches from disk")
    except BaseException:
        # Without this, a sampling error leaves the pool's non-daemon
        # worker threads alive and the interpreter (or a pytest run hosting
        # several CLI invocations) hangs on exit.
        job_q.put(None)
        pool.terminate()
        pool.join()
        raise
    sampling_wall = time.perf_counter() - t0
    logger.info(
        f"sampling done: {n_enqueued} scenes in {sampling_wall:.1f}s "
        f"({n_enqueued / sampling_wall:.2f} scenes/s) — waiting for workers"
    )

    job_q.put(None)
    pool.close()
    counts = {"n_ok": 0, "n_rejected": 0, "n_failed": 0}
    for r in results:
        counts[f"n_{r}"] += 1
    pool.join()
    total_wall = time.perf_counter() - t0

    stats = {
        "n_images": n_enqueued,
        **counts,
        "sampling_wall_s": round(sampling_wall, 1),
        "wall_time_s": round(total_wall, 1),
        "scenes_per_s": round(n_enqueued / total_wall, 2),
        # Accepted scenes per second: rejected scenes are sampled and then
        # discarded, so throughput claims must not count them.
        "ok_scenes_per_s": round(counts["n_ok"] / total_wall, 2),
        "sampler": f"{args.sampler}-{steps}",
        # eta only affects the DDIM path; null otherwise.
        "eta": eta if args.sampler == "ddim" else None,
        "spacing": args.spacing or ("trailing" if args.sampler in ("dpm", "sde")
                                    else "leading"),
        "seed": args.seed,
        "batch_size": batch,
        "n_workers": args.n_workers,
        "img_res": cfg.model.sample_size,
        # Rejection-gate settings, so every record is self-describing.
        "gates": {
            "noise_mask_frac": vcfg.noise_mask_frac,
            "max_graph_nodes": vcfg.max_graph_nodes,
            "max_scene_nodes": vcfg.max_scene_nodes,
            "despeckle_px": vcfg.despeckle_px,
        },
    }
    mesh.barrier()
    mesh.close()
    # Same filename/keys as vectorization.py, so metrics pick up the
    # survivorship accounting unchanged.
    with open(os.path.join(out_dir, "vectorization_stats.json"), "w") as f:
        json.dump(stats, f, indent=2)
    print(
        f"end-to-end: {n_enqueued} scenes sampled+vectorized in {total_wall:.1f}s "
        f"({n_enqueued / total_wall:.2f} scenes/s) "
        f"[ok {counts['n_ok']}, rejected {counts['n_rejected']}, "
        f"failed {counts['n_failed']}] -> {out_dir}"
    )
    timings = {"first_batch_s": first_batch_s, "sampling_wall_s": sampling_wall,
               "wall_time_s": total_wall, "n_resumed": n_resumed, "n_batches": n_batches}
    return stats, timings


if __name__ == "__main__":
    main()
