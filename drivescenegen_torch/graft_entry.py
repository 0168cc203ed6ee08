"""Driver entry points of the PyTorch port (the counterparts of the JAX
package's __graft_entry__.py).

  python -m drivescenegen_torch.graft_entry N

entry(device)        -> (fn, example_args): the flagship UNet2D's denoiser
                        forward (256x256x3, eps prediction), on the card
                        unless the caller asks for the CPU.
dryrun_multichip(n)  -> n gloo ranks on the CPU on a ("data", "model")
                        mesh, DP x TP (data n/2, model 2) when n >= 4 and
                        even, else pure DP; ONE train step at tiny shapes
                        with the batch sharded over "data" and the
                        parameters by the tensor-parallel rules, then a
                        batch-sharded DDIM-5 on the same mesh. Prints
                        "dryrun_multichip OK: mesh=..., batch=..., loss=...".
"""

from __future__ import annotations

import math
import os
import socket
import sys

import torch

# The dryrun's tiny model: dims chosen so that the model axis (2) divides
# every sharded dimension (the JAX dryrun's shapes).
DRYRUN_MODEL = dict(sample_size=16, block_out_channels=(8, 16), layers_per_block=1,
                    norm_num_groups=2, attention_head_dim=8, dtype="float32")


def entry(device="cuda"):
    """The flagship forward step: UNet2D(256x256x3) eps prediction, seeded
    random weights, and its example inputs (x, t)."""
    from drivescenegen_torch.config import ModelConfig
    from drivescenegen_torch.models import UNet2D

    model = UNet2D(ModelConfig(), device=device).eval()
    x = torch.zeros((1, 256, 256, 3), device=model.conv_in.weight.device)
    t = torch.zeros((1,), dtype=torch.long, device=x.device)

    def fn(x, t):
        with torch.no_grad():
            return model(x, t)

    return fn, (x, t)


def dryrun_mesh(n: int) -> dict:
    """The dryrun's mesh for n ranks: DP x TP when n >= 4 and even."""
    if n >= 4 and n % 2 == 0:
        return dict(data=n // 2, model=2)
    return dict(data=n, model=1)


def _rank(rank: int, n: int, port: int, results) -> None:
    """One rank of the dryrun (torch.multiprocessing.start_processes)."""
    from drivescenegen_torch.config import MeshConfig, ModelConfig, TrainConfig
    from drivescenegen_torch.diffusion import ddim_sample, make_schedule
    from drivescenegen_torch.models import UNet2D
    from drivescenegen_torch.parallel import make_mesh
    from drivescenegen_torch.scripts.generation import row_draws
    from drivescenegen_torch.training import create_optimizer, init_train_state, make_train_step

    torch.set_num_threads(1)  # n ranks share the host's cores
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    mesh = make_mesh(MeshConfig(**dryrun_mesh(n)), "cpu", backend="gloo")
    try:
        cfg = ModelConfig(**DRYRUN_MODEL)
        model = UNet2D(cfg, device="cpu", for_training=True, mesh=mesh,
                       generator=torch.Generator().manual_seed(0))
        schedule = make_schedule(device="cpu")
        tcfg = TrainConfig()
        opt, lr_fn = create_optimizer(tcfg, 100, model.parameters())
        state = init_train_state(model, opt)
        batch_size = 2 * mesh.shape["data"]
        batch = torch.randn((batch_size, 16, 16, 3), generator=torch.Generator().manual_seed(1))
        step = make_train_step(schedule, lr_fn, tcfg, mesh)
        state, metrics = step(state, batch[mesh.rows(batch_size)])
        loss = float(metrics["loss"])

        # The generation leg: a 5-step DDIM on the same mesh, batch-sharded
        # over "data" as scripts/generation.py shards it, through the
        # just-trained (tensor-parallel) model.
        shape = (batch_size, 16, 16, 3)
        rows = mesh.rows(batch_size)
        x_T, noise = row_draws(torch.Generator().manual_seed(3), shape, rows)
        with torch.no_grad():
            samples = ddim_sample(model, schedule, x_T.shape, None, 5, x_T=x_T, noise=noise)
        ok = torch.tensor([int(bool(torch.isfinite(samples).all())), samples.shape[0]])
        torch.distributed.all_reduce(ok)
        if mesh.is_main:
            results.put((dict(mesh.shape), batch_size, loss, int(ok[0]), int(ok[1])))
    finally:
        mesh.close()


def dryrun_multichip(n_ranks: int) -> str:
    """One sharded train step and a sharded DDIM-5 over n gloo ranks on the
    CPU; raises if the loss or the samples are not finite or a rank holds
    no rows. Prints and returns the OK line."""
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    mp.start_processes(_rank, args=(n_ranks, port, results), nprocs=n_ranks, join=True,
                       start_method="spawn")
    mesh, batch_size, loss, n_finite, n_rows = results.get()
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss} in the multichip dryrun")
    if n_finite != n_ranks:
        raise RuntimeError(f"non-finite samples on {n_ranks - n_finite} of {n_ranks} ranks")
    if n_rows != batch_size * mesh["model"]:
        raise RuntimeError(f"the ranks sampled {n_rows} rows, not {batch_size} on each of "
                           f"{mesh['model']} model ranks")
    line = (f"dryrun_multichip OK: mesh={mesh}, batch={batch_size}, loss={loss:.4f}, "
            f"ddim5 sharded over {n_ranks} ranks ({mesh['data']} row blocks)")
    print(line, flush=True)
    return line


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
