"""One rank of a tensor-parallel train run on the CPU, for
tests/test_torch_tensor_parallel.py; started by torch.distributed.run:

  python -m torch.distributed.run --standalone --nproc_per_node N \
      tests/torch_tp_worker.py <inputs.npz> <model axis> <out.npz>

<inputs.npz> holds the run: "config" (JSON of the model and train
sections), the initial weights as the flat flax tree under "params/...",
the global batch, and for each step i its global noise "noise_i", t "t_i"
and full-width dropout masks "mask_i_j" (one per ResnetBlock, in forward
order). Every rank takes the rows of its data coordinate. After the
steps, rank 0 writes <out.npz>: each step's loss and grad_norm, the last
step's clipped gradients, the params and the EMA (when it is on),
gathered whole, as flat flax trees ("grads/...", "params/...", "ema/..."),
the names of the sharded parameters ("tp_plan") and the (heads, S, D) of
every attention call its forwards made ("attention_shapes")."""

import json
import sys

import numpy as np
import torch

from drivescenegen_torch import ops
from drivescenegen_torch.config import MeshConfig, ModelConfig, TrainConfig
from drivescenegen_torch.diffusion import make_schedule
from drivescenegen_torch.models import UNet2D
from drivescenegen_torch.models.convert import flax_to_torch, torch_to_flax
from drivescenegen_torch.parallel import gather_state_dict, make_mesh, shard_state_dict
from drivescenegen_torch.training import create_optimizer, init_train_state, make_train_step


def main(inputs: str, model: int, out: str) -> None:
    torch.set_num_threads(1)
    shapes, inner = [], ops.attention

    def attention(q, k, v, scale):
        shapes.append(tuple(q.shape[1:]))
        return inner(q, k, v, scale)

    ops.attention = attention
    data = np.load(inputs)
    config = json.loads(str(data["config"]))
    cfg, tcfg = ModelConfig(**config["model"]), TrainConfig(**config["train"])
    mesh = make_mesh(MeshConfig(data=-1, model=model), "cpu")
    net = UNet2D(cfg, device="cpu", for_training=True, mesh=mesh)
    flat = {k[len("params/"):]: data[k] for k in data.files if k.startswith("params/")}
    net.load_state_dict(shard_state_dict(flax_to_torch(flat, cfg), mesh, net.tp_plan))
    opt, lr_fn = create_optimizer(tcfg, 10, net.parameters())
    state = init_train_state(net, opt, ema=tcfg.ema_decay > 0)
    step = make_train_step(make_schedule(device="cpu"), lr_fn, tcfg, mesh)
    batch = torch.from_numpy(data["batch"])
    rows = mesh.rows(len(batch))
    record = {}
    n_steps = sum(k.startswith("noise_") for k in data.files)
    for i in range(n_steps):
        masks = sorted((k for k in data.files if k.startswith(f"mask_{i}_")),
                       key=lambda k: int(k.rsplit("_", 1)[1]))
        state, m = step(state, batch[rows], torch.from_numpy(data[f"noise_{i}"][rows]),
                        torch.from_numpy(data[f"t_{i}"][rows]),
                        dropout_masks=[torch.from_numpy(data[k][rows]) for k in masks] or None)
        record[f"loss_{i}"] = float(m["loss"])
        record[f"grad_norm_{i}"] = float(m["grad_norm"])
    grads = gather_state_dict({n: p.grad for n, p in net.named_parameters()}, mesh, net.tp_plan)
    trees = {"grads": grads, "params": gather_state_dict(net.state_dict(), mesh, net.tp_plan)}
    if state.ema_params is not None:
        trees["ema"] = gather_state_dict(state.ema_params, mesh, net.tp_plan)
    if mesh.is_main:
        for name, tree in trees.items():
            record.update({f"{name}/{k}": v for k, v in torch_to_flax(tree).items()})
        record["tp_plan"] = np.array(sorted(net.tp_plan))
        record["attention_shapes"] = np.array(shapes)
        np.savez(out, **record)
    mesh.close()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), sys.argv[3])
