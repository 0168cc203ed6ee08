"""Tensor parallelism in the port (parallel/mesh.py, models/unet2d.py,
training/) on the CPU over gloo, against the JAX package.

- The rules: the port's param_shardings gives, on the trees of
  tests/test_mesh.py's four rule tests and on the dryrun config's whole
  flax tree, the sharded dimension drivescenegen_tpu's param_shardings
  gives on the (4, 2) mesh, with the same fallback warning and the same
  silence; tp_plan's torch dimensions; shard and gather (Split) exact.
- Three train steps (dropout 0.1, EMA on) at model 2 on 2 ranks, 2 x 2 on
  4 ranks and model 4 on 4 ranks (the ResnetBlocks and the attention fall
  back to replication there: 2 groups and 2 heads do not divide 4; the
  time MLP stays sharded), fed the JAX step's own noise, t and dropout
  masks, against the JAX package's step on the (2, 2) mesh built as
  __graft_entry__.dryrun_multichip builds it, and against the port's
  one-process step.
(The CLIs at model 2: tests/test_torch_tp_cli.py.)

Tolerance: f32 everywhere, so the steps differ only in the order of the
sums (the all_reduces, and cuDNN's against XLA's convs): loss, grad_norm,
params, EMA and the last step's clipped gradients within TOL = 1e-5. The
lr is config-3's 1e-5: Adam's first update of an element is
lr * g / (|g| + eps), so a gradient near 0 whose rounding differs can move
an element by up to 2 lr a step from one side to the other; at 1e-5 three
steps keep that within the bound (at 1e-4 one element of the one-process
comparison moved 1.05e-5)."""

import json
import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from jax.sharding import NamedSharding, PartitionSpec as P

from drivescenegen_torch.config import ModelConfig, TrainConfig
from drivescenegen_torch.diffusion import make_schedule
from drivescenegen_torch.models import DropoutMasks, UNet2D
from drivescenegen_torch.models.convert import flax_to_torch, torch_to_flax
from drivescenegen_torch.parallel import Mesh, Split, param_shardings, shard_state_dict, tp_plan
from drivescenegen_torch.training import create_optimizer, init_train_state, make_train_step
from drivescenegen_tpu.config import DiffusionConfig as JaxDiffusionConfig
from drivescenegen_tpu.config import MeshConfig as JaxMeshConfig
from drivescenegen_tpu.config import ModelConfig as JaxModelConfig
from drivescenegen_tpu.config import TrainConfig as JaxTrainConfig
from drivescenegen_tpu.diffusion import make_schedule as jax_make_schedule
from drivescenegen_tpu.models import UNet2D as JaxUNet2D
from drivescenegen_tpu.parallel import make_mesh as jax_make_mesh
from drivescenegen_tpu.parallel import param_shardings as jax_param_shardings
from drivescenegen_tpu.parallel import shard_batch as jax_shard_batch
from drivescenegen_tpu.training import create_optimizer as jax_create_optimizer
from drivescenegen_tpu.training import make_train_step as jax_make_train_step
from drivescenegen_tpu.training.trainer import TrainState as JaxTrainState

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIST_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
# __graft_entry__.dryrun_multichip's tiny config, with dropout on.
DRYRUN = dict(sample_size=16, block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=2,
              attention_head_dim=8, dtype="float32")
MODEL = dict(DRYRUN, dropout=0.1)
TRAIN = dict(batch_size=4, learning_rate=1e-5, lr_warmup_steps=0, ema_decay=0.999)
TOL = 1e-5
STEPS = 3


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _jax_dim(spec):
    return spec.index("model") if "model" in spec else None


# tests/test_mesh.py's trees (test_param_shardings_tp_rules,
# _conv_tp_rules, _uneven_falls_back, _even_logs_nothing).
MESH_TREES = {
    "tp_rules": {
        "mid_attn": {"qkv": {"kernel": (64, 192)}},
        "time_mlp": {"dense1": {"kernel": (64, 256)}, "dense2": {"kernel": (256, 256)}},
        "conv_in": {"kernel": (3, 3, 3, 64)},
    },
    "conv_tp_rules": {
        "down_0_res_0": {
            "conv1": {"kernel": (3, 3, 8, 16), "bias": (16,)},
            "conv2": {"kernel": (3, 3, 16, 16), "bias": (16,)},
            "time_proj": {"kernel": (32, 16), "bias": (16,)},
            "norm2": {"scale": (16,), "bias": (16,)},
            "shortcut": {"kernel": (1, 1, 8, 16)},
        },
        "down_0_downsample": {"conv": {"kernel": (3, 3, 16, 16)}},
        "conv_out": {"kernel": (3, 3, 16, 3)},
    },
    "uneven_falls_back": {"mid_attn": {"qkv": {"kernel": (64, 63)}}},
    "even_logs_nothing": {"mid_attn": {"qkv": {"kernel": (64, 64)}}},
}


def _zeros(tree):
    return {k: _zeros(v) if isinstance(v, dict) else jnp.zeros(v) for k, v in tree.items()}


@pytest.mark.parametrize("name", sorted(MESH_TREES))
def test_param_shardings_match_jax_on_the_mesh_test_trees(name, eight_devices, caplog):
    tree = MESH_TREES[name]
    jmesh = jax_make_mesh(JaxMeshConfig(data=4, model=2))
    with caplog.at_level(logging.WARNING, logger="parallel"):
        want = {k: _jax_dim(s.spec) for k, s in
                flatten_dict(jax_param_shardings(_zeros(tree), jmesh), sep="/").items()}
    jax_warned = [r.message for r in caplog.records if "replicating" in r.message]
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="parallel"):
        got = param_shardings(tree, Mesh({"data": 4, "model": 2}))
    warned = [r.message for r in caplog.records if "replicating" in r.message]
    assert got == want
    assert len(warned) == len(jax_warned) == (1 if name == "uneven_falls_back" else 0)
    if warned:
        assert "mid_attn/qkv/kernel(64, 63)" in warned[0] and "qkv" in jax_warned[0]
    assert param_shardings(tree, 1) == {k: None for k in want}


def _dryrun_flat(**overrides):
    cfg = ModelConfig(**dict(DRYRUN, **overrides))
    return cfg, torch_to_flax(UNet2D(cfg, device="cpu").state_dict())


def test_param_shardings_match_jax_on_the_dryrun_tree(eight_devices, caplog):
    """The dryrun config's whole flax tree on the (4, 2) mesh: the same
    sharded paths on the same dimension, and no warning (every sharded
    dimension, group count and head count divides 2)."""
    cfg, flat = _dryrun_flat()
    jmesh = jax_make_mesh(JaxMeshConfig(data=4, model=2))
    tree = unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    want = {k: _jax_dim(s.spec) for k, s in
            flatten_dict(jax_param_shardings(tree, jmesh), sep="/").items()}
    with caplog.at_level(logging.WARNING, logger="parallel"):
        got = param_shardings(flat, 2, cfg=cfg)
    assert got == want
    assert {k for k, d in got.items() if d is not None} == {k for k, d in want.items()
                                                           if d is not None}
    assert sum(d is not None for d in got.values()) == 67
    assert not [r for r in caplog.records if "replicating" in r.message]


def test_model_four_falls_back_by_whole_blocks(caplog):
    """At model 4 the dryrun config's 2 GroupNorm groups and 2 heads do
    not divide the axis: every ResnetBlock and the attention are
    replicated whole, named in the one warning; the time MLP, whose
    shapes divide 4, stays sharded. JAX shards all 67 tensors there."""
    cfg, flat = _dryrun_flat()
    with caplog.at_level(logging.WARNING, logger="parallel"):
        got = param_shardings(flat, 4, cfg=cfg)
    sharded = {k for k, d in got.items() if d is not None}
    assert sharded == {"params/time_mlp/dense1/kernel", "params/time_mlp/dense1/bias",
                       "params/time_mlp/dense2/kernel"}
    (msg,) = [r.message for r in caplog.records if "replicating" in r.message]
    assert msg.startswith("TP: 64 param(s)")
    assert "params/mid_attn/qkv/kernel(16, 48)" in msg
    assert "params/up_0_res_1/shortcut/kernel(1, 1, 24, 16)" in msg


def test_tp_plan_maps_the_flax_dimensions_to_torch_and_shards_exactly():
    """tp_plan in the torch layout (HWIO dim -1 -> OIHW 0, -2 -> 1; [I, O]
    -> [O, I]); qkv split by heads within q, k and v; shard_state_dict's
    pieces joined in rank order give the full tensors bit for bit."""
    cfg = ModelConfig(**DRYRUN)
    full = UNet2D(cfg, device="cpu", generator=torch.Generator().manual_seed(4)).state_dict()
    plan = tp_plan({k: v.shape for k, v in full.items()}, 2, cfg)
    assert plan["down_0_res_0.conv1.weight"] == Split(0)
    assert plan["down_0_res_0.conv2.weight"] == Split(1)
    assert plan["up_0_res_1.shortcut.weight"] == Split(1)
    assert plan["down_0_res_0.time_proj.weight"] == Split(0)
    assert plan["time_mlp.dense2.weight"] == Split(1)
    assert plan["mid_attn.qkv.weight"] == Split(0, 3) == plan["mid_attn.qkv.bias"]
    assert "mid_attn.proj_out.bias" not in plan and "down_0_res_0.norm1.weight" not in plan
    shards = [shard_state_dict(full, Mesh({"data": 1, "model": 2}, r, 2), plan) for r in (0, 1)]
    qkv = full["mid_attn.qkv.weight"]  # [3C, C]: q rows, k rows, v rows
    assert torch.equal(shards[1]["mid_attn.qkv.weight"],
                       torch.cat([qkv[8:16], qkv[24:32], qkv[40:48]]))
    for k, v in full.items():
        if k in plan:
            assert shards[0][k].shape[plan[k].dim] * 2 == v.shape[plan[k].dim]
            assert torch.equal(plan[k].join([s[k] for s in shards]), v), k
        else:
            assert all(s[k] is v for s in shards)


def test_ranks_are_laid_out_as_jax_lays_out_its_devices():
    """reshape(data, model): rank = d * model + m; both ranks of a model
    group hold their data coordinate's rows."""
    ranks = [Mesh({"data": 2, "model": 2}, rank=r, world=4) for r in range(4)]
    assert [(m.data_index, m.model_index) for m in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [m.rows(8) for m in ranks] == [slice(0, 4), slice(0, 4), slice(4, 8), slice(4, 8)]


def test_dropout_masks_take_the_rank_columns_of_the_full_width_draw():
    """A channel shard draws the full-width mask and keeps its columns, so
    the tp ranks' masks are the one process's."""
    h = torch.ones(2, 4, 4, 6)
    whole = DropoutMasks(0.5, torch.Generator().manual_seed(1)).apply(h)
    parts = [DropoutMasks(0.5, torch.Generator().manual_seed(1)).apply(
        h[..., 3 * r:3 * r + 3], slice(3 * r, 3 * r + 3), 6) for r in (0, 1)]
    assert torch.equal(torch.cat(parts, dim=-1), whole)
    given = [torch.rand(2, 4, 4, 6) < 0.5]
    assert torch.equal(DropoutMasks(0.5, masks=given).apply(h[..., 3:], slice(3, 6), 6),
                       torch.where(given[0][..., 3:], h[..., 3:] / 0.5, 0.0))


def _jax_draws(key, step, shape):
    """The noise and t the JAX train step draws at `step`
    (drivescenegen_tpu/training/trainer.py:102-116)."""
    noise_key, t_key, _, _ = jax.random.split(jax.random.fold_in(key, step), 4)
    return (np.asarray(jax.random.normal(noise_key, shape, jnp.float32)),
            np.asarray(jax.random.randint(t_key, (shape[0],), 0, 1000)))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory, eight_devices):
    """The JAX package's train step on the (2, 2) mesh (params by its TP
    rules, the batch over "data"), three steps with dropout 0.1, its
    dropout masks caught at jax.random.bernoulli while the step traces;
    the weights are the port's init (a JAX init outside jit compiles op by
    op). Returns the run's inputs, written as tests/torch_tp_worker.py
    reads them, and its results."""
    cfg = ModelConfig(**MODEL)
    init = torch_to_flax(UNet2D(cfg, device="cpu", for_training=True,
                                generator=torch.Generator().manual_seed(0)).state_dict())
    params = unflatten_dict({k: jnp.asarray(v) for k, v in init.items()}, sep="/")
    jmodel = JaxUNet2D(JaxModelConfig(**MODEL))
    tx, lr = jax_create_optimizer(JaxTrainConfig(**TRAIN), total_steps=10)
    mesh = jax_make_mesh(JaxMeshConfig(data=2, model=2), devices=jax.devices()[:4])
    shardings = jax_param_shardings(params, mesh)
    rep = NamedSharding(mesh, P())
    opt_state = tx.init(params)
    state = JaxTrainState(
        params=jax.device_put(params, shardings),
        opt_state=jax.device_put(opt_state, jax.tree.map(lambda _: rep, opt_state)),
        step=jax.device_put(jnp.zeros((), jnp.int32), rep),
        ema_params=jax.device_put(params, shardings))
    placement = jax.tree.map(lambda a: a.sharding, state)
    batch = (np.random.default_rng(7).normal(size=(4, 16, 16, 3)) * 0.5).astype(np.float32)
    jbatch = jax_shard_batch(mesh, jnp.asarray(batch))
    step = jax_make_train_step(jmodel, jax_make_schedule(JaxDiffusionConfig()), tx, lr,
                               ema_decay=TRAIN["ema_decay"])
    caught, draw = [], jax.random.bernoulli

    def recording(*a, **kw):
        m = draw(*a, **kw)
        caught.append(m)
        return m

    def with_masks(state, batch, key):
        caught.clear()
        return step(state, batch, key), list(caught)

    key = jax.random.key(2)
    inputs = {"config": json.dumps({"model": MODEL, "train": TRAIN}), "batch": batch}
    inputs.update({f"params/{k}": v for k, v in init.items()})
    metrics = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", recording)
        jstep = jax.jit(with_masks)
        for i in range(STEPS):
            inputs[f"noise_{i}"], inputs[f"t_{i}"] = _jax_draws(key, i, batch.shape)
            (state, m), masks = jstep(state, jbatch, key)
            state = jax.device_put(state, placement)  # the next call reuses the trace
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            assert len(masks) == 8 and all(mk.dtype == bool for mk in masks)
            inputs.update({f"mask_{i}_{j}": np.asarray(mk) for j, mk in enumerate(masks)})
    path = str(tmp_path_factory.mktemp("tp") / "inputs.npz")
    np.savez(path, **inputs)
    return dict(path=path, inputs=inputs, metrics=metrics, params=_flat(state.params),
                ema=_flat(state.ema_params))


@pytest.fixture(scope="module")
def one_process(jax_run):
    """The port's one-process step on the same weights and draws."""
    inputs = jax_run["inputs"]
    cfg, tcfg = ModelConfig(**MODEL), TrainConfig(**TRAIN)
    net = UNet2D(cfg, device="cpu", for_training=True)
    net.load_state_dict(flax_to_torch({k[7:]: v for k, v in inputs.items()
                                       if k.startswith("params/")}, cfg))
    opt, lr_fn = create_optimizer(tcfg, 10, net.parameters())
    state = init_train_state(net, opt, ema=True)
    step = make_train_step(make_schedule(device="cpu"), lr_fn, tcfg)
    out = {}
    for i in range(STEPS):
        masks = [torch.tensor(inputs[f"mask_{i}_{j}"]) for j in range(8)]
        state, m = step(state, torch.tensor(inputs["batch"]), torch.tensor(inputs[f"noise_{i}"]),
                        torch.tensor(inputs[f"t_{i}"]), dropout_masks=masks)
        out[f"loss_{i}"], out[f"grad_norm_{i}"] = float(m["loss"]), float(m["grad_norm"])
    for name, tree in (("grads", {n: p.grad for n, p in net.named_parameters()}),
                       ("params", net.state_dict()), ("ema", state.ema_params)):
        out.update({f"{name}/{k}": v for k, v in torch_to_flax(tree).items()})
    return out


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [ROOT, os.environ.get("PYTHONPATH")])))
    for k in DIST_ENV:
        env.pop(k, None)
    return env


def _torchrun(args, n, timeout=300):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(n), *args]
    out = subprocess.run(cmd, cwd=ROOT, env=_env(), capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, (out.stdout + out.stderr)[-4000:]
    return out.stdout + out.stderr


def _tree_diff(got, want, name):
    keys = [k for k in want if k.startswith(name + "/")]
    assert keys and all(k in got for k in keys)
    return max(float(np.abs(got[k] - want[k]).max()) for k in keys)


def test_one_process_step_matches_jax_on_its_draws(jax_run, one_process):
    """The reference the tensor-parallel runs are held to, held to JAX."""
    for i, (loss, gnorm) in enumerate(jax_run["metrics"]):
        assert abs(one_process[f"loss_{i}"] - loss) <= TOL
        assert abs(one_process[f"grad_norm_{i}"] - gnorm) <= TOL
    got = {k: v for k, v in one_process.items()}
    want = {f"params/{k}": v for k, v in jax_run["params"].items()}
    want.update({f"ema/{k}": v for k, v in jax_run["ema"].items()})
    assert _tree_diff(got, want, "params") <= TOL
    assert _tree_diff(got, want, "ema") <= TOL


@pytest.mark.parametrize("n,model,n_sharded", [(2, 2, 67), (4, 2, 67), (4, 4, 3)],
                         ids=["1x2", "2x2", "1x4"])
def test_tensor_parallel_steps_match_jax_and_one_process(jax_run, one_process, tmp_path, n,
                                                         model, n_sharded):
    out = str(tmp_path / "out.npz")
    log = _torchrun([os.path.join(ROOT, "tests", "torch_tp_worker.py"), jax_run["path"],
                     str(model), out], n)
    assert ("replicating" in log) == (model == 4)
    got = dict(np.load(out))
    assert len(got["tp_plan"]) == n_sharded
    for i, (loss, gnorm) in enumerate(jax_run["metrics"]):
        for want_loss, want_gnorm in ((loss, gnorm), (one_process[f"loss_{i}"],
                                                      one_process[f"grad_norm_{i}"])):
            assert abs(float(got[f"loss_{i}"]) - want_loss) <= TOL, i
            assert abs(float(got[f"grad_norm_{i}"]) - want_gnorm) <= TOL, i
    jax_trees = {f"params/{k}": v for k, v in jax_run["params"].items()}
    jax_trees.update({f"ema/{k}": v for k, v in jax_run["ema"].items()})
    for name in ("params", "ema"):
        assert _tree_diff(got, jax_trees, name) <= TOL, name
        assert _tree_diff(got, one_process, name) <= TOL, name
    assert _tree_diff(got, one_process, "grads") <= TOL
