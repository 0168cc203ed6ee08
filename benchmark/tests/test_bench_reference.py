"""The plain reference against the port's CPU path (its plain versions) in
float32 on the same inputs, at a tiny width: the UNet, the DDIM chain and
guidance, the training steps. And the control's fp8 rounding."""


import numpy as np
import pytest
import torch

from benchmark import harness, inputs
from benchmark.reference import diffusion as ref
from benchmark.reference.unet import ReferenceUNet, round_fp8
from conftest import tiny_cell

CELLS = ["dsg_ref_unet256.ddim50_b8", "dsg_cond128.cfg_ddim50_b32"]


def port_model(mcfg, weights, **kw):
    from drivescenegen_torch.config import ModelConfig
    from drivescenegen_torch.models import UNet2D

    cfg = ModelConfig(**dict(mcfg, dtype="float32"))
    model = UNet2D(cfg, device="cpu", **kw)
    model.load_state_dict(inputs.port_state_dict(model, weights))
    return model


@pytest.mark.parametrize("name", CELLS)
def test_reference_unet_matches_the_port(name):
    _, cell, config = tiny_cell(name)
    mcfg = config["model"]
    weights = inputs.make_weights(mcfg, 5, "cpu")
    model = port_model(mcfg, weights).eval()
    S, B = mcfg["sample_size"], 3
    x = torch.randn(B, S, S, mcfg["in_channels"], generator=torch.Generator().manual_seed(1))
    t = torch.tensor([0, 417, 999])
    cond = None
    if mcfg["cond_channels"]:
        cond = inputs.cond_rasters(7, 0, (B, S, S, mcfg["cond_channels"]), "cpu")
    with torch.no_grad():
        got = model(x, t, cond)
        want = ReferenceUNet(mcfg, weights)(x, t, cond)
    assert got.shape == want.shape
    assert torch.allclose(got, want, atol=2e-5 * float(want.abs().max()), rtol=0)


@pytest.mark.parametrize("name", CELLS)
def test_reference_chain_matches_the_port_sampler(name):
    from drivescenegen_torch.diffusion import ddim_sample, make_guided_denoise, make_schedule

    _, cell, config = tiny_cell(name)
    mcfg, p = config["model"], cell["params"]
    weights = inputs.make_weights(mcfg, 6, "cpu")
    net = ReferenceUNet(mcfg, weights)
    S = mcfg["sample_size"]
    x_T = inputs.x_T(6, 0, (2, S, S, mcfg["out_channels"]), "cpu")
    denoise, ref_denoise = net, net
    if p["guidance"] is not None:
        cond = inputs.cond_rasters(6, 0, (2, S, S, mcfg["cond_channels"]), "cpu")
        denoise = make_guided_denoise(net, cond, p["guidance"])
        ref_denoise = ref.guided(net, cond, p["guidance"])
    with torch.no_grad():
        got = ddim_sample(denoise, make_schedule(device="cpu"), x_T.shape,
                          torch.Generator().manual_seed(0), p["steps"], eta=0.0,
                          spacing="leading", x_T=x_T)
        want = ref.ddim_chain(ref_denoise, x_T, p["steps"])
    # float32 order of summation only (guidance runs both branches as one
    # batch in the port, two in the reference): 1e-4 after the chain's
    # 1/sqrt(alpha_bar) gains, where a wrong timestep reads 0.1 or more.
    assert torch.allclose(got, want, atol=1e-3)


def test_reference_train_steps_match_the_port():
    """Three steps of the port's trainer in float32 on the CPU against the
    reference's: losses, the first clipped gradient, the parameters."""
    from drivescenegen_torch.config import DiffusionConfig, TrainConfig
    from drivescenegen_torch.diffusion import make_schedule
    from drivescenegen_torch.training import create_optimizer, init_train_state, make_train_step

    _, cell, config = tiny_cell("dsg_ref_unet256.train_b14")
    mcfg, tcfg = config["model"], config["train"]
    kind = harness.traffic_module("train")
    run = kind.Cell(cell, config, 9, "cpu")
    run.make_inputs()
    want = run.reference_steps()

    model = port_model(mcfg, run.weights, for_training=True)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt, lr = create_optimizer(TrainConfig(**tcfg), 100, model.parameters())
    state = init_train_state(model, opt)
    step = make_train_step(make_schedule(DiffusionConfig(), device="cpu"), lr, TrainConfig(**tcfg))
    order = np.random.default_rng(inputs.order_seed(9)).permutation(run.p["corpus"])
    losses = []
    for i in range(3):
        rows = order[i * run.B:(i + 1) * run.B]
        noise, t = inputs.step_noise(9, i, run.B, run.sample_shape, "cpu")
        state, m = step(state, torch.from_numpy(run.corpus[rows]), noise=noise, t=t)
        losses.append(float(m["loss"]))
        if i == 0:
            first = {n: opt.state[p]["exp_avg"] / 0.1 for n, p in model.named_parameters()}
            norms = {k: float(v.norm()) for k, v in kind.as_flat_tree(first).items()}
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-5)
    for k, v in want["grad_norms"].items():
        assert norms[k] == pytest.approx(v, rel=1e-3, abs=1e-6 * max(want["grad_norms"].values()))
    change = kind.as_flat_tree({n: p.detach() - start[n] for n, p in model.named_parameters()})
    for k, v in want["change"].items():
        assert torch.allclose(change[k], v, atol=2e-8), k


def test_round_fp8_is_float8_with_a_scale_and_passes_the_gradient():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0)) * 3e-3
    q = round_fp8(x)
    assert (q - x).abs().max() <= x.abs().max() * 2.0 ** -4
    assert not torch.equal(q, x)
    xg = x.clone().requires_grad_(True)
    round_fp8(xg).sum().backward()
    assert torch.equal(xg.grad, torch.ones_like(x))


def test_warmup_lr_is_optax_linear_schedule():
    assert ref.warmup_lr(0, 1e-5, 500) == 0.0
    assert ref.warmup_lr(2, 1e-5, 500) == pytest.approx(4e-8, rel=1e-6)
    with pytest.raises(ValueError):
        ref.warmup_lr(500, 1e-5, 500)
