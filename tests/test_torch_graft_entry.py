"""The port's counterparts of __graft_entry__.py (drivescenegen_torch/
graft_entry.py): the multichip dryrun on gloo ranks on the CPU, DP x TP at
4 ranks and pure DP at 3, and the flagship forward of entry() on the
CPU."""

import os
import subprocess
import sys

import pytest
import torch

from drivescenegen_torch import graft_entry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIST_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@pytest.mark.parametrize("n,mesh,batch", [(4, "{'data': 2, 'model': 2}", 4),
                                          (3, "{'data': 3, 'model': 1}", 6)])
def test_dryrun_multichip_prints_its_ok_line(n, mesh, batch):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [ROOT, os.environ.get("PYTHONPATH")])))
    for k in DIST_ENV:
        env.pop(k, None)
    out = subprocess.run([sys.executable, "-m", "drivescenegen_torch.graft_entry", str(n)],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, (out.stdout + out.stderr)[-3000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("dryrun_multichip OK")]
    assert len(lines) == 1, out.stdout
    assert lines[0].startswith(f"dryrun_multichip OK: mesh={mesh}, batch={batch}, loss=")
    assert lines[0].endswith(f"ddim5 sharded over {n} ranks ({n // (2 if n == 4 else 1)} "
                             "row blocks)")


def test_dryrun_mesh_is_dp_x_tp_for_even_counts_from_four():
    assert graft_entry.dryrun_mesh(8) == dict(data=4, model=2)
    assert graft_entry.dryrun_mesh(2) == dict(data=2, model=1)
    assert graft_entry.dryrun_mesh(5) == dict(data=5, model=1)


def test_entry_on_the_cpu_gives_a_finite_flagship_forward():
    fn, (x, t) = graft_entry.entry(device="cpu")
    assert x.shape == (1, 256, 256, 3) and t.shape == (1,)
    out = fn(x, t)
    assert out.shape == (1, 256, 256, 3) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
