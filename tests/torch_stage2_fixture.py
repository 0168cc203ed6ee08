"""The stage-2 fixture in tests/fixtures/torch_stage2/: four 256x256 rasters
of synthetic scenes (the JAX package's rasterize_scenario on
make_synthetic_scenario(seed, rich=seed % 2 == 1), seeds 0-3, map range
80 m) and expected.npz, the JAX package's vectorize() of those PNGs with
the default VectorizeConfig, as the vectorization CLI runs it.

expected.npz holds, for image i (the sorted PNGs' order):
  lane_<i>_<k>   float64 [N, 6], the k-th lane polyline in world metres
  agents_<i>     float64 [M, 9], the agent boxes
  nodes_<i>      int64 [V, 2], the directed graph's nodes in insertion order
  edges_<i>      int64 [E, 4], its edges (u, v) in insertion order
  n_lanes        int64 [4]

The fixture is read by tests/test_torch_stage2.py, which also rebuilds it
with JAX and compares, and by chip_smoke.py, which imports no JAX.

  python tests/torch_stage2_fixture.py    # rewrite the fixture (needs JAX)
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

SEEDS = (0, 1, 2, 3)
RES, MAP_RANGE = 256, 80.0
FIXTURE = Path(__file__).resolve().parent / "fixtures" / "torch_stage2"


def png_name(seed: int) -> str:
    return f"scene_{seed:02d}.png"


def jax_rasters() -> np.ndarray:
    """uint8 [4, 256, 256, 3]: the rasters, quantized as the JAX
    rasterization CLI writes its PNGs (clip(x * 255).astype(uint8))."""
    from drivescenegen_tpu.data.preprocess import decode_scenario
    from drivescenegen_tpu.data.synthetic import make_synthetic_scenario
    from drivescenegen_tpu.ops.raster import rasterize_scenario

    out = []
    for seed in SEEDS:
        info = decode_scenario(make_synthetic_scenario(seed, rich=seed % 2 == 1))
        img = rasterize_scenario(info, img_res=RES, map_range=MAP_RANGE)
        out.append(np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8))
    return np.stack(out)


def record(results) -> dict:
    """The arrays of expected.npz from [(lanes, graph, agents), ...]."""
    rec = {"n_lanes": np.array([len(lanes) for lanes, _, _ in results], np.int64)}
    for i, (lanes, graph, agents) in enumerate(results):
        for k, lane in enumerate(lanes):
            rec[f"lane_{i}_{k}"] = np.asarray(lane, np.float64)
        rec[f"agents_{i}"] = np.asarray(agents, np.float64).reshape(-1, 9)
        rec[f"nodes_{i}"] = np.asarray(list(graph.nodes), np.int64).reshape(-1, 2)
        rec[f"edges_{i}"] = np.asarray([(*u, *v) for u, v in graph.edges], np.int64).reshape(-1, 4)
    return rec


def vectorize_record(vectorize, png_paths, vcfg) -> dict:
    """record() of vectorize (either package's) on the PNGs, with vcfg."""
    from PIL import Image

    results = []
    for path in png_paths:
        lanes, graph, agents, _ = vectorize(Image.open(path).convert("RGB"), method=vcfg.method,
                                            map_range=vcfg.map_range, vcfg=vcfg)
        results.append((lanes, graph, agents))
    return record(results)


def write() -> None:
    from PIL import Image

    from drivescenegen_tpu.config import VectorizeConfig
    from drivescenegen_tpu.scripts.vectorization import vectorize

    FIXTURE.mkdir(parents=True, exist_ok=True)
    paths = []
    for seed, img in zip(SEEDS, jax_rasters()):
        paths.append(FIXTURE / png_name(seed))
        Image.fromarray(img).save(paths[-1], optimize=True)
    rec = vectorize_record(vectorize, paths, VectorizeConfig())
    np.savez_compressed(FIXTURE / "expected.npz", **rec)
    for p in sorted(FIXTURE.iterdir()):
        print(f"{p.name}: {os.path.getsize(p)} bytes")
    print(f"lanes per image {rec['n_lanes'].tolist()}, agents per image "
          f"{[len(rec[f'agents_{i}']) for i in range(len(SEEDS))]}")


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(FIXTURE.parent.parent.parent))
    import jax

    jax.config.update("jax_platforms", "cpu")
    write()
