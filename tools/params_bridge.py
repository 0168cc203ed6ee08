"""Convert a model directory's weights between the JAX package's orbax
export and the PyTorch port's params.npz.

The JAX package writes and restores `<model_dir>/params`, an orbax
StandardCheckpointer export of the flax variables
(drivescenegen_tpu/training/checkpoint.py save_params_only). The port
writes and reads `<model_dir>/params.npz`, the same tree flattened with
flax.traverse_util.flatten_dict(..., sep="/")
(drivescenegen_torch/models/convert.py). Both keep config.yaml beside the
weights, in one format. This tool carries a directory from one to the
other:

  python tools/params_bridge.py to-npz --src <jax model_dir> --dst <dir>
  python tools/params_bridge.py to-orbax --src <port model_dir> --dst <dir>

It needs numpy, JAX, orbax and flax (not torch, not either package), and
runs on the CPU. Only model directories are converted: a training
checkpoint also holds optimizer moments, which the two packages lay out
differently.
"""

from __future__ import annotations

import argparse
import os
import shutil


def _cpu_jax():
    import jax

    # Pure host work: never touch (or wait on) an accelerator.
    jax.config.update("jax_platforms", "cpu")
    return jax


def restore_orbax(path: str) -> dict:
    """The variables tree of an orbax params export, as numpy arrays. The
    restore target is built from the checkpoint's own metadata (shapes and
    dtypes) on the CPU, so a tree saved on another device topology restores
    here, and no model needs to be built."""
    jax = _cpu_jax()
    import numpy as np
    import orbax.checkpoint as ocp

    cpu = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    ckptr = ocp.StandardCheckpointer()
    try:
        meta = ckptr.metadata(path).item_metadata.tree
        target = jax.tree.map(lambda m: jax.ShapeDtypeStruct(m.shape, m.dtype, sharding=cpu), meta)
        tree = ckptr.restore(path, target)
    finally:
        ckptr.close()
    return jax.tree.map(np.asarray, tree)


def save_orbax(path: str, tree: dict) -> None:
    """Save a variables tree as JAX's save_params_only does: jax arrays
    through StandardCheckpointer, overwriting."""
    jax = _cpu_jax()
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    try:
        ckptr.save(path, jax.tree.map(jax.numpy.asarray, tree), force=True)
        ckptr.wait_until_finished()
    finally:
        ckptr.close()


def _copy_config(src: str, dst: str) -> None:
    cfg = os.path.join(src, "config.yaml")
    if os.path.exists(cfg):
        shutil.copyfile(cfg, os.path.join(dst, "config.yaml"))


def to_npz(src: str, dst: str) -> str:
    """<src>/params (orbax) -> <dst>/params.npz, written under a temporary
    name and renamed into place; config.yaml copied."""
    import numpy as np
    from flax.traverse_util import flatten_dict

    params = os.path.abspath(os.path.join(src, "params"))
    if not os.path.isdir(params):
        raise SystemExit(f"no orbax params export at {params}")
    flat = flatten_dict(restore_orbax(params), sep="/")
    os.makedirs(dst, exist_ok=True)
    out = os.path.join(dst, "params.npz")
    tmp = os.path.join(dst, f"params.{os.getpid()}.tmp.npz")
    np.savez(tmp, **flat)
    os.replace(tmp, out)
    _copy_config(src, dst)
    return out


def to_orbax(src: str, dst: str) -> str:
    """<src>/params.npz -> <dst>/params (orbax, as JAX's
    save_params_only writes it); config.yaml copied."""
    import numpy as np
    from flax.traverse_util import unflatten_dict

    npz = os.path.join(src, "params.npz")
    if not os.path.isfile(npz):
        raise SystemExit(f"no params.npz at {npz}")
    with np.load(npz) as data:
        tree = unflatten_dict({k: data[k] for k in data.files}, sep="/")
    os.makedirs(dst, exist_ok=True)
    out = os.path.abspath(os.path.join(dst, "params"))
    save_orbax(out, tree)
    _copy_config(src, dst)
    return out


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description="orbax params/ <-> params.npz")
    sub = parser.add_subparsers(dest="command", required=True)
    for name, help_ in (("to-npz", "JAX model_dir (params/) -> port model_dir (params.npz)"),
                        ("to-orbax", "port model_dir (params.npz) -> JAX model_dir (params/)")):
        p = sub.add_parser(name, help=help_)
        p.add_argument("--src", required=True)
        p.add_argument("--dst", required=True)
    args = parser.parse_args(argv)
    convert = to_npz if args.command == "to-npz" else to_orbax
    out = convert(args.src, args.dst)
    print(f"{args.command}: {args.src} -> {out}")
    return out


if __name__ == "__main__":
    main()
