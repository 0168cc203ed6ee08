"""GT scenario playback CLI (port of drivescenegen_tpu/scripts/visualize.py;
reference: utils/datasets/visualization.py __main__ :374-386): render
decoded scenario pickles as animations or stills. Host work only.

  python -m drivescenegen_torch.scripts.visualize --load_path data/preprocessed \
      --save_dir /tmp/viz --limit 3
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle


def main(argv=None):
    parser = argparse.ArgumentParser(description="Scenario visualization")
    parser.add_argument("--load_path", default="./data/preprocessed", type=str)
    parser.add_argument("--save_dir", default=None, type=str,
                        help="write GIFs/PNGs here instead of showing windows")
    parser.add_argument("--limit", default=1, type=int)
    parser.add_argument("--still", action="store_true",
                        help="single-frame PNG at t=current instead of animation")
    args = parser.parse_args(argv)

    from drivescenegen_torch.visualization import animate_scenario, visualize_scenario

    files = sorted(glob.glob(os.path.join(args.load_path, "sample_*.pkl")))
    if not files:
        raise SystemExit(f"no scenario pickles under {args.load_path}")
    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)

    for path in files[: args.limit]:
        with open(path, "rb") as f:
            info = pickle.load(f)
        name = os.path.splitext(os.path.basename(path))[0]
        if args.still:
            import matplotlib

            if args.save_dir:
                matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(8, 8))
            animate_scenario(10, 0.1, 10, info)
            if args.save_dir:
                out = os.path.join(args.save_dir, f"{name}.png")
                fig.savefig(out, dpi=120)
                print(f"saved {out}")
            else:
                plt.show()
            plt.close(fig)
        else:
            out = (
                os.path.join(args.save_dir, f"{name}.gif") if args.save_dir else None
            )
            visualize_scenario(info, t_steps=30, save_path=out)
            if out:
                print(f"saved {out}")


if __name__ == "__main__":
    main()
