"""Train a ~100M-parameter qwen3-family model with the PyTorch port, with
checkpointing, a simulated preemption and a restart-safe resume: the
twin of examples/train_100m.py.

It runs the port's launcher (repro_torch/launch/train.py) with sizes
picked for one card, and simulates one preemption half way.

Run:  PYTHONPATH=src python examples/torch_train_100m.py [--steps 200]
      PYTHONPATH=src python examples/torch_train_100m.py --device cpu \\
          --size smoke --steps 8 --seq 32 --batch 2      # the plain path
"""
import argparse
import shutil
import tempfile

from repro_torch.launch import train as launcher


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", default="100m", choices=["smoke", "100m"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    ckpt_dir = tempfile.mkdtemp(prefix="mcsa_torch_100m_")
    every = max(1, args.steps // 8)
    common = ["--arch", "qwen3-8b", "--size", args.size,
              "--steps", str(args.steps), "--seq", str(args.seq),
              "--batch", str(args.batch), "--ckpt-dir", ckpt_dir,
              "--ckpt-every", str(every), "--log-every",
              str(max(1, args.steps // 20)), "--device", args.device]
    try:
        print("== phase 1: train until 'preemption' at half way ==")
        launcher.main(common + ["--stop-after",
                                    str(args.steps // 2), "--resume"])
        print("\n== phase 2: restart, resume from checkpoint, finish ==")
        launcher.main(common + ["--resume"])
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
