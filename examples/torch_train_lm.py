"""Train a ~100M-param LM for a few hundred steps on the PyTorch port's
training substrate (optimizer, checkpointing, crash recovery); the twin
of ``examples/train_lm.py``.

The default trains a smaller variant; pass --full-100m for the full
size.  Runs on the card unless ``--device cpu`` is given.  Also
demonstrates crash recovery: run with --fail-at N, re-run, and training
resumes from the checkpoint.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300 --device cpu
"""
import argparse
import subprocess
import sys

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=300)
ap.add_argument("--arch", default="yi-9b")
ap.add_argument("--fail-at", type=int, default=0)
ap.add_argument("--full-100m", action="store_true")
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", args.arch,
       "--steps", str(args.steps), "--ckpt-dir", "out/example_torch_ckpt",
       "--device", args.device]
if not args.full_100m:
    cmd += ["--smoke", "--batch", "8", "--seq", "128"]
else:
    cmd += ["--batch", "32", "--seq", "1024"]
if args.fail_at:
    cmd += ["--fail-at", str(args.fail_at)]
print("running:", " ".join(cmd))
sys.exit(subprocess.call(cmd))
