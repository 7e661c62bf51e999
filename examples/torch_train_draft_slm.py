"""Train a draft SLM and a target LLM pair with the PyTorch/CUDA port
(the counterpart of examples/train_draft_slm.py): the GPT-Neo-shaped pair
of the paper at smoke scale on the synthetic corpus, checkpoints that
``repro_torch.launch.serve --target-ckpt/--draft-ckpt`` (or the
reference) loads.

    PYTHONPATH=src python examples/torch_train_draft_slm.py --steps 300
    PYTHONPATH=src python examples/torch_train_draft_slm.py --device cpu \\
        --steps 20
"""
import argparse
import os
import subprocess
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gptneo-1.3b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=48)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default="experiments/ckpt_torch")
    args = ap.parse_args(argv)

    for role, extra, steps in [
        ("target", ["--smoke"], args.steps),
        ("draft", ["--smoke", "--draft-scale", "2"], max(args.steps // 2,
                                                         1)),
    ]:
        cmd = [sys.executable, "-m", "repro_torch.launch.train",
               "--arch", args.arch, *extra, "--device", args.device,
               "--steps", str(steps), "--batch", str(args.batch),
               "--seq", str(args.seq),
               "--out", os.path.join(args.out, f"{args.arch}-{role}")]
        print("+", " ".join(cmd), flush=True)
        subprocess.run(cmd, check=True)
    print(f"checkpoints in {args.out}/ -- serve them with "
          "python -m repro_torch.launch.serve --target-ckpt ... "
          "--draft-ckpt ...")


if __name__ == "__main__":
    main()
