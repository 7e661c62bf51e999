"""Training launcher of the port (mirrors ``repro.launch.train``): one
model trained on the seeded synthetic corpus, saved as a flat-npz
checkpoint that either framework loads.  An encoder-decoder config
trains on the audio stub's frames (32 a row), as the reference's launcher
feeds them.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gptneo-1.3b \\
        --smoke --device cpu --steps 200 --batch 16 --seq 64 \\
        --out ckpt/target                                   # CPU smoke
    PYTHONPATH=src python -m repro_torch.launch.train --arch gptneo-1.3b \\
        --steps 300 --batch 16 --seq 48 --out ckpt/target   # on the card
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import configs, resolve_device
from repro_torch.bridge import seeded_model, to_jax_tree
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.frontend import audio_frame_embeds
from repro_torch.models.model import param_count
from repro_torch.train import checkpoint
from repro_torch.train.optimizer import AdamWConfig, init_state
from repro_torch.train.trainer import make_train_step, parameters


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.list_configs())
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke variant of the arch")
    ap.add_argument("--draft-scale", type=int, default=0,
                    help="use draft_variant(arch, scale) instead")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--vocab", type=int, default=0,
                    help="override vocab (synthetic data size)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = configs.get_config(args.arch)
    if args.smoke:
        cfg = configs.smoke_variant(cfg)
    if args.draft_scale:
        cfg = configs.draft_variant(cfg, args.draft_scale)
    if args.vocab:
        cfg = dataclasses.replace(cfg, vocab=args.vocab)

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  batch=args.batch, seed=1234))
    model = seeded_model(cfg, args.seed, device, trainable=True)
    print(f"[train] {cfg.name}: {param_count(model)/1e6:.1f}M params, "
          f"{args.steps} steps x (B={args.batch}, S={args.seq}) "
          f"device={device}")
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(100, args.steps // 10
                                                       + 1),
                          total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches)
    opt_state = init_state(parameters(model))
    hist = []
    t0 = time.time()
    for i, b in enumerate(data.batches(args.steps)):
        batch = {"tokens": torch.from_numpy(b["tokens"]).to(device)}
        if cfg.n_encoder_layers:
            # the audio stub's frames, 32 a row, drawn from the step index
            gen = torch.Generator(device=device).manual_seed(i)
            batch["enc_embeds"] = audio_frame_embeds(gen, args.batch, 32,
                                                     cfg.d_model)
        model, opt_state, m = step_fn(model, opt_state, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            m = {k: float(v) for k, v in m.items()}
            hist.append({"step": i, **m})
            print(f"  step {i:5d} loss={m['loss']:.4f} "
                  f"acc={m['accuracy']:.3f} lr={m['lr']:.2e} "
                  f"({time.time()-t0:.0f}s)", flush=True)
    if args.out:
        checkpoint.save(args.out, to_jax_tree(model),
                        meta={"arch": cfg.name, "smoke": args.smoke,
                              "draft_scale": args.draft_scale,
                              "vocab": cfg.vocab, "steps": args.steps,
                              "history": hist})
        print(f"[train] saved -> {args.out}.npz")
    return hist


if __name__ == "__main__":
    main()
