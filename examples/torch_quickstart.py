"""Quickstart of the PyTorch/CUDA port: SQS speculative decoding in ~50
lines (the counterpart of examples/quickstart.py).

    PYTHONPATH=src python examples/torch_quickstart.py              # card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import torch

from repro_torch import configs, resolve_device
from repro_torch.bridge import seeded_model
from repro_torch.core.engine import (EdgeCloudEngine, EngineConfig,
                                     MethodConfig, summarize)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. a target LLM (cloud) and a smaller draft SLM (edge), same family,
    #    random weights from seeded generators on the device
    target_cfg = configs.smoke_variant(configs.get_config("qwen2.5-3b"))
    draft_cfg = configs.draft_variant(target_cfg, scale=2)
    target = seeded_model(target_cfg, 1, device)
    draft = seeded_model(draft_cfg, 2, device)

    # 2. pick a compression method for the edge->cloud uplink
    methods = {
        "uncompressed": MethodConfig("uncompressed"),
        "dense-QS [22]": MethodConfig("qs", ell=100),
        "K-SQS (K=16)": MethodConfig("ksqs", K=16, ell=100),
        "C-SQS (conformal)": MethodConfig("csqs", ell=100,
                                          alpha=5e-4, eta=1e-3),
    }

    gen = torch.Generator().manual_seed(0)
    prompts = torch.randint(0, target_cfg.vocab, (2, 8),
                            generator=gen).numpy()

    print(f"target={target_cfg.name}  draft={draft_cfg.name}  "
          f"V={target_cfg.vocab}  device={device}")
    for name, m in methods.items():
        engine = EdgeCloudEngine(draft_cfg, draft, target_cfg, target, m,
                                 EngineConfig(L_max=4, bit_budget=5000.0),
                                 seed=0, device=device)
        rounds, _ = engine.run(prompts, n_rounds=6)
        s = summarize(rounds)
        print(f"{name:18s} uplink={s['bits_per_batch']:9.0f} bits/batch  "
              f"accept={s['accept_rate']:.2f}  "
              f"resample={s['resampling_rate']:.2f}  "
              f"tokens/batch={s['tokens_per_batch']:.1f}")
    print("\nNote: random-init models -> low acceptance; "
          "examples/torch_train_draft_slm.py trains a pair.")


if __name__ == "__main__":
    main()
