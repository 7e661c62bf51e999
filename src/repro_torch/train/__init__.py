"""Training (mirrors ``repro.train``): AdamW with the warmup-cosine
schedule, the train step with microbatch accumulation, and flat-npz
checkpoints with the reference's keys."""
