"""repro_torch.train — the LM training stack: AdamW (and Adafactor) with
f32 master weights, atomic checkpoints in the JAX package's layout, and
the fault-tolerant training loop."""
