"""repro_torch.models — the LM serving stack (config, layers, model,
conversion from the JAX parameter tree, serving engine)."""
