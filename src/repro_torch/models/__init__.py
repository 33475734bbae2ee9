"""repro_torch.models — the LM stack (config, layers, model and its loss,
conversion to and from the JAX parameter tree, serving engine)."""
