"""repro_torch.data — the LM training corpus: multilayer random walks
over a population network, and a synthetic token stream."""
