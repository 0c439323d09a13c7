"""Plain float32 references of the benchmark's models: plain PyTorch,
nothing of the program under test, nothing of JAX."""
