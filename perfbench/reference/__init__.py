"""Plain PyTorch references of the benchmark's configurations. They import
nothing of the measured program, of JAX or of the JAX package."""
