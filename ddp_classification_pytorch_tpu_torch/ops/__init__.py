"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (`fused_abn`: K1, fused BatchNorm + LeakyReLU forward)."""
