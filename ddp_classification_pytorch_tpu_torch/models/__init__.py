"""Models of the port: TResNet-M (`tresnet`), the factory, and the weight
converter from the JAX package's flax trees (`convert`)."""
