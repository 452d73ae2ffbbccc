__version__ = "0.1.0"  # the JAX package's, whose artifacts and checkpoints the port reads
