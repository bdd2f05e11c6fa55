"""Model configurations: the reference's architectures and their reduced
variants, copied."""
