"""The benchmark's plain PyTorch reference of MAGI-1's DiT forward and ViT-VAE
decoder.  It imports neither jax nor the program: it draws its weights from
the run's seed again (`benchmark.weights`) and works out what the program
derived from them (its int8 tree, smooth fold, KV cache) itself."""
