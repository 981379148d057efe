"""Ops: STFT, mel, the Hopper log-mel kernels and the fused conv-block kernels."""
