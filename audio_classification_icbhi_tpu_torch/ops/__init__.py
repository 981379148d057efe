"""Front-end ops: STFT, mel, and the Hopper log-mel kernel."""
