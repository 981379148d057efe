"""Feature extraction shared by the serving and training steps."""
