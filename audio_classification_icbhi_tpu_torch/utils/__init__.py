"""Config, device and checkpoint helpers."""
