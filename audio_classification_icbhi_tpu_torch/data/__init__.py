"""Host-side data I/O: WAV codec and resampling."""
