"""EXR codec, panoramic dataset and the analytic scene generator (numpy)."""
