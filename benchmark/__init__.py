"""The benchmark of avatarclip_torch: cells, drivers, metric readers, the
frozen counts and the plain reference (see run.py)."""
