"""The user-stage scripts of the port (twins of the JAX package's scripts/),
each run as ``python -m avatarclip_torch.scripts.<name>``: on the card
unless ``--device cpu`` is given."""
