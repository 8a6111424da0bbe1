"""Data-parallel training over N ranks (twin of avatarclip_tpu/parallel/):
the 1-D data group (``mesh``) and the 1-vs-N dry run (``dryrun``)."""
