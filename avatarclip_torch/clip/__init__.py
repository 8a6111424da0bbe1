"""CLIP for the port; the JAX reference is avatarclip_tpu/clipjax/."""
