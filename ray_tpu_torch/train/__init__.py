"""Training on one device (counterpart of ray_tpu/train/)."""
