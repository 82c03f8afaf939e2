"""Training of the port (port of birdnet_stm32_tpu/training): losses,
optimizers, checkpoints and the training loop."""
