"""Training of the port (port of birdnet_stm32_tpu/training): losses,
optimizers, checkpoints, the training loop, the linear probe, the LR
finder, the tuner and distillation."""
