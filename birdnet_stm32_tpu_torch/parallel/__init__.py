"""The train and eval steps (port of birdnet_stm32_tpu/parallel/steps.py).
The port trains on one device: there is no mesh."""
