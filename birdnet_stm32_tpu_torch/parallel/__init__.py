"""Train and eval steps, and data-parallel training over torch.distributed
(port of birdnet_stm32_tpu/parallel: steps.py, distributed.py, mesh.py)."""
