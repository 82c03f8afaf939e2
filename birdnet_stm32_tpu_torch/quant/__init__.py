"""Quantization (port of birdnet_stm32_tpu/quant/): the INT8 leg (a reader
of .tflite flatbuffers and the bit-exact integer executor of the graphs it
reads) and quantization-aware training (fake-quant, the QAT step)."""
