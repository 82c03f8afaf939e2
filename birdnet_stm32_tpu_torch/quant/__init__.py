"""The INT8 leg: a reader of .tflite flatbuffers and the bit-exact integer
executor of the graphs it reads (port of birdnet_stm32_tpu/quant/)."""
