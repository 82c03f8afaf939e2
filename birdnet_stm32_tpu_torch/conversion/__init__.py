"""Conversion (port of birdnet_stm32_tpu/conversion/): a trained model's
weights -> a TFLite flatbuffer (INT8 PTQ, dynamic-range or float), the
cosine gate against the float model and the report. The export itself needs
TensorFlow, imported inside the functions that build the graph; the gate
runs the port's integer executor on any device.
"""
