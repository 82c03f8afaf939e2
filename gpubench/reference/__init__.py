"""The benchmark's plain reference: what the timed path should produce,
worked out again from the inputs and weights the harness makes.

Nothing here imports the port (birdnet_stm32_tpu_torch), JAX or the JAX
package, and nothing takes a value the port made: the ingress and the
frontend are numpy in float64 (frontend.py), the float leg is the DS-CNN
written out in plain torch float32 (dscnn.py), and the INT8 leg runs the
raw .tflite file's integer graph op by op in numpy (int8.py, read by
tflite_file.py). It runs on the CPU, after the measured window, in blocks
of rows.
"""
