"""The benchmark's fixed arithmetic: the H100's published peaks, the
frontend kernels' least time (roofline.py, a frozen copy of
chip_smoke.py::bound) and each model's multiply-accumulates (macs.py
finds macs_<model>.py; macs_dscnn.py is a frozen copy of the port's
models/profiler.py arithmetic). Nothing here
imports the port."""
