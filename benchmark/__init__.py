"""The benchmark of `gvcnn_tf_tpu_torch` on one NVIDIA H100 (see `run.py`)."""
