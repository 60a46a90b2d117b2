"""The benchmark of fused4bit_tpu_torch on one NVIDIA H100: see run.py."""
