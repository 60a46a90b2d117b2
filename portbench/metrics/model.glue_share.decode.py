"""Share of the decode step's kernel time spent in kernels that are not the
port's own (not a ``__global__`` function of ``fused4bit_tpu_torch/csrc/``):
the norms, RoPE, the cache append, routing, dispatch and combine, SwiGLU
and argmax that PyTorch runs around the hand-written kernels."""
from portbench import trace

LAYER = "Model (models/transformer.py, layers/)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "decode_tok_s"
BETTER = "lower"


def read(obs):
    if obs.driver != "decode" or obs.trace is None or not obs.own_kernels:
        return None
    ks = obs.trace.kernels()
    total = sum(k.dur for k in ks)
    glue = sum(k.dur for k in ks if not trace.is_own(k.name, obs.own_kernels))
    return 100.0 * glue / total if total else None
