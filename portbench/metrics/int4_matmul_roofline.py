"""The linears' share of their roofline: the least time a decode step's
attention projections, routers and lm_head need (packed weights and scales,
x in, y out), over the linear kernels' device time per step in the trace
(``ops/int4_matmul.py``: main kernel and split pass)."""
from portbench import trace

LAYER = "Linears (ops/int4_matmul.py)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "decode_tok_s"
BETTER = "higher"


def _main(name):
    return trace.grouped_flag(name) is False


def read(obs):
    if obs.driver != "decode" or obs.trace is None or obs.work is None:
        return None
    ms = trace.family_ms(obs.trace.kernels(), _main) / obs.steps_traced
    return 100.0 * obs.work["int4_matmul"].bound_s() * 1e3 / ms if ms else None
