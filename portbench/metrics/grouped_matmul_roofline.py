"""The expert projections' share of their roofline: the least time the
gate, up and down products of a decode step need (the packed weights and
scales of the experts the routing hit, each routed row in and out once),
over the grouped kernels' device time per step in the trace (first pass,
main kernel and split pass of ``ops/grouped_matmul.py``)."""
from portbench import trace

LAYER = "Experts (ops/grouped_matmul.py)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "decode_tok_s"
BETTER = "higher"


def _main(name):
    return trace.grouped_flag(name) is True or "rows_used_kernel" in name \
        or "rows_in_use_kernel" in name


def read(obs):
    if obs.driver != "decode" or obs.trace is None or obs.work is None:
        return None
    ms = trace.family_ms(obs.trace.kernels(), _main) / obs.steps_traced
    return 100.0 * obs.work["grouped_matmul"].bound_s() * 1e3 / ms if ms else None
