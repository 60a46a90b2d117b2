"""The expert projections' share of their roofline, timed by the program's
own spans: the least time the gate, up and down products of a decode step
need (``grouped_matmul`` work over the experts the routing hit), over the
device time a step of every graph node the ``experts`` span enqueued (the
grouped kernels' passes and whatever ``MoEINT4.forward`` runs around them)."""
from portbench import spans

LAYER = "Experts (ops/grouped_matmul.py)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "decode_tok_s"
BETTER = "higher"


def read(obs):
    return spans.roofline(obs, "grouped_matmul", ("experts",))
