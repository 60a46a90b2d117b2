"""The MoE block's torch glue as a share of the decode step's device time,
by the program's own spans: the ``moe.route`` (top-k, the dispatch plan
and dispatch; the router's linear is its ``linear`` child, not counted
here), ``moe.swiglu`` and ``moe.combine`` spans' own graph nodes, over every
graph node's device time, a step."""
from portbench import spans

LAYER = "Model (models/transformer.py, layers/)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "decode_tok_s"
BETTER = "lower"


def read(obs):
    return spans.share(obs, ("moe.route", "moe.swiglu", "moe.combine"))
