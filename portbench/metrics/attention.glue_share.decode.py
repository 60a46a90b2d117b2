"""Attention's torch glue as a share of the decode step's device time, by
the program's own spans: the ``attention.rope`` (head reshapes, RoPE) and
``attention.kv_append`` (quantizing the step's K and V into the INT4
cache) spans' graph nodes, over every graph node's device time, a step."""
from portbench import spans

LAYER = "Model (models/transformer.py, layers/)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "decode_tok_s"
BETTER = "lower"


def read(obs):
    return spans.share(obs, ("attention.rope", "attention.kv_append"))
