"""The rest of the model's torch work as a share of the decode step's
device time, by the program's own spans: the ``embed``, ``norm`` (every
RMSNorm), ``residual`` (the two adds a block) and ``sample`` (argmax, the
next position, the stacked tokens) spans' graph nodes, over every graph
node's device time, a step."""
from portbench import spans

LAYER = "Model (models/transformer.py, layers/)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "decode_tok_s"
BETTER = "lower"


def read(obs):
    return spans.share(obs, ("embed", "norm", "residual", "sample"))
