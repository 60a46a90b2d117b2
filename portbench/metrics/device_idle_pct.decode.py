"""Share of the traced replays (each with its host fetch) in which no
operation ran on the card: 100 minus the union of the device operations'
intervals."""
LAYER = "Device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "decode_tok_s"
BETTER = "lower"


def read(obs):
    if obs.driver != "decode" or obs.trace is None:
        return None
    return 100.0 * (1.0 - obs.trace.busy_s / obs.trace.window_s)
