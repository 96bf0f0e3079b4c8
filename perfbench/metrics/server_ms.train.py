"""The server's device time a round (``core/cpsl.py``): the program's
spans ``cpsl.server_fwd``, ``cpsl.server_bwd`` (to the smashed data's
gradient) and ``cpsl.server_opt``, in ms a traced round."""
from perfbench.harness.spans import per_round_ms

NAMES = ("cpsl.server_fwd", "cpsl.server_bwd", "cpsl.server_opt")


def read(rec):
    return per_round_ms(rec, NAMES, "cpsl.round")
