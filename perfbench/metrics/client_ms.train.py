"""The clients' device time a round (``core/cpsl.py``): the program's
spans ``cpsl.client_fwd``, ``cpsl.client_bwd`` (from the smashed data's
gradient on) and ``cpsl.client_opt``, in ms a traced round."""
from perfbench.harness.spans import per_round_ms

NAMES = ("cpsl.client_fwd", "cpsl.client_bwd", "cpsl.client_opt")


def read(rec):
    return per_round_ms(rec, NAMES, "cpsl.round")
