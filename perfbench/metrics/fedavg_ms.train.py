"""FedAvg's device time a round (eq. 8, ``CPSL.fedavg``): the program's
span ``cpsl.fedavg``, in ms a traced round."""
from perfbench.harness.spans import per_round_ms


def read(rec):
    return per_round_ms(rec, ("cpsl.fedavg",), "cpsl.round")
