"""K2's backward kernel (``kernels/ssd/bwd.py``, ``csrc/ssd_bwd.cu``) over
the traced rounds: its calls' least time at the configuration's chunk
over the device time of the kernels named ``ssd_bwd_*``. A call's work is
twice the forward's products (each has two transposed products in the
backward); its bytes are every input read and every gradient written
once."""
from perfbench.harness import work
from perfbench.harness.readers import roofline_pct

KERNELS = ("ssd_bwd_",)


def bwd_work(operands, results, chunk: int):
    """(flops, bytes) of one call: operands (x, dt, A, Bm, Cm, gy[, ghT]),
    results (dx, ddt, dA, dB, dC), as (shape, itemsize) pairs."""
    flops = 2 * work.ssd_work(operands[:5], [], chunk)[0]
    return flops, work._nbytes(list(operands) + list(results))


def read(rec):
    chunk = int(rec.counters["chunk"])
    return roofline_pct(rec, "round", "ssd_bwd", KERNELS,
                        lambda ops, res: bwd_work(ops, res, chunk))
