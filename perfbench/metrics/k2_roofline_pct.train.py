"""K2 (the Mamba-2 SSD scan, ``kernels/ssd``) over the traced rounds: its
calls' least time at the configuration's chunk over the device time of
the kernels named below."""
from perfbench.harness import work
from perfbench.harness.readers import roofline_pct

KERNELS = ("ssd_chain_kernel", "ssd_reset_kernel", "ssd_f32_kernel")


def read(rec):
    chunk = int(rec.counters["chunk"])
    return roofline_pct(rec, "round", "ssd", KERNELS,
                        lambda ops, res: work.ssd_work(ops, res, chunk))
