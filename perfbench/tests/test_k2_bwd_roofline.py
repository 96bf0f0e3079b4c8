"""``k2_bwd_roofline_pct.train`` on a synthetic record: K2's backward
calls as ``kernels/ssd/bwd.py`` reports them (shapes and item sizes) and
trace sessions whose kernels sit at known durations."""
import pytest

from perfbench.harness import bench, work

B, S, H, P, G, N, CHUNK = 4, 4096, 80, 64, 1, 128, 256


def _fwd_specs():
    ops = [((B, S, H, P), 2), ((B, S, H), 4), ((H,), 4), ((B, S, G, N), 2),
           ((B, S, G, N), 2)]
    res = [((B, S, H, P), 2), ((B, H, N, P), 4)]
    return ops, res


def _bwd_specs(with_state=False):
    ops = _fwd_specs()[0] + [((B, S, H, P), 2)]
    if with_state:
        ops.append(((B, H, N, P), 4))
    res = [((B, S, H, P), 2), ((B, S, H), 4), ((H,), 4), ((B, S, G, N), 2),
           ((B, S, G, N), 2)]
    return ops, res


class Session:
    def __init__(self, phase, kernels):
        self.phase, self._k = phase, kernels

    def kernels(self):
        return [(name, 0.0, dur_us, "kernel") for name, dur_us in self._k]


def _record(calls, kernels):
    rec = bench.Record({}, {})
    rec.counters["chunk"] = CHUNK
    rec.calls = [("round", name, ops, res) for name, ops, res in calls]
    rec.sessions = [Session("round", kernels)]
    return rec


def _read(name, rec):
    return bench.load_module("metrics", name).read(rec)


def _bwd_work(ops, res):
    return bench.load_module("metrics", "k2_bwd_roofline_pct.train") \
        .bwd_work(ops, res, CHUNK)


def test_bound_of_one_call_at_the_server_shape():
    """531 MB of inputs read and gradients written once bind it: 0.158 ms
    at 3.35 TB/s, over 130 GFLOP (twice the forward's products)."""
    flops, nbytes = _bwd_work(*_bwd_specs())
    assert flops == 2 * work.ssd_work(_fwd_specs()[0], [], CHUNK)[0]
    assert flops == pytest.approx(130.1e9, rel=1e-3)
    assert nbytes == pytest.approx(530.7e6, rel=1e-3)
    assert work.bound_s(flops, nbytes) * 1e3 == pytest.approx(0.158, rel=0.01)
    # ghT, when the backward gets one, is read once more
    _, with_state = _bwd_work(*_bwd_specs(True))
    assert with_state - nbytes == B * H * N * P * 4


def test_only_backward_kernels_in_the_denominator():
    ops, res = _bwd_specs()
    bound_us = work.bound_s(*_bwd_work(ops, res)) * 1e6
    kernels = [("void ssd_bwd_key_kernel<128, 64>(Params)", 2 * bound_us),
               ("void ssd_bwd_query_kernel<128, 64>(Params)", 2 * bound_us),
               ("ssd_chain_kernel<128, 64>", 100.0 * bound_us),
               ("void at::native::elementwise_kernel", 50.0 * bound_us)]
    rec = _record([("ssd_bwd", ops, res)] * 2, kernels)
    assert _read("k2_bwd_roofline_pct.train", rec) == pytest.approx(50.0)


def test_no_backward_call_no_reading():
    """A program without the backward kernel (its parent) reports no call:
    the reader returns None and raises nothing."""
    ops, res = _fwd_specs()
    rec = _record([("ssd", ops, res)], [("ssd_chain_kernel<128, 64>", 10.0)])
    assert _read("k2_bwd_roofline_pct.train", rec) is None


def test_forward_roofline_ignores_the_backward():
    """``k2_roofline_pct.train`` reads the same with the backward's
    kernels and calls in the record as without them."""
    fops, fres = _fwd_specs()
    fwd = [("ssd", fops, fres)] * 3
    fwd_kernels = [("void ssd_chain_kernel<128, 64>", 800.0),
                   ("ssd_reset_kernel", 2.0)]
    alone = _read("k2_roofline_pct.train", _record(fwd, fwd_kernels))
    bops, bres = _bwd_specs()
    both = _read("k2_roofline_pct.train", _record(
        fwd + [("ssd_bwd", bops, bres)] * 3,
        fwd_kernels + [("void ssd_bwd_state_kernel<128, 64>", 500.0),
                       ("void ssd_bwd_scan_kernel<128, 64>", 300.0),
                       ("ssd_bwd_dt_kernel", 50.0),
                       ("ssd_bwd_reduce_kernel", 40.0)]))
    assert alone is not None and both == alone
