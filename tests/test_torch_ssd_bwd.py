"""K2's backward kernel on the CPU: the kernel's decomposition
(``ref.ssd_bwd_ref``) against ``ssd_chunked``'s gradient, the wrapper's
checks and refusals, its ``meta`` path (what it allocates and the call it
reports), the launch counter, and the Function's choice: the plain
recompute for CPU and float32 tensors, the wrapper for bf16 on ``meta``. The CUDA kernel itself is
tested on the card by ``tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

from repro_torch import telemetry
from repro_torch.kernels.ssd import bwd
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.kernel import chunk_len
from repro_torch.kernels.ssd.bwd import bwd_chunk
from repro_torch.kernels.ssd.ref import ssd_bwd_ref
from repro_torch.models import mamba2 as mb

BF = torch.bfloat16
# the decomposition is f32; the gradient it is held to, f64
REF_TOL = 5e-5


def _inputs(seed, B_, S, H, G, P, N, dtype=torch.float64, device="cpu"):
    """x, dt, A, Bm, Cm, gy, ghT: x, B, C and gy in ``dtype``, the rest
    in f32 (f64 where ``dtype`` is f64)."""
    rng = np.random.default_rng(seed)
    f = torch.float64 if dtype == torch.float64 else torch.float32

    def t(a, d):
        return torch.as_tensor(a).to(device=device, dtype=d)

    x = t(rng.standard_normal((B_, S, H, P)), dtype)
    dt = t(np.log1p(np.exp(rng.standard_normal((B_, S, H)) - 1.0)), f)
    A = t(-np.exp(0.3 * rng.standard_normal(H)), f)
    Bm = t(0.5 * rng.standard_normal((B_, S, G, N)), dtype)
    Cm = t(0.5 * rng.standard_normal((B_, S, G, N)), dtype)
    gy = t(rng.standard_normal((B_, S, H, P)), dtype)
    gh = t(rng.standard_normal((B_, H, N, P)), f)
    return x, dt, A, Bm, Cm, gy, gh


def _autograd(x, dt, A, Bm, Cm, gy, gh, chunk):
    H = x.shape[2]
    ins = [a.clone().requires_grad_() for a in (x, dt, A, Bm, Cm)]
    y, hT = mb.ssd_chunked(ins[0], ins[1], ins[2],
                           mb._broadcast_groups(ins[3], H),
                           mb._broadcast_groups(ins[4], H), chunk=chunk)
    if gh is None:
        return torch.autograd.grad(y, ins, gy)
    return torch.autograd.grad((y, hT), ins, (gy, gh))


# (B, S, H, G, P, N, chunk)
REF_CASES = [
    (2, 48, 4, 2, 16, 16, 16),     # Q = 16: chunks of 16 run as one of 48
    (1, 130, 4, 1, 16, 32, 64),    # Q = 65 (130 = 2 x 65): 64 + 1 rows
    (1, 200, 2, 2, 16, 16, 128),   # Q = 100, G = H
    (2, 67, 2, 1, 16, 16, 256),    # Q = 67: one chunk of 64 + 3 rows
    (1, 131, 3, 3, 32, 16, 16),    # odd S: Q = 1, three chunks of 64 rows
    (1, 256, 4, 2, 16, 16, 64),    # four chunks of 64
]


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("B_,S,H,G,P,N,chunk", REF_CASES)
def test_decomposition_matches_autograd(B_, S, H, G, P, N, chunk,
                                        with_state):
    x, dt, A, Bm, Cm, gy, gh = _inputs(7, B_, S, H, G, P, N)
    gh = gh if with_state else None
    want = _autograd(x, dt, A, Bm, Cm, gy, gh, chunk)
    got = ssd_bwd_ref(x, dt, A, Bm, Cm, gy, gh, chunk=chunk_len(S, chunk))
    for name, a, b in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert a.shape == b.shape, name
        err = float((a.double() - b).abs().max() / b.abs().max())
        assert err < REF_TOL, (name, err)


def test_decomposition_stays_finite_under_large_decays():
    """dt |A| ~ 20 a step, as mamba2-2.7b's A up to 16 gives: the cumsum
    spans more than exp's range within a chunk."""
    x, dt, A, Bm, Cm, gy, gh = _inputs(8, 1, 128, 2, 1, 16, 16)
    dt = dt * 0 + 2.0
    A = A * 0 - 10.0
    want = _autograd(x, dt, A, Bm, Cm, gy, gh, 64)
    got = ssd_bwd_ref(x, dt, A, Bm, Cm, gy, gh, chunk=64)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert float((a.double() - b).abs().max()) <= REF_TOL * max(
            1.0, float(b.abs().max()))


@pytest.mark.parametrize("S,Q,Qc", [(4096, 256, 256), (4096, 128, 128),
                                    (4096, 64, 64), (200, 100, 100),
                                    (48, 16, 64), (4095, 1, 64),
                                    (4094, 2, 64), (96, 3, 63)])
def test_bwd_chunk_runs_short_chunks_together(S, Q, Qc):
    assert bwd_chunk(S, Q) == Qc


@pytest.mark.parametrize("hpg,hs", [(80, 8), (1, 1), (6, 6), (12, 6),
                                    (7, 7), (9, 3), (128, 8)])
def test_slice_heads(hpg, hs):
    assert bwd.slice_heads(hpg) == hs


def test_scratch_at_the_cells_server_shape():
    """x (4, 4096, 80, 64), one group of N = 128, Q = 256: the chunk
    states (168 MB each in f32, as many as bf16 hi + lo) and the slices'
    partial dB and dC (10 slices of 8 heads: 84 MB each) dominate."""
    n = bwd.scratch_numel(4, 4096, 80, 1, 128, 64, 256)
    assert list(n) == ["hs", "ds", "hq", "dq", "pB", "pC", "cum", "rows",
                       "dcl", "dT"]
    assert n["hs"] == n["ds"] == n["hq"] == n["dq"] == 4 * 80 * 16 * 64 * 128
    assert n["pB"] == n["pC"] == 4 * 4096 * 10 * 128
    assert n["cum"] == 4 * 80 * 4096 and n["rows"] == 3 * n["cum"]
    assert n["dcl"] == 4 * 80 * 16 * 4 and n["dT"] == 4 * 80 * 16 * 4
    assert bwd.scratch_bytes(4, 4096, 80, 1, 128, 64, 256) == 4 * sum(
        n.values())
    # the regions read by 16-byte copies start 16-byte aligned
    for S in (4096, 331, 7):
        n = bwd.scratch_numel(1, S, 3, 1, 16, 16, chunk_len(S, 256))
        offsets = np.cumsum([0] + list(n.values()))
        assert all(offsets[i] % 4 == 0 for i in range(7))


def _meta(B_=2, S=256, H=4, G=2, P=64, N=128):
    x, dt, A, Bm, Cm, gy, gh = _inputs(3, B_, S, H, G, P, N, dtype=BF,
                                       device="meta")
    return x, dt, A, Bm, Cm, gy, gh


class _Calls:
    def __init__(self):
        self.calls = []

    def custom_call(self, name, operands, results):
        self.calls.append((name, [(tuple(t.shape), t.dtype) for t in
                                  operands],
                           [(tuple(t.shape), t.dtype, t.device.type)
                            for t in results]))


@pytest.mark.parametrize("with_state", [True, False])
def test_meta_path_allocates_and_reports(with_state):
    x, dt, A, Bm, Cm, gy, gh = _meta()
    gh = gh if with_state else None
    rec = _Calls()
    telemetry.observers.append(rec)
    try:
        with telemetry.LaunchCounter() as n:
            outs = bwd.ssd_bwd(x, dt, A, Bm, Cm, gy, gh, chunk=128)
    finally:
        telemetry.observers.remove(rec)
    f32 = torch.float32
    want = [((2, 256, 4, 64), BF), ((2, 256, 4), f32), ((4,), f32),
            ((2, 256, 2, 128), BF), ((2, 256, 2, 128), BF)]
    assert [(tuple(t.shape), t.dtype) for t in outs] == want
    assert all(t.device.type == "meta" for t in outs)
    ops = [(tuple(t.shape), t.dtype) for t in (x, dt, A, Bm, Cm, gy)]
    if with_state:
        ops.append(((2, 4, 128, 64), f32))
    assert rec.calls == [("ssd_bwd", ops, [s + ("meta",) for s in want])]
    assert n["ssd_bwd"] == 0          # meta launches nothing


def _refusal_cases():
    def cpu(a):
        a = list(a)
        for i in (0, 3, 4, 5):
            a[i] = torch.zeros(a[i].shape, dtype=BF)
        for i in (1, 2):
            a[i] = torch.zeros(a[i].shape)
        a[6] = None
        return a

    def set_(i, t):
        def f(a):
            a = list(a)
            a[i] = t(a)
            return a
        return f

    def empty(shape, dtype=BF):
        return lambda a: torch.empty(shape, dtype=dtype, device="meta")

    return [
        ("cpu", cpu, ValueError, "device"),
        ("f32 x", set_(0, empty((2, 256, 4, 64), torch.float32)), TypeError,
         "bfloat16"),
        ("bf16 dt", set_(1, empty((2, 256, 4))), TypeError, "float32"),
        ("N 48", lambda a: [*a[:3], empty((2, 256, 2, 48))(a),
                            empty((2, 256, 2, 48))(a), a[5], None],
         ValueError, "N=48"),
        ("ghT shape", set_(6, empty((2, 4, 64, 128), torch.float32)),
         ValueError, "ghT"),
        ("gy shape", set_(5, empty((2, 255, 4, 64))), ValueError,
         "disagree"),
        ("H % G", lambda a: [*a[:3], empty((2, 256, 3, 128))(a),
                             empty((2, 256, 3, 128))(a), *a[5:]],
         ValueError, "disagree"),
        ("x rows", set_(0, lambda a: torch.empty(
            (2, 256, 4, 68), dtype=BF, device="meta")[..., :64]),
         ValueError, "aligned"),
        ("devices", set_(2, lambda a: torch.zeros(4)), ValueError,
         "devices"),
    ]


@pytest.mark.parametrize("case", _refusal_cases(), ids=lambda c: c[0])
def test_wrapper_refusals(case):
    _, mutate, exc, match = case
    args = mutate(_meta())
    with pytest.raises(exc, match=match):
        bwd.ssd_bwd(*args, chunk=128)


def test_wrapper_refuses_inputs_that_require_grad():
    """The kernel's gradients are not differentiable: in grad mode (a
    double backward) an input that requires grad is refused."""
    x, dt, A, Bm, Cm, gy, gh = _meta()
    with pytest.raises(RuntimeError, match="requires grad"):
        bwd.ssd_bwd(x, dt.requires_grad_(), A, Bm, Cm, gy, gh, chunk=128)
    with torch.no_grad():
        bwd.ssd_bwd(x, dt, A, Bm, Cm, gy, gh, chunk=128)


def test_wrapper_refuses_an_empty_sequence():
    x, dt, A, Bm, Cm, gy, gh = _meta(S=0)
    with pytest.raises(ValueError, match="empty"):
        bwd.ssd_bwd(x, dt, A, Bm, Cm, gy, gh, chunk=128)


def test_launch_counter_counts_backward_calls():
    n = telemetry.LaunchCounter()
    assert n["ssd_bwd"] == 0 and n["ssd"] == 0
    n.custom_call("ssd_bwd", [torch.zeros(1)], [])
    n.custom_call("ssd_bwd", [torch.zeros(1, device="meta")], [])
    assert n["ssd_bwd"] == 1 and n["ssd"] == 0
    n.reset()
    assert n["ssd_bwd"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_function_keeps_the_plain_backward_on_the_cpu(dtype, monkeypatch):
    """CPU tensors, f32 or bf16, recompute through ``ssd_chunked``: the
    Function's gradients are its gradients, bit for bit, and the kernel's
    wrapper is never called."""
    def refuse(*a, **k):
        raise AssertionError("the CPU backward reached the kernel")

    monkeypatch.setattr(ssd_ops, "ssd_bwd", refuse)
    x, dt, A, Bm, Cm, gy, gh = _inputs(5, 2, 96, 4, 2, 16, 32, dtype=dtype)
    ins = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    y, hT = ssd_ops.ssd(*ins, chunk=32)
    got = torch.autograd.grad((y, hT), ins, (gy, gh))
    want = _autograd(x, dt, A, Bm, Cm, gy, gh, 32)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", [BF, torch.float32])
def test_function_on_meta_takes_what_the_card_would(dtype, monkeypatch):
    """On ``meta`` (the dry run's shape propagation) the Function chooses
    as on the card: bf16 takes the kernel wrapper's meta path (one
    ``ssd_bwd`` call, no recompute through ``ssd_chunked``), float32 the
    plain recompute (no ``ssd_bwd`` call)."""
    chunked = mb.ssd_chunked

    def recompute(*a, **k):
        if dtype == BF:
            raise AssertionError("the bf16 meta backward recomputed")
        return chunked(*a, **k)

    monkeypatch.setattr(mb, "ssd_chunked", recompute)
    x, dt, A, Bm, Cm, gy, gh = _meta(S=64, P=16, N=16)
    x, Bm, Cm, gy = (t.to(dtype) for t in (x, Bm, Cm, gy))
    ins = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    y, hT = ssd_ops.ssd(*ins, chunk=32)
    rec = _Calls()
    telemetry.observers.append(rec)
    try:
        got = torch.autograd.grad((y, hT), ins, (gy, gh))
    finally:
        telemetry.observers.remove(rec)
    assert [g.shape for g in got] == [t.shape for t in ins]
    assert [g.dtype for g in got] == [t.dtype for t in ins]
    assert all(g.device.type == "meta" for g in got)
    assert [c[0] for c in rec.calls] == (["ssd_bwd"] if dtype == BF
                                         else [])
