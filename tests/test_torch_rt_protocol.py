"""The port's rt wire format (``repro_torch.rt.protocol``) and its msgpack
codec (``repro_torch.codec``) against the reference's
(``repro.rt.protocol``, which packs with the ``msgpack`` package).

- Payloads round-trip exactly: every numpy dtype the runtime ships at
  shapes (), (3,) and (2, 3, 4), tuples (sgd's empty optimizer state),
  nested dicts with int keys, torch tensors (bfloat16 included).
- For numpy payloads the port's frames are byte-identical to the
  reference's, and each side decodes the other's.
- Framing errors raise the reference's classes with its messages.
- The codec gives ``msgpack.packb(..., use_bin_type=True)``'s bytes on
  the runtime's payloads (nil, bools, floats included) and reads float32;
  checkpoint payloads are byte-identical to msgpack's, so checkpoint
  files do not change.
"""
import msgpack
import numpy as np
import pytest
import torch

from repro.rt import protocol as rpr
from repro_torch import codec, tree
from repro_torch.checkpoint import checkpointer as tck
from repro_torch.core.splitting import make_split_model
from repro_torch.rt import protocol as pr
from repro_torch.rt.protocol import MsgType

DTYPES = ["float32", "float64", "int32", "int64", "uint8", "bool"]
SHAPES = [(), (3,), (2, 3, 4)]


def roundtrip(obj):
    return pr.decode_payload(pr.encode_payload(obj))


def _array(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    return np.asarray(rng.random(shape) * 100).astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_array_roundtrip_exact(dtype, shape):
    a = _array(dtype, shape)
    b = roundtrip({"a": a})["a"]
    assert isinstance(b, np.ndarray) and b.flags.writeable
    assert b.dtype == a.dtype and b.shape == a.shape
    assert np.array_equal(b, a)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_torch_tensor_ships_as_its_numpy_array(dtype, shape):
    """A tensor frames exactly like its numpy array (the reference can
    read a port worker's uploads) and decodes to that array."""
    a = _array(dtype, shape)
    t = torch.from_numpy(a)
    assert pr.frame(MsgType.AGG, {"dev": t}) == \
        rpr.frame(MsgType.AGG, {"dev": a})
    b = roundtrip(t)
    assert b.dtype == a.dtype and np.array_equal(b, a)


def test_float_roundtrip_is_bitwise():
    """Raw tobytes/frombuffer: NaNs, infs, denormals all survive."""
    a = np.array([np.nan, np.inf, -np.inf, 5e-324, -0.0, 1 / 3], np.float64)
    b = roundtrip(a)
    assert np.array_equal(a.view(np.uint64), b.view(np.uint64))


def test_bfloat16_tensor_roundtrip():
    """bfloat16 travels under the name "bfloat16" (an int16 view, as the
    reference's ml_dtypes arrays do) and decodes to a CPU tensor."""
    t = (torch.arange(6, dtype=torch.float32).reshape(2, 3) / 7) \
        .to(torch.bfloat16)
    b = roundtrip({"w": t})["w"]
    assert isinstance(b, torch.Tensor) and b.dtype == torch.bfloat16
    assert b.device.type == "cpu" and torch.equal(b, t)
    body = msgpack.unpackb(pr.encode_payload(t), raw=False)["__nd__"]
    assert body["dtype"] == "bfloat16" and body["shape"] == [2, 3]
    assert body["data"] == t.view(torch.int16).numpy().tobytes()


def test_np_scalars_materialize():
    out = roundtrip({"s": np.int32(7), "f": np.float64(2.5)})
    assert out["s"].dtype == np.int32 and int(out["s"]) == 7
    assert out["f"].dtype == np.float64 and float(out["f"]) == 2.5


def test_tuple_structure_survives():
    """msgpack would turn tuples into lists; optimizer states are tuples
    (sgd's is the EMPTY tuple) and tree structure must survive."""
    obj = {"empty": (), "nested": (1, (2.5, "x")), "lst": [1, (2,)]}
    out = roundtrip(obj)
    assert out["empty"] == () and isinstance(out["empty"], tuple)
    assert out["nested"] == (1, (2.5, "x"))
    assert isinstance(out["nested"][1], tuple)
    assert isinstance(out["lst"], list) and out["lst"][1] == (2,)


def test_nested_dicts_with_int_keys():
    obj = {0: {1: np.arange(3, dtype=np.int64), 2: (None, True, False)},
           -5: {"x": [0.5, -1.25, 1e300]}, 7: {}}
    out = roundtrip(obj)
    assert set(out) == {0, -5, 7} and set(out[0]) == {1, 2}
    assert np.array_equal(out[0][1], obj[0][1])
    assert out[0][2] == (None, True, False) and out[7] == {}
    assert out[-5]["x"] == [0.5, -1.25, 1e300]


def test_device_params_roundtrip_exact():
    """The payload of CLUSTER_START/AGG: lenet device params."""
    split = make_split_model("lenet", 3)
    dev = split.init_device(torch.Generator().manual_seed(0))
    out = roundtrip(dev)
    for a, b in zip(tree.leaves(dev), tree.leaves(out)):
        assert np.array_equal(a.numpy(), b) and b.dtype == a.numpy().dtype


def _payloads():
    rng = np.random.default_rng(3)
    return [
        {"device": 0},
        {},
        {"round": 3, "m": 1, "epoch": 0, "k": 2, "device": 5,
         "smashed": rng.standard_normal((4, 6, 6, 16)).astype(np.float32),
         "attempt": 1},
        {"round": 0, "m": 0, "k": 1, "members": [2, 3], "step": 4,
         "dev": {"conv1": {"b": rng.random(6).astype(np.float32),
                           "w": rng.random((5, 5, 1, 6)).astype(np.float32)}},
         "dev_opt": ()},
        {"model": "lenet", "v": 3, "lr_device": 0.05, "warmup": True,
         "device": "cpu", "data": {"n_train": 400, "data_seed": 0}},
        {"device": 1, "t": 12345.678},
        {"reason": "not expecting AGG (r0m1agg)"},
        {"round": 2, "m": 0, "qos": [{"round": 2, "device": 1,
                                      "phase": "fwd", "t_s": 0.003,
                                      "kind": "qos", "ok": None}]},
        {"s": np.int64(-3), "z": np.zeros((), np.float32),
         "u": np.arange(6, dtype=np.uint8).reshape(2, 3),
         "b": np.array([True, False]), "big": 2 ** 40, "neg": -200},
    ]


@pytest.mark.parametrize("i", range(len(_payloads())))
@pytest.mark.parametrize("mtype", [MsgType.REGISTER, MsgType.SMASHED,
                                   MsgType.AGG, MsgType.REJOIN_ACK])
def test_frames_byte_identical_to_reference(i, mtype):
    payload = _payloads()[i]
    ours, theirs = pr.frame(mtype, payload), rpr.frame(mtype, payload)
    assert ours == theirs
    # each side decodes the other's frame to the same tree
    mt_a, got_a = pr.unpack_frame(theirs)
    mt_b, got_b = rpr.unpack_frame(ours)
    assert int(mt_a) == int(mt_b) == int(mtype)
    assert pr.encode_payload(got_a) == rpr.encode_payload(got_b)


def test_frame_roundtrip():
    mtype, payload = pr.unpack_frame(
        pr.frame(MsgType.GRAD, {"g": np.zeros((4, 2), np.float32),
                                "round": 3}))
    assert mtype == MsgType.GRAD and payload["round"] == 3


# -- framing errors: the reference's classes and messages -------------------

def test_truncated_header_and_body():
    buf = pr.frame(MsgType.SMASHED, {"x": np.arange(10)})
    with pytest.raises(pr.TruncatedFrame, match="short header: 4 bytes"):
        pr.parse_header(buf[:4])
    with pytest.raises(pr.TruncatedFrame, match="body has"):
        pr.unpack_frame(buf[:-3])


def test_unknown_msg_type_and_oversize():
    hdr = pr.HEADER.pack(pr.MAGIC, pr.VERSION, 200, 0)
    with pytest.raises(pr.BadFrame, match="unknown message type 200"):
        pr.parse_header(hdr)
    hdr = pr.HEADER.pack(pr.MAGIC, pr.VERSION, int(MsgType.PLAN),
                         pr.MAX_FRAME + 1)
    with pytest.raises(pr.BadFrame, match="exceeds cap"):
        pr.parse_header(hdr)


@pytest.mark.parametrize("raw", [b"\xc1\xc1\xc1", b"\x92\x01", b"\x01\x02",
                                 b"\x81\xa6__nd__\x80"])
def test_malformed_payload_is_bad_frame(raw):
    """Invalid, truncated or trailing msgpack is BadFrame on both sides;
    so, in the port, is an array record without its fields."""
    with pytest.raises(pr.BadFrame, match="undecodable payload"):
        pr.decode_payload(raw)
    if b"__nd__" not in raw:
        with pytest.raises(rpr.BadFrame):
            rpr.decode_payload(raw)


def _errors(mod, hdr):
    with pytest.raises(mod.ProtocolError) as ei:
        mod.parse_header(hdr)
    return ei.value


@pytest.mark.parametrize("first, second", [
    (0x00, None), (0x7F, None), (None, 1), (None, -1)])
def test_errors_match_reference(first, second):
    """Bad magic and both version directions: same class, same message,
    same attributes as the reference's."""
    buf = bytearray(pr.frame(MsgType.REGISTER, {"device": 0}))
    if first is not None:
        buf[0] = first
    if second is not None:
        buf[1] = pr.VERSION + second
    hdr = bytes(buf[:pr.HEADER.size])
    ours, theirs = _errors(pr, hdr), _errors(rpr, hdr)
    assert type(ours).__name__ == type(theirs).__name__
    assert str(ours) == str(theirs)
    assert isinstance(ours, pr.VersionMismatch)
    for attr in ("magic", "peer_version", "our_version"):
        assert getattr(ours, attr, None) == getattr(theirs, attr, None)


def test_version_mismatch_is_actionable():
    buf = bytearray(pr.frame(MsgType.REGISTER, {"device": 0}))
    newer = bytes(buf[:1]) + bytes([pr.VERSION + 1]) + bytes(buf[2:])
    with pytest.raises(pr.VersionMismatch) as ei:
        pr.parse_header(newer[: pr.HEADER.size])
    e = ei.value
    assert e.peer_version == pr.VERSION + 1 and e.our_version == pr.VERSION
    assert f"v{pr.VERSION + 1}" in str(e) and f"v{pr.VERSION}" in str(e)
    assert "upgrade this side" in str(e)
    bad = bytes([0x7F]) + bytes(buf[1:])
    with pytest.raises(pr.BadMagic) as ei:
        pr.parse_header(bad[: pr.HEADER.size])
    assert ei.value.magic == 0x7F
    assert "0x7f" in str(ei.value) and f"0x{pr.MAGIC:02x}" in str(ei.value)


def test_rejoin_msg_types_are_versioned():
    assert [(m.name, int(m)) for m in MsgType] == \
        [(m.name, int(m)) for m in rpr.MsgType]
    mtype, payload = pr.unpack_frame(
        pr.frame(MsgType.REJOIN, {"device": 2, "incarnation": 1}))
    assert mtype == MsgType.REJOIN and payload["incarnation"] == 1


# -- the codec against msgpack ------------------------------------------------

@pytest.mark.parametrize("obj", [
    None, True, False, 0.0, -0.0, 1.5, -2.25e-310, float("inf"), 1e300,
    [None, True, 0.5, "x"], {"a": None, "b": [False, 3.0]},
    {1: 2, -3: {"k": 1.0}}, 2 ** 63, -2 ** 63,
], ids=repr)
def test_codec_scalars_match_msgpack(obj):
    raw = codec.packb(obj)
    assert raw == msgpack.packb(obj, use_bin_type=True)
    assert codec.unpackb(raw) == msgpack.unpackb(raw, raw=False,
                                                 strict_map_key=False)


@pytest.mark.parametrize("i", range(len(_payloads())))
def test_codec_matches_msgpack_on_rt_payloads(i):
    enc = pr._enc(_payloads()[i])
    raw = codec.packb(enc)
    assert raw == msgpack.packb(enc, use_bin_type=True)
    assert codec.unpackb(raw) == msgpack.unpackb(raw, raw=False,
                                                 strict_map_key=False)


def test_codec_reads_float32():
    raw = msgpack.packb([1.5, -0.1], use_single_float=True)
    assert raw[1] == 0xca
    assert codec.unpackb(raw) == [1.5, float(np.float32(-0.1))]


def test_checkpoint_payload_bytes_unchanged():
    """Checkpoint payloads stay msgpack's bytes, and the checkpoint codec
    still refuses the wire format's extra types."""
    state = {"step": torch.tensor(3, dtype=torch.int32),
             "dev": {"w": torch.arange(6.0).reshape(2, 3)},
             "rng": torch.tensor([1, 2], dtype=torch.int64),
             "bf": torch.ones(2, dtype=torch.bfloat16), "opt": ()}
    want = {"bf": {"dtype": "bfloat16", "shape": [2],
                   "data": torch.ones(2, dtype=torch.bfloat16)
                   .view(torch.int16).numpy().tobytes()},
            "dev/w": {"dtype": "float32", "shape": [2, 3],
                      "data": np.arange(6, dtype=np.float32).tobytes()},
            "rng": {"dtype": "int64", "shape": [2],
                    "data": np.array([1, 2], np.int64).tobytes()},
            "step": {"dtype": "int32", "shape": [],
                     "data": np.array(3, np.int32).tobytes()}}
    assert tck.payload_bytes(state) == msgpack.packb(want,
                                                     use_bin_type=True)
    for bad in (None, True, 1.5):
        with pytest.raises(TypeError, match="checkpoint format"):
            tck.packb({"x": bad})
    with pytest.raises(ValueError, match="not in the checkpoint format"):
        tck.unpackb(msgpack.packb([None]))
