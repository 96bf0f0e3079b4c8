"""The port's rt runtime keeps the reference's shared-state contracts.

Statically, through the port's own thread lint
(``repro_torch.analysis.thread_lint``): the port's ``rt/`` passes it with
no finding, and the thread roots of ``RTServer``'s attributes, computed
by the port's lint on the port's server, are those the reference's lint
(``repro.analysis.thread_lint``) computes on the reference's server — the
GRAD/ACK replay caches and the ready/round sets are main-thread only, the
connection roster (``channels``/``last_seen``/``dead``) is rooted in the
main thread and the orchestrator's membership thread, hence locked.
Dynamically, a hammer: membership-thread ``attach``/``is_attached_live``
churn racing the main thread's ``_send``/``_mark_dead`` and roster reads.
"""
import queue
import sys
import threading
from pathlib import Path

from repro.analysis import thread_lint as ref_thread_lint
from repro_torch.analysis import thread_lint
from repro_torch.rt.server import RTServer

ROOT = Path(__file__).resolve().parent.parent
PORT_SERVER = ROOT / "src" / "repro_torch" / "rt" / "server.py"
REF_SERVER = ROOT / "src" / "repro" / "rt" / "server.py"


def test_port_rt_passes_thread_lint():
    assert thread_lint.run(ROOT / "src" / "repro_torch") == []


def test_server_root_sets_match_reference():
    ours = thread_lint.attr_roots(PORT_SERVER.read_text(), "RTServer")
    theirs = ref_thread_lint.attr_roots(REF_SERVER.read_text(), "RTServer")
    for attr in ("_grad_cache", "_ack_cache", "ready", "_round_dropped",
                 "_round_recovered"):
        assert ours[attr] == theirs[attr] == {"main"}, attr
    for attr in ("channels", "last_seen", "dead"):
        assert ours[attr] == theirs[attr], attr
        assert {"main", "membership"} <= ours[attr], attr
    shared = set(ours) & set(theirs)
    assert {a: ours[a] for a in shared} == {a: theirs[a] for a in shared}


class FakeChannel:
    """recv blocks until close() (so each reader parks), send fails after
    close (so a replaced channel's _send marks the gid dead, like a torn
    socket)."""

    def __init__(self):
        self.closed = threading.Event()

    def recv(self, timeout=None):
        self.closed.wait()
        raise ConnectionError("closed")

    def send(self, mtype, payload):
        if self.closed.is_set():
            raise OSError("closed")

    def close(self):
        self.closed.set()


def _bare_server():
    """An RTServer with only the connection roster wired up: the methods
    under test touch nothing else, and skipping __init__ keeps the
    hammer model-free."""
    srv = RTServer.__new__(RTServer)
    srv._roster_lock = threading.RLock()
    srv.channels, srv.last_seen = {}, {}
    srv.dead, srv.ready = set(), set()
    srv.inbox = queue.Queue()
    return srv


def test_attach_vs_round_drive_hammer():
    """8 membership threads (more than the cores) re-attach while the
    main thread drives sends and straggler kills, with a short switch
    interval; the roster must end consistent and every gid revivable."""
    srv = _bare_server()
    gids = list(range(8))
    errors = []

    def membership(g):
        try:
            for _ in range(150):
                srv.attach(g, FakeChannel())
                srv.is_attached_live(g)
        except Exception as e:  # pragma: no cover - the regression
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=membership, args=(g,))
               for g in gids]
    try:
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads):
            for g in gids:
                srv._send(g, 1, b"x")
            srv._mark_dead(gids[0])
            with srv._roster_lock:
                pending = set(gids) - srv.ready - srv.dead
                assert set(srv.channels) <= set(gids)
            assert pending <= set(gids)
    finally:
        sys.setswitchinterval(old)
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    with srv._roster_lock:
        assert set(srv.channels) == set(gids)
        assert set(srv.last_seen) == set(gids)
    for g in gids:
        srv.attach(g, FakeChannel())   # revive anything _mark_dead hit
    assert all(srv.is_attached_live(g) for g in gids)
    with srv._roster_lock:
        assert srv.dead == set()
    # every replaced channel's reader reported its own death only
    n = 0
    while not srv.inbox.empty():
        gid, mtype, ch = srv.inbox.get_nowait()
        assert mtype is None and ch is not srv.channels[gid]
        n += 1
    assert n <= 8 * 151
    with srv._roster_lock:
        for ch in srv.channels.values():
            ch.close()                 # release the parked readers
